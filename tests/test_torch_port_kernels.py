"""The port's kernel modules (K1 quantize, K2 qmm, K3 epilogue) held against
the JAX package's Pallas kernels on the CPU through their plain versions,
and the CUDA header's constants against the Python ones.  The hand kernels
themselves run only on a card: chip_smoke.py holds each against its plain
version there."""

import fractions
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu.kernels import epilogue as jepi
from cnns_slfp_quantization_tpu.kernels import qmm as jqmm
from cnns_slfp_quantization_tpu.ops import sfp as jsfp
from cnns_slfp_quantization_tpu_torch import kernels as tk
from cnns_slfp_quantization_tpu_torch.kernels import _build
from cnns_slfp_quantization_tpu_torch.kernels import epilogue as tepi
from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as tfm
from cnns_slfp_quantization_tpu_torch.kernels import qmm as tqmm
from cnns_slfp_quantization_tpu_torch.kernels import quantize as tquant
from cnns_slfp_quantization_tpu_torch.ops import sfp as tsfp

CUH = pathlib.Path(tsfp.__file__).resolve().parents[1] / "csrc" / "slfp.cuh"
RECIP_A, RECIP_B = tsfp.recip_of(0.1701), tsfp.recip_of(0.2964)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def _code_index(vals: np.ndarray) -> np.ndarray:
    """Signed position of each quantized value among the bf16 values the
    SLFP<3,4> activation quantizer emits: 0, the pseudo-zero, 0.125 and up.
    Its linear pre-round skips some codebook entries (2**(2/16), ...), so
    the emitted set comes from the quantizer itself, fed every finite
    non-negative bf16 value."""
    every = torch.arange(0x7F80, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    book = tsfp.act_bf16_bits(every, 1.0, 8, True).float().unique().numpy()
    idx = np.searchsorted(book, np.abs(vals).astype(np.float32))
    return np.where(vals < 0, -idx, idx)


# ---------------------------------------------------------------------------
# CUDA header <-> Python constants
# ---------------------------------------------------------------------------


def test_cuda_header_constants_match_python():
    text = CUH.read_text()
    consts = {m.group(1): int(m.group(2), 16) for m in re.finditer(
        r"constexpr int32_t (k\w+) = (0x[0-9A-Fa-f]+);", text)}
    want = {"kD3Lo": tsfp.D3_LO, "kD3Hi": tsfp.D3_HI, "kPz16": tsfp.PZ16,
            "kI32Lo": tsfp.I32_LO, "kI32ClampSlfp": tsfp.I32_CLAMP_SLFP,
            "kI32ClampSfp33": tsfp.I32_CLAMP_SFP33,
            "kI32FloorSlfp": tsfp.I32_FLOOR_SLFP,
            "kI32FloorSfp33": tsfp.I32_FLOOR_SFP33,
            "kI32PseudoZero": tsfp._f32_bits(1e-10),
            "kI32Eighth": tsfp._f32_bits(0.125), "kMlMagic": tsfp._ML_MAGIC}
    assert consts == want
    table = [int(v, 16) for v in re.findall(
        r"(?:case \d+|default): return (0x[0-9A-Fa-f]+);", text)]
    assert table == tsfp._P_TABLE


# ---------------------------------------------------------------------------
# K3: affine with one rounding, epilogue forms
# ---------------------------------------------------------------------------


def test_affine_f32_is_correctly_rounded():
    # exact sum 1 + 2**-23 + 2**-24 - 2**-54 lies just below a float32
    # midpoint; float64 rounds it onto the midpoint, and a plain .float()
    # then rounds to even, away from the correct value
    y = np.float32(2.0**-24 * (1 + 2.0**-15))
    s = np.float32(1 - 2.0**-15)
    t = np.float32(1 + 2.0**-23)
    naive = np.float32(np.float64(y) * np.float64(s) + np.float64(t))
    got = tepi.affine_f32(torch.tensor([y]), torch.tensor([s]),
                          torch.tensor([t])).item()
    assert got == t and naive != t
    xla = float(jax.jit(lambda a, b, c: a * b + c)(y, s, t))
    assert xla == got  # XLA fuses y*s + t into one rounding too
    rng = np.random.default_rng(0)
    ys = rng.standard_normal(3000).astype(np.float32) * 8
    ss = rng.uniform(0.01, 3, 3000).astype(np.float32)
    ts = rng.standard_normal(3000).astype(np.float32)
    got = tepi.affine_f32(torch.from_numpy(ys), torch.from_numpy(ss),
                          torch.from_numpy(ts)).numpy()
    exact = [np.float32(float(fractions.Fraction(float(a)) *
                              fractions.Fraction(float(b)) +
                              fractions.Fraction(float(c))))
             for a, b, c in zip(ys, ss, ts)]
    # float(Fraction) rounds once, to float64; exact enough off midpoints
    np.testing.assert_array_equal(got, np.asarray(exact, np.float32))


def _epi_inputs(rows=512, c=64, seed=0):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((rows, c)) * 4).astype(np.float32)
    ident = (rng.standard_normal((rows, c)) * 2).astype(np.float32)
    ident = torch.from_numpy(ident).to(torch.bfloat16)
    s = rng.uniform(0.05, 2.0, c).astype(np.float32)
    t = rng.standard_normal(c).astype(np.float32)
    return y, ident, s, t


def test_dual_epilogue_plain_bit_equal_to_pallas():
    y, ident, s, t = _epi_inputs()
    raw_j, q_j = jepi.dual_epilogue(
        jnp.asarray(y), jnp.asarray(ident.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(s), jnp.asarray(t), RECIP_A, interpret=True)
    raw, q = tepi.bn_epilogue(torch.from_numpy(y), torch.from_numpy(s),
                              torch.from_numpy(t), identity=ident, relu=True,
                              quant_recip=RECIP_A)
    np.testing.assert_array_equal(_bf16_bits(raw), _jbits(raw_j))
    np.testing.assert_array_equal(_bf16_bits(q), _jbits(q_j))


@pytest.mark.parametrize("residual", [False, True])
def test_single_q_form_quantizes_the_f32_value(residual):
    """q only (after conv2, or conv3 at a stage end) = the JAX xla_post
    with quant_next: _act_bf16_bits(relu(fma(y, s, t) [+ r]))."""
    y, ident, s, t = _epi_inputs(seed=1)
    r32 = ident.float().numpy()

    def jax_post(y, s, t, r):
        v = y * s + t
        if residual:
            v = v + r
        return jsfp._act_bf16_bits(jnp.maximum(v, 0.0), RECIP_B, 8, True)

    want = _jbits(jax.jit(jax_post)(y, s, t, r32))
    raw, q = tepi.bn_epilogue(torch.from_numpy(y), torch.from_numpy(s),
                              torch.from_numpy(t),
                              identity=ident if residual else None,
                              relu=True, emit_raw=False, quant_recip=RECIP_B)
    assert raw is None
    np.testing.assert_array_equal(_bf16_bits(q), want)


@pytest.mark.parametrize("relu", [False, True])
def test_single_raw_form_matches_xla_post(relu):
    """raw only (stem, downsample without ReLU) = bf16(relu?(fma(y,s,t)))."""
    y, _, s, t = _epi_inputs(seed=2)
    want = _jbits(jax.jit(lambda y, s, t: (
        jnp.maximum(y * s + t, 0.0) if relu else y * s + t).astype(
            jnp.bfloat16))(y, s, t))
    raw, q = tepi.bn_epilogue(torch.from_numpy(y), torch.from_numpy(s),
                              torch.from_numpy(t), relu=relu)
    assert q is None
    np.testing.assert_array_equal(_bf16_bits(raw), want)


def test_relu_yields_positive_zero():
    """fma(-0.0, 1, -0.0) is -0.0; ReLU must give +0.0, whose quantized
    code is 0 and not the pseudo-zero that -0.0's bit pattern would give."""
    y = torch.tensor([[-0.0, -1.0, 0.0, 2.0, -0.0, 3.0, 0.5, -0.0]])
    s = torch.ones(8)
    t = torch.full((8,), -0.0)
    raw, q = tepi.bn_epilogue(y, s, t, relu=True, quant_recip=1.0)
    assert (_bf16_bits(raw)[0, [0, 1, 2, 4, 7]] == 0).all()
    assert (_bf16_bits(q)[0, [0, 1, 2, 4, 7]] == 0).all()
    _, q_only = tepi.bn_epilogue(y, s, t, relu=True, emit_raw=False,
                                 quant_recip=1.0)
    assert (_bf16_bits(q_only)[0, [0, 1, 2, 4, 7]] == 0).all()


@pytest.mark.parametrize("form", ["dual", "q_only"])
def test_f32_q_form_is_pallas_output_widened(form):
    """K3's f32 q form: JAX's dual epilogue (interpret mode) or xla_post +
    quantize, widened to float32, bit for bit."""
    y, ident, s, t = _epi_inputs(seed=3)
    if form == "dual":
        _, want = jepi.dual_epilogue(
            jnp.asarray(y),
            jnp.asarray(ident.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(s), jnp.asarray(t), RECIP_A, interpret=True)
    else:
        want = jax.jit(lambda y, s, t: jsfp._act_bf16_bits(
            jnp.maximum(y * s + t, 0.0), RECIP_A, 8, True))(y, s, t)
    want = np.asarray(want).astype(np.float32)
    raw, q = tepi.bn_epilogue(torch.from_numpy(y), torch.from_numpy(s),
                              torch.from_numpy(t),
                              identity=ident if form == "dual" else None,
                              relu=True, emit_raw=form == "dual",
                              quant_recip=RECIP_A, q_dtype=torch.float32)
    assert q.dtype == torch.float32 and (raw is None) == (form != "dual")
    np.testing.assert_array_equal(q.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nonneg", [True, False])
def test_k1_f32_form_is_jax_act_bf16_bits_widened(dtype, nonneg):
    """K1's f32 output form: JAX's ``_act_bf16_bits`` widened to float32,
    bit for bit, from f32 and bf16 inputs."""
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32) * 6
    if nonneg:
        x = np.abs(x)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    want = np.asarray(jax.jit(lambda v: jsfp._act_bf16_bits(
        v, RECIP_B, 8, nonneg))(xj)).astype(np.float32)
    got = tquant.act_quantize(xt, RECIP_B, nonneg=nonneg,
                              out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("subnormal", [None, "scale", "shift", "recip"])
def test_ftz_route_only_without_subnormals(subnormal):
    """K3's FTZ route flushes its scale, shift and reciprocal, which the
    exact route does not: it is taken only when none is subnormal.  K1's
    likewise only for a normal reciprocal."""
    s, t = torch.full((16,), 0.5), torch.full((16,), -1.25)
    recips = [RECIP_A, RECIP_B]
    if subnormal == "scale":
        s[3] = 1e-40
    elif subnormal == "shift":
        t[7] = -3e-39
    elif subnormal == "recip":
        recips.append(2e-39)
    assert tepi.ftz_route(s, t, recips) == (subnormal is None)
    assert _build.normal_scalar(recips[-1]) == (subnormal != "recip")


def test_epilogue_needs_an_output():
    y, _, s, t = _epi_inputs(rows=8)
    with pytest.raises(ValueError):
        tepi.bn_epilogue(torch.from_numpy(y), torch.from_numpy(s),
                         torch.from_numpy(t), emit_raw=False)


# ---------------------------------------------------------------------------
# K2: plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

# the flag combinations the fused executor uses
QMM_CASES = {
    "conv1_prologue": dict(relu=True, quant_in_recip=RECIP_A,
                           quant_out_recip=RECIP_B),
    "conv1_quantized_in": dict(relu=True, quant_out_recip=RECIP_B),
    "conv3_mid": dict(relu=True, residual=True),
    "conv3_stage_end": dict(relu=True, residual=True,
                            quant_out_recip=RECIP_A),
    "f32_out": dict(relu=False, out_f32=True),
}


def _qmm_inputs(m=96, k=64, n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((m, k))).astype(np.float32) * 2
    xb = torch.from_numpy(x).to(torch.bfloat16)
    w = tsfp.quantize_weight(torch.from_numpy(
        rng.standard_normal((k, n)).astype(np.float32)), 8)
    s = rng.uniform(0.002, 0.02, n).astype(np.float32)
    t = rng.standard_normal(n).astype(np.float32) * 0.5
    r = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(
        torch.bfloat16)
    return xb, w, s, t, r


def assert_qmm_close(got: torch.Tensor, want: np.ndarray, quantized: bool):
    """K2's tolerance: its sums run in another order than the reference's.
    Raw bf16 outputs within one bf16 ulp per element, or 1e-4*max|y| where
    the affine and residual cancel to near zero; f32 outputs within
    1e-3*max|y|; quantized outputs within one SLFP code step in at most 0.1%
    of elements."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    if quantized:
        step = np.abs(_code_index(g) - _code_index(w))
        assert step.max() <= 1 and (step > 0).mean() <= 1e-3, (
            step.max(), (step > 0).mean())
    elif got.dtype == torch.bfloat16:
        # bf16 patterns of one sign are ordered like their values; where the
        # epilogue cancels to near zero, an absolute 1e-4*max|y|
        gi = g.view(np.int32) >> 16
        wi = w.view(np.int32) >> 16
        near = np.abs(g - w) <= 1e-4 * np.abs(w).max()
        assert np.all((np.abs(gi - wi) <= 1) | near)
    else:
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("w_u8", [False, True])
@pytest.mark.parametrize("case", list(QMM_CASES))
def test_qmm_plain_matches_pallas(case, w_u8):
    xb, w, s, t, r = _qmm_inputs(seed=len(case))
    flags = dict(QMM_CASES[case])
    res = r if flags.pop("residual", False) else None
    out_f32 = flags.pop("out_f32", False)
    w_arg = tsfp.pack_slfp34(w) if w_u8 else w.to(torch.bfloat16)
    want = jqmm.qmm_fused(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w_arg.numpy()) if w_u8 else
        jnp.asarray(w.numpy()).astype(jnp.bfloat16),
        jnp.asarray(s), jnp.asarray(t),
        residual=None if res is None else
        jnp.asarray(res.float().numpy()).astype(jnp.bfloat16),
        out_dtype=jnp.float32 if out_f32 else jnp.bfloat16,
        interpret=True, **flags)
    got = tqmm.qmm_fused(xb, w_arg, torch.from_numpy(s), torch.from_numpy(t),
                         residual=res,
                         out_dtype=torch.float32 if out_f32 else torch.bfloat16,
                         **flags)
    assert_qmm_close(got, np.asarray(want, np.float32),
                     quantized="quant_out_recip" in flags)


def test_qmm_packed_equals_bf16_weights():
    xb, w, s, t, r = _qmm_inputs(seed=5)
    args = (torch.from_numpy(s), torch.from_numpy(t))
    a = tqmm.qmm_fused(xb, w.to(torch.bfloat16), *args, residual=r, relu=True,
                       quant_in_recip=RECIP_A)
    b = tqmm.qmm_fused(xb, tsfp.pack_slfp34(w), *args, residual=r, relu=True,
                       quant_in_recip=RECIP_A)
    np.testing.assert_array_equal(_bf16_bits(a), _bf16_bits(b))


# ---------------------------------------------------------------------------
# K1 wrapper, launch counts and the build
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    tk.reset_launches()
    x = torch.linspace(-20, 20, 1000)
    np.testing.assert_array_equal(
        _bf16_bits(tquant.act_quantize(x, RECIP_A, nonneg=False)),
        _bf16_bits(tsfp.act_bf16_bits(x, RECIP_A, 8, False)))
    np.testing.assert_array_equal(tquant.slfp34_act_quantize(x).numpy(),
                                  tsfp.slfp34_act_bits(x).numpy())
    y, ident, s, t = _epi_inputs(rows=8)
    tepi.bn_epilogue(torch.from_numpy(y), torch.from_numpy(s),
                     torch.from_numpy(t))
    xb, w, s2, t2, _ = _qmm_inputs(m=8)
    tqmm.qmm_fused(xb, w, torch.from_numpy(s2), torch.from_numpy(t2))
    assert set(tk.launches().values()) == {0}


@pytest.mark.parametrize("wrapper", ["act_quantize", "act_quantize_f32",
                                     "slfp34_act_quantize", "qmm_fused",
                                     "bn_epilogue", "bn_epilogue_f32",
                                     "fused_quant_matmul"])
def test_non_cpu_tensors_never_take_the_plain_version(wrapper):
    """Only a CPU tensor runs the plain version: any other device goes to
    the kernel's launch path, which refuses what is not on one CUDA device
    (a meta tensor here) instead of falling back."""
    meta = dict(device="meta")
    calls = {
        "act_quantize": lambda: tquant.act_quantize(
            torch.empty(64, **meta), RECIP_A),
        "act_quantize_f32": lambda: tquant.act_quantize(
            torch.empty(64, dtype=torch.bfloat16, **meta), RECIP_A,
            out_dtype=torch.float32),
        "slfp34_act_quantize": lambda: tquant.slfp34_act_quantize(
            torch.empty(64, **meta)),
        "qmm_fused": lambda: tqmm.qmm_fused(
            torch.empty(16, 8, dtype=torch.bfloat16, **meta),
            torch.empty(8, 8, dtype=torch.bfloat16, **meta),
            torch.empty(8, **meta), torch.empty(8, **meta)),
        "bn_epilogue": lambda: tepi.bn_epilogue(
            torch.empty(4, 8, **meta), torch.empty(8, **meta),
            torch.empty(8, **meta)),
        "bn_epilogue_f32": lambda: tepi.bn_epilogue(
            torch.empty(4, 8, **meta), torch.empty(8, **meta),
            torch.empty(8, **meta), emit_raw=False, quant_recip=RECIP_A,
            q_dtype=torch.float32, ftz=True),
        "fused_quant_matmul": lambda: tfm.fused_quant_matmul(
            torch.empty(16, 8, dtype=torch.bfloat16, **meta),
            torch.empty(8, 8, dtype=torch.uint8, **meta), ka=1.0, kw=1.0,
            bias=torch.empty(8, **meta)),
    }
    tk.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        calls[wrapper]()
    assert set(tk.launches().values()) == {0}


def test_library_path_follows_the_sources():
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for name, p in paths.items():
        assert p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{name}-")
        assert (_build.CSRC / f"{name}.cu").exists()
        assert set(_build.SIGNATURES[name])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(("quantize",))
