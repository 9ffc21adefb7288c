"""K5's plain version (cnns_slfp_quantization_tpu_torch.kernels.depthwise)
held against the JAX package's Pallas ``dw3x3`` in interpret mode and
against the grouped-conv route the fused executor also runs, its wrapper's
device rule, and the per-device constant tables of ``ops/sfp.py``.

Bit equality with JAX's raw stencil is out of reach on the CPU: JAX's
``dw3x3`` in interpret mode (x 2x12x12x128, seed 0, relu=False, f32 out)
matches an (i, j)-ordered chain of float32 FMAs bit for bit in only 91% of
its raw outputs, a chain of separate multiplies and adds in 53%, the
reversed order in 35-37% and a pairwise tree in 43%, all within 1e-6: XLA
contracts some taps into FMAs and not others.  So the raw outputs are held
to JAX's own tolerance (tests/test_depthwise.py:35, rtol = atol = 1e-5) and
the quantized ones to one step of the quantizer in at most 0.1% of
elements.  On the card K5 and its plain version run the same FMA chain and
are bit-equal (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cnns_slfp_quantization_tpu.kernels import depthwise as jdw
from cnns_slfp_quantization_tpu.ops import sfp as jsfp
from cnns_slfp_quantization_tpu_torch import kernels as tk
from cnns_slfp_quantization_tpu_torch.kernels import depthwise as tdw
from cnns_slfp_quantization_tpu_torch.kernels import epilogue as tepi
from cnns_slfp_quantization_tpu_torch.ops import sfp as tsfp

SHAPES = [(2, 12, 12, 128), (1, 7, 9, 32)]
RECIP = tsfp.recip_of(0.2)


def _inputs(shape, x_bf16, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(0, 1, shape).astype(np.float32)
    if x_bf16:
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    w = rng.normal(0, 0.5, (3, 3, c)).astype(np.float32)
    s = rng.normal(1, 0.1, (c,)).astype(np.float32)
    t = rng.normal(0, 0.1, (c,)).astype(np.float32)
    return x, w, s, t


def _torch(x, x_bf16):
    xt = torch.from_numpy(x)
    return xt.to(torch.bfloat16) if x_bf16 else xt


def _emitted() -> np.ndarray:
    """Every value the SLFP<3,4> activation quantizer emits (0, the
    pseudo-zero, 0.125 and up): its linear pre-round skips some codebook
    entries, so one step is counted over these, not over the codebook."""
    every = torch.arange(0x7F80, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    return np.unique(tsfp.act_bf16_bits(every, 1.0, 8, True).float().numpy())


def _check(got, want, quantized):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if not quantized:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    emitted = _emitted()
    step = np.abs(np.searchsorted(emitted, np.abs(got)) * np.sign(got)
                  - np.searchsorted(emitted, np.abs(want)) * np.sign(want))
    assert step.max() <= 1, step.max()
    assert (step > 0).mean() <= 1e-3, (step > 0).mean()


@pytest.mark.parametrize("quantized", [False, True], ids=["raw", "quant"])
@pytest.mark.parametrize("x_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_pallas(shape, relu, x_bf16, quantized):
    x, w, s, t = _inputs(shape, x_bf16)
    kw = dict(relu=relu, quant_out_recip=RECIP if quantized else None,
              out_dtype=jnp.bfloat16 if quantized else jnp.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if x_bf16 else jnp.float32)
    want = np.asarray(jax.jit(lambda *a: jdw.dw3x3(
        a[0], a[1], scale=a[2], shift=a[3], interpret=True, **kw))(
            xj, jnp.asarray(w), jnp.asarray(s), jnp.asarray(t)), np.float32)
    got = tdw.dw3x3(_torch(x, x_bf16), torch.from_numpy(w),
                    scale=torch.from_numpy(s), shift=torch.from_numpy(t),
                    relu=relu, quant_out_recip=kw["quant_out_recip"],
                    out_dtype=torch.bfloat16 if quantized else torch.float32)
    assert got.dtype == (torch.bfloat16 if quantized else torch.float32)
    _check(got.float().numpy(), want, quantized)


@pytest.mark.parametrize("quantized", [False, True], ids=["raw", "quant"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_grouped_conv_chain(shape, relu, quantized):
    """The executor's ``dw="torch"`` route: a grouped conv of the same
    operands, then K3's plain epilogue."""
    x, w, s, t = _inputs(shape, True, seed=1)
    xt, wt = _torch(x, True), torch.from_numpy(w)
    st, tt = torch.from_numpy(s), torch.from_numpy(t)
    y = F.conv2d(xt.float().permute(0, 3, 1, 2),
                 wt.permute(2, 0, 1).unsqueeze(1), padding=1,
                 groups=shape[-1]).permute(0, 2, 3, 1)
    if quantized:
        _, want = tepi.bn_epilogue_plain(y, st, tt, relu=relu, emit_raw=False,
                                         quant_recip=RECIP)
    else:
        want = tepi.epilogue_value_plain(y, st, tt, None, relu)
    got = tdw.dw3x3(xt, wt, scale=st, shift=tt, relu=relu,
                    quant_out_recip=RECIP if quantized else None,
                    out_dtype=torch.bfloat16 if quantized else torch.float32)
    _check(got.float().numpy(), want.float().numpy(), quantized)


def test_plain_is_the_fma_chain_with_the_epilogue():
    """Defaults: scale 1, shift 0; nonneg_in quantizes without sign
    handling; the plain version is the nine single-rounding taps followed
    by K3's epilogue value and the quantize, in that order."""
    x, w, _, _ = _inputs((1, 5, 6, 16), True, seed=2)
    xt, wt = _torch(np.abs(x), True), torch.from_numpy(np.abs(w))
    acc = torch.zeros(xt.shape)
    xp = F.pad(xt.float(), (0, 0, 1, 1, 1, 1))
    for i in range(3):
        for j in range(3):
            acc = tepi.affine_f32(xp[:, i:i + 5, j:j + 6, :], wt[i, j], acc)
    want = tsfp.act_bf16_bits(acc, RECIP, 8, True)
    got = tdw.dw3x3(xt, wt, quant_out_recip=RECIP, nonneg_in=True)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(torch.int16).numpy())
    assert tdw.dw3x3(xt, wt, out_dtype=torch.float32).dtype == torch.float32


def test_non_cpu_tensors_never_take_the_plain_version():
    """A CPU tensor runs the plain version and counts nothing; any other
    device goes to the kernel's launch path, which refuses what is not on
    one CUDA device (a meta tensor here) instead of falling back."""
    tk.reset_launches()
    x = torch.zeros(1, 4, 4, 8)
    tdw.dw3x3(x, torch.zeros(3, 3, 8))
    assert tk.launches()["dw3x3"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tdw.dw3x3(torch.empty(1, 4, 4, 8, device="meta"),
                  torch.empty(3, 3, 8, device="meta"))
    with pytest.raises(ValueError, match="dw3x3"):
        tdw.dw3x3(torch.empty(1, 4, 4, 8, device="meta"),
                  torch.empty(3, 3, 4, device="meta"))
    assert set(tk.launches().values()) == {0}


# ---------------------------------------------------------------------------
# the constant tables of ops/sfp.py, cached per device
# ---------------------------------------------------------------------------


def _quantizer_outputs():
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    w = torch.from_numpy(np.random.default_rng(3).normal(
        0, 4, 50_000).astype(np.float32))
    return [tsfp.unpack_slfp34(codes), tsfp.slfp34_decode_bits(codes),
            tsfp.quantize_weight(w, 8), tsfp.quantize_weight(w, 7),
            tsfp.quantize_act(w, 8), tsfp.slfp34_act_bits(w),
            tsfp.pack_slfp34(tsfp.quantize_weight(w, 8)),
            tsfp.quantize_layerout(w, 8, bug_compat=False)]


def test_cached_tables_give_the_same_bits(monkeypatch):
    """The quantizers with the tables copied anew on every call (as before
    the cache) and with the cached tables give the same bits, and a second
    call copies nothing."""
    monkeypatch.setattr(tsfp, "_table", lambda name, device: torch.from_numpy(
        tsfp._TABLES[name].copy()).to(device))
    before = _quantizer_outputs()
    monkeypatch.undo()
    tsfp._on_device.clear()
    after = _quantizer_outputs()
    cached = dict(tsfp._on_device)
    assert {name for name, _ in cached} == set(tsfp._TABLES)
    again = _quantizer_outputs()
    assert all(tsfp._on_device[k] is t for k, t in cached.items())
    assert len(tsfp._on_device) == len(cached)
    for b, a, g in zip(before, after, again):
        bits = (lambda t: t.view(torch.int32) if t.dtype == torch.float32
                else t)
        np.testing.assert_array_equal(bits(b).numpy(), bits(a).numpy())
        np.testing.assert_array_equal(bits(a).numpy(), bits(g).numpy())


def test_tables_first_built_under_inference_mode_are_ordinary_tensors():
    tsfp._on_device.clear()
    with torch.inference_mode():
        tsfp.unpack_slfp34(torch.zeros(4, dtype=torch.uint8))
    t = tsfp._on_device[("exp2_16", torch.device("cpu"))]
    assert not t.is_inference()
    w = torch.randn(16, requires_grad=True)
    tsfp.quantize_weight(w, 8).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.ones(16, np.float32))


def test_quantize_act_keeps_the_sign_of_zero_as_jax():
    x = np.array([-0.0, 0.0, -1e-40, 1e-40, -3.0], np.float32)
    for q in (7, 8):
        want = np.asarray(jsfp.quantize_act(jnp.asarray(x), q))
        got = tsfp.quantize_act(torch.from_numpy(x), q).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# the kernel's block plan and its FTZ route (host side of csrc/depthwise.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hwc", [
    (112, 112, 32), (56, 56, 128), (28, 28, 256), (14, 14, 512),
    (7, 7, 1024), (16, 16, 32), (8, 8, 128), (4, 4, 256), (2, 2, 512),
    (1, 1, 1024), (13, 11, 40), (13, 11, 30), (9, 10, 24), (1, 1, 64)],
    ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_output_once(hwc):
    """The kernel's index math over the plan's grid (csrc/depthwise.cu:
    thread t owns channel group t % cg and column t / cg; block x is channel
    tile x % ctiles and column tile x / ctiles; block y a band of ``rows``)
    reaches every (row, column, group of 4 channels) exactly once, with at
    most 256 threads a block; at MobileNetV1's sites no thread is idle."""
    h, w, c = hwc
    cg, tw, rows = tdw.plan(h, w, c)
    assert 1 <= cg * tw <= 256 and rows <= 16
    groups = -(-c // 4)
    ctiles = -(-groups // cg)
    t = np.arange(cg * tw)
    bx = np.arange(ctiles * -(-w // tw))
    grp = ((bx % ctiles)[:, None] * cg + t % cg).ravel()
    col = ((bx // ctiles)[:, None] * tw + t // cg).ravel()
    live = (grp < groups) & (col < w)
    hits = np.zeros((h, w, groups), np.int64)
    for r0 in range(0, h, rows):
        np.add.at(hits, (slice(r0, min(r0 + rows, h)), col[live],
                         grp[live]), 1)
    assert (hits == 1).all()
    if hwc[:2] in ((112, 112), (56, 56), (28, 28), (14, 14), (7, 7)):
        assert live.all()


def test_ftz_route_only_without_subnormals():
    """The FTZ route equals the exact one only when no tap, scale, shift
    or reciprocal is subnormal; the check reads each tensor as it is now,
    also one made under inference mode and changed in place."""
    w, s, t = torch.ones(3, 3, 8), torch.ones(8), torch.zeros(8)
    assert tdw.ftz_route(w, s, t, 0.37)
    assert tdw.ftz_route(w, None, None, None)
    assert not tdw.ftz_route(w, s, t, 1e-40)
    sub = torch.full((8,), 1e-40)
    assert not tdw.ftz_route(w, sub, t, 0.37)
    assert not tdw.ftz_route(w, s, -sub, None)
    w2 = torch.ones(3, 3, 8)
    assert tdw.ftz_route(w2, s, t, None)
    w2[1, 2, 3] = -1e-42
    assert not tdw.ftz_route(w2, s, t, None)
    with torch.inference_mode():
        w3 = torch.ones(3, 3, 8)
        assert tdw.ftz_route(w3, s, t, None)
        w3[0, 0, 0] = 1e-39
        assert not tdw.ftz_route(w3, s, t, None)
