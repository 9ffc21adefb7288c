"""K4 (``kernels/fused_matmul.py``) held against the JAX package's Pallas
kernel ``fused_quant_matmul`` on the CPU, run in interpret mode as
tests/test_kernels.py runs it.  The hand kernel itself runs only on a card:
chip_smoke.py holds it against the plain version there, by the rule below.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cnns_slfp_quantization_tpu.kernels import fused_matmul as jfm
from cnns_slfp_quantization_tpu.ops import sfp as jsfp
from cnns_slfp_quantization_tpu_torch.kernels import _build
from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as tfm
from cnns_slfp_quantization_tpu_torch.ops import sfp as tsfp

KA, KW = 0.37, 0.11


def assert_k4_close(got, want, xq, wv, bias, ka, kw):
    """K4's tolerance, K2's rule: the kernel sums its K products in another
    order than the reference.  Each order rounds at most K times, each by at
    most 2**-23 of a running sum that never exceeds ``mag``, the sum of the
    magnitudes of all terms, so the values before the output rounding
    differ by at most delta = K * 2**-22 * mag, and the outputs by delta
    plus one ulp of the output type."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want, np.float32).astype(np.float64)
    assert g.shape == w.shape
    kaw = np.float64(ka) * np.float64(kw)
    mag = np.abs(xq.astype(np.float64)) @ np.abs(wv.astype(np.float64))
    if bias is not None:
        mag = mag + np.abs(bias.astype(np.float64)) / kaw
    mag = mag * kaw
    delta = xq.shape[1] * 2.0**-22 * mag
    p = 7 if got.dtype == torch.bfloat16 else 23
    v = np.abs(w) + delta
    _, e = np.frexp(v)
    ulp = np.where(v > 0, np.ldexp(1.0, e - 1 - p), 0.0)
    err = np.abs(g - w)
    assert np.all(err <= delta + ulp), float((err - delta - ulp).max())


# (M, K, N), weights, flags: every flag of the port's signature, JAX's own
# shape (96, 160, 192), K = 16 (SqueezeNet's expand1x1 after a 16-wide
# squeeze) and a ragged M of 17 rows
CASES = {
    "u8_signed_f32out": ((96, 160, 192), "u8", dict()),
    "u8_bias_relu": ((96, 160, 192), "u8", dict(bias=True, act="relu")),
    "bf16_values_bias_bf16out": ((96, 160, 192), "bf16",
                                 dict(bias=True, out_dtype="bf16")),
    "u8_nonneg_bf16out_ragged": ((17, 64, 40), "u8",
                                 dict(nonneg=True, out_dtype="bf16")),
    "k16_bias_relu_nonneg": ((200, 16, 64), "u8",
                             dict(bias=True, act="relu", nonneg=True)),
    "no_quantize_x": ((96, 160, 192), "bf16", dict(quantize_x=False)),
    "bf16_x_u8": ((17, 64, 40), "u8", dict(x_bf16=True, bias=True)),
    "bf16_relu_bf16out_ragged": ((17, 64, 40), "bf16",
                                 dict(act="relu", out_dtype="bf16")),
}


def _inputs(m, k, n, wkind, flags, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (m, k)).astype(np.float32)
    if flags.get("nonneg"):
        x = np.abs(x)
    if flags.get("x_bf16"):
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    wq = np.asarray(jsfp.quantize_weight(
        jnp.asarray(rng.normal(0, 0.05, (k, n)).astype(np.float32) / KW), 8))
    w = (np.array(jsfp.pack_slfp34(jnp.asarray(wq))) if wkind == "u8"
         else wq.astype(ml_dtypes.bfloat16))
    bias = (rng.normal(0, 0.1, n).astype(np.float32) if flags.get("bias")
            else None)
    return x, w, bias


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case):
    (m, k, n), wkind, flags = CASES[case]
    x, w, bias = _inputs(m, k, n, wkind, flags, seed=len(case))
    quantize_x = flags.get("quantize_x", True)
    nonneg = flags.get("nonneg", False)
    bf16_out = flags.get("out_dtype") == "bf16"
    x_in = x
    if not quantize_x:  # already quantized values, as a producer emits them
        x_in = np.asarray(jsfp.quantize_act(jnp.asarray(x / KA), 8))
    with pltpu.force_tpu_interpret_mode():
        want = jfm.fused_quant_matmul(
            jnp.asarray(x_in).astype(jnp.bfloat16) if flags.get("x_bf16")
            else jnp.asarray(x_in), jnp.asarray(w), ka=KA, kw=KW,
            bias=None if bias is None else jnp.asarray(bias),
            act=jax.nn.relu if flags.get("act") else None,
            quantize_x=quantize_x, nonneg=nonneg,
            out_dtype=jnp.bfloat16 if bf16_out else jnp.float32)
    xt = torch.from_numpy(x_in)
    if flags.get("x_bf16"):
        xt = xt.to(torch.bfloat16)
    wt = (torch.from_numpy(w) if wkind == "u8"
          else torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16))
    got = tfm.fused_quant_matmul(
        xt, wt, ka=KA, kw=KW,
        bias=None if bias is None else torch.from_numpy(bias),
        act=flags.get("act"), quantize_x=quantize_x, nonneg=nonneg,
        out_dtype=torch.bfloat16 if bf16_out else torch.float32)
    assert got.dtype == (torch.bfloat16 if bf16_out else torch.float32)
    xq = (tsfp.act_bf16_bits(xt, 1.0 / KA, 8, nonneg) if quantize_x
          else xt.to(torch.bfloat16)).float().numpy()
    wv = tfm._weight_values(wt).float().numpy()
    assert_k4_close(got, np.asarray(want, np.float32), xq, wv, bias, KA, KW)


def test_quant_conv1x1_stride2_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    x = np.abs(rng.normal(0, 1, (2, 9, 9, 64))).astype(np.float32)
    wq = jsfp.quantize_weight(
        jnp.asarray(rng.normal(0, 0.05, (64, 96)).astype(np.float32) / KW), 8)
    codes = np.array(jsfp.pack_slfp34(wq))
    bias = rng.normal(0, 0.1, 96).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jfm.quant_conv1x1(jnp.asarray(x), jnp.asarray(codes), ka=KA,
                                 kw=KW, bias=jnp.asarray(bias), stride=2,
                                 nonneg=True)
    got = tfm.quant_conv1x1(torch.from_numpy(x), torch.from_numpy(codes),
                            ka=KA, kw=KW, bias=torch.from_numpy(bias),
                            stride=2, nonneg=True)
    assert tuple(got.shape) == (2, 5, 5, 96) == want.shape
    xs = x[:, ::2, ::2, :].reshape(-1, 64)
    xq = tsfp.act_bf16_bits(torch.from_numpy(xs), 1.0 / KA, 8,
                            True).float().numpy()
    wv = tfm._weight_values(torch.from_numpy(codes)).float().numpy()
    assert_k4_close(got.reshape(-1, 96), np.asarray(want).reshape(-1, 96),
                    xq, wv, bias, KA, KW)


def test_transposed_weight_storage_is_the_same_matrix():
    """The layers hand K4 ``weight.t()`` of their [N, K] storage."""
    x, w, bias = _inputs(33, 24, 16, "u8", dict(bias=True), seed=3)
    wt = torch.from_numpy(w)
    w_nk = wt.t().contiguous().t()
    assert not w_nk.is_contiguous() and w_nk.t().is_contiguous()
    args = dict(ka=KA, kw=KW, bias=torch.from_numpy(bias), act="relu")
    a = tfm.fused_quant_matmul(torch.from_numpy(x), wt, **args)
    b = tfm.fused_quant_matmul(torch.from_numpy(x), w_nk, **args)
    np.testing.assert_array_equal(a.view(torch.int32).numpy(),
                                  b.view(torch.int32).numpy())


@pytest.mark.parametrize("wkind,act,want_zero_bias", [
    ("bf16", None, True), ("u8", None, False), ("bf16", "relu", False)])
def test_dense_bias_follows_jax_routes(monkeypatch, wkind, act,
                                       want_zero_bias):
    """JAX's float-weight dense route (``_diff_matmul``) passes zeros as the
    bias when there is none, which turns a -0.0 sum into +0.0; its uint8
    route, and any call with an activation, pass none
    (fused_matmul.py:196-204).  The port keeps both."""
    seen = {}

    def spy(x4, w, **kw):
        seen["bias"] = kw["bias"]
        return torch.zeros(x4.shape[0] * x4.shape[1] * x4.shape[2],
                           w.shape[1])

    monkeypatch.setattr(tfm, "_matmul", spy)
    x, w, _ = _inputs(8, 16, 8, wkind, {}, seed=0)
    wt = (torch.from_numpy(w) if wkind == "u8"
          else torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16))
    tfm.quant_dense(torch.from_numpy(x), wt, ka=KA, kw=KW, act=act)
    tfm.quant_conv1x1(torch.from_numpy(x).reshape(2, 2, 2, 16), wt, ka=KA,
                      kw=KW, act=act)
    if want_zero_bias:
        assert seen["bias"] is not None and not seen["bias"].any()
    else:
        assert seen["bias"] is None


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(4, 16)
    w = torch.zeros(16, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="act"):
        tfm.fused_quant_matmul(x, w, ka=1.0, kw=1.0, act="gelu")
    with pytest.raises(ValueError, match="bias"):
        tfm.fused_quant_matmul(x, w, ka=1.0, kw=1.0, bias=torch.zeros(5))
    with pytest.raises(ValueError, match="out_dtype"):
        tfm.fused_quant_matmul(x, w, ka=1.0, kw=1.0,
                               out_dtype=torch.float16)


def test_library_digest_covers_every_header(monkeypatch, tmp_path):
    """An edited shared header rebuilds every library, not only those of
    slfp.cuh: every *.cuh under csrc/ enters the digest."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    (tmp_path / "extra.cuh").write_text("// a new shared header\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    assert "fused_matmul" in _build.SOURCES
