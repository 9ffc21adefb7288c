"""K6's plain version (cnns_slfp_quantization_tpu_torch.kernels.chain) held
against the JAX package's Pallas ``bottleneck_chain`` in interpret mode, the
fused ResNet-50 executor under ``policy={"chain": {2, 3}}`` against JAX's
and against the port's default executor, the wrapper's device rule and
band plan, and the policy's validation.

Exact inputs make every sum exact in float32, so that the order of the
summation cannot matter: block inputs are values the SLFP<3,4> quantizer
emits (8 significant bits, at most 4; the identity at most 2 in
magnitude), weights are +-1 and +-0.5, the affines scale by 2**-6 and shift
by 3, 4 or 5 (or by -40, which zeroes a channel through the ReLU).  Every
partial sum then lies on a 2**-17 grid below 2**6, and every scaled
quantizer input is either 0 or above 1, never in the pseudo-zero band (0,
0.0625), whose 1e-10 is off the grid (each test asserts it).  With those
inputs the plain K6 and JAX agree bit for bit; on the card K6 and the
plain version do too (``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu import calib as jcalib
from cnns_slfp_quantization_tpu import models as jmodels
from cnns_slfp_quantization_tpu.kernels import chain as jchain
from cnns_slfp_quantization_tpu.models import resnet50_fused as jfused
from cnns_slfp_quantization_tpu.ops import sfp as jsfp
from cnns_slfp_quantization_tpu_torch import kernels as tk
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.kernels import chain as tchain
from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as tfused
from cnns_slfp_quantization_tpu_torch.models.resnet50 import STAGES
from cnns_slfp_quantization_tpu_torch.ops import freeze as tfreeze
from cnns_slfp_quantization_tpu_torch.ops import sfp as tsfp
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from cnns_slfp_quantization_tpu_torch.train.checkpoint import (
    load_jax_variables)

RECIPS = dict(recip2=0.7, recip3=0.9, recip_next=0.8)
# (N, H, W, block_images): 7x7, an odd 5x6, and N=3 over JAX's image tiles
SHAPES = [(1, 7, 7, 4), (2, 5, 6, 4), (3, 7, 7, 2)]
C, M = 64, 16


def _emitted() -> np.ndarray:
    """Every value the SLFP<3,4> activation quantizer emits (0, the
    pseudo-zero, 0.125 and up)."""
    every = torch.arange(0x7F80, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    return np.unique(tsfp.act_bf16_bits(every, 1.0, 8, True).float().numpy())


EMITTED = _emitted()


def _exact_inputs(n, h, w, c, m, seed=0):
    rng = np.random.default_rng(seed)
    vals = EMITTED[(EMITTED >= 0.125) & (EMITTED <= 4)]
    sign = lambda *s: rng.choice(np.float32([-1, 1]), s)  # noqa: E731
    xq = rng.choice(vals, (n, h, w, c))
    idn = rng.choice(vals[vals <= 2], (n, h, w, c)) * sign(n, h, w, c)
    wv = lambda *s: rng.choice(np.float32([-1, -0.5, 0.5, 1]), s)  # noqa
    aff = lambda k, b: (np.full(k, 2.0**-6, np.float32),  # noqa: E731
                        np.where(rng.random(k) < 0.2, -40, b).astype(
                            np.float32))
    a1, b1 = aff(m, 4)
    a2, b2 = aff(m, 5)
    a3, b3 = aff(c, 3)
    return [np.asarray(a, np.float32) for a in (
        xq, idn, wv(c, m), wv(3, 3, m, m), wv(m, c), a1, b1, a2, b2, a3, b3)]


def _random_inputs(n, h, w, c, m, seed=0):
    rng = np.random.default_rng(seed)
    bf = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float32)  # noqa
    xq = tchain.chain_quantize(torch.from_numpy(np.abs(rng.standard_normal(
        (n, h, w, c))).astype(np.float32) * 3), 1.0).float().numpy()
    wq = lambda *s: bf(np.asarray(jsfp.quantize_weight(jnp.asarray(  # noqa
        rng.standard_normal(s).astype(np.float32) * 4), 8)))
    aff = lambda k: ((rng.random(k) * 0.02 + 1e-3).astype(np.float32),  # noqa
                     (rng.standard_normal(k) * 0.5).astype(np.float32))
    a1, b1 = aff(m)
    a2, b2 = aff(m)
    a3, b3 = aff(c)
    idn = bf((rng.standard_normal((n, h, w, c)) * 2).astype(np.float32))
    return [xq, idn, wq(c, m), wq(3, 3, m, m), wq(m, c), a1, b1, a2, b2, a3,
            b3]


def _assert_band_empty(args, recips):
    """The pre-quantize values of y1, y2 and y3, in float64 (exact here),
    scaled as the quantizer scales them: each is 0 or at least 0.0625."""
    xq, idn, w1, w2, w3, a1, b1, a2, b2, a3, b3 = [
        a.astype(np.float64) for a in args]
    n, h, w, c = xq.shape
    m = w1.shape[1]

    def check_and_quantize(v, recip):
        s = v.astype(np.float32) * np.float32(recip)
        assert ((s == 0) | (s >= 0.0625)).all(), s[(s > 0) & (s < 0.0625)]
        return tchain.chain_quantize(torch.from_numpy(v.astype(np.float32)),
                                     recip).double().numpy()

    y1 = np.maximum(xq.reshape(-1, c) @ w1 * a1 + b1, 0)
    y1p = np.pad(check_and_quantize(y1, recips["recip2"]).reshape(
        n, h, w, m), ((0, 0), (1, 1), (1, 1), (0, 0)))
    y2 = sum(y1p[:, dy:dy + h, dx:dx + w, :].reshape(-1, m) @ w2[dy, dx]
             for dy in range(3) for dx in range(3))
    y2q = check_and_quantize(np.maximum(y2 * a2 + b2, 0), recips["recip3"])
    y3 = np.maximum(y2q @ w3 * a3 + b3 + idn.reshape(-1, c), 0)
    check_and_quantize(y3, recips["recip_next"])
    return y3.reshape(n, h, w, c)


def _jax_chain(args, emit_raw, block_images=4):
    bf = [jnp.asarray(a, jnp.bfloat16) for a in args[:5]]
    f32 = [jnp.asarray(a) for a in args[5:]]
    raw, q = jax.jit(lambda *a: jchain.bottleneck_chain(
        *a, emit_raw=emit_raw, block_images=block_images, interpret=True,
        **RECIPS))(*bf, *f32)
    return (np.asarray(raw, np.float32) if emit_raw else None,
            np.asarray(q, np.float32))


def _port_chain(args, **kw):
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in args[:5]]
    f32 = [torch.from_numpy(a) for a in args[5:]]
    raw, q = tchain.bottleneck_chain(*bf, *f32, **RECIPS, **kw)
    return (None if raw is None else raw.float().numpy(),
            None if q is None else q.float().numpy())


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("emit_raw", [True, False], ids=["raw_q", "q_only"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_bit_equal_to_jax_on_exact_inputs(shape, emit_raw):
    n, h, w, bi = shape
    args = _exact_inputs(n, h, w, C, M, seed=h * w + n)
    y3 = _assert_band_empty(args, RECIPS)
    want_raw, want_q = _jax_chain(args, emit_raw, bi)
    raw, q = _port_chain(args, emit_raw=emit_raw)
    np.testing.assert_array_equal(_bits(q), _bits(want_q))
    if emit_raw:
        np.testing.assert_array_equal(_bits(raw), _bits(want_raw))
        np.testing.assert_array_equal(
            raw, y3.astype(np.float32).astype(ml_dtypes.bfloat16).astype(
                np.float32))
    else:
        assert raw is None
    # the wide range of the inputs reaches many quantizer bins
    assert len(np.unique(q)) > 20


def _steps(got, want):
    """|index difference| over the quantizer's emitted values."""
    idx = lambda a: np.searchsorted(EMITTED, np.abs(a)) * np.sign(a)  # noqa
    return np.abs(idx(got) - idx(want))


@pytest.mark.parametrize("shape", SHAPES + [(1, 14, 14, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_on_random_inputs(shape):
    """Random values: the two sum in other orders, so raw is held to the
    reordering bound plus one ulp wherever no bin of y1 or y2 flipped
    upstream; a flip there moves a whole pixel's conv3 sums by a quantizer
    step times a weight, so at most 2% of raw elements may exceed the bound
    (the cosine stays above 0.99999).  q may differ by one step where its
    input crosses a bin edge, in at most 1% of elements."""
    n, h, w, bi = shape
    c, m = (1024, 256) if h == 14 else (C, M)
    args = _random_inputs(n, h, w, c, m, seed=n + h)
    want_raw, want_q = _jax_chain(args, True, bi)
    raw, q = _port_chain(args)
    y2q_mag = np.abs(args[4]).sum(0) * 15.33   # |y2q| <= clamp, M terms
    delta = m * 2.0**-22 * (y2q_mag * args[9] + np.abs(args[10])
                            + np.abs(args[1]))
    ulp = np.spacing(np.abs(want_raw).astype(ml_dtypes.bfloat16).astype(
        np.float32) + delta) * 2**16
    beyond = np.abs(raw - want_raw) > delta + ulp
    assert beyond.mean() <= 0.02, beyond.mean()
    cos = float((raw * want_raw).sum() / np.linalg.norm(raw)
                / np.linalg.norm(want_raw))
    assert cos > 0.99999, cos
    steps = _steps(q, want_q)
    assert steps.max() <= 1 or (steps > 1).mean() <= 1e-3, steps.max()
    assert (steps > 0).mean() <= 0.01, (steps > 0).mean()


def test_chain_quantize_bit_equal_to_jax():
    """The chain's quantize of float32 values (JAX ``chain._q``) over every
    finite bf16 value and its float32 neighbours, both signs, at two
    scales."""
    every = torch.arange(0x7F80, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).float().numpy()
    x = np.concatenate([every, np.nextafter(every, np.float32(np.inf)),
                        np.nextafter(every, np.float32(0))])
    x = np.concatenate([x, -x])
    for recip in (1.0, 0.37):
        want = np.asarray(jax.jit(lambda v: jchain._q(v, recip))(
            jnp.asarray(x)), np.float32)
        got = tchain.chain_quantize(torch.from_numpy(x), recip).float().numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_plan_bands_and_limits():
    """Rows per band and blocks per band at ResNet-50's shapes, each GEMM
    of a band in at most two 64-row wgmma tiles: stage 2 in two bands of 7
    rows (a whole 14x14 image takes four tiles), stage 3 in whole 7x7
    images, split over a pair of blocks at batch 64 (128 blocks) and not at
    256, stage 1 in bands of 2; and the limit that keeps stage 0 off the
    card."""
    assert tchain._plan(64, 14, 14, 1024, 256) == (7, 1)
    assert tchain._plan(64, 7, 7, 2048, 512) == (7, 2)
    assert tchain._plan(256, 7, 7, 2048, 512) == (7, 1)
    assert tchain._plan(64, 28, 28, 512, 128) == (2, 1)
    # M or C that does not halve into multiples of 16: no split
    assert tchain._plan(2, 9, 11, 48, 48) == (1, 1)
    for w, m, rows in ((14, 256, 7), (7, 512, 4), (7, 512, 7), (28, 128, 2)):
        tiles, smem = tchain._smem_bytes(w, m, rows)
        assert tiles <= tchain.MAX_ROW_TILES and smem <= tchain.SMEM_LIMIT
    assert tchain._smem_bytes(14, 256, 14)[0] > tchain.MAX_ROW_TILES
    assert tchain._smem_bytes(28, 128, 3)[0] > tchain.MAX_ROW_TILES
    assert tchain._smem_bytes(7, 1024, 7)[1] > tchain.SMEM_LIMIT
    with pytest.raises(ValueError, match="56x56"):
        tchain._plan(64, 56, 56, 256, 64)
    with pytest.raises(ValueError, match="multiples of 16"):
        tchain._plan(1, 7, 7, 64, 24)


def test_ftz_route_only_without_subnormals():
    """K6 folds its epilogues' flushes into FTZ instructions only when no
    affine parameter or reciprocal is subnormal."""
    params = [torch.full((16,), v) for v in (0.5, -1.0, 0.25, 0.0, 2.0, 3.0)]
    assert tchain.ftz_route(params, (0.2, 4.0, 1.0))
    assert not tchain.ftz_route(params, (0.2, 1e-40, 1.0))
    params[4] = params[4].clone()
    params[4][3] = -1e-41
    assert not tchain.ftz_route(params, (0.2, 4.0, 1.0))


def test_non_cpu_tensors_never_take_the_plain_version():
    """A CPU tensor runs the plain version and counts nothing; any other
    device goes to the launch path, which refuses what is not on one CUDA
    device (meta tensors here) instead of falling back."""
    tk.reset_launches()
    args = [torch.from_numpy(a) for a in _exact_inputs(1, 3, 3, 16, 16)]
    args[:5] = [a.to(torch.bfloat16) for a in args[:5]]
    tchain.bottleneck_chain(*args, **RECIPS)
    assert tk.launches()["bottleneck_chain"] == 0
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        tchain.bottleneck_chain(*meta, **RECIPS)
    with pytest.raises(ValueError, match="expected"):
        tchain.bottleneck_chain(*meta[:2], meta[2].float(), *meta[3:],
                                **RECIPS)
    with pytest.raises(ValueError, match="nothing"):
        tchain.bottleneck_chain(*args, **RECIPS, emit_raw=False,
                                emit_q=False)
    assert set(tk.launches().values()) == {0}


# ---------------------------------------------------------------------------
# the fused executor under policy={"chain": {2, 3}}
# ---------------------------------------------------------------------------


def _scale_id(name: str) -> int:
    if name == "conv1":
        return 0
    if name == "fc":
        return 53
    stage, block, conv = name.split("_", 2)
    base = STAGES[int(stage[len("layer"):]) - 1][3]
    if conv == "down_conv":
        return base
    return base + 3 * int(block) + int(conv[-1])


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def executor_run():
    """2x64x64 images (at 32x32 stage 3 would be 1x1 and never touch the
    padding), JAX's frozen bf16 weights and the port's on the same
    variables, and the port's logits under the chain policy and the default
    with the number of plain K6 calls of the chain forward."""
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    jm = jmodels.create_model("resnet", 32)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1, :32, :32]),
                train=False)
    v_np = jax.tree.map(np.asarray, v)
    scales = jcalib.load_scales("resnet50_imgnet")
    # JAX's frozen kernels Q(kernel * f32(1/kw)), as bf16, all through the
    # quantizer as one vector (one compile)
    names = [n for n, lv in v_np["params"].items() if "kernel" in lv]
    scaled = [v_np["params"][n]["kernel"] * (np.float32(1) / np.float32(
        scales.kw[_scale_id(n)])) for n in names]
    flat = np.asarray(jsfp.quantize_weight(jnp.asarray(
        np.concatenate([a.ravel() for a in scaled])), 8))
    params, at = {n: dict(lv) for n, lv in v_np["params"].items()}, 0
    for n, a in zip(names, scaled):
        params[n]["kernel"] = flat[at:at + a.size].reshape(a.shape).astype(
            ml_dtypes.bfloat16)
        at += a.size
    vf = {"params": params, "batch_stats": v_np["batch_stats"]}

    def port(packed):
        model = load_jax_variables(tmodels.create_model("resnet", 8), v_np)
        if packed:
            tfreeze.pack(model)
        else:
            tfreeze.prequantize(model, torch.bfloat16)
        return tfused.prepare(model.eval(), device="cpu")

    frozen, packed = port(False), port(True)
    calls = []
    plain = tchain.bottleneck_chain_plain
    tchain.bottleneck_chain_plain = (
        lambda *a, **k: calls.append(a[0].shape) or plain(*a, **k))
    tk.reset_launches()
    try:
        with torch.no_grad():
            chain = tfused.fused_apply(frozen, torch.from_numpy(x),
                                       policy={"chain": {2, 3}})
    finally:
        tchain.bottleneck_chain_plain = plain
    launches = tk.launches()
    with torch.no_grad():
        chain_packed = tfused.fused_apply(packed, torch.from_numpy(x),
                                          policy={"chain": [3, 2]})
        # JAX's default placement (chain off; the port's default is {2, 3})
        default = tfused.fused_apply(frozen, torch.from_numpy(x),
                                     policy={"chain": frozenset()})
    return dict(x=x, vf=vf, scales=scales, chain=chain,
                chain_packed=chain_packed, default=default, calls=calls,
                launches=launches, packed=packed)


def test_fused_chain_matches_jax_chain(executor_run):
    """JAX's own bar is cosine > 0.995 and equal top-1; measured 0.99981
    here, so the bar is 0.999."""
    r = executor_run
    want = np.asarray(jax.jit(lambda v, xx: jfused.fused_apply(
        v, xx, scales=r["scales"], policy={"chain": frozenset({2, 3})},
        interpret=True))(r["vf"], jnp.asarray(r["x"])), np.float32)
    got = r["chain"].float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _cos(got, want) > 0.999, _cos(got, want)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


def test_fused_chain_matches_default_executor(executor_run):
    """JAX's bar between its chain and production executors
    (tests/test_resnet_fused.py:96-112), tightened to 0.999 (measured
    0.99968): the quantizes see the same values up to summation order."""
    got = executor_run["chain"].float().numpy()
    want = executor_run["default"].float().numpy()
    assert _cos(got, want) > 0.999, _cos(got, want)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


def test_fused_chain_packed_bit_equal_to_float_frozen(executor_run):
    r = executor_run
    assert r["packed"].blocks["layer3_1"]["conv1"].w.dtype == torch.uint8
    assert r["packed"].chain["layer3_1"].w1.dtype == torch.bfloat16
    np.testing.assert_array_equal(r["chain_packed"].view(torch.int16).numpy(),
                                  r["chain"].view(torch.int16).numpy())


def test_fused_chain_runs_k6_at_every_stride1_block_of_stages_2_and_3(
        executor_run):
    """Blocks 1-5 of stage 2 (4x4 at 64x64) and 1-2 of stage 3 (2x2): seven
    chain calls per forward, on the plain version (CPU), with no launch."""
    shapes = executor_run["calls"]
    assert shapes == [(2, 4, 4, 1024)] * 5 + [(2, 2, 2, 2048)] * 2
    assert set(executor_run["launches"].values()) == {0}


def test_fused_chain_decides_k6_route_once_per_block(executor_run):
    """K6's route is decided with the block's weights, from its affines
    and reciprocals: the FTZ route for the served blocks, the exact one
    when an affine parameter or a reciprocal is subnormal."""
    fw = executor_run["packed"]
    assert len(fw.chain) == 7 and all(cw.ftz for cw in fw.chain.values())
    blocks = dict(fw.blocks)
    blk = dict(blocks["layer3_1"])
    shift = blk["conv3"].shift.clone()
    shift[5] = -1e-40
    blk["conv3"] = dataclasses.replace(blk["conv3"], shift=shift)
    blocks["layer3_1"] = blk
    sub = dataclasses.replace(fw, blocks=blocks, chain={})
    assert not tfused._chain_weights(sub, "layer3_1", (0.2, 4.0, 1.0)).ftz
    fresh = dataclasses.replace(fw, chain={})
    assert tfused._chain_weights(fresh, "layer3_1", (0.2, 4.0, 1.0)).ftz
    assert not tfused._chain_weights(dataclasses.replace(fw, chain={}),
                                     "layer3_1", (0.2, 1e-40, 1.0)).ftz


@pytest.mark.parametrize("policy", [
    {"chain": {4}}, {"chain": "23"}, {"chain": 3}, {"chain": {2}, "dw": "x"},
    {"conv1": "pallas"}], ids=str)
def test_fused_rejects_bad_chain_policies(executor_run, policy):
    with pytest.raises(ValueError, match="policy"):
        tfused.fused_apply(executor_run["packed"], torch.zeros(1, 32, 32, 3),
                           policy=policy)


@pytest.mark.parametrize("policy", [{"chain": {2, 3}}, None],
                         ids=["chain23", "default"])
def test_engine_serves_the_chain_policy(monkeypatch, policy):
    """Stages 2 and 3 through K6, asked for or by default."""
    eng = InferenceEngine("resnet", qbit=8, batch_size=1, image_size=32,
                          device="cpu", seed=0, policy=policy)
    calls = []
    plain = tchain.bottleneck_chain_plain
    monkeypatch.setattr(tchain, "bottleneck_chain_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    logits = eng.predict(np.ones((1, 32, 32, 3), np.float32))
    assert logits.shape == (1, 1000) and np.isfinite(logits).all()
    assert len(calls) == 7
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine("resnet", qbit=8, policy={"chain": {2, 3}})
