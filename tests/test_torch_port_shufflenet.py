"""The port's ShuffleNetV2 held against the JAX package on the CPU: the
fp32 and SLFP8 module paths (float-frozen, and packed with K4's plain
version on the 1x1 convs and the classifier), the fused executor against
JAX's ``shufflenetv2_fused.fused_apply`` and against the port's module
path, its quantize sites per forward, the channel shuffle and the engine's
routing rule.

Width ratio 0.5 at 32x32, batch 2, as JAX's own test runs it.  Scales are
absmax / 15 (ShuffleNetV2's divisor) of each quantized layer's input and
weight over one float32 forward of the same weights, read by forward
hooks: the shipped constants belong to trained weights and saturate the
quantizers of a random-init model.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu import calib as jcalib
from cnns_slfp_quantization_tpu import models as jmodels
from cnns_slfp_quantization_tpu.models import shufflenetv2 as jshuffle
from cnns_slfp_quantization_tpu.models import shufflenetv2_fused as jfused
from cnns_slfp_quantization_tpu.ops import sfp as jsfp
from cnns_slfp_quantization_tpu_torch import calib as tcalib
from cnns_slfp_quantization_tpu_torch import kernels as tk
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.kernels import epilogue as tk3
from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as tfm
from cnns_slfp_quantization_tpu_torch.kernels import quantize as tk1
from cnns_slfp_quantization_tpu_torch.models import shufflenetv2 as tshuffle
from cnns_slfp_quantization_tpu_torch.models import shufflenetv2_fused as tfused
from cnns_slfp_quantization_tpu_torch.ops import freeze as tfreeze
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from cnns_slfp_quantization_tpu_torch.train.checkpoint import (
    load_jax_variables)

# the suite runs in several processes at once: one intra-op thread each
# (torch's default, a thread per core in each, spins on shared cores)
torch.set_num_threads(1)

RATIO = 0.5
DIVISOR = 15.0
# per forward: K1 at the stem, 2 per unit (its input, res conv1's output),
# conv5 and the classifier; K3 at the stem and after every depthwise conv
K1_PER_FWD, K3_PER_FWD = 1 + 2 * 16 + 2, 1 + 16 + 3


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _same(got, want, bar=0.995):
    """Cosine above ``bar`` and the same top-1 on every row."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _cos(got, want) > bar, _cos(got, want)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


def _agree(got, want, bar):
    """JAX's bar (tests/test_shufflenet_fused.py:49-57): cosine above
    ``bar``, and equal top-1 on every row whose top-2 margin exceeds three
    times the largest elementwise difference."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _cos(got, want) > bar, _cos(got, want)
    diff = np.abs(got - want).max()
    top2 = np.sort(want, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 3 * diff
    np.testing.assert_array_equal(np.argmax(got, -1)[decisive],
                                  np.argmax(want, -1)[decisive])


def _run(fn, x):
    with torch.no_grad():
        return fn(torch.from_numpy(x)).float().numpy()


def _jax_apply(model, variables, x):
    return np.asarray(jax.jit(lambda vv, xx: model.apply(
        vv, xx, train=False))(variables, jnp.asarray(x)), np.float32)


def _hook_scales(model, x):
    """absmax / 15 of every quant layer's input and weight over one
    float32 forward of ``model``."""
    ka, kw, hooks = {}, {}, []
    for _, layer in tfreeze.quant_layers(model):
        def hook(m, inp, out):
            ka[m.layer_id] = float(inp[0].abs().max())
            kw[m.layer_id] = float(m.weight.abs().max())
        hooks.append(layer.register_forward_hook(hook))
    _run(model, x)
    for h in hooks:
        h.remove()
    n = max(ka) + 1
    assert sorted(ka) == list(range(n))
    return (np.array([ka[i] for i in range(n)]) / DIVISOR,
            np.array([kw[i] for i in range(n)]) / DIVISOR)


def _get(tree, dotted):
    for key in dotted.split("."):
        tree = tree[key]
    return tree


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jm = jmodels.create_model("shufflenetv2", 32, ratio=RATIO)
    v = jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(x[:1]))
    v_np = _to_numpy(v)
    fp32 = load_jax_variables(tmodels.create_model(
        "shufflenetv2", 32, ratio=RATIO), v_np).eval()
    ka, kw = _hook_scales(fp32, x)
    scales = jcalib.ScaleSet(ka=ka, kw=kw, divisor=DIVISOR)
    tscales = tcalib.ScaleSet(ka, kw, DIVISOR)
    # frozen kernels Q(kernel * f32(1/kw)) of every quant layer (JAX's
    # quotient under jit), all through the quantizer as one vector
    layers = tfreeze.quant_layers(fp32)
    kernels = [_get(v_np["params"], n)["kernel"] for n, _ in layers]
    scaled = [k * (np.float32(1) / np.float32(kw[layer.layer_id]))
              for k, (_, layer) in zip(kernels, layers)]
    flat = np.asarray(jsfp.quantize_weight(
        jnp.asarray(np.concatenate([a.ravel() for a in scaled])), 8))

    def with_kernels(cast):
        params = _to_numpy(v_np["params"])
        at = 0
        for (name, _), a in zip(layers, scaled):
            _get(params, name)["kernel"] = cast(
                flat[at:at + a.size].reshape(a.shape))
            at += a.size
        return dict(v_np, params=params)

    return dict(x=x, v=v, v_np=v_np, scales=scales, tscales=tscales,
                fp32=fp32, values=with_kernels(lambda k: k),
                values_bf16=with_kernels(
                    lambda k: k.astype(ml_dtypes.bfloat16)))


def _port(s, qbit=8, **kw):
    model = tmodels.create_model("shufflenetv2", qbit, ratio=RATIO,
                                 scales=s["tscales"], **kw)
    return load_jax_variables(model, s["v_np"]).eval()


@pytest.fixture(scope="module")
def frozen(setup):
    """(packed, float-frozen bf16) SLFP8 bf16 port models."""
    return tuple(fn(_port(setup, compute_dtype=torch.bfloat16))
                 for fn in (tfreeze.pack,
                            lambda m: tfreeze.prequantize(m, torch.bfloat16)))


@pytest.fixture(scope="module")
def executors(frozen):
    """(float-frozen, packed) fused executors on the CPU."""
    packed, values = frozen
    return (tfused.prepare(values, device="cpu"),
            tfused.prepare(packed, device="cpu"))


@pytest.fixture(scope="module")
def jax_module_slfp8(setup):
    """JAX's frozen bf16 SLFP8 module path on the fixture's input."""
    jm = jmodels.create_model("shufflenetv2", 8, ratio=RATIO,
                              scales=setup["scales"],
                              compute_dtype=jnp.bfloat16,
                              frozen_weights=True, use_pallas=False)
    return _jax_apply(jm, setup["values"], setup["x"])


# ---------------------------------------------------------------------------
# layout, bridge
# ---------------------------------------------------------------------------


def test_channel_shuffle_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 12)).astype(
        np.float32)
    want = np.asarray(jshuffle.channel_shuffle(jnp.asarray(x), 2))
    got = tshuffle.channel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_units_follow_jax_index_layout(setup):
    """Every unit's scale ids, widths and stride, and the first unit's
    signed input, as JAX's ``stage`` lays them out (:146-160); the loaded
    model holds every one of JAX's leaves."""
    got = tshuffle.units(RATIO)
    assert [u[0] for u in got] == [
        f"stage{s}_u{k}" for s, n in ((2, 4), (3, 8), (4, 4)) for k in range(n)]
    assert got[0][1:] == ([1, 2, 3, 4, 5], 24, 48, 2, False)
    assert got[4][1:] == ([15, 16, 17, 18, 19], 48, 96, 2, True)
    assert got[-1][1:] == ([52, 53, 54], 192, 192, 1, True)
    assert setup["fp32"].stage3_u0.res_conv2.weight.shape == (48, 1, 3, 3)
    n_leaves = sum(1 for c in setup["v_np"].values()
                   for _ in jax.tree.leaves(c))
    assert n_leaves == sum(1 for k in setup["fp32"].state_dict()
                           if not k.endswith("num_batches_tracked"))


# ---------------------------------------------------------------------------
# module paths against JAX
# ---------------------------------------------------------------------------


def test_fp32_module_path_matches_jax(setup):
    jm = jmodels.create_model("shufflenetv2", 32, ratio=RATIO)
    want = _jax_apply(jm, setup["v"], setup["x"])
    got = _run(setup["fp32"], setup["x"])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("packed", [False, True], ids=["frozen", "packed_k4"])
def test_slfp8_module_path_matches_jax(monkeypatch, setup, frozen,
                                      jax_module_slfp8, packed):
    """Float-frozen bf16 weights on the conv route, and packed weights with
    use_pallas=True (the 35 1x1 convs and the classifier on K4's plain
    version), against JAX's frozen bf16 module path."""
    model = frozen[0 if packed else 1]
    for _, layer in tfreeze.quant_layers(model):
        layer.use_pallas = packed
    calls = []
    plain = tfm.fused_quant_matmul_plain
    monkeypatch.setattr(tfm, "fused_quant_matmul_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    got = _run(model, setup["x"])
    assert len(calls) == (2 * 16 + 3 + 1 + 1 if packed else 0)
    _same(got, jax_module_slfp8)


def test_packed_module_path_bit_equal_to_float_frozen(setup, frozen):
    outs = []
    for model in frozen:
        for _, layer in tfreeze.quant_layers(model):
            layer.use_pallas = True
        outs.append(_run(model, setup["x"]))
    np.testing.assert_array_equal(outs[0].view(np.int32),
                                  outs[1].view(np.int32))


# ---------------------------------------------------------------------------
# the fused executor
# ---------------------------------------------------------------------------


def test_fused_apply_matches_jax(setup, executors):
    """Against JAX's ``fused_apply`` on the same frozen weights: cosine
    0.99935 measured here (the sums run in another order, so a few values
    at a quantizer's bin edge flip), the same top-1."""
    s = setup
    want = np.asarray(jax.jit(lambda v, xx: jfused.fused_apply(
        v, xx, scales=s["scales"], ratio=RATIO))(
            s["values_bf16"], jnp.asarray(s["x"])), np.float32)
    got = _run(lambda x: tfused.fused_apply(executors[0], x), s["x"])
    _same(got, want)


def test_fused_apply_matches_port_module_path(setup, frozen, executors):
    """JAX's own bar between its executor and its module path
    (tests/test_shufflenet_fused.py:49-57)."""
    model = frozen[1]
    for _, layer in tfreeze.quant_layers(model):
        layer.use_pallas = False
    _agree(_run(lambda x: tfused.fused_apply(executors[0], x), setup["x"]),
           _run(model, setup["x"]), 0.98)


def test_fused_packed_bit_equal_to_float_frozen(setup, executors):
    x = torch.from_numpy(setup["x"])
    with torch.no_grad():
        a, b = (tfused.fused_apply(fw, x) for fw in executors)
    assert a.dtype == torch.bfloat16
    np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                  b.view(torch.int16).numpy())


def _count_sites(monkeypatch, fw, x):
    """(K1 calls, K3 calls) of one forward, on the plain versions (CPU),
    with no launch."""
    k1, k3 = [], []
    p1, p3 = tk1.act_quantize_plain, tk3.bn_epilogue_plain
    monkeypatch.setattr(tk1, "act_quantize_plain",
                        lambda *a, **k: k1.append(1) or p1(*a, **k))
    monkeypatch.setattr(tk3, "bn_epilogue_plain",
                        lambda *a, **k: k3.append(1) or p3(*a, **k))
    tk.reset_launches()
    out = _run(lambda xx: tfused.fused_apply(fw, xx), x)
    assert set(tk.launches().values()) == {0}
    return len(k1), len(k3), out


def test_fused_quantize_sites_per_forward(monkeypatch, setup, executors):
    """54 quantize sites a forward, as JAX's executor has them: 35 on K1
    and 19 on K3 (the ``loq=False`` posts: bn2 of every unit and the
    shortcut's bn1), plus the stem's K3; each downsample unit quantizes
    its input once for both branches, since their Ka agree."""
    fw = executors[0]
    assert all(u.shared for u in fw.units if u.downsample)
    n1, n3, _ = _count_sites(monkeypatch, fw, setup["x"])
    assert (n1, n3) == (K1_PER_FWD, K3_PER_FWD)


def test_fused_unshared_downsample_quantize(monkeypatch, setup):
    """Where a downsample unit's two Ka differ, its two branches quantize
    their input in two passes, as JAX falls back to (:81-89): one more K1
    launch, and the module path's numerics."""
    ka = setup["tscales"].ka.copy()
    ka[18] *= 1.25                   # stage3_u0's shortcut conv1
    sc = tcalib.ScaleSet(ka, setup["tscales"].kw, DIVISOR)
    model = load_jax_variables(tmodels.create_model(
        "shufflenetv2", 8, ratio=RATIO, scales=sc,
        compute_dtype=torch.bfloat16), setup["v_np"]).eval()
    tfreeze.prequantize(model, torch.bfloat16)
    fw = tfused.prepare(model, device="cpu")
    assert [u.shared for u in fw.units if u.downsample] == [True, False, True]
    n1, n3, got = _count_sites(monkeypatch, fw, setup["x"])
    assert (n1, n3) == (K1_PER_FWD + 1, K3_PER_FWD)
    for _, layer in tfreeze.quant_layers(model):
        layer.use_pallas = False
    _agree(got, _run(model, setup["x"]), 0.98)


def test_fused_rejects_a_policy_and_unfrozen_weights(setup, executors):
    with pytest.raises(ValueError, match="policy"):
        tfused.fused_apply(executors[0], torch.zeros(1, 32, 32, 3),
                           policy={"dw": "torch"})
    with pytest.raises(ValueError, match="frozen"):
        tfused.prepare(_port(setup), device="cpu")


# ---------------------------------------------------------------------------
# the engine (JAX serve.py:63-70, 121-125)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net,fusable,size", [
    ("shufflenetv2", True, 32), ("cifar/shufflenetv2", True, 224),
    ("shufflenetv2_swish", False, 32)])
def test_engine_auto_rule(net, fusable, size):
    kw = dict(qbit=8, batch_size=1, device="cpu")
    eng = InferenceEngine(net, **kw)
    assert eng.fused == fusable and eng.image_size == size
    if fusable:
        assert isinstance(eng.executor, tfused.FusedWeights)
        assert not InferenceEngine(net, use_pallas=True, **kw).fused
        assert not InferenceEngine(net, compute_dtype=None, **kw).fused
    else:
        with pytest.raises(ValueError, match="fused=True"):
            InferenceEngine(net, fused=True, **kw)


def test_engine_fused_decisions_match_module_path():
    """JAX tests/test_serve.py:143-156 on the port: the auto-selected fused
    engine classifies as the module-path engine does."""
    eng = InferenceEngine("shufflenetv2", qbit=8, batch_size=2, device="cpu")
    x = np.random.default_rng(3).normal(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    logits = eng.predict(x)
    assert logits.shape == (2, 100) and np.isfinite(logits).all()
    eng_m = InferenceEngine("shufflenetv2", qbit=8, batch_size=2,
                            device="cpu", fused=False)
    assert eng.fused and not eng_m.fused
    np.testing.assert_array_equal(eng.classify(x), eng_m.classify(x))


@pytest.mark.parametrize("net", ["resnet", "vgg16", "mobilenet",
                                 "inceptionv3"])
def test_ratio_rejected_on_other_nets(net):
    with pytest.raises(ValueError, match="ratio"):
        jmodels.create_model(net, 8, ratio=0.5)
    with pytest.raises(ValueError, match="ratio"):
        tmodels.create_model(net, 8, ratio=0.5)
    assert tmodels.create_model("shufflenetv2", 32, ratio=2).ratio == 2
