"""The port's SLFP8 module path held against the JAX package on the CPU:
SqueezeNet 1.0 and AlexNet (new to the port) and ResNet-50 with
``use_pallas=True``, whose 1x1 convs and dense layers go to K4 (here its
plain version), the weight bridge, freezing and packing, the ceil-mode pool,
the calibration copies and the engine's routing rules."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cnns_slfp_quantization_tpu import calib as jcalib
from cnns_slfp_quantization_tpu import models as jmodels
from cnns_slfp_quantization_tpu.models import squeezenet as jsqueezenet
from cnns_slfp_quantization_tpu.ops import freeze as jfreeze
from cnns_slfp_quantization_tpu.ops import sfp as jsfp
from cnns_slfp_quantization_tpu_torch import calib as tcalib
from cnns_slfp_quantization_tpu_torch import kernels as tk
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as tfm
from cnns_slfp_quantization_tpu_torch.models import alexnet as talexnet
from cnns_slfp_quantization_tpu_torch.models import squeezenet as tsqueezenet
from cnns_slfp_quantization_tpu_torch.models.resnet50 import STAGES
from cnns_slfp_quantization_tpu_torch.ops import freeze as tfreeze
from cnns_slfp_quantization_tpu_torch.ops import sfp as tsfp
from cnns_slfp_quantization_tpu_torch.ops.layers import relu
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from cnns_slfp_quantization_tpu_torch.train.checkpoint import (
    load_jax_variables)

REPO = pathlib.Path(__file__).resolve().parents[1]
# (image size, classes, K4 launches per forward) at the tests' small sizes
NETS = {"squeezenet": (32, 1000, 17), "alexnet": (64, 10, 3),
        "resnet": (32, 1000, 37)}


def _scale_id(net: str, name: str) -> int:
    """Scale index of a quant layer from its flax name."""
    if net == "squeezenet":
        if name == "conv0":
            return 0
        if name == "classifier":
            return 25
        fire, part = name.split("_")
        return 1 + 3 * int(fire[len("fire"):]) + (
            "squeeze", "expand1", "expand3").index(part)
    if net == "alexnet":
        return int(name[-1]) if name.startswith("conv") else 4 + int(name[-1])
    if name == "conv1":
        return 0
    if name == "fc":
        return 53
    stage, block, conv = name.split("_", 2)
    base = STAGES[int(stage[len("layer"):]) - 1][3]
    if conv == "down_conv":
        return base
    return base + 3 * int(block) + int(conv[-1])


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _setup(net):
    size, classes, _ = NETS[net]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    jm = jmodels.create_model(net, 32, num_classes=classes)
    v = jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(x[:1]))
    v_np = _to_numpy(v)
    scales = jcalib.load_scales(
        {"squeezenet": "squeezenet_imgnet", "alexnet": "alexnet_imgnet",
         "resnet": "resnet50_imgnet"}[net])
    # frozen kernels without a capture run: Q(kernel * f32(1/kw)) per
    # quant layer (JAX's quotient under jit), all through the quantizer as one vector (one compile)
    names = [n for n, lv in v_np["params"].items() if "kernel" in lv]
    scaled = [v_np["params"][n]["kernel"] * (np.float32(1) / np.float32(
        scales.kw[_scale_id(net, n)])) for n in names]
    flat = jsfp.quantize_weight(
        jnp.asarray(np.concatenate([a.ravel() for a in scaled])), 8)
    flat_q, flat_c = np.asarray(flat), np.asarray(jsfp.pack_slfp34(flat))
    values, codes, at = {}, {}, 0
    for n, a in zip(names, scaled):
        values[n] = flat_q[at:at + a.size].reshape(a.shape)
        codes[n] = flat_c[at:at + a.size].reshape(a.shape)
        at += a.size

    def with_kernels(kernels):
        params = {n: dict(lv) for n, lv in v_np["params"].items()}
        for n, k in kernels.items():
            params[n]["kernel"] = k
        return dict(v_np, params=params)

    return dict(x=x, v=v, v_np=v_np, values=with_kernels(values),
                codes=with_kernels(codes), size=size, classes=classes)


@pytest.fixture(scope="module")
def setups():
    cache = {}

    def get(net):
        if net not in cache:
            cache[net] = _setup(net)
        return cache[net]
    return get


def _port(net, s, qbit=8, **kw):
    """The port's model with the fixture's float weights."""
    model = tmodels.create_model(net, qbit, num_classes=s["classes"],
                                 image_size=s["size"], **kw)
    return load_jax_variables(model, s["v_np"]).eval()


@pytest.fixture(scope="module")
def frozen_models(setups):
    """net -> (packed, float-frozen bf16) SLFP8 bf16 port models, built once;
    a test sets their layers' ``use_pallas`` with :func:`_route`."""
    cache = {}

    def get(net):
        if net not in cache:
            s = setups(net)
            cache[net] = tuple(
                fn(_port(net, s, compute_dtype=torch.bfloat16))
                for fn in (tfreeze.pack,
                           lambda m: tfreeze.prequantize(m, torch.bfloat16)))
        return cache[net]
    return get


def _route(model, use_pallas):
    for _, layer in tfreeze.quant_layers(model):
        layer.use_pallas = use_pallas
    return model


def _run(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).float().numpy()


# ---------------------------------------------------------------------------
# shipped constants, pool, bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["squeezenet_imgnet", "alexnet_imgnet",
                                  "resnet50_imgnet"])
def test_calib_copies_are_byte_equal(name):
    """Byte for byte, but for the ``source`` line: it names the reference
    file without the directory it was mounted at."""
    mine = (REPO / "cnns_slfp_quantization_tpu_torch/calib/constants"
            / f"{name}.json").read_text().splitlines()
    theirs = (REPO / "cnns_slfp_quantization_tpu/calib/constants"
              / f"{name}.json").read_text().splitlines()
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        if a.startswith(' "source": '):
            assert b.endswith(a.split("reference ", 1)[1])
        else:
            assert a == b
    a, b = tcalib.load_scales(name), jcalib.load_scales(name)
    np.testing.assert_array_equal(a.ka, b.ka)
    np.testing.assert_array_equal(a.kw, b.kw)


@pytest.mark.parametrize("size", [7, 13, 27, 54, 109])
def test_ceil_max_pool_matches_jax(size):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 4)).astype(np.float32)
    want = np.asarray(jsqueezenet._ceil_max_pool(jnp.asarray(x)))
    got = tsqueezenet.ceil_max_pool(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("net", ["squeezenet", "alexnet"])
def test_load_jax_variables_round_trips_every_leaf(setups, net):
    s = setups(net)
    model = _port(net, s, qbit=32)
    sd = model.state_dict()
    leaves = [(m, leaf, a) for m, lv in s["v_np"]["params"].items()
              for leaf, a in lv.items()]
    assert len(leaves) == len(sd) == 2 * len(tfreeze.quant_layers(model))
    for mod, leaf, a in leaves:
        t = sd[f"{mod}.{'weight' if leaf == 'kernel' else 'bias'}"].numpy()
        back = (np.transpose(t, (2, 3, 1, 0)) if t.ndim == 4
                else t.T if t.ndim == 2 else t)
        np.testing.assert_array_equal(back, a, err_msg=f"{mod}/{leaf}")


def test_alexnet_fc1_width_follows_the_image_size(setups):
    assert talexnet.feature_size(224) == 6   # 256 * 36 = 9216, the reference
    assert talexnet.feature_size(64) == 1
    s = setups("alexnet")
    assert s["v_np"]["params"]["fc1"]["kernel"].shape[0] == 256


# ---------------------------------------------------------------------------
# module paths against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["squeezenet", "alexnet"])
def test_fp32_module_path_matches_jax(setups, net):
    s = setups(net)
    jm = jmodels.create_model(net, 32, num_classes=s["classes"])
    want = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        s["v"], jnp.asarray(s["x"])))
    got = _run(_port(net, s, qbit=32), s["x"])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("net", ["squeezenet", "alexnet"])
def test_slfp8_k4_path_matches_jax_pallas(setups, frozen_models, net):
    """Packed weights, bf16, use_pallas=True: JAX's Pallas K4 in interpret
    mode against the port's K4 (its plain version on the CPU)."""
    s = setups(net)
    jm = jmodels.create_model(net, 8, compute_dtype=jnp.bfloat16,
                              frozen_weights=True, use_pallas=True,
                              num_classes=s["classes"])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(
            lambda vv, xx: jm.apply(vv, xx, train=False))(
                s["codes"], jnp.asarray(s["x"])), np.float32)
    got = _run(_route(frozen_models(net)[0], True), s["x"])
    assert np.isfinite(got).all() and got.shape == want.shape
    assert _cos(got, want) > 0.995
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


def test_resnet_k4_path_matches_jax_module_path(setups, frozen_models):
    """ResNet-50 with use_pallas=True (37 layers on K4) against JAX's
    use_pallas=False module path, which JAX calls numerically equivalent
    (layers.py:159-161) and which compiles faster."""
    s = setups("resnet")
    jm = jmodels.create_model("resnet", 8, compute_dtype=jnp.bfloat16,
                              frozen_weights=True, use_pallas=False)
    vals = {"params": {n: {k: np.asarray(a, np.float32)
                           for k, a in lv.items()}
                       for n, lv in s["values"]["params"].items()},
            "batch_stats": s["v_np"]["batch_stats"]}
    want = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        vals, jnp.asarray(s["x"])), np.float32)
    got = _run(_route(frozen_models("resnet")[0], True), s["x"])
    assert np.isfinite(got).all()
    assert _cos(got, want) > 0.995
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("net", list(NETS))
def test_packed_bit_equal_to_float_frozen(setups, frozen_models, net,
                                          use_pallas):
    """K4 (use_pallas=True) and the conv / matmul route (False; on the CPU
    also what None takes)."""
    x = torch.from_numpy(setups(net)["x"])
    outs = []
    for model in frozen_models(net):
        with torch.no_grad():
            outs.append(_route(model, use_pallas)(x))
    np.testing.assert_array_equal(outs[0].view(torch.int16).numpy(),
                                  outs[1].view(torch.int16).numpy())


@pytest.mark.parametrize("use_pallas", [True, None, False])
@pytest.mark.parametrize("net", list(NETS))
def test_use_pallas_routes_the_eligible_layers(monkeypatch, setups,
                                               frozen_models, net,
                                               use_pallas):
    """True sends every 1x1 conv and dense layer to K4 (17 in SqueezeNet,
    3 in AlexNet, 37 in ResNet-50); None only packed weights on the card,
    so none here; False none.  A CPU tensor takes the plain version and
    counts no launch."""
    s = setups(net)
    calls = []
    plain = tfm.fused_quant_matmul_plain
    monkeypatch.setattr(tfm, "fused_quant_matmul_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    model = _route(frozen_models(net)[0], use_pallas)
    tk.reset_launches()
    _run(model, s["x"])
    assert len(calls) == (NETS[net][2] if use_pallas else 0)
    assert set(tk.launches().values()) == {0}


def test_pack_matches_jax_pack_variables(setups):
    """The port packs every quant layer, biased ones included, to exactly
    the codes JAX's pack_variables stores, and keeps each bias in float32.
    Under jit XLA computes JAX's ``kernel / kw`` as ``kernel * f32(1/kw)``
    (227,334 of AlexNet conv2's 663,552 quotients differ from a true
    division, 2 of its codes); the port multiplies by the same reciprocal."""
    s = setups("alexnet")
    cap = jmodels.create_model("alexnet", 8, capture="full",
                               num_classes=s["classes"])
    jp = _to_numpy(jfreeze.pack_variables(cap, s["v"],
                                          jnp.asarray(s["x"][:1])))
    packed = {n: lv["kernel"] for n, lv in jp["params"].items()
              if lv["kernel"].dtype == np.uint8}
    model = tfreeze.pack(_port("alexnet", s))
    layers = tfreeze.quant_layers(model)
    assert len(packed) == len(layers) == 8
    scales = jcalib.load_scales("alexnet_imgnet")
    n_true_division_differs = 0
    for name, layer in layers:
        assert layer.weight.dtype == torch.uint8
        assert layer.bias.dtype == torch.float32
        kernel = s["v_np"]["params"][name]["kernel"]
        kw = np.float32(scales.kw[_scale_id("alexnet", name)])
        mine = (np.transpose(layer.weight.numpy(), (2, 3, 1, 0))
                if kernel.ndim == 4 else layer.weight.numpy().T)
        np.testing.assert_array_equal(mine, packed[name], err_msg=name)
        true_div = np.asarray(jsfp.pack_slfp34(jsfp.quantize_weight(
            jnp.asarray(kernel / kw), 8)))
        n_true_division_differs += int((true_div != packed[name]).sum())
        np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                      s["v_np"]["params"][name]["bias"])
    # the case the repair is about: a true division moves some codes
    assert n_true_division_differs > 0


def _quotient_inputs(ka, shape, rng):
    """float32 inputs of ``shape``, random signs, each at a rounding edge of
    ``quantize_act`` where ``x / ka`` and ``x * f32(1/ka)`` quantize to
    different values; the last entry of the leading axis is all zeros (its
    outputs are the bias term alone)."""
    ka = np.float32(ka)
    r = np.float32(1) / ka
    # quotients just at the half-way mantissa pattern of every 4-bit bin
    # from 2**-4 to 2**4, and the x within 8 ulps of each quotient * ka
    t = ((np.arange(123, 131)[:, None] << 23) | (np.arange(16) << 19)
         | 0x40000).ravel().astype(np.int32).view(np.float32)
    x0 = (t.astype(np.float64) * np.float64(ka)).astype(np.float32)
    x = (x0.view(np.int32)[:, None] + np.arange(-8, 9)).ravel().view(
        np.float32)
    q = [tsfp.quantize_act(torch.from_numpy(v), 8).numpy()
         for v in (x / ka, x * r)]
    flips = x[q[0] != q[1]]
    assert len(flips) > 16
    out = flips[np.arange(int(np.prod(shape))) % len(flips)].reshape(shape)
    out = out * rng.choice(np.float32([-1, 1]), shape)
    out[-1] = 0
    return out


def _quotient_biases(ka, kw, n, rng):
    """n float32 biases whose ``b / (ka*kw)`` differs from ``b * f32(1/(ka*
    kw))`` (about one random bias in ten)."""
    kaw = np.float32(ka) * np.float32(kw)
    b = rng.standard_normal(64 * n).astype(np.float32) * np.float32(0.1)
    b = b[b / kaw != b * (np.float32(1) / kaw)][:n]
    assert len(b) == n
    return b


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_f32_quotients_are_jax_reciprocal_multiplies(kind):
    """At ``qbit=8, compute_dtype=None`` JAX computes ``quantize_act(x /
    ka)`` and ``bias / (ka * kw)``; under jit XLA divides by the constant as
    a multiply by its float32 reciprocal.  Inputs sit where a true division
    lands in the other quantizer bin, biases where it rounds the other way;
    weights are ``kw`` on one tap per output and 0 elsewhere, so every sum
    has one term and is exact in any order.  The port must match bit for
    bit."""
    import flax.linen as fnn

    from cnns_slfp_quantization_tpu.ops import layers as jlayers
    from cnns_slfp_quantization_tpu_torch.ops import layers as tlayers

    ka, kw, c = 0.37, 0.11, 16
    rng = np.random.default_rng(0)
    if kind == "dense":
        x = _quotient_inputs(ka, (4, c), rng)
        kernel = np.eye(c, dtype=np.float32) * np.float32(kw)
        def jlayer():
            return jlayers.QuantDense(c, qbit=8, ka=ka, kw=kw, name="layer")
        tlayer = tlayers.QuantDense(c, c, qbit=8, ka=ka, kw=kw)
    else:
        x = _quotient_inputs(ka, (2, 5, 5, c), rng)
        kernel = np.zeros((3, 3, c, c), np.float32)
        kernel[1, 1] = np.eye(c, dtype=np.float32) * np.float32(kw)
        def jlayer():
            return jlayers.QuantConv(c, (3, 3), qbit=8, ka=ka, kw=kw,
                                     padding=1, use_bias=True, name="layer")
        tlayer = tlayers.QuantConv(c, c, 3, padding=1, use_bias=True,
                                   qbit=8, ka=ka, kw=kw)

    class One(fnn.Module):
        @fnn.compact
        def __call__(self, v):
            return jlayer()(v)

    jmodel = One()
    v_np = {"params": {"layer": {
        "kernel": kernel, "bias": _quotient_biases(ka, kw, c, rng)}}}
    want = np.asarray(jax.jit(jmodel.apply)(v_np, jnp.asarray(x)))

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layer = tlayer

    port = load_jax_variables(Wrap(), v_np).layer.eval()
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = (port(xt) if kind == "dense"
               else port(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    got = got.contiguous().numpy()
    assert np.isfinite(want).all() and (want != 0).mean() > 0.9
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_relu_yields_positive_zero():
    x = torch.tensor([-0.0, -1.0, 0.0, 2.0]).to(torch.bfloat16)
    assert (relu(x).view(torch.int16) == torch.tensor(
        [0, 0, 0, 0x4000], dtype=torch.int16)).all()


# ---------------------------------------------------------------------------
# the engine (JAX tests/test_serve.py:43-54 over the ported nets)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["squeezenet", "alexnet"])
def test_engine_fused_true_raises_on_unfusable_nets(net):
    with pytest.raises(ValueError, match="fused=True"):
        InferenceEngine(net, qbit=8, fused=True, device="cpu")


def test_engine_auto_rule_and_overrides():
    kw = dict(qbit=8, batch_size=1, image_size=32, device="cpu")
    assert InferenceEngine("resnet", **kw).fused
    # explicit K4 / fp32 requests are not overridden by the auto rule
    assert not InferenceEngine("resnet", use_pallas=True, **kw).fused
    assert not InferenceEngine("resnet", compute_dtype=None, **kw).fused
    assert not InferenceEngine("squeezenet", **kw).fused
    with pytest.raises(ValueError, match="fused=True"):
        InferenceEngine("resnet", qbit=32, fused=True, device="cpu")
    assert InferenceEngine("squeezenet", qbit=32, device="cpu",
                           batch_size=1).image_size == 224


def test_engine_module_path_serves_packed_weights(setups):
    eng = InferenceEngine("squeezenet", qbit=8, batch_size=2, image_size=32,
                          pack_weights=True, use_pallas=True, device="cpu")
    assert not eng.fused
    assert eng.model.fire0_squeeze.weight.dtype == torch.uint8
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    logits = eng.predict(x)
    assert logits.shape == (3, 1000) and np.isfinite(logits).all()
    with torch.no_grad():
        direct = eng.model(torch.from_numpy(x[2:3])).float().numpy()
    np.testing.assert_array_equal(logits[2], direct[0])
    np.testing.assert_array_equal(eng.classify(x), np.argmax(logits, -1))
    frozen = InferenceEngine("squeezenet", qbit=8, batch_size=2,
                             image_size=32, use_pallas=True, device="cpu")
    np.testing.assert_array_equal(frozen.predict(x).view(np.int32),
                                  logits.view(np.int32))
