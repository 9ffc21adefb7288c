"""The port's MobileNetV1 held against the JAX package on the CPU: the
weight bridge, the fp32 and SLFP8 module paths (frozen and packed, K4's
plain version on the pointwise convs), packing of grouped kernels, the
fused executor under both ``dw`` routes, the engine's routing rule, and the
Swish / layer-output variant with its quantizer and activations.

Scales are calibrated on the test input with JAX's ``calibrate``, as
``tests/test_mobilenet_fused.py`` does: the shipped constants belong to
trained weights and saturate the quantizers of a random-init model.
"""

import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu import calib as jcalib
from cnns_slfp_quantization_tpu import models as jmodels
from cnns_slfp_quantization_tpu.calib import calibrate as jcalibrate
from cnns_slfp_quantization_tpu.models import mobilenetv1_fused as jfused
from cnns_slfp_quantization_tpu.ops import activations as jact
from cnns_slfp_quantization_tpu.ops import freeze as jfreeze
from cnns_slfp_quantization_tpu.ops import sfp as jsfp
from cnns_slfp_quantization_tpu.train import checkpoint as jckpt
from cnns_slfp_quantization_tpu_torch import calib as tcalib
from cnns_slfp_quantization_tpu_torch import kernels as tk
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.kernels import depthwise as tdw
from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as tfm
from cnns_slfp_quantization_tpu_torch.models import mobilenetv1 as tmobilenet
from cnns_slfp_quantization_tpu_torch.models import mobilenetv1_fused as tfused
from cnns_slfp_quantization_tpu_torch.ops import activations as tact
from cnns_slfp_quantization_tpu_torch.ops import freeze as tfreeze
from cnns_slfp_quantization_tpu_torch.ops import sfp as tsfp
from cnns_slfp_quantization_tpu_torch.ops.layers import QuantConv
from cnns_slfp_quantization_tpu_torch import serve as tserve
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from cnns_slfp_quantization_tpu_torch.train.checkpoint import (
    load_jax_variables)

REPO = pathlib.Path(__file__).resolve().parents[1]
# image size of each net at the tests' size (full widths, batch 2)
NETS = {"mobilenet": 32, "mobilenetv1": 32, "mobilenet_swish": 32}
POLICIES = [{"dw": "kernel"}, {"dw": "torch"}]


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _agree(got, want, bar):
    """JAX's bar (tests/test_mobilenet_fused.py:57-62): cosine above
    ``bar``, and equal top-1 on every row whose top-2 margin exceeds three
    times the largest elementwise difference."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    cos = _cos(got, want)
    assert cos > bar, f"cos={cos}"
    diff = np.abs(got - want).max()
    top2 = np.sort(want, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 3 * diff
    np.testing.assert_array_equal(np.argmax(got, -1)[decisive],
                                  np.argmax(want, -1)[decisive])


def _scale_id(name: str) -> int:
    return tmobilenet.FC_ID if name == "fc" else int(name[len("conv"):])


def _setup(net):
    size = NETS[net]
    x = np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    fp = jmodels.create_model(net, 32, capture="absmax")
    # eager init: its dicts keep flax's call order, which the JAX exporter's
    # positional matching reads
    v = fp.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]), train=False)
    res = jcalibrate.calibrate(fp, v, [(x, np.zeros(len(x), np.int32))])
    scales = jcalib.ScaleSet(ka=np.asarray(res.ka_max()) / 15.5,
                             kw=np.asarray(res.kw_max()) / 15.5, divisor=15.5)
    v_np = {c: _to_numpy(v[c]) for c in ("params", "batch_stats")}
    # frozen kernels Q(kernel * f32(1/kw)) of the quant layers (JAX's
    # quotient under jit: XLA multiplies by the reciprocal constant), all
    # through the quantizer as one vector (one compile)
    names = [n for n in v_np["params"]
             if n.startswith("conv") or (n == "fc" and net != "mobilenetv1")]
    scaled = [v_np["params"][n]["kernel"] * (np.float32(1) / np.float32(
        scales.kw[_scale_id(n)])) for n in names]
    flat = jsfp.quantize_weight(
        jnp.asarray(np.concatenate([a.ravel() for a in scaled])), 8)
    flat_q = np.asarray(flat)
    values, at = {}, 0
    for n, a in zip(names, scaled):
        values[n] = flat_q[at:at + a.size].reshape(a.shape)
        at += a.size

    def with_kernels(cast):
        params = {n: dict(lv) for n, lv in v_np["params"].items()}
        for n, k in values.items():
            params[n]["kernel"] = cast(k)
        return dict(v_np, params=params)

    return dict(x=x, v=v, v_np=v_np, scales=scales, size=size,
                tscales=tcalib.ScaleSet(scales.ka, scales.kw, 15.5),
                values=with_kernels(lambda k: k),
                values_bf16=with_kernels(
                    lambda k: k.astype(ml_dtypes.bfloat16)))


@pytest.fixture(scope="module")
def setups():
    cache = {}

    def get(net):
        if net not in cache:
            cache[net] = _setup(net)
        return cache[net]
    return get


def _port(net, s, qbit=8, **kw):
    """The port's model with the fixture's float weights and scales."""
    model = tmodels.create_model(net, qbit, scales=s["tscales"], **kw)
    return load_jax_variables(model, s["v_np"]).eval()


@pytest.fixture(scope="module")
def frozen(setups):
    """net -> (packed, float-frozen bf16) SLFP8 bf16 port models."""
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


@pytest.fixture(scope="module")
def executors(frozen):
    """net -> (float-frozen, packed) fused executors on the CPU."""
    cache = {}

    def get(net):
        if net not in cache:
            packed, values = frozen(net)
            cache[net] = (tfused.prepare(values, device="cpu"),
                          tfused.prepare(packed, device="cpu"))
        return cache[net]
    return get


def _run(fn, x):
    with torch.no_grad():
        return fn(torch.from_numpy(x)).float().numpy()


def _jax_apply(model, variables, x):
    return np.asarray(jax.jit(lambda vv, xx: model.apply(
        vv, xx, train=False))(variables, jnp.asarray(x)), np.float32)


# ---------------------------------------------------------------------------
# shipped constants, layers, bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mobilenetv1_imgnet", "mobilenetv1_cifar",
                                  "mobilenetv1_swish_cifar"])
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


def test_grouped_conv_layer():
    """JAX's feature_group_count: [C_out, C_in/groups, k, k] weights, fan-in
    C_in/groups*k*k, never on K4."""
    conv = QuantConv(64, 64, 3, padding=1, groups=64, qbit=8,
                     use_pallas=True)
    assert conv.weight.shape == (64, 1, 3, 3)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    std = float(np.sqrt(2.0 / 9))
    assert conv.weight.abs().max() <= 2 * std / 0.8796256610342398 + 1e-6
    assert not conv.uses_k4(torch.zeros(1, 64, 4, 4))
    pw = QuantConv(64, 32, 1, qbit=8, use_pallas=True)
    assert pw.uses_k4(torch.zeros(1, 64, 4, 4))


@pytest.mark.parametrize("net", ["mobilenet", "mobilenetv1"])
def test_load_jax_variables_round_trips_every_leaf(setups, net):
    """Every leaf of JAX's model loads by name; the port registers its
    parameters in flax's order, which the JAX exporter fills by position."""
    s = setups(net)
    model = _port(net, s, qbit=32)
    sd = model.state_dict()
    exported = jckpt.export_torch_state_dict(s["v"], sd)
    assert set(exported) == set(sd)
    for name, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(exported[name]),
                                      err_msg=name)
    n_leaves = sum(len(m) for c in s["v_np"].values() for m in c.values())
    assert n_leaves == sum(1 for k in sd if not k.endswith(
        "num_batches_tracked"))
    assert model.conv1.weight.shape == (32, 1, 3, 3)


# ---------------------------------------------------------------------------
# module paths against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["mobilenet", "mobilenetv1"])
def test_fp32_module_path_matches_jax(setups, net):
    s = setups(net)
    want = _jax_apply(jmodels.create_model(net, 32, scales=s["scales"]),
                      s["v"], s["x"])
    got = _run(_port(net, s, qbit=32), s["x"])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("packed", [False, True], ids=["frozen", "packed_k4"])
@pytest.mark.parametrize("net", ["mobilenet", "mobilenetv1"])
def test_slfp8_module_path_matches_jax(monkeypatch, setups, frozen, net,
                                      packed):
    """Float-frozen bf16 weights on the conv route, and packed weights with
    use_pallas=True (the 13 pointwise convs, and CIFAR's classifier, on
    K4's plain version), against JAX's frozen bf16 module path."""
    s = setups(net)
    jm = jmodels.create_model(net, 8, scales=s["scales"],
                              compute_dtype=jnp.bfloat16,
                              frozen_weights=True, use_pallas=False)
    want = _jax_apply(jm, s["values"], s["x"])
    model = frozen(net)[0 if packed else 1]
    for _, layer in tfreeze.quant_layers(model):
        layer.use_pallas = packed
    calls = []
    plain = tfm.fused_quant_matmul_plain
    monkeypatch.setattr(tfm, "fused_quant_matmul_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    got = _run(model, s["x"])
    assert len(calls) == (13 + (net == "mobilenet") if packed else 0)
    _agree(got, want, 0.995)


def _assert_pack_matches_jax(setups, net, n_layers):
    """Every quant layer of ``net`` packs to exactly JAX's codes: under jit
    XLA computes ``kernel / kw`` as ``kernel * f32(1/kw)``, and so does the
    port."""
    s = setups(net)
    cap = jmodels.create_model(net, 8, capture="full", scales=s["scales"])
    # one jit over the capture run and every layer's pack (one compile)
    jp = _to_numpy(jax.jit(lambda v, x: jfreeze.pack_variables(cap, v, x))(
        s["v"], jnp.asarray(s["x"][:1])))
    model = tfreeze.pack(_port(net, s))
    layers = tfreeze.quant_layers(model)
    assert len(layers) == n_layers
    for name, layer in layers:
        assert layer.weight.dtype == torch.uint8
        mine = layer.weight.numpy()
        mine = np.transpose(mine, (2, 3, 1, 0)) if mine.ndim == 4 else mine.T
        np.testing.assert_array_equal(mine, jp["params"][name]["kernel"],
                                      err_msg=name)


def test_pack_matches_jax_pack_variables(setups):
    """CIFAR MobileNet: grouped (depthwise) kernels, pointwise kernels and
    the quantized classifier."""
    _assert_pack_matches_jax(setups, "mobilenet", 28)


def test_mobilenetv1_pack_matches_jax_pack_variables(setups):
    """ImageNet MobileNetV1: its 27 quantized convs (the classifier is
    float32 and stays unpacked)."""
    _assert_pack_matches_jax(setups, "mobilenetv1", 27)


# ---------------------------------------------------------------------------
# the fused executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p["dw"])
@pytest.mark.parametrize("net", ["mobilenet", "mobilenetv1"])
def test_fused_apply_matches_jax(setups, executors, net, policy):
    s = setups(net)
    want = np.asarray(jax.jit(lambda v, xx: jfused.fused_apply(
        v, xx, scales=s["scales"], quant_classifier=net == "mobilenet"))(
            s["values_bf16"], jnp.asarray(s["x"])), np.float32)
    got = _run(lambda x: tfused.fused_apply(executors(net)[0], x,
                                            policy=policy), s["x"])
    _agree(got, want, 0.995)


def test_fused_s2d_stem_matches_jax(setups, executors):
    """The space-to-depth stem (``s2d_stem=True``, off by default as in
    JAX): a 2x2 conv over 12 channels that sums the same products."""
    s = setups("mobilenetv1")
    want = np.asarray(jax.jit(lambda v, xx: jfused.fused_apply(
        v, xx, scales=s["scales"], quant_classifier=False, s2d_stem=True))(
            s["values_bf16"], jnp.asarray(s["x"])), np.float32)
    got = _run(lambda x: tfused.fused_apply(executors("mobilenetv1")[0], x,
                                            s2d_stem=True), s["x"])
    _agree(got, want, 0.995)


@pytest.mark.parametrize("net", ["mobilenet", "mobilenetv1"])
def test_fused_apply_matches_port_module_path(setups, frozen, executors, net):
    """JAX's own bar between its executor and its module path."""
    s = setups(net)
    model = frozen(net)[1]
    for _, layer in tfreeze.quant_layers(model):
        layer.use_pallas = False
    _agree(_run(lambda x: tfused.fused_apply(executors(net)[0], x), s["x"]),
           _run(model, s["x"]), 0.98)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p["dw"])
@pytest.mark.parametrize("net", ["mobilenet", "mobilenetv1"])
def test_fused_packed_bit_equal_to_float_frozen(setups, executors, net,
                                                policy):
    x = torch.from_numpy(setups(net)["x"])
    values, packed = executors(net)
    with torch.no_grad():
        a = tfused.fused_apply(values, x, policy=policy)
        b = tfused.fused_apply(packed, x, policy=policy)
    assert a.dtype == (torch.bfloat16 if net == "mobilenet" else torch.float32)
    np.testing.assert_array_equal(a.float().numpy().view(np.int32),
                                  b.float().numpy().view(np.int32))


@pytest.mark.parametrize("net", ["mobilenet", "mobilenetv1"])
def test_dw_kernel_route_against_torch_route(monkeypatch, setups, executors,
                                             net):
    """``dw="kernel"`` runs K5 (its plain version here) at the 9 stride-1
    sites; ``dw="torch"`` runs none.  The two sum the taps in another order:
    JAX's bar between its two placements."""
    s = setups(net)
    calls = []
    plain = tdw.dw3x3_plain
    monkeypatch.setattr(tdw, "dw3x3_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tk.reset_launches()
    outs = []
    for policy in POLICIES:
        calls.clear()
        outs.append(_run(lambda x: tfused.fused_apply(
            executors(net)[0], x, policy=policy), s["x"]))
        assert len(calls) == (9 if policy["dw"] == "kernel" else 0)
    assert set(tk.launches().values()) == {0}
    _agree(outs[0], outs[1], 0.995)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p["dw"])
@pytest.mark.parametrize("net", ["mobilenet", "mobilenetv1"])
def test_cudnn_and_matmuls_read_f32_from_their_producers(monkeypatch,
                                                         executors, net,
                                                         policy):
    """Every kernel writes the operand its consumer reads: no bf16 tensor
    reaches cuDNN or a plain matmul, and K5 reads bf16."""
    seen = []
    conv, mm, dw = tfused._conv_f32, tfused._mm_f32, tdw.dw3x3
    monkeypatch.setattr(tfused, "_conv_f32", lambda x, c: seen.append(
        ("conv", x.dtype)) or conv(x, c))
    monkeypatch.setattr(tfused, "_mm_f32", lambda x, w: seen.append(
        ("mm", x.dtype)) or mm(x, w))
    monkeypatch.setattr(tfused.k5, "dw3x3", lambda x, *a, **k: seen.append(
        ("k5", x.dtype)) or dw(x, *a, **k))
    with torch.no_grad():
        tfused.fused_apply(executors(net)[0], torch.zeros(1, 32, 32, 3),
                           policy=policy)
    k5 = 9 if policy["dw"] == "kernel" else 0
    want = [("conv", torch.float32)] * (1 + 13 - k5) + [
        ("k5", torch.bfloat16)] * k5 + [("mm", torch.float32)] * (
            13 + (net == "mobilenet"))
    assert sorted(seen) == sorted(want)


def test_fused_decides_k5_route_when_it_prepares(monkeypatch, executors):
    """``prepare`` decides K5's route once per site from its taps, affine
    and reciprocal, and every forward hands that decision to the wrapper
    (which would otherwise read the operands on each launch)."""
    fw = executors("mobilenet")[0]
    assert fw.dw_ftz == [tdw.ftz_route(fw.dw_taps[b], fw.dw[b].scale,
                                       fw.dw[b].shift, fw.recips[2 + 2 * b])
                         for b in range(len(fw.dw))]
    assert all(fw.dw_ftz)
    seen = []
    wrapper = tdw.dw3x3
    monkeypatch.setattr(tfused.k5, "dw3x3", lambda *a, **k: seen.append(
        k["ftz"]) or wrapper(*a, **k))
    with torch.no_grad():
        tfused.fused_apply(fw, torch.zeros(1, 32, 32, 3))
    assert seen == [True] * 9


def test_fused_rejects_unknown_policy_and_classifier(executors):
    fw = executors("mobilenet")[0]
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="policy"):
        tfused.fused_apply(fw, x, policy={"dw": "pallas"})
    with pytest.raises(ValueError, match="policy"):
        tfused.fused_apply(fw, x, policy={"conv1": "kernel"})
    with pytest.raises(ValueError, match="quant_classifier"):
        tfused.fused_apply(fw, x, quant_classifier=False)


# ---------------------------------------------------------------------------
# the engine (JAX serve.py:63-83 over the ported nets)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net,fusable,size", [
    ("mobilenet", True, 32), ("cifar/mobilenet", True, 224),
    ("mobilenetv1", True, 224), ("mobilenet_swish", False, 32)])
def test_engine_auto_rule(net, fusable, size):
    kw = dict(qbit=8, batch_size=1, device="cpu")
    eng = InferenceEngine(net, **kw)
    assert eng.fused == fusable and eng.image_size == size
    if fusable:
        assert eng.executor.quant_classifier == (net != "mobilenetv1")
        assert not InferenceEngine(net, use_pallas=True, **kw).fused
        assert not InferenceEngine(net, compute_dtype=None, **kw).fused
    else:
        with pytest.raises(ValueError, match="fused=True"):
            InferenceEngine(net, fused=True, **kw)


@pytest.mark.parametrize("net", tmodels.NAMES)
def test_default_image_size_is_jax_rule(net):
    """The default image size of every name the registry accepts is JAX's
    (serve.py:85-86): 32 only for a bare CIFAR name, so a slash-prefixed
    ``cifar/...`` name gets 224 there and here."""
    want = 32 if net in jmodels.MODEL_NAMES["cifar"] else 224
    assert tserve.default_image_size(net) == want


def test_engine_serves_the_fused_executor_with_a_policy(setups):
    s = setups("mobilenet")
    eng = InferenceEngine("mobilenet", qbit=8, batch_size=2, device="cpu",
                          scales=s["tscales"], policy={"dw": "torch"})
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    logits = eng.predict(x)
    assert logits.shape == (3, 100) and np.isfinite(logits).all()
    with torch.no_grad():
        direct = tfused.fused_apply(eng.executor, torch.from_numpy(x[2:3]),
                                    policy={"dw": "torch"})
    np.testing.assert_array_equal(logits[2], direct.float().numpy()[0])


# ---------------------------------------------------------------------------
# the Swish / layer-output variant, its quantizer and activations
# ---------------------------------------------------------------------------


def test_mobilenet_swish_matches_jax(setups):
    """SLFP8 weights and activations with SFP<4,4> layer outputs and Swish
    in the last 4 blocks, in float32 (compute_dtype None), frozen weights."""
    s = setups("mobilenet_swish")
    jm = jmodels.create_model("mobilenet_swish", 8, scales=s["scales"],
                              frozen_weights=True)
    want = _jax_apply(jm, s["values"], s["x"])
    model = tfreeze.prequantize(_port("mobilenet_swish", s))
    assert model.swish_tail == 4 and model.layerout_quant
    assert not model.conv20.nonneg_input and not model.conv21.nonneg_input
    assert model.conv19.nonneg_input
    _agree(_run(model, s["x"]), want, 0.995)
    np.testing.assert_allclose(
        _run(_port("mobilenet_swish", s, qbit=32), s["x"]),
        _jax_apply(jmodels.create_model("mobilenet_swish", 32,
                                        scales=s["scales"]), s["v"], s["x"]),
        rtol=1e-4, atol=1e-4)


def _every_bf16_value() -> np.ndarray:
    """Every finite bfloat16 value (both zeros included), as float32, plus
    values around the SFP<4,4> thresholds."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    vals = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    edges = np.asarray([2.0**-8, 2.0**-7, 248.0, 247.9, 1.96875, 1.03125],
                       np.float32)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(0))])
    return np.concatenate([vals[np.isfinite(vals)], near, -near])


@pytest.mark.parametrize("bug_compat", [True, False])
def test_quantize_layerout_bit_equal_to_jax(bug_compat):
    x = _every_bf16_value()
    want = np.asarray(jsfp.quantize_layerout(jnp.asarray(x), 8,
                                             bug_compat=bug_compat))
    got = tsfp.quantize_layerout(torch.from_numpy(x), 8,
                                 bug_compat=bug_compat).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert tsfp.quantize_layerout(torch.from_numpy(x), 32) is not None
    with pytest.raises(ValueError):
        tsfp.quantize_layerout(torch.from_numpy(x), 16)


@pytest.mark.parametrize("name", ["relu", "swish", "sigmoid", "gelu", "stl"])
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = np.asarray(jact.get(name)(jnp.asarray(x)))
    got = tact.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7)
    with pytest.raises(ValueError):
        tact.get("tanh")


def test_stl_backward_is_a_function_of_the_cotangent_only():
    x = np.array([-3.0, -0.5, 0.2, 4.0], np.float32)
    g = np.array([0.5, -2.0, 4.0, -0.25], np.float32)
    _, vjp = jax.vjp(jact.stl, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    tact.stl(xt).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
