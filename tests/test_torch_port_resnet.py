"""The port's ResNet-50 slice held against the JAX package on the CPU: the
weight bridge, the fp32 module path, freezing and the fused SLFP8 executor
under every policy, the engine's device guard, and the import boundary."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu import calib as jcalib
from cnns_slfp_quantization_tpu import models as jmodels
from cnns_slfp_quantization_tpu.models import resnet50_fused as jfused
from cnns_slfp_quantization_tpu.ops import freeze as jfreeze
from cnns_slfp_quantization_tpu.ops import sfp as jsfp
from cnns_slfp_quantization_tpu.train import checkpoint as jckpt
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as tfused
from cnns_slfp_quantization_tpu_torch.models.resnet50 import STAGES
from cnns_slfp_quantization_tpu_torch.ops import freeze as tfreeze
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from cnns_slfp_quantization_tpu_torch.train.checkpoint import (
    load_jax_variables)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cnns_slfp_quantization_tpu_torch"
# (JAX policy, port policy); JAX's chain is empty by default, the port's
# {2, 3}, so the port names it
_NO_CHAIN = {"chain": frozenset()}
POLICIES = [
    ({"conv1": "pallas", "conv3": "xla"},
     {"conv1": "kernel", "conv3": "torch", **_NO_CHAIN}),
    ({"conv1": "xla", "conv3": "xla"},
     {"conv1": "torch", "conv3": "torch", **_NO_CHAIN}),
    ({"conv1": "pallas", "conv3": "pallas"},
     {"conv1": "kernel", "conv3": "kernel", **_NO_CHAIN}),
]


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _scale_id(name: str) -> int:
    """Scale index of a quant layer from its flax name."""
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
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = jmodels.create_model("resnet", 32)
    # eager init: its dicts keep flax's call order, which the JAX exporter's
    # positional matching reads (a jit output's keys are sorted)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]), train=False)
    v_np = _to_numpy(v)
    scales = jcalib.load_scales("resnet50_imgnet")
    # frozen JAX weights without a capture run: Q(kernel * f32(1/kw)) per
    # quant layer, stored as bf16 (prequantize_variables(dtype=bfloat16)).
    # The quantizer is elementwise, so all kernels go through it as one
    # vector (one shape to compile).
    names = [n for n, lv in v_np["params"].items() if "kernel" in lv]
    scaled = [v_np["params"][n]["kernel"] * (np.float32(1) / np.float32(
        scales.kw[_scale_id(n)])) for n in names]
    flat_q = np.asarray(jsfp.quantize_weight(
        jnp.asarray(np.concatenate([a.ravel() for a in scaled])), 8))
    params, at = {n: dict(lv) for n, lv in v_np["params"].items()}, 0
    for n, a in zip(names, scaled):
        params[n]["kernel"] = flat_q[at:at + a.size].reshape(a.shape).astype(
            ml_dtypes.bfloat16)
        at += a.size
    vf = {"params": params, "batch_stats": v_np["batch_stats"]}
    return x, v, v_np, vf, scales


def test_load_jax_variables_round_trips_every_leaf(setup):
    _, v, v_np, _, _ = setup
    model = tmodels.create_model("resnet", 32)
    load_jax_variables(model, v_np)
    sd = model.state_dict()
    # the JAX exporter fills the port's state_dict by registration order;
    # it must agree with the by-name bridge leaf for leaf
    exported = jckpt.export_torch_state_dict(v, sd)
    assert set(exported) == set(sd)
    for name, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(exported[name]),
                                      err_msg=name)
    n_leaves = sum(len(m) for c in v_np.values() for m in c.values())
    n_filled = sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    assert n_leaves == n_filled


def test_load_jax_variables_rejects_missing_and_extra(setup):
    _, _, v_np, _, _ = setup
    model = tmodels.create_model("resnet", 32)
    bad = {"params": dict(v_np["params"]),
           "batch_stats": v_np["batch_stats"]}
    del bad["params"]["fc"]
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables(model, bad)
    bad["params"] = dict(v_np["params"], extra={"kernel": np.zeros(3)})
    with pytest.raises(ValueError, match="left over"):
        load_jax_variables(model, bad)


def test_fp32_module_path_matches_jax(setup):
    x, v, v_np, _, _ = setup
    jm = jmodels.create_model("resnet", 32)
    want = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        v, jnp.asarray(x)))
    model = load_jax_variables(tmodels.create_model("resnet", 32), v_np).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_freeze_matches_jax_frozen_weights(setup):
    _, _, v_np, vf, _ = setup
    model = load_jax_variables(tmodels.create_model("resnet", 8), v_np)
    layers = tfreeze.quant_layers(tfreeze.prequantize(model, torch.bfloat16))
    assert len(layers) == 54
    for name, layer in layers:
        want = vf["params"][name]["kernel"].astype(np.float32)
        want = (np.transpose(want, (3, 2, 0, 1)) if want.ndim == 4
                else want.T)
        np.testing.assert_array_equal(layer.weight.float().numpy(), want,
                                      err_msg=name)


def test_pack_matches_jax_pack_variables(setup):
    """All 54 quant kernels pack to exactly the codes JAX's pack_variables
    stores: under jit XLA computes ``kernel / kw`` as ``kernel * f32(1/kw)``,
    and so does the port."""
    x, v, v_np, _, _ = setup
    cap = jmodels.create_model("resnet", 8, capture="full")
    jp = _to_numpy(jax.jit(lambda vv, xx: jfreeze.pack_variables(cap, vv, xx))(
        v, jnp.asarray(x[:1])))
    layers = tfreeze.quant_layers(tfreeze.pack(load_jax_variables(
        tmodels.create_model("resnet", 8), v_np)))
    assert len(layers) == 54
    for name, layer in layers:
        mine = layer.weight.numpy()
        mine = np.transpose(mine, (2, 3, 1, 0)) if mine.ndim == 4 else mine.T
        np.testing.assert_array_equal(mine, jp["params"][name]["kernel"],
                                      err_msg=name)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_slfp8_module_path_matches_jax(setup, bf16):
    """The quantized layers over frozen weights, in float32 (float
    quantizers) and in the bf16 compute mode (bit-domain quantizer, bf16
    activations): the JAX tests' bar against JAX's own module path."""
    x, _, v_np, vf, _ = setup
    jm = jmodels.create_model(
        "resnet", 8, frozen_weights=True, use_pallas=False,
        compute_dtype=jnp.bfloat16 if bf16 else None)
    vf32 = {"params": {n: {k: np.asarray(a, np.float32) for k, a in lv.items()}
                       for n, lv in vf["params"].items()},
            "batch_stats": vf["batch_stats"]}
    want = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        vf32, jnp.asarray(x)), np.float32)
    model = load_jax_variables(tmodels.create_model(
        "resnet", 8, compute_dtype=torch.bfloat16 if bf16 else None), v_np)
    tfreeze.prequantize(model, torch.bfloat16 if bf16 else None)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).float().numpy()
    assert np.isfinite(got).all()
    assert _cos(got, want) > 0.995
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


@pytest.fixture(scope="module")
def port_fused(setup):
    _, _, v_np, _, _ = setup

    def build(packed):
        model = load_jax_variables(tmodels.create_model("resnet", 8), v_np)
        if packed:
            tfreeze.pack(model)
        else:
            tfreeze.prequantize(model, torch.bfloat16)
        return tfused.prepare(model.eval(), device="cpu")

    return build(False), build(True)


@pytest.mark.parametrize("jax_policy,port_policy", POLICIES)
def test_fused_apply_matches_jax(setup, port_fused, jax_policy, port_policy):
    x, _, _, vf, scales = setup
    want = np.asarray(jax.jit(lambda v, xx: jfused.fused_apply(
        v, xx, scales=scales, policy=jax_policy))(vf, jnp.asarray(x)),
        np.float32)
    with torch.no_grad():
        got = tfused.fused_apply(port_fused[0], torch.from_numpy(x),
                                 policy=port_policy).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    cos = _cos(got, want)
    assert cos > 0.995, f"{port_policy}: cos={cos}"
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


@pytest.mark.parametrize("port_policy", [p for _, p in POLICIES])
def test_fused_packed_bit_equal_to_float_frozen(setup, port_fused,
                                                port_policy):
    x = torch.from_numpy(setup[0])
    frozen, packed = port_fused
    assert packed.blocks["layer1_0"]["conv1"].w.dtype == torch.uint8
    with torch.no_grad():
        a = tfused.fused_apply(frozen, x, policy=port_policy)
        b = tfused.fused_apply(packed, x, policy=port_policy)
    np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                  b.view(torch.int16).numpy())


@pytest.mark.parametrize("policy", [
    None, _NO_CHAIN, {"conv1": "torch", "conv3": "torch", **_NO_CHAIN}],
    ids=["default", "chain_off", "torch"])
def test_cudnn_and_matmuls_read_f32_from_their_producers(monkeypatch,
                                                         port_fused, policy):
    """Every kernel writes the operand its consumer reads: a bf16 tensor
    reaches cuDNN or a plain matmul (to be widened there) only where K2
    reads conv1's input too, at the 4 downsample inputs."""
    fw = port_fused[0]
    seen = []
    conv, mm = tfused._conv_f32, tfused._mm_f32
    monkeypatch.setattr(tfused, "_conv_f32", lambda x, c: seen.append(
        (c, x.dtype)) or conv(x, c))
    monkeypatch.setattr(tfused, "_mm_f32", lambda x, w: seen.append(
        (None, x.dtype)) or mm(x, w))
    with torch.no_grad():
        tfused.fused_apply(fw, torch.zeros(1, 32, 32, 3), policy=policy)
    allowed = []
    if (policy or {}).get("conv1") != "torch":
        allowed += [blk["down"] for blk in fw.blocks.values() if "down" in blk]
    got = [c for c, dt in seen if dt == torch.bfloat16]
    assert len(got) == len(allowed) and all(
        any(c is a for a in allowed) for c in got)
    assert {dt for _, dt in seen} <= {torch.float32, torch.bfloat16}
    n_mm = 1 + (32 if policy and policy.get("conv1") == "torch" else 0)
    n_conv = 1 + 4 + (7 + 2 if policy is None else 16)
    assert (sum(c is None for c, _ in seen), len(seen)) == (n_mm,
                                                            n_mm + n_conv)


def test_fused_rejects_unknown_policy(port_fused):
    with pytest.raises(ValueError, match="policy"):
        tfused.fused_apply(port_fused[0], torch.zeros(1, 32, 32, 3),
                           policy={"conv1": "pallas"})


def test_engine_cpu_predict_pads_and_matches_fused():
    eng = InferenceEngine("resnet", qbit=8, batch_size=2, image_size=32,
                          device="cpu", seed=0)
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    logits = eng.predict(x)
    assert logits.shape == (3, 1000) and np.isfinite(logits).all()
    with torch.no_grad():
        direct = tfused.fused_apply(eng.executor, torch.from_numpy(x[2:3]))
    np.testing.assert_array_equal(logits[2], direct.float().numpy()[0])
    np.testing.assert_array_equal(eng.classify(x), np.argmax(logits, -1))


def test_engine_leaves_backend_flags_of_the_process_alone():
    """The executor's TF32 / deterministic-cuDNN flags hold inside each
    fused_apply and nowhere else, so other models keep their own."""
    def flags():
        return (torch.backends.cudnn.enabled, torch.backends.cudnn.benchmark,
                torch.backends.cudnn.deterministic,
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    before = flags()
    with tfused.backend_flags():
        assert flags()[1:] == (False, True, True, True)
    assert flags() == before
    eng = InferenceEngine("resnet", qbit=8, batch_size=1, image_size=32,
                          device="cpu", seed=0)
    eng.predict(np.zeros((1, 32, 32, 3), np.float32))
    assert flags() == before


def test_engine_same_seed_same_weights_fp32():
    a = InferenceEngine("resnet", qbit=32, batch_size=1, image_size=32,
                        device="cpu", seed=3)
    b = InferenceEngine("resnet", qbit=32, batch_size=1, image_size=32,
                        device="cpu", generator=torch.Generator().manual_seed(3))
    x = np.ones((1, 32, 32, 3), np.float32)
    np.testing.assert_array_equal(a.predict(x), b.predict(x))


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine("resnet")


def test_create_model_names_unported_models():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodels.create_model("vgg16")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
        assert top != "cnns_slfp_quantization_tpu", (path, mod)
