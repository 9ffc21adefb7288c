"""ShuffleNet V2 1.0x in its published ImageNet form (``imgnet/shufflenetv2``,
a name of the port's own: the JAX package has no ImageNet ShuffleNetV2) on
the CPU: the served logits against the benchmark's plain reference
(``benchmark/reference/shufflenetv2.py``) on the benchmark's exact inputs,
the published parameter count and layer table, the widths that set the
two forms apart, and the executor's phases and counters.

Batch 2 at 64x64 on the plain versions of the kernels.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import checks, inputs
from benchmark import work
from benchmark.reference import shufflenetv2 as ref
from benchmark.reference.common import Numerics
from cnns_slfp_quantization_tpu_torch import calib as tcalib
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.models import shufflenetv2 as tshuffle
from cnns_slfp_quantization_tpu_torch.models import (
    shufflenetv2_fused as tfused)
from cnns_slfp_quantization_tpu_torch.serve import (
    FUSABLE,
    InferenceEngine,
    default_image_size,
)
from cnns_slfp_quantization_tpu_torch.utils import profiling

# the suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
NET = "imgnet/shufflenetv2"
CONFIG = json.loads((REPO / "benchmark" / "configs"
                     / "shufflenetv2-slfp8.json").read_text())
SIZE = 64


class _Cell:
    """What ``inputs.model`` reads of a cell: its configuration at the
    test's size, and the reference."""

    def __init__(self):
        self.config = dict(CONFIG, image_size=SIZE, calibration_images=4)
        self.reference = ref


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


# ---------------------------------------------------------------------------
# the served logits against the plain reference
# ---------------------------------------------------------------------------


def _served(seed, tmp_path, **kw):
    """The benchmark's weights, scales and batch of 2 for ``seed``, the
    engine over them (``kw`` its options) and its logits; the reference's
    logits and its float8 control's, both with ``layer_outputs`` held as
    ``kw["fused"]`` holds them."""
    p, scales = inputs.model(_Cell(), seed, "cpu")
    inputs.save(p, scales, tmp_path / "w.pt", tmp_path / "s.json")
    ka, kwts = inputs.scale_arrays(scales)
    x = inputs.images(2, SIZE, seed, 3, "cpu")
    eng = InferenceEngine(NET, qbit=8, batch_size=2, image_size=SIZE,
                          checkpoint=str(tmp_path / "w.pt"),
                          scales=str(tmp_path / "s.json"), device="cpu", **kw)
    outs = torch.bfloat16 if kw.get("fused") is False else torch.float32
    with torch.no_grad():
        r = ref.serve_forward(p, x, ka, kwts, layer_outputs=outs)
        c = ref.serve_forward(p, x, ka, kwts, layer_outputs=outs,
                              num=Numerics(operand=torch.float8_e4m3fn))
    got = eng.forward(x)
    assert got.shape == (2, 1000) and got.dtype == torch.bfloat16
    return eng, got.float(), r.float(), c.float()


@pytest.mark.parametrize("seed", [12345, 2**31 + 11])
def test_served_logits_against_the_reference(seed, tmp_path):
    """The engine's default (the fused executor) on the benchmark's exact
    inputs reads under the configuration's ``logit_gap``; the reference
    with float8 operands, the serving control, reads over it."""
    eng, got, r, c = _served(seed, tmp_path)
    assert eng.fused and isinstance(eng.executor, tfused.FusedWeights)
    limit = CONFIG["limits"]["serve"]["logit_gap"]
    assert max(checks.logit_gaps(got, r)) < limit
    assert max(checks.logit_gaps(c, r)) > limit


@pytest.mark.parametrize("seed", [12345, 2**31 + 11])
def test_module_path_against_the_reference_with_bf16_layer_outputs(
        seed, tmp_path):
    """``fused=False`` holds every conv's and BatchNorm's output and the
    pooled features in bf16, where the served network keeps float32: the
    reference that does the same (``layer_outputs=torch.bfloat16``) reads
    it under ``logit_gap`` (0 on these seeds), and the float8 control with
    the same outputs over it.  Those bf16 values are the whole of the
    module path's gap to the served reference."""
    eng, got, r, c = _served(seed, tmp_path, fused=False)
    assert not eng.fused
    limit = CONFIG["limits"]["serve"]["logit_gap"]
    assert max(checks.logit_gaps(got, r)) < limit
    assert max(checks.logit_gaps(c, r)) > limit


def test_module_path_decides_as_the_fused_executor():
    """``fused=False`` (the frozen module path, which holds every layer's
    output in bf16) classifies as the fused engine does on the seeded
    weights and the shipped constants, and agrees in cosine."""
    x = np.random.default_rng(3).standard_normal((2, SIZE, SIZE, 3)).astype(
        np.float32)
    kw = dict(qbit=8, batch_size=2, image_size=SIZE, device="cpu")
    fused = InferenceEngine(NET, **kw)
    module = InferenceEngine(NET, fused=False, **kw)
    assert fused.fused and not module.fused
    a, b = fused.predict(x), module.predict(x)
    assert a.shape == b.shape == (2, 1000) and np.isfinite(b).all()
    assert _cos(a, b) > 0.98, _cos(a, b)
    np.testing.assert_array_equal(np.argmax(a, -1), np.argmax(b, -1))


def test_reference_imports_neither_jax_nor_the_port():
    tree = ast.parse((REPO / "benchmark" / "reference"
                      / "shufflenetv2.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add((node.module or "").split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "cnns_slfp_quantization_tpu",
                        "cnns_slfp_quantization_tpu_torch"}, names


@pytest.mark.parametrize("x, want", [
    (0.0, 0.0), (1.0, 1.0), (1.03125, 1.0), (1.09375, 1.125),
    (-3.1, -3.125), (247.0, 248.0), (300.0, 248.0), (-1000.0, -248.0),
    (0.0123, 0.01220703125), (1e-40, 0.0)])
def test_reference_sfp44_against_the_ports(x, want):
    """The reference's SFP<4,4>, written from the format, gives the port's
    layer-output quantize (the reference repository's, with its dead
    subnormal branch) on ties, saturation, small magnitudes and float32
    subnormals."""
    from cnns_slfp_quantization_tpu_torch.ops import sfp

    t = torch.tensor([x], dtype=torch.float32)
    assert ref.sfp44(t).item() == want
    assert sfp.quantize_layerout(t, 8).item() == want


# ---------------------------------------------------------------------------
# the published form
# ---------------------------------------------------------------------------


def test_parameter_count_and_layer_table():
    """torchvision's 2,278,604 trainable parameters, and the configuration's
    layer table at 144.9 M multiply-adds an image (56 convs, the
    classifier), which the reference's layers match shape for shape."""
    model = tmodels.create_model(NET, 8)
    assert sum(p.numel() for p in model.parameters()
               if p.requires_grad) == 2_278_604
    assert abs(work.flops_per_image(CONFIG) / 2 - 144.9e6) < 0.1e6
    convs = [lay for lay in CONFIG["layers"] if lay["kind"] == "conv"]
    assert len(convs) == 56
    for lay, (name, _, cin, cout, k, stride, groups) in zip(convs,
                                                            ref.convs()):
        assert lay["name"] == ("stem" if name == "pre_conv" else name)
        assert (lay["cin"], lay["cout"], lay["k"], lay["stride"],
                lay["groups"]) == (cin, cout, k, stride, groups)
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == ref.param_shapes()


@pytest.mark.parametrize("net, widths, nonneg, stride", [
    (NET, (24, 58, 58), True, 2), ("shufflenetv2", (24, 24, 58), False, 1)])
def test_stage2_u0_widths(net, widths, nonneg, stride):
    """``stage2_u0``'s residual branch is 24 -> 58 -> 58 in the published
    form and 24 -> 24 -> 58 in the CIFAR one; the published unit takes a
    non-negative input (ReLU and max pool before it), its stem a stride of
    2; stages 3 and 4 are alike in both."""
    model = tmodels.create_model(net, 8)
    u = model.stage2_u0
    w1, w2, w3 = (u.res_conv1.weight, u.res_conv2.weight, u.res_conv3.weight)
    assert (w1.shape[1], w1.shape[0], w3.shape[0]) == widths
    assert w2.shape == (widths[1], 1, 3, 3) and w3.shape[1] == widths[1]
    assert u.short_conv2.weight.shape == (58, 24, 1, 1)
    assert u.res_conv1.nonneg_input == nonneg
    assert model.pre_conv.stride == stride
    assert model.stage3_u0.res_conv1.weight.shape == (116, 116, 1, 1)
    assert model.stage4_u0.res_conv3.weight.shape == (232, 232, 1, 1)


def test_registry_and_engine_defaults():
    """The port's own name builds without ``scales=`` (the shipped
    constants, 57 entries), serves through the fused executor at 224 by
    default, refuses a width plan, and leaves the CIFAR names as they
    were."""
    assert NET in tmodels.NAMES
    assert FUSABLE[NET] == "shufflenetv2_fused"
    assert default_image_size(NET) == 224
    sc = tcalib.load_scales("shufflenetv2_imgnet")
    assert len(sc.ka) == len(sc.kw) == 57 and sc.divisor == 15.0
    assert "synthetic" in sc.source
    model = tmodels.create_model(NET, 8)
    assert model.imagenet and model.fc.weight.shape == (1000, 1024)
    np.testing.assert_array_equal(model.scales.ka, sc.ka)
    with pytest.raises(ValueError, match="ratio"):
        tmodels.create_model(NET, 8, ratio=0.5)
    cifar = tmodels.create_model("shufflenetv2", 8)
    assert not cifar.imagenet and cifar.fc.weight.shape == (100, 1024)
    assert tshuffle.units(1) == tshuffle.units(1, imagenet=False)
    assert tshuffle.units(1, imagenet=True)[0][-1] is True


# ---------------------------------------------------------------------------
# phases and counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net, size", [(NET, SIZE), ("shufflenetv2", 32)])
def test_phases_and_counters_record_once_a_forward(net, size):
    """With recording on, each of the executor's five phases records once
    a forward (host spans on the CPU), and the counters read 36 plain-op
    posts and 16 shuffles; with recording off, nothing."""
    eng = InferenceEngine(net, qbit=8, batch_size=2, image_size=size,
                          device="cpu")
    x = torch.zeros(2, size, size, 3)
    profiling.reset()
    eng.forward(x)
    assert not any(profiling.spans(n).count for n in tfused.PHASES)
    assert not profiling.counters()
    with profiling.recording():
        eng.forward(x)
        eng.forward(x)
    for name in tfused.PHASES:
        got = profiling.spans(name)
        assert got.count == 2, name
        assert all(s.parent == "engine.eager" for s in got.samples)
    c = profiling.counters()
    assert c["shufflenet.posts_plain"] == 2 * 36
    assert c["shufflenet.shuffles"] == 2 * 16
    profiling.reset()
