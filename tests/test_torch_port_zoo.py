"""The rest of the zoo in the port, held against the JAX package on the CPU:
VGG16 and VGG16-GELU (CIFAR), the ResNet-50 STL / Swish variants and
InceptionV3 (float32 only) on the module path, the registry's names and
warnings, SFP<3,3> packing, and the engine's refusals (fused at qbit 7,
InceptionV3 quantized).

Full widths at batch 2: 32x32 for VGG16 and ResNet-50, 9x9 for InceptionV3,
the smallest input it takes.  Scales are absmax / 15.5 of each quantized
layer's input and weight over one float32 forward of the same weights,
read by forward hooks (the shipped constants belong to trained weights and
saturate the quantizers of a random-init model); both packages get the
same ones.
"""

import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu import calib as jcalib
from cnns_slfp_quantization_tpu import models as jmodels
from cnns_slfp_quantization_tpu import serve as jserve
from cnns_slfp_quantization_tpu.ops import sfp as jsfp
from cnns_slfp_quantization_tpu_torch import calib as tcalib
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as tfm
# every model module imported here, not first under torch.device("meta"),
# where its import-time constants would land on the meta device
from cnns_slfp_quantization_tpu_torch.models import (  # noqa: F401
    alexnet,
    inception_v3,
    mobilenetv1,
    resnet50,
    shufflenetv2,
    squeezenet,
    vgg16,
)
from cnns_slfp_quantization_tpu_torch.ops import freeze as tfreeze
from cnns_slfp_quantization_tpu_torch.ops import sfp as tsfp
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from cnns_slfp_quantization_tpu_torch.train.checkpoint import (
    load_jax_variables)

# the suite runs in several processes at once: one intra-op thread each
# (torch's default, a thread per core in each, spins on shared cores)
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
DIVISOR = 15.5
# net -> (image size, K4 launches per forward with use_pallas=True)
NETS = {"vgg16": (32, 3), "vgg16_gelu": (32, 3), "resnet_stl": (32, 37),
        "resnet_swish": (32, 37)}


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


def _run(fn, x):
    with torch.no_grad():
        return fn(torch.from_numpy(x)).float().numpy()


def _jax_apply(model, variables, x):
    return np.asarray(jax.jit(lambda vv, xx: model.apply(
        vv, xx, train=False))(variables, jnp.asarray(x)), np.float32)


def _hook_scales(model, x):
    """absmax / 15.5 of every quant layer's input and weight over one
    float32 forward (the largest where layers share a scale index, as
    VGG16's three dense layers do)."""
    ka, kw, hooks = {}, {}, []
    for _, layer in tfreeze.quant_layers(model):
        def hook(m, inp, out):
            i = m.layer_id
            ka[i] = max(ka.get(i, 0.0), float(inp[0].abs().max()))
            kw[i] = max(kw.get(i, 0.0), float(m.weight.abs().max()))
        hooks.append(layer.register_forward_hook(hook))
    _run(model, x)
    for h in hooks:
        h.remove()
    n = max(ka) + 1
    return (np.array([ka.get(i, 1.0) for i in range(n)]) / DIVISOR,
            np.array([kw.get(i, 1.0) for i in range(n)]) / DIVISOR)


def _setup(net):
    size = NETS[net][0]
    x = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(
        np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the variants' synthetic scales
        jm = jmodels.create_model(net, 32)
    v = jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(x[:1]))
    v_np = _to_numpy(v)
    fp32 = load_jax_variables(tmodels.create_model(net, 32), v_np).eval()
    ka, kw = _hook_scales(fp32, x)
    scales = jcalib.ScaleSet(ka=ka, kw=kw, divisor=DIVISOR)
    # frozen kernels Q(kernel * f32(1/kw)) of every quant layer (JAX's
    # quotient under jit), all through the quantizer as one vector
    layers = tfreeze.quant_layers(fp32)
    scaled = [v_np["params"][n]["kernel"] * (
        np.float32(1) / np.float32(kw[layer.layer_id])) for n, layer in layers]
    flat = np.asarray(jsfp.quantize_weight(
        jnp.asarray(np.concatenate([a.ravel() for a in scaled])), 8))
    params = _to_numpy(v_np["params"])
    at = 0
    for (name, _), a in zip(layers, scaled):
        params[name]["kernel"] = flat[at:at + a.size].reshape(a.shape)
        at += a.size
    return dict(x=x, v=v, v_np=v_np, scales=scales, fp32=fp32,
                tscales=tcalib.ScaleSet(ka, kw, DIVISOR),
                values=dict(v_np, params=params))


@pytest.fixture(scope="module")
def setups():
    cache = {}

    def get(net):
        if net not in cache:
            cache[net] = _setup(net)
        return cache[net]
    return get


@pytest.fixture(scope="module")
def jax_slfp8(setups):
    """net -> JAX's frozen bf16 SLFP8 module path on the fixture's input."""
    cache = {}

    def get(net):
        if net not in cache:
            s = setups(net)
            jm = jmodels.create_model(net, 8, scales=s["scales"],
                                      compute_dtype=jnp.bfloat16,
                                      frozen_weights=True, use_pallas=False)
            cache[net] = _jax_apply(jm, s["values"], s["x"])
        return cache[net]
    return get


# ---------------------------------------------------------------------------
# shipped constants, registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["shufflenetv2_cifar", "vgg16_cifar",
                                  "vgg16_gelu_cifar", "resnet50_stl_imgnet",
                                  "resnet50_swish_imgnet"])
def test_calib_copies_are_byte_equal(name):
    """Byte for byte, but for a ``source`` line that names a reference
    file: it drops the directory the reference was mounted at.  The
    variants' ``source`` says ``synthetic`` in both, which the registry's
    warning reads."""
    mine = (REPO / "cnns_slfp_quantization_tpu_torch/calib/constants"
            / f"{name}.json").read_text().splitlines()
    theirs = (REPO / "cnns_slfp_quantization_tpu/calib/constants"
              / f"{name}.json").read_text().splitlines()
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        if a != b:
            assert a.startswith(' "source": "reference ')
            assert b.endswith(a.split("reference ", 1)[1])
    a, b = tcalib.load_scales(name), jcalib.load_scales(name)
    np.testing.assert_array_equal(a.ka, b.ka)
    np.testing.assert_array_equal(a.kw, b.kw)
    assert ("synthetic" in a.source) == ("synthetic" in b.source)


# every name JAX's create_model accepts (JAX models/__init__.py:43-152)
JAX_NAMES = [
    "mobilenet", "cifar/mobilenet", "mobilenet_swish", "cifar/mobilenet_swish",
    "mobilenetv1", "imgnet/mobilenetv1", "shufflenetv2", "shufflenetv2_swish",
    "cifar/shufflenetv2", "cifar/shufflenetv2_swish", "vgg16", "cifar/vgg16",
    "vgg16_gelu", "cifar/vgg16_gelu", "resnet", "resnet50", "imgnet/resnet",
    "resnet_stl", "resnet_swish", "imgnet/resnet_stl", "imgnet/resnet_swish",
    "alexnet", "imgnet/alexnet", "squeezenet", "imgnet/squeezenet",
    "inceptionv3", "imgnet/inceptionv3"]
def test_model_names_are_jax_names():
    assert tmodels.MODEL_NAMES == jmodels.MODEL_NAMES
    assert tmodels.INPUT_SIZE == jmodels.INPUT_SIZE
    assert set(tmodels.NAMES) == set(JAX_NAMES)
    for create in (jmodels.create_model, tmodels.create_model):
        with pytest.raises(ValueError, match="unknown"):
            create("vgg19")


# the flax field each port model keeps under the same name
_FIELDS = ("num_classes", "qbit", "act", "layerout_quant", "gelu_variant",
           "swish_tail", "quant_classifier", "ratio")


@pytest.mark.parametrize("name", JAX_NAMES)
def test_every_jax_name_builds(name):
    """Each name builds in both registries, to the same architecture with
    JAX's defaults (classes, variant fields, shipped scales); the port's
    model is built on the meta device (no weights drawn)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jmodels.create_model(name, 8)
        with torch.device("meta"):
            tm = tmodels.create_model(name, 8)
    assert type(tm).__name__ == type(jm).__name__
    head = [m for m in tm.modules() if hasattr(m, "weight")
            and not isinstance(m, torch.nn.BatchNorm2d)][-1]
    assert head.weight.shape[0] == jm.num_classes
    for field in _FIELDS:
        if hasattr(jm, field) and field != "num_classes":
            assert getattr(tm, field) == getattr(jm, field), field
    if hasattr(jm, "scales"):
        np.testing.assert_array_equal(tm.scales.ka, jm.scales.ka)


@pytest.mark.parametrize("name", ["resnet_stl", "resnet_swish"])
def test_variants_warn_about_synthetic_scales_as_jax(name):
    """JAX warns when a quantized variant takes constants calibrated on a
    synthetic-data model (models/__init__.py:124-129); the port too, and
    neither does at qbit 32."""
    for create in (jmodels.create_model,
                   lambda n, q: _meta(tmodels.create_model, n, q)):
        with pytest.warns(UserWarning, match="synthetic"):
            create(name, 8)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            create(name, 32)


def _meta(create, name, qbit):
    """The port's model built on the meta device: no weights drawn."""
    with torch.device("meta"):
        return create(name, qbit)


# ---------------------------------------------------------------------------
# module paths against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", list(NETS))
def test_fp32_module_path_matches_jax(setups, net):
    s = setups(net)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jmodels.create_model(net, 32)
    want = _jax_apply(jm, s["v"], s["x"])
    got = _run(s["fp32"], s["x"])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("packed", [False, True], ids=["frozen", "packed_k4"])
@pytest.mark.parametrize("net", ["vgg16", "vgg16_gelu"])
def test_slfp8_module_path_matches_jax(monkeypatch, setups, jax_slfp8, net,
                                      packed):
    """Float-frozen bf16 weights on the conv route, and packed weights with
    use_pallas=True (the three biased dense layers on K4's plain version),
    against JAX's frozen bf16 module path."""
    s = setups(net)
    model = load_jax_variables(tmodels.create_model(
        net, 8, scales=s["tscales"], compute_dtype=torch.bfloat16,
        use_pallas=packed), s["v_np"]).eval()
    if packed:
        tfreeze.pack(model)
    else:
        tfreeze.prequantize(model, torch.bfloat16)
    calls = []
    plain = tfm.fused_quant_matmul_plain
    monkeypatch.setattr(tfm, "fused_quant_matmul_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    got = _run(model, s["x"])
    assert len(calls) == (NETS[net][1] if packed else 0)
    _same(got, jax_slfp8(net))


@pytest.mark.parametrize("net", ["resnet_stl", "resnet_swish"])
def test_variant_quantized_layers_bit_equal_to_jax(setups, net):
    """Each of the 54 quantized layers of the SLFP8 variant, fed the input
    JAX's layer saw, quantizes it and holds its frozen weights bit for bit
    as JAX does (``capture="full"``: JAX's float quantize path, which the
    port runs at ``compute_dtype=None``), with sign handling everywhere.

    The logits of a random-init variant are no measure of the port: every
    one-ulp difference that summation order leaves in a conv output can
    move a quantizer bin, and with STL or Swish (He init, no ReLU halving
    the variance) each block spreads such a flip wider.  JAX against itself,
    every BN variance scaled by 1 + 2**-22, gives cosine 0.990 at float32
    here, and the port against JAX 0.9875 (float32) and 0.944 (bf16, where
    XLA's own transcendental approximations also differ by one bf16 ulp
    in a quarter of the Swish and GELU outputs): both below the 0.995 bar
    the other nets meet.  The float32 path is held to JAX by
    ``test_fp32_module_path_matches_jax``."""
    s = setups(net)
    jm = jmodels.create_model(net, 8, scales=s["scales"], capture="full",
                              frozen_weights=True, use_pallas=False)
    _, inter = jax.jit(lambda v, xx: jm.apply(
        v, xx, train=False, mutable=["intermediates"]))(
            s["values"], jnp.asarray(s["x"]))
    inter = inter["intermediates"]
    model = tfreeze.prequantize(load_jax_variables(tmodels.create_model(
        net, 8, scales=s["tscales"]), s["v_np"]).eval())
    layers = tfreeze.quant_layers(model)
    assert len(layers) == 54
    for name, layer in layers:
        assert not layer.nonneg_input, name
        cap = {k: np.asarray(v[0], np.float32) for k, v in inter[name].items()
               if k != "nonneg_hint"}
        x = torch.from_numpy(cap["input_raw"])
        with torch.no_grad():
            if x.dim() == 4:
                q = layer.input_q(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                w = layer.weight_q().permute(2, 3, 1, 0)
            else:
                q, w = layer.input_q(x), layer.weight_q().t()
        np.testing.assert_array_equal(
            q.contiguous().numpy().view(np.int32),
            cap["input_q"].view(np.int32), err_msg=name)
        np.testing.assert_array_equal(
            w.contiguous().numpy().view(np.int32),
            cap["weight_q"].view(np.int32), err_msg=name)


def _jax_block_inputs(jm, values, x):
    """JAX's forward with the input of every quantized layer (``x_in``) and
    the output of every submodule (``__call__``: the LayeroutQuants')
    kept."""
    from flax import linen as fnn
    from cnns_slfp_quantization_tpu.ops.layers import QuantConv, QuantDense

    def keep_input(next_fun, args, kwargs, ctx):
        if (isinstance(ctx.module, (QuantConv, QuantDense))
                and ctx.method_name == "__call__"):
            ctx.module.sow("intermediates", "x_in", args[0])
        return next_fun(*args, **kwargs)

    def fwd(v, xx):
        with fnn.intercept_methods(keep_input):
            return jm.apply(v, xx, train=False, capture_intermediates=True,
                            mutable=["intermediates"])
    logits, inter = jax.jit(fwd)(values, jnp.asarray(x))
    return np.asarray(logits, np.float32), jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), inter["intermediates"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", ["resnet_stl", "resnet_swish"])
def test_variant_blocks_match_jax(setups, net, dtype):
    """How the SLFP8 variant is assembled, block by block, against JAX's
    frozen module path: the stem fed the image, each of the 16
    bottlenecks fed the input JAX's block saw, the FC fed JAX's pooled
    features.  Each ``loq`` output (the SFP<4,4> layer-output quantize
    before each activation) and each block output is compared with JAX's.

    At float32 every loq output and every block output is JAX's bit for
    bit in at least 90% of its elements (measured: 95.7% and 94.9% at the
    worst ones, layer4_0 of Swish, and 99.6% or more elsewhere: a
    summation-order ulp moves an input quantizer bin now and then, and the
    activations differ from XLA's by an ulp in a few outputs), each block's
    output reads cosine > 0.9999 against JAX's and the FC's logits
    > 0.99999 with the same top-1.  A loq left out, moved after the
    activation or a residual wired elsewhere changes most elements.  At bf16 the conv outputs and BatchNorm round at other
    points than XLA's fusions do, so a third to a half of the loq outputs
    sit one SFP<4,4> step from JAX's: there each block's output and each
    loq output reads cosine > 0.999 (measured 0.99953 at the worst
    one).  The logits of a whole random-init variant are no measure
    (``test_variant_quantized_layers_bit_equal_to_jax``)."""
    from cnns_slfp_quantization_tpu_torch.models.resnet50 import block_names

    s = setups(net)
    f32 = dtype == "float32"
    jm = jmodels.create_model(net, 8, scales=s["scales"],
                              compute_dtype=None if f32 else jnp.bfloat16,
                              frozen_weights=True, use_pallas=False)
    logits, inter = _jax_block_inputs(jm, s["values"], s["x"])
    tdt = torch.float32 if f32 else torch.bfloat16
    model = tfreeze.prequantize(load_jax_variables(tmodels.create_model(
        net, 8, scales=s["tscales"], compute_dtype=None if f32 else tdt),
        s["v_np"]).eval(), None if f32 else tdt)
    loq = {}
    for name, m in model.named_modules():
        if "loq" in name:
            m.register_forward_hook(
                lambda _m, _i, out, name=name: loq.__setitem__(name, out))

    def nchw(a):
        return torch.tensor(a).to(tdt).permute(0, 3, 1, 2)

    def nhwc(t):
        return t.permute(0, 2, 3, 1).float().numpy()

    def check(got, want, where):
        if f32:
            same = float((got.view(np.int32) == want.view(np.int32)).mean())
            assert same >= 0.9, (where, same)
        else:
            assert _cos(got, want) > 0.999, (where, _cos(got, want))

    pres = [b[2] for b in block_names()]
    with torch.no_grad():
        stem = nhwc(model.stem(nchw(s["x"])))
        check(nhwc(loq["loq1"]), inter["loq1"]["__call__"][0], "loq1")
        assert _cos(stem, inter[f"{pres[0]}_conv1"]["x_in"][0]) > (
            0.9999 if f32 else 0.999)
        for i, pre in enumerate(pres):
            out = nhwc(model.block(nchw(inter[f"{pre}_conv1"]["x_in"][0]),
                                   pre))
            for j in (1, 2, 3):
                check(nhwc(loq[f"{pre}_loq{j}"]),
                      inter[f"{pre}_loq{j}"]["__call__"][0], f"{pre}_loq{j}")
            if i + 1 < len(pres):
                want = inter[f"{pres[i + 1]}_conv1"]["x_in"][0]
            else:            # the FC's input: the mean over space
                out, want = out.mean((1, 2)), inter["fc"]["x_in"][0]
            check(out, want, pre)
            assert _cos(out, want) > (0.9999 if f32 else 0.999), pre
        got = model.fc(torch.tensor(inter["fc"]["x_in"][0]).to(tdt))
    _same(got.float().numpy(), logits, bar=0.99999 if f32 else 0.999)


def test_variants_keep_sign_handling():
    """A smooth activation emits signed values: every quantizer after the
    stem keeps its sign handling (JAX resnet50.py:87, vgg16.py:57)."""
    for name in ("resnet_stl", "resnet_swish", "vgg16_gelu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the synthetic scales
            model = _meta(tmodels.create_model, name, 8)
        assert not any(layer.nonneg_input
                       for _, layer in tfreeze.quant_layers(model)), name
    relu = _meta(tmodels.create_model, "vgg16", 8)
    assert [layer.nonneg_input for _, layer in tfreeze.quant_layers(relu)] \
        == [False] + [True] * 15
    assert relu.conv0.bias is not None
    assert _meta(tmodels.create_model, "vgg16_gelu", 8).conv0.bias is None


def test_inceptionv3_fp32_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 9, 9, 3)).astype(
        np.float32)
    jm = jmodels.create_model("inceptionv3")
    v = jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(x[:1]))
    want = _jax_apply(jm, v, x)
    model = load_jax_variables(tmodels.create_model("inceptionv3"),
                               _to_numpy(v)).eval()
    got = _run(model, x)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# SFP<3,3> packing
# ---------------------------------------------------------------------------


def test_sfp33_codes_bit_equal_to_jax():
    """Every code decodes as JAX decodes it (the zero code to 0.0), and
    every value they decode to, and random values through the SFP<3,3>
    quantizer, pack to JAX's codes."""
    codes = np.arange(128, dtype=np.uint8)
    want = np.asarray(jsfp.unpack_sfp33(jnp.asarray(codes)))
    got = tsfp.unpack_sfp33(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    rng = np.random.default_rng(0)
    x = np.concatenate([want, rng.standard_normal(100_000).astype(
        np.float32) * 4, np.float32([0.0, -0.0, 0.06, 0.125, 15.0, 40.0])])
    q = np.asarray(jsfp.quantize_weight(jnp.asarray(x), 7))
    np.testing.assert_array_equal(
        tsfp.quantize_weight(torch.from_numpy(x), 7).numpy().view(np.int32),
        q.view(np.int32))
    for v in (want, q):
        np.testing.assert_array_equal(
            tsfp.pack_sfp33(torch.from_numpy(v)).numpy(),
            np.asarray(jsfp.pack_sfp33(jnp.asarray(v))))
    back = tsfp.unpack_sfp33(tsfp.pack_sfp33(torch.from_numpy(q))).numpy()
    np.testing.assert_array_equal(back[np.abs(q) >= 0.125],
                                  q[np.abs(q) >= 0.125])


# ---------------------------------------------------------------------------
# the engine's refusals
# ---------------------------------------------------------------------------


def test_engine_fused_true_raises_at_qbit_7():
    """The fused executors consume SLFP<3,4> weights: qbit 7 serves the
    module path only, in JAX and here."""
    with pytest.raises(ValueError, match="fused=True"):
        jserve.InferenceEngine("resnet", qbit=7, fused=True)
    with pytest.raises(ValueError, match="fused=True"):
        InferenceEngine("resnet", qbit=7, fused=True, device="cpu")
    eng = InferenceEngine("shufflenetv2", qbit=7, batch_size=1, device="cpu",
                          pack_weights=True)
    assert not eng.fused
    # qbit 7 freezes values: packing targets the SLFP<3,4> codes
    assert eng.model.conv5.weight.dtype == torch.bfloat16
    assert eng.model.conv5.frozen_weights
    with pytest.raises(ValueError, match="qbit"):
        InferenceEngine("shufflenetv2", qbit=16, device="cpu")


def test_engine_inceptionv3_is_float32_only():
    """JAX's engine cannot freeze InceptionV3 (it has no quantized layer,
    so its capture run sows nothing and the engine raises); the port
    refuses qbit 7 and 8 up front, and both serve it at qbit 32."""
    with pytest.raises(KeyError):
        jserve.InferenceEngine("inceptionv3", qbit=8, batch_size=1,
                               image_size=9)
    for qbit in (7, 8):
        with pytest.raises(ValueError, match="float32 only"):
            InferenceEngine("inceptionv3", qbit=qbit, device="cpu")
    eng = InferenceEngine("inceptionv3", qbit=32, batch_size=2, image_size=9,
                          device="cpu")
    out = eng.predict(np.ones((3, 9, 9, 3), np.float32))
    assert out.shape == (3, 1000) and out.dtype == np.float32
    assert np.isfinite(out).all()
