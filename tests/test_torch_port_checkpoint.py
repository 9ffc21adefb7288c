"""Reference ``.pth`` checkpoints in the port, held against the JAX
package's ``train/checkpoint.py`` on the CPU: each model's flax init order,
the positional import of a reference-layout state_dict (bit for bit, every
leaf, every net the engine serves), ``strict``, and the engine serving a
``.pth`` at qbit 8 (ShuffleNetV2's fused executor) and at qbit 7 (the
module path) against JAX's engine on the same file.

A reference-layout state_dict is what the reference's PyTorch models save:
per module in declaration order, ``weight`` (OIHW / [out, in]) and
``bias``, and for BatchNorm ``weight``, ``bias``, ``running_mean``,
``running_var`` and ``num_batches_tracked``.  The tests write one from
numpy values in flax's init order, which JAX's importer reads back
positionally (the reference's models declare their layers in that order).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu import models as jmodels
from cnns_slfp_quantization_tpu import serve as jserve
from cnns_slfp_quantization_tpu.train import checkpoint as jckpt
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.ops import freeze as tfreeze
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from cnns_slfp_quantization_tpu_torch.train import checkpoint as tckpt

# the suite runs in several processes at once: one intra-op thread each
# (torch's default, a thread per core in each, spins on shared cores)
torch.set_num_threads(1)

# every architecture the engine serves, at a small input (AlexNet's fc1
# width follows it) -> image size
NETS = {"mobilenet": 32, "mobilenetv1": 32, "shufflenetv2": 32,
        "vgg16": 32, "vgg16_gelu": 32, "resnet": 32, "resnet_stl": 32,
        "squeezenet": 32, "alexnet": 64, "inceptionv3": 9}


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _same(got, want, bar=0.995):
    """Cosine above ``bar`` and the same top-1 on every row."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _cos(got, want) > bar, _cos(got, want)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


def _walk(tree, prefix=()):
    """(path, leaf name, value) in insertion order."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix, key, val


def _flax_variables(net, size, seed=0):
    """numpy variables in flax's init order: the order is read from a
    trace of JAX's ``init`` (no compile), the values drawn from a seed
    (He-scaled kernels, small biases, BN statistics near unit)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jmodels.create_model(net, 32)
    traced = {}

    def init(key, x):
        traced["v"] = jm.init(key, x, train=False)
        return 0

    jax.make_jaxpr(init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf, v in _walk(traced["v"].get(coll, {})):
            shape = tuple(v.shape)
            if leaf == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                arr = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            elif leaf in ("scale", "var"):
                arr = 1.0 + 0.1 * rng.standard_normal(shape) ** 2
            else:
                arr = 0.1 * rng.standard_normal(shape)
            node = out.setdefault(coll, {})
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = arr.astype(np.float32)
    return out


def _reference_state_dict(variables):
    """The state_dict a reference model declaring the flax modules in
    flax's order saves (OIHW kernels, [out, in] dense weights)."""
    stats = {path: lv for path, lv in _modules(variables.get(
        "batch_stats", {}))}
    sd = {}
    for path, lv in _modules(variables["params"]):
        name = ".".join(path)
        if "kernel" in lv:
            k = lv["kernel"]
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(k, (3, 2, 0, 1)) if k.ndim == 4 else k.T))
            if "bias" in lv:
                sd[f"{name}.bias"] = torch.from_numpy(lv["bias"])
        else:
            sd[f"{name}.weight"] = torch.from_numpy(lv["scale"])
            sd[f"{name}.bias"] = torch.from_numpy(lv["bias"])
            sd[f"{name}.running_mean"] = torch.from_numpy(stats[path]["mean"])
            sd[f"{name}.running_var"] = torch.from_numpy(stats[path]["var"])
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return sd


def _modules(tree, prefix=()):
    """(module path, its leaves) of a flax collection, in order."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    if leaves:
        yield prefix, leaves
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _modules(val, prefix + (key,))


def _port_model(net, size, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tmodels.create_model(net, 32, image_size=size, **kw)


@pytest.fixture(scope="module")
def cases():
    cache = {}

    def get(net):
        if net not in cache:
            v = _flax_variables(net, NETS[net])
            cache[net] = dict(v=v, sd=_reference_state_dict(v))
        return cache[net]
    return get


# ---------------------------------------------------------------------------
# flax's order and the positional import
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", list(NETS))
def test_flax_order_is_jax_init_order(cases, net):
    """Each model lists its modules in flax's init order itself
    (``flax_order``), leaf by leaf as JAX's ``init`` creates them: two
    same-shaped convs in swapped order would pass every shape check of the
    positional import and load the wrong weights."""
    v = cases(net)["v"]
    want = [(coll, path, leaf, tuple(a.shape))
            for coll in ("params", "batch_stats")
            for path, leaf, a in _walk(v.get(coll, {}))]
    got = tckpt.flax_template(_port_model(net, NETS[net]))
    for coll in ("params", "batch_stats"):
        assert [w for w in want if w[0] == coll] == \
            [g for g in got if g[0] == coll], coll


@pytest.mark.parametrize("net", list(NETS))
def test_import_torch_state_dict_matches_jax(cases, net):
    """Both importers give the same leaves, bit for bit, and the port's
    loads into its model, which then holds the reference's tensors."""
    c = cases(net)
    want = jckpt.import_torch_state_dict(c["sd"], c["v"])
    model = _port_model(net, NETS[net])
    got = tckpt.import_torch_state_dict(c["sd"], model)
    w_leaves = [(coll, p, k, np.asarray(a)) for coll in want
                for p, k, a in _walk(want[coll])]
    g_leaves = [(coll, p, k, a) for coll in got
                for p, k, a in _walk(got[coll])]
    assert [x[:3] for x in g_leaves] == [x[:3] for x in w_leaves]
    for (coll, p, k, a), (_, _, _, b) in zip(g_leaves, w_leaves):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f"{coll}/{'/'.join(p)}/{k}")
    tckpt.load_jax_variables(model, got)
    mine = model.state_dict()
    for name, t in c["sd"].items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(mine[name].numpy(), t.numpy(),
                                          err_msg=name)


def test_strict_errors_as_jax():
    """A missing tensor raises in both; a tensor left over raises under
    ``strict`` with JAX's message and passes without it."""
    v = _flax_variables("squeezenet", 32)
    sd = _reference_state_dict(v)
    model = _port_model("squeezenet", 32)
    missing = dict(sd)
    missing.pop("classifier.bias")
    with pytest.raises(IndexError):
        jckpt.import_torch_state_dict(missing, v)
    with pytest.raises(ValueError, match="bias: flax wants more"):
        tckpt.import_torch_state_dict(missing, model)
    extra = dict(sd, **{"extra.weight": torch.zeros(4, 4, 1, 1)})
    for imp, arg in ((jckpt.import_torch_state_dict, v),
                     (tckpt.import_torch_state_dict, model)):
        with pytest.raises(ValueError, match="conv: consumed 26 of 27"):
            imp(extra, arg)
        imp(extra, arg, strict=False)
    bn = _flax_variables("vgg16", 32)
    extra_bn = dict(_reference_state_dict(bn),
                    **{"x.running_mean": torch.zeros(3)})
    for imp, arg in ((jckpt.import_torch_state_dict, bn),
                     (tckpt.import_torch_state_dict,
                      _port_model("vgg16", 32))):
        with pytest.raises(ValueError, match="bn stats: consumed 13/14"):
            imp(extra_bn, arg)


# ---------------------------------------------------------------------------
# the engine serving a .pth, against JAX's engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shufflenet_pth(tmp_path_factory, cases):
    path = tmp_path_factory.mktemp("pth") / "shufflenetv2.pth"
    torch.save(cases("shufflenetv2")["sd"], path)
    return path


def _images(n=4):
    return np.random.default_rng(3).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def test_engine_serves_pth_as_jax_engine(shufflenet_pth):
    """SLFP8 ShuffleNetV2 through the fused executor (both engines' auto
    choice) on the same ``.pth``: the same top-1; and the port's logits
    are bit for bit those of an engine whose model was loaded with the same
    weights directly."""
    x = _images()
    jeng = jserve.InferenceEngine("shufflenetv2", qbit=8, batch_size=4,
                                  checkpoint=str(shufflenet_pth))
    eng = InferenceEngine("shufflenetv2", qbit=8, batch_size=4, device="cpu",
                          checkpoint=str(shufflenet_pth))
    assert jeng.fused and eng.fused
    got = eng.predict(x)
    _same(got, jeng.predict(x))
    state = tmodels.create_model("shufflenetv2", 32)
    tckpt.load_jax_variables(state, tckpt.load_pth(shufflenet_pth, state))
    saved = shufflenet_pth.with_name("port_state.pt")
    torch.save(state.state_dict(), saved)
    direct = InferenceEngine("shufflenetv2", qbit=8, batch_size=4,
                             device="cpu", checkpoint=str(saved))
    np.testing.assert_array_equal(direct.predict(x).view(np.int32),
                                  got.view(np.int32))


def test_qbit7_engine_matches_jax(shufflenet_pth):
    """qbit 7 (SFP<3,3>) serves the frozen module path in both: the frozen
    weights are JAX's ``prequantize_variables`` bit for bit in the bf16
    compute dtype, which the port stores them in and JAX casts them to at
    each use (its float32 copy differs only at the pseudo-zero, 1e-10,
    which bf16 holds as 1.0004442e-10), and the logits agree (cosine,
    top-1)."""
    x = _images()
    jeng = jserve.InferenceEngine("shufflenetv2", qbit=7, batch_size=4,
                                  checkpoint=str(shufflenet_pth))
    eng = InferenceEngine("shufflenetv2", qbit=7, batch_size=4, device="cpu",
                          checkpoint=str(shufflenet_pth))
    assert not jeng.fused and not eng.fused
    layers = tfreeze.quant_layers(eng.model)
    assert len(layers) == 57
    for name, layer in layers:
        node = jeng.variables["params"]
        for key in name.split("."):
            node = node[key]
        assert layer.weight.dtype == torch.bfloat16
        w = layer.weight.detach()
        w = w.permute(2, 3, 1, 0) if w.dim() == 4 else w.t()
        want = torch.from_numpy(np.asarray(node["kernel"], np.float32)).to(
            torch.bfloat16)
        np.testing.assert_array_equal(
            w.contiguous().view(torch.int16).numpy(),
            want.view(torch.int16).numpy(), err_msg=name)
    _same(eng.predict(x), jeng.predict(x))
