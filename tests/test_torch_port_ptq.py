"""The port's PTQ workflow held against the JAX package on the CPU:
``ptq_sweep``, ``recovery``, ``slfp34_pack_bits``, the ResNet-50
executor's block-input levers and the ImageNet nets' training dropout.
The JAX side gets the port's weights
(``test_torch_port_calib.jax_variables``); the kernels on the card are
checked by ``chip_smoke.py``.
"""

import ast
import copy
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu import models as jmodels
from cnns_slfp_quantization_tpu.cli import common as jcommon
from cnns_slfp_quantization_tpu.cli import ptq_sweep as jptq
from cnns_slfp_quantization_tpu.cli import recovery as jrecovery
from cnns_slfp_quantization_tpu.data import subset as jsubset
from cnns_slfp_quantization_tpu.kernels import quantize as jquantize
from cnns_slfp_quantization_tpu_torch.cli import common as tcommon
from cnns_slfp_quantization_tpu_torch.cli import ptq_sweep as tptq
from cnns_slfp_quantization_tpu_torch.cli import recovery as trecovery
from cnns_slfp_quantization_tpu_torch.data import synthetic as tsynthetic
from cnns_slfp_quantization_tpu_torch.kernels import quantize as tquantize
from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as tfused
from cnns_slfp_quantization_tpu_torch.ops import freeze as tfreeze
from cnns_slfp_quantization_tpu_torch.ops import layers as tlayers
from cnns_slfp_quantization_tpu_torch.ops import sfp as tsfp
from cnns_slfp_quantization_tpu_torch.train import checkpoint as tckpt
from test_torch_port_calib import _port_model, jax_variables, port_fp32

# the suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


# ----------------------------------------------------------- ptq_sweep
def test_ptq_sweep_matches_jax(tmp_path, monkeypatch, capsys):
    """Synthetic CIFAR mobilenet, 2 batches of 8, qbits 32 and 8, the same
    weights on both sides: the same printed keys and lines, qbit 32's
    metrics equal and its logits within the fp32 module path's tolerance
    of JAX's."""
    model = _port_model("mobilenet")
    v = jax_variables(model)
    ckpt = tmp_path / "mobilenet.pt"
    tckpt.save(ckpt, {"model": model.state_dict()})
    args = ["--net", "mobilenet", "--dataset", "cifar", "--synthetic",
            "--eval_batch_size", "8", "--max_images", "16", "--qbits", "32",
            "8"]
    # JAX's sweep on the same weights: its build_model returns them
    monkeypatch.setattr(jcommon, "build_model", lambda cfg, net, size: (
        jmodels.create_model(net, cfg.Qbits), v))
    jptq.main(args + ["--jax_cache", ""])
    out_j = capsys.readouterr().out.splitlines()
    logits = []
    tbuild = tcommon.build_model

    def hooked(*a, **k):
        m = tbuild(*a, **k)
        m.register_forward_hook(lambda mod, i, o: logits.append(
            (mod.qbit, o.float().numpy())))
        return m

    monkeypatch.setattr(tcommon, "build_model", hooked)
    res = tptq.main(args + ["--device", "cpu", "--pretrain",
                            "--pretrain_dir", str(ckpt)])
    out_t = capsys.readouterr().out.splitlines()

    def keyed(lines):
        return [re.sub(r"[-+]?\d+\.\d+", "#", ln) for ln in lines
                if ln.startswith(("Qbits=", "PTQ", "{"))]

    assert keyed(out_t) == keyed(out_j) and len(keyed(out_t)) == 4
    jres, tres = json.loads(out_j[-1]), json.loads(out_t[-1])
    assert list(jres) == list(tres) == ["32", "8"]
    assert tres["32"] == jres["32"] == res[32]
    assert tres["8"]["images"] == jres["8"]["images"] == 16
    jm = jmodels.create_model("mobilenet", 32)
    x = np.concatenate([b for b, _ in tsynthetic.SyntheticIterator(
        image_size=32, num_classes=100, batch_size=8, num_batches=2,
        seed=1)])
    want = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        v, jnp.asarray(x)))
    got = np.concatenate([o for q, o in logits if q == 32])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------------- recovery
def _jax_row_keys():
    """The keys of the row JAX's ``recovery.run`` returns, from its source."""
    tree = ast.parse(pathlib.Path(jrecovery.__file__).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "row"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no row in JAX's recovery.run")


def test_recovery_run_uses_jax_sets_and_row(monkeypatch):
    """A tiny ``recovery.run`` on the CPU: the same train arrays, eval and
    calibration sets and subset indices as JAX's functions give, the
    subset's batch by JAX's rule, and JAX's row keys."""
    seen = {}
    gen, strat = trecovery.gen_eval_sets, trecovery.subset_lib.\
        stratified_indices
    monkeypatch.setattr(trecovery, "gen_eval_sets", lambda *a, **k: seen.
                        setdefault("eval", gen(*a, **k)))
    monkeypatch.setattr(trecovery.subset_lib, "stratified_indices",
                        lambda *a, **k: seen.setdefault("idx",
                                                        strat(*a, **k)))
    epochs = trecovery._epochs

    def recorded(model, opt, x, y, batch, *a):
        seen.setdefault("batches", []).append((len(x), batch))
        return epochs(model, opt, x, y, batch, *a)

    monkeypatch.setattr(trecovery, "_epochs", recorded)
    row = trecovery.run("mobilenet", 8, fp32_epochs=1, train_images=64,
                        batch=64, subset_fraction=0.25, qat_epochs=1,
                        eval_images=64, seed=0, device="cpu")
    assert list(row) == _jax_row_keys()
    task = jrecovery._task("mobilenet")
    assert trecovery._task("mobilenet") == {
        k: v for k, v in task.items() if k != "builder"}
    tr_x, tr_y = jrecovery._train_arrays(64, 64, task, seed=0)
    for a, b in zip(trecovery._train_arrays(64, 64, task, seed=0),
                    (tr_x, tr_y)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(seen["eval"], jrecovery.gen_eval_sets(
            "mobilenet", 64, 64, 0, task=task)):
        np.testing.assert_array_equal(a, b)
    idx = jsubset.stratified_indices(tr_y, 0.25, seed=0)
    np.testing.assert_array_equal(seen["idx"], idx)
    assert row["subset_images"] == len(idx)
    assert seen["batches"] == [(64, 64), (len(idx), min(64, max(
        32, len(idx) // 6)))]
    assert all(np.isfinite(row[k]) for k in ("acc_fp32", "acc_ptq",
                                             "acc_recovered"))


# ------------------------------------------------------ slfp34_pack_bits
def test_slfp34_pack_bits_bit_equal_to_jax():
    """Every 4093rd float32 bit pattern and both neighbours of each
    boundary (pseudo-zero, subnormal floor, clamp, every rounding midpoint
    of the 4-bit mantissa at each exponent), signed."""
    pats = np.arange(0, 2**32, 4093, dtype=np.uint64).astype(np.uint32)
    edges = [0.0625, 0.125, 15.32165]
    for e in range(-5, 5):
        for m in range(16):
            edges.append((1 + (m + 0.5) / 16) * 2.0 ** e)
            edges.append((1 + m / 16) * 2.0 ** e)
    e32 = np.asarray(edges, np.float32)
    near = np.concatenate([e32, np.nextafter(e32, np.float32(np.inf)),
                           np.nextafter(e32, np.float32(0))])
    x = np.concatenate([pats.view(np.float32), near, -near,
                        np.asarray([0.0, -0.0, np.inf, -np.inf],
                                   np.float32)])
    x = x[~np.isnan(x)]
    want = np.asarray(jquantize.slfp34_pack_bits(jnp.asarray(x)))
    got = tquantize.slfp34_pack_bits(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # and they decode to the codebook's values
    codes = torch.from_numpy(got)
    np.testing.assert_array_equal(tsfp.slfp34_decode_bits(codes).numpy(),
                                  tsfp.unpack_slfp34(codes).numpy())


# --------------------------------------------------- block-input levers
@pytest.fixture(scope="module")
def frozen_resnet():
    """Frozen SLFP8 weights of the shared float32 ResNet-50: each layer's
    Q(w/kw) through the bit-domain encoder and the decoder (the codebook's
    values)."""
    m = copy.deepcopy(port_fp32("resnet"))
    with torch.no_grad():
        for _, layer in tfreeze.quant_layers(m):
            layer.weight.copy_(tsfp.slfp34_decode_bits(
                tquantize.slfp34_pack_bits(layer.weight * layer.rkw32)))
            layer.frozen_weights = True
    return tfused.prepare(m, device="cpu")


@pytest.mark.parametrize("policy", [
    {"conv3": "torch", "chain": frozenset()},
    {"conv1": "torch", "conv3": "torch", "chain": frozenset()},
    {"conv3": "torch"}], ids=["conv1_kernel", "conv1_torch", "chain"])
def test_blockin_levers_match_consumer(frozen_resnet, policy):
    """What JAX asserts (tests/test_resnet_fused.py:76-93): K3's dual form
    is bit-equal to the consumer placement; the packed stream within 1e-2
    with the same top-1; the producer form (quantized from the f32 value)
    by the executors' bar."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))

    def run(mode):
        with torch.no_grad():
            return tfused.fused_apply(frozen_resnet, x, policy=policy,
                                      _diag_blockin_fuse=mode).float().numpy()

    base = run("consumer")
    dual = run("pallas_dual")
    np.testing.assert_array_equal(dual.view(np.int32), base.view(np.int32))
    with torch.no_grad():   # the default is the dual form
        default = tfused.fused_apply(frozen_resnet, x, policy=policy)
    np.testing.assert_array_equal(default.float().numpy(), dual)
    packed = run("packed")
    assert float(np.max(np.abs(packed - base))) < 1e-2
    np.testing.assert_array_equal(np.argmax(packed, -1), np.argmax(base, -1))
    prod = run("producer")
    cos = float(np.sum(prod * base) / np.linalg.norm(prod) /
                np.linalg.norm(base))
    assert cos > 0.995
    np.testing.assert_array_equal(np.argmax(prod, -1), np.argmax(base, -1))
    with pytest.raises(ValueError, match="_diag_blockin_fuse"):
        run("xla")


# -------------------------------------------- training dropout (Queue 3)
@pytest.mark.parametrize("net,module,size", [
    ("alexnet", "alexnet", 64), ("squeezenet", "squeezenet", 64),
    ("inceptionv3", "inception_v3", 24)])
def test_imagenet_nets_train_with_jax_dropout(net, module, size):
    """The ImageNet driver trains these nets with dropout (JAX's
    ``has_dropout``): the port's models hold as many rate-0.5 dropouts as
    JAX's source applies, identity in eval mode, masks in training."""
    src = (REPO / "cnns_slfp_quantization_tpu" / "models" /
           f"{module}.py").read_text()
    m = _port_model(net, 32, image_size=size)
    drops = [d for d in m.modules() if isinstance(d, tlayers.Dropout)]
    assert len(drops) == src.count("nn.Dropout(0.5") > 0
    assert all(d.p == 0.5 for d in drops)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, size, size, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = m(x), m(x)
        for d in drops:
            d.generator = torch.Generator().manual_seed(0)
        t = m.train()(x)
    assert torch.equal(a, b) and not torch.equal(a, t)
