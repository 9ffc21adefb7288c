"""The port's calibration held against the JAX package on the CPU: the
layers' capture modes (``capture="absmax"`` / ``"full"``), ``calibrate``
and ``--pre_reference``'s dumps.

The JAX side gets the port's weights (``flax_template`` order, no flax
init, ``jax_variables``), and every JAX capture goes through JAX's own
``calibrate``, whose jitted apply at batch 2 the tests share.  The port's
PTQ drivers are in ``test_torch_port_ptq.py``.
"""

import copy
import functools
import json
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu import calib as jcalib
from cnns_slfp_quantization_tpu import models as jmodels
from cnns_slfp_quantization_tpu.calib import calibrate as jcalibrate
from cnns_slfp_quantization_tpu.cli import common as jcommon
from cnns_slfp_quantization_tpu_torch import calib as tcalib
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.calib import calibrate as tcalibrate
from cnns_slfp_quantization_tpu_torch.cli import common as tcommon
from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as tfm
from cnns_slfp_quantization_tpu_torch.ops import layers as tlayers
from cnns_slfp_quantization_tpu_torch.ops import sfp as tsfp
from cnns_slfp_quantization_tpu_torch.train import checkpoint as tckpt

# the suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cnns_slfp_quantization_tpu_torch"
X = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
    np.float32)
# the largest relative difference of a calibrated maximum (other than the
# weights' and in0, which are bit-equal) between the port and JAX at qbit 8:
# the convs sum in another order, so a value at a quantizer's bin edge may
# move one step of SLFP<3,4> (2**(1/16) - 1, 4.4%) and carry into the next
# layers' maxima.  Measured on these inputs: 0 for mobilenet at bf16, 0.0424
# at float32 (test_capture_absmax_matches_jax prints it)
QBIT8_RTOL = 5e-2


def _port_model(net, qbit=32, seed=3, **kw):
    return tmodels.create_model(
        net, qbit, generator=torch.Generator().manual_seed(seed), **kw).eval()


@functools.cache
def port_fp32(net):
    """The float32 model of ``net`` from seed 3, built once per process
    (ResNet-50's init takes seconds): callers copy it before changing it."""
    return _port_model(net)


def jax_variables(model):
    """flax variables holding ``model``'s weights (kernels HWIO / [in,
    out]), in flax's init order: no JAX init needed."""
    mods = dict(model.named_modules())
    out = {"params": {}, "batch_stats": {}}
    for coll, path, leaf, shape in tckpt.flax_template(model):
        mod = mods[".".join(path)]
        t = {"kernel": mod.weight, "scale": mod.weight, "bias": mod.bias,
             "mean": getattr(mod, "running_mean", None),
             "var": getattr(mod, "running_var", None)}[leaf]
        a = t.detach().float().numpy()
        if leaf == "kernel":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        assert a.shape == shape, (path, leaf)
        node = out[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return {k: v for k, v in out.items() if v}


@pytest.fixture(scope="module")
def nets():
    """net -> (port fp32 model, its weights as flax variables, max-abs
    scales of its layers on X).  The qbit-8 captures run at these scales
    (the PTQ workflow): the shipped constants belong to trained weights and
    flush random ones to the pseudo-zero from the middle of the net on,
    where the maxima are sums of pseudo-zeros (about 1e-11)."""
    out = {}
    for net in ("mobilenet", "resnet"):
        m = port_fp32(net)
        r = tcalibrate.calibrate(_port_capture(net, m, 32, False), [X])
        ka, kw = (np.asarray(a, np.float64) / 15.5
                  for a in (r.ka_max(), r.kw_max()))
        out[net] = (m, jax_variables(m), (ka, kw))
    return out


def _port_capture(net, model, qbit, bf16, scales=None):
    cap = tmodels.create_model(
        net, qbit, capture="absmax",
        compute_dtype=torch.bfloat16 if bf16 else None,
        scales=scales and tcalib.ScaleSet(*scales, 15.5)).eval()
    cap.load_state_dict(model.state_dict())
    return cap


def _jax_capture(net, qbit, bf16, scales=None):
    return jmodels.create_model(net, qbit, capture="absmax",
                                compute_dtype=jnp.bfloat16 if bf16 else None,
                                scales=scales and jcalib.ScaleSet(*scales,
                                                                  15.5))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


# ------------------------------------------------------------ capture
# The calibration itself (qbit 32) and qbit 8 at bf16, where JAX's capture
# leaves out the fused quantizer.  Not compared here, for their XLA compile
# time (above these files' share of the suite): ResNet-50 at qbit 8
# (bit-equal at bf16 when measured; 14 s) and mobilenet at qbit-8 float32
# (0.0424; 6 s).  chip_smoke.py holds the card's ResNet-50 calibration to
# the CPU's.
CAPTURE_CASES = [("mobilenet", 32, False), ("mobilenet", 32, True),
                 ("mobilenet", 8, True), ("resnet", 32, False)]


@pytest.mark.parametrize("net,qbit,bf16", CAPTURE_CASES,
                         ids=[f"{n}-q{q}-{'bf16' if b else 'f32'}"
                              for n, q, b in CAPTURE_CASES])
def test_capture_absmax_matches_jax(nets, net, qbit, bf16):
    """The per-layer maxima of one batch: the same tags, weights and the
    image's maximum bit for bit, the rest within rtol 1e-5 at qbit 32 and
    QBIT8_RTOL at qbit 8."""
    model, v, scales = nets[net]
    scales = scales if qbit == 8 else None
    want = jcalibrate.calibrate(_jax_capture(net, qbit, bf16, scales), v,
                                [X], max_images=2)
    cap = _port_capture(net, model, qbit, bf16, scales)
    got = tcalibrate.calibrate(cap, [X], max_images=2)
    # the port's stores carry JAX's sow names
    for name, store in tlayers.captured(cap).items():
        lid = dict(cap.named_modules())[name].layer_id
        assert set(store) == {f"in{lid}", f"w{lid}", f"out{lid}"}, name
    rtol = 1e-5 if qbit == 32 else QBIT8_RTOL
    worst = 0.0
    for kind in ("input_absmax", "weight_absmax", "output_absmax"):
        g, w = getattr(got, kind), getattr(want, kind)
        assert set(g) == set(w), kind
        for lid in w:
            if kind == "weight_absmax" or (kind == "input_absmax"
                                           and lid == 0):
                assert g[lid] == w[lid], (kind, lid, g[lid], w[lid])
            else:
                worst = max(worst, _rel(g[lid], w[lid]))
    print(f"worst relative difference {worst:.3g}")
    assert worst <= rtol, worst
    assert got.ka_max() == [got.input_absmax[i] for i in range(len(
        got.ka_max()))]


def test_capture_takes_neither_k1_nor_k4(monkeypatch):
    """Under a capture JAX takes neither its Pallas route nor the fused
    bf16 quantizer (JAX ops/layers.py:118, :175, :271): the port's layers
    call neither K1's fused quantizer nor K4, even with
    ``use_pallas=True``; without the capture the same model calls both."""
    calls = []

    def spy(name, fn):
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    monkeypatch.setattr(tsfp, "fused_scale_quant_act_bf16",
                        spy("k1", tsfp.fused_scale_quant_act_bf16))
    for name in ("quant_conv1x1", "quant_dense"):
        monkeypatch.setattr(tfm, name, spy("k4", getattr(tfm, name)))
    x = torch.from_numpy(X[:1])
    m = _port_model("mobilenet", 8, capture="absmax",
                    compute_dtype=torch.bfloat16, use_pallas=True)
    for capture, want in (("absmax", set()), ("full", set()),
                          (None, {"k1", "k4"})):
        calls.clear()
        tlayers.set_capture(m, capture)
        with torch.no_grad():
            m(x)
        assert set(calls) == want, capture


def test_capture_full_nonneg_hints_hold():
    """Every layer that declares ``nonneg_input`` sees x >= 0 (as JAX
    tests/test_nonneg_hints.py checks JAX), on each family of the zoo."""
    # qbit 32: the hints are structural (ReLU, pools, concat and shuffles
    # keep x >= 0 whatever the quantizers do), and qbit 8 would quantize
    # every weight of AlexNet and ResNet-50 in float32 on each forward
    cases = [("mobilenet_swish", 32), ("shufflenetv2", 32), ("resnet", 32),
             ("squeezenet", 64)]
    hints = set()
    for net, size in cases:
        m = (copy.deepcopy(port_fp32(net)) if net == "resnet" else
             _port_model(net, 32, image_size=size))
        tlayers.set_capture(m, "full")
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, size, size, 3)).astype(np.float32))
        with torch.no_grad():
            m(x)
        caps = tlayers.captured(m)
        assert caps and all(len(c["input_q"]) == len(c["weight_q"])
                            == len(c["nonneg_hint"]) == 1
                            for c in caps.values()), net
        for name, c in caps.items():
            hints.add(c["nonneg_hint"][0])
            if c["nonneg_hint"][0]:
                assert float(c["input_raw"][0].min()) >= 0, (net, name)
    assert hints == {False, True}


# ----------------------------------------------------------- calibrate
def test_calibrate_stops_after_the_batch_that_reaches_max_images(nets):
    """Batches of 2 and max_images 5: both stop after the third batch, the
    fourth is never drawn; the maxima over the three agree."""
    model, v, _ = nets["mobilenet"]
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal((2, 32, 32, 3)).astype(np.float32) * s
               for s in (1.0, 3.0, 2.0, 50.0)]

    def drawn(record):
        for b in batches:
            record.append(1)
            yield (b, np.zeros(2, np.int32))

    seen_j, seen_t = [], []
    want = jcalibrate.calibrate(_jax_capture("mobilenet", 32, False), v,
                                drawn(seen_j), max_images=5)
    got = tcalibrate.calibrate(_port_capture("mobilenet", model, 32, False),
                               drawn(seen_t), max_images=5)
    assert len(seen_j) == len(seen_t) == 3
    assert got.input_absmax[0] == want.input_absmax[0] == float(
        np.abs(batches[1]).max())
    for lid, w in want.output_absmax.items():
        assert _rel(got.output_absmax[lid], w) <= 1e-5, lid


def test_run_calibration_writes_jax_files(nets, tmp_path):
    """``--pre_reference``'s dumps: the same lines as JAX's (layer 0's
    input and weight lines identical, the rest within rtol 1e-5), the same
    JSON keys, and nothing written into the package."""
    model, v, _ = nets["mobilenet"]
    before = sorted((p, p.stat().st_mtime_ns) for p in PORT.rglob("*")
                    if p.is_file() and "__pycache__" not in p.parts)
    batches = [(X, np.zeros(2, np.int32))]
    jcommon.run_calibration(types.SimpleNamespace(root_dir=str(
        tmp_path / "jax")), _jax_capture("mobilenet", 32, False),
        "mobilenet", v, batches)
    cfg = types.SimpleNamespace(root_dir=str(tmp_path / "port"), Qbits=32)
    tcommon.run_calibration(cfg, model, "mobilenet", batches)
    for name in ("max_inout_mobilenet.txt", "max_weight_mobilenet.txt"):
        got = (tmp_path / "port" / name).read_text().splitlines()
        want = (tmp_path / "jax" / name).read_text().splitlines()
        assert len(got) == len(want) and got[:2] == want[:2], name
        for g, w in zip(got, want):
            if g.startswith("Layer") or not g:
                assert g == w
            else:
                assert _rel(float(g), float(w)) <= 1e-5, (name, g, w)
    js = [json.loads((tmp_path / d / "calib" /
                      "mobilenet_calibrated.json").read_text())
          for d in ("port", "jax")]
    assert list(js[0]) == list(js[1])
    assert js[0]["divisor"] == js[1]["divisor"] == 15.5
    assert js[0]["kw_max"] == js[1]["kw_max"]
    after = sorted((p, p.stat().st_mtime_ns) for p in PORT.rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts)
    assert after == before


