"""The fused CIFAR MobileNetV1 and ShuffleNetV2 executors over a model
axis (``shard_weights``, ``InferenceEngine(..., mesh=)``) on the CPU: one
gloo group of two ranks on a ``1x2`` mesh (``tests/
torch_port_parallel_fused_worker.py``, spawned; one intra-op thread a
rank) serves batch 4, held against the port's unsharded fused engine on
the same weights (cosine > 0.999, the same top-1, identical logits on both
ranks) and against JAX's engine on a ``1x2`` mesh of the CPU's forced host
devices with the port's weights carried across (cosine > 0.995, the same
top-1).  Scales are absmax / 15.5 of the seed's weights on the input (the
shipped ones saturate a random-init model's quantizers)."""

import pickle
import socket
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cnns_slfp_quantization_tpu import calib as jcalib
from cnns_slfp_quantization_tpu import models as jmodels
from cnns_slfp_quantization_tpu import serve as jserve
from cnns_slfp_quantization_tpu.parallel import make_mesh as jmake_mesh
from cnns_slfp_quantization_tpu_torch import calib as tcalib
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.calib import calibrate as tcalibrate
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from test_torch_port_calib import jax_variables

import torch_port_parallel_fused_worker as worker

torch.set_num_threads(1)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _seeded(net, qbit, **kw):
    """The engine's model at ``seed=0``: its float weights."""
    return tmodels.create_model(net, qbit, generator=torch.Generator()
                                .manual_seed(0), **kw).eval()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_fused")
    x = np.random.default_rng(5).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    inputs, scales = {"x": x}, {}
    for net in worker.NETS:
        r = tcalibrate.calibrate(_seeded(net, 32, capture="absmax"), [x])
        ka, kw = (np.asarray(a, np.float64) / 15.5
                  for a in (r.ka_max(), r.kw_max()))
        inputs[f"{net}_ka"], inputs[f"{net}_kw"] = ka, kw
        scales[net] = (ka, kw)
    np.savez(out / "inputs.npz", **inputs)
    ctx = mp.start_processes(worker.run, (2, _free_port(), str(out)),
                             nprocs=2, join=False, start_method="spawn")

    # meanwhile: the unsharded port engine and JAX's on a 1x2 mesh
    jmesh = jmake_mesh(data=1, model=2, devices=jax.devices()[:2])
    want = {}
    for net in worker.NETS:
        ka, kw = scales[net]
        one = InferenceEngine(net, qbit=8, batch_size=4, seed=0,
                              scales=tcalib.ScaleSet(ka, kw, 15.5),
                              device="cpu")
        v = jax_variables(_seeded(net, 8))
        # JAX's engine initialises its model, then freezes: hand it the
        # port's float weights as that init
        cls = type(jmodels.create_model(net, 8))
        with pytest.MonkeyPatch.context() as mp_:
            mp_.setattr(cls, "init", lambda self, *a, **k: v)
            jeng = jserve.InferenceEngine(
                net, qbit=8, batch_size=4, mesh=jmesh,
                scales=jcalib.ScaleSet(ka, kw, 15.5))
        want[net] = {"port": one.predict(x), "jax": jeng.predict(x)}

    deadline = time.time() + 240
    while not ctx.join(timeout=max(deadline - time.time(), 1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the 2-rank group did not finish")
    got = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got, want


def _rank(runs, net, r):
    res = runs[0][r][net]
    if "error" in res:
        pytest.fail(f"rank {r}, {net}:\n{res['error']}")
    return res


@pytest.mark.parametrize("net", worker.NETS)
def test_sharded_fused_engine_matches_unsharded(runs, net):
    want = runs[1][net]["port"].astype(np.float32)
    for r in range(2):
        res = _rank(runs, net, r)
        got = res["got"].astype(np.float32)
        assert res["sharded"] and got.shape == want.shape == (4, 100)
        assert np.isfinite(got).all()
        assert _cos(got, want) > 0.999, (r, _cos(got, want))
        np.testing.assert_array_equal(np.argmax(got, -1),
                                      np.argmax(want, -1))
        np.testing.assert_array_equal(
            res["got"].view(np.uint32),
            _rank(runs, net, 0)["got"].view(np.uint32))


@pytest.mark.parametrize("net", worker.NETS)
def test_sharded_fused_engine_matches_jax_mesh(runs, net):
    want = runs[1][net]["jax"].astype(np.float32)
    got = _rank(runs, net, 0)["got"].astype(np.float32)
    assert got.shape == want.shape
    assert _cos(got, want) > 0.995, _cos(got, want)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))
