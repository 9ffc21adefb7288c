"""The ResNet-50 executor's quantize-site lever, ``fused_apply(...,
_diag_quant_sites=...)``, held against JAX's on the CPU: every site set
the bench measures (all sites, each one removed, none) at 2x32x32 under
JAX's placement (``conv1`` / ``conv3`` as plain matmuls, no K6), by the
executors' bar (cosine > 0.995, the same top-1).  JAX gets the port's
frozen weights (``test_torch_port_calib.jax_variables``, no flax init).
Port-side: no keyword and ``None`` give the same bits under every policy,
removing a site changes the logits, and an unknown site raises."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu import calib as jcalib
from cnns_slfp_quantization_tpu.models import resnet50_fused as jfused
from cnns_slfp_quantization_tpu_torch import models as tmodels
from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as tfused
from cnns_slfp_quantization_tpu_torch.ops import freeze as tfreeze
from test_torch_port_calib import jax_variables

# the suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)

ALL = tfused.QUANT_SITES
# the bench's configurations: all, each site removed, none (the ceiling)
SITE_SETS = [None] + [ALL - {s} for s in sorted(ALL)] + [frozenset()]
SITE_IDS = ["all"] + [f"without_{s}" for s in sorted(ALL)] + ["none"]
JAX_POLICY = {"conv1": "xla", "conv3": "xla"}
PORT_POLICY = {"conv1": "torch", "conv3": "torch", "chain": frozenset()}
POLICIES = [None, PORT_POLICY, {"conv3": "torch"},
            {"conv1": "torch", "chain": frozenset()}]


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def setup():
    """The port's frozen seeded ResNet-50 laid out for its executor, the
    same weights as JAX's frozen variables (bf16 kernels), an input and
    JAX's jitted executor by site set (one compile each)."""
    model = tmodels.create_model(
        "resnet", 8, generator=torch.Generator().manual_seed(3)).eval()
    tfreeze.prequantize(model, torch.bfloat16)
    fw = tfused.prepare(model, device="cpu")
    v = jax_variables(model)
    for leaves in v["params"].values():
        if "kernel" in leaves:
            leaves["kernel"] = leaves["kernel"].astype(ml_dtypes.bfloat16)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    scales = jcalib.load_scales("resnet50_imgnet")

    def jax_logits(sites):
        fn = jax.jit(lambda vv, xx: jfused.fused_apply(
            vv, xx, scales=scales, policy=JAX_POLICY,
            _diag_quant_sites=sites))
        return np.asarray(fn(v, jnp.asarray(x)), np.float32)

    return fw, torch.from_numpy(x), jax_logits


def _port(fw, x, policy, **kw):
    with torch.no_grad():
        return tfused.fused_apply(fw, x, policy=policy, **kw)


@pytest.mark.parametrize("sites", SITE_SETS, ids=SITE_IDS)
def test_quant_sites_match_jax(setup, sites):
    fw, x, jax_logits = setup
    want = jax_logits(sites)
    got = _port(fw, x, PORT_POLICY, _diag_quant_sites=sites).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    cos = _cos(got, want)
    assert cos > 0.995, f"{sites}: cos={cos}"
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


@pytest.mark.parametrize("policy", POLICIES,
                         ids=["default", "jax", "conv3_torch", "conv1_torch"])
def test_quant_sites_none_is_production_and_each_site_counts(setup,
                                                             policy):
    """None and every site give the production bits; each set without a
    site gives other logits (under the default policy K6 ignores
    ``c1out`` / ``c2out`` in stages 2-3 but not in the blocks of stages 0
    and 1)."""
    fw, x, _ = setup
    base = _port(fw, x, policy).view(torch.int16)
    for sites in (None, ALL, set(ALL)):
        got = _port(fw, x, policy, _diag_quant_sites=sites)
        assert torch.equal(got.view(torch.int16), base), sites
    for sites in SITE_SETS[1:]:
        got = _port(fw, x, policy, _diag_quant_sites=sites)
        assert torch.isfinite(got.float()).all()
        assert not torch.equal(got.view(torch.int16), base), sites


def test_unknown_quant_site_raises(setup):
    fw, x, _ = setup
    with pytest.raises(ValueError, match="unknown sites"):
        _port(fw, x, None, _diag_quant_sites={"stem", "conv9"})
