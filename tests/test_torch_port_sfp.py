"""The port's quantizer core (cnns_slfp_quantization_tpu_torch.ops.sfp)
held bit for bit against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cnns_slfp_quantization_tpu.calib import load_scales as jax_load_scales
from cnns_slfp_quantization_tpu.kernels import fused_matmul as jax_fm
from cnns_slfp_quantization_tpu.kernels import quantize as jax_quantize
from cnns_slfp_quantization_tpu.ops import sfp as jsfp
from cnns_slfp_quantization_tpu_torch import calib as tcalib
from cnns_slfp_quantization_tpu_torch.ops import sfp as tsfp

# the suite runs in several processes at once: one intra-op thread each
# (torch's default, a thread per core in each, spins on shared cores)
torch.set_num_threads(1)

_KA = jax_load_scales("resnet50_imgnet").ka


def _all_finite_bf16_as_f32() -> np.ndarray:
    """Every finite bfloat16 value (both zeros included), as float32."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    vals = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    return vals[np.isfinite(vals)]


def _random_and_boundary_f32(n=100_000, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(np.log(1e-4), np.log(300.0), n)).astype(np.float32)
    rand = mag * rng.choice([-1.0, 1.0], n).astype(np.float32)
    # reference spot-check vector (sfp_quant.py:179) and every threshold,
    # each with its float32 neighbours
    edges = np.asarray([0.0, 0.0625, 0.123046875, 0.12109375, 0.125, 1.0,
                        1.96875, 2.0, 15.0, 15.32165, 15.5, 248.0,
                        0.05, 0.07, 0.1, 0.13, 0.2, 3.3, 7.7, 16.0, 1e-10],
                       np.float32)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(0.0))])
    return np.concatenate([rand, near, -near,
                           np.asarray([-0.0], np.float32)]).astype(np.float32)


def _bits16(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def test_scale_constants_match_jax():
    mine = tcalib.load_scales("resnet50_imgnet")
    theirs = jax_load_scales("resnet50_imgnet")
    np.testing.assert_array_equal(mine.ka, theirs.ka)
    np.testing.assert_array_equal(mine.kw, theirs.kw)
    assert mine.divisor == theirs.divisor


@pytest.mark.parametrize("qbit", [7, 8])
@pytest.mark.parametrize("nonneg", [True, False])
@pytest.mark.parametrize("recip", [1.0, tsfp.recip_of(_KA[0]),
                                   tsfp.recip_of(_KA[1])])
def test_act_bf16_bits_bit_equal_to_jax(qbit, nonneg, recip):
    x = np.concatenate([_all_finite_bf16_as_f32(), _random_and_boundary_f32()])
    want = _bits16(jsfp._act_bf16_bits(jnp.asarray(x), recip, qbit, nonneg))
    got = tsfp.act_bf16_bits(torch.from_numpy(x), recip, qbit, nonneg)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want)
    # the bf16 input path gives the same bits as its float32 value
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want_b = _bits16(jsfp._act_bf16_bits(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), recip, qbit,
        nonneg))
    got_b = tsfp.act_bf16_bits(xb, recip, qbit, nonneg)
    np.testing.assert_array_equal(
        got_b.view(torch.int16).numpy().view(np.uint16), want_b)


def test_negative_zero_maps_to_pseudo_zero_under_nonneg():
    """The nonneg fast path sends the bit pattern of -0.0 to the pseudo-zero,
    as JAX does; the port's ReLUs therefore always produce +0.0."""
    x = torch.tensor([-0.0, 0.0])
    got = tsfp.act_bf16_bits(x, 1.0, 8, True).float().numpy()
    want = np.asarray(jsfp._act_bf16_bits(jnp.asarray(x.numpy()), 1.0, 8, True),
                      np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] > 0 and got[1] == 0


def test_slfp34_act_bits_matches_pallas_kernel():
    x = _random_and_boundary_f32(n=65_536 - 64, seed=1)[:65_536]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_quantize.slfp34_act_quantize(
            jnp.asarray(x), block_rows=8))
    got = tsfp.slfp34_act_bits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # bf16 in -> bf16 out, as the Pallas kernel's output dtype follows input
    xb = x.astype(ml_dtypes.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want_b = np.asarray(jax_quantize.slfp34_act_quantize(
            jnp.asarray(xb), block_rows=8))
    got_b = tsfp.slfp34_act_bits(torch.from_numpy(xb.astype(np.float32))
                                 .to(torch.bfloat16))
    np.testing.assert_array_equal(
        got_b.view(torch.int16).numpy().view(np.uint16), _bits16(want_b))


@pytest.mark.parametrize("kind,qbit", [("weight", 7), ("weight", 8),
                                       ("act", 7), ("act", 8), ("act", 32)])
def test_float_quantizers_bit_equal(kind, qbit):
    x = np.concatenate([_all_finite_bf16_as_f32(), _random_and_boundary_f32()])
    jfn = jsfp.quantize_weight if kind == "weight" else jsfp.quantize_act
    tfn = tsfp.quantize_weight if kind == "weight" else tsfp.quantize_act
    want = np.asarray(jfn(jnp.asarray(x), qbit), np.float32)
    got = tfn(torch.from_numpy(x), qbit).numpy()
    # bit patterns: -0.0 stays -0.0, as in JAX
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_ste_gradient_is_identity():
    x = torch.tensor([0.01, -0.3, 2.0, 40.0], requires_grad=True)
    tsfp.quantize_act(x, 8).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(4, np.float32))


def test_exp2_table_equals_jax_split_product():
    ml = np.arange(17, dtype=np.int32)
    want = np.asarray(jsfp._exp2_frac16(jnp.asarray(ml)))
    np.testing.assert_array_equal(tsfp._EXP2_16.view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("fmt", ["sfp33", "slfp34", "sfp44"])
def test_codebook_equal(fmt):
    np.testing.assert_array_equal(tsfp.codebook(fmt), jsfp.codebook(fmt))


def test_pack_unpack_decode_bit_equal():
    x = np.concatenate([_all_finite_bf16_as_f32(), _random_and_boundary_f32()])
    q = np.asarray(jsfp.quantize_weight(jnp.asarray(x), 8), np.float32)
    codes_j = np.asarray(jsfp.pack_slfp34(jnp.asarray(q)))
    codes_t = tsfp.pack_slfp34(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(codes_t, codes_j)
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tsfp.unpack_slfp34(torch.from_numpy(every)).numpy(),
        np.asarray(jsfp.unpack_slfp34(jnp.asarray(every))))
    np.testing.assert_array_equal(
        tsfp.slfp34_decode_bits(torch.from_numpy(every)).numpy().view(np.int32),
        np.asarray(jax_fm.slfp34_decode_bits(jnp.asarray(every)))
        .view(np.int32))
