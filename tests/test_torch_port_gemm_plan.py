"""The tile plan of the shared Hopper GEMM mainloop of K2 and K4
(``kernels/_gemm_plan.py``), on the CPU: at every shape the served paths
give the two kernels it fits the shared memory of the blocks an SM holds,
fills the card or splits K in whole K steps, covers N up to 128 with one
column tile (x read and quantized once) unless the epilogue reads a
residual, and is the same whatever the weights' dtype or layout; a
fixed-order f32 split-K reduction stays within the K2/K4 reordering bound
of the plain version."""

import pathlib
import re

import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu_torch.kernels import _build, _gemm_plan
from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as k4
from cnns_slfp_quantization_tpu_torch.kernels import qmm as k2
from cnns_slfp_quantization_tpu_torch.kernels.epilogue import (
    epilogue_value_plain)
from cnns_slfp_quantization_tpu_torch.ops import sfp
from cnns_slfp_quantization_tpu_torch.utils import bench_gemm

HEADER = (pathlib.Path(_build.CSRC) / "gemm_sm90.cuh").read_text()


def _served():
    """(label, M, K, N, residual) of every K2 and K4 site at batch 64."""
    flags = bench_gemm.k2_flags([1.0] * 54)
    out = {(m, k, n, "residual" in flags[site]): f"K2 {site}"
           for m, k, n, site, _ in bench_gemm.k2_sites()}
    for path, sites in bench_gemm.k4_sites().items():
        for shape, k, n, stride, _, _ in sites:
            out.setdefault((*bench_gemm.gemm_shape(shape, k, n, stride),
                            False), f"K4 {path}")
    return [(label, *key) for key, label in out.items()]


SERVED = _served()


def test_served_shapes_are_the_paths_sites():
    assert len(bench_gemm.k2_sites()) == 16
    assert sum(c for *_, c in bench_gemm.k2_sites()) == 32
    assert len(SERVED) == 47        # distinct (M, K, N, residual)


@pytest.mark.parametrize("label,m,k,n,residual", SERVED,
                         ids=[f"{s[0]}-{s[1]}x{s[2]}x{s[3]}" for s in SERVED])
def test_plan_at_every_served_shape(label, m, k, n, residual):
    p = _gemm_plan.plan(m, k, n, residual)
    assert p.bm in (64, 128) and p.bn in (64, 128)
    assert p.stages >= 3                            # the ring
    assert p.smem == _gemm_plan.smem_bytes(p.bm, p.bn, p.stages)
    assert p.smem <= 227 * 1024
    blocks = _gemm_plan.blocks_per_sm(p.bm, p.bn)
    assert blocks * (p.smem + 1024) <= 228 * 1024
    if residual:
        assert (p.bm, p.bn) == (64, 64)
    elif n <= 128:
        assert p.bn >= n                            # x quantized once
    tiles = -(-m // p.bm) * -(-n // p.bn)
    assert tiles >= _gemm_plan.SMS or p.split > 1
    ksteps = -(-k // _gemm_plan.BK)
    per = -(-ksteps // p.split)
    # whole K steps per split, none empty
    assert (p.split - 1) * per < ksteps <= p.split * per
    ws = _gemm_plan.workspace(p, m, n, torch.device("meta"))
    assert (ws is None) == (p.split == 1)
    if ws is not None:
        assert ws.shape == (p.split, m, n) and ws.dtype == torch.float32


def test_small_m_layers_split_k():
    """AlexNet's FC layers and the ResNet-50 module path's FC stream their
    codes from at least 64 blocks; fc1's f32 partials stay under a third of
    its codes' bytes."""
    for m, k, n in ((64, 9216, 4096), (64, 4096, 4096), (64, 4096, 1000),
                    (64, 2048, 1000)):
        p = _gemm_plan.plan(m, k, n)
        assert p.split > 1
        assert -(-n // p.bn) * p.split >= 64
    p = _gemm_plan.plan(64, 9216, 4096)
    assert 4 * p.split * 64 * 4096 < 9216 * 4096 // 3


def test_layout_constants_match_the_header():
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", HEADER))
    assert int(consts["kBK"]) == _gemm_plan.BK
    assert int(consts["kStgPitch"]) == _gemm_plan.STG_PITCH
    assert int(consts["kMaxSmem"]) == _gemm_plan.SMEM_MAX


def _launch_args(monkeypatch, call):
    """The arguments a wrapper hands its C entry point, from tensors on the
    meta device (no data, no card)."""
    seen = []
    monkeypatch.setattr(_build, "launch", lambda *a: seen.append(a))
    monkeypatch.setattr(_build, "check_cuda", lambda *t: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    call()
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("m,k,n", [(64, 9216, 4096), (200704, 64, 256),
                                   (1000, 136, 72)])
def test_plan_is_the_same_for_uint8_and_bf16_weights(monkeypatch, m, k, n):
    """The wrappers pass the plan of (M, K, N) whatever the weights' dtype
    and layout: codes and values enter the same MMAs in the same order."""
    meta = torch.device("meta")
    x = torch.empty(m, k, dtype=torch.bfloat16, device=meta)
    s = torch.empty(n, dtype=torch.float32, device=meta)
    plans = set()
    for dt in (torch.uint8, torch.bfloat16):
        for nk in (False, True):
            w = (torch.empty(n, k, dtype=dt, device=meta).t() if nk
                 else torch.empty(k, n, dtype=dt, device=meta))
            args = _launch_args(monkeypatch, lambda: k4.fused_quant_matmul(
                x, w, ka=0.5, kw=0.25))
            plans.add(tuple(args[-7:-2]))
            if not nk:
                args = _launch_args(monkeypatch, lambda: k2.qmm_fused(
                    x, w, s, s))
                plans.add(tuple(args[-7:-2]))
    assert plans == {tuple(_gemm_plan.plan(m, k, n))}


def test_fixed_order_split_k_reduction_within_the_bound():
    """Split-K's f32 partials, added in split order and then put through
    the epilogue, stay within the K2/K4 reordering bound of qmm_plain."""
    rng = np.random.default_rng(0)
    m, k, n = 64, 4104, 136
    p = _gemm_plan.plan(m, k, n)
    assert p.split > 1
    x = sfp.act_bf16_bits(torch.from_numpy(
        np.abs(rng.standard_normal((m, k))).astype(np.float32) * 3), 1.0, 8,
        True)
    w = sfp.quantize_weight(torch.from_numpy(
        rng.standard_normal((k, n)).astype(np.float32) * 4), 8).to(
            torch.bfloat16)
    s = torch.from_numpy(rng.random(n).astype(np.float32) * 0.01 + 1e-3)
    t = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.5)
    per = -(-(-(-k // _gemm_plan.BK)) // p.split) * _gemm_plan.BK
    xf, wf = x.float(), w.float()
    acc = None
    for j in range(p.split):       # partial sums, added in split order
        part = xf[:, j * per:(j + 1) * per] @ wf[j * per:(j + 1) * per]
        acc = part if acc is None else acc + part
    got = epilogue_value_plain(acc, s, t, None, True).to(torch.bfloat16)
    want = k2.qmm_plain(x, w, s, t, relu=True)
    emitted = bench_gemm.emitted_values(torch.device("cpu"))
    mag = bench_gemm.gemm_mag(x, w, s, t)
    bench_gemm.check_gemm(got, want, False, "split-K", mag, k, emitted)
    # and the reordering is real: the partial order changes some bits
    assert not torch.equal(acc, xf @ wf)
