"""Tile plan of the shared Hopper GEMM mainloop (``csrc/gemm_sm90.cuh``) of
K2 (``qmm_fused``) and K4 (``fused_quant_matmul``).

:func:`plan` depends on M, K, N and on whether the epilogue reads a
residual, never on the weight dtype, the pointers or the layout, so that
uint8 codes and bf16 values of the same weights enter the same MMAs in the
same order (packed == float-frozen, bit for bit) and two launches give the
same bits.  The rules were read from a sweep of every served shape over
row and column tiles of 64 and 128 and rings of 3 and 4 stages on the
H100 (``utils/bench_gemm.py --plans``):

- ``bn``: the column tile, 64 where 128-column tiles would pad N more
  (N up to 64, N = 192), else 128.  x is read and quantized once per
  column tile.
- ``bm``: 64 rows (one consumer warpgroup) where the 128-row tiles are
  fewer than the SMs, or where 64-row tiles fill the last wave of blocks
  clearly better; else 128 (two warpgroups).
- a residual read in the epilogue (K2's conv3 sites): 64 x 64 tiles.  The
  whole tile's residual is loaded before the mainloop, and the registers
  of wider tiles spill.
- ``split``: where the tiles leave SMs idle, K is cut into whole chunks of
  ``BK`` so that tiles x splits cover the SMs (at most ``MAX_SPLIT``); the
  splits' f32 sums go to a workspace ``[split, M, N]`` that a second pass
  adds in split order.
- ``stages``: 3, the ring the sweep found fastest or within a few percent
  everywhere: deeper rings take shared memory from the blocks an SM holds
  and from its L1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

BK = 64                 # K step of the ring
SMS = 132               # H100 SXM
SMEM_MAX = 232448       # 227 KB a block
MAX_SPLIT = 16
STAGES = 3
STG_PITCH = 40          # floats per row of the epilogue's staging tile


class Plan(NamedTuple):
    bm: int
    bn: int
    split: int
    stages: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Shared memory of one block (the mirror of ``gemm::layout``): the
    ring (128 bytes of each x row and a weight tile sized for bf16 a
    stage), the decoded weight tile, the epilogue's staging tiles, the
    producer's row offsets, the decode table, the barriers and 1 KB of
    alignment slack."""
    return (stages * (bm * 128 + BK * bn * 2) + BK * bn * 2
            + (bm // 64) * 64 * STG_PITCH * 4 + bm * 8 + 512 + 16 * stages
            + 1024)


def blocks_per_sm(bm: int, bn: int) -> int:
    """Blocks of a 3-stage plan an SM holds (``gemm::min_blocks``, the
    registers and shared memory of the H100): one for 128 x 128 tiles,
    else two."""
    return 1 if (bm, bn) == (128, 128) else 2


def _last_wave_fill(tiles: int, bm: int, bn: int) -> float:
    """Share of the blocks' slots over all waves that tiles occupy."""
    slots = SMS * blocks_per_sm(bm, bn)
    return tiles / (_cdiv(tiles, slots) * slots)


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, residual: bool = False) -> Plan:
    if residual:
        bm, bn = 64, 64
    else:
        bn = 64 if n <= 64 or _cdiv(n, 64) * 64 < _cdiv(n, 128) * 128 \
            else 128
        tiles_n = _cdiv(n, bn)
        t128, t64 = _cdiv(m, 128) * tiles_n, _cdiv(m, 64) * tiles_n
        bm = 64 if t128 < SMS or (_last_wave_fill(t64, 64, bn)
                                  > _last_wave_fill(t128, 128, bn) + 0.05) \
            else 128
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    ksteps = _cdiv(k, BK)
    split = 1
    if tiles < SMS and ksteps > 1:
        want = min(_cdiv(SMS, tiles), ksteps, MAX_SPLIT)
        split = _cdiv(ksteps, _cdiv(ksteps, want))
    return Plan(bm, bn, split, STAGES, smem_bytes(bm, bn, STAGES))


def workspace(p: Plan, m: int, n: int, device):
    """The split-K workspace ``[split, M, N]`` f32 for a launch (None
    without a split); every element is written before it is read."""
    if p.split == 1:
        return None
    return torch.empty((p.split, m, n), dtype=torch.float32, device=device)


def weight_storage(w: torch.Tensor, who: str):
    """``(nk, storage)`` of a ``[K, N]`` weight operand: a contiguous
    ``[K, N]`` tensor (nk False), or the transpose of a contiguous ``[N, K]``
    one (nk True; the layers' and the executor's storage, read as it is)."""
    if w.is_contiguous():
        return False, w
    if w.t().is_contiguous():
        return True, w.t()
    raise ValueError(f"{who}: w must be a contiguous [K, N] tensor or the "
                     f"transpose of a contiguous [N, K] one")
