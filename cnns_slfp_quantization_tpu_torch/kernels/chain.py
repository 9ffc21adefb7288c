"""K6: a whole stride-1 ResNet bottleneck in one kernel (hand kernel
``csrc/chain.cu``).

Counterpart of the Pallas kernel ``kernels/chain.py::bottleneck_chain``.  On
NHWC bf16 ``xq`` (the quantized block input) and ``identity`` (the raw block
input), with bf16 weight values ``w1 [C, M]``, ``w2 [3, 3, M, M]`` (HWIO)
and ``w3 [M, C]`` and float32 per-channel affines, it computes

    y1  = Q(relu(fma(xq @ w1, a1, b1)), recip2)
    y2  = Q(relu(fma(sum over (dy, dx) of y1p[dy:, dx:] @ w2[dy, dx], a2, b2)),
            recip3)                          y1p: y1 zero-padded by one pixel
    y3  = relu(fma(y2 @ w3, a3, b3) + identity)
    raw = bf16(y3),  q = Q(y3, recip_next)

where ``Q(v, r) = bf16(slfp34_act_bits(v * f32(r)))`` is the chain's own
quantize of the float32 value (JAX ``chain.py:42-44``), not the bf16-bits
form K2 and K3 inline; ReLU gives +0.0; subnormals are flushed.  The kernel
keeps y1 and y2 in shared memory.  It takes a band of output rows per block,
or per pair of blocks that split its columns (``_plan``), whose GEMMs have at
most two 64-row tiles each: stages 1, 2 and 3 of ResNet-50 fit, stage 0
(56x56) does not, and the wrapper says so.  The plain version takes any
shape.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cnns_slfp_quantization_tpu_torch.kernels import _build
from cnns_slfp_quantization_tpu_torch.kernels.epilogue import (
    epilogue_value_plain,
)
from cnns_slfp_quantization_tpu_torch.ops import sfp

# limits of csrc/chain.cu: 64-row tiles per GEMM (one per consumer
# warpgroup), ring stages, and the shared memory of one block
MAX_ROW_TILES = 2
SMEM_LIMIT = 232448
_MAX_STAGES = 4
_X_TILE = 64 * 128          # bytes of a 64-row x tile (and of a weight box)
# blocks wanted in flight: about one per SM of the H100 (132)
_TARGET_BLOCKS = 128


def chain_quantize(v: torch.Tensor, recip: float) -> torch.Tensor:
    """``bf16(slfp34_act_bits(v * f32(recip)))`` on float32 ``v``.

    As XLA computes it: the product flushes subnormal inputs and results,
    and a multiply by 1.0 is dropped, so that a subnormal ``v`` reaches the
    quantizer (and maps to the pseudo-zero).  Inside K6 every ``v`` is an
    epilogue value, flushed already, and the two cases agree."""
    xs = v.to(torch.float32)
    if np.float32(recip) != 1:
        xs = sfp.flush_subnormals(sfp.flush_subnormals(xs) * torch.tensor(
            np.float32(recip), device=v.device))
    return sfp.slfp34_act_bits(xs).to(torch.bfloat16)


def bottleneck_chain_plain(xq, identity, w1, w2, w3, a1, b1, a2, b2, a3, b3,
                           *, recip2: float, recip3: float,
                           recip_next: float = 1.0, emit_raw: bool = True,
                           emit_q: bool = True):
    """Plain version of K6, in the JAX kernel's order: three float32
    matmuls of bf16 values, conv2 as nine shifted products summed one by one
    in (dy, dx) order from zero, each affine one rounding (K3's epilogue
    value)."""
    n, h, w, c = xq.shape
    m = w1.shape[1]
    x = xq.reshape(-1, c).to(torch.float32)
    y1 = epilogue_value_plain(x @ w1.to(torch.float32), a1, b1, None, True)
    y1p = F.pad(chain_quantize(y1, recip2).to(torch.float32).reshape(
        n, h, w, m), (0, 0, 1, 1, 1, 1))
    y2 = torch.zeros(n * h * w, m, dtype=torch.float32, device=xq.device)
    for dy in range(3):
        for dx in range(3):
            tap = y1p[:, dy:dy + h, dx:dx + w, :].reshape(-1, m)
            y2 = y2 + tap @ w2[dy, dx].to(torch.float32)
    y2 = epilogue_value_plain(y2, a2, b2, None, True)
    y2q = chain_quantize(y2, recip3).to(torch.float32)
    y3 = epilogue_value_plain(y2q @ w3.to(torch.float32), a3, b3,
                              identity.reshape(-1, c), True)
    raw = y3.to(torch.bfloat16).reshape(n, h, w, c) if emit_raw else None
    q = (chain_quantize(y3, recip_next).reshape(n, h, w, c) if emit_q
         else None)
    return raw, q


def _geometry(w: int, m: int, rows: int):
    """(row tiles of conv1, conv2, conv3; ring stages; shared memory bytes)
    of one block for a band of ``rows`` output rows:
    csrc/chain.cu::chain_geometry."""
    wp = w + 2
    tiles = tuple(-(-p // 64) for p in ((rows + 2) * w, rows * wp, rows * w))

    def chunk(t):   # output columns a chunk: 256 split over two warpgroups
        return 256 if t == 1 else 128

    stage = max(tiles[0] * _X_TILE + 128 * chunk(tiles[0]),
                128 * chunk(tiles[1]), 128 * chunk(tiles[2]))
    fixed = 1024 + 2 * (m + 8) * ((rows + 2) * wp + 2 + rows * w) \
        + 16 * _MAX_STAGES + 16
    stages = min(_MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    return tiles, stages, fixed + max(stages, 2) * stage


def _smem_bytes(w: int, m: int, rows: int):
    """(the most row tiles of one GEMM, shared memory bytes) of one block
    for a band of ``rows`` output rows."""
    tiles, _, smem = _geometry(w, m, rows)
    return max(tiles), smem


class Plan(NamedTuple):
    """Output rows per band, and blocks per band (``split`` 2: a cluster
    of two, each computing half of every GEMM's columns)."""
    rows: int
    split: int


@functools.lru_cache(maxsize=None)
def _plan(n: int, h: int, w: int, c: int, m: int) -> Plan:
    """The fewest bands that fit; then, while fewer than about 128 blocks
    are in flight, two blocks per band (where M and C halve into multiples
    of 16), then more bands.  Raises ValueError for shapes the kernel does
    not take."""
    if c % 16 or m % 16:
        raise ValueError(f"bottleneck_chain: C={c} and M={m} must be "
                         f"multiples of 16 on the card")

    def fits(rows):
        tiles, stages, smem = _geometry(w, m, rows)
        return (max(tiles) <= MAX_ROW_TILES and stages >= 2
                and smem <= SMEM_LIMIT)

    if not fits(1):
        tiles, stages, _ = _geometry(w, m, 1)
        raise ValueError(
            f"bottleneck_chain: a {h}x{w} image with M={m} does not fit the "
            f"kernel even in one-row bands (row tiles of 64 per GEMM "
            f"{tiles}, limit {MAX_ROW_TILES}; {stages} ring stages in "
            f"{SMEM_LIMIT} bytes of shared memory, at least 2)")
    bands = next(b for b in range(1, h + 1) if fits(math.ceil(h / b)))
    split = 2 if (n * bands < _TARGET_BLOCKS and c % 32 == 0
                  and m % 32 == 0) else 1
    bands = max(bands, min(h, math.ceil(_TARGET_BLOCKS / (n * split))))
    return Plan(math.ceil(h / bands), split)


def ftz_route(params, recips) -> bool:
    """Whether K6 may fold its epilogues' flushes into FTZ instructions:
    exact when no affine parameter or reciprocal is subnormal."""
    return (all(_build.normal_scalar(r) for r in recips)
            and all(_build.no_subnormal(t) for t in params))


def bottleneck_chain(
    xq: torch.Tensor,
    identity: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    w3: torch.Tensor,
    a1: torch.Tensor,
    b1: torch.Tensor,
    a2: torch.Tensor,
    b2: torch.Tensor,
    a3: torch.Tensor,
    b3: torch.Tensor,
    *,
    recip2: float,
    recip3: float,
    recip_next: float = 1.0,
    emit_raw: bool = True,
    emit_q: bool = True,
    ftz: Optional[bool] = None,
):
    """(raw, q) of a stride-1 bottleneck; either is None when not asked
    for.  xq, identity ``[N, H, W, C]`` bf16; w1 ``[C, M]``, w2 ``[3, 3, M,
    M]``, w3 ``[M, C]`` bf16 values; a*/b* float32 per channel (BN folded
    with Ka*Kw); recip2/recip3/recip_next: 1/Ka of conv2's, conv3's and the
    next layer's quantize; ``ftz``: the route, :func:`ftz_route` of the
    affines and reciprocals as the caller found it, or None to check them
    now (a device sync)."""
    if not (emit_raw or emit_q):
        raise ValueError("bottleneck_chain: nothing to emit")
    if xq.dim() != 4:
        raise ValueError(f"bottleneck_chain: xq must be [N, H, W, C], got "
                         f"{tuple(xq.shape)}")
    n, h, w, c = xq.shape
    m = w1.shape[-1]
    args = (xq, identity, w1, w2, w3, a1, b1, a2, b2, a3, b3)
    if xq.device.type == "cpu":
        return bottleneck_chain_plain(
            *args, recip2=recip2, recip3=recip3, recip_next=recip_next,
            emit_raw=emit_raw, emit_q=emit_q)
    shapes = ((xq, (n, h, w, c), torch.bfloat16),
              (identity, (n, h, w, c), torch.bfloat16),
              (w1, (c, m), torch.bfloat16), (w2, (3, 3, m, m), torch.bfloat16),
              (w3, (m, c), torch.bfloat16),
              (a1, (m,), torch.float32), (b1, (m,), torch.float32),
              (a2, (m,), torch.float32), (b2, (m,), torch.float32),
              (a3, (c,), torch.float32), (b3, (c,), torch.float32))
    for t, shape, dtype in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"bottleneck_chain: operand {tuple(t.shape)} {t.dtype}, "
                f"expected {shape} {dtype}")
    _build.check_cuda(*args)
    if not _build.aligned16(*args):
        raise ValueError("bottleneck_chain: operands must be 16-byte aligned")
    plan = _plan(n, h, w, c, m)
    if ftz is None:
        ftz = ftz_route((a1, b1, a2, b2, a3, b3),
                        (recip2, recip3, recip_next))
    raw = torch.empty_like(xq) if emit_raw else None
    q = torch.empty_like(xq) if emit_q else None
    _build.launch(
        "chain", "slfp_bottleneck_chain", *(t.data_ptr() for t in args),
        None if raw is None else raw.data_ptr(),
        None if q is None else q.data_ptr(), n, h, w, c, m, *plan,
        float(np.float32(recip2)), float(np.float32(recip3)),
        float(np.float32(recip_next)), int(ftz), _build.stream_of(xq))
    bottleneck_chain.launches += 1
    bottleneck_chain.ftz_launches += int(ftz)
    return raw, q


bottleneck_chain.launches = 0
bottleneck_chain.ftz_launches = 0   # of the launches, those on the FTZ route
