"""The PyTorch numerics flags the SLFP8 serving paths and the training
step run under.

Shared by the fused ResNet-50 executor (``models/resnet50_fused.py``), the
qbit-8 module path of ``serve.InferenceEngine`` and ``train/loop.py``.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def backend_flags():
    """Set for the duration of one forward and restored after it, so that
    other models in the process keep their own.

    - cuDNN convolutions in TF32: the operands are bf16 values, which TF32
      holds exactly, so each product is exact and the sums stay float32;
      the result equals a full-float32 convolution and runs on tensor cores.
    - float32 matmuls in TF32 for the same reason (the operands of the
      plain matmuls and the head are bf16 values too); either setting is
      exact.
    - deterministic cuDNN algorithms, so that two runs on the same inputs
      (packed against float-frozen weights) give the same bits.
    """
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=True):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


@contextlib.contextmanager
def full_f32_matmul():
    """True float32 matmuls inside :func:`backend_flags`, for operands that
    are not bf16 values (the fp32 ImageNet classifier): TF32 would round
    them to 10 mantissa bits."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


@contextlib.contextmanager
def exact_f32():
    """cuDNN convolutions and float32 matmuls in full float32 (no TF32),
    restored after: the training step's backward reads float32 cotangents,
    which TF32 would round to 10 mantissa bits."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
