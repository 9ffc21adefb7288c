"""A device kernel's class by its name in a profiler trace.

Frozen copy of ``cnns_slfp_quantization_tpu_torch/utils/profiling.py``
(``HAND_KERNELS``, ``HAND_CLASSES``, ``SPLITK_CLASSES``, ``LIBRARY_CLASSES``
and ``kernel_class``), so that the
breakdown's classes do not move with the program.  Copies between host and
device, and fills, get classes of their own (:func:`device_op_class`).
"""

from __future__ import annotations

import re

# kernel wrapper -> the name of the device kernel one call launches, as the
# trace spells it (split-K's second pass, ``splitk_reduce``, not counted)
HAND_KERNELS = {
    "act_quantize": r"\bquantize_kernel<",
    "slfp34_act_quantize": r"\bf32form_kernel<",
    "qmm_fused": r"\bgemm_kernel<.*\bQmmEpi\b",
    "bn_epilogue": r"\bepilogue_(slab|any)\b",
    "fused_quant_matmul": r"\bgemm_kernel<.*\bFusedEpi\b",
    "dw3x3": r"\bdw3x3_kernel<",
    "bottleneck_chain": r"\bchain_kernel<",
}

# kernel class of each hand kernel's launches, by wrapper; split-K's second
# pass goes with the GEMM whose epilogue type it carries
HAND_CLASSES = {
    "act_quantize": "K1", "slfp34_act_quantize": "K1", "qmm_fused": "K2",
    "bn_epilogue": "K3", "fused_quant_matmul": "K4", "dw3x3": "K5",
    "bottleneck_chain": "K6",
}
SPLITK_CLASSES = ((r"\bsplitk_reduce<.*\bQmmEpi\b", "K2"),
                  (r"\bsplitk_reduce<.*\bFusedEpi\b", "K4"))

# library class -> substrings of the kernel names it takes, tried in order
# after the hand kernels
LIBRARY_CLASSES = (
    ("cuDNN conv", ("cudnn", "conv", "implicit", "dgrad", "wgrad", "fprop",
                    "Winograd")),
    ("cuBLAS", ("gemm", "cutlass", "cublas", "Kernel2", "splitKreduce")),
)


def kernel_class(name: str) -> str:
    """A device kernel's class by its trace name: its hand kernel (K1-K6,
    :data:`HAND_KERNELS`, split-K's second pass with its GEMM) before any
    library substring, else cuDNN, cuBLAS or elementwise."""
    for wrapper, pattern in HAND_KERNELS.items():
        if re.search(pattern, name):
            return HAND_CLASSES[wrapper]
    for pattern, label in SPLITK_CLASSES:
        if re.search(pattern, name):
            return label
    for label, keys in LIBRARY_CLASSES:
        if any(k in name for k in keys):
            return label
    return "elementwise"


def device_op_class(name: str) -> str:
    """:func:`kernel_class`, with host-device copies and fills apart."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return kernel_class(name)
