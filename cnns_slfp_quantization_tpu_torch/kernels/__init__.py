"""Hand kernels for Hopper (``csrc/*.cu``) with their plain PyTorch versions.

K1 :mod:`.quantize`, K2 :mod:`.qmm`, K3 :mod:`.epilogue`, K4
:mod:`.fused_matmul`, K5 :mod:`.depthwise`, K6 :mod:`.chain`.  A wrapper
given CUDA tensors launches its kernel (or raises) and adds one to its
``launches`` count; given CPU tensors it runs the plain version and counts
nothing.  Kernels build from source at first use (:mod:`._build`).
"""

from __future__ import annotations

from cnns_slfp_quantization_tpu_torch.kernels import (
    chain,
    depthwise,
    epilogue,
    fused_matmul,
    qmm,
    quantize,
)

# wrapper name -> wrapper, for the launch counts
WRAPPERS = {
    "act_quantize": quantize.act_quantize,
    "slfp34_act_quantize": quantize.slfp34_act_quantize,
    "qmm_fused": qmm.qmm_fused,
    "bn_epilogue": epilogue.bn_epilogue,
    "fused_quant_matmul": fused_matmul.fused_quant_matmul,
    "dw3x3": depthwise.dw3x3,
    "bottleneck_chain": chain.bottleneck_chain,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    epilogue.bn_epilogue.dual_launches = 0


def launches() -> dict:
    out = {name: fn.launches for name, fn in WRAPPERS.items()}
    out["bn_epilogue_dual"] = epilogue.bn_epilogue.dual_launches
    return out
