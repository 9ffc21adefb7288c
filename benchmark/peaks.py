"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit) and the roofline bound.

Frozen copy of ``cnns_slfp_quantization_tpu_torch/utils/bench_roofline.py``
(``HBM_BYTES_PER_S``, ``BF16_FLOPS``, ``TF32_FLOPS``, ``F32_OPS``,
``bound_ms``), so that the yardstick does not move with the program.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12            # tensor cores
TF32_FLOPS = 495e12            # tensor cores under TF32
F32_OPS = 67e12                # float32 outside the tensor cores
L2_BYTES = 50e6

PEAKS = {"bf16": BF16_FLOPS, "tf32": TF32_FLOPS, "float32": F32_OPS}


def bound_ms(nbytes, ops, peak):
    """(the least milliseconds the card could take for ``nbytes`` moved
    and ``ops`` operations at ``peak`` per second, what bounds it:
    ``"bytes"`` or ``"operations"``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")
