"""PyTorch / CUDA port of the SLFP/SFP CNN quantization framework.

The JAX package ``cnns_slfp_quantization_tpu`` beside this one is the
reference; this package imports nothing of it.  Ported so far: the
quantizer core (:mod:`.ops.sfp`), the quantized layers, every net of the
registry with the fused SLFP8 serving executors and ``serve``, the six
hand kernels for Hopper (:mod:`.kernels`, sources in ``csrc/``), and
quantization-aware training (:mod:`.train`, :mod:`.cli`).
"""
