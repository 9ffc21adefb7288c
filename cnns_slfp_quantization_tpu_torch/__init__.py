"""PyTorch / CUDA port of the SLFP/SFP CNN quantization framework.

The JAX package ``cnns_slfp_quantization_tpu`` beside this one is the
reference; this package imports nothing of it.  Ported so far: the
quantizer core (:mod:`.ops.sfp`), the quantized layers, ResNet-50 with its
fused SLFP8 serving executor, and three hand kernels for Hopper
(:mod:`.kernels`, sources in ``csrc/``).
"""
