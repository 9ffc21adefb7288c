// Device math shared by the hand kernels (K1 quantize.cu, K2 qmm.cu, K3
// epilogue.cu, and K4-K6): the SLFP<3,4> / SFP<3,3> activation quantizer in
// the float32 bit domain and the fused affine epilogue.
//
// Bit-equal to the plain PyTorch versions (ops/sfp.py::act_bf16_bits and
// slfp34_act_bits, kernels/epilogue.py::affine_f32) and through them to the
// JAX package (ops/sfp.py::_act_bf16_bits,
// kernels/quantize.py::slfp34_act_bits).
// tests/test_torch_port_kernels.py checks that the constants below equal
// the ones ops/sfp.py derives.
//
// Subnormal floats are flushed to a zero of the same sign around every float
// operation, as XLA does on the CPU and TPU; no build flag is relied on for
// it.  The exact route flushes explicitly (ftz() around each operation).
// The FTZ route folds the flushes into the .ftz forms of the instructions
// (fma_ftz, mul_ftz, add_ftz), which flush every operand and the result:
// the same bits wherever the operands the exact route does not flush (an
// affine's scale and shift, a reciprocal, a depthwise tap) are not
// subnormal, which the wrappers check before they take it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slfp {

// nibble table D3[j] = M7[j] - 8j + 3 (ops/sfp.py D3_LO / D3_HI)
constexpr int32_t kD3Lo = 0x00123513;
constexpr int32_t kD3Hi = 0x08642100;
constexpr int32_t kPz16 = 0x2EDC;                 // bf16(1e-10)
constexpr int32_t kI32Lo = 0x3D800000;            // f32 bits of 0.0625
constexpr int32_t kI32ClampSlfp = 0x4175257A;     // 15.32165
constexpr int32_t kI32ClampSfp33 = 0x41700000;    // 15.0
constexpr int32_t kI32FloorSlfp = 0x3DFC0000;     // 0.123046875
constexpr int32_t kI32FloorSfp33 = 0x3DF80000;    // 0.12109375
constexpr int32_t kI32PseudoZero = 0x2EDBE6FF;    // f32 bits of 1e-10
constexpr int32_t kI32Eighth = 0x3E000000;        // 0.125
constexpr int32_t kMlMagic = 0x7FFC;

// 23-bit mantissa field of float32(2**(ml/16)), ml = 0..15
__device__ __forceinline__ int32_t p_table(int32_t ml) {
  switch (ml) {
    case 0: return 0x0;       case 1: return 0x5AAC3;
    case 2: return 0xB95C2;   case 3: return 0x11C3D3;
    case 4: return 0x1837F0;  case 5: return 0x1EF532;
    case 6: return 0x25FED7;  case 7: return 0x2D583F;
    case 8: return 0x3504F3;  case 9: return 0x3D08A4;
    case 10: return 0x45672A; case 11: return 0x4E248C;
    case 12: return 0x5744FD; case 13: return 0x60CCDF;
    case 14: return 0x6AC0C7; default: return 0x75257D;
  }
}

__device__ __forceinline__ float ftz(float v) {
  return (__float_as_int(v) & 0x7FFFFFFF) < 0x00800000 ? v * 0.f : v;
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float d;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
}

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float d;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float add_ftz(float a, float b) {
  float d;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// the quantize of an already scaled and flushed xs = ftz(x * recip)
__device__ __forceinline__ uint16_t act_bf16_bits_scaled(float xs, int qbit,
                                                         bool nonneg) {
  const int32_t bits = __float_as_int(xs);
  const int32_t a = nonneg ? bits : (bits & 0x7FFFFFFF);
  int32_t out;
  if (qbit == 8) {
    const int32_t am = max(min(a, kI32ClampSlfp), kI32FloorSlfp);
    const int32_t t = am + (0x3FFFF + ((am >> 19) & 1));
    const int32_t r4 = t >> 19;
    const int32_t j = r4 & 15;
    const int32_t sel = j >= 8 ? kD3Hi : kD3Lo;
    const int32_t d = (sel >> ((j & 7) << 2)) & 15;
    out = (r4 << 3) + (d - 3);
  } else {
    const int32_t am = max(min(a, kI32ClampSfp33), kI32FloorSfp33);
    const int32_t t = am + (0x7FFFF + ((am >> 20) & 1));
    out = (t >> 20) << 4;
  }
  if (a < kI32Lo) out = (a == 0) ? 0 : kPz16;
  if (!nonneg) out |= (bits >> 16) & 0x8000;
  return static_cast<uint16_t>(out);
}

// quantize_act(x * recip, qbit) as bf16 bits (ops/sfp.py::act_bf16_bits)
__device__ __forceinline__ uint16_t act_bf16_bits(float x, float recip,
                                                  int qbit, bool nonneg) {
  return act_bf16_bits_scaled(ftz(__fmul_rn(ftz(x), recip)), qbit, nonneg);
}

// x * recip flushed, on either route (kFtz: recip not subnormal)
template <bool kFtz>
__device__ __forceinline__ float scaled(float x, float recip) {
  return kFtz ? mul_ftz(x, recip) : ftz(__fmul_rn(ftz(x), recip));
}

// SLFP<3,4> activation quantize, float32 result (slfp34_act_bits)
__device__ __forceinline__ float slfp34_act_f32(float x) {
  const int32_t bits = __float_as_int(x);
  const int32_t sign = bits & static_cast<int32_t>(0x80000000u);
  const int32_t ab = bits & 0x7FFFFFFF;
  const int32_t lsb = (ab >> 19) & 1;
  const int32_t r = (ab + 0x3FFFF + lsb) & -0x80000;
  const int32_t j = (r >> 19) & 15;
  const int32_t ml = j + ((kMlMagic >> j) & 1);
  int32_t out = (r & -0x00800000) | p_table(ml);
  if (ab < kI32Lo) out = (ab == 0) ? 0 : kI32PseudoZero;
  else if (ab < kI32Eighth) out = kI32Eighth;
  if (ab > kI32ClampSlfp) out = kI32ClampSlfp;
  return __int_as_float(out | sign);
}

// folded-BN affine, single rounding (kernels/epilogue.py::affine_f32), the
// residual add and ReLU; ReLU yields +0.0, never -0.0
__device__ __forceinline__ float epilogue_value(float y, float s, float t,
                                                bool has_res, float r,
                                                bool relu) {
  float v = ftz(__fmaf_rn(ftz(y), s, t));
  if (has_res) v = ftz(__fadd_rn(v, ftz(r)));
  if (relu) v = v > 0.f ? v : 0.f;
  return v;
}

// the same with its flags fixed at compile time, on either route (kFtz: s
// and t not subnormal)
template <bool kFtz, bool kRes, bool kRelu>
__device__ __forceinline__ float epilogue_value(float y, float s, float t,
                                                float r) {
  float v = kFtz ? fma_ftz(y, s, t) : ftz(__fmaf_rn(ftz(y), s, t));
  if (kRes) v = kFtz ? add_ftz(v, r) : ftz(__fadd_rn(v, ftz(r)));
  if (kRelu) v = v > 0.f ? v : 0.f;
  return v;
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_to_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// uint8 SLFP<3,4> code -> bf16 bits: the exact float32 value
// (ops/sfp.py::slfp34_decode_bits) rounded to nearest even, as the JAX
// kernel's decode(...).astype(bfloat16) and the bf16 frozen weights are
__device__ __forceinline__ uint16_t decode_code_bf16(uint8_t c) {
  const int32_t code7 = c & 0x7F;
  uint32_t bits = code7 == 0
      ? 0u
      : static_cast<uint32_t>((((code7 >> 4) - 4 + 127) << 23) |
                              p_table(code7 & 15));
  bits |= static_cast<uint32_t>(c & 0x80) << 24;
  return bf16_bits(__uint_as_float(bits));
}

}  // namespace slfp
