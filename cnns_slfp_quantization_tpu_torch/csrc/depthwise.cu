// K5: stride-1 SAME depthwise 3x3 conv, folded-BN affine, ReLU and the next
// layer's quantize in one pass.
//
// Replaces the Pallas kernel cnns_slfp_quantization_tpu/kernels/depthwise.py::
// dw3x3 (:61).  On NHWC x with taps w[3][3][C] (f32) it computes per output
// element
//   acc = fma(x[i][j], w[i][j], acc)   over (i, j) = (0,0), (0,1), ..., (2,2)
//   v   = relu?(fma(acc, s[c], t[c]))
//   out = act_bf16_bits(v, recip, 8, relu || nonneg_in)   (quant)
//   out = v                                               (otherwise)
// as bf16 or f32, every float operation rounded once and subnormals flushed
// (slfp.cuh), so it is bit-equal to kernels/depthwise.py::dw3x3_plain.
//
// Bound on the H100: 2 bytes in and 2 out per element at bf16 would take
// 0.119 ms per MobileNetV1 forward at batch 64, but the first design spent
// some 80 instructions per element (nine FMAs each followed by a software
// flush, x widened, flushed and staged as f32, taps re-read per output row
// pair, the epilogue and the quantize with flushes of their own), so the
// issue rate set the pace.  This design's serving form compiles to about
// 33 (nine of them the FMAs):
//   - Flushes folded into the arithmetic.  fma.rn.ftz.f32 flushes subnormal
//     inputs and a subnormal result, sign kept: for a flushed acc and a tap
//     that is not subnormal it equals ftz(fma(ftz(x), w, acc)), and it
//     flushes x in place.  Likewise fma.rn.ftz for the affine (acc flushed;
//     s, t not subnormal) and mul.rn.ftz for the quantize's x * recip (the
//     epilogue value flushed; recip not subnormal).  The wrapper checks the
//     taps, scale and shift once per tensor on the host and launches this
//     route (kFtz) only when none is subnormal, else the exact route, which
//     keeps the explicit software flushes.
//   - A register stream down the rows.  Each thread owns 4 channels of one
//     output column over a band of `rows` output rows and holds the 36 taps
//     in registers.  It reads each input row of its band plus the two halo
//     rows once (3 pixels, each as one 8-byte load of bf16 widened by a
//     shift or a mask, or 16 of f32), one row ahead of the arithmetic so
//     that the loads' latency hides behind it, and adds it into the three
//     output rows it belongs to: taps of row 2 into output iy - 1 (which is
//     then complete and stored), row 1 into output iy, row 0 into iy + 1.
//     Each output still takes its nine taps in (0,0)..(2,2) order.  No
//     shared memory: the neighbouring columns' loads of the same pixels hit
//     in L1.  Bands are at most 16 rows, so halo rows add at most 1/8 loads.
//   - No branch inside a step but the store's.  Per-output predicates on
//     the FMAs made the compiler widen each value once per predicate, and
//     runtime flags inside the unrolled channel loop kept the 4 channels'
//     epilogues apart; so every step adds into all three accumulators, and
//     the serving form (ReLU, quantize, bf16 out, vector access) is a
//     compile-time variant (kServe).  The quantize reads its codebook
//     nibble from a 16-word table in shared memory.
//   - The plan (kernels/depthwise.py::plan) sizes the block per shape: cg
//     channel groups of 4 by tw columns, at most 256 threads, tw chosen so
//     that the columns split evenly over the tiles (MobileNetV1's 112, 56,
//     28, 14 and 7 leave no thread idle).  Thread t of a block owns channel
//     group t % cg and column t / cg; block (x, y, z) is channel tile
//     x % ctiles, column tile x / ctiles, band y, image z.
// The epilogue and the quantize run on the 4 channels of a pixel and store
// them as one 8-byte (bf16) or 16-byte (f32) vector.  A scalar path covers
// C not a multiple of 4 and unaligned pointers.
#include "slfp.cuh"

namespace {

constexpr int kVec = 4;            // channels per thread
constexpr int kMaxThreads = 256;

struct Args {
  const void* x;
  const float* w;
  const float* s;
  const float* t;
  void* out;
  int h, w_, c;
  int cg, tw, rows, ctiles;        // the plan
  float recip;
  bool out_f32, relu, quant, nonneg, vec;
};

using slfp::fma_ftz;
using slfp::mul_ftz;

// one tap: acc + x * w, rounded once, subnormals flushed (x flushed at its
// load on the exact route)
template <bool kFtz>
__device__ __forceinline__ float tap(float x, float w, float acc) {
  return kFtz ? fma_ftz(x, w, acc) : slfp::ftz(__fmaf_rn(x, w, acc));
}

// 4 float32 parameters (taps, scale or shift) from p, 0 beyond C
__device__ __forceinline__ void load_f32x4(bool vec, const float* p,
                                           int nk, float (&v)[kVec]) {
  if (vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = k < nk ? __ldg(p + k) : 0.f;
}

// 4 channels of one pixel as loaded: bf16 bits or float32
template <bool kBf16>
struct Raw4;
template <>
struct Raw4<true> {
  uint2 u;
};
template <>
struct Raw4<false> {
  float4 f;
};

// channels c0.. of the 3 pixels at columns ox - 1, ox, ox + 1 of an input
// row, as loaded: ``off`` is the element offset of (that row, ox, c0);
// zeros where the row is outside the image (``row`` false), for columns
// that do not exist (bit j of ``cols`` clear: SAME padding) and beyond C
template <bool kBf16>
__device__ __forceinline__ void load_row(const Args& a, bool vec,
                                         long long off, bool row,
                                         unsigned cols, int nk,
                                         Raw4<kBf16> (&r)[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const bool ok = row && ((cols >> j) & 1);
    const long long e = off + (j - 1) * a.c;
    if constexpr (kBf16) {
      const uint16_t* q = static_cast<const uint16_t*>(a.x) + e;
      if (vec) {
        r[j].u = ok ? __ldg(reinterpret_cast<const uint2*>(q))
                    : make_uint2(0, 0);
      } else {
        uint16_t h[kVec] = {0, 0, 0, 0};
        if (ok)
          for (int k = 0; k < nk; ++k) h[k] = q[k];
        r[j].u = make_uint2(h[0] | (static_cast<uint32_t>(h[1]) << 16),
                            h[2] | (static_cast<uint32_t>(h[3]) << 16));
      }
    } else {
      const float* q = static_cast<const float*>(a.x) + e;
      if (vec) {
        r[j].f = ok ? __ldg(reinterpret_cast<const float4*>(q))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float v[kVec] = {0.f, 0.f, 0.f, 0.f};
        if (ok)
          for (int k = 0; k < nk; ++k) v[k] = q[k];
        r[j].f = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// the loaded channels as float32 (flushed on the exact route; the FTZ
// route's fma flushes them itself)
template <bool kFtz, bool kBf16>
__device__ __forceinline__ void widen4(const Raw4<kBf16>& r,
                                       float (&v)[kVec]) {
  if constexpr (kBf16) {
    const uint2 u = r.u;
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xFFFF0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xFFFF0000u);
  } else {
    const float4 f = r.f;
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  if (!kFtz) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = slfp::ftz(v[k]);
  }
}

// slfp::act_bf16_bits_scaled(xs, 8, nonneg) with its codebook nibble
// table as 16 words in shared memory, e[j] = D3[j] - 3: one load in place
// of a select and three shifts and masks
__device__ __forceinline__ uint16_t act8(float xs, bool nonneg,
                                         const int32_t* e) {
  const int32_t bits = __float_as_int(xs);
  const int32_t a = nonneg ? bits : (bits & 0x7FFFFFFF);
  const int32_t am = max(min(a, slfp::kI32ClampSlfp), slfp::kI32FloorSlfp);
  const int32_t r4 = (am + (0x3FFFF + ((am >> 19) & 1))) >> 19;
  int32_t out = (r4 << 3) + e[r4 & 15];
  if (a < slfp::kI32Lo) out = (a == 0) ? 0 : slfp::kPz16;
  if (!nonneg) out |= (bits >> 16) & 0x8000;
  return static_cast<uint16_t>(out);
}

// epilogue, quantize and store of the 4 channels at element offset off;
// kServe: the serving form (ReLU, quantize, bf16 out, vector access)
// fixed at compile time, so that the unrolled channel loop holds no branch
template <bool kFtz, bool kServe>
__device__ __forceinline__ void store4(const Args& a, const float (&acc)[kVec],
                                       const float (&sv)[kVec],
                                       const float (&tv)[kVec], long long off,
                                       int nk, const int32_t* e) {
  const bool relu = kServe || a.relu, quant = kServe || a.quant;
  const bool out_f32 = !kServe && a.out_f32, vec = kServe || a.vec;
  uint16_t hb[kVec];
  float fv[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    // acc is flushed already on both routes
    float v = kFtz ? fma_ftz(acc[k], sv[k], tv[k])
                   : slfp::ftz(__fmaf_rn(acc[k], sv[k], tv[k]));
    if (relu) v = v > 0.f ? v : 0.f;
    if (quant) {
      const bool nn = relu || a.nonneg;
      hb[k] = kFtz ? act8(mul_ftz(v, a.recip), nn, e)
                   : slfp::act_bf16_bits(v, a.recip, 8, nn);
      fv[k] = slfp::bf16_to_float(hb[k]);
    } else {
      hb[k] = slfp::bf16_bits(v);
      fv[k] = v;
    }
  }
  if (out_f32) {
    float* o = static_cast<float*>(a.out) + off;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(fv[0], fv[1], fv[2], fv[3]);
    } else {
      for (int k = 0; k < nk; ++k) o[k] = fv[k];
    }
  } else {
    uint16_t* o = static_cast<uint16_t*>(a.out) + off;
    if (vec) {
      *reinterpret_cast<uint2*>(o) =
          make_uint2(hb[0] | (static_cast<uint32_t>(hb[1]) << 16),
                     hb[2] | (static_cast<uint32_t>(hb[3]) << 16));
    } else {
      for (int k = 0; k < nk; ++k) o[k] = hb[k];
    }
  }
}

template <bool kFtz, bool kBf16, bool kServe>
__global__ void __launch_bounds__(kMaxThreads) dw3x3_kernel(Args a) {
  __shared__ int32_t e[16];
  if (threadIdx.x < 16) {
    const int32_t j = threadIdx.x;
    e[j] = ((j >= 8 ? slfp::kD3Hi : slfp::kD3Lo) >> ((j & 7) << 2) & 15) - 3;
  }
  __syncthreads();
  const bool vec = kServe || a.vec;
  const int g = threadIdx.x % a.cg;
  const int col = threadIdx.x / a.cg;
  const int c0 = ((blockIdx.x % a.ctiles) * a.cg + g) * kVec;
  const int ox = (blockIdx.x / a.ctiles) * a.tw + col;
  if (c0 >= a.c || ox >= a.w_) return;
  const int nk = min(kVec, a.c - c0);
  const int r0 = blockIdx.y * a.rows;
  const int r1 = min(r0 + a.rows, a.h);       // outputs r0 .. r1 - 1
  const long long img =
      static_cast<long long>(blockIdx.z) * a.h * a.w_ * a.c;

  float wv[3][3][kVec];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) load_f32x4(vec, a.w + (i * 3 + j) * a.c + c0,
                                           nk, wv[i][j]);
  float sv[kVec], tv[kVec];
  load_f32x4(vec, a.s + c0, nk, sv);
  load_f32x4(vec, a.t + c0, nk, tv);

  // acc0: output row iy - 1, acc1: iy, acc2: iy + 1.  Every step adds
  // into all three: an accumulator of a row outside the band takes taps it
  // does not need and is never stored, and each stored row still takes its
  // nine from zero in order, so no step needs a branch.
  float acc0[kVec], acc1[kVec], acc2[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc0[k] = acc1[k] = acc2[k] = 0.f;
  // input row iy + 1 is loaded while row iy is summed: the loads of one
  // step are in flight across the arithmetic of the previous one
  const unsigned cols = (ox > 0 ? 1u : 0u) | 2u | (ox + 1 < a.w_ ? 4u : 0u);
  const long long rs = static_cast<long long>(a.w_) * a.c;  // one row
  long long off = img + (r0 - 1) * rs + static_cast<long long>(ox) * a.c + c0;
  Raw4<kBf16> cur[3], nxt[3];
  load_row<kBf16>(a, vec, off, r0 > 0, cols, nk, cur);
#pragma unroll 3
  for (int iy = r0 - 1; iy <= r1; ++iy, off += rs) {
    load_row<kBf16>(a, vec, off + rs, iy < r1 && iy + 1 < a.h, cols, nk,
                    nxt);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float xv[kVec];
      widen4<kFtz, kBf16>(cur[j], xv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        acc0[k] = tap<kFtz>(xv[k], wv[2][j][k], acc0[k]);
        acc1[k] = tap<kFtz>(xv[k], wv[1][j][k], acc1[k]);
        acc2[k] = tap<kFtz>(xv[k], wv[0][j][k], acc2[k]);
      }
    }
    if (iy > r0) store4<kFtz, kServe>(a, acc0, sv, tv, off - rs, nk, e);
#pragma unroll
    for (int j = 0; j < 3; ++j) cur[j] = nxt[j];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      acc0[k] = acc1[k];
      acc1[k] = acc2[k];
      acc2[k] = 0.f;
    }
  }
}

}  // namespace

extern "C" int slfp_dw3x3(const void* x, int x_bf16, const void* w,
                          const void* s, const void* t, void* out,
                          int out_f32, int n, int h, int w_, int c, int relu,
                          int quant, float recip, int nonneg_in, int vec,
                          int ftz, int cg, int tw, int rows, void* stream) {
  if (n <= 0 || h <= 0 || w_ <= 0 || c <= 0) return 0;
  if (cg < 1 || tw < 1 || rows < 1 || cg * tw > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = x;
  a.w = static_cast<const float*>(w);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.out = out;
  a.h = h;
  a.w_ = w_;
  a.c = c;
  a.cg = cg;
  a.tw = tw;
  a.rows = rows;
  a.ctiles = ((c + kVec - 1) / kVec + cg - 1) / cg;
  a.recip = recip;
  a.out_f32 = out_f32 != 0;
  a.relu = relu != 0;
  a.quant = quant != 0;
  a.nonneg = nonneg_in != 0;
  a.vec = vec != 0;
  const dim3 grid(static_cast<unsigned>(a.ctiles * ((w_ + tw - 1) / tw)),
                  static_cast<unsigned>((h + rows - 1) / rows),
                  static_cast<unsigned>(n));
  const dim3 block(static_cast<unsigned>(cg * tw));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the serving form: ReLU, the quantize, bf16 out, vector access
  const bool serve = a.relu && a.quant && !a.out_f32 && a.vec;
#define DW3X3(F, B, S) dw3x3_kernel<F, B, S><<<grid, block, 0, st>>>(a)
  if (ftz) {
    if (x_bf16) {
      if (serve) DW3X3(true, true, true); else DW3X3(true, true, false);
    } else {
      if (serve) DW3X3(true, false, true); else DW3X3(true, false, false);
    }
  } else {
    if (x_bf16) {
      if (serve) DW3X3(false, true, true); else DW3X3(false, true, false);
    } else {
      if (serve) DW3X3(false, false, true); else DW3X3(false, false, false);
    }
  }
#undef DW3X3
  return static_cast<int>(cudaGetLastError());
}
