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
// Bound on the H100: memory in principle (2 bytes in and 2 out per element
// at bf16), but at some 80 instructions per element (9 FMAs with their
// flushes, the epilogue and the quantize) the rate of instructions and of
// loads and stores sets the pace, so the design spends as few as it can
// beside the arithmetic.  A block stages a 16x8 tile of output pixels plus the
// one-pixel halo (18x10 pixels, 32 channels, as flushed f32 with zeros
// outside the image) in shared memory, each x element converted and flushed
// once; each of its 256 threads then computes 8 consecutive channels of two
// output pixels eight rows apart, loading each tap's 8 channels once (two
// 16-byte loads) for both, and writes each pixel as one 16-byte vector.  A
// staged pixel is padded to 36 floats so that a quarter warp's 16-byte
// shared-memory reads hit distinct banks.  Halo pixels are read by up to
// four blocks; the 50 MB L2 absorbs most of that.  A scalar path covers C
// not a multiple of 8 and unaligned pointers.
#include "slfp.cuh"

namespace {

constexpr int kTile = 8;                       // output columns; rows per pass
constexpr int kPasses = 2;                     // output rows per thread
constexpr int kTileH = kTile * kPasses;        // output rows per block
constexpr int kHalo = kTile + 2;               // staged columns
constexpr int kHaloH = kTileH + 2;             // staged rows
constexpr int kVec = 8;                        // channels per thread
constexpr int kGroups = 4;                     // channel vectors per block
constexpr int kCb = kVec * kGroups;            // channels per block
constexpr int kThreads = kTile * kTile * kGroups;
// a staged pixel's floats: 4 past kCb, so the two pixels that share a
// quarter warp's 16-byte reads fall in different banks
constexpr int kPitch = kCb + 4;

struct Args {
  const void* x;
  const float* w;
  const float* s;
  const float* t;
  void* out;
  int h, w_, c;
  int groups_c;
  float recip;
  bool x_bf16, out_f32, relu, quant, nonneg, vec;
};

// the 8 channels c0..c0+7 of element offset e, as float32 (0 beyond C)
__device__ __forceinline__ void load8(const Args& a, long long e, int c0,
                                      float (&v)[kVec]) {
  if (a.vec) {
    if (a.x_bf16) {
      const uint4 u =
          *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(a.x) + e);
      const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = __uint_as_float(wd[k] << 16);
        v[2 * k + 1] = __uint_as_float(wd[k] & 0xFFFF0000u);
      }
    } else {
      const float4* p =
          reinterpret_cast<const float4*>(static_cast<const float*>(a.x) + e);
      const float4 p0 = p[0], p1 = p[1];
      v[0] = p0.x; v[1] = p0.y; v[2] = p0.z; v[3] = p0.w;
      v[4] = p1.x; v[5] = p1.y; v[6] = p1.z; v[7] = p1.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (c0 + k < a.c) {
      v[k] = a.x_bf16
                 ? slfp::bf16_to_float(static_cast<const uint16_t*>(a.x)[e + k])
                 : static_cast<const float*>(a.x)[e + k];
    }
  }
}

// 8 consecutive float32 parameters (taps, scale or shift), 0 beyond C
__device__ __forceinline__ void load_f32x8(const Args& a, const float* p,
                                           int nk, float (&v)[kVec]) {
  if (a.vec) {
    const float4 p0 = __ldg(reinterpret_cast<const float4*>(p));
    const float4 p1 = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = p0.x; v[1] = p0.y; v[2] = p0.z; v[3] = p0.w;
    v[4] = p1.x; v[5] = p1.y; v[6] = p1.z; v[7] = p1.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = k < nk ? __ldg(p + k) : 0.f;
}

// epilogue, quantize and store of channels c0.. of output pixel (oy, ox)
__device__ __forceinline__ void store8(const Args& a, const float (&acc)[kVec],
                                       const float (&sv)[kVec],
                                       const float (&tv)[kVec], long long img,
                                       int oy, int ox, int c0, int nk) {
  uint16_t hb[kVec] = {0, 0, 0, 0, 0, 0, 0, 0};
  float fv[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float v = slfp::epilogue_value(acc[k], sv[k], tv[k], false, 0.f,
                                         a.relu);
    if (a.quant) {
      hb[k] = slfp::act_bf16_bits(v, a.recip, 8, a.relu || a.nonneg);
      fv[k] = slfp::bf16_to_float(hb[k]);
    } else {
      hb[k] = slfp::bf16_bits(v);
      fv[k] = v;
    }
  }
  const long long e = (img + static_cast<long long>(oy) * a.w_ + ox) * a.c + c0;
  if (a.out_f32) {
    float* o = static_cast<float*>(a.out) + e;
    if (a.vec) {
      reinterpret_cast<float4*>(o)[0] = make_float4(fv[0], fv[1], fv[2], fv[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(fv[4], fv[5], fv[6], fv[7]);
    } else {
      for (int k = 0; k < nk; ++k) o[k] = fv[k];
    }
  } else {
    uint16_t* o = static_cast<uint16_t*>(a.out) + e;
    if (a.vec) {
      uint4 u;
      u.x = hb[0] | (static_cast<uint32_t>(hb[1]) << 16);
      u.y = hb[2] | (static_cast<uint32_t>(hb[3]) << 16);
      u.z = hb[4] | (static_cast<uint32_t>(hb[5]) << 16);
      u.w = hb[6] | (static_cast<uint32_t>(hb[7]) << 16);
      *reinterpret_cast<uint4*>(o) = u;
    } else {
      for (int k = 0; k < nk; ++k) o[k] = hb[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads) dw3x3_kernel(Args a) {
  __shared__ __align__(16) float tile[kHaloH][kHalo][kPitch];
  const int g = blockIdx.x % a.groups_c;
  const int h0 = blockIdx.y * kTileH;
  const int w0 = (blockIdx.x / a.groups_c) * kTile;
  const long long img = static_cast<long long>(blockIdx.z) * a.h * a.w_;
  const int cbase = g * kCb;

  // stage the halo tile: zeros outside the image and beyond C
  for (int slot = threadIdx.x; slot < kHaloH * kHalo * kGroups;
       slot += kThreads) {
    const int cv = slot % kGroups;
    const int p = slot / kGroups;
    const int ty = p / kHalo, tx = p % kHalo;
    const int y = h0 + ty - 1, x = w0 + tx - 1;
    const int c0 = cbase + cv * kVec;
    float v[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (y >= 0 && y < a.h && x >= 0 && x < a.w_ && c0 < a.c) {
      load8(a, (img + static_cast<long long>(y) * a.w_ + x) * a.c + c0, c0, v);
    }
    float4* dst = reinterpret_cast<float4*>(&tile[ty][tx][cv * kVec]);
    dst[0] = make_float4(slfp::ftz(v[0]), slfp::ftz(v[1]), slfp::ftz(v[2]),
                         slfp::ftz(v[3]));
    dst[1] = make_float4(slfp::ftz(v[4]), slfp::ftz(v[5]), slfp::ftz(v[6]),
                         slfp::ftz(v[7]));
  }
  __syncthreads();

  const int cv = threadIdx.x % kGroups;
  const int px = (threadIdx.x / kGroups) % kTile;
  const int py = threadIdx.x / (kGroups * kTile);
  const int ox = w0 + px;
  const int c0 = cbase + cv * kVec;
  if (ox >= a.w_ || c0 >= a.c || h0 + py >= a.h) return;
  const int nk = min(kVec, a.c - c0);

  // rows py and py + 8 of the block's 16, the taps loaded once for both
  float acc[kPasses][kVec] = {};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float wv[kVec];
      load_f32x8(a, a.w + (i * 3 + j) * a.c + c0, nk, wv);
#pragma unroll
      for (int r = 0; r < kPasses; ++r) {
        const float4* s4 = reinterpret_cast<const float4*>(
            &tile[py + r * kTile + i][px + j][cv * kVec]);
        const float4 x0 = s4[0], x1 = s4[1];
        const float xv[kVec] = {x0.x, x0.y, x0.z, x0.w,
                                x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          acc[r][k] = slfp::ftz(__fmaf_rn(xv[k], wv[k], acc[r][k]));
        }
      }
    }
  }
  float sv[kVec], tv[kVec];
  load_f32x8(a, a.s + c0, nk, sv);
  load_f32x8(a, a.t + c0, nk, tv);
#pragma unroll
  for (int r = 0; r < kPasses; ++r) {
    const int oy = h0 + py + r * kTile;
    if (oy < a.h) store8(a, acc[r], sv, tv, img, oy, ox, c0, nk);
  }
}

}  // namespace

extern "C" int slfp_dw3x3(const void* x, int x_bf16, const void* w,
                          const void* s, const void* t, void* out,
                          int out_f32, int n, int h, int w_, int c, int relu,
                          int quant, float recip, int nonneg_in, int vec,
                          void* stream) {
  Args a;
  a.x = x;
  a.w = static_cast<const float*>(w);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.out = out;
  a.h = h;
  a.w_ = w_;
  a.c = c;
  a.groups_c = (c + kCb - 1) / kCb;
  a.recip = recip;
  a.x_bf16 = x_bf16 != 0;
  a.out_f32 = out_f32 != 0;
  a.relu = relu != 0;
  a.quant = quant != 0;
  a.nonneg = nonneg_in != 0;
  a.vec = vec != 0;
  if (n > 0 && h > 0 && w_ > 0 && c > 0) {
    const int tiles_w = (w_ + kTile - 1) / kTile;
    const dim3 grid(static_cast<unsigned>(tiles_w * a.groups_c),
                    static_cast<unsigned>((h + kTileH - 1) / kTileH),
                    static_cast<unsigned>(n));
    dw3x3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
