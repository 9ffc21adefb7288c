// K4: SLFP act-quantize -> weight decode -> bf16 GEMM -> scaled epilogue,
// the module path's 1x1 convolutions and dense layers on packed weights.
//
// Replaces the Pallas kernel cnns_slfp_quantization_tpu/kernels/
// fused_matmul.py::fused_quant_matmul (:76, body _matmul_kernel :55):
//   out = act((Q_a(x/ka) @ decode(W) [+ b * f32(1/(ka*kw))]) * f32(ka*kw))
//   x   the rows of a [B, H, W, K] view with any row strides and contiguous
//       channels: a dense [M, K] matrix, an NHWC activation or its stride-2
//       view.  f32 or bf16; quantized while staged (signed or nonneg form of
//       slfp::act_bf16_bits), or only rounded to bf16;
//   W   [K, N] uint8 SLFP<3,4> codes (decoded while staged) or bf16 values,
//       stored [K, N] or [N, K]: the [N, K] form is the OIHW / [out, in]
//       storage of the port's layers, read as it is, never transposed;
//   out [M, N] f32 or bf16, contiguous.
//
// Bound on the H100: bytes, in both regimes of the module path.  SqueezeNet
// 1.0's 1x1 convs (K = 16..512, N = 16..1000, up to 186,624 rows at batch
// 64) do at most 2KN / (2K + 2N) flops per byte moved, under 256, below the
// ~295 flops per byte where the bf16 tensor cores would bind.  AlexNet's FC
// layers at batch 64 read 58.6 MB of uint8 codes for 128 flops per code.
//
// Design (right and simple first): K2's tiling (csrc/qmm.cu).  64x64 output
// tiles per 128-thread block, four warps each owning a 32x32 quadrant as
// 2x2 nvcuda::wmma 16x16x16 bf16 fragments with f32 sums, K walked in steps
// of 32.  The next step's tiles are fetched into registers (16-byte loads)
// while the tensor cores work on the current one; the quantize (or bf16
// rounding) of x and the decode of the codes run as those registers are
// stored to shared memory, so neither costs a pass over device memory.  The
// row of each of a thread's two x chunks is the same for the whole K loop,
// so its address (b, i, j) is unravelled once.  Codes decode through a
// 256-entry table of bf16 patterns that each block builds in shared memory
// once (decoding each code through slfp::decode_code_bf16's 16-way
// mantissa switch diverges within warps).  The epilogue (bias, scale, ReLU,
// cast) runs on the f32 sums in registers after one pass through shared
// memory, 8 consecutive channels per thread.  Ragged M, K and N (K,
// N multiples of 8) are masked with zero fill.  At AlexNet's FC shapes the
// grid has N/64 = 64 blocks for 132 SMs and one K step in flight per block:
// split-K, a deeper pipeline (cp.async or TMA) and wgmma are later work.
#include <mma.h>

#include <type_traits>

#include "slfp.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 128;
constexpr int kLdA = kBK + 8;     // As[m][k]; padded rows, multiples of 8
constexpr int kLdBkn = kBN + 8;   // Bs[k][n] for [K, N] storage
constexpr int kLdBnk = kBK + 8;   // Bs[n][k] for [N, K] storage
constexpr int kLdC = kBN + 4;
constexpr int kBsElems =
    kBK * kLdBkn > kBN * kLdBnk ? kBK * kLdBkn : kBN * kLdBnk;

struct Params {
  const void* x;
  const void* w;
  const float* bias;
  void* out;
  long long m;
  int k, n;
  long long hw;            // rows per image (H * W)
  int wdim;                // W
  long long sb, sh, sw;    // element strides of x's B, H, W axes
  float recip, c_bias, c_scale;
  bool w_u8, quant_x, nonneg, relu, out_f32;
};

struct Staged {
  uint4 a[2][2];  // 2 chunks of 8 x values: 8 bf16 in [0], or 8 f32
  uint4 b[2];     // 2 chunks of 8 bf16 (or 8 uint8 codes in .x/.y) of W
};

__device__ __forceinline__ long long row_offset(const Params& p,
                                                long long m) {
  const long long b = m / p.hw;
  const long long r = m - b * p.hw;
  const long long i = r / p.wdim;
  const long long j = r - i * p.wdim;
  return b * p.sb + i * p.sh + j * p.sw;
}

template <bool kXf32, bool kWnk>
__device__ __forceinline__ void fetch(const Params& p, int n0, int k0,
                                      int tid, const long long a_off[2],
                                      Staged& st) {
  const int kc = (tid % (kBK / 8)) * 8;  // the same for both chunks
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = k0 + kc;
    st.a[i][0] = st.a[i][1] = make_uint4(0, 0, 0, 0);
    if (a_off[i] >= 0 && k < p.k) {
      if (kXf32) {
        const uint4* src = reinterpret_cast<const uint4*>(
            static_cast<const float*>(p.x) + a_off[i] + k);
        st.a[i][0] = src[0];
        st.a[i][1] = src[1];
      } else {
        st.a[i][0] = *reinterpret_cast<const uint4*>(
            static_cast<const uint16_t*>(p.x) + a_off[i] + k);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = tid + i * kThreads;
    // [K, N]: 32 rows of k x 8 chunks along n; [N, K]: 64 rows of n x 4
    // chunks along k
    const int k = kWnk ? k0 + (chunk % (kBK / 8)) * 8 : k0 + chunk / (kBN / 8);
    const int n = kWnk ? n0 + chunk / (kBK / 8) : n0 + (chunk % (kBN / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < p.k && n < p.n) {
      const long long off = kWnk ? static_cast<long long>(n) * p.k + k
                                 : static_cast<long long>(k) * p.n + n;
      if (p.w_u8) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            static_cast<const uint8_t*>(p.w) + off);
        v.x = u.x;
        v.y = u.y;
      } else {
        v = *reinterpret_cast<const uint4*>(
            static_cast<const uint16_t*>(p.w) + off);
      }
    }
    st.b[i] = v;
  }
}

__device__ __forceinline__ uint32_t decode_pair(const uint16_t* lut,
                                                uint32_t bytes2) {
  return lut[bytes2 & 0xFF] |
         (static_cast<uint32_t>(lut[(bytes2 >> 8) & 0xFF]) << 16);
}

template <bool kXf32>
__device__ __forceinline__ uint4 stage_x(const Params& p, const uint4 (&a)[2]) {
  if (!kXf32 && !p.quant_x) return a[0];
  float f[8];
  if (kXf32) {
    const uint32_t w[8] = {a[0].x, a[0].y, a[0].z, a[0].w,
                           a[1].x, a[1].y, a[1].z, a[1].w};
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __uint_as_float(w[e]);
  } else {
    const uint32_t w[4] = {a[0].x, a[0].y, a[0].z, a[0].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(w[e] << 16);
      f[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
    }
  }
  uint32_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    h[e] = p.quant_x ? slfp::act_bf16_bits(f[e], p.recip, 8, p.nonneg)
                     : slfp::bf16_bits(f[e]);
  return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                    h[4] | (h[5] << 16), h[6] | (h[7] << 16));
}

template <bool kXf32, bool kWnk>
__device__ __forceinline__ void stage(const Params& p, int tid,
                                      const Staged& st, const uint16_t* lut,
                                      __nv_bfloat16* As, __nv_bfloat16* Bs) {
  const int kc = (tid % (kBK / 8)) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = tid / (kBK / 8) + i * (kThreads / (kBK / 8));
    *reinterpret_cast<uint4*>(As + row * kLdA + kc) =
        stage_x<kXf32>(p, st.a[i]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = tid + i * kThreads;
    uint4 v = st.b[i];
    if (p.w_u8) {
      const uint32_t lo = v.x, hi = v.y;
      v.x = decode_pair(lut, lo);
      v.y = decode_pair(lut, lo >> 16);
      v.z = decode_pair(lut, hi);
      v.w = decode_pair(lut, hi >> 16);
    }
    __nv_bfloat16* dst =
        kWnk ? Bs + (chunk / (kBK / 8)) * kLdBnk + (chunk % (kBK / 8)) * 8
             : Bs + (chunk / (kBN / 8)) * kLdBkn + (chunk % (kBN / 8)) * 8;
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

template <bool kXf32, bool kWnk>
__global__ void __launch_bounds__(kThreads) fused_matmul_kernel(Params p) {
  using BLayout =
      typename std::conditional<kWnk, wmma::col_major, wmma::row_major>::type;
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBsElems];
  __shared__ __align__(128) float Cs[kBM * kLdC];
  __shared__ uint16_t lut[256];  // uint8 code -> bf16 bits

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // element offset of the x row behind each of this thread's two chunks,
  // -1 past the last row
  long long a_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m =
        m0 + tid / (kBK / 8) + i * (kThreads / (kBK / 8));
    a_off[i] = m < p.m ? row_offset(p, m) : -1;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (p.w_u8) {
    for (int c = tid; c < 256; c += kThreads)
      lut[c] = slfp::decode_code_bf16(static_cast<uint8_t>(c));
    __syncthreads();
  }

  Staged st;
  fetch<kXf32, kWnk>(p, n0, 0, tid, a_off, st);
  stage<kXf32, kWnk>(p, tid, st, lut, As, Bs);
  __syncthreads();
  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    const bool more = k0 + kBK < p.k;
    if (more) fetch<kXf32, kWnk>(p, n0, k0 + kBK, tid, a_off, st);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * kLdA + kk,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nn = wc * 32 + j * 16;
        if (kWnk)
          wmma::load_matrix_sync(b[j], Bs + nn * kLdBnk + kk, kLdBnk);
        else
          wmma::load_matrix_sync(b[j], Bs + kk * kLdBkn + nn, kLdBkn);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage<kXf32, kWnk>(p, tid, st, lut, As, Bs);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * kLdC + wc * 32 + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();

  // epilogue, in the order of the Pallas body: + b * f32(1/(ka*kw)), then
  // * f32(ka*kw), then ReLU (+0.0, never -0.0), then the cast; each float
  // operation rounded once (no contraction into an FMA) and flushed
#pragma unroll
  for (int i = 0; i < (kBM * kBN / 8) / kThreads; ++i) {
    const int chunk = tid + i * kThreads;
    const int row = chunk / (kBN / 8);
    const int nc = (chunk % (kBN / 8)) * 8;
    const long long m = m0 + row;
    const int n = n0 + nc;
    if (m >= p.m || n >= p.n) continue;
    const float4 c0 = *reinterpret_cast<const float4*>(Cs + row * kLdC + nc);
    const float4 c1 =
        *reinterpret_cast<const float4*>(Cs + row * kLdC + nc + 4);
    float v[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float y = slfp::ftz(v[e]);
      if (p.bias != nullptr)
        y = slfp::ftz(__fadd_rn(
            y, slfp::ftz(__fmul_rn(slfp::ftz(__ldg(p.bias + n + e)),
                                   p.c_bias))));
      y = slfp::ftz(__fmul_rn(y, p.c_scale));
      if (p.relu) y = y > 0.f ? y : 0.f;
      v[e] = y;
    }
    const long long off = m * p.n + n;
    if (p.out_f32) {
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(p.out) + off);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = slfp::bf16_bits(v[e]);
      *reinterpret_cast<uint4*>(static_cast<uint16_t*>(p.out) + off) =
          make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                     h[4] | (h[5] << 16), h[6] | (h[7] << 16));
    }
  }
}

template <bool kXf32, bool kWnk>
void launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.m + kBM - 1) / kBM),
                  static_cast<unsigned>((p.n + kBN - 1) / kBN));
  fused_matmul_kernel<kXf32, kWnk><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

extern "C" int slfp_fused_matmul(
    const void* x, int x_f32, long long hw, int wdim, long long sb,
    long long sh, long long sw, const void* w, int w_u8, int w_nk,
    const void* bias, void* out, int out_f32, long long m, int k, int n,
    int quant_x, float recip, int nonneg, float c_bias, float c_scale,
    int relu, void* stream) {
  Params p;
  p.x = x;
  p.w = w;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.m = m;
  p.k = k;
  p.n = n;
  p.hw = hw;
  p.wdim = wdim;
  p.sb = sb;
  p.sh = sh;
  p.sw = sw;
  p.recip = recip;
  p.c_bias = c_bias;
  p.c_scale = c_scale;
  p.w_u8 = w_u8 != 0;
  p.quant_x = quant_x != 0;
  p.nonneg = nonneg != 0;
  p.relu = relu != 0;
  p.out_f32 = out_f32 != 0;
  if (m > 0 && n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_f32) {
      if (w_nk) launch<true, true>(p, s); else launch<true, false>(p, s);
    } else {
      if (w_nk) launch<false, true>(p, s); else launch<false, false>(p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
