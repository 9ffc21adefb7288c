// K2: fused quantize -> bf16 GEMM -> epilogue for the 1x1 convolutions.
//
// Replaces the Pallas kernel cnns_slfp_quantization_tpu/kernels/qmm.py::
// qmm_fused (:93):
//   out = epilogue(Q_a(x * recip_in) @ W)
//   x   [M, K] bf16, raw (quant_in: quantized while staged, as the
//       non-negative output of a ReLU) or quantized;
//   W   [K, N] bf16 values, or uint8 SLFP<3,4> codes decoded while staged;
//   epilogue per element: fma(acc, s[n], t[n]) (+ residual[m, n]), ReLU,
//   then bf16 out, f32 out, or the next layer's quantize (nonneg = relu).
//
// Bound on the H100: at ResNet-50's shapes (M = B*HW up to 200704, K and N
// 64..2048) the arithmetic intensity is K*N*2 / (2K + 2N + ...) flops per
// byte: 32 to 600, so the small layers are memory-bound and the wide ones
// compute-bound against 989 TFLOP/s of bf16 tensor cores.
//
// Design (right and simple first): 64x64 output tiles per 128-thread block,
// four warps each owning a 32x32 quadrant as 2x2 nvcuda::wmma 16x16x16
// bf16 -> f32 fragments, K walked in steps of 32.  The next K step's tiles
// are fetched into registers (16-byte vector loads) while the tensor cores
// work on the current one; the quantize prologue and the uint8 decode run
// as those registers are written to shared memory, so neither costs a pass
// over device memory.  The accumulators go through shared memory once so
// that each thread finishes 8 consecutive channels of a row with vector
// loads of the residual and vector stores of the output.  Ragged M, K and N
// (K, N multiples of 8) are masked with zero fill; nothing is padded in
// device memory.  wgmma, TMA and deeper pipelines are later work.
#include <mma.h>

#include "slfp.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 128;
constexpr int kLdA = kBK + 8;  // padded rows: fewer bank conflicts, and a
constexpr int kLdB = kBN + 8;  // multiple of 8 elements as wmma requires
constexpr int kLdC = kBN + 4;

struct Params {
  const uint16_t* x;
  const void* w;
  const float* s;
  const float* t;
  const uint16_t* res;
  void* out;
  long long m;
  int k, n;
  float recip_in, recip_out;
  bool w_u8, quant_in, relu, quant_out, out_f32;
};

struct Staged {
  uint4 a[2];  // 2 chunks of 8 bf16 of the x tile
  uint4 b[2];  // 2 chunks of 8 bf16 (or 8 uint8 in .x/.y) of the W tile
};

__device__ __forceinline__ void fetch(const Params& p, long long m0, int n0,
                                      int k0, int tid, Staged& st) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = tid + i * kThreads;
    const int row = chunk / (kBK / 8);
    const int kc = (chunk % (kBK / 8)) * 8;
    const long long m = m0 + row;
    const int k = k0 + kc;
    st.a[i] = (m < p.m && k < p.k)
        ? *reinterpret_cast<const uint4*>(p.x + m * p.k + k)
        : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = tid + i * kThreads;
    const int row = chunk / (kBN / 8);
    const int nc = (chunk % (kBN / 8)) * 8;
    const int k = k0 + row;
    const int n = n0 + nc;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < p.k && n < p.n) {
      const long long off = static_cast<long long>(k) * p.n + n;
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

// the prologue's input is always a ReLU output, hence nonneg = true
__device__ __forceinline__ uint32_t quant_pair(uint32_t w, float recip) {
  const uint32_t lo = slfp::act_bf16_bits(slfp::bf16_to_float(w & 0xFFFF),
                                          recip, 8, true);
  const uint32_t hi = slfp::act_bf16_bits(slfp::bf16_to_float(w >> 16),
                                          recip, 8, true);
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t decode_pair(uint32_t bytes2) {
  return slfp::decode_code_bf16(bytes2 & 0xFF) |
         (static_cast<uint32_t>(slfp::decode_code_bf16((bytes2 >> 8) & 0xFF))
          << 16);
}

__device__ __forceinline__ void stage(const Params& p, int tid,
                                      const Staged& st, __nv_bfloat16* As,
                                      __nv_bfloat16* Bs) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = tid + i * kThreads;
    const int row = chunk / (kBK / 8);
    const int kc = (chunk % (kBK / 8)) * 8;
    uint4 v = st.a[i];
    if (p.quant_in) {
      v.x = quant_pair(v.x, p.recip_in);
      v.y = quant_pair(v.y, p.recip_in);
      v.z = quant_pair(v.z, p.recip_in);
      v.w = quant_pair(v.w, p.recip_in);
    }
    *reinterpret_cast<uint4*>(As + row * kLdA + kc) = v;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = tid + i * kThreads;
    const int row = chunk / (kBN / 8);
    const int nc = (chunk % (kBN / 8)) * 8;
    uint4 v = st.b[i];
    if (p.w_u8) {
      const uint32_t lo = v.x, hi = v.y;
      v.x = decode_pair(lo);
      v.y = decode_pair(lo >> 16);
      v.z = decode_pair(hi);
      v.w = decode_pair(hi >> 16);
    }
    *reinterpret_cast<uint4*>(Bs + row * kLdB + nc) = v;
  }
}

__global__ void __launch_bounds__(kThreads) qmm_kernel(Params p) {
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBK * kLdB];
  __shared__ __align__(128) float Cs[kBM * kLdC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Staged st;
  fetch(p, m0, n0, 0, tid, st);
  stage(p, tid, st, As, Bs);
  __syncthreads();
  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    const bool more = k0 + kBK < p.k;
    if (more) fetch(p, m0, n0, k0 + kBK, tid, st);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * kLdA + kk,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdB + wc * 32 + j * 16,
                               kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage(p, tid, st, As, Bs);
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
    const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const long long off = m * p.n + n;
    float rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (p.res != nullptr) {
      const uint4 u = *reinterpret_cast<const uint4*>(p.res + off);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rv[2 * k] = __uint_as_float(w[k] << 16);
        rv[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
      }
    }
    float v[8];
    uint16_t h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = slfp::epilogue_value(cv[k], __ldg(p.s + n + k),
                                  __ldg(p.t + n + k), p.res != nullptr, rv[k],
                                  p.relu);
      h[k] = p.quant_out ? slfp::act_bf16_bits(v[k], p.recip_out, 8, p.relu)
                         : slfp::bf16_bits(v[k]);
      if (p.out_f32 && p.quant_out) v[k] = slfp::bf16_to_float(h[k]);
    }
    if (p.out_f32) {
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(p.out) + off);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint4 u;
      u.x = h[0] | (static_cast<uint32_t>(h[1]) << 16);
      u.y = h[2] | (static_cast<uint32_t>(h[3]) << 16);
      u.z = h[4] | (static_cast<uint32_t>(h[5]) << 16);
      u.w = h[6] | (static_cast<uint32_t>(h[7]) << 16);
      *reinterpret_cast<uint4*>(static_cast<uint16_t*>(p.out) + off) = u;
    }
  }
}

}  // namespace

extern "C" int slfp_qmm(const void* x, const void* w, int w_u8, const void* s,
                        const void* t, const void* residual, void* out,
                        int out_f32, long long m, int k, int n, int quant_in,
                        float recip_in, int relu, int quant_out,
                        float recip_out, void* stream) {
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.w = w;
  p.s = static_cast<const float*>(s);
  p.t = static_cast<const float*>(t);
  p.res = static_cast<const uint16_t*>(residual);
  p.out = out;
  p.m = m;
  p.k = k;
  p.n = n;
  p.recip_in = recip_in;
  p.recip_out = recip_out;
  p.w_u8 = w_u8 != 0;
  p.quant_in = quant_in != 0;
  p.relu = relu != 0;
  p.quant_out = quant_out != 0;
  p.out_f32 = out_f32 != 0;
  if (m > 0 && n > 0) {
    const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                    static_cast<unsigned>((n + kBN - 1) / kBN));
    qmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
