// K2: fused quantize -> bf16 GEMM -> epilogue for the 1x1 convolutions.
//
// Replaces the Pallas kernel cnns_slfp_quantization_tpu/kernels/qmm.py::
// qmm_fused (:93):
//   out = epilogue(Q_a(x * recip_in) @ W)
//   x   [M, K] bf16, raw (quant_in: quantized on the way to the tensor
//       cores, as the non-negative output of a ReLU) or quantized;
//   W   [K, N] bf16 values, or uint8 SLFP<3,4> codes decoded in the kernel,
//       stored [K, N] or [N, K];
//   epilogue per element: fma(acc, s[n], t[n]) (+ residual[m, n]), ReLU,
//   then bf16 out, f32 out, or the next layer's quantize (nonneg = relu).
//
// Bound on the H100: at ResNet-50's shapes at batch 64 (M = 3136..200704,
// K and N 64..2048) bytes bind all but the deepest layers, 2KN / (2K + 2N
// + ...) flops per byte against the ~295 where the 989 TFLOP/s of bf16
// tensor cores would; those (M = 3136..12544, K or N 1024..2048) are near
// the ridge.
//
// Design: the shared Hopper mainloop (gemm_sm90.cuh): wgmma with A from
// registers, x by TMA into a ring of >= 3 stages fed by a producer warp,
// the quantize prologue applied to the A fragments in registers, codes
// decoded through a 256-entry shared-memory table into the B tile, column
// tiles as wide as N up to 128 (x read and quantized once per tile row;
// 64 x 64 tiles where a residual is read), split-K where the row tiles
// leave the SMs idle.  The epilogue runs on the f32 sums staged 32 columns
// at a time: each thread finishes 8 consecutive channels of a row with
// 16-byte loads of the residual (the whole tile's, issued before the
// mainloop) and 16-byte stores, in the order of the wmma kernel it replaces
// (slfp::epilogue_value, then the quantize).  Weights come [K, N] or as
// the transpose of [N, K] storage (the executor's, read K-major).
// Ragged M, K and N (K, N multiples of 8) are zero-filled by TMA.
#include "gemm_sm90.cuh"

namespace {

struct QmmEpi {
  const float* s;
  const float* t;
  const uint16_t* res;
  void* out;
  int n;
  float recip_out;
  bool relu, quant_out, out_f32;

  struct Pre {
    uint4 res;   // 8 bf16 of the residual
  };

  __device__ __forceinline__ Pre prefetch(long long m, int n0) const {
    Pre p = {make_uint4(0, 0, 0, 0)};
    if (res != nullptr)
      p.res = *reinterpret_cast<const uint4*>(res + m * n + n0);
    return p;
  }

  __device__ __forceinline__ void operator()(long long m, int n0,
                                             const float (&cv)[8],
                                             const Pre& pre) const {
    const long long off = m * n + n0;
    const uint32_t w[4] = {pre.res.x, pre.res.y, pre.res.z, pre.res.w};
    float rv[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rv[2 * k] = __uint_as_float(w[k] << 16);
      rv[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
    const float4 sa = __ldg(reinterpret_cast<const float4*>(s + n0));
    const float4 sb = __ldg(reinterpret_cast<const float4*>(s + n0 + 4));
    const float4 ta = __ldg(reinterpret_cast<const float4*>(t + n0));
    const float4 tb = __ldg(reinterpret_cast<const float4*>(t + n0 + 4));
    const float sv[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    const float tv[8] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
    float v[8];
    uint16_t h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = slfp::epilogue_value(cv[k], sv[k], tv[k], res != nullptr, rv[k],
                                  relu);
      h[k] = quant_out ? slfp::act_bf16_bits(v[k], recip_out, 8, relu)
                       : slfp::bf16_bits(v[k]);
      if (out_f32 && quant_out) v[k] = slfp::bf16_to_float(h[k]);
    }
    if (out_f32) {
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint4 u;
      u.x = h[0] | (static_cast<uint32_t>(h[1]) << 16);
      u.y = h[2] | (static_cast<uint32_t>(h[3]) << 16);
      u.z = h[4] | (static_cast<uint32_t>(h[5]) << 16);
      u.w = h[6] | (static_cast<uint32_t>(h[7]) << 16);
      *reinterpret_cast<uint4*>(static_cast<uint16_t*>(out) + off) = u;
    }
  }
};

}  // namespace

// The tile plan (bm, bn, split, stages, smem) is kernels/_gemm_plan.py's;
// ws is the f32 workspace [split, M, N] when split > 1.
extern "C" int slfp_qmm(const void* x, const void* w, int w_u8, int w_nk,
                        const void* s,
                        const void* t, const void* residual, void* out,
                        int out_f32, long long m, int k, int n, int quant_in,
                        float recip_in, int relu, int quant_out,
                        float recip_out, int bm, int bn, int split,
                        int stages, int smem, void* ws, void* stream) {
  gemm::Problem p = {};
  p.m = m;
  p.k = k;
  p.n = n;
  p.x = x;
  p.hw = 1;
  p.wdim = 1;
  p.sb = p.sh = p.sw = k;
  p.a_pitch = k;
  p.quant = quant_in != 0;
  p.nonneg = true;   // the prologue's input is always a ReLU output
  p.recip = recip_in;
  p.w = w;
  p.w_u8 = w_u8 != 0;
  p.w_nk = w_nk != 0;
  p.split = split;
  p.stages = stages;
  p.ws = static_cast<float*>(ws);
  QmmEpi epi;
  epi.s = static_cast<const float*>(s);
  epi.t = static_cast<const float*>(t);
  epi.res = static_cast<const uint16_t*>(residual);
  epi.out = out;
  epi.n = n;
  epi.recip_out = recip_out;
  epi.relu = relu != 0;
  epi.quant_out = quant_out != 0;
  epi.out_f32 = out_f32 != 0;
  return static_cast<int>(gemm::run<false>(p, false, epi, bm, bn, smem,
                                           static_cast<cudaStream_t>(stream)));
}
