// K4: SLFP act-quantize -> weight decode -> bf16 GEMM -> scaled epilogue,
// the module path's 1x1 convolutions and dense layers on packed weights.
//
// Replaces the Pallas kernel cnns_slfp_quantization_tpu/kernels/
// fused_matmul.py::fused_quant_matmul (:76, body _matmul_kernel :55):
//   out = act((Q_a(x/ka) @ decode(W) [+ b * f32(1/(ka*kw))]) * f32(ka*kw))
//   x   the rows of a [B, H, W, K] view with any row strides and contiguous
//       channels: a dense [M, K] matrix, an NHWC activation or its stride-2
//       view.  f32 or bf16; quantized on the way to the tensor cores
//       (signed or nonneg form of slfp::act_bf16_bits), or only rounded to
//       bf16;
//   W   [K, N] uint8 SLFP<3,4> codes (decoded in the kernel) or bf16
//       values, stored [K, N] or [N, K]: the [N, K] form is the OIHW /
//       [out, in] storage of the port's layers, read as it is;
//   out [M, N] f32 or bf16, contiguous.
//
// Bound on the H100: bytes, in both regimes of the module path.  The 1x1
// convs (K = 16..2048, N = 16..2048, up to 200,704 rows at batch 64) do at
// most 2KN / (2K + 2N) flops per byte moved, about the ~295 flops per byte
// where the bf16 tensor cores would bind only at the deepest layers;
// AlexNet's FC layers at batch 64 read 58.6 MB of uint8 codes for 128
// flops per code.
//
// Design: the shared Hopper mainloop (gemm_sm90.cuh).  x goes by TMA where
// its rows lie at one pitch and by 16-byte cp.async where they do not (the
// stride-2 views, whose row offsets b*sb + i*sh + j*sw no box describes);
// the quantize is applied to the wgmma A fragments in registers.  Codes go
// by TMA (or 8-byte cp.async where a row is not a multiple of 16 bytes) and
// are decoded through a 256-entry shared-memory table into the B tile in
// the layout TMA gives bf16 weights.  At small M (AlexNet's FC layers, the
// ResNet-50 module path's FC) the plan splits K across blocks so that the
// codes stream from every SM; the splits' f32 sums are added in split order
// by a second pass, which runs the epilogue.  The product is not
// transposed for small M: M = 64 fills one wgmma row tile exactly.  The
// epilogue runs on f32 sums staged 32 columns at a time, 8 consecutive
// channels of a row per thread, in the order of the Pallas body: + b *
// c_bias, * c_scale, ReLU to +0.0, each float op rounded once and flushed
// (no contraction into an FMA), 16-byte stores.
#include "gemm_sm90.cuh"

namespace {

struct FusedEpi {
  const float* bias;
  void* out;
  int n;
  float c_bias, c_scale;
  bool relu, out_f32;

  struct Pre {};   // nothing to read ahead

  __device__ __forceinline__ Pre prefetch(long long, int) const {
    return Pre();
  }

  __device__ __forceinline__ void operator()(long long m, int n0,
                                             const float (&cv)[8],
                                             const Pre&) const {
    float bv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (bias != nullptr) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(bias + n0));
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + n0 + 4));
      const float u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) bv[e] = u[e];
    }
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float y = slfp::ftz(cv[e]);
      if (bias != nullptr)
        y = slfp::ftz(__fadd_rn(
            y, slfp::ftz(__fmul_rn(slfp::ftz(bv[e]), c_bias))));
      y = slfp::ftz(__fmul_rn(y, c_scale));
      if (relu) y = y > 0.f ? y : 0.f;
      v[e] = y;
    }
    const long long off = m * n + n0;
    if (out_f32) {
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = slfp::bf16_bits(v[e]);
      *reinterpret_cast<uint4*>(static_cast<uint16_t*>(out) + off) =
          make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                     h[4] | (h[5] << 16), h[6] | (h[7] << 16));
    }
  }
};

}  // namespace

// a_pitch: the element pitch of x's rows where they lie at one pitch (the
// view flattens to [M, K]), else 0.  The tile plan (bm, bn, split, stages,
// smem) is kernels/_gemm_plan.py's; ws is the f32 workspace [split, M, N]
// when split > 1.
extern "C" int slfp_fused_matmul(
    const void* x, int x_f32, long long hw, int wdim, long long sb,
    long long sh, long long sw, long long a_pitch, const void* w, int w_u8,
    int w_nk, const void* bias, void* out, int out_f32, long long m, int k,
    int n, int quant_x, float recip, int nonneg, float c_bias, float c_scale,
    int relu, int bm, int bn, int split, int stages, int smem, void* ws,
    void* stream) {
  gemm::Problem p = {};
  p.m = m;
  p.k = k;
  p.n = n;
  p.x = x;
  p.hw = hw;
  p.wdim = wdim;
  p.sb = sb;
  p.sh = sh;
  p.sw = sw;
  p.a_pitch = a_pitch;
  p.quant = quant_x != 0;
  p.nonneg = nonneg != 0;
  p.recip = recip;
  p.w = w;
  p.w_u8 = w_u8 != 0;
  p.w_nk = w_nk != 0;
  p.split = split;
  p.stages = stages;
  p.ws = static_cast<float*>(ws);
  FusedEpi epi;
  epi.bias = static_cast<const float*>(bias);
  epi.out = out;
  epi.n = n;
  epi.c_bias = c_bias;
  epi.c_scale = c_scale;
  epi.relu = relu != 0;
  epi.out_f32 = out_f32 != 0;
  return static_cast<int>(gemm::run<true>(p, x_f32 != 0, epi, bm, bn, smem,
                                          static_cast<cudaStream_t>(stream)));
}
