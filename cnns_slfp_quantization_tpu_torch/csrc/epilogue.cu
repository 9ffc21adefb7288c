// K3: per-channel affine epilogue after a cuDNN convolution or plain matmul.
//
// Replaces the Pallas kernel cnns_slfp_quantization_tpu/kernels/epilogue.py::
// dual_epilogue (:45) and generalises it to the single-output epilogue the
// JAX executor leaves to XLA (models/resnet50_fused.py::xla_post, :191):
//   v   = relu?(fma(y, s[c], t[c]) (+ identity))
//   raw = bf16(v)                                   (emit_raw)
//   q   = act_bf16_bits(raw, recip, 8, relu)        (emit_raw and emit_q:
//                                                    dual, from the bf16 raw)
//   q   = act_bf16_bits(v,   recip, 8, relu)        (emit_q alone: from f32)
// y is f32 [rows, C]; identity bf16 [rows, C]; s, t f32 [C].
//
// Bound on the H100: memory.  Per element it reads 4 bytes of y (+2 of
// identity) and writes 2 or 4, with some 30 integer and float operations:
// far below the ~300 operations per byte where compute would bound it.  So
// the design moves 16-byte vectors: 8 consecutive channels of one row per
// thread step (C is a multiple of 8 on that path), with s/t read as vectors
// from L1; a scalar loop covers other shapes.
#include "slfp.cuh"

namespace {

struct Args {
  const float* y;
  const uint16_t* id;
  const float* s;
  const float* t;
  uint16_t* raw;
  uint16_t* q;
  long long n;  // rows * C
  int c;
  float recip;
  bool relu;
  bool vec;
};

__device__ __forceinline__ void one(const Args& a, float y, float s, float t,
                                    float r, uint16_t& raw, uint16_t& q) {
  const float v = slfp::epilogue_value(y, s, t, a.id != nullptr, r, a.relu);
  raw = slfp::bf16_bits(v);
  if (a.q != nullptr) {
    const float src = a.raw != nullptr ? slfp::bf16_to_float(raw) : v;
    q = slfp::act_bf16_bits(src, a.recip, 8, a.relu);
  }
}

__device__ __forceinline__ uint4 pack8(const uint16_t (&h)[8]) {
  uint4 u;
  u.x = h[0] | (static_cast<uint32_t>(h[1]) << 16);
  u.y = h[2] | (static_cast<uint32_t>(h[3]) << 16);
  u.z = h[4] | (static_cast<uint32_t>(h[5]) << 16);
  u.w = h[6] | (static_cast<uint32_t>(h[7]) << 16);
  return u;
}

__global__ void epilogue_kernel(Args a) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (a.vec) {
    const long long nv = a.n / 8;
    for (long long i = tid; i < nv; i += stride) {
      const long long e = i * 8;
      const int c = static_cast<int>(e % a.c);
      const float4* yp = reinterpret_cast<const float4*>(a.y + e);
      const float4 y0 = yp[0], y1 = yp[1];
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      const float4* sp = reinterpret_cast<const float4*>(a.s + c);
      const float4* tp = reinterpret_cast<const float4*>(a.t + c);
      const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
      const float4 t0 = __ldg(tp), t1 = __ldg(tp + 1);
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      float rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (a.id != nullptr) {
        const uint4 u = *reinterpret_cast<const uint4*>(a.id + e);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rv[2 * k] = __uint_as_float(w[k] << 16);
          rv[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
        }
      }
      uint16_t raw[8], q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) one(a, yv[k], sv[k], tv[k], rv[k], raw[k], q[k]);
      if (a.raw != nullptr) *reinterpret_cast<uint4*>(a.raw + e) = pack8(raw);
      if (a.q != nullptr) *reinterpret_cast<uint4*>(a.q + e) = pack8(q);
    }
    done = nv * 8;
  }
  for (long long e = done + tid; e < a.n; e += stride) {
    const int c = static_cast<int>(e % a.c);
    const float r = a.id != nullptr ? slfp::bf16_to_float(a.id[e]) : 0.f;
    uint16_t raw, q;
    one(a, a.y[e], a.s[c], a.t[c], r, raw, q);
    if (a.raw != nullptr) a.raw[e] = raw;
    if (a.q != nullptr) a.q[e] = q;
  }
}

}  // namespace

extern "C" int slfp_epilogue(const void* y, const void* identity,
                             const void* s, const void* t, void* raw, void* q,
                             long long rows, int c, float recip, int relu,
                             int vec, void* stream) {
  Args a;
  a.y = static_cast<const float*>(y);
  a.id = static_cast<const uint16_t*>(identity);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.raw = static_cast<uint16_t*>(raw);
  a.q = static_cast<uint16_t*>(q);
  a.n = rows * static_cast<long long>(c);
  a.c = c;
  a.recip = recip;
  a.relu = relu != 0;
  a.vec = vec != 0;
  if (a.n > 0) {
    long long blocks = (a.n / 8 + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    if (blocks < 1) blocks = 1;
    epilogue_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
