// K1: standalone SLFP<3,4> / SFP<3,3> activation quantize pass.
//
// Replaces the Pallas kernel cnns_slfp_quantization_tpu/kernels/quantize.py::
// slfp34_act_quantize (:83) and its production form ops/sfp.py::
// _act_bf16_bits (:361), which the JAX executor runs as
// kernels/qmm.py::quantize_act_pass.  Two forms:
//   slfp_quantize_bf16:    bf16(quantize_act(x * recip, qbit)), qbit 7 or 8,
//                          optional sign handling (nonneg);
//   slfp_quantize_f32form: slfp34_act_bits(x), output in the input's dtype.
//
// Bound on the H100: memory.  About 25 integer operations per element
// against 6 to 8 bytes moved, far below the card's ~300 operations per
// byte, so the time is bytes in + bytes out over 3.35 TB/s.  The design does
// the one thing that matters for that: every thread moves 16-byte vectors
// (8 elements per step, coalesced across the warp) in a grid-stride loop,
// with a scalar loop only for a ragged tail or unaligned pointers.
#include "slfp.cuh"

namespace {

template <bool kBf16>
__device__ __forceinline__ void load8(const void* base, long long i,
                                      float (&v)[8]) {
  if (kBf16) {
    const uint4 u = reinterpret_cast<const uint4*>(base)[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(base) + 2 * i;
    const float4 a = p[0], b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

template <bool kBf16>
__device__ __forceinline__ float load1(const void* base, long long i) {
  if (kBf16) {
    return slfp::bf16_to_float(reinterpret_cast<const uint16_t*>(base)[i]);
  }
  return reinterpret_cast<const float*>(base)[i];
}

__device__ __forceinline__ void store8_bf16(void* base, long long i,
                                            const uint16_t (&q)[8]) {
  uint4 u;
  u.x = q[0] | (static_cast<uint32_t>(q[1]) << 16);
  u.y = q[2] | (static_cast<uint32_t>(q[3]) << 16);
  u.z = q[4] | (static_cast<uint32_t>(q[5]) << 16);
  u.w = q[6] | (static_cast<uint32_t>(q[7]) << 16);
  reinterpret_cast<uint4*>(base)[i] = u;
}

__device__ __forceinline__ void store8_f32(void* base, long long i,
                                           const float (&q)[8]) {
  float4* p = reinterpret_cast<float4*>(base) + 2 * i;
  p[0] = make_float4(q[0], q[1], q[2], q[3]);
  p[1] = make_float4(q[4], q[5], q[6], q[7]);
}

// kF32Form: slfp34_act_bits, output dtype == input dtype; else the bf16
// production form with recip / qbit / nonneg.
template <bool kInBf16, bool kF32Form>
__global__ void quantize_kernel(const void* __restrict__ x,
                                void* __restrict__ out, long long n,
                                float recip, int qbit, bool nonneg,
                                bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 8;
    for (long long i = tid; i < nv; i += stride) {
      float v[8];
      load8<kInBf16>(x, i, v);
      if (kF32Form && !kInBf16) {
        float q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) q[k] = slfp::slfp34_act_f32(v[k]);
        store8_f32(out, i, q);
      } else {
        uint16_t q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          q[k] = kF32Form ? slfp::bf16_bits(slfp::slfp34_act_f32(v[k]))
                          : slfp::act_bf16_bits(v[k], recip, qbit, nonneg);
        }
        store8_bf16(out, i, q);
      }
    }
    done = nv * 8;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float v = load1<kInBf16>(x, i);
    if (kF32Form && !kInBf16) {
      reinterpret_cast<float*>(out)[i] = slfp::slfp34_act_f32(v);
    } else {
      reinterpret_cast<uint16_t*>(out)[i] =
          kF32Form ? slfp::bf16_bits(slfp::slfp34_act_f32(v))
                   : slfp::act_bf16_bits(v, recip, qbit, nonneg != 0);
    }
  }
}

unsigned grid_for(long long n) {
  const long long chunks = (n + 7) / 8;
  long long blocks = (chunks + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

template <bool kF32Form>
void launch(const void* x, int x_bf16, void* out, long long n, float recip,
            int qbit, int nonneg, int vec, cudaStream_t st) {
  const unsigned g = grid_for(n);
  if (x_bf16) {
    quantize_kernel<true, kF32Form><<<g, 256, 0, st>>>(
        x, out, n, recip, qbit, nonneg != 0, vec != 0);
  } else {
    quantize_kernel<false, kF32Form><<<g, 256, 0, st>>>(
        x, out, n, recip, qbit, nonneg != 0, vec != 0);
  }
}

}  // namespace

extern "C" int slfp_quantize_bf16(const void* x, int x_bf16, void* out,
                                  long long n, float recip, int qbit,
                                  int nonneg, int vec, void* stream) {
  if (n > 0) {
    launch<false>(x, x_bf16, out, n, recip, qbit, nonneg, vec,
                  static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slfp_quantize_f32form(const void* x, int x_bf16, void* out,
                                     long long n, int vec, void* stream) {
  if (n > 0) {
    launch<true>(x, x_bf16, out, n, 1.f, 8, 0, vec,
                 static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}
