// K1: standalone SLFP<3,4> / SFP<3,3> activation quantize pass.
//
// Replaces the Pallas kernel cnns_slfp_quantization_tpu/kernels/quantize.py::
// slfp34_act_quantize (:83) and its production form ops/sfp.py::
// _act_bf16_bits (:361), which the JAX executor runs as
// kernels/qmm.py::quantize_act_pass.  Two forms:
//   slfp_quantize:         bf16(quantize_act(x * recip, qbit)), qbit 7 or 8,
//                          optional sign handling (nonneg), written as bf16
//                          or as the float32 that holds the same bf16 value
//                          (its exact widening) where cuDNN or a plain
//                          matmul reads it next;
//   slfp_quantize_f32form: slfp34_act_bits(x), output in the input's dtype.
//
// Bound on the H100: memory.  About 20 integer operations per element
// against 6 to 8 bytes moved, far below the card's ~300 operations per
// byte, so the time is bytes in + bytes out over 3.35 TB/s.  The design
// keeps the loads in flight and the instructions per element few:
//   - Compile-time forms: qbit, nonneg, input and output type and the
//     route are template parameters (32 small kernels), so the per-element
//     body holds no flag.
//   - The FTZ route computes x * recip as mul.rn.ftz, which flushes a
//     subnormal x and a subnormal product as the exact route's explicit
//     selects do; it is exact whenever recip is not subnormal, which the
//     wrapper checks on the host (kernels/_build.py::normal_scalar).
//   - Every thread moves vectors of 4 elements (8 or 16 bytes), four of
//     them in flight a step.  Consecutive threads take consecutive
//     vectors, so each load and store of a warp covers one contiguous span
//     and writes every 32-byte sector whole: a first design's 8 elements a
//     thread (two 16-byte float32 stores, 32 bytes apart across the warp)
//     wrote half sectors and ran the float32 output at 57% of the memory
//     rate.  A grid sized from occupancy walks the tensor; a scalar loop
//     takes a ragged tail or unaligned pointers.
#include "slfp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // 4-element vectors in flight per thread

// 4 consecutive elements as loaded: 8 bytes of bf16 or 16 of float32
template <bool kBf16>
struct In4;
template <>
struct In4<true> {
  uint2 u;
};
template <>
struct In4<false> {
  float4 f;
};

template <bool kBf16>
__device__ __forceinline__ In4<kBf16> load4(const void* base, long long i) {
  In4<kBf16> r;
  if constexpr (kBf16) {
    r.u = __ldg(reinterpret_cast<const uint2*>(base) + i);
  } else {
    r.f = __ldg(reinterpret_cast<const float4*>(base) + i);
  }
  return r;
}

template <bool kBf16>
__device__ __forceinline__ void widen4(const In4<kBf16>& r, float (&v)[4]) {
  if constexpr (kBf16) {
    v[0] = __uint_as_float(r.u.x << 16);
    v[1] = __uint_as_float(r.u.x & 0xFFFF0000u);
    v[2] = __uint_as_float(r.u.y << 16);
    v[3] = __uint_as_float(r.u.y & 0xFFFF0000u);
  } else {
    v[0] = r.f.x; v[1] = r.f.y; v[2] = r.f.z; v[3] = r.f.w;
  }
}

template <int kQbit, bool kNonneg, bool kFtz>
__device__ __forceinline__ uint16_t quant1(float x, float recip) {
  return slfp::act_bf16_bits_scaled(slfp::scaled<kFtz>(x, recip), kQbit,
                                    kNonneg);
}

// 4 outputs as one 8-byte (bf16) or 16-byte (float32) store: a warp's
// store covers one contiguous span, every 32-byte sector written whole
template <bool kOutF32>
__device__ __forceinline__ void store4(void* base, long long i,
                                       const uint16_t (&q)[4]) {
  if constexpr (kOutF32) {
    reinterpret_cast<float4*>(base)[i] =
        make_float4(slfp::bf16_to_float(q[0]), slfp::bf16_to_float(q[1]),
                    slfp::bf16_to_float(q[2]), slfp::bf16_to_float(q[3]));
  } else {
    reinterpret_cast<uint2*>(base)[i] =
        make_uint2(q[0] | (static_cast<uint32_t>(q[1]) << 16),
                   q[2] | (static_cast<uint32_t>(q[3]) << 16));
  }
}

template <int kQbit, bool kNonneg, bool kInBf16, bool kOutF32, bool kFtz>
__device__ __forceinline__ void quant4(const In4<kInBf16>& r, void* out,
                                       long long i, float recip) {
  float v[4];
  widen4<kInBf16>(r, v);
  uint16_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = quant1<kQbit, kNonneg, kFtz>(v[k], recip);
  store4<kOutF32>(out, i, q);
}

// nvec: the 4-element vectors (0 where a pointer is not 16-byte aligned);
// the elements past them go one at a time
template <int kQbit, bool kNonneg, bool kInBf16, bool kOutF32, bool kFtz>
__global__ void __launch_bounds__(kThreads) quantize_kernel(
    const void* __restrict__ x, void* __restrict__ out, long long n,
    long long nvec, float recip) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long i = tid;
  // kUnroll vectors a step, all loads in flight before the first is used;
  // a warp's load of one of them is one contiguous span
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    In4<kInBf16> r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = load4<kInBf16>(x, i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      quant4<kQbit, kNonneg, kInBf16, kOutF32, kFtz>(r[u], out,
                                                     i + u * stride, recip);
    }
  }
  for (; i < nvec; i += stride) {
    quant4<kQbit, kNonneg, kInBf16, kOutF32, kFtz>(load4<kInBf16>(x, i), out,
                                                   i, recip);
  }
  for (long long e = nvec * 4 + tid; e < n; e += stride) {
    const float v =
        kInBf16 ? slfp::bf16_to_float(static_cast<const uint16_t*>(x)[e])
                : static_cast<const float*>(x)[e];
    const uint16_t q = quant1<kQbit, kNonneg, kFtz>(v, recip);
    if (kOutF32) {
      static_cast<float*>(out)[e] = slfp::bf16_to_float(q);
    } else {
      static_cast<uint16_t*>(out)[e] = q;
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int kQbit, bool kNonneg, bool kInBf16, bool kOutF32, bool kFtz>
cudaError_t launch(const void* x, void* out, long long n, long long nvec,
                   float recip, cudaStream_t st) {
  auto kernel = quantize_kernel<kQbit, kNonneg, kInBf16, kOutF32, kFtz>;
  static int per_sm = 0;                         // resident blocks per SM
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    if (per_sm < 1) per_sm = 1;
  }
  // kUnroll vectors (or, unaligned, elements) per thread a step; no more
  // blocks than fill the SMs once
  const long long work = nvec > 0 ? nvec : n;
  long long blocks = (work + kUnroll * kThreads - 1) / (kUnroll * kThreads);
  const long long full = static_cast<long long>(per_sm) * sm_count();
  if (blocks > full) blocks = full;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(x, out, n, nvec,
                                                            recip);
  return cudaGetLastError();
}

// the 32 forms: qbit, nonneg, input type, output type, route
template <int kQbit, bool kNonneg, bool kInBf16>
cudaError_t pick_out(int out_f32, int ftz, const void* x, void* out,
                     long long n, long long nvec, float recip,
                     cudaStream_t st) {
  if (out_f32) {
    return ftz ? launch<kQbit, kNonneg, kInBf16, true, true>(x, out, n, nvec,
                                                            recip, st)
               : launch<kQbit, kNonneg, kInBf16, true, false>(x, out, n, nvec,
                                                             recip, st);
  }
  return ftz ? launch<kQbit, kNonneg, kInBf16, false, true>(x, out, n, nvec,
                                                           recip, st)
             : launch<kQbit, kNonneg, kInBf16, false, false>(x, out, n, nvec,
                                                            recip, st);
}

template <int kQbit>
cudaError_t pick(int nonneg, int x_bf16, int out_f32, int ftz, const void* x,
                 void* out, long long n, long long nvec, float recip,
                 cudaStream_t st) {
  if (nonneg) {
    return x_bf16 ? pick_out<kQbit, true, true>(out_f32, ftz, x, out, n,
                                                nvec, recip, st)
                  : pick_out<kQbit, true, false>(out_f32, ftz, x, out, n,
                                                 nvec, recip, st);
  }
  return x_bf16 ? pick_out<kQbit, false, true>(out_f32, ftz, x, out, n, nvec,
                                               recip, st)
                : pick_out<kQbit, false, false>(out_f32, ftz, x, out, n,
                                                nvec, recip, st);
}

// the Pallas kernel's own form: slfp34_act_bits, output dtype == input
// dtype
template <bool kInBf16>
__global__ void f32form_kernel(const void* __restrict__ x,
                               void* __restrict__ out, long long n, bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nv = vec ? n / 4 : 0;
  for (long long i = tid; i < nv; i += stride) {
    float v[4];
    widen4<kInBf16>(load4<kInBf16>(x, i), v);
    if constexpr (kInBf16) {
      uint16_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[k] = slfp::bf16_bits(slfp::slfp34_act_f32(v[k]));
      store4<false>(out, i, q);
    } else {
      reinterpret_cast<float4*>(out)[i] = make_float4(
          slfp::slfp34_act_f32(v[0]), slfp::slfp34_act_f32(v[1]),
          slfp::slfp34_act_f32(v[2]), slfp::slfp34_act_f32(v[3]));
    }
  }
  for (long long i = nv * 4 + tid; i < n; i += stride) {
    if (kInBf16) {
      const float v = slfp::bf16_to_float(static_cast<const uint16_t*>(x)[i]);
      static_cast<uint16_t*>(out)[i] =
          slfp::bf16_bits(slfp::slfp34_act_f32(v));
    } else {
      static_cast<float*>(out)[i] =
          slfp::slfp34_act_f32(static_cast<const float*>(x)[i]);
    }
  }
}

}  // namespace

// out_f32: the output as float32 holding the bf16 value; ftz: the FTZ route
// (the caller has checked that recip is not subnormal); vec: both pointers
// 16-byte aligned
extern "C" int slfp_quantize(const void* x, int x_bf16, void* out,
                             int out_f32, long long n, float recip, int qbit,
                             int nonneg, int ftz, int vec, void* stream) {
  if (n <= 0) return 0;
  if (qbit != 7 && qbit != 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long nvec = vec ? n / 4 : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      qbit == 8 ? pick<8>(nonneg, x_bf16, out_f32, ftz, x, out, n, nvec,
                          recip, st)
                : pick<7>(nonneg, x_bf16, out_f32, ftz, x, out, n, nvec,
                          recip, st);
  return static_cast<int>(err);
}

extern "C" int slfp_quantize_f32form(const void* x, int x_bf16, void* out,
                                     long long n, int vec, void* stream) {
  if (n > 0) {
    const long long chunks = (n + 3) / 4;
    long long blocks = (chunks + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    if (blocks < 1) blocks = 1;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_bf16) {
      f32form_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          x, out, n, vec != 0);
    } else {
      f32form_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                              st>>>(x, out, n, vec != 0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
