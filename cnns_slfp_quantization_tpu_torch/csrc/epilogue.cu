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
// y is f32 [rows, C]; identity bf16 [rows, C]; s, t f32 [C].  q is written
// as bf16, or as the float32 that holds the same bf16 value (its exact
// widening) where cuDNN or a plain matmul reads it next, so that no copy
// widens it in between.
//
// Bound on the H100: memory.  Per element it reads 4 bytes of y (+2 of
// identity) and writes 2 or 4 per output, with some 20 integer and float
// operations: far below the ~300 operations per byte where compute would
// bound it.  The design keeps the instruction count per element low enough
// that the loads stay in flight:
//   - Channel slabs.  A thread owns one group of 4 channels, holds their
//     s and t in registers and walks rows, 4 rows' loads in flight before
//     the first is used; no modulo, no reload of s and t.  Rows are C
//     apart, so the threads of a block cover whole rows and each load and
//     store of a warp is one contiguous span (16 bytes of y a thread, 8 of
//     each bf16 tensor, 16 of an f32 q), every 32-byte sector written
//     whole: a first design's 8 channels a thread wrote an f32 q as two
//     16-byte stores 32 bytes apart across the warp, half sectors, at 60%
//     of the memory rate.
//   - Compile-time serving forms.  identity, ReLU, raw, q (none, bf16,
//     f32) and the route are template parameters; the host instantiates
//     the forms the executors serve and picks one.  Any other form, a C
//     that is not a multiple of 4 or an unaligned pointer takes a scalar
//     kernel with runtime flags (epilogue_any).
//   - The FTZ route folds the flushes into fma.rn.ftz / add.rn.ftz /
//     mul.rn.ftz (slfp.cuh); the wrapper takes it when no scale or shift
//     element and no reciprocal is subnormal, else the exact route.
//   - Plain read-only loads of y.  A streaming (evict-first, ld.global.cs)
//     hint, meant to keep the outputs the next kernel reads in L2, was
//     faster at stage 0's 56x56 sites and slower at stage 3's 7x7 ones,
//     and moved images/s by no more than 0.7% either way (PERF.md), so it
//     is left out; so is a TMA bulk-copy ring for y (cp.async.bulk into
//     shared memory), 1.5% faster at the two 51M-element raw sites and
//     slower at the f32-q ones.
//   - The grid is sized from occupancy to fill the SMs once; a block's
//     rows stride across the grid.
#include "slfp.cuh"

namespace {

constexpr int kThreads = 256;
enum { kQNone = 0, kQBf16 = 1, kQF32 = 2 };

struct Args {
  const float* y;
  const uint16_t* id;
  const float* s;
  const float* t;
  uint16_t* raw;
  void* q;
  long long rows;
  int c;
  float recip;
};

constexpr int kRows = 4;       // rows in flight per thread

__device__ __forceinline__ uint2 pack4(const uint16_t (&h)[4]) {
  return make_uint2(h[0] | (static_cast<uint32_t>(h[1]) << 16),
                    h[2] | (static_cast<uint32_t>(h[3]) << 16));
}

// 4 channels of one row as loaded: y and, with an identity, its 4 bf16
struct Row4 {
  float4 y;
  uint2 id;
};

template <bool kId>
__device__ __forceinline__ Row4 load_row(const Args& a, long long off) {
  Row4 r;
  r.y = __ldg(reinterpret_cast<const float4*>(a.y + off));
  if (kId) r.id = *reinterpret_cast<const uint2*>(a.id + off);
  return r;
}

template <bool kId, bool kRelu, bool kRaw, int kQ, bool kFtz>
__device__ __forceinline__ void finish_row(const Args& a, long long off,
                                           const Row4& r, const float4& s,
                                           const float4& t) {
  const float yv[4] = {r.y.x, r.y.y, r.y.z, r.y.w};
  const float sv[4] = {s.x, s.y, s.z, s.w};
  const float tv[4] = {t.x, t.y, t.z, t.w};
  const float rv[4] = {__uint_as_float(r.id.x << 16),
                       __uint_as_float(r.id.x & 0xFFFF0000u),
                       __uint_as_float(r.id.y << 16),
                       __uint_as_float(r.id.y & 0xFFFF0000u)};
  uint16_t raw[4], q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = slfp::epilogue_value<kFtz, kId, kRelu>(
        yv[k], sv[k], tv[k], kId ? rv[k] : 0.f);
    raw[k] = slfp::bf16_bits(v);
    if (kQ != kQNone) {
      // the dual form quantizes the bf16 raw value, the q-only form the
      // f32 value
      const float src = kRaw ? slfp::bf16_to_float(raw[k]) : v;
      q[k] = slfp::act_bf16_bits_scaled(slfp::scaled<kFtz>(src, a.recip), 8,
                                        kRelu);
    }
  }
  if (kRaw) *reinterpret_cast<uint2*>(a.raw + off) = pack4(raw);
  if (kQ == kQBf16) {
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(a.q) + off) = pack4(q);
  } else if (kQ == kQF32) {
    *reinterpret_cast<float4*>(static_cast<float*>(a.q) + off) =
        make_float4(slfp::bf16_to_float(q[0]), slfp::bf16_to_float(q[1]),
                    slfp::bf16_to_float(q[2]), slfp::bf16_to_float(q[3]));
  }
}

// Block (blockDim.x channel groups of 4) x (blockDim.y rows); blockIdx.y
// picks the channel tile where C / 4 exceeds one block's width.
template <bool kId, bool kRelu, bool kRaw, int kQ, bool kFtz>
__global__ void __launch_bounds__(kThreads) epilogue_slab(Args a) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * 4;
  if (c0 >= a.c) return;
  const float4 s = __ldg(reinterpret_cast<const float4*>(a.s + c0));
  const float4 t = __ldg(reinterpret_cast<const float4*>(a.t + c0));
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  const long long pitch = a.c;
  long long r = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  // kRows rows a step: all their loads are in flight before the first is
  // used
  for (; r + (kRows - 1) * step < a.rows; r += kRows * step) {
    Row4 x[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      x[u] = load_row<kId>(a, (r + u * step) * pitch + c0);
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      finish_row<kId, kRelu, kRaw, kQ, kFtz>(a, (r + u * step) * pitch + c0,
                                              x[u], s, t);
  }
  for (; r < a.rows; r += step) {
    const long long off = r * pitch + c0;
    finish_row<kId, kRelu, kRaw, kQ, kFtz>(a, off, load_row<kId>(a, off), s,
                                            t);
  }
}

// Any form, any C, any alignment: one element per step, runtime flags,
// the exact route (the slab kernel serves the executors' forms).
__global__ void epilogue_any(Args a, bool relu, bool q_f32) {
  const long long n = a.rows * a.c;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const int c = static_cast<int>(e % a.c);
    const float r = a.id != nullptr ? slfp::bf16_to_float(a.id[e]) : 0.f;
    const float v = slfp::epilogue_value(a.y[e], a.s[c], a.t[c],
                                         a.id != nullptr, r, relu);
    const uint16_t raw = slfp::bf16_bits(v);
    if (a.raw != nullptr) a.raw[e] = raw;
    if (a.q != nullptr) {
      const float src = a.raw != nullptr ? slfp::bf16_to_float(raw) : v;
      const uint16_t q = slfp::act_bf16_bits(src, a.recip, 8, relu);
      if (q_f32) {
        static_cast<float*>(a.q)[e] = slfp::bf16_to_float(q);
      } else {
        static_cast<uint16_t*>(a.q)[e] = q;
      }
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

template <bool kId, bool kRelu, bool kRaw, int kQ, bool kFtz>
cudaError_t launch_slab(const Args& a, cudaStream_t st) {
  const int groups = a.c / 4;
  const int gx = groups < kThreads ? groups : kThreads;
  const int gy = kThreads / gx;                 // rows per block step
  const int tiles = (groups + gx - 1) / gx;
  static int per_sm = 0;                        // resident blocks per SM
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, epilogue_slab<kId, kRelu, kRaw, kQ, kFtz>, gx * gy, 0);
    if (per_sm < 1) per_sm = 1;
  }
  // as many blocks as fill the SMs once, fewer where rows run short
  // (kRows rows per thread a step)
  long long bx = (a.rows + kRows * gy - 1) / (kRows * gy);
  const long long full = static_cast<long long>(per_sm) * sm_count() / tiles;
  if (bx > full) bx = full;
  if (bx < 1) bx = 1;
  epilogue_slab<kId, kRelu, kRaw, kQ, kFtz>
      <<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(tiles)),
         dim3(gx, gy), 0, st>>>(a);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const Args&, cudaStream_t);

// the forms the executors serve, on either route; nullptr for any other
template <bool kFtz>
Launch served(bool id, bool relu, bool raw, int q) {
  if (!id && relu && raw && q == kQNone)       // stem, last pointwise
    return launch_slab<false, true, true, kQNone, kFtz>;
  if (!id && !relu && raw && q == kQNone)      // downsample
    return launch_slab<false, false, true, kQNone, kFtz>;
  if (!id && relu && !raw && q == kQBf16)      // after a conv: q only
    return launch_slab<false, true, false, kQBf16, kFtz>;
  if (!id && relu && !raw && q == kQF32)
    return launch_slab<false, true, false, kQF32, kFtz>;
  if (id && relu && !raw && q == kQBf16)       // conv3 at a stage end
    return launch_slab<true, true, false, kQBf16, kFtz>;
  if (id && relu && !raw && q == kQF32)
    return launch_slab<true, true, false, kQF32, kFtz>;
  if (id && relu && raw && q == kQBf16)        // conv3 mid-stage: dual
    return launch_slab<true, true, true, kQBf16, kFtz>;
  if (id && relu && raw && q == kQF32)
    return launch_slab<true, true, true, kQF32, kFtz>;
  return nullptr;
}

}  // namespace

// q_f32: q as float32 holding the bf16 value; ftz: the FTZ route (the
// caller has checked s, t and recip); vec: C a multiple of 4 and every
// pointer 16-byte aligned.
extern "C" int slfp_epilogue(const void* y, const void* identity,
                             const void* s, const void* t, void* raw, void* q,
                             int q_f32, long long rows, int c, float recip,
                             int relu, int ftz, int vec, void* stream) {
  Args a;
  a.y = static_cast<const float*>(y);
  a.id = static_cast<const uint16_t*>(identity);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.raw = static_cast<uint16_t*>(raw);
  a.q = q;
  a.rows = rows;
  a.c = c;
  a.recip = recip;
  if (rows <= 0 || c <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qform = q == nullptr ? kQNone : (q_f32 ? kQF32 : kQBf16);
  Launch slab = nullptr;
  if (vec) {
    slab = ftz ? served<true>(identity != nullptr, relu != 0, raw != nullptr,
                              qform)
               : served<false>(identity != nullptr, relu != 0, raw != nullptr,
                               qform);
  }
  if (slab != nullptr) return static_cast<int>(slab(a, st));
  long long blocks = (rows * c + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  epilogue_any<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      a, relu != 0, q_f32 != 0);
  return static_cast<int>(cudaGetLastError());
}
