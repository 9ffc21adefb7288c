// K7: QSGD's update over every parameter in one pass (train/optimizers.py::
// QSGD.step on the card): momentum SGD with weight decay, dampening and
// nesterov, then the rule's extra step (DSGD: 2x where the weight quantize
// Q did not move, |Q(p) - Q(p + d1)| < tol; SSGD: |p + d1| + 1; SGD: none).
//
// Replaces no Pallas kernel: the JAX package leaves the update to XLA's
// fusion of the optax step (train/optimizers.py there).  Bit-equal to the
// plain version, kernels/optim.py::qsgd_update_plain, and through it to
// JAX's jitted step: the same fused multiply-adds (fma(p, wd, g), fma(buf,
// m, (1 - damp) g), nesterov's fma(buf, m, g), fma(d1, 1 + s, p)) with one
// rounding each, the same separate roundings (d * -lr, p + d1), and
// subnormals flushed exactly where the plain version flushes (around each
// fused multiply-add and inside Q), by slfp.cuh's exact route: the .ftz
// instruction forms would also flush g and p where the plain version keeps
// them.
//
// Bound on the H100: memory.  An element reads p, g and the momentum
// buffer and writes p and the buffer, 20 bytes of float32 (511 MB a step
// at ResNet-50's 25.56 M parameters, 0.153 ms at 3.35 TB/s) against under
// 60 integer and float operations, far below the card's ridge point, so
// the only cure is to move each byte once.  The design:
//   - One thread does an element's whole update in registers; the plain
//     version flattens all parameters into one vector and runs about 70
//     kernels over it, each a pass through device memory.
//   - The parameters are read where they lie: the host plans (tensor,
//     chunk) items from the pointers and sizes (kernels/optim.py::plan)
//     and passes the plan by value, under the 4 KB argument limit, so a
//     CUDA graph keeps it with its kernel node; one block a chunk of 4,096
//     elements, found by a binary search of the blocks' prefix.  -lr is
//     read from device memory, so a graph's replays take the rate written
//     before each.
//   - 16-byte loads, consecutive threads on consecutive vectors, all of a
//     thread's 12 loads issued before its first store; a scalar tail, and
//     a scalar loop for a tensor whose start is not 16-byte aligned.
//   - Q's log bin (qbit 8) is one shared-memory read of a 32-entry table
//     by the top 5 mantissa bits, which holds the bin below and the one
//     bound that may follow, and one compare of the mantissa field.
//   - The rule, qbit, nesterov and the counts are template parameters;
//     the counts ("updated", "stuck" per tensor) are a warp reduction and
//     one atomic add per block.
#include <stddef.h>

#include "slfp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                          // float4s per thread
constexpr int kChunk = kThreads * kUnroll * 4;      // elements per block
constexpr int kMaxTensors = 112;                    // per launch

enum Rule : int { kDsgd = 0, kSsgd = 1, kSgd = 2 };
enum Flag : int { kWd = 1, kMom = 2, kDamp = 4 };

// one launch's tensors; kernels/optim.py::Plan mirrors it field by field
struct Plan {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* buf[kMaxTensors];           // null without momentum
  const float* neg_lr;               // 0-d device tensor
  unsigned long long* counts;        // [tensors][2] (updated, stuck) or null
  int first[kMaxTensors + 1];        // each tensor's first block; the total
  int n[kMaxTensors];
  float wd, momentum, gscale, tol;   // gscale = 1 - dampening
  int tensors, flags;
  unsigned char vec[kMaxTensors];    // p, g and buf 16-byte aligned
};

struct Consts {
  float wd, m, gscale, tol, nlr;
  int flags;
};

template <int kQbit>
__device__ __forceinline__ float weight_q(float x, const int32_t* tab,
                                          const int32_t* val) {
  if constexpr (kQbit == 8) return slfp::slfp34_weight_f32(x, tab, val);
  else if constexpr (kQbit == 7) return slfp::sfp33_weight_f32(x);
  else return x;
}

// one element: the new p, the new buf in place, stuck counted
template <int kRule, int kQbit, bool kNesterov>
__device__ __forceinline__ float update1(float p, float g, float& buf,
                                         const Consts& c, const int32_t* tab,
                                         const int32_t* val,
                                         unsigned& stuck) {
  using slfp::ftz;
  const float gw = (c.flags & kWd) ? ftz(__fmaf_rn(ftz(p), c.wd, g)) : g;
  float d = gw;
  if (c.flags & kMom) {
    const float gd = (c.flags & kDamp) ? __fmul_rn(gw, c.gscale) : gw;
    buf = ftz(__fmaf_rn(ftz(buf), c.m, gd));
    d = kNesterov ? ftz(__fmaf_rn(buf, c.m, gw)) : buf;
  }
  if constexpr (kRule == kSgd) {
    return ftz(__fmaf_rn(ftz(d), c.nlr, p));
  } else {
    const float d1 = __fmul_rn(d, c.nlr);
    const float pd = __fadd_rn(p, d1);
    float factor;
    if constexpr (kRule == kDsgd) {
      const float moved = fabsf(__fsub_rn(weight_q<kQbit>(p, tab, val),
                                          weight_q<kQbit>(pd, tab, val)));
      const bool st = moved < c.tol;
      stuck += st;
      factor = st ? 3.f : 1.f;
    } else {
      factor = __fadd_rn(fabsf(pd), 2.f);
    }
    return ftz(__fmaf_rn(ftz(d1), factor, p));
  }
}

template <int kRule, int kQbit, bool kNesterov>
__device__ __forceinline__ void update4(float4& p, const float4& g,
                                        float4& buf, const Consts& c,
                                        const int32_t* tab,
                                        const int32_t* val, unsigned& stuck) {
  p.x = update1<kRule, kQbit, kNesterov>(p.x, g.x, buf.x, c, tab, val, stuck);
  p.y = update1<kRule, kQbit, kNesterov>(p.y, g.y, buf.y, c, tab, val, stuck);
  p.z = update1<kRule, kQbit, kNesterov>(p.z, g.z, buf.z, c, tab, val, stuck);
  p.w = update1<kRule, kQbit, kNesterov>(p.w, g.w, buf.w, c, tab, val, stuck);
}

template <int kRule, int kQbit, bool kNesterov, bool kStats>
__global__ void __launch_bounds__(kThreads)
    qsgd_update_kernel(const __grid_constant__ Plan plan) {
  __shared__ int32_t tab[32];
  __shared__ int32_t val[17];
  __shared__ unsigned warp_stuck[kThreads / 32];
  if constexpr (kRule == kDsgd && kQbit == 8) {
    if (threadIdx.x < 32) tab[threadIdx.x] = slfp::weight_bin_entry(threadIdx.x);
    if (threadIdx.x < 17) val[threadIdx.x] = slfp::weight_bin_value(threadIdx.x);
    __syncthreads();
  }
  // this block's tensor: the last t with first[t] <= blockIdx.x
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = plan.tensors;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (plan.first[mid] <= b) lo = mid;
    else hi = mid;
  }
  const int t = lo;
  const int start = (b - plan.first[t]) * kChunk;
  const int len = min(kChunk, plan.n[t] - start);
  float* p = plan.p[t] + start;
  const float* g = plan.g[t] + start;
  float* buf = plan.buf[t] ? plan.buf[t] + start : nullptr;
  const Consts c{plan.wd, plan.momentum, plan.gscale, plan.tol,
                 __ldg(plan.neg_lr), plan.flags};
  const bool mom = (c.flags & kMom) != 0;
  unsigned stuck = 0;
  int scalar_from = 0;
  if (plan.vec[t]) {
    const int nv = len >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* b4 = reinterpret_cast<float4*>(buf);
    float4 pv[kUnroll], gv[kUnroll], bv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nv) {
        pv[k] = p4[i];
        gv[k] = __ldg(g4 + i);
        bv[k] = mom ? b4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nv) {
        update4<kRule, kQbit, kNesterov>(pv[k], gv[k], bv[k], c, tab, val,
                                         stuck);
        p4[i] = pv[k];
        if (mom) b4[i] = bv[k];
      }
    }
    scalar_from = nv * 4;
  }
  for (int i = scalar_from + threadIdx.x; i < len; i += kThreads) {
    float bi = mom ? buf[i] : 0.f;
    p[i] = update1<kRule, kQbit, kNesterov>(p[i], g[i], bi, c, tab, val,
                                            stuck);
    if (mom) buf[i] = bi;
  }
  if constexpr (kStats) {
    stuck = __reduce_add_sync(0xFFFFFFFFu, stuck);
    if ((threadIdx.x & 31) == 0) warp_stuck[threadIdx.x >> 5] = stuck;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned s = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += warp_stuck[w];
      atomicAdd(plan.counts + 2 * t, static_cast<unsigned long long>(len - s));
      atomicAdd(plan.counts + 2 * t + 1, static_cast<unsigned long long>(s));
    }
  }
}

template <int kRule, int kQbit, bool kNesterov, bool kStats>
cudaError_t launch(const Plan& plan, cudaStream_t st) {
  const int blocks = plan.first[plan.tensors];
  if (blocks > 0) {
    qsgd_update_kernel<kRule, kQbit, kNesterov, kStats>
        <<<blocks, kThreads, 0, st>>>(plan);
  }
  return cudaGetLastError();
}

template <int kRule, int kQbit, bool kStats>
cudaError_t pick_nesterov(const Plan& plan, int nesterov, cudaStream_t st) {
  return nesterov ? launch<kRule, kQbit, true, kStats>(plan, st)
                  : launch<kRule, kQbit, false, kStats>(plan, st);
}

template <int kQbit>
cudaError_t pick_dsgd(const Plan& plan, int nesterov, int stats,
                      cudaStream_t st) {
  return stats ? pick_nesterov<kDsgd, kQbit, true>(plan, nesterov, st)
               : pick_nesterov<kDsgd, kQbit, false>(plan, nesterov, st);
}

}  // namespace

// sizeof(Plan) for field < 0, else the offset of field i in declaration
// order: the wrapper holds its ctypes mirror to them once, at load
extern "C" int qsgd_plan_layout(int field) {
  switch (field) {
    case 0: return static_cast<int>(offsetof(Plan, p));
    case 1: return static_cast<int>(offsetof(Plan, g));
    case 2: return static_cast<int>(offsetof(Plan, buf));
    case 3: return static_cast<int>(offsetof(Plan, neg_lr));
    case 4: return static_cast<int>(offsetof(Plan, counts));
    case 5: return static_cast<int>(offsetof(Plan, first));
    case 6: return static_cast<int>(offsetof(Plan, n));
    case 7: return static_cast<int>(offsetof(Plan, wd));
    case 8: return static_cast<int>(offsetof(Plan, momentum));
    case 9: return static_cast<int>(offsetof(Plan, gscale));
    case 10: return static_cast<int>(offsetof(Plan, tol));
    case 11: return static_cast<int>(offsetof(Plan, tensors));
    case 12: return static_cast<int>(offsetof(Plan, flags));
    case 13: return static_cast<int>(offsetof(Plan, vec));
    default: return static_cast<int>(sizeof(Plan));
  }
}

extern "C" int qsgd_zero_counts(void* counts, long long bytes, void* stream) {
  return static_cast<int>(
      cudaMemsetAsync(counts, 0, static_cast<size_t>(bytes),
                      static_cast<cudaStream_t>(stream)));
}

// rule: 0 DSGD, 1 SSGD, 2 SGD; qbit 8, 7 or 32 (DSGD's Q); stats: DSGD
// only
extern "C" int qsgd_update(const void* plan_ptr, int rule, int qbit,
                           int nesterov, int stats, void* stream) {
  const Plan& plan = *static_cast<const Plan*>(plan_ptr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan.tensors < 1 || plan.tensors > kMaxTensors ||
      (stats && (rule != kDsgd || plan.counts == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (rule == kDsgd) {
    if (qbit == 8) err = pick_dsgd<8>(plan, nesterov, stats, st);
    else if (qbit == 7) err = pick_dsgd<7>(plan, nesterov, stats, st);
    else if (qbit == 32) err = pick_dsgd<32>(plan, nesterov, stats, st);
    else err = cudaErrorInvalidValue;
  } else if (rule == kSsgd) {
    err = pick_nesterov<kSsgd, 32, false>(plan, nesterov, st);
  } else if (rule == kSgd) {
    err = pick_nesterov<kSgd, 32, false>(plan, nesterov, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
