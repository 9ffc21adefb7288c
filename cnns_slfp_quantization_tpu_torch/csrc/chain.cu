// K6: a whole stride-1 ResNet bottleneck in one kernel.
//
// Replaces the Pallas kernel cnns_slfp_quantization_tpu/kernels/chain.py::
// bottleneck_chain (:87), body _chain_kernel (:47-80).  For NHWC bf16 xq
// (the quantized block input) and identity (the raw block input):
//   y1  = Q2(relu(fma(xq @ W1, a1, b1)))                 1x1, C -> M
//   y2  = Q3(relu(fma(sum_taps y1p[shift] @ W2[tap], a2, b2)))  3x3 pad 1
//   y3  = relu(fma(y2 @ W3, a3, b3) + identity)          1x1, M -> C
//   raw = bf16(y3);  q = Qn(y3)
// with Qk(v) = bf16(slfp34_act_bits(v * recip_k)) on the float32 value (the
// chain's own quantize, not the bf16-bits form K2/K3 inline), every float
// operation rounded once and subnormals flushed (slfp.cuh).  y1 and y2 never
// leave shared memory: only xq, identity, the weights and the outputs move
// through device memory.
//
// Bound on the H100: at ResNet-50's stage 2 (14x14, C 1024, M 256) and stage
// 3 (7x7, C 2048, M 512) a launch at batch 64 moves 48-105 MB and does 27.9
// GFLOP: about 30 us either way, so bytes and bf16 tensor-core operations
// bound it alike.
//
// Design (right and simple first).  One block of 256 threads computes a band
// of `rows` output rows of one image.  The TPU kernel holds whole images and
// all three weight matrices in VMEM; a block here has 227 KB of shared
// memory, while the weights alone are 2.2 MB (stage 2) and 8.9 MB (stage 3).
// So the weights stream from L2 in tiles of 32 rows, and only the band's
// intermediates stay resident:
//   - y1 over the band plus one halo row above and below, zero-padded, laid
//     out on a row pitch of W + 2 pixels.  On that pitch the 3x3 conv's nine
//     shifted operands are contiguous row ranges of y1 (offset dy*(W+2)+dx),
//     so each tap is a plain wmma GEMM read straight from shared memory; the
//     two padding columns of each output row are computed and dropped;
//   - y2 over the band's pixels, compact.
// Stage 2 runs in bands of 7 rows (225 KB; conv1 recomputes the 2 halo rows,
// 7% more FLOPs for the block), stage 3 in bands of 4 and 3 rows so that
// 128 blocks fill the 132 SMs at batch 64.  The wrapper
// (kernels/chain.py::_plan) picks the band and checks the limits: at most 10
// row tiles of 16 per GEMM (5 per warp) and 227 KB of shared memory; stage 0
// (56x56) exceeds them even with one-row bands.  Each warp owns up to a 5 x 2
// grid of 16x16 wmma bf16 -> f32 accumulators: two column tiles of a
// 128-column chunk and half the row tiles, or, where one warp can hold all
// of a GEMM's row tiles (stage 3's bands), two column tiles of a 256-column
// chunk and every row tile, which halves the chunks and their pipeline
// fills and keeps no warp idle (stage 3: 1.235 -> 0.929 ms a launch at
// batch 64).  Operand tiles stream in through a ring of cp.async copies,
// three tiles deep for conv1 (x and W1) and four for conv2 and conv3
// (weights only), so that L2's latency hides behind the tensor cores.
// Epilogues go through a 16x16 f32 staging tile per warp; the quantize
// selects its 2**(ml/16) mantissa with a select tree, as the JAX kernel
// does, since a per-lane table switch diverges.  Every block re-reads the
// whole weight set from L2 (128 x 2.2 MB in stage 2).  What bounds it now
// (utils/bench_chain.py): about a fifth of mma.sync's rate inside the
// pipelines, with 8-20 wmma products per warp between two barriers, and
// the epilogues, serial after each chunk (31% of a stage-2 block); wgmma,
// TMA multicast across a cluster and deeper pipelines are later work.
#include <mma.h>

#include "slfp.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256, kWarps = 8;
constexpr int kBK = 32;            // K step of every GEMM
constexpr int kNC = 128;           // output channels per narrow chunk
constexpr int kMaxRowTiles = 10;   // 16-row tiles of one GEMM
constexpr int kHalf = kMaxRowTiles / 2;
constexpr int kLdA = kBK + 16;     // staged x tile pitch: 32-byte rows
constexpr int kStagesX = 3;        // ring depth of conv1 (x and W1 tiles)
constexpr int kStagesW = 4;        // ring depth of conv2 and conv3

// bytes of a staged weight tile [kBK x nc] on a pitch of nc + 16
__host__ __device__ constexpr int tile_b_bytes(int nc) {
  return 2 * kBK * (nc + 16);
}
// columns per chunk of a GEMM with tm row tiles: 256 when one warp holds
// all its row tiles, else 128 with the row tiles split in two halves
__host__ __device__ constexpr int chunk_cols(int tm) {
  return tm <= kHalf ? 2 * kNC : kNC;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Params {
  const uint16_t* x;
  const uint16_t* idn;
  const uint16_t* w1;
  const uint16_t* w2;
  const uint16_t* w3;
  const float *a1, *b1, *a2, *b2, *a3, *b3;
  uint16_t* raw;
  uint16_t* q;
  int h, w, c, m, rows;
  float recip2, recip3, recip_next;
  // derived from the above (chain_geometry)
  int wp, tm1, tm2, tm3, y1r, ld, tile_a, ring;
};

struct Geometry {
  int wp, tm1, tm2, tm3, y1r, ld, tile_a, ring;
  long long smem;
};

// the layout of one band; kernels/chain.py::_smem_bytes mirrors it
Geometry chain_geometry(int w, int m, int rows) {
  Geometry g;
  g.wp = w + 2;
  g.tm1 = ((rows + 2) * g.wp + 15) / 16;   // conv1 rows: band + halo
  g.tm2 = (rows * g.wp + 15) / 16;         // conv2 rows on the padded pitch
  g.tm3 = (rows * w + 15) / 16;            // conv3 rows: the band's pixels
  int need = g.tm2 * 16 + 2 * g.wp + 2;    // last row a shifted tap reads
  if (need < g.tm1 * 16) need = g.tm1 * 16;
  g.y1r = (need + 15) / 16 * 16;
  g.ld = m + 16;
  g.tile_a = 2 * g.tm1 * 16 * kLdA;        // bytes of one staged x tile
  g.ring = kStagesX * (g.tile_a + tile_b_bytes(chunk_cols(g.tm1)));
  const int w2 = kStagesW * tile_b_bytes(chunk_cols(g.tm2));
  const int w3 = kStagesW * tile_b_bytes(chunk_cols(g.tm3));
  if (g.ring < w2) g.ring = w2;
  if (g.ring < w3) g.ring = w3;
  g.smem = 2LL * g.y1r * g.ld + 2LL * g.tm3 * 16 * g.ld + g.ring +
           4LL * kWarps * 256;
  return g;
}

// 23-bit mantissa field of float32(2**(ml/16)) by a select tree: a table
// indexed per lane would diverge or go through local memory
__device__ __forceinline__ int32_t p_select(int32_t ml) {
  const bool b0 = ml & 1, b1 = ml & 2, b2 = ml & 4, b3 = ml & 8;
  const int32_t t0 = b0 ? 0x5AAC3 : 0x0, t1 = b0 ? 0x11C3D3 : 0xB95C2;
  const int32_t t2 = b0 ? 0x1EF532 : 0x1837F0, t3 = b0 ? 0x2D583F : 0x25FED7;
  const int32_t t4 = b0 ? 0x3D08A4 : 0x3504F3, t5 = b0 ? 0x4E248C : 0x45672A;
  const int32_t t6 = b0 ? 0x60CCDF : 0x5744FD, t7 = b0 ? 0x75257D : 0x6AC0C7;
  const int32_t u0 = b1 ? t1 : t0, u1 = b1 ? t3 : t2;
  const int32_t u2 = b1 ? t5 : t4, u3 = b1 ? t7 : t6;
  const int32_t v0 = b2 ? u1 : u0, v1 = b2 ? u3 : u2;
  return b3 ? v1 : v0;
}

// the chain's quantize: bf16(slfp34_act_bits(v * recip)) on float32 v
// (slfp.cuh::slfp34_act_f32 with the select tree), for v >= 0 or any v
__device__ __forceinline__ uint16_t chain_q(float v, float recip) {
  const int32_t bits = __float_as_int(slfp::ftz(__fmul_rn(slfp::ftz(v),
                                                          recip)));
  const int32_t sign = bits & static_cast<int32_t>(0x80000000u);
  const int32_t ab = bits & 0x7FFFFFFF;
  const int32_t r = (ab + 0x3FFFF + ((ab >> 19) & 1)) & -0x80000;
  const int32_t j = (r >> 19) & 15;
  int32_t out = (r & -0x00800000) | p_select(j + ((slfp::kMlMagic >> j) & 1));
  if (ab < slfp::kI32Lo) out = (ab == 0) ? 0 : slfp::kI32PseudoZero;
  else if (ab < slfp::kI32Eighth) out = slfp::kI32Eighth;
  if (ab > slfp::kI32ClampSlfp) out = slfp::kI32ClampSlfp;
  return slfp::bf16_bits(__int_as_float(out | sign));
}

__device__ __forceinline__ uint4 pack8(const uint16_t (&h)[8]) {
  uint4 u;
  u.x = h[0] | (static_cast<uint32_t>(h[1]) << 16);
  u.y = h[2] | (static_cast<uint32_t>(h[3]) << 16);
  u.z = h[4] | (static_cast<uint32_t>(h[5]) << 16);
  u.w = h[6] | (static_cast<uint32_t>(h[7]) << 16);
  return u;
}

__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

// 16-byte asynchronous copy global -> shared; zero fill when !pred
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// how the 8 warps share one GEMM of tm row tiles, chunk by chunk of nc
// output columns: warp w owns column tiles ct0, ct0 + 1 and row tiles
// rt0 .. rt0 + nrt - 1
struct Tiling {
  int nc, ldb, rt0, nrt, ct0;
};

__device__ __forceinline__ Tiling tiling(int tm, int warp) {
  Tiling t;
  t.nc = chunk_cols(tm);
  t.ldb = t.nc + 16;
  if (t.nc > kNC) {
    t.rt0 = 0;
    t.nrt = tm;
    t.ct0 = warp * 2;
  } else {
    const int half = (tm + 1) / 2;
    t.rt0 = (warp / 4) * half;
    t.nrt = max(0, min(half, tm - t.rt0));
    t.ct0 = (warp % 4) * 2;
  }
  return t;
}

// weight tile [kBK x nc] of a row-major [K, N] matrix, nc / 64 chunks of 8
// a thread
__device__ __forceinline__ void issue_b(bf16* bs, const Tiling& t,
                                        const uint16_t* w, int K, int N,
                                        int k0, int n0, int tid) {
  const int per_row = t.nc / 8;
#pragma unroll
  for (int i = 0; i < 2 * kNC / 64; ++i) {
    if (i >= t.nc / 64) break;
    const int id = tid + i * kThreads;
    const int row = id / per_row, col = (id % per_row) * 8;
    const int k = k0 + row;
    const int n = n0 + col;
    const bool ok = k < K && n < N;
    cp16(bs + row * t.ldb + col,
         ok ? w + static_cast<long long>(k) * N + n : w, ok);
  }
}

// padded-pitch row j of y1 -> the input pixel it is computed from, or -1
// for the zero padding (outside the image or past the band)
__device__ __forceinline__ int y1_pixel(const Params& p, int r0, int j) {
  if (j >= (p.rows + 2) * p.wp) return -1;
  const int row = r0 - 1 + j / p.wp;
  const int col = j % p.wp - 1;
  if (row < 0 || row >= p.h || col < 0 || col >= p.w) return -1;
  return row * p.w + col;
}

// x tile [tm1*16 x kBK] of the band's y1 rows, up to 3 chunks of 8 a thread
__device__ __forceinline__ void issue_x(bf16* as, const Params& p,
                                        const uint16_t* xn, int r0, int k0,
                                        int tid) {
  const int total = p.tm1 * 16 * (kBK / 8);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int id = tid + i * kThreads;
    if (id < total) {
      const int pix = y1_pixel(p, r0, id >> 2);
      const int k = k0 + (id & 3) * 8;
      const bool ok = pix >= 0 && k < p.c;
      cp16(as + (id >> 2) * kLdA + (id & 3) * 8,
           ok ? xn + static_cast<long long>(pix) * p.c + k : xn, ok);
    }
  }
}

// a ring of S stages: step s's copies are one commit group, issued S - 1
// steps ahead; compute(s, stage) runs once every thread's copies of step s
// have landed.  Ends with the ring drained and the block synchronised.
template <int S, class Issue, class Compute>
__device__ __forceinline__ void pipeline(int nsteps, Issue issue,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nsteps) issue(s, s);
    cp_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_wait<S - 2>();
    __syncthreads();
    compute(s, s % S);
    const int nx = s + S - 1;
    if (nx < nsteps) issue(nx, nx % S);
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();
}

// acc[i][j] += A[row tile rt0 + i] @ Bs[:, column tile ct0 + j] over ksub
// steps of 16; `a` points at the A operand's first column of this K step
__device__ __forceinline__ void mma_step(FragC (&acc)[kHalf][2],
                                         const bf16* a, int lda, int rt0,
                                         int nrt, const bf16* bs, int ldb,
                                         int ksub, int ct0, int nct) {
  for (int kk = 0; kk < ksub; ++kk) {
    FragB b[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < nct) {
        wmma::load_matrix_sync(b[j], bs + kk * 16 * ldb + (ct0 + j) * 16,
                               ldb);
      }
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      if (i < nrt) {
        FragA fa;
        wmma::load_matrix_sync(
            fa, a + static_cast<long long>(rt0 + i) * 16 * lda + kk * 16,
            lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j < nct) wmma::mma_sync(acc[i][j], fa, b[j], acc[i][j]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(FragC (&acc)[kHalf][2]) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// one accumulator tile through the warp's staging tile: lane l gets row
// l / 2, columns (l % 2) * 8 .. + 8
__device__ __forceinline__ void tile_row8(float* st, const FragC& f, int lane,
                                          float (&v)[8]) {
  wmma::store_matrix_sync(st, f, 16, wmma::mem_row_major);
  __syncwarp();
  const float* s = st + (lane >> 1) * 16 + (lane & 1) * 8;
  const float4 p0 = *reinterpret_cast<const float4*>(s);
  const float4 p1 = *reinterpret_cast<const float4*>(s + 4);
  v[0] = p0.x; v[1] = p0.y; v[2] = p0.z; v[3] = p0.w;
  v[4] = p1.x; v[5] = p1.y; v[6] = p1.z; v[7] = p1.w;
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1) chain_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* y1p = reinterpret_cast<bf16*>(smem);
  bf16* y2 = y1p + p.y1r * p.ld;
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(y2 + p.tm3 * 16 * p.ld);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* st = reinterpret_cast<float*>(ring + p.ring) + warp * 256;

  const int img = blockIdx.y;
  const int r0 = blockIdx.x * p.rows;
  const int r_eff = min(p.rows, p.h - r0);
  const long long hw = static_cast<long long>(p.h) * p.w;
  const uint16_t* xn = p.x + img * hw * p.c;
  const int lr = lane >> 1, lc = (lane & 1) * 8;

  // y1 rows that conv1 does not write but the shifted taps read: zeros
  {
    uint4* z = reinterpret_cast<uint4*>(y1p + p.tm1 * 16 * p.ld);
    const int n = (p.y1r - p.tm1 * 16) * p.ld / 8;
    for (int i = tid; i < n; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }

  FragC acc[kHalf][2];

  // ---- conv1: y1 = Q2(relu(fma(x @ W1, a1, b1))) on the padded pitch ----
  {
    const Tiling t = tiling(p.tm1, warp);
    const int rt0 = t.rt0, nrt = t.nrt, ct0 = t.ct0;
    // a ring stage holds an x tile and a weight tile
    const int stride = p.tile_a + tile_b_bytes(t.nc);
    const int ksteps = (p.c + kBK - 1) / kBK;
    for (int n0 = 0; n0 < p.m; n0 += t.nc) {
      const int nct = max(0, min(2, min(t.nc, p.m - n0) / 16 - ct0));
      zero_acc(acc);
      pipeline<kStagesX>(
          ksteps,
          [&](int s, int stage) {
            issue_x(reinterpret_cast<bf16*>(ring + stage * stride), p, xn,
                    r0, s * kBK, tid);
            issue_b(reinterpret_cast<bf16*>(ring + stage * stride +
                                            p.tile_a),
                    t, p.w1, p.c, p.m, s * kBK, n0, tid);
          },
          [&](int s, int stage) {
            mma_step(acc, reinterpret_cast<bf16*>(ring + stage * stride),
                     kLdA, rt0, nrt,
                     reinterpret_cast<bf16*>(ring + stage * stride +
                                             p.tile_a),
                     t.ldb, min(2, (p.c - s * kBK) / 16), ct0, nct);
          });
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (i >= nrt || j >= nct) continue;
          float v[8];
          tile_row8(st, acc[i][j], lane, v);
          const int row = (rt0 + i) * 16 + lr;
          const int ch = n0 + (ct0 + j) * 16 + lc;
          const bool valid = y1_pixel(p, r0, row) >= 0;
          uint16_t hq[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float y = slfp::epilogue_value(
                v[k], __ldg(p.a1 + ch + k), __ldg(p.b1 + ch + k), false, 0.f,
                true);
            hq[k] = valid ? chain_q(y, p.recip2) : 0;
          }
          *reinterpret_cast<uint4*>(y1p + row * p.ld + ch) = pack8(hq);
        }
      }
    }
  }
  __syncthreads();

  // ---- conv2: nine shifted GEMMs over y1 -> y2 = Q3(relu(fma(., a2, b2)))
  {
    const Tiling t = tiling(p.tm2, warp);
    const int rt0 = t.rt0, nrt = t.nrt, ct0 = t.ct0;
    const int stride = tile_b_bytes(t.nc);
    const int kc = (p.m + kBK - 1) / kBK;
    const long long tap_size = static_cast<long long>(p.m) * p.m;
    for (int n0 = 0; n0 < p.m; n0 += t.nc) {
      const int nct = max(0, min(2, min(t.nc, p.m - n0) / 16 - ct0));
      zero_acc(acc);
      pipeline<kStagesW>(
          9 * kc,
          [&](int s, int stage) {
            issue_b(reinterpret_cast<bf16*>(ring + stage * stride), t,
                    p.w2 + (s / kc) * tap_size, p.m, p.m, (s % kc) * kBK, n0,
                    tid);
          },
          [&](int s, int stage) {
            const int tap = s / kc, k0 = (s % kc) * kBK;
            const int shift = (tap / 3) * p.wp + tap % 3;
            mma_step(acc, y1p + shift * p.ld + k0, p.ld, rt0, nrt,
                     reinterpret_cast<bf16*>(ring + stage * stride), t.ldb,
                     min(2, (p.m - k0) / 16), ct0, nct);
          });
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (i >= nrt || j >= nct) continue;
          float v[8];
          tile_row8(st, acc[i][j], lane, v);
          const int qrow = (rt0 + i) * 16 + lr;
          const int r = qrow / p.wp, c = qrow % p.wp;
          if (r >= p.rows || c >= p.w) continue;   // padding columns
          const int ch = n0 + (ct0 + j) * 16 + lc;
          uint16_t hq[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float y = slfp::epilogue_value(
                v[k], __ldg(p.a2 + ch + k), __ldg(p.b2 + ch + k), false, 0.f,
                true);
            hq[k] = chain_q(y, p.recip3);
          }
          *reinterpret_cast<uint4*>(y2 + (r * p.w + c) * p.ld + ch) =
              pack8(hq);
        }
      }
    }
  }
  __syncthreads();

  // ---- conv3: y3 = relu(fma(y2 @ W3, a3, b3) + identity) -> raw, q ------
  {
    const Tiling t = tiling(p.tm3, warp);
    const int rt0 = t.rt0, nrt = t.nrt, ct0 = t.ct0;
    const int stride = tile_b_bytes(t.nc);
    const int ksteps = (p.m + kBK - 1) / kBK;
    for (int n0 = 0; n0 < p.c; n0 += t.nc) {
      const int nct = max(0, min(2, min(t.nc, p.c - n0) / 16 - ct0));
      zero_acc(acc);
      pipeline<kStagesW>(
          ksteps,
          [&](int s, int stage) {
            issue_b(reinterpret_cast<bf16*>(ring + stage * stride), t, p.w3,
                    p.m, p.c, s * kBK, n0, tid);
          },
          [&](int s, int stage) {
            mma_step(acc, y2 + s * kBK, p.ld, rt0, nrt,
                     reinterpret_cast<bf16*>(ring + stage * stride), t.ldb,
                     min(2, (p.m - s * kBK) / 16), ct0, nct);
          });
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (i >= nrt || j >= nct) continue;
          float v[8];
          tile_row8(st, acc[i][j], lane, v);
          const int prow = (rt0 + i) * 16 + lr;
          const int r = prow / p.w;
          if (r >= r_eff) continue;
          const long long pix = img * hw +
              static_cast<long long>(r0 + r) * p.w + prow % p.w;
          const int ch = n0 + (ct0 + j) * 16 + lc;
          const long long off = pix * p.c + ch;
          float id[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(p.idn + off)), id);
          uint16_t hr[8], hq[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float y = slfp::epilogue_value(
                v[k], __ldg(p.a3 + ch + k), __ldg(p.b3 + ch + k), true, id[k],
                true);
            hr[k] = slfp::bf16_bits(y);
            hq[k] = chain_q(y, p.recip_next);
          }
          if (p.raw != nullptr) {
            *reinterpret_cast<uint4*>(p.raw + off) = pack8(hr);
          }
          if (p.q != nullptr) {
            *reinterpret_cast<uint4*>(p.q + off) = pack8(hq);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int slfp_bottleneck_chain(
    const void* xq, const void* identity, const void* w1, const void* w2,
    const void* w3, const void* a1, const void* b1, const void* a2,
    const void* b2, const void* a3, const void* b3, void* raw, void* q,
    int n, int h, int w, int c, int m, int rows, float recip2, float recip3,
    float recip_next, void* stream) {
  const Geometry g = chain_geometry(w, m, rows);
  if (n <= 0 || h <= 0 || w <= 0 || rows <= 0 || c % 16 || m % 16 ||
      g.tm1 > kMaxRowTiles || g.smem > 232448 ||
      (raw == nullptr && q == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const uint16_t*>(xq);
  p.idn = static_cast<const uint16_t*>(identity);
  p.w1 = static_cast<const uint16_t*>(w1);
  p.w2 = static_cast<const uint16_t*>(w2);
  p.w3 = static_cast<const uint16_t*>(w3);
  p.a1 = static_cast<const float*>(a1);
  p.b1 = static_cast<const float*>(b1);
  p.a2 = static_cast<const float*>(a2);
  p.b2 = static_cast<const float*>(b2);
  p.a3 = static_cast<const float*>(a3);
  p.b3 = static_cast<const float*>(b3);
  p.raw = static_cast<uint16_t*>(raw);
  p.q = static_cast<uint16_t*>(q);
  p.h = h;
  p.w = w;
  p.c = c;
  p.m = m;
  p.rows = rows;
  p.recip2 = recip2;
  p.recip3 = recip3;
  p.recip_next = recip_next;
  p.wp = g.wp;
  p.tm1 = g.tm1;
  p.tm2 = g.tm2;
  p.tm3 = g.tm3;
  p.y1r = g.y1r;
  p.ld = g.ld;
  p.tile_a = g.tile_a;
  p.ring = g.ring;
  cudaError_t e = cudaFuncSetAttribute(
      chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((h + rows - 1) / rows),
                  static_cast<unsigned>(n));
  chain_kernel<<<grid, kThreads, g.smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
