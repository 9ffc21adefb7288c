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
// GFLOP: about 30 us either way.  A block holds a band of one image, so
// every block also streams the whole weight set (2.2 MB at stage 2, 8.9 MB
// at stage 3) from L2; sharing each weight tile between two blocks by TMA
// multicast measured slower on the H100 (the pair then moves in lockstep),
// so the weights stream per block.  What bounds this design instead is the
// issue of each K step (a stage's wait, the A fragments, four wgmmas, their
// wait) and the epilogues' arithmetic (utils/bench_chain.py's cycles per
// phase).
//
// Design (sm_90a), on the machinery of gemm_sm90.cuh (included, not
// changed).  One block of two consumer warpgroups and one producer warp
// computes a band of `rows` output rows of one image, as three GEMMs in
// turn, each in chunks of output columns accumulated in registers by
// wgmma m64n128k16 (A from registers, B from shared memory):
//   conv1  A = the band's input pixels plus a halo row above and below,
//          (rows + 2) * W rows loaded by TMA with the weights (one 2-D box
//          of 64 rows a row tile, 128-byte swizzle; rows outside the image
//          are loaded as whatever lies there and masked by the epilogue);
//   conv2  A = y1 on a row pitch of W + 2 pixels, zero-padded: the nine
//          taps are row shifts of dy * (W + 2) + dx, which no shared-memory
//          descriptor can express (they are not 8-row aligned), so each
//          lane of an ldmatrix names its own row; y1's pitch is M + 8
//          elements, an odd multiple of 16 bytes, so the 8 rows an ldmatrix
//          reads hit distinct banks; the padding columns of each output row
//          are computed and dropped;
//   conv3  A = y2, compact, by ldmatrix.
// Rows of a GEMM form 1 or 2 row tiles of 64 (kernels/chain.py::_plan
// picks the band so that they do): with 2, each warpgroup takes one row
// tile of the same 128-column chunk; with 1, the two warpgroups take the
// two halves of a 256-column chunk; either way they share every weight
// tile.  Where bands would leave the card short of blocks, the plan gives
// a band to a cluster of two blocks instead (split 2: stage 3 at batch 64,
// whole 7x7 images): each computes half of every GEMM's output columns,
// streams only its half of the weights, and writes its half of y1 and y2
// into both blocks' shared memory (st.shared::cluster), each GEMM waiting
// on an mbarrier that both blocks' consumer warps arrive on.  A whole
// image fills its 64-row tiles where 4-row bands left half of them empty.
// The weights land by TMA in the 128-byte-swizzled [K, N] layout
// wgmma reads B from, in a ring of 2-4 stages guarded by full/empty
// mbarriers and kept full by one lane of the producer warp, which walks
// the single weight stream of the block in the consumers' order (conv1's
// tiles, conv2's 9 taps x K steps, conv3's) so that the ring never drains
// at a GEMM boundary; a chunk's epilogue runs while the next chunk's tiles
// land.  Epilogues work straight from the accumulator registers (wgmma's
// fragment layout: pairs of columns of two rows a thread), with no branch
// inside their unrolled loops: conv1's and conv2's write bf16 pairs to y1
// / y2 in shared memory, conflict-free on their pitch; conv3's reads the
// identity of its chunk (loaded before the chunk's mainloop) and writes raw
// and q as bf16 pairs.  Each epilogue is slfp::epilogue_value then the
// chain's quantize, whose 2**(ml/16) mantissa comes from a 16-word table
// in shared memory; their flushes fold into the FTZ forms of fma, add and
// mul (kFtz) when the wrapper finds no subnormal affine parameter or
// reciprocal, as K5's do.  No float atomics: two launches give the same
// bits.
#include "gemm_sm90.cuh"

#ifdef CHAIN_PHASES
// utils/bench_chain.py builds a copy with -DCHAIN_PHASES: thread 0 adds the
// clock64 cycles of each phase of its block to g_phase[k]
__device__ unsigned long long g_phase[8];
extern "C" int chain_phases(unsigned long long* host, int zero) {
  if (zero) {
    const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_phase, z, sizeof(z)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase)));
}
#define PHASE(k)                                                    \
  if (threadIdx.x == 0) {                                           \
    const long long t_ = clock64();                                 \
    atomicAdd(&g_phase[k], static_cast<unsigned long long>(t_ - t_mark)); \
    t_mark = t_;                                                    \
  }
#else
#define PHASE(k)
#endif

namespace {

constexpr int kWG = 2;                       // consumer warpgroups
constexpr int kConsumers = 128 * kWG;
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kBK = 64;                      // K step: 128 bytes of bf16
constexpr int kMaxTiles = kWG;               // 64-row tiles of one GEMM
constexpr int kMaxStages = 4;
constexpr int kXTile = 64 * 128;             // bytes of a 64-row x tile
constexpr int kSmemLimit = 232448;

// output columns of a chunk: the warpgroups split it when a GEMM has one
// row tile
__host__ __device__ constexpr int chunk_cols(int tiles) {
  return tiles == 1 ? 128 * kWG : 128;
}

struct Geometry {
  int wp, p1, p2, p3, t1, t2, t3, ld, y1r, y2r, stage_bytes, stages;
  long long smem;
};

// the layout of one band; kernels/chain.py::_smem_bytes mirrors it
Geometry chain_geometry(int w, int m, int rows) {
  Geometry g;
  g.wp = w + 2;
  g.p1 = (rows + 2) * w;           // conv1 rows: the band's pixels + halo
  g.p2 = rows * g.wp;              // conv2 rows on the padded pitch
  g.p3 = rows * w;                 // conv3 rows: the band's pixels
  g.t1 = (g.p1 + 63) / 64;
  g.t2 = (g.p2 + 63) / 64;
  g.t3 = (g.p3 + 63) / 64;
  g.ld = m + 8;
  g.y1r = (rows + 2) * g.wp + 2;   // + the last taps' overrun
  g.y2r = g.p3;
  int sb = g.t1 * kXTile + 128 * chunk_cols(g.t1);
  if (sb < 128 * chunk_cols(g.t2)) sb = 128 * chunk_cols(g.t2);
  if (sb < 128 * chunk_cols(g.t3)) sb = 128 * chunk_cols(g.t3);
  g.stage_bytes = sb;
  const long long fixed =
      1024 + 2LL * g.ld * (g.y1r + g.y2r) + 16LL * kMaxStages + 16;
  const long long st = (kSmemLimit - fixed) / sb;
  g.stages = static_cast<int>(st < kMaxStages ? st : kMaxStages);
  // at least two stages: what does not fit shows in smem
  g.smem = fixed + static_cast<long long>(g.stages > 2 ? g.stages : 2) * sb;
  return g;
}

struct Params {
  const uint16_t* idn;
  const float *a1, *b1, *a2, *b2, *a3, *b3;
  uint16_t* raw;
  uint16_t* q;
  long long pixels;                // N * H * W
  int h, w, c, m, rows;
  float recip2, recip3, recip_next;
  int wp, p1, p2, p3, t1, t2, t3, ld, y1r, stage_bytes, stages;
  int split;                       // blocks sharing a band's columns: 1, 2
};

// ---------------------------------------- a band's columns over two blocks

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the shared address ``a`` of this block, in block ``rank`` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v)
               : "memory");
}

// arrive, with release at cluster scope, on the mbarrier at cluster
// address ``a``
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t a) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          a)
      : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float d;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
}

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float d;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float add_ftz(float a, float b) {
  float d;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// slfp::epilogue_value(y, a, b, r != nullptr, *r, true): the affine, the
// residual and ReLU, each rounded once and flushed.  kFtz: by the FTZ
// forms of the instructions, equal when a and b are not subnormal (the
// wrapper checks them once per tensor); the residual add's FTZ form equals
// its explicit flushes always.
template <bool kFtz>
__device__ __forceinline__ float epi_value(float y, float a, float b,
                                           const float* r) {
  float v = kFtz ? fma_ftz(y, a, b) : slfp::ftz(__fmaf_rn(slfp::ftz(y), a, b));
  if (r != nullptr)
    v = kFtz ? add_ftz(v, *r) : slfp::ftz(__fadd_rn(v, slfp::ftz(*r)));
  return v > 0.f ? v : 0.f;
}

// the chain's quantize: bf16(slfp34_act_bits(v * recip)) on a flushed
// float32 v (an epilogue value; slfp.cuh::slfp34_act_f32), for v >= 0 or
// any v.  ptab[j] is the 23-bit mantissa field of float32(2**(ml/16)) for
// the rounded 4 bits j (ml = j, or j + 1 where the codebook skips an entry),
// a 16-word table in shared memory: one load where a select tree took some
// twenty instructions, without the divergence of a per-lane register table.
template <bool kFtz>
__device__ __forceinline__ uint32_t chain_q(float v, float recip,
                                           const int32_t* ptab) {
  // kFtz: recip is not subnormal
  const int32_t bits = __float_as_int(
      kFtz ? mul_ftz(v, recip) : slfp::ftz(__fmul_rn(v, recip)));
  const int32_t sign = bits & static_cast<int32_t>(0x80000000u);
  const int32_t ab = bits & 0x7FFFFFFF;
  const int32_t r = (ab + 0x3FFFF + ((ab >> 19) & 1)) & -0x80000;
  int32_t out = (r & -0x00800000) | ptab[(r >> 19) & 15];
  if (ab < slfp::kI32Lo) out = (ab == 0) ? 0 : slfp::kI32PseudoZero;
  else if (ab < slfp::kI32Eighth) out = slfp::kI32Eighth;
  if (ab > slfp::kI32ClampSlfp) out = slfp::kI32ClampSlfp;
  return slfp::bf16_bits(__int_as_float(out | sign));
}

// epilogue value of sums v with column parameters a, b, then the quantize
template <bool kFtz>
__device__ __forceinline__ uint32_t epi_q(float v, float a, float b,
                                          float recip, const int32_t* ptab) {
  return chain_q<kFtz>(epi_value<kFtz>(v, a, b, nullptr), recip, ptab);
}

// The mainloop of one chunk: ``steps`` K steps from the ring, each up to 4
// k16 slabs of m64n128k16 wgmmas into acc.  load_a(stage, step, slabs, fr)
// fills the A fragments of the warp's 16 rows; ``kdim`` is the K of one
// tap (for the slabs of a ragged last step); the B tile of the step sits at
// b_off in its stage, and this warpgroup's 128 columns at col_off bytes
// past it.
template <class LoadA>
__device__ __forceinline__ void mainloop(float (&acc)[64], int steps,
                                         int steps_per_tap, int kdim,
                                         uint32_t& it, const Params& p,
                                         uint8_t* ring, uint32_t full0,
                                         uint32_t empty0, int b_off,
                                         int col_off, LoadA load_a) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int step = 0; step < steps; ++step, ++it) {
    const int slot = it % p.stages;
    gemm::mbar_wait(full0 + 8 * slot, (it / p.stages) & 1);
    uint8_t* stage = ring + slot * p.stage_bytes;
    const int k0 = (step % steps_per_tap) * kBK;
    const int slabs = min(4, (kdim - k0 + 15) / 16);
    const uint32_t b_u = gemm::smem_u32(stage + b_off) + col_off;
    // a full step compiles to four unconditional wgmmas
    auto mma = [&](auto full) {
      const int sl = decltype(full)::value ? 4 : slabs;
      uint32_t fr[4][4];
      load_a(stage, step, sl, fr);
#pragma unroll
      for (int i = 0; i < 64; ++i) gemm::fence_operand(acc[i]);
      gemm::wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (s < sl) gemm::wgmma_rs<1>(acc, fr[s], gemm::b_desc(b_u, s, false));
      gemm::wgmma_commit();
    };
    if (slabs == 4)
      mma(std::true_type());
    else
      mma(std::false_type());
    gemm::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 64; ++i) gemm::fence_operand(acc[i]);
    gemm::mbar_arrive(empty0 + 8 * slot);
  }
}

// A fragments of k16 slabs 0..sl-1 from an unswizzled bf16 matrix at
// shared address base, pitch ld elements: lane l names row ``row`` (its
// row of the ldmatrix) and column k0 + 16 s + 8 (l / 16)
__device__ __forceinline__ void ldm_rows(uint32_t base, int row, int ld,
                                         int k0, int lane, int sl,
                                         uint32_t (&fr)[4][4]) {
  const uint32_t a = base + (row * ld + k0 + 8 * (lane >> 4)) * 2;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < sl) gemm::ldmatrix_x4(a + 32 * s, fr[s]);
}

template <bool kFtz>
__global__ void __launch_bounds__(kThreads, 1)
    chain_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap tw2,
                 const __grid_constant__ CUtensorMap tw3, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring =
      smem_raw + ((1024 - (gemm::smem_u32(smem_raw) & 1023)) & 1023);
  uint16_t* y1 = reinterpret_cast<uint16_t*>(ring + p.stages * p.stage_bytes);
  uint16_t* y2 = y1 + p.y1r * p.ld;
  const uint32_t full0 = gemm::smem_u32(y2 + p.p3 * p.ld);
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  // y1, then y2, complete in this block (split: both blocks' halves)
  const uint32_t ready0 = empty0 + 8 * kMaxStages;
  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int r0 = blockIdx.x * p.rows;
  const int ch1 = chunk_cols(p.t1), ch2 = chunk_cols(p.t2);
  const int ch3 = chunk_cols(p.t3);
  // split: block z of the pair computes columns [lo, hi) of every GEMM
  // and writes its halves of y1 and y2 into both blocks
  const uint32_t rank = blockIdx.z, partner = rank ^ 1;
  const int m_lo = rank * (p.m / p.split), m_hi = m_lo + p.m / p.split;
  const int c_lo = rank * (p.c / p.split), c_hi = c_lo + p.c / p.split;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      gemm::mbar_init(full0 + 8 * s, 1);
      gemm::mbar_init(empty0 + 8 * s, kConsumers);
    }
    gemm::mbar_init(ready0, p.split * (kConsumers / 32));
    gemm::mbar_init(ready0 + 8, p.split * (kConsumers / 32));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // y1's padding (and everything else) starts at zero, before the partner
  // may write into it
  if (tid < kConsumers) {
    uint4* z = reinterpret_cast<uint4*>(y1);
    const int n = p.y1r * p.ld / 8;
    for (int i = tid; i < n; i += kConsumers) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if (p.split > 1) cluster_sync();

  if (tid >= kConsumers) {
    // ------------------------------------------------ producer: one lane
    if (tid != kConsumers) return;
    const uint32_t ring_u = gemm::smem_u32(ring);
    uint32_t it = 0;
    // wait for a free slot, then load the step's x tiles (conv1) and
    // weight boxes [64 k x 64 n] of columns n0.. (those left of N)
    auto step = [&](const CUtensorMap* map, int n0, int cols, int ncols,
                    int krow, int kx) {
      const int slot = it % p.stages;
      gemm::mbar_wait(empty0 + 8 * slot, ((it / p.stages) & 1) ^ 1);
      const uint32_t base = ring_u + slot * p.stage_bytes;
      const uint32_t full = full0 + 8 * slot;
      const long long xrow0 =
          static_cast<long long>(img) * p.h * p.w +
          static_cast<long long>(r0 - 1) * p.w;
      int tiles = 0, boxes = 0;
      if (kx >= 0)
        for (int t = 0; t < p.t1; ++t) {
          const long long row = xrow0 + 64 * t;
          tiles += row + 64 > 0 && row < p.pixels;
        }
      for (int j = 0; j < cols / 64; ++j) boxes += n0 + 64 * j < ncols;
      gemm::mbar_arrive_tx(full, (tiles + boxes) * kXTile);
      if (kx >= 0)
        for (int t = 0; t < p.t1; ++t) {
          const long long row = xrow0 + 64 * t;
          if (row + 64 > 0 && row < p.pixels)
            gemm::tma_load_2d(base + t * kXTile, &tx, full, kx,
                              static_cast<int>(row));
        }
      const uint32_t b = base + (kx >= 0 ? p.t1 * kXTile : 0);
      for (int j = 0; j < cols / 64; ++j)
        if (n0 + 64 * j < ncols)
          gemm::tma_load_2d(b + j * kXTile, map, full, n0 + 64 * j, krow);
      ++it;
    };
    for (int n0 = m_lo; n0 < m_hi; n0 += ch1)
      for (int k0 = 0; k0 < p.c; k0 += kBK) step(&tw1, n0, ch1, m_hi, k0, k0);
    for (int n0 = m_lo; n0 < m_hi; n0 += ch2)
      for (int tap = 0; tap < 9; ++tap)
        for (int k0 = 0; k0 < p.m; k0 += kBK)
          step(&tw2, n0, ch2, m_hi, tap * p.m + k0, -1);
    for (int n0 = c_lo; n0 < c_hi; n0 += ch3)
      for (int k0 = 0; k0 < p.m; k0 += kBK)
        step(&tw3, n0, ch3, c_hi, k0, -1);
    return;
  }

  // --------------------------------------------- consumer warpgroups
  const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
  // this lane's row of an ldmatrix within the warpgroup's 64
  const int lrow = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t y1_u = gemm::smem_u32(y1), y2_u = gemm::smem_u32(y2);
  const int r_eff = min(p.rows, p.h - r0);
  uint32_t it = 0;
  float acc[64];
#ifdef CHAIN_PHASES
  long long t_mark = clock64();
#endif

  __shared__ int32_t ptab[16];
  if (tid < 16) ptab[tid] = slfp::p_table(tid + ((slfp::kMlMagic >> tid) & 1));
  gemm::named_bar_sync(1, kConsumers);   // ptab
  // every consumer warp of both blocks has written its part of y1 (k = 0)
  // or y2 (k = 1); split: into both blocks
  auto ready = [&](int k) {
    if (p.split == 1) {
      gemm::named_bar_sync(1, kConsumers);
      return;
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive_cluster(ready0 + 8 * k);
      mbar_arrive_cluster(mapa(ready0 + 8 * k, partner));
    }
    mbar_wait_cluster(ready0 + 8 * k, 0);
  };

  // ---- conv1: y1 = Q2(relu(fma(x @ W1, a1, b1))) on the padded pitch ----
  {
    const int rt = wg % p.t1, cw = (wg / p.t1) * 128;
    for (int n0 = m_lo; n0 < m_hi; n0 += ch1) {
      mainloop(acc, (p.c + kBK - 1) / kBK, 1 << 30, p.c, it, p, ring, full0,
               empty0, p.t1 * kXTile, cw * 128,
               [&](uint8_t* stage, int, int sl, uint32_t(&fr)[4][4]) {
                 const uint32_t a =
                     gemm::smem_u32(stage + rt * kXTile + lrow * 128);
#pragma unroll
                 for (int s = 0; s < 4; ++s)
                   if (s < sl)
                     gemm::ldmatrix_x4(
                         a + (((2 * s + (lane >> 4)) ^ (lane & 7)) << 4),
                         fr[s]);
               });
      PHASE(1)
      // every column of the chunk left of N (always at ResNet-50's widths):
      // the unrolled loops below then hold no branch
      const bool full = n0 + cw + 128 <= m_hi;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = rt * 64 + 16 * warp + g + 8 * hr;   // band+halo pixel
        if (i >= p.p1) continue;
        const int iy = r0 - 1 + i / p.w;
        uint16_t* dst = y1 + ((i / p.w) * p.wp + i % p.w + 1) * p.ld;
        if (iy < 0 || iy >= p.h) continue;   // padding: y1 is zero there
        // the same row in the partner block
        const uint32_t far =
            p.split > 1 ? mapa(gemm::smem_u32(dst), partner) : 0u;
        auto body = [&](auto all) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = n0 + cw + 8 * j + 2 * q;
            if (!decltype(all)::value && col >= m_hi) continue;
            const float2 a =
                __ldg(reinterpret_cast<const float2*>(p.a1 + col));
            const float2 b =
                __ldg(reinterpret_cast<const float2*>(p.b1 + col));
            const uint32_t v =
                epi_q<kFtz>(acc[4 * j + 2 * hr], a.x, b.x, p.recip2, ptab) |
                (epi_q<kFtz>(acc[4 * j + 2 * hr + 1], a.y, b.y, p.recip2,
                             ptab) << 16);
            *reinterpret_cast<uint32_t*>(dst + col) = v;
            if (p.split > 1) st_cluster(far + 2 * col, v);
          }
        };
        if (full)
          body(std::true_type());
        else
          body(std::false_type());
      }
      PHASE(2)
    }
  }
  ready(0);

  // ---- conv2: nine shifted GEMMs over y1 -> y2 = Q3(relu(fma(., a2, b2)))
  {
    const int rt = wg % p.t2, cw = (wg / p.t2) * 128;
    const int kst = (p.m + kBK - 1) / kBK;
    // rows past the band's read row p2 - 1 (their sums are dropped)
    const int row = min(rt * 64 + lrow, p.p2 - 1);
    for (int n0 = m_lo; n0 < m_hi; n0 += ch2) {
      mainloop(acc, 9 * kst, kst, p.m, it, p, ring, full0, empty0, 0,
               cw * 128,
               [&](uint8_t*, int step, int sl, uint32_t(&fr)[4][4]) {
                 const int tap = step / kst;
                 ldm_rows(y1_u, row + (tap / 3) * p.wp + tap % 3, p.ld,
                          (step % kst) * kBK, lane, sl, fr);
               });
      PHASE(3)
      const bool full = n0 + cw + 128 <= m_hi;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = rt * 64 + 16 * warp + g + 8 * hr;   // padded pitch
        const int r = i / p.wp, c = i % p.wp;
        if (i >= p.p2 || c >= p.w) continue;             // padding columns
        uint16_t* dst = y2 + (r * p.w + c) * p.ld;
        const uint32_t far =
            p.split > 1 ? mapa(gemm::smem_u32(dst), partner) : 0u;
        auto body = [&](auto all) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = n0 + cw + 8 * j + 2 * q;
            if (!decltype(all)::value && col >= m_hi) continue;
            const float2 a =
                __ldg(reinterpret_cast<const float2*>(p.a2 + col));
            const float2 b =
                __ldg(reinterpret_cast<const float2*>(p.b2 + col));
            const uint32_t v =
                epi_q<kFtz>(acc[4 * j + 2 * hr], a.x, b.x, p.recip3, ptab) |
                (epi_q<kFtz>(acc[4 * j + 2 * hr + 1], a.y, b.y, p.recip3,
                             ptab) << 16);
            *reinterpret_cast<uint32_t*>(dst + col) = v;
            if (p.split > 1) st_cluster(far + 2 * col, v);
          }
        };
        if (full)
          body(std::true_type());
        else
          body(std::false_type());
      }
      PHASE(4)
    }
  }
  ready(1);

  // ---- conv3: y3 = relu(fma(y2 @ W3, a3, b3) + identity) -> raw, q ------
  {
    const int rt = wg % p.t3, cw = (wg / p.t3) * 128;
    const int kst = (p.m + kBK - 1) / kBK;
    const int row = min(rt * 64 + lrow, p.p3 - 1);
    long long pix[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = rt * 64 + 16 * warp + g + 8 * hr;
      pix[hr] = i < p.p3 && i / p.w < r_eff
                    ? (static_cast<long long>(img) * p.h + r0 + i / p.w) *
                              p.w + i % p.w
                    : -1;
    }
    for (int n0 = c_lo; n0 < c_hi; n0 += ch3) {
      // this chunk's identity, loaded ahead of its mainloop
      uint32_t id[16][2];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + cw + 8 * j + 2 * q;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          id[j][hr] = pix[hr] >= 0 && col < p.c
                          ? __ldg(reinterpret_cast<const uint32_t*>(
                                p.idn + pix[hr] * p.c + col))
                          : 0u;
      }
      mainloop(acc, kst, kst, p.m, it, p, ring, full0, empty0, 0, cw * 128,
               [&](uint8_t*, int step, int sl, uint32_t(&fr)[4][4]) {
                 ldm_rows(y2_u, row, p.ld, step * kBK, lane, sl, fr);
               });
      PHASE(5)
      const bool full = n0 + cw + 128 <= c_hi;
      // what to emit and whether every column counts, as constants of the
      // unrolled loop
      auto body = [&](auto all, auto er, auto eq) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (pix[hr] < 0) continue;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = n0 + cw + 8 * j + 2 * q;
            if (!decltype(all)::value && col >= c_hi) continue;
            const float2 a =
                __ldg(reinterpret_cast<const float2*>(p.a3 + col));
            const float2 b =
                __ldg(reinterpret_cast<const float2*>(p.b3 + col));
            const float r0v = slfp::bf16_to_float(id[j][hr] & 0xFFFF);
            const float r1v = slfp::bf16_to_float(id[j][hr] >> 16);
            const float v0 =
                epi_value<kFtz>(acc[4 * j + 2 * hr], a.x, b.x, &r0v);
            const float v1 =
                epi_value<kFtz>(acc[4 * j + 2 * hr + 1], a.y, b.y, &r1v);
            const long long off = pix[hr] * p.c + col;
            if (decltype(er)::value) {
              *reinterpret_cast<uint32_t*>(p.raw + off) =
                  slfp::bf16_bits(v0) |
                  (static_cast<uint32_t>(slfp::bf16_bits(v1)) << 16);
            }
            if (decltype(eq)::value) {
              *reinterpret_cast<uint32_t*>(p.q + off) =
                  chain_q<kFtz>(v0, p.recip_next, ptab) |
                  (chain_q<kFtz>(v1, p.recip_next, ptab) << 16);
            }
          }
        }
      };
      using T = std::true_type;
      using F = std::false_type;
      if (p.raw != nullptr && p.q != nullptr) {
        if (full) body(T(), T(), T()); else body(F(), T(), T());
      } else if (p.raw != nullptr) {
        if (full) body(T(), T(), F()); else body(F(), T(), F());
      } else {
        if (full) body(T(), F(), T()); else body(F(), F(), T());
      }
      PHASE(6)
    }
  }
}

}  // namespace

extern "C" int slfp_bottleneck_chain(
    const void* xq, const void* identity, const void* w1, const void* w2,
    const void* w3, const void* a1, const void* b1, const void* a2,
    const void* b2, const void* a3, const void* b3, void* raw, void* q,
    int n, int h, int w, int c, int m, int rows, int split, float recip2,
    float recip3, float recip_next, int ftz, void* stream) {
  const Geometry g = chain_geometry(w, m, rows);
  if (n <= 0 || h <= 0 || w <= 0 || rows <= 0 || c % 16 || m % 16 ||
      (split != 1 && split != 2) || c % (16 * split) || m % (16 * split) ||
      g.t1 > kMaxTiles || g.t2 > kMaxTiles || g.t3 > kMaxTiles ||
      g.smem > kSmemLimit ||
      (raw == nullptr && q == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tx, tw1, tw2, tw3;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t pixels = static_cast<uint64_t>(n) * h * w;
  if (!gemm::encode_2d(&tx, xq, bf, c, pixels, 2ULL * c, 64, 64, true) ||
      !gemm::encode_2d(&tw1, w1, bf, m, c, 2ULL * m, 64, 64, true) ||
      !gemm::encode_2d(&tw2, w2, bf, m, 9ULL * m, 2ULL * m, 64, 64, true) ||
      !gemm::encode_2d(&tw3, w3, bf, c, m, 2ULL * c, 64, 64, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.idn = static_cast<const uint16_t*>(identity);
  p.a1 = static_cast<const float*>(a1);
  p.b1 = static_cast<const float*>(b1);
  p.a2 = static_cast<const float*>(a2);
  p.b2 = static_cast<const float*>(b2);
  p.a3 = static_cast<const float*>(a3);
  p.b3 = static_cast<const float*>(b3);
  p.raw = static_cast<uint16_t*>(raw);
  p.q = static_cast<uint16_t*>(q);
  p.pixels = static_cast<long long>(pixels);
  p.h = h;
  p.w = w;
  p.c = c;
  p.m = m;
  p.rows = rows;
  p.recip2 = recip2;
  p.recip3 = recip3;
  p.recip_next = recip_next;
  p.wp = g.wp;
  p.p1 = g.p1;
  p.p2 = g.p2;
  p.p3 = g.p3;
  p.t1 = g.t1;
  p.t2 = g.t2;
  p.t3 = g.t3;
  p.ld = g.ld;
  p.y1r = g.y1r;
  p.stage_bytes = g.stage_bytes;
  p.stages = g.stages;
  p.split = split;
  auto kernel = ftz ? chain_kernel<true> : chain_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // a pair of blocks splitting a band's columns runs as a cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((h + rows - 1) / rows),
                     static_cast<unsigned>(n), static_cast<unsigned>(split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(g.smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(split);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tx, tw1, tw2, tw3, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
