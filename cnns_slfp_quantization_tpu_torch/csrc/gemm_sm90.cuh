// The Hopper GEMM mainloop shared by K2 (qmm.cu) and K4 (fused_matmul.cu):
// sums of a [M, K] x [K, N] product in float32 registers, for an epilogue
// that each kernel supplies.
//
//   A  rows of x, bf16 or f32, at a row pitch (a plain 2-D tile) or through
//      the row offsets b*sb + i*sh + j*sw of a strided NHWC view; quantized
//      on the way to the tensor cores (slfp::act_bf16_bits, signed or
//      nonneg) or only rounded to bf16.
//   B  the weights, bf16 values or uint8 SLFP<3,4> codes, stored [K, N] or
//      [N, K].
//
// Design (sm_90a).  A persistent grid, one or two blocks per SM (as many as
// the registers and shared memory let in), walks work items (row tile,
// column tile, K split).  A block is 1 or 2 consumer warpgroups
// (64 rows each: BM 64 or 128) and one producer warp.
//
// - The producer keeps a ring of >= 3 stages of 64-deep K steps full, each
//   stage guarded by a "full" and an "empty" mbarrier.  Plain 2-D tiles go
//   by TMA (cp.async.bulk.tensor, one lane): x rows at a pitch that is a
//   multiple of 16 bytes, bf16 weights, uint8 weights whose row length is a
//   multiple of 16.  The rest goes by cp.async with zero fill, from all 32
//   lanes, as a second route inside the same kernel: x through a strided
//   view (16-byte copies; the row offsets of a tile are computed once), and
//   uint8 rows whose length is a multiple of 8 but not of 16 (8-byte
//   copies).  A lane arrives on a stage's full barrier once its copies of
//   that stage have landed, up to stages - 1 stages behind the issue.
// - x lands in the 128-byte-swizzled layout TMA writes, 128 bytes of a row
//   a stage (f32 x takes two stages a K step).  Each consumer thread loads
//   its part of the wgmma A fragment straight from it (ldmatrix for bf16
//   x, 8-byte loads for f32), applies the quantize in registers and hands
//   the fragment to wgmma.mma_async in its A-from-registers form: x is
//   read and quantized once per column tile, and the plan makes a column
//   tile as wide as N up to N = 128 (64 wide where that pads N less or
//   where the epilogue reads a residual).
//   (Tiles of 256 columns, which would quantize x once up to N = 256,
//   measured slower on the H100: two warpgroups' 128 accumulators a thread
//   spill at the 168 registers a 288-thread block allows, and one
//   warpgroup leaves an SM too few warps for the epilogue.)
// - bf16 weights land by TMA in the layout wgmma reads B from: 128-byte
//   swizzle, K-major for [N, K] storage, N-major (transposed B) for [K, N].
//   uint8 codes land raw; the consumers decode them through a 256-entry
//   table of bf16 patterns in shared memory into a B tile of exactly that
//   layout, so that codes and bf16 values of the same weights enter the
//   same MMAs in the same order.
// - Per K step each warpgroup issues four m64nBNk16 wgmmas (BN 64 or 128)
//   into f32 accumulators in registers, waits for them and releases the
//   stage; the k16 slabs of a ragged last step that hold no K are skipped
//   (K = 16 is one slab).  The wgmmas of one step are not overlapped with
//   the next step's quantize: a second set of A fragments made the kernel
//   spill and measured slower on the H100.  The epilogue stages 32 columns
//   at a time through shared memory so that each thread finishes 8
//   consecutive channels of a row with 16-byte loads and stores; what it
//   reads besides the sums (K2's residual) is loaded for the whole tile
//   before the mainloop.  Meanwhile the producer fills the ring for the
//   next item.
// - Split-K (small M): the K steps of a tile are cut into whole chunks of
//   64; each split writes its f32 sums to a workspace [split, M, N], and a
//   second pass adds the splits in split order and runs the epilogue once.
//   No float atomics: two launches give the same bits.
//
// The tile plan (bm, bn, split, stages, smem) comes from the host
// (kernels/_gemm_plan.py) and depends on M, K, N and whether the epilogue
// reads a residual, never on the weights' dtype.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

#include "slfp.cuh"

namespace gemm {

constexpr int kBK = 64;             // K step: 128 bytes of bf16
constexpr int kStgCols = 32;        // epilogue columns staged at a time
constexpr int kStgPitch = 40;       // floats per staged row
constexpr int kMaxSmem = 232448;    // 227 KB, the H100's per-block limit

struct Problem {
  long long m;
  int k, n;
  // A
  const void* x;
  long long hw;                 // rows per image (H * W) of the view
  int wdim;                     // W
  long long sb, sh, sw;         // element strides of the view's B, H, W
  long long a_pitch;            // element pitch of a plain 2-D x, else 0
  bool a_tma;
  bool quant, nonneg;           // the transform of A
  float recip;
  // B
  const void* w;
  bool w_u8, w_nk, b_tma;
  // plan
  int split, steps_per_split, stages;
  float* ws;                    // split > 1: f32 partials [split, M, N]
};

// Offsets into the block's shared memory (from a 1024-byte-aligned base)
struct Layout {
  uint32_t a_bytes, stage_bytes, dec, stg, rows, lut, full, empty, total;
};

// Mirrored by kernels/_gemm_plan.py::smem_bytes.  A stage holds 128 bytes
// of each x row (64 k of bf16, or 32 k of f32: f32 x takes two stages a K
// step) and a weight tile sized for bf16, whatever the call passes, so that
// the plan does not depend on the weights' dtype.
__host__ __device__ inline Layout layout(int bm, int bn, int stages) {
  Layout l;
  l.a_bytes = bm * 128;
  l.stage_bytes = l.a_bytes + kBK * bn * 2;
  l.dec = stages * l.stage_bytes;
  l.stg = l.dec + kBK * bn * 2;
  l.rows = l.stg + (bm / 64) * 64 * kStgPitch * 4;
  l.lut = l.rows + bm * 8;
  l.full = l.lut + 512;
  l.empty = l.full + 8 * stages;
  l.total = l.empty + 8 * stages + 1024;   // + alignment slack
  return l;
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes (cg) or 8 bytes (ca), zero-filled when ``bytes`` is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n (0..7) of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// four 8x8 b16 matrices, one row address per lane (lanes 8i..8i+7: matrix i)
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// keeps the compiler from moving reads of an accumulator across the wait
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory matrix descriptor of the B tile for k16 slab s: 128-byte
// swizzle; K-major ([N, K] storage, rows of 64 k at 128 bytes, 8-row groups
// 1024 bytes apart) or N-major ([K, N] storage: 64-column boxes of 64 k
// rows, 8192 bytes apart (leading offset), 8-row groups 1024 bytes apart
// (stride offset)).
__device__ __forceinline__ uint64_t b_desc(uint32_t base, int s, bool nk) {
  const uint32_t addr = nk ? base + 32 * s : base + 2048 * s;
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(nk ? 1 : 8192 >> 4) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// wgmma m64nNk16 (N = 64, 128), f32 += bf16 x bf16, A from registers, B by
// descriptor; kTnsp = 1 reads B N-major
template <int kTnsp>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(kTnsp));
}

template <int kTnsp>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(kTnsp));
}

// ------------------------------------------------------- operand handling

__device__ __forceinline__ long long row_offset(const Problem& p,
                                                long long m) {
  const long long b = m / p.hw;
  const long long r = m - b * p.hw;
  const long long i = r / p.wdim;
  const long long j = r - i * p.wdim;
  return b * p.sb + i * p.sh + j * p.sw;
}

// two bf16 x values (low = lower k) -> two bf16 A values
__device__ __forceinline__ uint32_t xform(uint32_t v, const Problem& p) {
  if (!p.quant) return v;
  const uint32_t lo = slfp::act_bf16_bits(
      slfp::bf16_to_float(static_cast<uint16_t>(v & 0xFFFF)), p.recip, 8,
      p.nonneg);
  const uint32_t hi = slfp::act_bf16_bits(
      slfp::bf16_to_float(static_cast<uint16_t>(v >> 16)), p.recip, 8,
      p.nonneg);
  return lo | (hi << 16);
}

// two f32 x values -> two bf16 A values
__device__ __forceinline__ uint32_t xform(float2 f, const Problem& p) {
  const uint32_t lo = p.quant ? slfp::act_bf16_bits(f.x, p.recip, 8, p.nonneg)
                              : slfp::bf16_bits(f.x);
  const uint32_t hi = p.quant ? slfp::act_bf16_bits(f.y, p.recip, 8, p.nonneg)
                              : slfp::bf16_bits(f.y);
  return lo | (hi << 16);
}

// This thread's wgmma A fragments for the first ``slabs`` k16 slabs of a
// K step, from the swizzled x tile (f32 x: its halves a0 and a1, 32 k
// each): rows r0 and r0 + 8 (r0 % 8 == g), columns 16s + 2q (+1) and
// 16s + 2q + 8 (+1), packed two bf16 a register, lower k low.  bf16 x: one ldmatrix a slab, lane l
// addressing row lr = (r0 - g) + l % 8 + 8 * (l / 8 % 2), 16-byte chunk
// 2s + l / 16.
template <bool kXf32>
__device__ __forceinline__ void load_a(const uint8_t* a0, const uint8_t* a1,
                                       int r0, int lr, int g, int q,
                                       int lane, int slabs, const Problem& p,
                                       uint32_t (&fr)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s >= slabs) continue;
    if (!kXf32) {
      uint32_t raw[4];
      ldmatrix_x4(smem_u32(a0 + lr * 128) +
                      (((2 * s + (lane >> 4)) ^ (lane & 7)) << 4),
                  raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) fr[s][i] = xform(raw[i], p);
    } else {
      // a 16-byte chunk holds 4 floats
      const uint8_t* row0 = (s < 2 ? a0 : a1) + r0 * 128;
      const uint8_t* row1 = row0 + 8 * 128;
      const int ca = 4 * (s & 1) + (q >> 1), cb = ca + 2;
      const int byte = 8 * (q & 1);
      fr[s][0] = xform(*reinterpret_cast<const float2*>(
                           row0 + ((ca ^ g) << 4) + byte), p);
      fr[s][1] = xform(*reinterpret_cast<const float2*>(
                           row1 + ((ca ^ g) << 4) + byte), p);
      fr[s][2] = xform(*reinterpret_cast<const float2*>(
                           row0 + ((cb ^ g) << 4) + byte), p);
      fr[s][3] = xform(*reinterpret_cast<const float2*>(
                           row1 + ((cb ^ g) << 4) + byte), p);
    }
  }
}

__device__ __forceinline__ uint32_t decode_pair(const uint16_t* lut,
                                                uint32_t bytes2) {
  return lut[bytes2 & 0xFF] |
         (static_cast<uint32_t>(lut[(bytes2 >> 8) & 0xFF]) << 16);
}

// The raw uint8 tile of a stage (rows of BN codes along n for [K, N]
// storage, rows of 64 codes along k for [N, K]) decoded into the bf16 B
// tile in the layout TMA gives bf16 weights: 16 codes a thread at a time,
// those of the first ``slabs`` k16 slabs.
template <int kBN>
__device__ __forceinline__ void decode_tile(const uint8_t* raw, uint8_t* dec,
                                            const uint16_t* lut, bool nk,
                                            int slabs, int ctid,
                                            int nthreads) {
  for (int piece = ctid; piece < kBK * kBN / 16; piece += nthreads) {
    const uint8_t* src;
    uint8_t* row;
    int c, swz;
    if (nk) {
      const int n = piece >> 2, k16 = piece & 3;
      if (k16 >= slabs) continue;
      src = raw + n * kBK + 16 * k16;
      row = dec + n * 128;
      c = 2 * k16;
      swz = n & 7;
    } else {
      const int k = piece / (kBN / 16), n16 = piece % (kBN / 16);
      if (k >= 16 * slabs) continue;
      src = raw + k * kBN + 16 * n16;
      row = dec + (n16 >> 2) * 8192 + k * 128;
      c = 2 * (n16 & 3);
      swz = k & 7;
    }
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(row + ((c ^ swz) << 4)) =
        make_uint4(decode_pair(lut, u.x), decode_pair(lut, u.x >> 16),
                   decode_pair(lut, u.y), decode_pair(lut, u.y >> 16));
    *reinterpret_cast<uint4*>(row + (((c + 1) ^ swz) << 4)) =
        make_uint4(decode_pair(lut, u.z), decode_pair(lut, u.z >> 16),
                   decode_pair(lut, u.w), decode_pair(lut, u.w >> 16));
  }
}

// ---------------------------------------------------------------- kernel

// Epi: a functor that finishes 8 consecutive channels n..n+7 of row m from
// their f32 sums (n + 8 <= N: N is a multiple of 8), with
//   Pre prefetch(long long m, int n) const: what it reads from device
//       memory besides the sums, loaded ahead;
//   void operator()(long long m, int n, const float (&v)[8],
//                   const Pre& pre) const.

// The Pre of this thread's two groups of the 32-column chunk at n0:
// groups t and t + 128 of a warpgroup's 64 rows x 4 groups of 8 channels
template <class Epi>
__device__ __forceinline__ void epi_prefetch(const Epi& epi, const Problem& p,
                                             long long mw, int n0, int t,
                                             typename Epi::Pre (&out)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gi = t + 128 * i;
    const long long m = mw + gi / (kStgCols / 8);
    const int n = n0 + 8 * (gi % (kStgCols / 8));
    out[i] = m < p.m && n < p.n ? epi.prefetch(m, n) : typename Epi::Pre();
  }
}

// Blocks an SM keeps in flight: two where the accumulators leave registers
// for two (the plan sizes their shared memory for two as well), else one
template <int kWG, int kBN>
constexpr int min_blocks() {
  return (kBN == 64 || (kWG == 1 && kBN == 128)) ? 2 : 1;
}

template <int kWG, int kBN, bool kXf32, class Epi>
__global__ void __launch_bounds__(128 * kWG + 32, (min_blocks<kWG, kBN>()))
    gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, const Problem p,
                const Epi epi) {
  constexpr int kBM = 64 * kWG;
  constexpr int kNC = 128 * kWG;   // consumer threads
  constexpr int kHalves = kXf32 ? 2 : 1;   // ring stages a K step
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = layout(kBM, kBN, p.stages);
  const int S = p.stages;
  const uint32_t full0 = smem_u32(smem + L.full);
  const uint32_t empty0 = smem_u32(smem + L.empty);
  uint16_t* lut = reinterpret_cast<uint16_t*>(smem + L.lut);
  const int tid = threadIdx.x;
  const bool cp_route = !p.a_tma || !p.b_tma;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // the TMA lane's arrive (with its bytes), and one arrive per
      // producer lane where cp.async feeds the stage
      mbar_init(full0 + 8 * s, cp_route ? 33 : 1);
      mbar_init(empty0 + 8 * s, kNC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (p.w_u8)
    for (int c = tid; c < 256; c += blockDim.x)
      lut[c] = slfp::decode_code_bf16(static_cast<uint8_t>(c));
  __syncthreads();

  const long long tiles_m = (p.m + kBM - 1) / kBM;
  const int tiles_n = (p.n + kBN - 1) / kBN;
  const int ksteps = (p.k + kBK - 1) / kBK;
  const long long items = tiles_m * tiles_n * p.split;

  if (tid >= kNC) {
    // ------------------------------------------------ producer warp
    const int lane = tid - kNC;
    long long* rows = reinterpret_cast<long long*>(smem + L.rows);
    const uint8_t* w8 = static_cast<const uint8_t*>(p.w);
    uint32_t it = 0;
    int pend = 0;   // cp.async stages issued and not yet acknowledged
    const int lag = S - kHalves;
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int sp = static_cast<int>(item % p.split);
      const long long t = item / p.split;
      const int n0 = static_cast<int>(t % tiles_n) * kBN;
      const long long m0 = (t / tiles_n) * kBM;
      const int ks0 = sp * p.steps_per_split;
      const int ks1 = min(ks0 + p.steps_per_split, ksteps);
      if (!p.a_tma) {
        __syncwarp();
        for (int r = lane; r < kBM; r += 32)
          rows[r] = m0 + r < p.m ? row_offset(p, m0 + r) : -1;
        __syncwarp();
      }
      for (int ks = ks0; ks < ks1; ++ks) {
        const int k0 = ks * kBK;
        // f32 x: the step's two 32-k halves of x in two stages, the
        // weights with the first
        for (int h = 0; h < kHalves; ++h, ++it) {
          const int slot = it % S;
          mbar_wait(empty0 + 8 * slot, ((it / S) & 1) ^ 1);
          const uint32_t a_u = smem_u32(smem + slot * L.stage_bytes);
          const uint32_t b_u = a_u + L.a_bytes;
          const uint32_t full = full0 + 8 * slot;
          const bool with_b = h == 0;
          if (lane == 0) {
            uint32_t tx = 0;
            if (p.a_tma) tx += kBM * 128;
            if (with_b && p.b_tma) tx += kBK * kBN * (p.w_u8 ? 1 : 2);
            if (tx)
              mbar_arrive_tx(full, tx);
            else
              mbar_arrive(full);
            if (p.a_tma)
              tma_load_2d(a_u, &tma_a, full, k0 + 32 * h,
                          static_cast<int>(m0));
            if (with_b && p.b_tma) {
              if (p.w_nk)
                tma_load_2d(b_u, &tma_b, full, k0, n0);
              else if (p.w_u8)
                tma_load_2d(b_u, &tma_b, full, n0, k0);
              else
                for (int j = 0; j < kBN / 64; ++j)
                  tma_load_2d(b_u + j * 8192, &tma_b, full, n0 + 64 * j, k0);
            }
          }
          if (!p.a_tma) {
            // 8 chunks of 16 bytes a row: 8 bf16 or 4 f32 each
            constexpr int kE = kXf32 ? 4 : 2;
            for (int idx = lane; idx < kBM * 8; idx += 32) {
              const int r = idx >> 3, c = idx & 7;
              const int k = k0 + 32 * h + c * (16 / kE);
              const long long off = rows[r];
              const bool ok = off >= 0 && k < p.k;
              cp_async16(a_u + r * 128 + ((c ^ (r & 7)) << 4),
                         static_cast<const char*>(p.x) +
                             (ok ? (off + k) * kE : 0),
                         ok ? 16 : 0);
            }
          }
          if (with_b && !p.b_tma) {   // uint8 rows not a multiple of 16
            if (p.w_nk) {
              for (int idx = lane; idx < kBN * 8; idx += 32) {
                const int nn = idx >> 3, c = idx & 7;
                const int n = n0 + nn, k = k0 + 8 * c;
                const bool ok = n < p.n && k < p.k;
                cp_async8(b_u + nn * kBK + 8 * c,
                          w8 + (ok ? static_cast<long long>(n) * p.k + k : 0),
                          ok ? 8 : 0);
              }
            } else {
              for (int idx = lane; idx < kBK * (kBN / 8); idx += 32) {
                const int kk = idx / (kBN / 8), c = idx % (kBN / 8);
                const int k = k0 + kk, n = n0 + 8 * c;
                const bool ok = n < p.n && k < p.k;
                cp_async8(b_u + kk * kBN + 8 * c,
                          w8 + (ok ? static_cast<long long>(k) * p.n + n : 0),
                          ok ? 8 : 0);
              }
            }
          }
          if (cp_route) {
            cp_async_commit();
            // keep at most lag stages unacknowledged, so that the empty
            // wait above never waits on a stage (or on the partner of a
            // stage) this warp still holds
            if (++pend > lag) {
              cp_async_wait(lag);
              mbar_arrive(full0 + 8 * ((it - lag) % S));
              --pend;
            }
          }
        }
      }
    }
    if (cp_route) {
      cp_async_wait(0);
      for (; pend > 0; --pend) mbar_arrive(full0 + 8 * ((it - pend) % S));
    }
  } else {
    // ------------------------------------------- consumer warpgroups
    const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, q = lane % 4;
    const int r0 = 64 * wg + 16 * warp + g;
    const int lr = 64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
    float* stg = reinterpret_cast<float*>(smem + L.stg) + wg * 64 * kStgPitch;
    uint8_t* dec = smem + L.dec;
    constexpr int kChunks = kBN / kStgCols;
    uint32_t it = 0;
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int sp = static_cast<int>(item % p.split);
      const long long t_ = item / p.split;
      const int n0 = static_cast<int>(t_ % tiles_n) * kBN;
      const long long m0 = (t_ / tiles_n) * kBM;
      const int ks0 = sp * p.steps_per_split;
      const int ks1 = min(ks0 + p.steps_per_split, ksteps);

      const long long mw = m0 + 64 * wg;   // this warpgroup's first row
      // what the epilogue reads besides the sums (K2's residual), for the
      // whole tile at once, before the mainloop: 8 channels of a row for
      // each of this thread's two groups of each 32-column chunk
      typename Epi::Pre pre[kChunks][2];
      if (p.split == 1) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          epi_prefetch(epi, p, mw, n0 + c * kStgCols, t, pre[c]);
      }
      float acc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

      for (int ks = ks0; ks < ks1; ++ks, it += kHalves) {
        const int slot0 = it % S, slot1 = (it + kHalves - 1) % S;
        mbar_wait(full0 + 8 * slot0, (it / S) & 1);
        if (kXf32) mbar_wait(full0 + 8 * slot1, ((it + 1) / S) & 1);
        // the k16 slabs of this step that hold any of K (the rest of a
        // ragged last step is zeros: neither loaded, decoded nor summed)
        const int slabs = min(4, (p.k - ks * kBK + 15) / 16);
        const uint8_t* a0 = smem + slot0 * L.stage_bytes;
        uint32_t b_u = smem_u32(a0 + L.a_bytes);
        if (p.w_u8) {
          named_bar_sync(1, kNC);   // every warpgroup is done with it
          decode_tile<kBN>(a0 + L.a_bytes, dec, lut, p.w_nk, slabs, tid, kNC);
          fence_proxy_async();      // generic writes -> wgmma's reads
          named_bar_sync(1, kNC);
          b_u = smem_u32(dec);
        }
        // a full step (every slab holds K) compiles to four unconditional
        // wgmmas: conditional ones measured slower on the H100
        auto mma = [&](auto full) {
          const int sl = decltype(full)::value ? 4 : slabs;
          uint32_t fr[4][4];
          load_a<kXf32>(a0, smem + slot1 * L.stage_bytes, r0, lr, g, q,
                        lane, sl, p, fr);
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) fence_operand(acc[i]);
          wgmma_fence();
          if (p.w_nk) {
#pragma unroll
            for (int s = 0; s < 4; ++s)
              if (s < sl) wgmma_rs<0>(acc, fr[s], b_desc(b_u, s, true));
          } else {
#pragma unroll
            for (int s = 0; s < 4; ++s)
              if (s < sl) wgmma_rs<1>(acc, fr[s], b_desc(b_u, s, false));
          }
          wgmma_commit();
        };
        if (slabs == 4)
          mma(std::true_type());
        else
          mma(std::false_type());
        wgmma_wait0();
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) fence_operand(acc[i]);
        mbar_arrive(empty0 + 8 * slot0);
        if (kXf32) mbar_arrive(empty0 + 8 * slot1);
      }

      // epilogue: 32 columns at a time through shared memory, for 16-byte
      // loads and stores of 8 consecutive channels of a row; accumulator
      // element 4j + e holds row 16*warp + g (+8 for e >= 2), column
      // 8j + 2q (+1 for odd e).  The chunk loop is not unrolled: only the
      // staging stores name accumulators (one unrolled branch per chunk),
      // so the epilogue's arithmetic is compiled once, not once a chunk.
#pragma unroll 1
      for (int c = 0; c < kChunks; ++c) {
        const int c0 = c * kStgCols;
        typename Epi::Pre cur[2];
        named_bar_sync(2 + wg, 128);
#pragma unroll
        for (int cc = 0; cc < kChunks; ++cc) {
          if (cc != c) continue;
          cur[0] = pre[cc][0];
          cur[1] = pre[cc][1];
#pragma unroll
          for (int jj = 0; jj < kStgCols / 8; ++jj) {
            const int j = cc * (kStgCols / 8) + jj;
            const int row = 16 * warp + g, col = 8 * jj + 2 * q;
            *reinterpret_cast<float2*>(stg + row * kStgPitch + col) =
                make_float2(acc[4 * j], acc[4 * j + 1]);
            *reinterpret_cast<float2*>(stg + (row + 8) * kStgPitch + col) =
                make_float2(acc[4 * j + 2], acc[4 * j + 3]);
          }
        }
        named_bar_sync(2 + wg, 128);
#pragma unroll
        for (int i = 0; i < 64 * (kStgCols / 8) / 128; ++i) {
          const int gi = t + 128 * i;
          const int row = gi / (kStgCols / 8), cg = gi % (kStgCols / 8);
          const long long m = mw + row;
          const int n = n0 + c0 + 8 * cg;
          if (m >= p.m || n >= p.n) continue;
          const float4 v0 =
              *reinterpret_cast<const float4*>(stg + row * kStgPitch + 8 * cg);
          const float4 v1 = *reinterpret_cast<const float4*>(
              stg + row * kStgPitch + 8 * cg + 4);
          if (p.split > 1) {
            float4* o = reinterpret_cast<float4*>(
                p.ws + (static_cast<long long>(sp) * p.m + m) * p.n + n);
            o[0] = v0;
            o[1] = v1;
          } else {
            const float v[8] = {v0.x, v0.y, v0.z, v0.w,
                                v1.x, v1.y, v1.z, v1.w};
            epi(m, n, v, cur[i]);
          }
        }
      }
    }
  }
}

// Split-K's second pass: the splits' partial sums added in split order,
// then the epilogue once, 8 channels of a row per thread.
template <class Epi>
__global__ void __launch_bounds__(256)
    splitk_reduce(const float* __restrict__ ws, int split, long long m, int n,
                  const Epi epi) {
  const long long groups = m * (n / 8);
  const long long plane = m * n;
  for (long long gi = blockIdx.x * 256LL + threadIdx.x; gi < groups;
       gi += static_cast<long long>(gridDim.x) * 256) {
    const long long row = gi / (n / 8);
    const int col = static_cast<int>(gi % (n / 8)) * 8;
    const float4* src = reinterpret_cast<const float4*>(ws + row * n + col);
    float4 a = __ldg(src), b = __ldg(src + 1);
    float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    for (int s = 1; s < split; ++s) {
      src = reinterpret_cast<const float4*>(ws + s * plane + row * n + col);
      a = __ldg(src);
      b = __ldg(src + 1);
      const float u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], u[e]);
    }
    epi(row, col, v, epi.prefetch(row, col));
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, through the CUDA runtime's
// entry-point query (no link against libcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &status);
#endif
    if (status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// a 2-D tensor map: ``outer`` rows of ``inner`` elements at ``pitch`` bytes,
// boxes of box_inner x box_outer, 128-byte swizzle or none; zero fill past
// the edges
inline bool encode_2d(CUtensorMap* map, const void* ptr,
                      CUtensorMapDataType dtype, uint64_t inner,
                      uint64_t outer, uint64_t pitch, uint32_t box_inner,
                      uint32_t box_outer, bool swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

template <int kWG, int kBN, bool kXf32, class Epi>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const Problem& p, const Epi& epi, int smem,
                   cudaStream_t stream) {
  constexpr int kThreads = 128 * kWG + 32;
  static bool attr = false;
  static int occ_smem = -1, occ_blocks = 1;   // blocks an SM holds at smem
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<kWG, kBN, kXf32, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  if (smem != occ_smem) {
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gemm_kernel<kWG, kBN, kXf32, Epi>, kThreads, smem);
    if (e != cudaSuccess) return e;
    occ_blocks = blocks > 0 ? blocks : 1;
    occ_smem = smem;
  }
  const long long items = ((p.m + 64 * kWG - 1) / (64 * kWG)) *
                          ((p.n + kBN - 1) / kBN) * p.split;
  const long long slots = static_cast<long long>(occ_blocks) * sm_count();
  const int grid = static_cast<int>(items < slots ? items : slots);
  gemm_kernel<kWG, kBN, kXf32, Epi>
      <<<grid, kThreads, smem, stream>>>(ta, tb, p, epi);
  return cudaGetLastError();
}

// Checks the plan, builds the tensor maps, launches the mainloop (and the
// split-K pass).  ``p`` carries the problem, the A transform and the plan's
// split and stages; bm, bn and smem are the rest of the plan.
template <bool kAllowF32, class Epi>
cudaError_t run(Problem p, bool x_f32, const Epi& epi, int bm, int bn,
                int smem, cudaStream_t stream) {
  if (p.m <= 0 || p.n <= 0) return cudaSuccess;
  const bool plan_ok =
      (bm == 64 || bm == 128) &&
      (bn == 64 || bn == 128) && p.split >= 1 &&
      p.stages >= 2 && p.stages <= 8 && smem <= kMaxSmem &&
      static_cast<int>(layout(bm, bn, p.stages).total) == smem &&
      (p.split == 1 || p.ws != nullptr) && (x_f32 ? kAllowF32 : true) &&
      p.k % 8 == 0 && p.n % 8 == 0;
  if (!plan_ok) return cudaErrorInvalidValue;
  const int ksteps = (p.k + kBK - 1) / kBK;
  p.steps_per_split = (ksteps + p.split - 1) / p.split;

  CUtensorMap ta, tb;
  memset(&ta, 0, sizeof(ta));
  memset(&tb, 0, sizeof(tb));
  const int xe = x_f32 ? 4 : 2;
  p.a_tma = p.a_pitch > 0 && (p.a_pitch * xe) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  if (p.a_tma &&
      !encode_2d(&ta, p.x,
                 x_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 p.k, p.m, p.a_pitch * xe, x_f32 ? 32 : 64, bm, true))
    return cudaErrorInvalidValue;
  const int we = p.w_u8 ? 1 : 2;
  const long long w_pitch = static_cast<long long>(p.w_nk ? p.k : p.n) * we;
  p.b_tma = w_pitch % 16 == 0 && reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
  if (!p.b_tma && !p.w_u8) return cudaErrorInvalidValue;
  if (p.b_tma) {
    const CUtensorMapDataType dt = p.w_u8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    bool ok;
    if (p.w_nk)
      ok = encode_2d(&tb, p.w, dt, p.k, p.n, w_pitch, 64, bn,
                            !p.w_u8);
    else if (p.w_u8)
      ok = encode_2d(&tb, p.w, dt, p.n, p.k, w_pitch, bn, 64, false);
    else
      ok = encode_2d(&tb, p.w, dt, p.n, p.k, w_pitch, 64, 64, true);
    if (!ok) return cudaErrorInvalidValue;
  }

  cudaError_t e;
#define GEMM_LAUNCH(WG, BN)                                                 \
  e = x_f32 ? launch<WG, BN, kAllowF32, Epi>(ta, tb, p, epi, smem, stream) \
            : launch<WG, BN, false, Epi>(ta, tb, p, epi, smem, stream)
  if (bm == 128 && bn == 64) {
    GEMM_LAUNCH(2, 64);
  } else if (bm == 128) {
    GEMM_LAUNCH(2, 128);
  } else if (bn == 64) {
    GEMM_LAUNCH(1, 64);
  } else {
    GEMM_LAUNCH(1, 128);
  }
#undef GEMM_LAUNCH
  if (e != cudaSuccess || p.split == 1) return e;
  const long long groups = p.m * (p.n / 8);
  long long blocks = (groups + 255) / 256;
  if (blocks > 8LL * sm_count()) blocks = 8LL * sm_count();
  splitk_reduce<Epi><<<static_cast<int>(blocks), 256, 0, stream>>>(
      p.ws, p.split, p.m, p.n, epi);
  return cudaGetLastError();
}

}  // namespace gemm
