// The bfloat16 design of the two ConvNeXt block kernels for Hopper (sm_90a):
// both products of the LN -> fc1 -> GELU -> fc2 -> gamma -> residual chain on
// the tensor cores (wgmma, bf16 in, float accumulate), weight tiles brought
// in by TMA while the products run.  ln_mlp.cu and convnext_block.cu differ
// only in how a row tile reaches the LayerNorm and where the shortcut comes
// from; everything else is here.
//
// One block = 288 threads = two consumer warpgroups + one producer warp
// (one thread of it starts every copy).  The ninth warp caps a thread at 168
// registers (three warps on one of the SM's four sub-partitions): enough up
// to C = 128; at C >= 256 (a 128-float accumulator) ptxas spills about 110
// words a thread and notes (C7512) that it serialises the wgmma there for
// want of registers.  Measured alternatives (PERF.md): setmaxnreg with a
// producer warpgroup is not taken up by ptxas here, and a block of exactly
// two warpgroups whose thread 0 starts the copies between its own products
// has no spill but lets the ring run dry.
//
//   rows      C <= 256: a block takes TM = 128 rows, 64 per consumer
//             warpgroup, all C output columns each.  C = 512: the (64, 512)
//             float accumulator does not fit one warpgroup's registers, so a
//             block takes TM = 64 rows and each warpgroup owns 256 output
//             columns; both compute the (64, 64) hidden chunk (the first
//             product is done twice there: that stage is bound by the weight
//             traffic of its few blocks, not by the tensor cores).
//   Xn        the normalised rows, bf16 in shared memory, in slabs of 64
//             channels: [C/64][TM][64], each row 128 bytes, written by
//             ordinary stores with the 128-byte swizzle that the wgmma
//             descriptor states (16-byte group g of row r sits at g ^ (r % 8)).
//   weights   walked in chunks of 64 hidden units.  Every tile that moves is
//             one *unit*: 64 rows x 64 bf16 (8 KB), one TMA box with the
//             128-byte swizzle.  A chunk is C/64 units of fc1.weight (rows
//             j0..j0+64, one unit per 64 input channels: the K slabs of the
//             first product) and then C/64 units of fc2.weight (one unit per
//             64 output columns, columns j0..j0+64: K of the second product).
//             Both nn.Linear layouts are K-major for wgmma's B operand, so
//             nothing is transposed.  Units go through a ring of 4-8 slots
//             with a full and an empty mbarrier per slot; the producer runs
//             ahead of the consumers by the depth of the ring.
//   products  H = Xn . W1[chunk]^T: A and B from shared memory, m64n64k16.
//             GELU(H + b1) stays in registers: the m64n64 accumulator
//             fragment, packed to bf16 pairs, is the A fragment of the
//             second product (as attention kernels do for P.V), so the
//             hidden activations never touch shared or device memory.
//             acc[nb] += G . W2[nb, chunk]^T: A from registers.
//   epilogue  + b2, * gamma, + shortcut with the rounding points of
//             pallas_mlp.py:63-73, bf16 pairs stored straight to device memory.
//
// Rounding points are those of the first version: LN statistics in float,
// bf16 after the normalisation, after scale, after shift, after each
// product, after each bias, after GELU, after gamma, residual add in bf16.
// One piece of arithmetic between them is not the first version's: GELU's
// tanh is tanh.approx.f32 (relative error about 2^-11, under the bf16
// half-ulp) where the first version called tanhf, so a single result can
// land one bf16 ulp away from the first version's.  tanhf costs 11-29 % of a
// launch here (PERF.md): GELU sits between the two products of the same
// warpgroup and nothing hides it.
//
// Every other width (Plan<CP, true>, the "wgmma_any" kernels): the same
// design at a channel width padded to CP = 64 ceil(C / 64) inside the kernel
// only; nothing is padded in device memory.  They replace the same TPU
// kernels (pallas_mlp.py:fused_ln_mlp, pallas_convnext.py:
// convnext_block_fused), which take any C and pad only rows and H, W.
//   weights   the maps have the real extents, (hidden, C) and (C, hidden),
//             so the part of a 64 x 64 box past them arrives as zeros
//             (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE); the mbarrier still counts
//             the whole 8 KB box.  The last hidden chunk may be partial: its
//             missing rows of W1 are zeros, b1 is read with a mask, so those
//             hidden units are GELU(0) = 0.
//   Xn        the channels past C are written as zeros, not left as they
//             are: shared memory is not cleared between blocks, and a NaN
//             bit pattern there times a zero weight is NaN.  The LayerNorm
//             divides by the real C, and ln_w / ln_b, b1, b2, gamma are read
//             with masks; stores are masked to the real C and rows.
//   columns   the warpgroups' split follows CP: 1 warpgroup across the
//             columns up to 256, 2 above, unevenly where CP / 64 is odd
//             (320: 3 + 2 blocks of 64); the producer sends only the units
//             of blocks that exist.
//   CP > 512  (nano 640, tiny / small 768, base 1024: 1x1 maps, M = batch
//             rows) the (64, CP) float accumulator does not fit a
//             warpgroup's registers, so the output columns are split over
//             SLICES blocks (blockIdx.y): each owns at most 8 blocks of 64
//             columns and recomputes the first product over the full CP for
//             them.  Each output column's sum over the hidden units is
//             complete in one block, in a fixed order, rounded once; nothing
//             crosses blocks.  These stages move more weight bytes than they
//             compute (4-48 row tiles for 132 SMs), so what bounds them is
//             the weight traffic through L2, which the split spreads over
//             twice the blocks; the recomputed product costs tensor-core
//             time that those stages have to spare.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "block_common.cuh"

namespace btsbot {
namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kConsumerThreads = 256;  // two warpgroups
constexpr int kBlockThreads = 288;     // + the producer warp
constexpr int kUnitBytes = 64 * 64 * 2;
constexpr int kMaxStages = 8;
constexpr int kMinStages = 4;  // C = 512 holds two units while it waits for two
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kSmemPerSm = 233472;  // bytes of one SM, 1 KB of each block reserved
constexpr int kBarrierBytes = (2 * kMaxStages + 1) * 8;
constexpr int kAlignSlack = 1024;  // the ring and Xn start on a 1024-byte line

constexpr int kMaxWidth = 1024;  // the widest C the bf16 kernels take

// CP: the channel width as the kernel lays it out (a multiple of 64).  ANY:
// the real width C <= CP and any hidden width that is a multiple of 8 come
// at run time (the "wgmma_any" kernels); without it C = CP and hidden is a
// multiple of 64 (the tuned kernels, C = 64 / 128 / 256 / 512), and every
// mask below folds away at compile time.
template <int CP_, bool ANY_ = false> struct Plan {
  static constexpr int CP = CP_;
  static constexpr bool ANY = ANY_;
  static_assert(CP % 64 == 0 && CP <= kMaxWidth && (ANY || CP <= 512), "width");
  static constexpr int KS = CP / 64;        // K slabs of the first product
  static constexpr int SLICES = (KS + 7) / 8;            // blocks across the columns
  static constexpr int SB = (KS + SLICES - 1) / SLICES;  // 64-column blocks of a slice
  static constexpr int CS = SB > 4 ? 2 : 1;  // warpgroups across the output columns
  static constexpr int RW = 2 / CS;          // warpgroups across the rows
  static constexpr int TM = 64 * RW;
  static constexpr int NBW = (SB + CS - 1) / CS;  // 64-column accumulator blocks a warpgroup
  static constexpr int G8 = CP / 8;               // 16-byte groups of a padded row
  static constexpr int LPP = G8 >= 32 ? 32 : (G8 >= 16 ? 16 : 8);  // lanes that share one row
  static constexpr int VEC = (G8 + LPP - 1) / LPP;  // 8-channel vectors a lane
  static constexpr int GROUPS = kConsumerThreads / LPP;
  static constexpr int ROW_BYTES = CP * 2;
  static constexpr int XN_BYTES = TM * ROW_BYTES;
  // the block kernel keeps the taps' weights in shared memory, except
  // where CP > 512 leaves no room for all 49 of them beside Xn: there a
  // tap's weights come from device memory (L2)
  static constexpr bool TAPS_IN_SMEM = SLICES == 1;
  // C = 64 needs few registers (a 32-float accumulator), so there two
  // blocks share an SM and one's taps, GELU and epilogue hide under the
  // other's products.  Registers are handed out by the SM's four
  // sub-partitions, 16384 each, and the 9 (or 18) warps are dealt out over
  // them, so what a thread may hold follows from the fullest sub-partition:
  // 168 with one block, 96 with two.
  static constexpr int BLOCKS_PER_SM = CP == 64 ? 2 : 1;
  static constexpr int SMEM_LIMIT =
      BLOCKS_PER_SM == 1 ? kSmemLimit : kSmemPerSm / BLOCKS_PER_SM - 1024;
  static constexpr int MAX_REGS =
      16384 / ((kBlockThreads / 32 * BLOCKS_PER_SM + 3) / 4 * 32) / 8 * 8;
  static_assert(TM % GROUPS == 0, "row groups");
};

// The padded widths the "wgmma_any" kernels are built for: every multiple of
// 64 up to 512, then the ConvNeXt widths above it.  A width C runs the
// smallest one >= C.
#define BTS_ANY_WIDTHS(X) \
  X(64) X(128) X(192) X(256) X(320) X(384) X(448) X(512) X(640) X(768) X(1024)
inline int any_width_plan(int c) {
  if (c <= 0 || c % 8 != 0 || c > kMaxWidth) return 0;
  if (c <= 512) return (c + 63) / 64 * 64;
  return c <= 640 ? 640 : (c <= 768 ? 768 : 1024);
}

// Shared memory of one block, in bytes from a 1024-byte line:
//   [ring: stages x 8 KB][Xn][extra: the block kernel's input tile and its
//   depthwise taps][barriers].  Returns the number of ring stages that fit
//   (at most kMaxStages), or 0 if fewer than kMinStages do.
constexpr int stages_that_fit(int limit, int xn_bytes, int extra_bytes) {
  const int left = limit - kAlignSlack - kBarrierBytes - xn_bytes - extra_bytes;
  const int n = left / kUnitBytes;
  return n >= kMaxStages ? kMaxStages : (n >= kMinStages ? n : 0);
}
constexpr int smem_bytes(int stages, int xn_bytes, int extra_bytes) {
  return kAlignSlack + stages * kUnitBytes + xn_bytes + extra_bytes + kBarrierBytes;
}

// ------------------------------ PTX ------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits until the barrier has left the phase of `parity`.  A pipeline that
// does not advance for about two seconds traps, so a fault shows as a CUDA
// error at the next synchronise and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// A contiguous run of bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving uses of an accumulator across the
// asynchronous products that write it.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A K-major tile of 128-byte rows with the 128-byte swizzle, on a 1024-byte
// line: 8-row groups are 1024 bytes apart.  16 elements further along K is
// 32 bytes, i.e. 2 in the descriptor's address field.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

#define BTS_D8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define BTS_D32_LIST                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, float) = or += A (64 x 16, shared) . B (64 x 16, shared)^T
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BTS_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : BTS_D8(d, 0), BTS_D8(d, 8), BTS_D8(d, 16), BTS_D8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d += A (64 x 16, this warpgroup's registers) . B (64 x 16, shared)^T
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BTS_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : BTS_D8(d, 0), BTS_D8(d, 8), BTS_D8(d, 16), BTS_D8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------ values ------------------------------

// Round to bf16 (nearest even, as XLA and PyTorch do) and back.
__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}
__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void unpack8(const uint4& q, float (&f)[8]) {
  f[0] = lo_f(q.x), f[1] = hi_f(q.x), f[2] = lo_f(q.y), f[3] = hi_f(q.y);
  f[4] = lo_f(q.z), f[5] = hi_f(q.z), f[6] = lo_f(q.w), f[7] = hi_f(q.w);
}

// GELU, tanh form, of a value already rounded to bf16; the caller rounds.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.79788456080286536f * (x + 0.044715f * x * x * x);
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(u));
  return 0.5f * x * (1.0f + t);
}

template <int LANES> __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether 8-channel vector vv of lane l holds real channels (< c) of a row.
template <class P> __device__ __forceinline__ bool real_vec(int vv, int l, int c) {
  return !P::ANY || (vv * P::LPP + l) * 8 < c;
}

// LayerNorm of row r of the tile, whose c values lie across LPP lanes (lane
// l of the group holds channels 8 (vv LPP + l) .. + 8 in v[vv]; vectors past
// c hold zeros); the result goes to Xn as bf16 in the swizzled slab layout,
// and the padded channels c .. CP as zeros.  lw / lb are this lane's LN
// scale and shift, packed.  Mean and variance are over the c real channels.
template <class P>
__device__ __forceinline__ void layer_norm_to_xn(const float (&v)[P::VEC][8],
                                                 const uint4 (&lw)[P::VEC],
                                                 const uint4 (&lb)[P::VEC],
                                                 unsigned char* xn, int r, int l, int c) {
  float s = 0.f;
#pragma unroll
  for (int vv = 0; vv < P::VEC; ++vv)
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[vv][e];
  const float inv_c = 1.0f / c;
  const float mu = group_sum<P::LPP>(s) * inv_c;
  float ss = 0.f;
#pragma unroll
  for (int vv = 0; vv < P::VEC; ++vv) {
    if (!real_vec<P>(vv, l, c)) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = v[vv][e] - mu;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(group_sum<P::LPP>(ss) * inv_c + kLnEps);
#pragma unroll
  for (int vv = 0; vv < P::VEC; ++vv) {
    const int cg = vv * P::LPP + l;  // 16-byte group along the row
    if (P::ANY && cg >= P::G8) continue;  // past the padded row
    uint4 q = make_uint4(0u, 0u, 0u, 0u);  // padded channels: zeros
    if (real_vec<P>(vv, l, c)) {
      float w[8], b[8], o[8];
      unpack8(lw[vv], w);
      unpack8(lb[vv], b);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = rb(rb(rb((v[vv][e] - mu) * rstd) * w[e]) + b[e]);
      q.x = pack2(o[0], o[1]), q.y = pack2(o[2], o[3]);
      q.z = pack2(o[4], o[5]), q.w = pack2(o[6], o[7]);
    }
    const int slab = cg >> 3, g = cg & 7;
    *reinterpret_cast<uint4*>(xn + slab * (P::TM * 128) + r * 128 + ((g ^ (r & 7)) << 4)) = q;
  }
}

// This lane's LN scale and shift (and for the block kernel its depthwise
// bias): 16 bytes a vector, zeros past c.
template <class P>
__device__ __forceinline__ void load_row_params(const bf16* __restrict__ p, uint4 (&q)[P::VEC],
                                                int l, int c) {
#pragma unroll
  for (int vv = 0; vv < P::VEC; ++vv) {
    q[vv] = make_uint4(0u, 0u, 0u, 0u);
    if (real_vec<P>(vv, l, c))
      q[vv] = *reinterpret_cast<const uint4*>(p + (vv * P::LPP + l) * 8);
  }
}

// ------------------------------ the ring ------------------------------

struct Ring {
  uint32_t tiles, full, empty;  // shared-memory addresses
  int stages, slot;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
  __device__ __forceinline__ uint32_t tile() const { return tiles + slot * kUnitBytes; }
  __device__ __forceinline__ uint32_t full_bar() const { return full + slot * 8; }
  __device__ __forceinline__ uint32_t empty_bar(int s) const { return empty + s * 8; }
};

// Block-wide set-up, run by every thread before the roles part: the ring's
// barriers (full: the producer's arrive + the copy's bytes; empty: one
// arrive per consumer warp) and the extra barrier the block kernel's input
// tile completes on.
__device__ __forceinline__ void init_barriers(uint32_t full, uint32_t empty, uint32_t extra,
                                              int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    mbar_init(extra, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The 64-column blocks of the output that this block owns, [blk0, blk0 +
// nb): all of them, or with the columns split over blocks (CP > 512) the
// slice blockIdx.y.  Warpgroup cs owns blocks cs NBW .. cs NBW + NBW of it,
// those that exist.
template <class P> struct Slice {
  int blk0, nb;
  __device__ __forceinline__ static Slice of_block() {
    if (P::SLICES == 1) return Slice{0, P::KS};
    const int b0 = static_cast<int>(blockIdx.y) * P::SB;
    return Slice{b0, P::KS - b0 < P::SB ? P::KS - b0 : P::SB};
  }
  __device__ __forceinline__ bool has(int cs, int k) const {
    return (P::SLICES == 1 && P::NBW * P::CS == P::KS) || cs * P::NBW + k < nb;
  }
};

// The producer thread: every unit of every chunk, in the order the
// consumers take them.  A chunk is KS units of fc1 (the K slabs), then one
// fc2 unit for each accumulator block; with the columns split over the
// warpgroups the units alternate between the two, so that both start
// their k-th product at the same step.
template <class P>
__device__ __forceinline__ void produce_weights(Ring ring, const CUtensorMap* map1,
                                                const CUtensorMap* map2, int hidden,
                                                Slice<P> sl) {
  ring.slot = 0;
  ring.phase = 1;  // a fresh barrier lets a wait on the other parity through
  for (int j0 = 0; j0 < hidden; j0 += 64) {
    for (int u = 0; u < P::KS + P::NBW * P::CS; ++u) {
      int blk = 0;
      if (u >= P::KS) {
        const int i = u - P::KS, k = i / P::CS, cs = i % P::CS;
        if (!sl.has(cs, k)) continue;
        blk = sl.blk0 + cs * P::NBW + k;
      }
      mbar_wait(ring.empty_bar(ring.slot), ring.phase);
      mbar_expect_tx(ring.full_bar(), kUnitBytes);
      if (u < P::KS)
        tma_load_2d(ring.tile(), map1, ring.full_bar(), u * 64, j0);
      else
        tma_load_2d(ring.tile(), map2, ring.full_bar(), j0, blk * 64);
      ring.advance();
    }
  }
}

// The consumers, once Xn is complete and visible to the asynchronous proxy:
// both products over all chunks, then the epilogue, for the output columns
// of slice `sl` and the c real channels (rows of width c in device memory).
// `shortcut(r, col)` gives the two bf16 shortcut values of tile row r at
// columns col, col + 1.
template <class P, typename Shortcut>
__device__ __forceinline__ void consume_mlp(Ring ring, uint32_t xn, const bf16* __restrict__ b1,
                                            const bf16* __restrict__ b2,
                                            const bf16* __restrict__ gamma,
                                            bf16* __restrict__ out, long long row0,
                                            long long M, int hidden, int c, Slice<P> sl,
                                            Shortcut shortcut) {
  const int wg = threadIdx.x >> 7;
  const int rg = P::CS == 1 ? wg : 0;  // which 64 rows
  const int cs = P::CS == 1 ? 0 : wg;  // which share of the columns
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;
  const int frow = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // fragment row, +8

  float acc[P::NBW][32];
#pragma unroll
  for (int nb = 0; nb < P::NBW; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  ring.slot = 0;
  ring.phase = 0;
  const uint32_t a_base = xn + rg * (64 * 128);

  for (int j0 = 0; j0 < hidden; j0 += 64) {
    // ---- H = Xn . W1[j0 .. j0+64]^T, one unit per 64 input channels
    uint32_t bias1[8];  // asked for ahead of the product that hides their latency
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = j0 + 8 * i + t2;
      bias1[i] = 0u;  // hidden units past the last: zero bias, zero weights
      if (!P::ANY || j < hidden) bias1[i] = __ldg(reinterpret_cast<const uint32_t*>(b1 + j));
    }
    float h[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) h[i] = 0.f;
    fence_regs(h);
    wgmma_fence();
    int held = -1;  // slot whose products may still be reading it
#pragma unroll
    for (int s = 0; s < P::KS; ++s) {
      mbar_wait(ring.full_bar(), ring.phase);
      const uint64_t da = wgmma_desc(a_base + s * (P::TM * 128));
      const uint64_t db = wgmma_desc(ring.tile());
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(h, da + 2 * kk, db + 2 * kk, (s | kk) != 0);
      wgmma_commit();
      if (held >= 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(ring.empty_bar(held));
      }
      held = ring.slot;
      ring.advance();
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(ring.empty_bar(held));
    fence_regs(h);

    // ---- G = GELU(H + b1), packed as the A fragments of the second product
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t bb = bias1[i];
      const float bl = lo_f(bb), bh = hi_f(bb);
      const float g0 = gelu_tanh(rb(rb(h[4 * i + 0]) + bl));
      const float g1 = gelu_tanh(rb(rb(h[4 * i + 1]) + bh));
      const float g2 = gelu_tanh(rb(rb(h[4 * i + 2]) + bl));
      const float g3 = gelu_tanh(rb(rb(h[4 * i + 3]) + bh));
      a[i >> 1][(i & 1) * 2 + 0] = pack2(g0, g1);
      a[i >> 1][(i & 1) * 2 + 1] = pack2(g2, g3);
    }

    // ---- acc[k] += G . W2[64-column block of acc[k], j0 .. j0+64]^T
#pragma unroll
    for (int nb = 0; nb < P::NBW; ++nb) fence_regs(acc[nb]);
    wgmma_fence();
    int held2[P::CS];
    bool holding = false;
#pragma unroll
    for (int k = 0; k < P::NBW; ++k) {
      // one unit for each warpgroup across the columns that has a k-th
      // block; this one takes its own.  A warpgroup without a k-th block
      // (uneven splits) multiplies the other's unit into an accumulator it
      // never stores: a product under a branch would serialise every wgmma
      // of the kernel (ptxas C7520).
      int slots[P::CS];
      uint32_t mine = 0;
#pragma unroll
      for (int c2 = 0; c2 < P::CS; ++c2) {
        slots[c2] = -1;
        if (!sl.has(c2, k)) continue;
        mbar_wait(ring.full_bar(), ring.phase);
        slots[c2] = ring.slot;
        mine = c2 == cs || !sl.has(cs, k) ? ring.tile() : mine;
        ring.advance();
      }
      const uint64_t db = wgmma_desc(mine);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[k], a[kk], db + 2 * kk);
      wgmma_commit();
      if (holding) {
        wgmma_wait<1>();
#pragma unroll
        for (int c2 = 0; c2 < P::CS; ++c2)
          if (lane == 0 && (!P::ANY || held2[c2] >= 0)) mbar_arrive(ring.empty_bar(held2[c2]));
      }
#pragma unroll
      for (int c2 = 0; c2 < P::CS; ++c2) held2[c2] = slots[c2];
      holding = true;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c2 = 0; c2 < P::CS; ++c2)
      if (lane == 0 && (!P::ANY || held2[c2] >= 0)) mbar_arrive(ring.empty_bar(held2[c2]));
#pragma unroll
    for (int nb = 0; nb < P::NBW; ++nb) fence_regs(acc[nb]);
  }

  // ---- epilogue: + b2, * gamma, + shortcut
#pragma unroll
  for (int nb = 0; nb < P::NBW; ++nb) {
    if (P::ANY && !sl.has(cs, nb)) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = (sl.blk0 + cs * P::NBW + nb) * 64 + 8 * i + t2;
      if (P::ANY && col >= c) continue;  // padded columns: zeros, never stored
      const uint32_t b2p = __ldg(reinterpret_cast<const uint32_t*>(b2 + col));
      const uint32_t gp = __ldg(reinterpret_cast<const uint32_t*>(gamma + col));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rg * 64 + frow + 8 * half;
        if (row0 + r >= M) continue;
        const uint32_t sp = shortcut(r, col);
        const float y0 = rb(rb(acc[nb][4 * i + 2 * half]) + lo_f(b2p));
        const float y1 = rb(rb(acc[nb][4 * i + 2 * half + 1]) + hi_f(b2p));
        const float z0 = rb(y0 * lo_f(gp)), z1 = rb(y1 * hi_f(gp));
        *reinterpret_cast<uint32_t*>(out + (row0 + r) * c + col) =
            pack2(lo_f(sp) + z0, hi_f(sp) + z1);
      }
    }
  }
}

// ------------------------------ host ------------------------------

typedef CUresult (*TensorMapEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                      const cuuint32_t*, CUtensorMapInterleave,
                                      CUtensorMapSwizzle, CUtensorMapL2promotion,
                                      CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library links against
// nothing but cudart.
inline TensorMapEncodeFn tensor_map_encoder() {
  static const TensorMapEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<TensorMapEncodeFn>(p);
  }();
  return fn;
}

// A map over a row-major (rows, cols) matrix of `type`, rows `ld` bytes
// apart (a multiple of 16), that loads boxes of 64 rows x 128 bytes
// (box_cols elements) with the 128-byte swizzle: one ring unit.  The part of
// a box past (rows, cols) arrives as zeros.
inline cudaError_t unit_map(CUtensorMap* map, const void* w, CUtensorMapDataType type, int rows,
                            int cols, int ld, int box_cols) {
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(w), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A dense row-major (rows, cols) bf16 matrix in 64 x 64 boxes.
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int rows, int cols) {
  return unit_map(map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rows, cols, cols * 2, 64);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace hopper
}  // namespace btsbot
