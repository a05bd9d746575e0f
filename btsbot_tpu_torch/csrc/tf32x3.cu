// The float32 design of the two ConvNeXt block kernels for Hopper (sm_90a):
// both products of the LN -> fc1 -> GELU -> fc2 -> gamma -> residual chain on
// the tensor cores as three TF32 products each ("3xTF32"), weight tiles
// brought in by TMA while the products run.  Every float32 launch of both
// functions, at every width, runs here (the "tf32x3" kernels):
//   btsbot_ln_mlp_tf32x3          btsbot_tpu/ops/pallas_mlp.py:fused_ln_mlp
//   btsbot_convnext_block_tf32x3  btsbot_tpu/ops/pallas_convnext.py:convnext_block_fused
// The bfloat16 kernels (hopper_mlp.cuh, ln_mlp.cu, convnext_block.cu) are
// not touched by this file.
//
// Why three products.  float32 must agree with the plain version to 1e-5.
// One TF32 product keeps 11 bits of each operand and misses that by two to
// three orders of magnitude; exact float FMAs on the CUDA cores hold it but
// cap the kernel at 67 TFLOP/s.  With a = a_hi + a_lo, a_hi = tf32(a),
// a_lo = tf32(a - a_hi) (cvt.rna, round to nearest, ties away), the sum
//   a_lo b_hi + a_hi b_lo + a_hi b_hi
// in the float accumulator drops only a_lo b_lo (2^-22 relative) and lands
// within the float32 error of the exact product; it costs three tensor-core
// products, 495 / 3 = 165 TFLOP/s at the card's TF32 rate.
//
// Layout of one block = 288 threads = two consumer warpgroups + one
// producer warp (one thread of it starts every copy), as the bf16 design.
//   rows      a block takes TM = 64 rows (32 at padded widths above 512,
//             where 64 float rows of Xn do not fit beside the ring; the
//             products still run 64 rows, the upper 32 as zeros), and both
//             warpgroups share them; at C <= 64 it takes 128, 64 for each
//             warpgroup, whose products then run n64 over all 64 hidden
//             units and output columns (RW in consume).
//   Xn        the normalised rows, float, [TM][KP + 4] in shared memory,
//             KP = 32 ceil(C / 32), channels past C zero.  The 4-float pad
//             makes a quarter-warp's 16-byte loads of 8 rows hit 8 bank
//             groups.
//   A         TF32 wgmma takes no transpose, so both operands are K-major,
//             which they are (the rows; nn.Linear's (hidden, C) and
//             (C, hidden)).  A comes from registers: a lane loads 8
//             consecutive channels of its two fragment rows as two float4s
//             per 32-channel slab and splits them into hi / lo there.  The
//             m64k8 fragment wants channels t and t + 4 of each 8-wide
//             k-step; the lane holds 8t .. 8t + 7 instead, so the weights
//             are permuted along K to match: within every 32-wide K slab,
//             position 8 kk + j reads source column 8 (j % 4) + 2 kk + j / 4
//             (slab_source below).  K is summed over, so the permutation
//             changes the order of the sum, not what is summed.
//   weights   a split pass at each launch writes W_hi and W_lo of fc1 and
//             fc2, permuted along K and zero-padded (hidden to HP = 64
//             ceil(hidden / 64), fc1's C to KP), into a workspace that the
//             wrapper allocates; the block kernel's depthwise weights go
//             there too, transposed to [tap][KP].  Every tile that moves is
//             a box of 32 rows x 32 floats (4 KB, 128-byte rows, the
//             128-byte swizzle); a ring slot (16 KB) holds four: hi and lo
//             for each warpgroup.  Slots go through a ring of 3-8 stages
//             with a full and an empty mbarrier each; the producer runs
//             ahead by the depth of the ring.
//   products  per 64-unit hidden chunk, warpgroup w computes hidden units
//             32 w .. 32 w + 32 of it, H = Xn . W1^T, m64n32k8, three
//             products per k-step.  GELU(H + b1) (erf form) goes to G, a
//             float [TM][68] tile in shared memory; after a barrier of the
//             two warpgroups both read all 64 units of G as A
//             (loaded and split like Xn) for acc += G . W2^T, each over its
//             own NB blocks of 32 output columns (m64n32k8, three products
//             per k-step).
//   columns   a block owns 64 NB output columns (NB = 1 .. 4 blocks of 32
//             for each warpgroup); wider C is split over SLICES blocks
//             (blockIdx.y), each recomputing the first product for its
//             columns.  Each column's sum over the hidden units is complete
//             in one block, in a fixed order; nothing crosses blocks (no
//             atomics).  NB is chosen by the host for the rows at hand:
//             fewer, wider slices when the rows fill the card, more when
//             they do not.
//   small M   where row tiles x slices still leave the card idle (batch 64
//             at C = 512, base's 1x1 stage at batch 256), the hidden chunks
//             are split over SPLITS blocks (blockIdx.z) too: each writes
//             its float partial sums to the workspace, and a second pass
//             (reduce_splits) adds them in split order, then b2, gamma and
//             the shortcut.  Fixed order, no atomics.
//   epilogue  out = shortcut + (acc + b2) * gamma in float, as the plain
//             version rounds, masked to the real C and rows.
// The block kernel's front: the 7x7 taps in float FMAs on the CUDA cores,
// 16-byte loads, 4 rows of a channel group a thread, each tap's weights read
// once for the 4 (the weights of the taps that can be in bounds in shared
// memory where they fit); the input (the TM rows with the halo of the taps,
// as the bf16 design's contiguous run of the flattened index) comes by one
// bulk copy into shared memory where it fits beside Xn and the ring, and
// through L2 from x elsewhere.  Then the LayerNorm in place over Xn.
//
// What bounds it on the H100: per row, 3 x 8 C^2 TF32 multiply-adds (the
// card's TF32 rate, 495 TFLOP/s dense) against 3 C floats moved; the
// weights (hi and lo, 16 C hidden bytes) are read by every block from L2.
// What is left between it and that bound (measured with timing-only
// variants, PERF.md): not the weight feed (half the bytes, or none, leave
// the time within 5 %) but the consumers' loop: a slab's 12 small (n32)
// products are waited for before the next slab's A is split, which keeps
// the tensor cores near a quarter of their TF32 rate; the LN and the taps
// run before the products of the same block and nothing overlaps them;
// above 256 columns the first product is recomputed for each slice.

#include <cuda.h>

#include <cstdint>

#include "block_common.cuh"
#include "hopper_mlp.cuh"

namespace btsbot {
namespace tf32x3 {

using namespace hopper;

constexpr int kBox = 32 * 32 * 4;       // one TMA box: 32 rows x 32 floats
constexpr int kSlot = 4 * kBox;          // hi and lo of two 32-row halves
constexpr int kMinStagesF = 3;
constexpr int kGPitch = 68;              // floats of a G row (64 + 4)
constexpr int kMaxWidthF = 1024;
constexpr int kSms = 132;
constexpr int kMaxRegs = 168;            // 288 threads: 3 warps on a sub-partition

// ------------------------------ plan ------------------------------

struct Plan32 {
  int kp, hp, tm, nb, slices, stages, bytes;
  int splits, cps;  // blocks along the hidden chunks, chunks a block
  int tile_floats;  // the block kernel's input tile (0: x through L2)
  int taps_floats;  // its taps' weights in shared memory (0: through L1 / L2)
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Bytes of shared memory from a 1024-byte line: [ring][Xn][G][tile][taps'
// weights][bars].
__host__ __device__ inline int xn_offset(int stages) { return stages * kSlot; }
__host__ __device__ inline int g_offset(int stages, int tm, int kp) {
  return xn_offset(stages) + tm * (kp + 4) * 4;
}
__host__ __device__ inline int tile_offset(int stages, int tm, int kp) {
  return g_offset(stages, tm, kp) + tm * kGPitch * 4;
}
__host__ __device__ inline int bar_offset(int stages, int tm, int kp, int extra_floats) {
  return tile_offset(stages, tm, kp) + extra_floats * 4;
}

inline bool widths_ok(int C, int hidden) {
  return C > 0 && hidden > 0 && C % 8 == 0 && hidden % 8 == 0 && C <= kMaxWidthF;
}

// Output columns a block owns (64 NB), how many blocks split C (slices),
// and, when those blocks do not fill the card in one wave, how many split
// the hidden chunks (splits, cps chunks each): the choice whose waves over
// the card take the least product work, a split block charged two chunks
// more for what every block pays again (the ring's first fill, the LN and
// the taps, its partial sums); ties to the wider NB and the fewer splits.
inline void choose_grid(long long M, int C, Plan32* p) {
  const long long tiles = (M + p->tm - 1) / p->tm;
  const int chunks = p->hp / 64;
  const int nb_max = (C + 63) / 64 < 4 ? (C + 63) / 64 : 4;
  long long best = -1;
  for (int n = nb_max; n >= 1; --n) {
    const int s = (C + 64 * n - 1) / (64 * n);
    const long long base = tiles * s, chunk = p->kp + 64LL * n;
    for (int splits = 1; splits <= (base < kSms ? chunks : 1); ++splits) {
      const int cps = (chunks + splits - 1) / splits;
      if (splits > 1 && (chunks + cps - 1) / cps != splits) continue;  // an empty split
      const long long waves = (base * splits + kSms - 1) / kSms;
      const long long cost = waves * (cps * chunk + (splits > 1 ? 2 * chunk : 0));
      if (best < 0 || cost < best) {
        best = cost;
        p->nb = n, p->slices = s, p->splits = splits, p->cps = cps;
      }
    }
  }
}

// The plan of one launch; false for widths the kernels do not take.  With
// H > 0 it is the block kernel's (H, W map): its input tile and the weights
// of the taps that can be in bounds go to shared memory where they fit
// beside at least kMinStagesF ring stages (the tile first given up).
inline bool plan_for(long long M, int C, int hidden, int H, int W, Plan32* p) {
  if (!widths_ok(C, hidden) || M <= 0) return false;
  p->kp = round_up(C, 32);
  p->hp = round_up(hidden, 64);
  p->tm = p->kp <= 64 ? 128 : (p->kp > 512 ? 32 : 64);
  choose_grid(M, C, p);
  const int fixed = kAlignSlack + kBarrierBytes;
  auto stages_with = [&](long long extra_floats) {
    const long long left = kSmemLimit - fixed - tile_offset(0, p->tm, p->kp) - 4 * extra_floats;
    const long long n = left / kSlot;
    return n >= kMaxStages ? kMaxStages : (n >= kMinStagesF ? static_cast<int>(n) : 0);
  };
  p->tile_floats = p->taps_floats = 0;
  if (H > 0) {
    const Reach q = reach_of(H, W);
    const long long tile = static_cast<long long>(p->tm + 2 * q.halo) * C;
    const long long taps = static_cast<long long>(q.taps) * p->kp;
    if (stages_with(tile + taps) > 0) {
      p->tile_floats = static_cast<int>(tile);
      p->taps_floats = static_cast<int>(taps);
    } else if (stages_with(taps) > 0) {
      p->taps_floats = static_cast<int>(taps);
    }
  }
  p->stages = stages_with(p->tile_floats + p->taps_floats);
  if (p->stages == 0) return false;
  p->bytes = bar_offset(p->stages, p->tm, p->kp, p->tile_floats + p->taps_floats) + fixed;
  return true;
}

// Floats of the workspace: W1 hi, lo (HP x KP), W2 hi, lo (C x HP), for
// the block kernel the taps' weights [49][KP], and with the hidden chunks
// split over blocks their partial sums [splits][M][C].
inline long long weights_floats(int C, int hidden, bool taps) {
  const long long kp = round_up(C, 32), hp = round_up(hidden, 64);
  return 2 * hp * kp + 2LL * C * hp + (taps ? kTaps * kp : 0);
}
inline long long workspace_floats(const Plan32& p, long long M, int C, int hidden, bool taps) {
  return weights_floats(C, hidden, taps) + (p.splits > 1 ? p.splits * M * C : 0);
}

// ------------------------------ values ------------------------------

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}
// The same rounding in two integer operations: half a TF32 ulp added to
// the magnitude bits, the low 13 bits cleared.  Bit for bit cvt.rna's
// result for every finite float (and infinities); cvt runs on the SM's
// conversion unit at a fraction of the integer rate, and the A operands
// are split in the products' inner loop, 32 values a lane a slab.
__device__ __forceinline__ uint32_t tf32_bits_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// Column of the source that position p of a permuted K axis reads: within
// every 32-wide slab, position 8 kk + j <- column 8 (j % 4) + 2 kk + j / 4.
__host__ __device__ __forceinline__ int slab_source(int p) {
  const int q = p & 31, kk = q >> 3, j = q & 7;
  return (p & ~31) + 8 * (j & 3) + 2 * kk + (j >> 2);
}

// The split pass: W1 (hidden, C) -> hi, lo (HP, KP); W2 (C, hidden) -> hi,
// lo (C, HP), both permuted along K and zero-padded; with dw_w (C, 1, 7, 7)
// the taps' weights as [49][KP].
static __global__ void __launch_bounds__(256)
    split_weights_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                         const float* __restrict__ dw_w, float* __restrict__ ws, int C,
                         int hidden, int kp, int hp) {
  const long long n1 = static_cast<long long>(hp) * kp, n2 = static_cast<long long>(C) * hp;
  const long long n3 = dw_w != nullptr ? static_cast<long long>(kTaps) * kp : 0;
  const long long total = n1 + n2 + n3;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    if (i < n1) {
      const int n = static_cast<int>(i / kp), src = slab_source(static_cast<int>(i % kp));
      const float v = n < hidden && src < C ? w1[static_cast<long long>(n) * C + src] : 0.f;
      const uint32_t hi = tf32_bits(v);
      ws[i] = __uint_as_float(hi);
      ws[n1 + i] = __uint_as_float(tf32_bits(v - __uint_as_float(hi)));
    } else if (i < n1 + n2) {
      const long long j = i - n1;
      const int c = static_cast<int>(j / hp), src = slab_source(static_cast<int>(j % hp));
      const float v = src < hidden ? w2[static_cast<long long>(c) * hidden + src] : 0.f;
      const uint32_t hi = tf32_bits(v);
      ws[2 * n1 + j] = __uint_as_float(hi);
      ws[2 * n1 + n2 + j] = __uint_as_float(tf32_bits(v - __uint_as_float(hi)));
    } else {
      const long long j = i - n1 - n2;
      const int t = static_cast<int>(j / kp), c = static_cast<int>(j % kp);
      ws[2 * n1 + 2 * n2 + j] = c < C ? dw_w[c * kTaps + t] : 0.f;
    }
  }
}

// d (64 x 32, float) += A (64 x 8, this warpgroup's registers, tf32) .
// B (32 x 8, shared, tf32)^T
__device__ __forceinline__ void mma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : BTS_D8(d, 0), BTS_D8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, float) += A (64 x 8, registers, tf32) . B (64 x 8, shared)^T
__device__ __forceinline__ void mma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " BTS_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : BTS_D8(d, 0), BTS_D8(d, 8), BTS_D8(d, 16), BTS_D8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NR> __device__ __forceinline__ void fence_acc(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The A fragments of one 32-wide K slab: a lane's 8 consecutive values of
// its two rows (raw[0..8) row R0, raw[8..16) row R0 + 8, from column 8 t),
// split into hi and lo (tf32_bits_int).  k-step kk takes values 2 kk
// (fragment column t) and 2 kk + 1 (column t + 4) of each row.
struct Frags {
  uint32_t hi[4][4], lo[4][4];
};
__device__ __forceinline__ void split_frags(const float (&raw)[16], Frags& f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float v[4] = {raw[2 * kk], raw[8 + 2 * kk], raw[2 * kk + 1], raw[8 + 2 * kk + 1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f.hi[kk][e] = tf32_bits_int(v[e]);
      f.lo[kk][e] = tf32_bits_int(v[e] - __uint_as_float(f.hi[kk][e]));
    }
  }
}
// Rows R0 and R0 + 8 of a float tile of `pitch` floats, columns c0 + 8 t ..
// + 8; zeros for a warp whose rows lie past the tile (live = false).
__device__ __forceinline__ void load_slab(const float* tile, int pitch, int r0, int c0, int t,
                                          bool live, float (&raw)[16]) {
  if (!live) {
#pragma unroll
    for (int i = 0; i < 16; ++i) raw[i] = 0.f;
    return;
  }
  const float* p0 = tile + r0 * pitch + c0 + 8 * t;
  const float* p1 = p0 + 8 * pitch;
  const float4 a = *reinterpret_cast<const float4*>(p0);
  const float4 b = *reinterpret_cast<const float4*>(p0 + 4);
  const float4 c = *reinterpret_cast<const float4*>(p1);
  const float4 d = *reinterpret_cast<const float4*>(p1 + 4);
  raw[0] = a.x, raw[1] = a.y, raw[2] = a.z, raw[3] = a.w;
  raw[4] = b.x, raw[5] = b.y, raw[6] = b.z, raw[7] = b.w;
  raw[8] = c.x, raw[9] = c.y, raw[10] = c.z, raw[11] = c.w;
  raw[12] = d.x, raw[13] = d.y, raw[14] = d.z, raw[15] = d.w;
}

// Three products of one 32-wide K slab into d (n32: 16 registers, n64: 32):
// B_hi and B_lo are 32 or 64 rows of 32 floats; a k-step is 32 bytes along
// them (2 in the descriptor).
template <int NR>
__device__ __forceinline__ void slab_products(float (&d)[NR], const Frags& f, uint32_t b_hi,
                                              uint32_t b_lo) {
  const uint64_t dh = wgmma_desc(b_hi), dl = wgmma_desc(b_lo);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_tf32(d, f.lo[kk], dh + 2 * kk);
    mma_tf32(d, f.hi[kk], dl + 2 * kk);
    mma_tf32(d, f.hi[kk], dh + 2 * kk);
  }
}

// d += the three products of `slabs` consecutive 32-wide K slabs: A from
// rows r0, r0 + 8 of `tile` (`pitch` floats a row) at columns c0, c0 + 32,
// ...; B from consecutive ring slots, at `hi` and `lo` in them.  The
// tensor cores' float accumulation truncates, which over hundreds of
// products compounds to ~2e-5 at C = 1024; so each slab's 12 products go to
// a fresh partial sum, added to d in float (round to nearest) after the
// slab.  The next slab's A is loaded while the products run.
template <int NR, class Ring>
__device__ __forceinline__ void accumulate_slabs(float (&d)[NR], Ring& ring, const float* tile,
                                                 int pitch, int c0, int slabs, int r0, int t,
                                                 bool live, int lane, uint32_t hi, uint32_t lo) {
  float raw[16], part[NR];
  Frags f;
  load_slab(tile, pitch, r0, c0, t, live, raw);
  for (int i = 0; i < slabs; ++i) {
    split_frags(raw, f);
#pragma unroll
    for (int j = 0; j < NR; ++j) part[j] = 0.f;
    fence_acc(part);
    mbar_wait(ring.full_bar(), ring.phase);
    wgmma_fence();
    slab_products(part, f, ring.tile() + hi, ring.tile() + lo);
    wgmma_commit();
    if (i + 1 < slabs) load_slab(tile, pitch, r0, c0 + 32 * (i + 1), t, live, raw);
    wgmma_wait<0>();
    fence_acc(part);
    if (lane == 0) mbar_arrive(ring.empty_bar());
    ring.advance();
#pragma unroll
    for (int j = 0; j < NR; ++j) d[j] += part[j];
  }
}

// ------------------------------ the kernels ------------------------------

struct Args {
  CUtensorMap w1hi, w1lo, w2hi, w2lo;
  const float* src;    // h (ln_mlp) or x (block)
  const float* res;    // the shortcut: res (ln_mlp) or x (block)
  const float* ln_w;
  const float* ln_b;
  const float* b1;
  const float* b2;
  const float* gamma;
  const float* dw_t;   // block: the taps' weights [49][KP] in the workspace
  const float* dw_b;   // block: the depthwise bias
  float* out;
  float* part;         // hidden split over blocks: partial sums [splits][M][C]
  long long M;
  int c, hidden, hp, kp, tm, stages, tile_floats, taps_floats;
  int splits, cps;
  int H, W;            // block: the map (0 for ln_mlp)
  float eps;           // the LayerNorm's eps
};

struct SlotRing {
  uint32_t tiles, full, empty;
  int stages, slot;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
  __device__ __forceinline__ uint32_t tile() const { return tiles + slot * kSlot; }
  __device__ __forceinline__ uint32_t full_bar() const { return full + slot * 8; }
  __device__ __forceinline__ uint32_t empty_bar() const { return empty + slot * 8; }
};

// Where box `half` (rows 0-31 or 32-63 of a slot's 64) and its hi or lo
// part sit in a slot: each warpgroup's hi, lo side by side (RW false: the
// two warpgroups take the two halves), or all 64 hi rows and then all 64
// lo rows (RW: both warpgroups take all 64, as one n64 operand).
template <bool RW> __device__ __forceinline__ uint32_t box_at(int half, int lo) {
  return RW ? (half + 2 * lo) * kBox : (2 * half + lo) * kBox;
}

// The producer thread: for each hidden chunk, one slot per 32-channel slab
// of fc1 (rows j0 .. j0 + 32 and j0 + 32 .. j0 + 64), then one slot per
// 32-column block (NB) and K slab (2) of fc2 (rows col0 + 32 b and col0 +
// 32 (NB + b)).  Boxes past C are zero-filled by the map and still count
// their whole 4 KB.
template <int NB, bool RW>
__device__ __forceinline__ void produce(SlotRing ring, const Args& a, int col0, int jb, int je) {
  ring.slot = 0;
  ring.phase = 1;  // a fresh barrier lets a wait on the other parity through
  for (int j0 = jb; j0 < je; j0 += 64) {
    for (int s = 0; s < a.kp; s += 32) {
      mbar_wait(ring.empty_bar(), ring.phase);
      mbar_expect_tx(ring.full_bar(), kSlot);
      tma_load_2d(ring.tile() + box_at<RW>(0, 0), &a.w1hi, ring.full_bar(), s, j0);
      tma_load_2d(ring.tile() + box_at<RW>(0, 1), &a.w1lo, ring.full_bar(), s, j0);
      tma_load_2d(ring.tile() + box_at<RW>(1, 0), &a.w1hi, ring.full_bar(), s, j0 + 32);
      tma_load_2d(ring.tile() + box_at<RW>(1, 1), &a.w1lo, ring.full_bar(), s, j0 + 32);
      ring.advance();
    }
    for (int b = 0; b < NB; ++b) {
      for (int ks = 0; ks < 2; ++ks) {
        const int r0 = col0 + 32 * b, r1 = col0 + 32 * (NB + b), k0 = j0 + 32 * ks;
        mbar_wait(ring.empty_bar(), ring.phase);
        mbar_expect_tx(ring.full_bar(), kSlot);
        tma_load_2d(ring.tile() + box_at<RW>(0, 0), &a.w2hi, ring.full_bar(), k0, r0);
        tma_load_2d(ring.tile() + box_at<RW>(0, 1), &a.w2lo, ring.full_bar(), k0, r0);
        tma_load_2d(ring.tile() + box_at<RW>(1, 0), &a.w2hi, ring.full_bar(), k0, r1);
        tma_load_2d(ring.tile() + box_at<RW>(1, 1), &a.w2lo, ring.full_bar(), k0, r1);
        ring.advance();
      }
    }
  }
}

// LayerNorm of the tile's rows into Xn: row r (c floats at src + r pitch,
// shared or device memory) -> Xn row r (KP floats, zeros past c); rows
// r >= valid (past M) -> zeros.  Mean, mean of squared deviations, eps,
// over the c real channels.  Warp w takes rows w, w + 8, ...; a lane
// holds Q float4 groups of a row (KP <= 128 Q) and 8 / Q rows' loads are in
// flight together, so the rows do not wait on each other's latency.
template <int Q>
__device__ __forceinline__ void layer_norm_rows(const float* src, int pitch, long long valid,
                                                float* xn, int xp, int tm, int c, int kp,
                                                const float* __restrict__ ln_w,
                                                const float* __restrict__ ln_b, float eps,
                                                int warp, int lane) {
  constexpr int R = 8 / Q;
  const float inv_c = 1.0f / c;
  for (int rb = warp; rb < tm; rb += 8 * R) {
    float4 v[R][Q];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int r = rb + 8 * i, k = 4 * (lane + 32 * q);
        v[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < tm && r < valid && k < c)
          v[i][q] = *reinterpret_cast<const float4*>(src + static_cast<long long>(r) * pitch + k);
      }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = rb + 8 * i;
      if (r >= tm) break;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) s += (v[i][q].x + v[i][q].y) + (v[i][q].z + v[i][q].w);
      const float mu = warp_sum(s) * inv_c;
      float ss = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (4 * (lane + 32 * q) >= c) continue;
        const float dx = v[i][q].x - mu, dy = v[i][q].y - mu;
        const float dz = v[i][q].z - mu, dw = v[i][q].w - mu;
        ss += (dx * dx + dy * dy) + (dz * dz + dw * dw);
      }
      const float rstd = rsqrtf(warp_sum(ss) * inv_c + eps);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int k = 4 * (lane + 32 * q);
        if (k >= kp) continue;
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < c && r < valid) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(ln_w + k));
          const float4 b = __ldg(reinterpret_cast<const float4*>(ln_b + k));
          o.x = (v[i][q].x - mu) * rstd * w.x + b.x;
          o.y = (v[i][q].y - mu) * rstd * w.y + b.y;
          o.z = (v[i][q].z - mu) * rstd * w.z + b.z;
          o.w = (v[i][q].w - mu) * rstd * w.w + b.w;
        }
        *reinterpret_cast<float4*>(xn + r * xp + k) = o;
      }
    }
  }
}
__device__ __forceinline__ void layer_norm_tile(const float* src, int pitch, long long valid,
                                                float* xn, const Args& a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, xp = a.kp + 4;
  if (a.kp <= 128)
    layer_norm_rows<1>(src, pitch, valid, xn, xp, a.tm, a.c, a.kp, a.ln_w, a.ln_b, a.eps, warp,
                            lane);
  else if (a.kp <= 256)
    layer_norm_rows<2>(src, pitch, valid, xn, xp, a.tm, a.c, a.kp, a.ln_w, a.ln_b, a.eps, warp,
                            lane);
  else if (a.kp <= 512)
    layer_norm_rows<4>(src, pitch, valid, xn, xp, a.tm, a.c, a.kp, a.ln_w, a.ln_b, a.eps, warp,
                            lane);
  else
    layer_norm_rows<8>(src, pitch, valid, xn, xp, a.tm, a.c, a.kp, a.ln_w, a.ln_b, a.eps, warp,
                            lane);
}

// The consumers, once Xn is complete: both products over every hidden
// chunk, then the epilogue, for this block's rows and columns.  RW false:
// both warpgroups share the 64 (or 32) rows, warpgroup w takes hidden units
// 32 w .. 32 w + 32 of a chunk and its NB blocks of 32 output columns (n32
// products).  RW (C <= 64, NB = 1): warpgroup w takes rows 64 w .. 64 w + 64
// of a 128-row tile, all 64 hidden units of a chunk and all 64 output
// columns (n64 products: twice the work an instruction, half the weight
// bytes a row).
template <int NB, bool RW>
__device__ __forceinline__ void consume(SlotRing ring, const Args& a, const float* xn,
                                        float* gbuf, long long row0, int col0, int jb, int je) {
  constexpr int NR = RW ? 32 : 16;         // accumulator registers of one product
  constexpr int G8 = NR / 4;               // 8-column groups of one product
  static_assert(!RW || NB == 1, "128-row tiles take 64 output columns");
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int rw0 = RW ? 64 * wg : 0;        // this warpgroup's first row
  const int r0 = rw0 + 16 * warp + (lane >> 2);  // fragment rows r0, r0 + 8
  const bool live = rw0 + 16 * warp < a.tm;       // rows past TM are zeros
  const int xp = a.kp + 4;
  const int cw = RW ? 0 : 32 * wg;         // this warpgroup's first column of a product
  const uint32_t hi = RW ? box_at<RW>(0, 0) : box_at<RW>(wg, 0);
  const uint32_t lo = RW ? box_at<RW>(0, 1) : box_at<RW>(wg, 1);

  float acc[NB][NR];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[b][i] = 0.f;

  ring.slot = 0;
  ring.phase = 0;
  for (int j0 = jb; j0 < je; j0 += 64) {
    // ---- H = Xn . W1[j0 + cw .. + 32 (64)]^T, one slot per 32 channels
    float h[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) h[i] = 0.f;
    accumulate_slabs(h, ring, xn, xp, 0, a.kp / 32, r0, t, live, lane, hi, lo);

    // ---- G = GELU(H + b1) into this warpgroup's columns of G, once both
    // warpgroups have read the last chunk's
    float* g = gbuf;
    if (j0 > jb) consumer_barrier();
    if (live) {
#pragma unroll
      for (int i = 0; i < G8; ++i) {
        const int col = cw + 8 * i + 2 * t;
        float2 bias = make_float2(0.f, 0.f);  // hidden units past the last: zero
        if (j0 + col < a.hidden) bias = __ldg(reinterpret_cast<const float2*>(a.b1 + j0 + col));
        *reinterpret_cast<float2*>(g + r0 * kGPitch + col) =
            make_float2(gelu_erf(h[4 * i] + bias.x), gelu_erf(h[4 * i + 1] + bias.y));
        *reinterpret_cast<float2*>(g + (r0 + 8) * kGPitch + col) =
            make_float2(gelu_erf(h[4 * i + 2] + bias.x), gelu_erf(h[4 * i + 3] + bias.y));
      }
    }
    consumer_barrier();  // both halves of G are written

    // ---- acc[b] += G . W2[column block b, j0 .. j0 + 64]^T, two slots each
#pragma unroll
    for (int b = 0; b < NB; ++b)
      accumulate_slabs(acc[b], ring, g, kGPitch, 0, 2, r0, t, live, lane, hi, lo);
  }

  // ---- epilogue: + b2, * gamma, + shortcut, in float; with the hidden
  // chunks split over blocks, this block's partial sums, finished by
  // reduce_splits
  if (!live) return;
  if (a.splits > 1) {
    float* part = a.part + blockIdx.z * a.M * a.c;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < G8; ++i) {
        const int col = col0 + (RW ? 0 : 32 * (wg * NB + b)) + 8 * i + 2 * t;
        if (col >= a.c) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long row = row0 + r0 + 8 * half;
          if (r0 + 8 * half >= a.tm || row >= a.M) continue;
          *reinterpret_cast<float2*>(part + row * a.c + col) =
              make_float2(acc[b][4 * i + 2 * half], acc[b][4 * i + 2 * half + 1]);
        }
      }
    return;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int i = 0; i < G8; ++i) {
      const int col = col0 + (RW ? 0 : 32 * (wg * NB + b)) + 8 * i + 2 * t;
      if (col >= a.c) continue;  // padded columns: never stored
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(a.b2 + col));
      const float2 gm = __ldg(reinterpret_cast<const float2*>(a.gamma + col));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = row0 + r0 + 8 * half;
        if (r0 + 8 * half >= a.tm || row >= a.M) continue;
        const float2 sc = __ldg(reinterpret_cast<const float2*>(a.res + row * a.c + col));
        float2 o;
        o.x = sc.x + (acc[b][4 * i + 2 * half] + b2.x) * gm.x;
        o.y = sc.y + (acc[b][4 * i + 2 * half + 1] + b2.y) * gm.y;
        *reinterpret_cast<float2*>(a.out + row * a.c + col) = o;
      }
    }
  }
}

// The block kernel's taps: depthwise 7x7 SAME + bias of the tile's TM rows
// into Xn (before its LayerNorm), a thread at a time 4 rows of one group of
// 4 channels.  xc: pixel row0 of the input, in the tile or in x itself (a
// tap in bounds of its sample is a row of either, so nothing else is read);
// dws: the taps' weights, [tap][KP]: those that can be in bounds in shared
// memory (a.taps_floats > 0), else all 49 in the workspace.
__device__ __forceinline__ void taps_to_xn(const Args& a, const float* xc, const float* dws,
                                           float* xn, long long row0) {
  const Reach q = reach_of(a.H, a.W);
  const int groups = a.kp / 4, hw = a.H * a.W, xp = a.kp + 4;
  const bool near = a.taps_floats > 0;
  const int nx = near ? 2 * q.rx + 1 : 7, oy = near ? q.ry : 3, ox = near ? q.rx : 3;
  for (int it = threadIdx.x; it < (a.tm / 4) * groups; it += kConsumerThreads) {
    const int g4 = it % groups, rb = 4 * (it / groups);
    float4 v[4];
    int py[4], px[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      const long long p = row0 + rb + i;
      const int rem = static_cast<int>(p % hw);
      py[i] = p < a.M ? rem / a.W : -8;  // rows past M: no tap in bounds, never stored
      px[i] = rem % a.W;
    }
    const int k = 4 * g4;
    if (k < a.c) {
      for (int dy = -q.ry; dy <= q.ry; ++dy) {
        for (int dx = -q.rx; dx <= q.rx; ++dx) {
          const float4 w = *reinterpret_cast<const float4*>(
              dws + ((dy + oy) * nx + dx + ox) * a.kp + k);
          const int shift = dy * a.W + dx;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (static_cast<unsigned>(py[i] + dy) < static_cast<unsigned>(a.H) &&
                static_cast<unsigned>(px[i] + dx) < static_cast<unsigned>(a.W)) {
              const float4 x = *reinterpret_cast<const float4*>(
                  xc + static_cast<long long>(rb + i + shift) * a.c + k);
              v[i].x = fmaf(x.x, w.x, v[i].x), v[i].y = fmaf(x.y, w.y, v[i].y);
              v[i].z = fmaf(x.z, w.z, v[i].z), v[i].w = fmaf(x.w, w.w, v[i].w);
            }
          }
        }
      }
      const float4 bv = __ldg(reinterpret_cast<const float4*>(a.dw_b + k));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = make_float4(v[i].x + bv.x, v[i].y + bv.y, v[i].z + bv.z, v[i].w + bv.w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) *reinterpret_cast<float4*>(xn + (rb + i) * xp + k) = v[i];
  }
}

// BLOCK false: fused_ln_mlp over (M, C) rows.  BLOCK true: the whole
// ConvNeXt block on (B, H, W, C) x, its input tile in shared memory when
// a.tile_floats > 0.
template <int NB, bool BLOCK, bool RW>
__global__ void __maxnreg__(kMaxRegs) tf32x3_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* xn = reinterpret_cast<float*>(base + xn_offset(a.stages));
  float* gbuf = reinterpret_cast<float*>(base + g_offset(a.stages, a.tm, a.kp));
  float* tile = reinterpret_cast<float*>(base + tile_offset(a.stages, a.tm, a.kp));
  unsigned char* bars = base + bar_offset(a.stages, a.tm, a.kp, a.tile_floats + a.taps_floats);
  SlotRing ring;
  ring.tiles = smem_u32(base);
  ring.full = smem_u32(bars);
  ring.empty = ring.full + 8 * kMaxStages;
  ring.stages = a.stages;
  const uint32_t tile_bar = ring.empty + 8 * kMaxStages;
  init_barriers(ring.full, ring.empty, tile_bar, a.stages);
  const long long row0 = static_cast<long long>(blockIdx.x) * a.tm;
  const int col0 = static_cast<int>(blockIdx.y) * 64 * NB;
  const int jb = static_cast<int>(blockIdx.z) * a.cps * 64;
  const int je = jb + a.cps * 64 < a.hp ? jb + a.cps * 64 : a.hp;
  const Reach q = BLOCK ? reach_of(a.H, a.W) : Reach{0, 0, 0, 1};

  if (threadIdx.x >= kConsumerThreads) {
    if (threadIdx.x == kConsumerThreads) {
      if (BLOCK && a.tile_floats > 0) {
        // the input rows with their halo, clipped to the rows that exist
        const long long lo = row0 - q.halo > 0 ? row0 - q.halo : 0;
        const long long hi = row0 + a.tm + q.halo < a.M ? row0 + a.tm + q.halo : a.M;
        const uint32_t bytes = static_cast<uint32_t>((hi - lo) * a.c * 4);
        mbar_expect_tx(tile_bar, bytes);
        bulk_load_1d(smem_u32(tile) + static_cast<uint32_t>((lo - (row0 - q.halo)) * a.c * 4),
                     a.src + lo * a.c, bytes, tile_bar);
      }
      produce<NB, RW>(ring, a, col0, jb, je);
    }
    return;
  }
  if constexpr (BLOCK) {
    const float* xc = a.src + row0 * a.c;
    if (a.tile_floats > 0) {
      mbar_wait(tile_bar, 0);
      xc = tile + q.halo * a.c;
    }
    // the weights of the taps that can be in bounds, from the workspace's
    // [49][KP] into shared memory where they fit, else read from it
    const float* dws = a.dw_t;
    if (a.taps_floats > 0) {
      float* d = tile + a.tile_floats;
      const int nx = 2 * q.rx + 1;
      for (int i = threadIdx.x; i < a.taps_floats / 4; i += kConsumerThreads) {
        const int tap = i / (a.kp / 4), k = 4 * (i % (a.kp / 4));
        const int dy = tap / nx - q.ry, dx = tap % nx - q.rx;
        *reinterpret_cast<float4*>(d + tap * a.kp + k) =
            __ldg(reinterpret_cast<const float4*>(a.dw_t + ((dy + 3) * 7 + dx + 3) * a.kp + k));
      }
      consumer_barrier();
      dws = d;
    }
    taps_to_xn(a, xc, dws, xn, row0);
    consumer_barrier();
    layer_norm_tile(xn, a.kp + 4, a.M - row0, xn, a);  // in place
  } else {
    layer_norm_tile(a.src + row0 * a.c, a.c, a.M - row0, xn, a);
  }
  consumer_barrier();  // Xn is complete
  consume<NB, RW>(ring, a, xn, gbuf, row0, col0, jb, je);
}

// The hidden chunks split over blocks: out = shortcut + (the partial sums
// in split order + b2) * gamma, in float.
static __global__ void __launch_bounds__(256)
    reduce_splits(const float* __restrict__ part, const float* __restrict__ res,
                  const float* __restrict__ b2, const float* __restrict__ gamma,
                  float* __restrict__ out, long long M, int c, int splits) {
  const long long n = M * c;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * 256) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    const int col = static_cast<int>(i % c);
    out[i] = res[i] + (s + b2[col]) * gamma[col];
  }
}

// ------------------------------ host ------------------------------

// A map over a row-major (rows, cols) float matrix that loads 32 x 32 boxes
// with the 128-byte swizzle; boxes past its extents arrive as zeros.
inline cudaError_t box_map(CUtensorMap* map, const float* w, int rows, int cols) {
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {32, 32};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(w),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool BLOCK>
static cudaError_t launch_nb(const Plan32& p, const Args& a, cudaStream_t stream) {
#define BTS_NB(N)                                                                       \
  case N: {                                                                             \
    const auto kernel = p.tm == 128 ? tf32x3_kernel<1, BLOCK, true>                     \
                                    : tf32x3_kernel<N, BLOCK, false>;                   \
    cudaError_t err =                                                                   \
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes); \
    if (err != cudaSuccess) return err;                                                 \
    kernel<<<dim3(static_cast<unsigned>((a.M + p.tm - 1) / p.tm), p.slices, p.splits),  \
             kBlockThreads, p.bytes, stream>>>(a);                                      \
    return cudaGetLastError();                                                          \
  }
  switch (p.nb) {
    BTS_NB(1)
    BTS_NB(2)
    BTS_NB(3)
    BTS_NB(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef BTS_NB
}

// Checks, the split pass, the maps, the launch.  dw_w == nullptr: ln_mlp.
static cudaError_t run(const void* src, const void* res, const void* dw_w, const void* dw_b,
                       const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* gamma, void* out, void* ws,
                       long long ws_bytes, long long M, int H, int W, int C, int hidden,
                       float eps, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  const bool block = dw_w != nullptr;
  Plan32 p;
  if (!plan_for(M, C, hidden, block ? H : 0, W, &p)) return cudaErrorInvalidValue;
  if (ws_bytes < 4 * workspace_floats(p, M, C, hidden, block)) return cudaErrorInvalidValue;
  for (const void* q : {src, res, ln_w, ln_b, w1, b1, w2, b2, gamma,
                        static_cast<const void*>(out), static_cast<const void*>(ws)})
    if (!aligned16(q)) return cudaErrorMisalignedAddress;
  if (block && !aligned16(dw_b)) return cudaErrorMisalignedAddress;
  if (M > 0x7fffffffLL * p.tm) return cudaErrorInvalidConfiguration;

  float* w = static_cast<float*>(ws);
  const long long n1 = static_cast<long long>(p.hp) * p.kp, n2 = static_cast<long long>(C) * p.hp;
  const long long total = weights_floats(C, hidden, block);
  const long long grid = (total + 255) / 256 < 8LL * kSms ? (total + 255) / 256 : 8LL * kSms;
  split_weights_kernel<<<static_cast<unsigned>(grid), 256, 0, stream>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(dw_w), w, C, hidden, p.kp, p.hp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Args a;
  if ((err = box_map(&a.w1hi, w, p.hp, p.kp)) != cudaSuccess) return err;
  if ((err = box_map(&a.w1lo, w + n1, p.hp, p.kp)) != cudaSuccess) return err;
  if ((err = box_map(&a.w2hi, w + 2 * n1, C, p.hp)) != cudaSuccess) return err;
  if ((err = box_map(&a.w2lo, w + 2 * n1 + n2, C, p.hp)) != cudaSuccess) return err;
  a.src = static_cast<const float*>(src);
  a.res = static_cast<const float*>(res);
  a.ln_w = static_cast<const float*>(ln_w);
  a.ln_b = static_cast<const float*>(ln_b);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.gamma = static_cast<const float*>(gamma);
  a.dw_t = block ? w + 2 * n1 + 2 * n2 : nullptr;
  a.dw_b = static_cast<const float*>(dw_b);
  a.out = static_cast<float*>(out);
  a.part = w + total;
  a.M = M;
  a.c = C;
  a.hidden = hidden;
  a.hp = p.hp;
  a.kp = p.kp;
  a.tm = p.tm;
  a.stages = p.stages;
  a.tile_floats = p.tile_floats;
  a.taps_floats = p.taps_floats;
  a.splits = p.splits;
  a.cps = p.cps;
  a.H = block ? H : 0;
  a.W = block ? W : 0;
  a.eps = eps;
  err = block ? launch_nb<true>(p, a, stream) : launch_nb<false>(p, a, stream);
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long n = M * C;
  reduce_splits<<<static_cast<unsigned>((n + 255) / 256 < 8LL * kSms ? (n + 255) / 256
                                                                      : 8LL * kSms),
                  256, 0, stream>>>(a.part, a.res, a.b2, a.gamma, a.out, M, C, p.splits);
  return cudaGetLastError();
}

}  // namespace tf32x3
}  // namespace btsbot

// As btsbot_ln_mlp (ln_mlp.cu) in float32, at any C up to 1024 and any hidden width, both multiples of 8.  ws: a float workspace
// of btsbot_tf32x3_workspace_floats(M, C, hidden, 0) floats (ws_bytes says
// how many bytes it holds), written by the launch; eps the LayerNorm's.
extern "C" int btsbot_ln_mlp_tf32x3(const void* h, const void* res, const void* ln_w,
                                    const void* ln_b, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* gamma,
                                    void* out, void* ws, long long ws_bytes, long long M, int C,
                                    int hidden, float eps, void* stream) {
  return btsbot::tf32x3::run(h, res, nullptr, nullptr, ln_w, ln_b, w1, b1, w2, b2, gamma, out,
                             ws, ws_bytes, M, 0, 0, C, hidden, eps,
                             static_cast<cudaStream_t>(stream));
}

// As btsbot_convnext_block (convnext_block.cu) in float32, at any C up to 1024 and any hidden width, both multiples of 8; ws as
// above with the taps' weights (btsbot_tf32x3_workspace_floats(B H W, C,
// hidden, 1)).
extern "C" int btsbot_convnext_block_tf32x3(const void* x, const void* dw_w, const void* dw_b,
                                            const void* ln_w, const void* ln_b, const void* w1,
                                            const void* b1, const void* w2, const void* b2,
                                            const void* gamma, void* out, void* ws,
                                            long long ws_bytes, int B, int H, int W, int C,
                                            int hidden, void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  return btsbot::tf32x3::run(x, x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, ws,
                             ws_bytes, M, H, W, C, hidden, btsbot::kLnEps,
                             static_cast<cudaStream_t>(stream));
}

// Floats of the workspace a launch over M rows at widths C and hidden needs
// (taps: the block kernel's); 0 for widths the kernels do not take.
extern "C" long long btsbot_tf32x3_workspace_floats(long long M, int C, int hidden, int taps) {
  btsbot::tf32x3::Plan32 p;
  if (!btsbot::tf32x3::plan_for(M > 0 ? M : 1, C, hidden, 0, 0, &p)) return 0;
  return btsbot::tf32x3::workspace_floats(p, M > 0 ? M : 1, C, hidden, taps != 0);
}

// Rows of the flattened index one block of the float32 kernels takes at
// width C (0: a width they do not take).
extern "C" int btsbot_tf32x3_rows(int C) {
  btsbot::tf32x3::Plan32 p;
  if (!btsbot::tf32x3::plan_for(1, C, 4 * C, 0, 0, &p)) return 0;
  return p.tm;
}

// Whether the float32 block kernel keeps the input tile of an (H, W) map
// in shared memory at width C (1), reads x through L2 (0), or does not take
// the width (-1).
extern "C" int btsbot_tf32x3_tiles_input(int C, int H, int W) {
  btsbot::tf32x3::Plan32 p;
  if (!btsbot::tf32x3::plan_for(1, C, 4 * C, H, W, &p)) return -1;
  return p.tile_floats > 0;
}
