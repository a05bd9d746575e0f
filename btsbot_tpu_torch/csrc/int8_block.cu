// One quantized ConvNeXt block of the int8 serving path in one launch, on
// NHWC input x (B, H, W, C) in T = float32 or bfloat16:
//
//   q_x  = clip(round_half_even(x / s_x), -127, 127)          (IEEE division)
//   acc  = sum of the 49 taps q_x * dw_q[c], zero padding, exact
//   h    = T(T(float(acc) * f32(s_x * dw_s[c])) + T(dw_b))
//   h    = T(T(T(LN(h)) * T(ln_w)) + T(ln_b))                 (statistics in float, eps 1e-6)
//   q_h  = clip(round_half_even(h / s_h), -127, 127)
//   g    = T(GELU_tanh(T(T(float(q_h . fc1_q^T) * f32(s_h * w1_s[n])) + T(b1))))
//   q_g  = clip(round_half_even(g / s_g), -127, 127)
//   out  = T(x + T(T(T(float(q_g . fc2_q^T) * f32(s_g * w2_s[n])) + T(b2)) * T(gamma)))
//
// No TPU kernel: the JAX package's int8 forward (btsbot_tpu/ops/quantized.py,
// quantized_convnext_logits, :194-218) leaves the block to XLA as about
// twenty-five elementwise passes around three int8 products; its own notes
// (:22-30) name this kernel as the way to make the path worth having.  The
// port ran the same composition eagerly (ops/quantized.py, with the taps in
// csrc/int8_dwconv.cu), about 25 launches a block.  Here every rounding point
// is the port's plain version's (int8_block_reference): __fdiv_rn, rintf,
// __fmul_rn and __fadd_rn keep nvcc from contracting or approximating (the
// build has no --use_fast_math), int32 -> float is round to nearest
// (__int2float_rn: |q_g . fc2_q^T| reaches 4 C 127^2, above 2^24 at C >= 256).
// Two pieces of arithmetic are not bit for bit the plain version's: the
// LayerNorm's sums run in another order (and rsqrtf is not correctly rounded),
// so q_h can land one int8 step away; in bfloat16 GELU's tanh is
// tanh.approx.f32 (relative error about 2^-11, under bf16's half ulp), so q_g
// can too.  float32 takes tanhf.  Given q_g, the output is bit for bit.
//
// What bounds it on the H100: per pixel two int8 products of 4 C^2
// multiply-adds each and 49 C taps, against x read once and out written once
// (plus the weights): the bytes bound it at every ConvNeXt width (2,000 int8
// TOP/s against 3.35 TB/s).  The design is the bfloat16 block kernel's
// (convnext_block.cu, hopper_mlp.cuh), with int8 operands:
//
//   block     288 threads: two consumer warpgroups and a producer warp whose
//             one thread starts every TMA copy; one block an SM (168
//             registers a thread).  A block takes TM consecutive pixels of
//             the flattened (B*H*W) index, as Plan<CP, true> lays them out
//             (hopper_mlp.cuh: TM = 128 up to CP = 256, 64 above, the output
//             columns split over the warpgroups above 256 and over
//             blockIdx.y above 512), CP = 64 ceil(C / 64).
//   the taps  every input a tap of the tile can touch lies in the flattened
//             range [row0 - halo, row0 + TM + halo) (block_common.cuh
//             reach_of).  The consumers quantize that range once, into a
//             shared tile of bytes (q + 128, one a channel, rows of CP);
//             each tap reads 8 channels as 8 bytes and turns them back into
//             floats with a byte permute and a subtraction (2^23 + byte -
//             (2^23 + 128), exact), then 8 exact float FMAs (|acc| <= 49
//             127^2 < 2^24).  Only taps that land inside the map are visited
//             (one at 1x1, nine of the 25 stored at 3x3 for a centre pixel).
//             The taps' weights sit beside the tile as floats, [tap][CP],
//             only the (2 ry + 1)(2 rx + 1) that can be in bounds.  The
//             lanes are dealt out over a row's 8-channel vectors to the real
//             C, not to CP: lpp lanes a row, vec vectors a lane, lpp a power
//             of two chosen on the host for the fewest idle slots (C = 80:
//             2 lanes x 5 vectors, none idle; C = 40: 2 x 3, one of six).
//   LN        in registers, over each row's lanes (shuffles), then q_h into
//             Xq: int8 rows of 128 bytes (one k128 slab a row, [CP / 128
//             rounded up][TM][128]) with the 128-byte swizzle of the wgmma
//             descriptor, channels c .. CP zero.
//   products  fc1 and fc2 as wgmma.mma_async m64n64k32 .s32.s8.s8, A and B
//             from shared memory, int32 accumulators (exact).  Both
//             nn.Linear layouts are K-major, as int8 wgmma requires of both
//             operands, so nothing is transposed.  The weights come in by
//             TMA through the ring of hopper_mlp.cuh: a unit is 64 rows x 128
//             int8 = 8 KB, as a bf16 unit is; a hidden chunk is 128 units
//             wide (the K of one fc2 unit), its first product done as two
//             64-unit halves (KS1 fc1 units each), then one fc2 unit for each
//             64-column accumulator block.  Units past the matrices' real
//             extents arrive as zeros (TMA's out-of-bounds fill); zero int8
//             in padded lanes is exact.  fc1's rows are C bytes apart, which
//             TMA takes only as a multiple of 16: the caller passes a copy
//             padded to 16 bytes a row where C is not (made once per weight,
//             ops/quantized.py).
//   q_g       the s32 accumulator fragment is not the register layout of an
//             s8 A fragment (8-bit A packs four consecutive k a register),
//             so the route taken is the simple one: GELU, quantize, and q_g
//             into a swizzled 64 x 128 int8 tile of shared memory a
//             warpgroup, which the second product reads as A.  Its cost: 8
//             KB of shared memory a warpgroup, two 16-bit stores a value
//             pair, and a warpgroup barrier and proxy fence each chunk before
//             the product may read it (and one before the next chunk writes
//             it).  Permuting in registers (__byte_perm + shuffles) is left
//             to later work (ROADMAP B13).
//   epilogue + b2, * gamma, + x (read again from device memory through L2),
//             rounded as above, stored two values a thread.
//
// Optional debug outputs (null when serving: one branch each): q_h (M, C) and
// q_g (M, hidden) as int8, for the checks on the card.

#include "block_common.cuh"
#include "hopper_mlp.cuh"

namespace btsbot {
namespace int8blk {

using namespace hopper;

constexpr int kMaxRegs = 168;      // 9 warps, one block an SM (hopper_mlp.cuh Plan)
constexpr int kVecMax = 5;         // 8-channel vectors a lane holds of a row
constexpr int kChunk = 128;        // hidden units a chunk: the K of one fc2 unit
constexpr int kGBytes = 64 * 128;  // a warpgroup's q_g tile
constexpr float kZeroByte = 8388736.0f;  // 2^23 + 128: a biased byte's float offset

template <int CP> struct Geo {
  using P = Plan<CP, true>;
  static constexpr int KS1 = (CP + 127) / 128;  // k128 slabs of the first product
  static constexpr int XQ_BYTES = KS1 * P::TM * 128;
};

// Shared memory besides the ring: Xq, both q_g tiles, the quantized input
// tile with its halo, the taps' weights.
template <int CP> constexpr int fixed_bytes(int halo, int taps) {
  return Geo<CP>::XQ_BYTES + 2 * kGBytes + (Plan<CP, true>::TM + 2 * halo) * CP + taps * CP * 4;
}

// ------------------------------ PTX ------------------------------

#define BTS_I8(d, i)                                                                  \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),         \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 64, int32) = or += A (64 x 32, int8, shared) . B (64 x 32, int8, shared)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " BTS_D32_LIST
      ", %32, %33, p;\n}\n"
      : BTS_I8(d, 0), BTS_I8(d, 8), BTS_I8(d, 16), BTS_I8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void fence_regs(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the four warps of warpgroup wg (barriers 2 and 3; 1 is consumer_barrier)
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// ------------------------------ values ------------------------------

// v rounded to T and back
template <typename T> __device__ __forceinline__ float rt(float v);
template <> __device__ __forceinline__ float rt<float>(float v) { return v; }
template <> __device__ __forceinline__ float rt<bf16>(float v) { return rb(v); }

// T(T(acc * s) + b): an exact sum dequantized, then biased
template <typename T> __device__ __forceinline__ float dequant(float acc, float s, float b) {
  return rt<T>(__fadd_rn(rt<T>(__fmul_rn(acc, s)), b));
}

// 8 consecutive values (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* __restrict__ p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* __restrict__ p, float (&f)[8]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}
// 2 consecutive values (4- or 8-byte aligned)
__device__ __forceinline__ float2 load2(const float* __restrict__ p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const bf16* __restrict__ p) {
  const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(p));
  return make_float2(lo_f(u), hi_f(u));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}

// clip(round_half_even(v / s), -127, 127)
__device__ __forceinline__ int quantize(float v, float s) {
  return __float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}

// 8 int8 values (each + bias, as bytes) in two words
__device__ __forceinline__ uint2 pack8(const int (&q)[8], int bias) {
  uint2 w;
  w.x = ((q[0] + bias) & 0xff) | (((q[1] + bias) & 0xff) << 8) |
        (((q[2] + bias) & 0xff) << 16) | (static_cast<uint32_t>(q[3] + bias) << 24);
  w.y = ((q[4] + bias) & 0xff) | (((q[5] + bias) & 0xff) << 8) |
        (((q[6] + bias) & 0xff) << 16) | (static_cast<uint32_t>(q[7] + bias) << 24);
  return w;
}

// 8 biased bytes (q + 128) back to the floats q, exactly
__device__ __forceinline__ void unbias8(uint2 w, float (&f)[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = __int_as_float(__byte_perm(w.x, 0x4B000000u, 0x7540u | k)) - kZeroByte;
    f[4 + k] = __int_as_float(__byte_perm(w.y, 0x4B000000u, 0x7540u | k)) - kZeroByte;
  }
}

// GELU, tanh form, of a value already rounded to T; the caller rounds
template <typename T> __device__ __forceinline__ float gelu_t(float x);
template <> __device__ __forceinline__ float gelu_t<float>(float x) {
  return 0.5f * x * (1.0f + tanhf(0.79788456080286536f * (x + 0.044715f * x * x * x)));
}
template <> __device__ __forceinline__ float gelu_t<bf16>(float x) { return gelu_tanh(x); }

// Byte k (a multiple of 2) of row r of a swizzled tile of 128-byte rows.
__device__ __forceinline__ int swz(int r, int k) {
  return r * 128 + ((((k >> 4) ^ (r & 7)) << 4) | (k & 15));
}
// Channel ch (a multiple of 8) of row r of Xq.
template <int CP> __device__ __forceinline__ int xq_at(int r, int ch) {
  return (ch >> 7) * (Plan<CP, true>::TM * 128) + swz(r, ch & 127);
}

__device__ __forceinline__ float lane_group_sum(float v, int lpp) {
  for (int o = lpp >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------ roles ------------------------------

// The producer thread: per chunk of 128 hidden units, the fc1 units of its
// two halves (KS1 each, K slabs in order), then one fc2 unit for each
// accumulator block, alternating between the warpgroups when the columns
// are split over them; the order the consumers take them in.
template <int CP>
__device__ __forceinline__ void produce(Ring ring, const CUtensorMap* map1,
                                        const CUtensorMap* map2, int hidden,
                                        Slice<Plan<CP, true>> sl) {
  using P = Plan<CP, true>;
  ring.slot = 0;
  ring.phase = 1;  // a fresh barrier lets a wait on the other parity through
  for (int j0 = 0; j0 < hidden; j0 += kChunk) {
    for (int sc = 0; sc < 2 && j0 + 64 * sc < hidden; ++sc) {
      for (int s = 0; s < Geo<CP>::KS1; ++s) {
        mbar_wait(ring.empty_bar(ring.slot), ring.phase);
        mbar_expect_tx(ring.full_bar(), kUnitBytes);
        tma_load_2d(ring.tile(), map1, ring.full_bar(), s * 128, j0 + 64 * sc);
        ring.advance();
      }
    }
    for (int u = 0; u < P::NBW * P::CS; ++u) {
      const int k = u / P::CS, c2 = u % P::CS;
      if (!sl.has(c2, k)) continue;
      mbar_wait(ring.empty_bar(ring.slot), ring.phase);
      mbar_expect_tx(ring.full_bar(), kUnitBytes);
      tma_load_2d(ring.tile(), map2, ring.full_bar(), j0, (sl.blk0 + c2 * P::NBW + k) * 64);
      ring.advance();
    }
  }
}

template <int CP, typename T>
__global__ void __maxnreg__(kMaxRegs)
    int8_block_kernel(const __grid_constant__ CUtensorMap map1,
                      const __grid_constant__ CUtensorMap map2, const T* __restrict__ x,
                      const int8_t* __restrict__ dw_q, const float* __restrict__ dw_s,
                      const T* __restrict__ dw_b, const T* __restrict__ ln_w,
                      const T* __restrict__ ln_b, const float* __restrict__ w1_s,
                      const T* __restrict__ b1, const float* __restrict__ w2_s,
                      const T* __restrict__ b2, const T* __restrict__ gamma,
                      T* __restrict__ out, int8_t* __restrict__ dbg_qh,
                      int8_t* __restrict__ dbg_qg, float s_x, float s_h, float s_g, int B,
                      int H, int W, int c, int hidden, int stages, int lpp, int vec) {
  using P = Plan<CP, true>;
  using Gm = Geo<CP>;
  const Reach q = reach_of(H, W);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* xq = base + stages * kUnitBytes;
  unsigned char* gt = xq + Gm::XQ_BYTES;  // [2][64][128]
  unsigned char* qx = gt + 2 * kGBytes;   // [TM + 2 halo][CP], rows row0 - halo ...
  float* taps = reinterpret_cast<float*>(qx + (P::TM + 2 * q.halo) * CP);  // [tap][CP]
  unsigned char* bars = reinterpret_cast<unsigned char*>(taps + q.taps * CP);
  Ring ring;
  ring.tiles = smem_u32(base);
  ring.full = smem_u32(bars);
  ring.empty = ring.full + 8 * kMaxStages;
  ring.stages = stages;
  init_barriers(ring.full, ring.empty, ring.empty + 8 * kMaxStages, stages);
  const long long M = static_cast<long long>(B) * H * W;
  const long long row0 = static_cast<long long>(blockIdx.x) * P::TM;
  const Slice<P> sl = Slice<P>::of_block();

  if (threadIdx.x >= kConsumerThreads) {
    if (threadIdx.x == kConsumerThreads) produce<CP>(ring, &map1, &map2, hidden, sl);
    return;
  }
  const int t = threadIdx.x;

  // ---- the taps' weights as floats, Xq's padded channels as zeros, and
  // the input range the taps reach quantized once, as biased bytes
  const int nx = 2 * q.rx + 1;
  for (int i = t; i < q.taps * CP; i += kConsumerThreads) {
    const int tap = i / CP, ch = i - tap * CP;
    const int ty = tap / nx, tx = tap - ty * nx;
    taps[i] = ch < c ? static_cast<float>(dw_q[((ty + 3 - q.ry) * 7 + tx + 3 - q.rx) * c + ch])
                     : 0.f;
  }
  const int pad8 = (CP - c) / 8;
  for (int i = t; i < P::TM * pad8; i += kConsumerThreads) {
    const int r = i / pad8;
    *reinterpret_cast<uint2*>(xq + xq_at<CP>(r, c + 8 * (i - r * pad8))) = make_uint2(0u, 0u);
  }
  {
    const long long first = row0 - q.halo;  // the input tile's row 0
    const long long lo = first > 0 ? first : 0;
    const long long hi = row0 + P::TM + q.halo < M ? row0 + P::TM + q.halo : M;
    const int per_row = c / 8;
    const int n8 = static_cast<int>(hi - lo) * per_row;
    const T* src = x + lo * c;
    unsigned char* dst = qx + (lo - first) * CP;
    for (int k = t; k < n8; k += kConsumerThreads) {
      const int rr = k / per_row, col = (k - rr * per_row) * 8;
      float v[8];
      load8(src + static_cast<long long>(rr) * c + col, v);
      int qv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[e] = quantize(v[e], s_x);
      *reinterpret_cast<uint2*>(dst + rr * CP + col) = pack8(qv, 128);
    }
  }
  consumer_barrier();

  // ---- taps, dequantize + bias, LayerNorm, q_h into Xq: lpp lanes a row,
  // vec 8-channel vectors a lane, two rows at a time
  {
    const int l = t % lpp, grp = t / lpp, groups = kConsumerThreads / lpp;
    const int rows_per = P::TM / groups;
    const int hw = H * W;
    const float inv_c = 1.0f / c;
    const bool write_qh = dbg_qh != nullptr && blockIdx.y == 0;
    for (int i0 = 0; i0 < rows_per; i0 += 2) {
      int r[2], py[2], px[2];
      bool live[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        live[i] = i0 + i < rows_per;
        r[i] = grp + (i0 + i) * groups;
        const long long p = row0 + r[i];
        const int rem = static_cast<int>(p % hw);
        py[i] = live[i] && p < M ? rem / W : -8;  // no tap in bounds, never stored
        px[i] = rem - (rem / W) * W;
      }
      float v[2][kVecMax][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int vv = 0; vv < kVecMax; ++vv)
#pragma unroll
          for (int e = 0; e < 8; ++e) v[i][vv][e] = 0.f;
#pragma unroll
      for (int vv = 0; vv < kVecMax; ++vv) {
        const int ch = 8 * (vv * lpp + l);
        if (vv >= vec || ch >= c) continue;
        for (int dy = -q.ry; dy <= q.ry; ++dy) {
          for (int dx = -q.rx; dx <= q.rx; ++dx) {
            const float* wt = taps + ((dy + q.ry) * nx + dx + q.rx) * CP + ch;
            const float4 wa = *reinterpret_cast<const float4*>(wt);
            const float4 wb = *reinterpret_cast<const float4*>(wt + 4);
            const int shift = dy * W + dx;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (static_cast<unsigned>(py[i] + dy) < static_cast<unsigned>(H) &&
                  static_cast<unsigned>(px[i] + dx) < static_cast<unsigned>(W)) {
                float f[8];
                unbias8(*reinterpret_cast<const uint2*>(qx + (r[i] + q.halo + shift) * CP + ch),
                        f);
                float(&a)[8] = v[i][vv];
                a[0] = fmaf(f[0], wa.x, a[0]), a[1] = fmaf(f[1], wa.y, a[1]);
                a[2] = fmaf(f[2], wa.z, a[2]), a[3] = fmaf(f[3], wa.w, a[3]);
                a[4] = fmaf(f[4], wb.x, a[4]), a[5] = fmaf(f[5], wb.y, a[5]);
                a[6] = fmaf(f[6], wb.z, a[6]), a[7] = fmaf(f[7], wb.w, a[7]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float s = 0.f;
#pragma unroll
        for (int vv = 0; vv < kVecMax; ++vv) {
          const int ch = 8 * (vv * lpp + l);
          if (vv >= vec || ch >= c) continue;
          float ds[8], db[8];
          load8(dw_s + ch, ds);
          load8(dw_b + ch, db);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[i][vv][e] = dequant<T>(v[i][vv][e], __fmul_rn(s_x, ds[e]), db[e]);
            s += v[i][vv][e];
          }
        }
        const float mu = lane_group_sum(s, lpp) * inv_c;
        float ss = 0.f;
#pragma unroll
        for (int vv = 0; vv < kVecMax; ++vv) {
          const int ch = 8 * (vv * lpp + l);
          if (vv >= vec || ch >= c) continue;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = v[i][vv][e] - mu;
            ss += d * d;
          }
        }
        const float rstd = rsqrtf(lane_group_sum(ss, lpp) * inv_c + kLnEps);
        const long long p = row0 + r[i];
#pragma unroll
        for (int vv = 0; vv < kVecMax; ++vv) {
          const int ch = 8 * (vv * lpp + l);
          if (!live[i] || vv >= vec || ch >= c) continue;
          float w[8], b[8];
          load8(ln_w + ch, w);
          load8(ln_b + ch, b);
          int qh[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float o = rt<T>(__fmul_rn(__fsub_rn(v[i][vv][e], mu), rstd));
            qh[e] = quantize(rt<T>(__fadd_rn(rt<T>(__fmul_rn(o, w[e])), b[e])), s_h);
          }
          const uint2 packed = pack8(qh, 0);
          *reinterpret_cast<uint2*>(xq + xq_at<CP>(r[i], ch)) = packed;
          if (write_qh && p < M) *reinterpret_cast<uint2*>(dbg_qh + p * c + ch) = packed;
        }
      }
    }
  }
  fence_proxy_async();  // Xq was written by ordinary stores, wgmma reads it
  consumer_barrier();

  // ---- both products over the hidden chunks, then the epilogue
  const int wg = t >> 7;
  const int rg = P::CS == 1 ? wg : 0;  // which 64 rows
  const int cs = P::CS == 1 ? 0 : wg;  // which share of the columns
  const int lane = t & 31;
  const int t2 = (lane & 3) * 2;
  const int frow = ((t >> 5) & 3) * 16 + (lane >> 2);  // fragment row, +8
  unsigned char* gtile = gt + wg * kGBytes;
  const uint32_t a_base = smem_u32(xq) + rg * (64 * 128);
  const uint64_t dg = wgmma_desc(smem_u32(gtile));
  const bool write_qg = dbg_qg != nullptr && cs == 0 && blockIdx.y == 0;

  int acc[P::NBW][32];
#pragma unroll
  for (int nb = 0; nb < P::NBW; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0;
  ring.slot = 0;
  ring.phase = 0;

  for (int j0 = 0; j0 < hidden; j0 += kChunk) {
    for (int sc = 0; sc < 2; ++sc) {
      const int hj = j0 + 64 * sc;
      if (hj >= hidden) break;
      // ---- H = q_h . fc1_q[hj .. hj+64]^T, one unit per 128 input channels
      int h[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h[i] = 0;
      fence_regs(h);
      wgmma_fence();
      int held = -1;  // slot whose products may still be reading it
#pragma unroll
      for (int s = 0; s < Gm::KS1; ++s) {
        mbar_wait(ring.full_bar(), ring.phase);
        const uint64_t da = wgmma_desc(a_base + s * (P::TM * 128));
        const uint64_t db = wgmma_desc(ring.tile());
        constexpr int kRest = CP - 128 * (Gm::KS1 - 1);  // channels of the last slab
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (s < Gm::KS1 - 1 || kk * 32 < kRest)
            wgmma_s8(h, da + 2 * kk, db + 2 * kk, (s | kk) != 0);
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

      // ---- q_g = quantize(GELU(dequantize(H) + b1)) into this warpgroup's tile
      if (sc == 0) wg_barrier(wg);  // the previous chunk's second product is done with it
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = hj + 8 * i + t2;  // j and j + 1: both below hidden or neither
        float sa = 0.f, sb = 0.f;
        float2 bias = make_float2(0.f, 0.f);
        if (j < hidden) {
          sa = __fmul_rn(s_h, __ldg(w1_s + j));
          sb = __fmul_rn(s_h, __ldg(w1_s + j + 1));
          bias = load2(b1 + j);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = frow + 8 * half;
          const float y0 = dequant<T>(__int2float_rn(h[4 * i + 2 * half]), sa, bias.x);
          const float y1 = dequant<T>(__int2float_rn(h[4 * i + 2 * half + 1]), sb, bias.y);
          const int q0 = quantize(rt<T>(gelu_t<T>(y0)), s_g);
          const int q1 = quantize(rt<T>(gelu_t<T>(y1)), s_g);
          const uint16_t pair = static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
          *reinterpret_cast<uint16_t*>(gtile + swz(rr, 64 * sc + 8 * i + t2)) = pair;
          const long long p = row0 + rg * 64 + rr;
          if (write_qg && p < M && j < hidden)
            *reinterpret_cast<uint16_t*>(dbg_qg + p * hidden + j) = pair;
        }
      }
    }
    fence_proxy_async();  // q_g was written by ordinary stores, wgmma reads it
    wg_barrier(wg);

    // ---- acc[k] += q_g . fc2_q[64-column block of acc[k], j0 .. j0+128]^T:
    // the K steps past hidden multiply the zeros TMA filled the unit with
#pragma unroll
    for (int nb = 0; nb < P::NBW; ++nb) fence_regs(acc[nb]);
    wgmma_fence();
    int held2[P::CS];
    bool holding = false;
#pragma unroll
    for (int k = 0; k < P::NBW; ++k) {
      // as hopper_mlp.cuh consume_mlp: a warpgroup without a k-th block
      // multiplies the other's unit into an accumulator it never stores
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
      for (int kk = 0; kk < 4; ++kk) wgmma_s8(acc[k], dg + 2 * kk, db + 2 * kk, 1);
      wgmma_commit();
      if (holding) {
        wgmma_wait<1>();
#pragma unroll
        for (int c2 = 0; c2 < P::CS; ++c2)
          if (lane == 0 && held2[c2] >= 0) mbar_arrive(ring.empty_bar(held2[c2]));
      }
#pragma unroll
      for (int c2 = 0; c2 < P::CS; ++c2) held2[c2] = slots[c2];
      holding = true;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c2 = 0; c2 < P::CS; ++c2)
      if (lane == 0 && held2[c2] >= 0) mbar_arrive(ring.empty_bar(held2[c2]));
#pragma unroll
    for (int nb = 0; nb < P::NBW; ++nb) fence_regs(acc[nb]);
  }

  // ---- epilogue: dequantize, + b2, * gamma, + x
#pragma unroll
  for (int nb = 0; nb < P::NBW; ++nb) {
    if (!sl.has(cs, nb)) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = (sl.blk0 + cs * P::NBW + nb) * 64 + 8 * i + t2;
      if (col >= c) continue;  // padded columns: zeros, never stored
      const float sa = __fmul_rn(s_g, __ldg(w2_s + col));
      const float sb = __fmul_rn(s_g, __ldg(w2_s + col + 1));
      const float2 bias = load2(b2 + col);
      const float2 gm = load2(gamma + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long p = row0 + rg * 64 + frow + 8 * half;
        if (p >= M) continue;
        const float2 xs = load2(x + p * c + col);
        const float y0 = dequant<T>(__int2float_rn(acc[nb][4 * i + 2 * half]), sa, bias.x);
        const float y1 = dequant<T>(__int2float_rn(acc[nb][4 * i + 2 * half + 1]), sb, bias.y);
        const float z0 = rt<T>(__fmul_rn(y0, gm.x)), z1 = rt<T>(__fmul_rn(y1, gm.y));
        store2(out + p * c + col, __fadd_rn(xs.x, z0), __fadd_rn(xs.y, z1));
      }
    }
  }
}

// ------------------------------ host ------------------------------

// lpp, the lanes that share a row in the taps and the LayerNorm (a power of
// two, at least 256 / TM so that every consumer thread has a row), and vec,
// the 8-channel vectors a lane takes (<= kVecMax): the pair with the fewest
// idle slots (lpp vec - C / 8), the wider lpp on a tie.  0: none.
inline int tap_lanes(int c, int tm, int* vec) {
  const int nv = c / 8;
  int best = 0, best_waste = 1 << 30;
  for (int lpp = 32; lpp >= kConsumerThreads / tm; lpp >>= 1) {
    const int v = (nv + lpp - 1) / lpp;
    if (v > kVecMax || lpp * v - nv >= best_waste) continue;
    best = lpp, best_waste = lpp * v - nv, *vec = v;
  }
  return best;
}

struct Args {
  const void *x, *dw_q, *dw_s, *dw_b, *ln_w, *ln_b, *w1, *w1_s, *b1, *w2, *w2_s, *b2, *gamma;
  void *out, *dbg_qh, *dbg_qg;
  float s_x, s_h, s_g;
  int B, H, W, C, hidden, ldw1;
};

// Ring stages beside the rest at an (H, W) map (0: it does not fit).
template <int CP> inline int stages_at(int H, int W) {
  const Reach q = reach_of(H, W);
  return stages_that_fit(kSmemLimit, 0, fixed_bytes<CP>(q.halo, q.taps));
}

template <int CP, typename T> cudaError_t launch(const Args& a, cudaStream_t stream) {
  using P = Plan<CP, true>;
  const long long M = static_cast<long long>(a.B) * a.H * a.W;
  if (M <= 0) return cudaSuccess;
  if (a.C % 8 != 0 || a.C > CP || a.hidden <= 0 || a.hidden % 16 != 0 || a.ldw1 % 16 != 0 ||
      a.ldw1 < a.C)
    return cudaErrorInvalidValue;
  for (const void* p : {a.x, a.dw_b, a.ln_w, a.ln_b, a.b1, a.b2, a.gamma, a.w1, a.w2, a.dw_s,
                        a.w1_s, a.w2_s, static_cast<const void*>(a.out)})
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  for (const void* p : {static_cast<const void*>(a.dbg_qh), static_cast<const void*>(a.dbg_qg)})
    if (reinterpret_cast<uintptr_t>(p) & 7u) return cudaErrorMisalignedAddress;
  const Reach q = reach_of(a.H, a.W);
  const int stages = stages_at<CP>(a.H, a.W);
  if (stages < kMinStages) return cudaErrorInvalidValue;
  const int bytes = smem_bytes(stages, 0, fixed_bytes<CP>(q.halo, q.taps));
  int vec = 0;
  const int lpp = tap_lanes(a.C, P::TM, &vec);
  if (lpp == 0) return cudaErrorInvalidValue;
  const long long blocks = (M + P::TM - 1) / P::TM;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  CUtensorMap map1, map2;
  cudaError_t err =
      unit_map(&map1, a.w1, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.hidden, a.C, a.ldw1, 128);
  if (err != cudaSuccess) return err;
  err = unit_map(&map2, a.w2, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.C, a.hidden, a.hidden, 128);
  if (err != cudaSuccess) return err;
  const auto kernel = int8_block_kernel<CP, T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(blocks), P::SLICES), kBlockThreads, bytes, stream>>>(
      map1, map2, static_cast<const T*>(a.x), static_cast<const int8_t*>(a.dw_q),
      static_cast<const float*>(a.dw_s), static_cast<const T*>(a.dw_b),
      static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b),
      static_cast<const float*>(a.w1_s), static_cast<const T*>(a.b1),
      static_cast<const float*>(a.w2_s), static_cast<const T*>(a.b2),
      static_cast<const T*>(a.gamma), static_cast<T*>(a.out), static_cast<int8_t*>(a.dbg_qh),
      static_cast<int8_t*>(a.dbg_qg), a.s_x, a.s_h, a.s_g, a.B, a.H, a.W, a.C, a.hidden, stages,
      lpp, vec);
  return cudaGetLastError();
}

template <typename T> cudaError_t dispatch(const Args& a, cudaStream_t stream) {
#define BTS_CASE(CP) case CP: return launch<CP, T>(a, stream);
  switch (any_width_plan(a.C)) {
    BTS_ANY_WIDTHS(BTS_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef BTS_CASE
}

}  // namespace int8blk
}  // namespace btsbot

// Shared memory (bytes) of one block of the int8 block kernel at width C on
// an (H, W) map, or 0 where it does not take the width or the map (a map so
// wide that the quantized input range, the taps' weights and Xq leave no
// room for four ring units).
extern "C" int btsbot_int8_block_smem(int C, int H, int W) {
  using namespace btsbot::int8blk;
  if (H <= 0 || W <= 0 || C % 8 != 0) return 0;
  const btsbot::Reach q = btsbot::reach_of(H, W);
#define BTS_CASE(CP)                                                             \
  case CP: {                                                                     \
    const int stages = stages_at<CP>(H, W);                                      \
    return stages ? smem_bytes(stages, 0, fixed_bytes<CP>(q.halo, q.taps)) : 0;  \
  }
  switch (btsbot::hopper::any_width_plan(C)) {
    BTS_ANY_WIDTHS(BTS_CASE)
    default: return 0;
  }
#undef BTS_CASE
}

// x, out (B, H, W, C) contiguous in float32 (is_bf16 0) or bfloat16 (1);
// dw_q (7, 7, C) int8, dw_s (C,) float32, dw_b, ln_w, ln_b (C,) in x's type;
// w1 (hidden, C) int8 with rows ldw1 bytes apart (a multiple of 16), w1_s
// (hidden,) float32, b1 (hidden,); w2 (C, hidden) int8, w2_s (C,) float32,
// b2, gamma (C,); dbg_qh (M, C) and dbg_qg (M, hidden) int8 or null; s_x,
// s_h, s_g the activation scales.  C a multiple of 8 up to 1024, hidden a
// multiple of 16.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (0 on success).
extern "C" int btsbot_int8_block(const void* x, const void* dw_q, const void* dw_s,
                                 const void* dw_b, const void* ln_w, const void* ln_b,
                                 const void* w1, const void* w1_s, const void* b1,
                                 const void* w2, const void* w2_s, const void* b2,
                                 const void* gamma, void* out, void* dbg_qh, void* dbg_qg,
                                 float s_x, float s_h, float s_g, int B, int H, int W, int C,
                                 int hidden, int ldw1, int is_bf16, void* stream) {
  const btsbot::int8blk::Args a{x,   dw_q, dw_s, dw_b, ln_w, ln_b,   w1,     w1_s, b1,
                                w2,  w2_s, b2,   gamma, out, dbg_qh, dbg_qg, s_x,  s_h,
                                s_g, B,    H,    W,     C,   hidden, ldw1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? btsbot::int8blk::dispatch<__nv_bfloat16>(a, s)
                 : btsbot::int8blk::dispatch<float>(a, s);
}
