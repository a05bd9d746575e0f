// One whole ConvNeXt block on NHWC input:
//   h   = depthwise 7x7 SAME conv(x) + bias      (float accumulation, bias
//         added in float before the LayerNorm, as pallas_convnext.py:87)
//   out = x + gamma * (GELU(LN(h) . fc1^T + b1) . fc2^T + b2)
//
// Replaces the TPU kernel btsbot_tpu/ops/pallas_convnext.py:
// convnext_block_fused (kernel _kernel, plain version _block_reference).
// What it keeps out of device memory is what the TPU kernel keeps out of
// HBM: the convolution output, the normalised rows and the 4C hidden
// activations; a block reads x once (plus the halo) and writes out once.
// The TPU version's padding of H and W to multiples of 8 and its batch tile
// are gone: a block takes TM consecutive pixels of the flattened (B*H*W)
// index, which may span samples (at the 3x3 and 1x1 maps of the later
// stages one sample holds fewer pixels than a tile), and every tap checks
// its own bounds, so SAME padding and the ragged last tile need no padded
// copy.
//
// What bounds it on the H100: per pixel, the two products' 8 C^2
// multiply-adds and the 49 C of the taps, against 2 C values read and
// written.  In bf16 on the tensor cores the two limits are about even at
// C = 64 and the operations win from C = 128 on; in f32 (three TF32
// products, tf32x3.cu) the operations win everywhere.
//
// bfloat16 (the serving type) runs the design of hopper_mlp.cuh for the MLP
// half.  In front of it: every input a tap of the tile's TM pixels can
// touch lies in the contiguous range [row0 - halo, row0 + TM + halo) of the
// flattened index, halo = ry W + rx with ry = min(3, H - 1), rx =
// min(3, W - 1) (taps further out are outside every sample: at a 1x1 map
// only the centre tap is left).  The producer thread brings that range in
// with one bulk copy, clipped to [0, M); the consumers read the taps from
// that tile (a pixel's channels across 8-32 lanes, 16 bytes a lane; a tap's
// weights are loaded once for four of the lane's rows; a tap that falls
// outside a pixel's sample is tested away, never multiplied), and the
// epilogue takes the shortcut from the
// same tile.  The taps' weights sit beside it as float, [tap][C], only the
// (2 ry + 1)(2 rx + 1) taps that can be in bounds.  A map so wide that the
// tile with its halo leaves no room for four ring units (C = 512 at 7x7,
// C = 256 at 14x14) runs the second instantiation of the kernel (kTile =
// false): no input tile, the taps and the shortcut read x from device memory
// (through L2, as the first version of the kernel did), everything else the
// same, so every (H, W) is taken at every width.  What is left between it
// and its bound: the taps and the GELU run on the CUDA cores and are not
// overlapped with the products of the same warpgroup (at C <= 128 they take
// most of a block's time), each block re-reads W1 and W2 from L2,
// and the last stage has only M / 64 blocks for 132 SMs.  PERF.md has the
// times.
//
// Every other width in bfloat16 runs the same kernel with the channels
// padded inside it (convnext_block_bf16_kernel<CP, true, *>,
// btsbot_convnext_block_wgmma; the design notes are hopper_mlp.cuh's): the
// input tile stays c 2 bytes a pixel, the taps run over the real c, and
// where CP > 512 leaves no room for the 49 taps' weights beside Xn they
// are read from device memory.
//
// float32 runs the three-TF32-product design of tf32x3.cu
// (btsbot_convnext_block_tf32x3), at every width.

#include "block_common.cuh"
#include "hopper_mlp.cuh"

namespace btsbot {

// ------------------------- bfloat16: wgmma + TMA -------------------------

namespace hopper {

// Bytes of the input tile with its halo (rows of c channels), and of the
// taps' weights in shared memory.
constexpr long long tile_bytes(int tm, int c, int halo) {
  return (static_cast<long long>(tm) + 2LL * halo) * c * 2;
}
template <class P> constexpr int taps_bytes(int c, int taps) {
  return P::TAPS_IN_SMEM ? taps * c * 4 : 0;
}
// Ring stages beside the input tile (0: the tile does not fit), and with
// the taps' weights alone.
template <class P> constexpr int tiled_stages(int c, int halo, int taps) {
  return tile_bytes(P::TM, c, halo) > kSmemLimit
             ? 0
             : stages_that_fit(P::SMEM_LIMIT, P::XN_BYTES,
                               static_cast<int>(tile_bytes(P::TM, c, halo)) +
                                   taps_bytes<P>(c, taps));
}
template <class P> constexpr int untiled_stages(int c, int taps) {
  return stages_that_fit(P::SMEM_LIMIT, P::XN_BYTES, taps_bytes<P>(c, taps));
}
// The four shapes of the flagship forward keep their input tile in shared
// memory (halo and taps as reach_of gives them for side 15, 7, 3, 1).
static_assert(tiled_stages<Plan<64>>(64, 48, 49) >= kMinStages &&
                  tiled_stages<Plan<128>>(128, 24, 49) >= kMinStages &&
                  tiled_stages<Plan<256>>(256, 8, 25) >= kMinStages &&
                  tiled_stages<Plan<512>>(512, 0, 1) >= kMinStages,
              "a flagship stage no longer fits the shared memory of a block");

// The shortcut of tile row r: from the input tile in shared memory, or
// (kTile = false) from x itself.
struct TileShortcut {
  const unsigned char* xin;  // pixel row0: row 0 of the tile proper (behind the halo)
  int row_bytes;
  __device__ __forceinline__ uint32_t operator()(int r, int col) const {
    return *reinterpret_cast<const uint32_t*>(xin + r * row_bytes + col * 2);
  }
};

// C = CP (tuned) or the real width c <= CP (ANY), pixels of c channels in
// device memory.
template <int CP, bool ANY, bool kTile>
__global__ void __maxnreg__((Plan<CP, ANY>::MAX_REGS))
    convnext_block_bf16_kernel(const __grid_constant__ CUtensorMap map1,
                               const __grid_constant__ CUtensorMap map2,
                               const bf16* __restrict__ x, const bf16* __restrict__ dw_w,
                               const bf16* __restrict__ dw_b, const bf16* __restrict__ ln_w,
                               const bf16* __restrict__ ln_b, const bf16* __restrict__ b1,
                               const bf16* __restrict__ b2, const bf16* __restrict__ gamma,
                               bf16* __restrict__ out, int B, int H, int W, int hidden,
                               int stages, int c_real) {
  using P = Plan<CP, ANY>;
  const int c = ANY ? c_real : CP;
  const int row_bytes = c * 2;
  const Reach q = reach_of(H, W);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* xn = base + stages * kUnitBytes;
  unsigned char* xin = xn + P::XN_BYTES;  // [TM + 2 halo][c], rows row0 - halo ...
  const int tile_rows = kTile ? P::TM + 2 * q.halo : 0;
  float* dws = reinterpret_cast<float*>(xin + tile_rows * row_bytes);  // [tap][c]
  unsigned char* bars = reinterpret_cast<unsigned char*>(dws + (P::TAPS_IN_SMEM ? q.taps * c : 0));
  Ring ring;
  ring.tiles = smem_u32(base);
  ring.full = smem_u32(bars);
  ring.empty = ring.full + 8 * kMaxStages;
  ring.stages = stages;
  const uint32_t xin_bar = ring.empty + 8 * kMaxStages;
  init_barriers(ring.full, ring.empty, xin_bar, stages);
  const long long M = static_cast<long long>(B) * H * W;
  const long long row0 = static_cast<long long>(blockIdx.x) * P::TM;
  const Slice<P> sl = Slice<P>::of_block();

  if (threadIdx.x >= kConsumerThreads) {
    if (threadIdx.x == kConsumerThreads) {
      if constexpr (kTile) {
        // the input tile with its halo, clipped to the rows that exist
        const long long lo = row0 - q.halo > 0 ? row0 - q.halo : 0;
        const long long hi = row0 + P::TM + q.halo < M ? row0 + P::TM + q.halo : M;
        const uint32_t bytes = static_cast<uint32_t>(hi - lo) * row_bytes;
        mbar_expect_tx(xin_bar, bytes);
        bulk_load_1d(smem_u32(xin) + static_cast<uint32_t>(lo - (row0 - q.halo)) * row_bytes,
                     x + lo * c, bytes, xin_bar);
      }
      produce_weights<P>(ring, &map1, &map2, hidden, sl);
    }
  } else {
    const int nx = 2 * q.rx + 1;
    if constexpr (P::TAPS_IN_SMEM) {
      // the taps' weights, transposed from (C, 1, 7, 7) to [tap][c]
      for (int i = threadIdx.x; i < q.taps * c; i += kConsumerThreads) {
        const int t = i / c, ch = i - t * c;
        const int ty = t / nx, tx = t - ty * nx;
        dws[i] = __bfloat162float(dw_w[ch * kTaps + (ty + 3 - q.ry) * 7 + tx + 3 - q.rx]);
      }
    }
    const int grp = threadIdx.x / P::LPP, l = threadIdx.x % P::LPP;
    uint4 lw[P::VEC], lb[P::VEC], db[P::VEC];
    load_row_params<P>(ln_w, lw, l, c);
    load_row_params<P>(ln_b, lb, l, c);
    load_row_params<P>(dw_b, db, l, c);
    consumer_barrier();                      // the taps' weights are in place
    if constexpr (kTile) mbar_wait(xin_bar, 0);  // and so is the input tile
    // pixel row0 of the input: in the tile, or in x itself (a tap in bounds
    // of its sample is a row of x, so nothing else is ever read)
    const unsigned char* xc = xin + q.halo * row_bytes;
    if constexpr (!kTile) xc = reinterpret_cast<const unsigned char*>(x + row0 * c);

    // Taps outermost, a lane's rows innermost: a tap's weights are loaded
    // once for RB rows (the taps are bound by shared-memory loads, and the
    // input values themselves cannot be shared between lanes).
    const int hw = H * W;
    constexpr int kRows = P::TM / P::GROUPS;
    constexpr int RB = kRows < 4 ? kRows : (P::VEC <= 2 ? 4 : 2);  // wide rows: fewer
    for (int i0 = 0; i0 < kRows; i0 += RB) {
      float v[RB][P::VEC][8];
      int py[RB], px[RB];
      const unsigned char* xrow[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
#pragma unroll
        for (int vv = 0; vv < P::VEC; ++vv)
#pragma unroll
          for (int e = 0; e < 8; ++e) v[i][vv][e] = 0.f;
        const int r = grp + (i0 + i) * P::GROUPS;
        const long long p = row0 + r;
        const int rem = static_cast<int>(p % hw);
        py[i] = p < M ? rem / W : -8;  // rows past M: no tap in bounds, never stored
        px[i] = rem - (rem / W) * W;
        xrow[i] = xc + r * row_bytes + l * 16;
      }
      for (int dy = -q.ry; dy <= q.ry; ++dy) {
        for (int dx = -q.rx; dx <= q.rx; ++dx) {
          float4 wa[P::VEC], wb[P::VEC];
#pragma unroll
          for (int vv = 0; vv < P::VEC; ++vv) {
            if (!real_vec<P>(vv, l, c)) continue;
            if constexpr (P::TAPS_IN_SMEM) {
              const float* wt =
                  dws + ((dy + q.ry) * nx + dx + q.rx) * c + l * 8 + vv * P::LPP * 8;
              wa[vv] = *reinterpret_cast<const float4*>(wt);
              wb[vv] = *reinterpret_cast<const float4*>(wt + 4);
            } else {  // from device memory, (C, 1, 7, 7): 49 apart a channel
              const bf16* wt = dw_w + (vv * P::LPP + l) * 8 * kTaps + (dy + 3) * 7 + dx + 3;
              float f[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(wt[e * kTaps]);
              wa[vv] = make_float4(f[0], f[1], f[2], f[3]);
              wb[vv] = make_float4(f[4], f[5], f[6], f[7]);
            }
          }
          const int shift = (dy * W + dx) * row_bytes;
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            if (static_cast<unsigned>(py[i] + dy) < static_cast<unsigned>(H) &&
                static_cast<unsigned>(px[i] + dx) < static_cast<unsigned>(W)) {
#pragma unroll
              for (int vv = 0; vv < P::VEC; ++vv) {
                if (!real_vec<P>(vv, l, c)) continue;
                float xv[8];
                unpack8(*reinterpret_cast<const uint4*>(xrow[i] + shift + vv * P::LPP * 16), xv);
                float(&a)[8] = v[i][vv];
                a[0] = fmaf(xv[0], wa[vv].x, a[0]), a[1] = fmaf(xv[1], wa[vv].y, a[1]);
                a[2] = fmaf(xv[2], wa[vv].z, a[2]), a[3] = fmaf(xv[3], wa[vv].w, a[3]);
                a[4] = fmaf(xv[4], wb[vv].x, a[4]), a[5] = fmaf(xv[5], wb[vv].y, a[5]);
                a[6] = fmaf(xv[6], wb[vv].z, a[6]), a[7] = fmaf(xv[7], wb[vv].w, a[7]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
#pragma unroll
        for (int vv = 0; vv < P::VEC; ++vv) {
          float bv[8];
          unpack8(db[vv], bv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[i][vv][e] += bv[e];
        }
        layer_norm_to_xn<P>(v[i], lw, lb, xn, grp + (i0 + i) * P::GROUPS, l, c,
                            kLnEps);
      }
    }
    fence_proxy_async();  // Xn was written by ordinary stores, wgmma reads it
    consumer_barrier();
    consume_mlp<P>(ring, smem_u32(xn), b1, b2, gamma, out, row0, M, hidden, c, sl,
                   TileShortcut{xc, row_bytes});
  }
}

template <int CP, bool ANY>
static cudaError_t launch_block_bf16(const void* x, const void* dw_w, const void* dw_b,
                                     const void* ln_w, const void* ln_b, const void* w1,
                                     const void* b1, const void* w2, const void* b2,
                                     const void* gamma, void* out, int B, int H, int W,
                                     int c, int hidden, cudaStream_t stream) {
  using P = Plan<CP, ANY>;
  const long long M = static_cast<long long>(B) * H * W;
  if (M <= 0) return cudaSuccess;
  if (hidden <= 0 || hidden % (ANY ? 8 : 64) != 0) return cudaErrorInvalidValue;
  for (const void* p : {x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma,
                        static_cast<const void*>(out)})
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  // every map fits without the input tile, whatever H and W are
  static_assert(untiled_stages<P>(CP, kTaps) >= kMinStages, "the taps' weights do not fit");
  const Reach q = reach_of(H, W);
  int stages = tiled_stages<P>(c, q.halo, q.taps);
  const bool tiled = stages >= kMinStages;
  if (!tiled) stages = untiled_stages<P>(c, q.taps);
  const int extra =
      taps_bytes<P>(c, q.taps) + (tiled ? static_cast<int>(tile_bytes(P::TM, c, q.halo)) : 0);
  const int bytes = smem_bytes(stages, P::XN_BYTES, extra);
  const long long blocks = (M + P::TM - 1) / P::TM;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  CUtensorMap map1, map2;
  cudaError_t err = weight_map(&map1, w1, hidden, c);
  if (err != cudaSuccess) return err;
  err = weight_map(&map2, w2, c, hidden);
  if (err != cudaSuccess) return err;
  const auto kernel = tiled ? convnext_block_bf16_kernel<CP, ANY, true>
                            : convnext_block_bf16_kernel<CP, ANY, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), P::SLICES);
  kernel<<<grid, kBlockThreads, bytes, stream>>>(
      map1, map2, static_cast<const bf16*>(x), static_cast<const bf16*>(dw_w),
      static_cast<const bf16*>(dw_b), static_cast<const bf16*>(ln_w),
      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(b2), static_cast<const bf16*>(gamma),
      static_cast<bf16*>(out), B, H, W, hidden, stages, c);
  return cudaGetLastError();
}

// The tuned kernels (C = 64 / 128 / 256 / 512, hidden in 64-unit steps), or
// with `any` the padded ones at every C up to kMaxWidth.
static cudaError_t dispatch_block_bf16(const void* x, const void* dw_w, const void* dw_b,
                                       const void* ln_w, const void* ln_b, const void* w1,
                                       const void* b1, const void* w2, const void* b2,
                                       const void* gamma, void* out, int B, int H, int W,
                                       int C, int hidden, bool any, cudaStream_t stream) {
#define BTS_LAUNCH(CP, ANY)                                                                 \
  return launch_block_bf16<CP, ANY>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, \
                                    B, H, W, C, hidden, stream);
  if (!any) {
    switch (C) {
      case 64: BTS_LAUNCH(64, false)
      case 128: BTS_LAUNCH(128, false)
      case 256: BTS_LAUNCH(256, false)
      case 512: BTS_LAUNCH(512, false)
      default: return cudaErrorInvalidValue;
    }
  }
#define BTS_CASE(CP) case CP: BTS_LAUNCH(CP, true)
  switch (any_width_plan(C)) {
    BTS_ANY_WIDTHS(BTS_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef BTS_CASE
#undef BTS_LAUNCH
}

}  // namespace hopper

}  // namespace btsbot

// Rows of the flattened (B*H*W) index that one block of the bfloat16 kernels
// (both functions, tuned or "wgmma_any") takes at width C; 0 for a width
// they do not take.
extern "C" int btsbot_tile_rows(int C) {
  using namespace btsbot::hopper;
#define BTS_CASE(CP) case CP: return Plan<CP, true>::TM;
  switch (any_width_plan(C)) {
    BTS_ANY_WIDTHS(BTS_CASE)
    default: return 0;
  }
#undef BTS_CASE
}

// Whether the bfloat16 block kernel keeps the input tile of an (H, W) map in
// shared memory at width C (1), reads x from device memory (0), or does not
// take the width (-1).
extern "C" int btsbot_block_tiles_input(int C, int H, int W) {
  using namespace btsbot::hopper;
  const btsbot::Reach q = btsbot::reach_of(H, W);
#define BTS_CASE(CP) case CP: return tiled_stages<Plan<CP, true>>(C, q.halo, q.taps) >= kMinStages;
  switch (any_width_plan(C)) {
    BTS_ANY_WIDTHS(BTS_CASE)
    default: return -1;
  }
#undef BTS_CASE
}

// x and out (B, H, W, C) contiguous, weights in the module layouts, all
// bfloat16 (float32 runs btsbot_convnext_block_tf32x3), on one card.
// is_bf16 must be 1: a guard that keeps the earlier signature, in which it
// chose the type, and refuses a float32 caller of it.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (0 on success).
extern "C" int btsbot_convnext_block(const void* x, const void* dw_w, const void* dw_b,
                                     const void* ln_w, const void* ln_b, const void* w1,
                                     const void* b1, const void* w2, const void* b2,
                                     const void* gamma, void* out, int B, int H, int W,
                                     int C, int hidden, int is_bf16, void* stream) {
  if (!is_bf16) return cudaErrorInvalidValue;
  return btsbot::hopper::dispatch_block_bf16(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma,
                                             out, B, H, W, C, hidden, false,
                                             static_cast<cudaStream_t>(stream));
}

// As btsbot_convnext_block in bfloat16 only, at any C up to 1024 and any
// hidden width, both multiples of 8 (the "wgmma_any" kernels).
extern "C" int btsbot_convnext_block_wgmma(const void* x, const void* dw_w, const void* dw_b,
                                           const void* ln_w, const void* ln_b, const void* w1,
                                           const void* b1, const void* w2, const void* b2,
                                           const void* gamma, void* out, int B, int H, int W,
                                           int C, int hidden, int is_bf16, void* stream) {
  if (!is_bf16) return cudaErrorInvalidValue;
  return btsbot::hopper::dispatch_block_bf16(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma,
                                             out, B, H, W, C, hidden, true,
                                             static_cast<cudaStream_t>(stream));
}
