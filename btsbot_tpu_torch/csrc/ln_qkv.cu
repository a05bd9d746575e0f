// MaxViT's LN1 -> qkv: qkv = LayerNorm(x) . Wqkv^T + b over (M, C) rows,
// Wqkv (3C, C) in nn.Linear's layout, the output (M, 3C) in the natural
// NHWC order that partition_attention.cu reads.
//
// Replaces no TPU kernel: the JAX package leaves MaxViT's LN1 and qkv to XLA
// (btsbot_tpu/models/maxvit.py).  It was added because the port ran them as
// ATen's LayerNorm (a block a row: rows of 64-512 values, millions of them)
// then cuBLAS, writing the normalised map and reading it back; LN1 alone
// took ~15 % of a MaxViT forward at 9 % of its bound.
//
// What bounds it on the H100: per row, 6 C^2 operations against 8 C bytes
// (x read once, 3C outputs written once, bf16): 0.75 C operations a byte,
// under the ~295 at which the tensor cores are the limit up to C = 256, so
// bytes bound it there (3/4 of them the output) and the operations, barely,
// at C = 512.
//
// Rounded where the modules it replaces round: the LayerNorm's statistics
// and affine in float, rounded to bf16 once (the product's A operand, as
// ATen's LayerNorm writes its output); the product accumulated in float,
// plus the bias, rounded once (as cuBLAS's bf16 GEMM with its bias).  Only
// the order of the float sums differs from the modules.
//
// bfloat16, C = 64 .. 512 in steps of 64 (ln_qkv_bf16_kernel<C>): one
// persistent block an SM walks 128-row tiles; 288 threads = two consumer
// warpgroups (64 rows each) + a producer warp, the design of hopper_mlp.cuh:
//   x      a tile comes in by TMA (64-channel boxes with the 128-byte
//          swizzle, which is Xn's slab layout), 1-3 tiles ahead in a ring of
//          tile buffers, so the next tiles' reads overlap this one's work;
//          rows past M arrive as zeros and are never stored.
//   LN     each consumer thread normalises its rows in place
//          (layer_norm_to_xn<P, true>): the buffer becomes Xn.
//   W      the product walks the 3C output columns in 64-column blocks; a
//          block's C / 64 units of Wqkv (64 output rows x 64 input channels,
//          K-major: wgmma's B layout, nothing transposed) stream from L2
//          through the producer's TMA ring, both warpgroups using each unit.
//          Each unit's products start with their own wgmma.fence: without
//          it, ptxas puts one after the wait that frees the slot before, in
//          a divergent path, and serialises every wgmma (C7520).
//   out    the blocks go in pairs, which halves the epilogues' barriers (at
//          C = 512 one by one, where pairs measured slower; PERF.md): a
//          pair's (64, 64) accumulators + bias are rounded into the
//          warpgroup's two swizzled staging boxes, and TMA stores move them
//          to device memory while the next pair's products run; the output,
//          3/4 of the bytes, leaves as whole 128-byte lines.
//
// float32 (training and the f32 scorer), and bfloat16 at any other C (a
// multiple of 8): ln_qkv_simple_kernel<T> on the CUDA cores, a (64 rows,
// 64 columns) output tile a block, every step in float, the normalised
// operand rounded to T.  No cell times it.

#include "block_common.cuh"
#include "hopper_mlp.cuh"

namespace btsbot {
namespace qkv {

using namespace hopper;

constexpr int kTileRows = 128;                       // two warpgroups of 64
constexpr int kStageBytes = 2 * 2 * kUnitBytes;      // two staging boxes a warpgroup
constexpr int kQkvBarrierBytes = (2 * kMaxStages + 3) * 8;  // ring + up to 3 tile buffers

constexpr int fixed_bytes(int xn_bytes, int buffers) {
  return kAlignSlack + buffers * xn_bytes + kStageBytes + kQkvBarrierBytes;
}
constexpr int min_int(int a, int b) { return a < b ? a : b; }

// The tuned width C = CP (a multiple of 64 up to 512) and the shared-memory
// plan that follows from it.  The members that layer_norm_to_xn and
// load_row_params read (TM, G8, LPP, VEC, ANY) mean what Plan's do; ANY here
// only masks the vectors of lanes that run past a row (CP / 8 not a multiple
// of LPP), the width is always CP.
template <int CP_> struct QkvPlan {
  static constexpr int CP = CP_;
  static constexpr int KS = CP / 64;  // K slabs: units of Wqkv an output block
  static constexpr int NB = 3 * KS;   // 64-column blocks of the output
  static constexpr int GROUP = KS < 8 ? 2 : 1;  // blocks an epilogue (header)
  static constexpr int TM = kTileRows;
  static constexpr int G8 = CP / 8;
  static constexpr int LPP = G8 >= 32 ? 32 : (G8 >= 16 ? 16 : 8);
  static constexpr int VEC = (G8 + LPP - 1) / LPP;
  static constexpr bool ANY = G8 % LPP != 0;
  static constexpr int GROUPS = kConsumerThreads / LPP;
  static constexpr int XN_BYTES = TM * CP * 2;
  // tile buffers: three where a tile is short (C <= 128), else two where
  // they fit beside a ring of kMinStages units, else one (C >= 384, where a
  // tile's products take long enough to hide its read)
  static constexpr int NXB =
      CP <= 128 ? 3
                : (fixed_bytes(XN_BYTES, 2) + kMinStages * kUnitBytes <= kSmemLimit ? 2 : 1);
  static constexpr int STAGES =
      min_int(kMaxStages, (kSmemLimit - fixed_bytes(XN_BYTES, NXB)) / kUnitBytes);
  static constexpr int SMEM = fixed_bytes(XN_BYTES, NXB) + STAGES * kUnitBytes;
  static_assert(CP % 64 == 0 && CP <= 512, "width");
  static_assert(STAGES >= kMinStages && SMEM <= kSmemLimit, "shared memory");
  static_assert(TM % GROUPS == 0, "row groups");
};

__device__ __forceinline__ void warpgroup_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until none of this thread's stores still reads its shared source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One tile of x (rows row0 .. row0 + TM) into a tile buffer: a box of 64
// channels a K slab, all completing on `bar`.
template <class P>
__device__ __forceinline__ void load_x_tile(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                            int row0) {
  mbar_expect_tx(bar, P::XN_BYTES);
#pragma unroll
  for (int s = 0; s < P::KS; ++s) tma_load_2d(dst + s * (P::TM * 128), map, bar, s * 64, row0);
}

// acc[h] = Xn[this warpgroup's rows] . Wqkv[block nb0 + h]^T for the NBLK
// blocks from nb0, one ring unit a K slab, each slot released once the
// products that read it are complete.
template <class P, int NBLK>
__device__ __forceinline__ void block_products(Ring& ring, float (&acc)[NBLK][32],
                                               uint32_t a_base, int lane) {
#pragma unroll
  for (int h = 0; h < NBLK; ++h) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[h][j] = 0.f;
    fence_regs(acc[h]);
  }
  int held = -1;  // slot whose products may still be reading it
#pragma unroll
  for (int h = 0; h < NBLK; ++h) {
#pragma unroll
    for (int s = 0; s < P::KS; ++s) {
      mbar_wait(ring.full_bar(), ring.phase);
      const uint64_t da = wgmma_desc(a_base + s * (P::TM * 128));
      const uint64_t db = wgmma_desc(ring.tile());
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc[h], da + 2 * kk, db + 2 * kk, (s | kk) != 0);
      wgmma_commit();
      if (held >= 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(ring.empty_bar(held));
      }
      held = ring.slot;
      ring.advance();
    }
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(ring.empty_bar(held));
#pragma unroll
  for (int h = 0; h < NBLK; ++h) fence_regs(acc[h]);
}

// Blocks nb0 .. nb0 + NBLK of this warpgroup's 64 rows, from row0: + bias,
// rounded once, into the warpgroup's staging boxes, then TMA stores.  Thread
// 0 of the warpgroup starts every store and waits for their reads: the last
// epilogue's stores were started a whole product earlier.
template <int NBLK>
__device__ __forceinline__ void block_epilogue(const float (&acc)[NBLK][32], int nb0,
                                               const bf16* __restrict__ bias, unsigned char* stg,
                                               const CUtensorMap* omap, long long row0,
                                               long long M, int wt, int wg, int frow, int t2) {
  if (wt == 0) bulk_wait_read();  // the stores that read these boxes are done
  warpgroup_barrier(wg);
#pragma unroll
  for (int h = 0; h < NBLK; ++h) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t bb =
          __ldg(reinterpret_cast<const uint32_t*>(bias + (nb0 + h) * 64 + 8 * j + t2));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = frow + 8 * half;
        *reinterpret_cast<uint32_t*>(stg + h * kUnitBytes + r * 128 + ((j ^ (r & 7)) << 4) +
                                     t2 * 2) =
            pack2(acc[h][4 * j + 2 * half] + lo_f(bb), acc[h][4 * j + 2 * half + 1] + hi_f(bb));
      }
    }
  }
  fence_proxy_async();
  warpgroup_barrier(wg);
  if (wt == 0) {
    if (row0 < M) {
#pragma unroll
      for (int h = 0; h < NBLK; ++h)
        tma_store_2d(omap, smem_u32(stg + h * kUnitBytes), (nb0 + h) * 64,
                     static_cast<int>(row0));
    }
    bulk_commit();
  }
}

template <int CP>
__global__ void __launch_bounds__(kBlockThreads, 1)
    ln_qkv_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap omap, const bf16* __restrict__ ln_w,
                       const bf16* __restrict__ ln_b, const bf16* __restrict__ bias,
                       long long M, float eps) {
  using P = QkvPlan<CP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* xn0 = base;                               // [NXB][KS][TM][128 B]
  unsigned char* stage0 = xn0 + P::NXB * P::XN_BYTES;      // [warpgroup][2][64][128 B]
  unsigned char* ring0 = stage0 + kStageBytes;             // [STAGES][64][128 B]
  unsigned char* bars = ring0 + P::STAGES * kUnitBytes;
  Ring ring;
  ring.tiles = smem_u32(ring0);
  ring.full = smem_u32(bars);
  ring.empty = ring.full + 8 * kMaxStages;
  ring.stages = P::STAGES;
  const uint32_t xfull = ring.empty + 8 * kMaxStages;  // one barrier a tile buffer
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kConsumerThreads / 32);
    }
    for (int b = 0; b < P::NXB; ++b) mbar_init(xfull + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long tiles = (M + P::TM - 1) / P::TM;

  if (threadIdx.x >= kConsumerThreads) {
    // the producer: every unit of every output block of every tile of this
    // block, in the order the consumers take them
    if (threadIdx.x == kConsumerThreads) {
      ring.slot = 0;
      ring.phase = 1;  // a fresh barrier lets a wait on the other parity through
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
        for (int nb = 0; nb < P::NB; ++nb)
#pragma unroll
          for (int s = 0; s < P::KS; ++s) {
            mbar_wait(ring.empty_bar(ring.slot), ring.phase);
            mbar_expect_tx(ring.full_bar(), kUnitBytes);
            tma_load_2d(ring.tile(), &wmap, ring.full_bar(), s * 64, nb * 64);
            ring.advance();
          }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;
  const int frow = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // fragment row, +8
  const int grp = threadIdx.x / P::LPP, l = threadIdx.x % P::LPP;
  uint4 lw[P::VEC], lb[P::VEC];
  load_row_params<P>(ln_w, lw, l, CP);
  load_row_params<P>(ln_b, lb, l, CP);

  // the first tiles' reads; thread 0 starts every read of x
  if (threadIdx.x == 0) {
    for (int j = 0; j < (P::NXB > 1 ? P::NXB - 1 : 1); ++j) {
      const long long t = blockIdx.x + static_cast<long long>(j) * gridDim.x;
      if (t < tiles)
        load_x_tile<P>(&xmap, smem_u32(xn0 + j * P::XN_BYTES), xfull + 8 * j,
                       static_cast<int>(t * P::TM));
    }
  }

  ring.slot = 0;
  ring.phase = 0;
  int i = 0;  // tiles this block has taken
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int buf = P::NXB == 1 ? 0 : i % P::NXB;
    unsigned char* xn = xn0 + buf * P::XN_BYTES;
    mbar_wait(xfull + 8 * buf, (i / P::NXB) & 1);

    // ---- LayerNorm in place: x's tile becomes Xn
    constexpr int kRows = P::TM / P::GROUPS;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = grp + k * P::GROUPS;
      float v[P::VEC][8];
#pragma unroll
      for (int vv = 0; vv < P::VEC; ++vv) {
        const int cg = vv * P::LPP + l;  // 16-byte group along the row
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (real_vec<P>(vv, l, CP))
          q = *reinterpret_cast<const uint4*>(xn + (cg >> 3) * (P::TM * 128) + r * 128 +
                                              (((cg & 7) ^ (r & 7)) << 4));
        unpack8(q, v[vv]);
      }
      layer_norm_to_xn<P, true>(v, lw, lb, xn, r, l, CP, eps);
    }
    fence_proxy_async();  // Xn was written by ordinary stores, wgmma reads it
    consumer_barrier();   // ... and both warpgroups are past the previous tile
    if (P::NXB > 1 && threadIdx.x == 0) {
      // the buffer the previous tile used: its products are complete
      const long long next = t + static_cast<long long>(P::NXB - 1) * gridDim.x;
      const int nbuf = (i + P::NXB - 1) % P::NXB;
      if (next < tiles)
        load_x_tile<P>(&xmap, smem_u32(xn0 + nbuf * P::XN_BYTES), xfull + 8 * nbuf,
                       static_cast<int>(next * P::TM));
    }

    const long long row0 = t * P::TM + wg * 64;  // this warpgroup's rows
    const uint32_t a_base = smem_u32(xn) + wg * (64 * 128);
    unsigned char* stg = stage0 + wg * 2 * kUnitBytes;
    for (int nb = 0; nb + P::GROUP <= P::NB; nb += P::GROUP) {
      float acc[P::GROUP][32];
      block_products<P, P::GROUP>(ring, acc, a_base, lane);
      block_epilogue<P::GROUP>(acc, nb, bias, stg, &omap, row0, M, wt, wg, frow, t2);
    }
    if (P::NB % P::GROUP) {  // an odd block count's last block
      float acc[1][32];
      block_products<P, 1>(ring, acc, a_base, lane);
      block_epilogue<1>(acc, P::NB - 1, bias, stg, &omap, row0, M, wt, wg, frow, t2);
    }

    if (P::NXB == 1) {
      consumer_barrier();  // both warpgroups' products of this tile are complete
      if (threadIdx.x == 0 && t + gridDim.x < tiles)
        load_x_tile<P>(&xmap, smem_u32(xn0), xfull, static_cast<int>((t + gridDim.x) * P::TM));
    }
  }
  if (wt == 0) bulk_wait_all();  // shared memory stays until the last store has read it
}

// A map over a row-major (rows, cols) bf16 matrix that moves boxes of
// box_rows rows x 64 columns (128 bytes) with the 128-byte swizzle; the part
// of a box past (rows, cols) loads as zeros and is not stored.
inline cudaError_t box_map(CUtensorMap* map, const void* p, long long rows, int cols,
                           int box_rows) {
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int CP>
static cudaError_t launch_ln_qkv_bf16(const void* x, const void* ln_w, const void* ln_b,
                                      const void* w, const void* b, void* out, long long M,
                                      float eps, cudaStream_t stream) {
  using P = QkvPlan<CP>;
  CUtensorMap xmap, wmap, omap;
  cudaError_t err = box_map(&xmap, x, M, CP, P::TM);
  if (err == cudaSuccess) err = box_map(&wmap, w, 3 * CP, CP, 64);
  if (err == cudaSuccess) err = box_map(&omap, out, M, 3 * CP, 64);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ln_qkv_bf16_kernel<CP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (M + P::TM - 1) / P::TM;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  ln_qkv_bf16_kernel<CP><<<grid, kBlockThreads, P::SMEM, stream>>>(
      xmap, wmap, omap, static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(b), M, eps);
  return cudaGetLastError();
}

// ------------------------- the CUDA cores: any width -------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

constexpr int kSimpleRows = 64, kSimpleCols = 64, kSimpleK = 32, kSimpleThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kSimpleThreads)
    ln_qkv_simple_kernel(const T* __restrict__ x, const T* __restrict__ ln_w,
                         const T* __restrict__ ln_b, const T* __restrict__ w,
                         const T* __restrict__ b, T* __restrict__ out, long long M, int C,
                         float eps) {
  __shared__ float mu[kSimpleRows], rs[kSimpleRows];
  __shared__ float As[kSimpleK][kSimpleRows + 1];  // the normalised rows, K-major
  __shared__ float Bs[kSimpleK][kSimpleCols + 1];  // Wqkv's rows, K-major
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kSimpleRows;
  const int n0 = blockIdx.y * kSimpleCols, N = 3 * C;
  // the rows' mean and 1 / sqrt(variance + eps), in float, a warp a row
  for (int rr = warp; rr < kSimpleRows; rr += kSimpleThreads / 32) {
    const long long row = row0 + rr;
    float m = 0.f, r = 0.f;
    if (row < M) {
      const T* xr = x + row * C;
      float s = 0.f;
      for (int k = lane; k < C; k += 32) s += to_f(xr[k]);
      m = warp_sum(s) / C;
      float ss = 0.f;
      for (int k = lane; k < C; k += 32) {
        const float d = to_f(xr[k]) - m;
        ss += d * d;
      }
      r = rsqrtf(warp_sum(ss) / C + eps);
    }
    if (lane == 0) mu[rr] = m, rs[rr] = r;
  }
  __syncthreads();
  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16 i, columns tx + 16 j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kSimpleK) {
    for (int e = tid; e < kSimpleRows * kSimpleK; e += kSimpleThreads) {
      const int rr = e / kSimpleK, kk = e % kSimpleK, k = k0 + kk;
      const long long row = row0 + rr;
      float v = 0.f;
      if (row < M && k < C)
        v = to_f(from_f<T>((to_f(x[row * C + k]) - mu[rr]) * rs[rr] * to_f(ln_w[k]) +
                           to_f(ln_b[k])));
      As[kk][rr] = v;
    }
    for (int e = tid; e < kSimpleCols * kSimpleK; e += kSimpleThreads) {
      const int nn = e / kSimpleK, kk = e % kSimpleK, n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = n < N && k < C ? to_f(w[static_cast<long long>(n) * C + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSimpleK; ++kk) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (row < M && n < N) out[row * N + n] = from_f<T>(acc[i][j] + to_f(b[n]));
    }
  }
}

template <typename T>
static cudaError_t launch_ln_qkv_simple(const void* x, const void* ln_w, const void* ln_b,
                                        const void* w, const void* b, void* out, long long M,
                                        int C, float eps, cudaStream_t stream) {
  const long long blocks = (M + kSimpleRows - 1) / kSimpleRows;
  const dim3 grid(static_cast<unsigned>(blocks), (3 * C + kSimpleCols - 1) / kSimpleCols);
  ln_qkv_simple_kernel<T><<<grid, kSimpleThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
      static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(out), M, C, eps);
  return cudaGetLastError();
}

}  // namespace qkv
}  // namespace btsbot

// x (M, C), ln_w / ln_b (C), w (3C, C), b (3C) and out (M, 3C) contiguous on
// one card, all bfloat16 (is_bf16) or all float32; C a multiple of 8, eps
// the LayerNorm's.  bfloat16 at C = 64 .. 512 in steps of 64 runs the
// tensor-core kernel, everything else the CUDA-core one.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int btsbot_ln_qkv(const void* x, const void* ln_w, const void* ln_b, const void* w,
                             const void* b, void* out, long long M, int C, float eps,
                             int is_bf16, void* stream) {
  using namespace btsbot::qkv;
  if (M <= 0) return cudaSuccess;
  if (C <= 0 || C % 8) return cudaErrorInvalidValue;
  // TMA's row coordinates and the CUDA-core grid are 32-bit
  if (M > 0x7fffffffLL - kTileRows) return cudaErrorInvalidConfiguration;
  for (const void* p : {x, ln_w, ln_b, w, b, static_cast<const void*>(out)})
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BTS_QKV(CP) \
  case CP:          \
    return launch_ln_qkv_bf16<CP>(x, ln_w, ln_b, w, b, out, M, eps, s);
  if (is_bf16) {
    switch (C) {
      BTS_QKV(64)
      BTS_QKV(128)
      BTS_QKV(192)
      BTS_QKV(256)
      BTS_QKV(320)
      BTS_QKV(384)
      BTS_QKV(448)
      BTS_QKV(512)
      default:
        return launch_ln_qkv_simple<bf16>(x, ln_w, ln_b, w, b, out, M, C, eps, s);
    }
  }
#undef BTS_QKV
  return launch_ln_qkv_simple<float>(x, ln_w, ln_b, w, b, out, M, C, eps, s);
}
