// Fused LayerNorm -> fc1 -> GELU -> fc2 -> gamma -> residual over (M, C) rows.
//
// Replaces the TPU kernel btsbot_tpu/ops/pallas_mlp.py:fused_ln_mlp (kernel
// _kernel, plain version _mlp_reference).  Same function, same rounding
// points; the row padding of the TPU version is gone: the last block masks
// its rows past M.
//
// What bounds it on the H100: per row, the two products' 8 C^2
// multiply-adds against 3 C values moved (h and the shortcut in, the output
// out).  In bf16 on the tensor cores bytes bound it at C = 64 and the
// operations from C = 128 on; in f32 (three TF32 products, tf32x3.cu) the
// operations everywhere.
// The (M, 4C) hidden activations that an unfused sequence writes and reads
// back are the traffic this kernel saves.
//
// bfloat16 (the serving type) runs the design of hopper_mlp.cuh: both
// products as wgmma on the tensor cores, weight tiles through a TMA-fed ring
// that a producer thread keeps ahead of two consumer warpgroups, the GELU
// chunk kept in registers between the products.  Here the consumers read
// their rows of h straight from device memory (16 bytes a lane), normalise
// them into the swizzled Xn tile, and take the shortcut from device memory
// in the epilogue.  What is left between it and its bound: every block
// still re-reads W1 and W2 from L2 (TM = 128 rows share one read), the GELU
// runs on the CUDA cores between the two products of a warpgroup, and the
// grid is not persistent.  PERF.md has the times.
//
// Every other width in bfloat16 runs the same kernel with the channels
// padded inside it (ln_mlp_bf16_kernel<CP, true>, btsbot_ln_mlp_wgmma; the
// design notes are hopper_mlp.cuh's).
//
// float32 runs the three-TF32-product design of tf32x3.cu
// (btsbot_ln_mlp_tf32x3), at every width.

#include "block_common.cuh"
#include "hopper_mlp.cuh"

namespace btsbot {

// ------------------------- bfloat16: wgmma + TMA -------------------------

namespace hopper {

struct GlobalShortcut {
  const bf16* res;
  long long row0;
  int c;
  __device__ __forceinline__ uint32_t operator()(int r, int col) const {
    // read-only path: these loads need not wait for the stores between them
    return __ldg(reinterpret_cast<const uint32_t*>(res + (row0 + r) * c + col));
  }
};

// C = CP (tuned) or the real width c <= CP (ANY), rows of width c in
// device memory.
template <int CP, bool ANY>
__global__ void __maxnreg__((Plan<CP, ANY>::MAX_REGS))
    ln_mlp_bf16_kernel(const __grid_constant__ CUtensorMap map1,
                       const __grid_constant__ CUtensorMap map2, const bf16* __restrict__ h,
                       const bf16* __restrict__ res, const bf16* __restrict__ ln_w,
                       const bf16* __restrict__ ln_b, const bf16* __restrict__ b1,
                       const bf16* __restrict__ b2, const bf16* __restrict__ gamma,
                       bf16* __restrict__ out, long long M, int hidden, int stages,
                       int c_real, float eps) {
  using P = Plan<CP, ANY>;
  const int c = ANY ? c_real : CP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* xn = base + stages * kUnitBytes;
  unsigned char* bars = xn + P::XN_BYTES;
  Ring ring;
  ring.tiles = smem_u32(base);
  ring.full = smem_u32(bars);
  ring.empty = ring.full + 8 * kMaxStages;
  ring.stages = stages;
  init_barriers(ring.full, ring.empty, ring.empty + 8 * kMaxStages, stages);
  const long long row0 = static_cast<long long>(blockIdx.x) * P::TM;
  const Slice<P> sl = Slice<P>::of_block();

  if (threadIdx.x >= kConsumerThreads) {
    if (threadIdx.x == kConsumerThreads) produce_weights<P>(ring, &map1, &map2, hidden, sl);
  } else {
    const int grp = threadIdx.x / P::LPP, l = threadIdx.x % P::LPP;
    uint4 lw[P::VEC], lb[P::VEC];
    load_row_params<P>(ln_w, lw, l, c);
    load_row_params<P>(ln_b, lb, l, c);
    // this lane's share of its rows, LR rows' loads in flight together
    constexpr int kRows = P::TM / P::GROUPS;
    constexpr int LR = P::VEC <= 2 ? kRows : 4;  // wide rows: fewer at once
#pragma unroll
    for (int i0 = 0; i0 < kRows; i0 += LR) {
      uint4 hq[LR][P::VEC];
#pragma unroll
      for (int i = 0; i < LR; ++i)
#pragma unroll
        for (int vv = 0; vv < P::VEC; ++vv) {
          const long long row = row0 + grp + (i0 + i) * P::GROUPS;
          hq[i][vv] = make_uint4(0u, 0u, 0u, 0u);  // rows past M: zeros, never stored
          if (row < M && real_vec<P>(vv, l, c))
            hq[i][vv] = *reinterpret_cast<const uint4*>(h + row * c + (vv * P::LPP + l) * 8);
        }
#pragma unroll
      for (int i = 0; i < LR; ++i) {
        float v[P::VEC][8];
#pragma unroll
        for (int vv = 0; vv < P::VEC; ++vv) unpack8(hq[i][vv], v[vv]);
        layer_norm_to_xn<P>(v, lw, lb, xn, grp + (i0 + i) * P::GROUPS, l, c, eps);
      }
    }
    fence_proxy_async();  // Xn was written by ordinary stores, wgmma reads it
    consumer_barrier();
    consume_mlp<P>(ring, smem_u32(xn), b1, b2, gamma, out, row0, M, hidden, c, sl,
                   GlobalShortcut{res, row0, c});
  }
}

template <int CP, bool ANY>
static cudaError_t launch_ln_mlp_bf16(const void* h, const void* res, const void* ln_w,
                                      const void* ln_b, const void* w1, const void* b1,
                                      const void* w2, const void* b2, const void* gamma,
                                      void* out, long long M, int c, int hidden, float eps,
                                      cudaStream_t stream) {
  using P = Plan<CP, ANY>;
  constexpr int kStages = stages_that_fit(P::SMEM_LIMIT, P::XN_BYTES, 0);
  static_assert(kStages >= kMinStages, "tile exceeds the shared memory of a block");
  constexpr int kBytes = smem_bytes(kStages, P::XN_BYTES, 0);
  if (M <= 0) return cudaSuccess;
  if (hidden <= 0 || hidden % (ANY ? 8 : 64) != 0) return cudaErrorInvalidValue;
  for (const void* p : {h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, static_cast<const void*>(out)})
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  const long long blocks = (M + P::TM - 1) / P::TM;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  CUtensorMap map1, map2;
  cudaError_t err = weight_map(&map1, w1, hidden, c);
  if (err != cudaSuccess) return err;
  err = weight_map(&map2, w2, c, hidden);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ln_mlp_bf16_kernel<CP, ANY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), P::SLICES);
  ln_mlp_bf16_kernel<CP, ANY><<<grid, kBlockThreads, kBytes, stream>>>(
      map1, map2, static_cast<const bf16*>(h), static_cast<const bf16*>(res),
      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(gamma), static_cast<bf16*>(out), M, hidden, kStages, c, eps);
  return cudaGetLastError();
}

// The tuned kernels (C = 64 / 128 / 256 / 512, hidden in 64-unit steps), or
// with `any` the padded ones at every C up to kMaxWidth.
static cudaError_t dispatch_ln_mlp_bf16(const void* h, const void* res, const void* ln_w,
                                        const void* ln_b, const void* w1, const void* b1,
                                        const void* w2, const void* b2, const void* gamma,
                                        void* out, long long M, int C, int hidden, float eps,
                                        bool any, cudaStream_t stream) {
#define BTS_LAUNCH(CP, ANY)                                                                \
  return launch_ln_mlp_bf16<CP, ANY>(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, C, \
                                     hidden, eps, stream);
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

// All tensors contiguous on one card, bfloat16 (float32 runs
// btsbot_ln_mlp_tf32x3); eps is the LayerNorm's (1e-6 in ConvNeXt and
// InceptionNeXt blocks, 1e-5 in MaxViT's).  is_bf16 must be 1: a guard that keeps the earlier
// signature, in which it chose the type, and refuses a float32 caller of it.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch (0 on success).
extern "C" int btsbot_ln_mlp(const void* h, const void* res, const void* ln_w,
                             const void* ln_b, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* gamma,
                             void* out, long long M, int C, int hidden, float eps,
                             int is_bf16, void* stream) {
  if (!is_bf16) return cudaErrorInvalidValue;
  return btsbot::hopper::dispatch_ln_mlp_bf16(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out,
                                              M, C, hidden, eps, false,
                                              static_cast<cudaStream_t>(stream));
}

// As btsbot_ln_mlp in bfloat16 only, at any C up to 1024 and any hidden
// width, both multiples of 8 (the "wgmma_any" kernels).
extern "C" int btsbot_ln_mlp_wgmma(const void* h, const void* res, const void* ln_w,
                                   const void* ln_b, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* gamma,
                                   void* out, long long M, int C, int hidden, float eps,
                                   int is_bf16, void* stream) {
  if (!is_bf16) return cudaErrorInvalidValue;
  return btsbot::hopper::dispatch_ln_mlp_bf16(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out,
                                              M, C, hidden, eps, true,
                                              static_cast<cudaStream_t>(stream));
}
