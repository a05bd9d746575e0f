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
// operations from C = 128 on; in f32 (no TF32) the operations everywhere.
// The (M, 4C) hidden activations that an unfused sequence writes and reads
// back are the traffic this kernel saves.  This first version multiplies on
// the CUDA cores in float (exact float for float32 storage, float
// accumulation of bfloat16 values for bfloat16), so its ceiling is the
// 67 TFLOP/s of float FMA, not the 989 TFLOP/s of the bf16 tensor cores;
// both products read their operands from shared memory through a 16 x 16
// thread grid with one float of row padding.  Moving the two products to
// wgmma with TMA-fed tiles is the next step.

#include "block_common.cuh"

namespace btsbot {

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    ln_mlp_kernel(const T* __restrict__ h, const T* __restrict__ res,
                  const T* __restrict__ ln_w, const T* __restrict__ ln_b,
                  const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ b2,
                  const T* __restrict__ gamma, T* __restrict__ out, long long M,
                  int hidden) {
  using S = Smem<C>;
  extern __shared__ float smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * S::TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int r = warp; r < S::TM; r += kWarps) {
    float* xs_row = smem + S::XS + r * (C + 1);
    const long long row = row0 + r;
    if (row >= M) {
#pragma unroll
      for (int q = 0; q < C / 32; ++q) xs_row[lane + 32 * q] = 0.f;
      continue;
    }
    float v[C / 32];
#pragma unroll
    for (int q = 0; q < C / 32; ++q) v[q] = to_f<T>(h[row * C + lane + 32 * q]);
    layer_norm_row<T, C>(v, ln_w, ln_b, xs_row, lane);
  }
  mlp_tile<T, C>(smem, w1, b1, w2, b2, gamma, res, out, row0, M, hidden);
}

template <typename T, int C>
static cudaError_t launch_ln_mlp(const void* h, const void* res, const void* ln_w,
                                 const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* gamma,
                                 void* out, long long M, int hidden, cudaStream_t stream) {
  using S = Smem<C>;
  if (hidden <= 0 || hidden % S::J != 0) return cudaErrorInvalidValue;
  return launch_tiles(ln_mlp_kernel<T, C>, M, S::TM, S::BYTES, stream,
                      static_cast<const T*>(h), static_cast<const T*>(res),
                      static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
                      static_cast<const T*>(w1), static_cast<const T*>(b1),
                      static_cast<const T*>(w2), static_cast<const T*>(b2),
                      static_cast<const T*>(gamma), static_cast<T*>(out), M, hidden);
}

template <typename T>
static cudaError_t dispatch_ln_mlp(const void* h, const void* res, const void* ln_w,
                                   const void* ln_b, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* gamma,
                                   void* out, long long M, int C, int hidden,
                                   cudaStream_t stream) {
  switch (C) {
    case 64:
      return launch_ln_mlp<T, 64>(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, hidden, stream);
    case 128:
      return launch_ln_mlp<T, 128>(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, hidden, stream);
    case 256:
      return launch_ln_mlp<T, 256>(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, hidden, stream);
    case 512:
      return launch_ln_mlp<T, 512>(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, hidden, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace btsbot

// All tensors contiguous on one card, of one type (is_bf16: 0 float, 1
// bfloat16).  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int btsbot_ln_mlp(const void* h, const void* res, const void* ln_w,
                             const void* ln_b, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* gamma,
                             void* out, long long M, int C, int hidden, int is_bf16,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return btsbot::dispatch_ln_mlp<__nv_bfloat16>(h, res, ln_w, ln_b, w1, b1, w2, b2,
                                                  gamma, out, M, C, hidden, s);
  return btsbot::dispatch_ln_mlp<float>(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out,
                                        M, C, hidden, s);
}
