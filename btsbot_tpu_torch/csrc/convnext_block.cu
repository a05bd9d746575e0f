// One whole ConvNeXt block on NHWC input:
//   h   = depthwise 7x7 SAME conv(x) + bias      (float accumulation, bias
//         added in float before the LayerNorm, as pallas_convnext.py:87)
//   out = x + gamma * (GELU(LN(h) . fc1^T + b1) . fc2^T + b2)
//
// Replaces the TPU kernel btsbot_tpu/ops/pallas_convnext.py:
// convnext_block_fused (kernel _kernel, plain version _block_reference).
// What it keeps out of device memory is what the TPU kernel keeps out of
// HBM: the convolution output, the normalised rows and the 4C hidden
// activations; a block reads x once (plus the halo, from L1/L2) and writes
// out once.  The TPU version's padding of H and W to multiples of 8 and its
// batch tile are gone: a block takes TM consecutive pixels of the flattened
// (B*H*W) index, which may span samples (at the 3x3 and 1x1 maps of the
// later stages one sample holds fewer pixels than a tile), and every tap
// checks its own bounds, so SAME padding and the ragged last tile need no
// padded copy.
//
// What bounds it on the H100: per pixel, the two products' 8 C^2
// multiply-adds and the 49 C of the taps, against 2 C values read and
// written.  In bf16 on the tensor cores the two limits are about even at
// C = 64 (stage 0 at batch 3072: 0.053 ms for the bytes, 0.050 ms for the
// operations) and the operations win from C = 128 on; in f32 (no TF32) the
// operations win everywhere.  This first version runs all of it as float
// FMAs on the CUDA cores (ceiling 67 TFLOP/s) and re-reads W1 and W2 through
// L2 in every block, so it is far from either limit; PERF.md has its times.
// The depthwise weights are staged transposed, [tap][C], in the shared
// memory that the MLP's weight chunks use afterwards, so a warp's 32
// channel reads of one tap are conflict-free.

#include "block_common.cuh"

namespace btsbot {

constexpr int kTaps = 49;  // 7 x 7

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    convnext_block_kernel(const T* __restrict__ x, const T* __restrict__ dw_w,
                          const T* __restrict__ dw_b, const T* __restrict__ ln_w,
                          const T* __restrict__ ln_b, const T* __restrict__ w1,
                          const T* __restrict__ b1, const T* __restrict__ w2,
                          const T* __restrict__ b2, const T* __restrict__ gamma,
                          T* __restrict__ out, int B, int H, int W, int hidden) {
  using S = Smem<C>;
  static_assert(kTaps * C <= S::SCRATCH, "depthwise weights do not fit");
  extern __shared__ float smem[];
  float* dws = smem + S::W1S;  // [tap][C], until the first MLP chunk loads
  const long long M = static_cast<long long>(B) * H * W;
  const long long row0 = static_cast<long long>(blockIdx.x) * S::TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kTaps * C; i += kThreads) {
    const int c = i / kTaps, t = i - c * kTaps;  // dw_w is (C, 1, 7, 7)
    dws[t * C + c] = to_f<T>(dw_w[i]);
  }
  __syncthreads();

  const int hw = H * W;
  for (int r = warp; r < S::TM; r += kWarps) {
    float* xs_row = smem + S::XS + r * (C + 1);
    const long long p = row0 + r;
    if (p >= M) {
#pragma unroll
      for (int q = 0; q < C / 32; ++q) xs_row[lane + 32 * q] = 0.f;
      continue;
    }
    const long long n = p / hw;
    const int rem = static_cast<int>(p - n * hw);
    const int py = rem / W, px = rem - (rem / W) * W;
    float v[C / 32];
#pragma unroll
    for (int q = 0; q < C / 32; ++q) v[q] = 0.f;
    for (int dy = 0; dy < 7; ++dy) {
      const int yy = py + dy - 3;
      if (yy < 0 || yy >= H) continue;
      for (int dx = 0; dx < 7; ++dx) {
        const int xx = px + dx - 3;
        if (xx < 0 || xx >= W) continue;
        const T* src = x + ((n * H + yy) * W + xx) * C;
        const float* wt = dws + (dy * 7 + dx) * C;
#pragma unroll
        for (int q = 0; q < C / 32; ++q) {
          const int c = lane + 32 * q;
          v[q] = fmaf(to_f<T>(src[c]), wt[c], v[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < C / 32; ++q) v[q] += to_f<T>(dw_b[lane + 32 * q]);
    layer_norm_row<T, C>(v, ln_w, ln_b, xs_row, lane);
  }
  // mlp_tile's first barrier also retires the reads of dws before the first
  // weight chunk overwrites it; the shortcut is the block input.
  mlp_tile<T, C>(smem, w1, b1, w2, b2, gamma, x, out, row0, M, hidden);
}

template <typename T, int C>
static cudaError_t launch_block(const void* x, const void* dw_w, const void* dw_b,
                                const void* ln_w, const void* ln_b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* gamma, void* out, int B, int H, int W,
                                int hidden, cudaStream_t stream) {
  using S = Smem<C>;
  if (hidden <= 0 || hidden % S::J != 0) return cudaErrorInvalidValue;
  const long long M = static_cast<long long>(B) * H * W;
  return launch_tiles(convnext_block_kernel<T, C>, M, S::TM, S::BYTES, stream,
                      static_cast<const T*>(x), static_cast<const T*>(dw_w),
                      static_cast<const T*>(dw_b), static_cast<const T*>(ln_w),
                      static_cast<const T*>(ln_b), static_cast<const T*>(w1),
                      static_cast<const T*>(b1), static_cast<const T*>(w2),
                      static_cast<const T*>(b2), static_cast<const T*>(gamma),
                      static_cast<T*>(out), B, H, W, hidden);
}

template <typename T>
static cudaError_t dispatch_block(const void* x, const void* dw_w, const void* dw_b,
                                  const void* ln_w, const void* ln_b, const void* w1,
                                  const void* b1, const void* w2, const void* b2,
                                  const void* gamma, void* out, int B, int H, int W,
                                  int C, int hidden, cudaStream_t stream) {
  switch (C) {
    case 64:
      return launch_block<T, 64>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, B, H, W, hidden, stream);
    case 128:
      return launch_block<T, 128>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, B, H, W, hidden, stream);
    case 256:
      return launch_block<T, 256>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, B, H, W, hidden, stream);
    case 512:
      return launch_block<T, 512>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, B, H, W, hidden, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace btsbot

// x and out (B, H, W, C) contiguous, weights in the module layouts, all of
// one type (is_bf16: 0 float, 1 bfloat16), on one card.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError() (0 on success).
extern "C" int btsbot_convnext_block(const void* x, const void* dw_w, const void* dw_b,
                                     const void* ln_w, const void* ln_b, const void* w1,
                                     const void* b1, const void* w2, const void* b2,
                                     const void* gamma, void* out, int B, int H, int W,
                                     int C, int hidden, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return btsbot::dispatch_block<__nv_bfloat16>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2,
                                                 b2, gamma, out, B, H, W, C, hidden, s);
  return btsbot::dispatch_block<float>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma,
                                       out, B, H, W, C, hidden, s);
}
