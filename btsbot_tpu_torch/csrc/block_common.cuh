// Device code shared by the two ConvNeXt block kernels (ln_mlp.cu and
// convnext_block.cu), float32 side: a LayerNorm of one row held by one warp
// and the LN -> fc1 -> GELU -> fc2 -> gamma -> residual tile loop that keeps
// the 4C hidden activations out of device memory.  The bfloat16 side of both
// kernels (wgmma + TMA) is hopper_mlp.cuh.
//
// float32 must agree with the plain version to 1e-5, which rules out TF32,
// so both products are exact float FMAs on the CUDA cores (ceiling
// 67 TFLOP/s): operands staged as float in shared memory with one float of
// row padding, a 16 x 16 thread grid, weight chunks staged through
// registers 16 loads at a time.  That is what bounds it; it serves parity
// checks and training-side callers, not the serving path.
//
// Layouts are the ones the port's modules hold (PyTorch's own):
//   rows   (M, C) row-major, NHWC pixels flattened;
//   fc1.weight (4C, C), fc2.weight (C, 4C), biases and LN params (n,);
//   conv_dw.weight (C, 1, 7, 7).
// No weight is transposed on the host: the tile loads read these layouts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace btsbot {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads for both products
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-6f;

// GELU, erf form (the JAX package's rule for float32, models/common.py).
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows per block (TM) and hidden units per chunk (J) for each width C, picked
// so every array below fits the 227 KB of shared memory a block may use.
template <int C> struct TileShape;
template <> struct TileShape<64> { static constexpr int TM = 128, J = 64; };
template <> struct TileShape<128> { static constexpr int TM = 64, J = 64; };
template <> struct TileShape<256> { static constexpr int TM = 32, J = 64; };
template <> struct TileShape<512> { static constexpr int TM = 32, J = 32; };

// Shared-memory plan, in floats.  Rows are padded by one float so that the
// 16 threads of a half-warp, which read 16 different rows at the same
// column, hit 16 different banks.
template <int C> struct Smem {
  static constexpr int TM = TileShape<C>::TM;
  static constexpr int J = TileShape<C>::J;
  static constexpr int XS = 0;                   // [TM][C+1] normalised rows
  static constexpr int W1S = XS + TM * (C + 1);  // [J][C+1]  fc1 rows j0..j0+J
  static constexpr int GS = W1S + J * (C + 1);   // [TM][J+1] GELU(hidden chunk)
  static constexpr int W2S = GS + TM * (J + 1);  // [C][J+1]  fc2 columns j0..j0+J
  static constexpr int B1S = W2S + C * (J + 1);  // [J]
  static constexpr int FLOATS = B1S + J;
  static constexpr int BYTES = FLOATS * static_cast<int>(sizeof(float));
  // Floats free behind XS before the first chunk loads (the block kernel
  // keeps its depthwise weights there during the convolution).
  static constexpr int SCRATCH = FLOATS - W1S;
  static_assert(BYTES <= 232448, "tile exceeds the shared memory of a block");
  static_assert(TM % 16 == 0 && J % 16 == 0 && C % 32 == 0, "tile shape");
};

// LayerNorm of one row held by one warp: v[q] is channel lane + 32 q, in
// float.  Mean, then mean of squared deviations, eps 1e-6.
template <int C>
__device__ __forceinline__ void layer_norm_row(const float (&v)[C / 32],
                                               const float* __restrict__ ln_w,
                                               const float* __restrict__ ln_b,
                                               float* __restrict__ xs_row, int lane) {
  constexpr int Q = C / 32;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) s += v[q];
  const float mu = warp_sum(s) * (1.0f / C);
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float d = v[q] - mu;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_sum(ss) * (1.0f / C) + kLnEps);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = lane + 32 * q;
    xs_row[c] = (v[q] - mu) * rstd * ln_w[c] + ln_b[c];
  }
}

// The MLP half of a block for the TM rows starting at row0, whose normalised
// values the caller has written to XS (rows past M hold zeros):
//   out = res + gamma * (GELU(xs . fc1^T + b1) . fc2^T + b2).
// The hidden dimension is walked in chunks of J units: a chunk of fc1 rows
// and fc2 columns is staged in shared memory, the chunk's GELU activations
// go to GS, and acc (this thread's share of the (TM, C) output, in
// registers) gathers their product with fc2.  The hidden activations never
// reach device memory.  Thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of each product.
template <int C>
__device__ __forceinline__ void mlp_tile(float* __restrict__ smem,
                                         const float* __restrict__ w1, const float* __restrict__ b1,
                                         const float* __restrict__ w2, const float* __restrict__ b2,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ res, float* __restrict__ out,
                                         long long row0, long long M, int hidden) {
  using S = Smem<C>;
  constexpr int TM = S::TM, J = S::J;
  constexpr int R = TM / 16;   // rows per thread
  constexpr int CA = J / 16;   // hidden units per thread in the first product
  constexpr int CB = C / 16;   // output columns per thread in the second
  float* xs = smem + S::XS;
  float* w1s = smem + S::W1S;
  float* gs = smem + S::GS;
  float* w2s = smem + S::W2S;
  float* b1s = smem + S::B1S;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[R][CB];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[i][c] = 0.f;

  // Each thread stages NW values of each weight chunk, G at a time: a
  // group's loads are all issued before its stores, so G loads are in
  // flight together instead of one.  G stays small (16) because the staged
  // values sit in registers beside acc; 64 spilled at C >= 256.
  constexpr int NW = J * C / kThreads;
  constexpr int G = NW < 16 ? NW : 16;
  static_assert(NW * kThreads == J * C && NW % G == 0, "chunk does not split");
  for (int j0 = 0; j0 < hidden; j0 += J) {
    __syncthreads();  // XS is complete; the last chunk's readers are done
#pragma unroll 1
    for (int g = 0; g < NW; g += G) {
      float r[G];
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const int i = tid + (g + t) * kThreads;
        r[t] = w1[(long long)(j0 + i / C) * C + i % C];
      }
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const int i = tid + (g + t) * kThreads;
        w1s[(i / C) * (C + 1) + i % C] = r[t];
      }
    }
#pragma unroll 1
    for (int g = 0; g < NW; g += G) {
      float r[G];
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const int i = tid + (g + t) * kThreads;
        r[t] = w2[(long long)(i / J) * hidden + j0 + i % J];
      }
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const int i = tid + (g + t) * kThreads;
        w2s[(i / J) * (J + 1) + i % J] = r[t];
      }
    }
    for (int i = tid; i < J; i += kThreads) b1s[i] = b1[j0 + i];
    __syncthreads();

    // first product: (TM, C) . (C, J), float accumulation
    float h[R][CA];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CA; ++j) h[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      float a[R], b[CA];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = xs[(ty + 16 * i) * (C + 1) + k];
#pragma unroll
      for (int j = 0; j < CA; ++j) b[j] = w1s[(tx + 16 * j) * (C + 1) + k];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CA; ++j) h[i][j] = fmaf(a[i], b[j], h[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CA; ++j) {
        const int jj = tx + 16 * j;
        gs[(ty + 16 * i) * (J + 1) + jj] = gelu_erf(h[i][j] + b1s[jj]);
      }
    __syncthreads();

    // second product: acc += (TM, J) . (J, C)
#pragma unroll 4
    for (int jj = 0; jj < J; ++jj) {
      float a[R], b[CB];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = gs[(ty + 16 * i) * (J + 1) + jj];
#pragma unroll
      for (int c = 0; c < CB; ++c) b[c] = w2s[(tx + 16 * c) * (J + 1) + jj];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

  // epilogue: + b2, * gamma, + residual
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const int col = tx + 16 * c;
      out[r * C + col] = res[r * C + col] + (acc[i][c] + b2[col]) * gamma[col];
    }
  }
}

// Host side: raise the block's shared-memory limit, launch, report.
template <typename Kernel, typename... Args>
inline cudaError_t launch_tiles(Kernel kernel, long long rows, int tm, int smem_bytes,
                                cudaStream_t stream, Args... args) {
  if (rows <= 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + tm - 1) / tm;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem_bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace btsbot
