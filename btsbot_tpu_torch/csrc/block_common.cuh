// Device code shared by the ConvNeXt block kernels: the bfloat16 design
// (hopper_mlp.cuh, used by ln_mlp.cu and convnext_block.cu) and the float32
// one (tf32x3.cu).  Both run the two products of the LN -> fc1 -> GELU ->
// fc2 -> gamma -> residual chain on the tensor cores with wgmma and TMA.
//
// float32 must agree with the plain version to 1e-5.  One TF32 product
// cannot (11 bits of each operand); three can: each operand split into a
// TF32 high part and a TF32 low part, the three products hi.hi, hi.lo,
// lo.hi summed in the float accumulator (tf32x3.cu).
//
// Layouts are the ones the port's modules hold (PyTorch's own):
//   rows   (M, C) row-major, NHWC pixels flattened;
//   fc1.weight (4C, C), fc2.weight (C, 4C), biases and LN params (n,);
//   conv_dw.weight (C, 1, 7, 7).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace btsbot {

// The ConvNeXt LayerNorm's eps, which the block kernels use (tf32x3.cu's and
// hopper_mlp.cuh's LN -> MLP take theirs as an argument: MaxViT's is 1e-5).
constexpr float kLnEps = 1e-6f;
constexpr int kTaps = 49;  // 7 x 7

// GELU, erf form (the JAX package's rule for float32, models/common.py).
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// How far a 7x7 SAME tap can reach along each axis of an (H, W) map, and the
// run of flattened rows around a tile that covers it: every input a tap of
// a tile's rows can touch lies in [row0 - halo, row0 + TM + halo).
struct Reach {
  int ry, rx, halo, taps;
};
inline __host__ __device__ Reach reach_of(int H, int W) {
  Reach q;
  q.ry = H - 1 < 3 ? H - 1 : 3;
  q.rx = W - 1 < 3 ? W - 1 : 3;
  q.halo = q.ry * W + q.rx;
  q.taps = (2 * q.ry + 1) * (2 * q.rx + 1);
  return q;
}

}  // namespace btsbot
