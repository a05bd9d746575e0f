// int8 depthwise 7x7 SAME convolution of the quantized ConvNeXt block, with
// the quantize step before it and the dequantize step after it.
//
// No TPU kernel: the JAX package's int8 path (btsbot_tpu/ops/quantized.py,
// quantized_convnext_logits, :199-203) leaves this step to XLA as
// quantize_act -> conv_general_dilated(int8, int8 -> int32, groups = C) ->
// dequantize + bias.  No CUDA operator of PyTorch computes an int8
// depthwise convolution, so this kernel computes the whole step (since
// int8_block.cu fuses the forward's blocks, for the calibration, which needs
// the step's float output):
//
//   q   = clip(round_half_even(float(x) / s_x), -127, 127)   (IEEE division)
//   acc = sum over the 49 taps of q * w_q[c], zero padding, exactly
//   out = T(float(acc) * f32(s_x * s_w[c])) + T(bias[c])
//
// with T the input's type (float32 or bfloat16) and every step rounded where
// the JAX function rounds it: __fdiv_rn, rintf, __fmul_rn and __fadd_rn keep
// nvcc from contracting or approximating (the build has no --use_fast_math).
//
// Exact accumulation: |acc| <= 49 * 127^2 = 790,321 < 2^24, so float FMAs
// over the integer-valued q and w_q are exact.  They run on the FP32 pipe,
// 128 lanes an SM a clock on Hopper against 64 for the int32 multiply-add,
// which is why the taps are floats and not int32.
//
// What bounds it on the H100: per output element 49 multiply-adds against
// two values moved (x in, out out); in bf16 at the FP32 FMA rate the two
// bounds are close (chip_smoke.py prints both).  The design is the simple
// one: a block takes a tile of up to TH x TW output pixels and 32 channels
// (one warp's lanes) of one image, or of up to 6 images where the map is
// that small (3x3: 2, 1x1: 6), quantizes the tiles' halo once into shared
// memory (as floats; a warp a halo row, four loads in flight a lane), and
// each thread slides down one output column of one channel, keeping the
// channel's 49 taps and 7 partial row sums in registers: 7 shared-memory
// loads feed 49 FMAs.  What it leaves: the taps that multiply padding
// columns (a halo row of padding is skipped, but at 1x1 six of the centre
// row's seven taps still multiply zeros), the idle lanes of a partial
// channel chunk (C = 80: 32 + 32 + 16), and the IEEE divisions of the halo
// (about 2.5 an output at 15x15).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace btsbot {
namespace int8dw {

constexpr int K = 7;                   // taps a side
constexpr int R = K / 2;               // SAME padding
constexpr int CC = 32;                 // channels a block: one warp's lanes
constexpr int TW = 8;                  // output columns a tile: one warp each
constexpr int TH = 16;                 // output rows a tile
constexpr int HW = TW + K - 1;         // the halo tile's row stride (columns)
constexpr int HH = TH + K - 1;
constexpr int MAX_BATCH = 65535;       // gridDim.z

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// clip(round_half_even(v / s), -127, 127), kept as an integer-valued float
__device__ __forceinline__ float quantize(float v, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// grid (tiles_h * tiles_w, ceil(C / CC), ceil(B / nimg)), block (CC, tw *
// nimg): th, tw the tile's rows and columns (TH, TW, or the map's own where
// smaller), nimg images a block where a map is that small (their halo tiles
// side by side in shared memory)
template <typename T>
__global__ void __launch_bounds__(CC * TW)
    int8_dwconv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                       const float* __restrict__ w_scale, const T* __restrict__ bias,
                       T* __restrict__ out, float s_x, int B, int H, int W, int C, int th,
                       int tw, int nimg, int tiles_w) {
  __shared__ float tile[HH * HW * CC];  // 39,424 bytes
  const int lane = threadIdx.x, ny = blockDim.y;
  const int y0 = (blockIdx.x / tiles_w) * th, x0 = (blockIdx.x % tiles_w) * tw;
  const int c = blockIdx.y * CC + lane;
  const long long b0 = static_cast<long long>(blockIdx.z) * nimg;

  // the halo, quantized once: a warp takes a halo row, a lane a channel;
  // four positions' loads in flight before their divisions; zeros outside
  // the map (SAME), past C and past the batch
  const int hh = th + K - 1, hw = tw + K - 1;
  for (int r = threadIdx.y; r < nimg * hh; r += ny) {
    const int sub = r / hh, gy = y0 + r - sub * hh - R;
    const long long b = b0 + sub;
    const bool row_in = b < B && gy >= 0 && gy < H && c < C;
    const long long row = row_in ? ((b * H + gy) * W) * C + c : 0;
    float* tr = tile + r * hw * CC + lane;
    for (int hx0 = 0; hx0 < hw; hx0 += 4) {
      float v[4];
      bool in[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int gx = x0 + hx0 + u - R;
        in[u] = row_in && hx0 + u < hw && gx >= 0 && gx < W;
        v[u] = in[u] ? to_float(x[row + static_cast<long long>(gx) * C]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (hx0 + u < hw) tr[(hx0 + u) * CC] = in[u] ? quantize(v[u], s_x) : 0.f;
    }
  }

  const int sub = threadIdx.y / tw, col = threadIdx.y % tw, ox = x0 + col;
  const long long b = b0 + sub;
  float w[K][K];
  float scale = 0.f, bc = 0.f;
  if (c < C) {
#pragma unroll
    for (int ky = 0; ky < K; ++ky)
#pragma unroll
      for (int kx = 0; kx < K; ++kx) w[ky][kx] = static_cast<float>(wq[(ky * K + kx) * C + c]);
    scale = __fmul_rn(s_x, w_scale[c]);  // the per-channel product first
    bc = to_float(bias[c]);
  }
  __syncthreads();
  if (c >= C || ox >= W || b >= B) return;

  // halo row i feeds output rows i-6 .. i of the tile; acc[k] holds row
  // i - 6 + k, to which row i contributes with ky = 6 - k
  const int rows = min(th, H - y0);
  const float* t0 = tile + (sub * hh * hw + col) * CC + lane;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  T* o = out + ((b * H + y0) * W + ox) * C + c;
  for (int i = 0; i < rows + K - 1; ++i) {
    const int gy = y0 + i - R;
    if (gy >= 0 && gy < H) {  // a halo row of padding adds nothing
      float v[K];
#pragma unroll
      for (int kx = 0; kx < K; ++kx) v[kx] = t0[(i * hw + kx) * CC];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int kx = 0; kx < K; ++kx) acc[k] = fmaf(w[K - 1 - k][kx], v[kx], acc[k]);
    }
    const int oy = i - (K - 1);
    if (oy >= 0) {
      const T h = from_float<T>(__fmul_rn(acc[0], scale));
      o[static_cast<long long>(oy) * W * C] = from_float<T>(__fadd_rn(to_float(h), bc));
    }
#pragma unroll
    for (int k = 0; k < K - 1; ++k) acc[k] = acc[k + 1];
    acc[K - 1] = 0.f;
  }
}

template <typename T>
int launch(const void* x, const void* wq, const void* w_scale, const void* bias, void* out,
           float s_x, int B, int H, int W, int C, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const int th = H < TH ? H : TH, tw = W < TW ? W : TW;
  const int tiles_w = (W + tw - 1) / tw, tiles = ((H + th - 1) / th) * tiles_w;
  // as many images a block as fit both the 8 warps and the halo buffer
  const int fit = (HH * HW) / ((th + K - 1) * (tw + K - 1));
  const int nimg = TW / tw < fit ? TW / tw : fit;
  const long long per_image = static_cast<long long>(H) * W * C;
  const long long chunk = static_cast<long long>(MAX_BATCH) * nimg;
  for (long long b0 = 0; b0 < B; b0 += chunk) {
    const int nb = static_cast<int>(B - b0 < chunk ? B - b0 : chunk);
    const long long off = b0 * per_image;
    int8_dwconv_kernel<T><<<dim3(tiles, (C + CC - 1) / CC, (nb + nimg - 1) / nimg),
                            dim3(CC, tw * nimg), 0, stream>>>(
        static_cast<const T*>(x) + off, static_cast<const int8_t*>(wq),
        static_cast<const float*>(w_scale), static_cast<const T*>(bias),
        static_cast<T*>(out) + off, s_x, nb, H, W, C, th, tw, nimg, tiles_w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace int8dw
}  // namespace btsbot

// x, out (B, H, W, C) in float32 (is_bf16 0) or bfloat16 (1), contiguous;
// wq (7, 7, C) int8; w_scale (C,) float32; bias (C,) in x's type.
extern "C" int btsbot_int8_dwconv(const void* x, const void* wq, const void* w_scale,
                                  const void* bias, void* out, float s_x, int B, int H,
                                  int W, int C, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? btsbot::int8dw::launch<__nv_bfloat16>(x, wq, w_scale, bias, out, s_x, B, H,
                                                         W, C, s)
                 : btsbot::int8dw::launch<float>(x, wq, w_scale, bias, out, s_x, B, H, W, C,
                                                 s);
}
