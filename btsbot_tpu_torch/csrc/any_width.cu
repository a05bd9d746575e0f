// Both ConvNeXt block kernels in float32 at any channel width C and hidden
// width: the widths that the tuned float32 kernels of convnext_block.cu and
// ln_mlp.cu (C = 64, 128, 256, 512, hidden in 64-unit steps) do not take.
// ops/_build.py::kernel_variant sends a float32 launch here by its width:
//   atto  C = 40 / 80 / 160 / 320      femto C = 48 / 96 / 192 / 384
//   nano  C = 80 / 160 / 320 / 640     tiny, small C = 96 / 192 / 384 / 768
//   base  C = 1024 (its 128 / 256 / 512 take the tuned kernels)
// and every hidden width k C of an inceptionnext_*.r<k> kind at those C.
// bfloat16 at these widths runs the tensor-core design of hopper_mlp.cuh
// (the "wgmma_any" kernels of convnext_block.cu and ln_mlp.cu).
//
// Replaces the same TPU kernels as the tuned ones:
//   btsbot_ln_mlp_any          btsbot_tpu/ops/pallas_mlp.py:fused_ln_mlp
//   btsbot_convnext_block_any  btsbot_tpu/ops/pallas_convnext.py:convnext_block_fused
// The Pallas kernels take any C: they pad only the rows (and H, W).  So
// does this one, and its arithmetic is the tuned float32 kernels'
// (block_common.cuh), so a width changes which kernel runs and not what it
// computes.
//
// Design: simple and right first.  One block of 256 threads takes TM rows
// (32, 16 or 8: fewer when the rows are few, so more blocks fill the card,
// or when C is wide).  Everything lives in shared memory as float:
//   xn  [TM][C]   the normalised rows; a warp normalises one row at a time,
//                 the statistics over the real C only;
//   g   [TM][HJ]  GELU of a chunk of HJ hidden units (all of them when
//                 they fit: HJ = hidden);
//   acc [TM][C]   the output sums across chunks, only when HJ < hidden.
// Both products are float FMAs on the CUDA cores: a thread owns one hidden
// unit (or output column) for 8 rows, streams that weight row from L2
// 16 bytes at a time and reads the rows' values as broadcast float4 loads.
// No width needs padding, no tile needs a swizzle, no register array
// depends on C.
//
// What bounds it on the H100: the two products' 8 C^2 multiply-adds a row
// (4 k C^2 at hidden k C) on the CUDA cores (67 TFLOP/s; the 1e-5 contract
// rules out TF32); every block also re-reads W1 and W2 from L2, and the 1x1
// maps give it few blocks.  It runs at 2-9 TFLOP/s (PERF.md).

#include <cuda_runtime.h>

#include "block_common.cuh"

namespace btsbot {
namespace anyw {

constexpr int kThreadsA = 256;
constexpr int kWarpsA = kThreadsA / 32;
constexpr int kRowsA = 8;            // rows one thread's products carry
constexpr int kSmemBudget = 115712;  // bytes: two blocks share an SM
constexpr int kTaps7 = 49;

// LayerNorm in place of one row of C raw float values, held by one warp
// (lane l owns channels l, l + 32, ...): mean, mean of squared deviations,
// eps 1e-6, over the C real channels.
__device__ __forceinline__ void normalise_row(float* __restrict__ row, int C,
                                              const float* __restrict__ ln_w,
                                              const float* __restrict__ ln_b, int lane) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += row[c];
  const float mu = warp_sum(s) / C;
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = row[c] - mu;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_sum(ss) / C + kLnEps);
  for (int c = lane; c < C; c += 32)
    row[c] = (row[c] - mu) * rstd * __ldg(ln_w + c) + __ldg(ln_b + c);
}

// The MLP half for the block's TM rows, once xn is written (rows past M
// hold zeros and are never stored):
//   out = res + gamma * (GELU(xn . W1^T + b1) . W2^T + b2)
// over chunks of HJ hidden units.
__device__ __forceinline__ void mlp_rows(float* __restrict__ smem, const float* __restrict__ w1,
                                         const float* __restrict__ b1, const float* __restrict__ w2,
                                         const float* __restrict__ b2,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ res, float* __restrict__ out,
                                         long long row0, long long M, int C, int hidden,
                                         int tm, int hj_max) {
  float* xn = smem;
  float* gs = xn + tm * C;
  float* acc = gs + tm * hj_max;
  const int groups = tm / kRowsA;
  for (int j0 = 0; j0 < hidden; j0 += hj_max) {
    const int hj = hidden - j0 < hj_max ? hidden - j0 : hj_max;
    const bool first = j0 == 0, last = j0 + hj >= hidden;
    __syncthreads();  // xn is complete; the last chunk's readers of gs are done

    // g = GELU(xn . W1[j0 .. j0 + hj]^T + b1)
    for (int w = threadIdx.x; w < hj * groups; w += kThreadsA) {
      const int jj = w % hj, grp = w / hj;
      const float* xr = xn + grp * kRowsA * C;
      const float* wr = w1 + static_cast<long long>(j0 + jj) * C;
      float a[kRowsA];
#pragma unroll
      for (int r = 0; r < kRowsA; ++r) a[r] = 0.f;
#pragma unroll 2
      for (int k = 0; k < C; k += 4) {
        const float4 wq = __ldg(reinterpret_cast<const float4*>(wr + k));
        const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int r = 0; r < kRowsA; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + r * C + k);
          a[r] = fmaf(xv.x, wv[0], a[r]);
          a[r] = fmaf(xv.y, wv[1], a[r]);
          a[r] = fmaf(xv.z, wv[2], a[r]);
          a[r] = fmaf(xv.w, wv[3], a[r]);
        }
      }
      const float bj = __ldg(b1 + j0 + jj);
#pragma unroll
      for (int r = 0; r < kRowsA; ++r)
        gs[(grp * kRowsA + r) * hj_max + jj] = gelu_erf(a[r] + bj);
    }
    __syncthreads();

    // acc += g . W2[:, j0 .. j0 + hj]^T; on the last chunk the epilogue
    for (int w = threadIdx.x; w < C * groups; w += kThreadsA) {
      const int c = w % C, grp = w / C;
      float a[kRowsA];
#pragma unroll
      for (int r = 0; r < kRowsA; ++r)
        a[r] = first ? 0.f : acc[(grp * kRowsA + r) * C + c];
      const float* wr = w2 + static_cast<long long>(c) * hidden + j0;
      const float* gr = gs + grp * kRowsA * hj_max;
#pragma unroll 2
      for (int jj = 0; jj < hj; jj += 4) {
        const float4 wq = __ldg(reinterpret_cast<const float4*>(wr + jj));
        const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int r = 0; r < kRowsA; ++r) {
          const float4 gv = *reinterpret_cast<const float4*>(gr + r * hj_max + jj);
          a[r] = fmaf(gv.x, wv[0], a[r]);
          a[r] = fmaf(gv.y, wv[1], a[r]);
          a[r] = fmaf(gv.z, wv[2], a[r]);
          a[r] = fmaf(gv.w, wv[3], a[r]);
        }
      }
      if (!last) {
#pragma unroll
        for (int r = 0; r < kRowsA; ++r) acc[(grp * kRowsA + r) * C + c] = a[r];
        continue;
      }
      const float bc = __ldg(b2 + c), gc = __ldg(gamma + c);
#pragma unroll
      for (int r = 0; r < kRowsA; ++r) {
        const long long row = row0 + grp * kRowsA + r;
        if (row < M)
          out[row * C + c] = __ldg(res + row * C + c) + (a[r] + bc) * gc;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreadsA)
    ln_mlp_any_kernel(const float* __restrict__ h, const float* __restrict__ res,
                      const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ gamma, float* __restrict__ out, long long M, int C,
                      int hidden, int tm, int hj) {
  extern __shared__ float4 smem_any[];
  float* xn = reinterpret_cast<float*>(smem_any);
  const long long row0 = static_cast<long long>(blockIdx.x) * tm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < tm; r += kWarpsA) {
    float* row = xn + r * C;
    const long long p = row0 + r;
    if (p >= M) {
      for (int c = lane; c < C; c += 32) row[c] = 0.f;
      continue;
    }
    for (int c = lane; c < C; c += 32) row[c] = __ldg(h + p * C + c);
    normalise_row(row, C, ln_w, ln_b, lane);
  }
  mlp_rows(xn, w1, b1, w2, b2, gamma, res, out, row0, M, C, hidden, tm, hj);
}

__global__ void __launch_bounds__(kThreadsA)
    convnext_block_any_kernel(const float* __restrict__ x, const float* __restrict__ dw_w,
                              const float* __restrict__ dw_b, const float* __restrict__ ln_w,
                              const float* __restrict__ ln_b, const float* __restrict__ w1,
                              const float* __restrict__ b1, const float* __restrict__ w2,
                              const float* __restrict__ b2, const float* __restrict__ gamma,
                              float* __restrict__ out, int B, int H, int W, int C, int hidden,
                              int tm, int hj) {
  extern __shared__ float4 smem_any[];
  float* xn = reinterpret_cast<float*>(smem_any);
  const long long M = static_cast<long long>(B) * H * W;
  const long long row0 = static_cast<long long>(blockIdx.x) * tm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hw = H * W;
  for (int r = warp; r < tm; r += kWarpsA) {
    float* row = xn + r * C;
    const long long p = row0 + r;
    if (p >= M) {
      for (int c = lane; c < C; c += 32) row[c] = 0.f;
      continue;
    }
    const long long n = p / hw;
    const int rem = static_cast<int>(p - n * hw);
    const int py = rem / W, px = rem - (rem / W) * W;
    // depthwise 7x7 SAME, float accumulation, the bias added in float
    // before the LayerNorm (as the tuned kernels and pallas_convnext.py:87)
    for (int c = lane; c < C; c += 32) {
      const float* wc = dw_w + c * kTaps7;  // dw_w is (C, 1, 7, 7)
      float v = 0.f;
      for (int dy = 0; dy < 7; ++dy) {
        const int yy = py + dy - 3;
        if (yy < 0 || yy >= H) continue;
        for (int dx = 0; dx < 7; ++dx) {
          const int xx = px + dx - 3;
          if (xx < 0 || xx >= W) continue;
          v = fmaf(__ldg(x + ((n * H + yy) * W + xx) * C + c), __ldg(wc + dy * 7 + dx), v);
        }
      }
      row[c] = v + __ldg(dw_b + c);
    }
    normalise_row(row, C, ln_w, ln_b, lane);
  }
  // the shortcut is the block input
  mlp_rows(xn, w1, b1, w2, b2, gamma, x, out, row0, M, C, hidden, tm, hj);
}

// ------------------------------ host ------------------------------

// Rows a block takes and hidden units a chunk holds.  Many rows share one
// pass over the weights; few rows (the late stages' small maps) want more,
// smaller blocks to fill 132 SMs; wide rows want fewer to fit.
struct PlanA {
  int tm, hj, bytes;
};

inline bool plan_any(long long M, int C, int hidden, PlanA* p) {
  int tm = M >= 32LL * 264 ? 32 : (M >= 16LL * 264 ? 16 : 8);
  for (; tm >= kRowsA; tm /= 2) {
    const long long whole = 4LL * tm * (C + hidden);
    if (whole <= kSmemBudget) {
      *p = PlanA{tm, hidden, static_cast<int>(whole)};
      return true;
    }
    const long long hj = (kSmemBudget / 4 / tm - 2LL * C) / 4 * 4;
    if (hj >= 64) {
      *p = PlanA{tm, static_cast<int>(hj), static_cast<int>(4LL * tm * (2LL * C + hj))};
      return true;
    }
  }
  return false;
}

inline bool widths_ok(int C, int hidden) {
  return C > 0 && hidden > 0 && C % 8 == 0 && hidden % 8 == 0;
}

template <typename Kernel, typename... Args>
inline cudaError_t launch_any(Kernel kernel, long long M, const PlanA& plan,
                              cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (err != cudaSuccess) return err;
  const long long blocks = (M + plan.tm - 1) / plan.tm;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreadsA, plan.bytes, stream>>>(args..., plan.tm,
                                                                            plan.hj);
  return cudaGetLastError();
}

cudaError_t ln_mlp_any(const void* h, const void* res, const void* ln_w, const void* ln_b,
                       const void* w1, const void* b1, const void* w2, const void* b2,
                       const void* gamma, void* out, long long M, int C, int hidden,
                       cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  PlanA plan;
  if (!widths_ok(C, hidden) || !plan_any(M, C, hidden, &plan)) return cudaErrorInvalidValue;
  return launch_any(ln_mlp_any_kernel, M, plan, stream, static_cast<const float*>(h),
                    static_cast<const float*>(res), static_cast<const float*>(ln_w),
                    static_cast<const float*>(ln_b), static_cast<const float*>(w1),
                    static_cast<const float*>(b1), static_cast<const float*>(w2),
                    static_cast<const float*>(b2), static_cast<const float*>(gamma),
                    static_cast<float*>(out), M, C, hidden);
}

cudaError_t block_any(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                      const void* ln_b, const void* w1, const void* b1, const void* w2,
                      const void* b2, const void* gamma, void* out, int B, int H, int W, int C,
                      int hidden, cudaStream_t stream) {
  const long long M = static_cast<long long>(B) * H * W;
  if (M <= 0) return cudaSuccess;
  PlanA plan;
  if (!widths_ok(C, hidden) || !plan_any(M, C, hidden, &plan)) return cudaErrorInvalidValue;
  return launch_any(convnext_block_any_kernel, M, plan, stream, static_cast<const float*>(x),
                    static_cast<const float*>(dw_w), static_cast<const float*>(dw_b),
                    static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
                    static_cast<const float*>(w1), static_cast<const float*>(b1),
                    static_cast<const float*>(w2), static_cast<const float*>(b2),
                    static_cast<const float*>(gamma), static_cast<float*>(out), B, H, W, C, hidden);
}

}  // namespace anyw
}  // namespace btsbot

// Rows of the flattened index one block takes for M rows at widths C and
// hidden (0: widths the kernel does not take).
extern "C" int btsbot_any_width_rows(long long M, int C, int hidden) {
  btsbot::anyw::PlanA plan;
  if (!btsbot::anyw::widths_ok(C, hidden) || !btsbot::anyw::plan_any(M, C, hidden, &plan))
    return 0;
  return plan.tm;
}

// As btsbot_ln_mlp (ln_mlp.cu) in float32 only (is_bf16 must be 0), at any
// C and hidden that are multiples of 8.
extern "C" int btsbot_ln_mlp_any(const void* h, const void* res, const void* ln_w,
                                 const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* gamma, void* out,
                                 long long M, int C, int hidden, int is_bf16, void* stream) {
  if (is_bf16) return cudaErrorInvalidValue;
  return btsbot::anyw::ln_mlp_any(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, C, hidden,
                                  static_cast<cudaStream_t>(stream));
}

// As btsbot_convnext_block (convnext_block.cu) in float32 only, at any C and
// hidden that are multiples of 8.
extern "C" int btsbot_convnext_block_any(const void* x, const void* dw_w, const void* dw_b,
                                         const void* ln_w, const void* ln_b, const void* w1,
                                         const void* b1, const void* w2, const void* b2,
                                         const void* gamma, void* out, int B, int H, int W,
                                         int C, int hidden, int is_bf16, void* stream) {
  if (is_bf16) return cudaErrorInvalidValue;
  return btsbot::anyw::block_any(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, B, H,
                                 W, C, hidden, static_cast<cudaStream_t>(stream));
}
