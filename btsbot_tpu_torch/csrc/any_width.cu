// Both ConvNeXt block kernels at any channel width C and hidden width, in
// float32 and bfloat16: the widths that the tuned kernels of
// convnext_block.cu and ln_mlp.cu (C = 64, 128, 256, 512) do not take.
// ops/_build.py::kernel_variant sends a launch here by its width:
//   atto  C = 40 / 80 / 160 / 320      femto C = 48 / 96 / 192 / 384
//   nano  C = 80 / 160 / 320 / 640     tiny, small C = 96 / 192 / 384 / 768
//   base  C = 1024 (its 128 / 256 / 512 take the tuned kernels)
// and every hidden width k C of an inceptionnext_*.r<k> kind at those C.
//
// Replaces the same TPU kernels as the tuned ones:
//   btsbot_ln_mlp_any          btsbot_tpu/ops/pallas_mlp.py:fused_ln_mlp
//   btsbot_convnext_block_any  btsbot_tpu/ops/pallas_convnext.py:convnext_block_fused
// The Pallas kernels take any C: they pad only the rows (and H, W).  So
// does this one, and its rounding points are the tuned kernels' (bf16:
// hopper_mlp.cuh; float32: block_common.cuh), so a width changes which
// kernel runs and not what it computes.
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
// 16 or 8 bytes at a time and reads the rows' values as broadcast float4
// loads.  No width needs padding, no tile needs a swizzle, no register
// array depends on C.
//
// What bounds it on the H100: the two products' 8 C^2 multiply-adds a row
// (4 k C^2 at hidden k C) on the CUDA cores, whose float rate (67 TFLOP/s)
// is 15x below the tensor cores' bf16 rate that bounds the work in bf16;
// every block also re-reads W1 and W2 from L2, and the 1x1 maps give it few
// blocks.  It runs at 2-9 TFLOP/s; PERF.md has the times against both
// bounds, and making these widths fast is queued (ROADMAP Queue B item 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "block_common.cuh"
#include "hopper_mlp.cuh"

namespace btsbot {
namespace anyw {

using bf16 = __nv_bfloat16;

constexpr int kThreadsA = 256;
constexpr int kWarpsA = kThreadsA / 32;
constexpr int kRowsA = 8;            // rows one thread's products carry
constexpr int kSmemBudget = 115712;  // bytes: two blocks share an SM
constexpr int kTaps7 = 49;

// Loads, the rounding points and the stores of each storage type.
template <typename T> struct Ops;

template <> struct Ops<float> {
  static __device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  static __device__ __forceinline__ float norm(float z, float w, float b) { return z * w + b; }
  static __device__ __forceinline__ float act(float h, float b1) { return gelu_erf(h + b1); }
  static __device__ __forceinline__ float finish(float a, float b2, float g, float res) {
    return res + (a + b2) * g;
  }
  static __device__ __forceinline__ float to(float v) { return v; }
};

template <> struct Ops<bf16> {
  static __device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void ld4(const bf16* p, float (&v)[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = hopper::lo_f(q.x), v[1] = hopper::hi_f(q.x);
    v[2] = hopper::lo_f(q.y), v[3] = hopper::hi_f(q.y);
  }
  // bf16 after the normalisation, after scale, after shift (as hopper_mlp.cuh)
  static __device__ __forceinline__ float norm(float z, float w, float b) {
    return hopper::rb(hopper::rb(hopper::rb(z) * w) + b);
  }
  // bf16 after the product, after the bias, after GELU (tanh form)
  static __device__ __forceinline__ float act(float h, float b1) {
    return hopper::rb(hopper::gelu_tanh(hopper::rb(hopper::rb(h) + b1)));
  }
  // bf16 after the product, after b2, after gamma; the residual add rounds
  // in the store
  static __device__ __forceinline__ float finish(float a, float b2, float g, float res) {
    const float y = hopper::rb(hopper::rb(a) + b2);
    return res + hopper::rb(y * g);
  }
  static __device__ __forceinline__ bf16 to(float v) { return __float2bfloat16(v); }
};

// LayerNorm in place of one row of C raw float values, held by one warp
// (lane l owns channels l, l + 32, ...): mean, mean of squared deviations,
// eps 1e-6, over the C real channels.
template <typename T>
__device__ __forceinline__ void normalise_row(float* __restrict__ row, int C,
                                              const T* __restrict__ ln_w,
                                              const T* __restrict__ ln_b, int lane) {
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
    row[c] = Ops<T>::norm((row[c] - mu) * rstd, Ops<T>::ld(ln_w + c), Ops<T>::ld(ln_b + c));
}

// The MLP half for the block's TM rows, once xn is written (rows past M
// hold zeros and are never stored):
//   out = res + gamma * (GELU(xn . W1^T + b1) . W2^T + b2)
// over chunks of HJ hidden units.
template <typename T>
__device__ __forceinline__ void mlp_rows(float* __restrict__ smem, const T* __restrict__ w1,
                                         const T* __restrict__ b1, const T* __restrict__ w2,
                                         const T* __restrict__ b2, const T* __restrict__ gamma,
                                         const T* __restrict__ res, T* __restrict__ out,
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
      const T* wr = w1 + static_cast<long long>(j0 + jj) * C;
      float a[kRowsA];
#pragma unroll
      for (int r = 0; r < kRowsA; ++r) a[r] = 0.f;
#pragma unroll 2
      for (int k = 0; k < C; k += 4) {
        float wv[4];
        Ops<T>::ld4(wr + k, wv);
#pragma unroll
        for (int r = 0; r < kRowsA; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + r * C + k);
          a[r] = fmaf(xv.x, wv[0], a[r]);
          a[r] = fmaf(xv.y, wv[1], a[r]);
          a[r] = fmaf(xv.z, wv[2], a[r]);
          a[r] = fmaf(xv.w, wv[3], a[r]);
        }
      }
      const float bj = Ops<T>::ld(b1 + j0 + jj);
#pragma unroll
      for (int r = 0; r < kRowsA; ++r)
        gs[(grp * kRowsA + r) * hj_max + jj] = Ops<T>::act(a[r], bj);
    }
    __syncthreads();

    // acc += g . W2[:, j0 .. j0 + hj]^T; on the last chunk the epilogue
    for (int w = threadIdx.x; w < C * groups; w += kThreadsA) {
      const int c = w % C, grp = w / C;
      float a[kRowsA];
#pragma unroll
      for (int r = 0; r < kRowsA; ++r)
        a[r] = first ? 0.f : acc[(grp * kRowsA + r) * C + c];
      const T* wr = w2 + static_cast<long long>(c) * hidden + j0;
      const float* gr = gs + grp * kRowsA * hj_max;
#pragma unroll 2
      for (int jj = 0; jj < hj; jj += 4) {
        float wv[4];
        Ops<T>::ld4(wr + jj, wv);
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
      const float bc = Ops<T>::ld(b2 + c), gc = Ops<T>::ld(gamma + c);
#pragma unroll
      for (int r = 0; r < kRowsA; ++r) {
        const long long row = row0 + grp * kRowsA + r;
        if (row < M)
          out[row * C + c] = Ops<T>::to(Ops<T>::finish(a[r], bc, gc, Ops<T>::ld(res + row * C + c)));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsA)
    ln_mlp_any_kernel(const T* __restrict__ h, const T* __restrict__ res,
                      const T* __restrict__ ln_w, const T* __restrict__ ln_b,
                      const T* __restrict__ w1, const T* __restrict__ b1,
                      const T* __restrict__ w2, const T* __restrict__ b2,
                      const T* __restrict__ gamma, T* __restrict__ out, long long M, int C,
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
    for (int c = lane; c < C; c += 32) row[c] = Ops<T>::ld(h + p * C + c);
    normalise_row<T>(row, C, ln_w, ln_b, lane);
  }
  mlp_rows<T>(xn, w1, b1, w2, b2, gamma, res, out, row0, M, C, hidden, tm, hj);
}

template <typename T>
__global__ void __launch_bounds__(kThreadsA)
    convnext_block_any_kernel(const T* __restrict__ x, const T* __restrict__ dw_w,
                              const T* __restrict__ dw_b, const T* __restrict__ ln_w,
                              const T* __restrict__ ln_b, const T* __restrict__ w1,
                              const T* __restrict__ b1, const T* __restrict__ w2,
                              const T* __restrict__ b2, const T* __restrict__ gamma,
                              T* __restrict__ out, int B, int H, int W, int C, int hidden,
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
      const T* wc = dw_w + c * kTaps7;  // dw_w is (C, 1, 7, 7)
      float v = 0.f;
      for (int dy = 0; dy < 7; ++dy) {
        const int yy = py + dy - 3;
        if (yy < 0 || yy >= H) continue;
        for (int dx = 0; dx < 7; ++dx) {
          const int xx = px + dx - 3;
          if (xx < 0 || xx >= W) continue;
          v = fmaf(Ops<T>::ld(x + ((n * H + yy) * W + xx) * C + c), Ops<T>::ld(wc + dy * 7 + dx),
                   v);
        }
      }
      row[c] = v + Ops<T>::ld(dw_b + c);
    }
    normalise_row<T>(row, C, ln_w, ln_b, lane);
  }
  // the shortcut is the block input
  mlp_rows<T>(xn, w1, b1, w2, b2, gamma, x, out, row0, M, C, hidden, tm, hj);
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

template <typename T>
cudaError_t ln_mlp_any(const void* h, const void* res, const void* ln_w, const void* ln_b,
                       const void* w1, const void* b1, const void* w2, const void* b2,
                       const void* gamma, void* out, long long M, int C, int hidden,
                       cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  PlanA plan;
  if (!widths_ok(C, hidden) || !plan_any(M, C, hidden, &plan)) return cudaErrorInvalidValue;
  return launch_any(ln_mlp_any_kernel<T>, M, plan, stream, static_cast<const T*>(h),
                    static_cast<const T*>(res), static_cast<const T*>(ln_w),
                    static_cast<const T*>(ln_b), static_cast<const T*>(w1),
                    static_cast<const T*>(b1), static_cast<const T*>(w2),
                    static_cast<const T*>(b2), static_cast<const T*>(gamma),
                    static_cast<T*>(out), M, C, hidden);
}

template <typename T>
cudaError_t block_any(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                      const void* ln_b, const void* w1, const void* b1, const void* w2,
                      const void* b2, const void* gamma, void* out, int B, int H, int W, int C,
                      int hidden, cudaStream_t stream) {
  const long long M = static_cast<long long>(B) * H * W;
  if (M <= 0) return cudaSuccess;
  PlanA plan;
  if (!widths_ok(C, hidden) || !plan_any(M, C, hidden, &plan)) return cudaErrorInvalidValue;
  return launch_any(convnext_block_any_kernel<T>, M, plan, stream, static_cast<const T*>(x),
                    static_cast<const T*>(dw_w), static_cast<const T*>(dw_b),
                    static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
                    static_cast<const T*>(w1), static_cast<const T*>(b1),
                    static_cast<const T*>(w2), static_cast<const T*>(b2),
                    static_cast<const T*>(gamma), static_cast<T*>(out), B, H, W, C, hidden);
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

// As btsbot_ln_mlp (ln_mlp.cu), at any C and hidden that are multiples of 8.
extern "C" int btsbot_ln_mlp_any(const void* h, const void* res, const void* ln_w,
                                 const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* gamma, void* out,
                                 long long M, int C, int hidden, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return btsbot::anyw::ln_mlp_any<__nv_bfloat16>(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma,
                                                   out, M, C, hidden, s);
  return btsbot::anyw::ln_mlp_any<float>(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, C,
                                         hidden, s);
}

// As btsbot_convnext_block (convnext_block.cu), at any C and hidden that are
// multiples of 8.
extern "C" int btsbot_convnext_block_any(const void* x, const void* dw_w, const void* dw_b,
                                         const void* ln_w, const void* ln_b, const void* w1,
                                         const void* b1, const void* w2, const void* b2,
                                         const void* gamma, void* out, int B, int H, int W,
                                         int C, int hidden, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return btsbot::anyw::block_any<__nv_bfloat16>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2,
                                                  gamma, out, B, H, W, C, hidden, s);
  return btsbot::anyw::block_any<float>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out,
                                        B, H, W, C, hidden, s);
}
