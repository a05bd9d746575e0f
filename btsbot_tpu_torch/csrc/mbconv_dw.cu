// MaxViT's MBConv middle in one launch, on an NHWC map h (the 1x1 expand's
// output, eval mode):
//
//   out = GELU(BN2(dwconv3x3_s(GELU(BN1(h)))))
//
// with BN1 / BN2 on their running statistics (eps an argument, 1e-5 in
// MaxViT), the depthwise 3x3 at stride s = 1 or 2 with zero padding (1, 1)
// of its post-GELU input, and the rounding points of the port's plain
// version (ops/mbconv_dw.py, op for op models/maxvit.py::MBConv's chain):
//
//   bfloat16: BN1 in float, rounded; GELU (tanh form) in float, rounded;
//             the conv as float sums of the products of those values with
//             the taps rounded to bfloat16 (Conv2d casts its weight to the
//             map's type), rounded; BN2 in float, rounded; GELU, rounded;
//   float32:  every step in float, GELU in its erf form.
//
// BatchNorm is a scale and a shift folded in float32 from the running
// statistics at the start of each block: s = gamma / sqrtf(var + eps)
// (IEEE square root and division), t = beta - mean * s, y = fmaf(x, s, t),
// each BatchNorm with its own eps.  The taps and the BatchNorm vectors are
// read where the module keeps them, in float32 or bfloat16 (widened
// exactly), so a launch makes no copy of them.
// GELU's tanh form is computed as x / (1 + exp(-2u)), u = sqrt(2/pi)(x +
// 0.044715 x^3), the same function as 0.5 x (1 + tanh(u)) without its
// cancellation where tanh(u) is near -1: ex2.approx and __fdividef keep it
// within a few float ulps.
//
// Replaces no TPU kernel: the JAX package leaves the MBConv to XLA
// (btsbot_tpu/models/maxvit.py).  It was added because the port ran this
// chain as cuDNN's grouped direct convolution plus four eager passes (two
// BatchNorms, two GELUs), each reading and writing the expanded map: the
// largest map, 112 x 112 x 256 an alert at 224, is 19.7 GB at batch 3072.
//
// What bounds it on the H100: bytes.  Per output element 9 multiply-adds
// and two activations against the input map read once (four values an
// output at stride 2) and the output written once.  So the design reads
// every input byte once and writes every output byte once, in 128-byte
// lines, and applies BN1 and GELU once an input element (not once a tap):
//
// A block (256 threads) takes a slab of 64 channels (bf16; 32 in float32:
// 128 bytes a pixel either way) of one image, or, where an image is a few
// steps, of images one after another (as many blocks as the card holds at
// once), and walks down it.  A ring of input rows in shared memory, each
// W + 2 pixels wide (the two padding columns zero), holds the rows a step
// of rs output rows reads and, behind them, the rows of the next step (the
// S * rs it adds, or the next image's first), which cp.async brings in
// while this step computes.  Each input row is loaded and transformed (BN1,
// GELU, rounded as above) once, in place, by the thread that loaded it;
// rows outside the map are set to zero after the transform, as the conv
// pads its post-GELU input.  A thread takes 16 bytes of a pixel (8 bf16
// channels, 4 float), so its 9 taps of them sit in registers; the folded BN
// vectors sit in shared memory, for want of registers.  Its output pixels
// of a step follow one another along the rows (rs is chosen so a step has
// about 64 of them a slab).  One barrier a step.  The channel count is any
// multiple of 8: a partial slab leaves its high channel groups idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "block_common.cuh"

namespace btsbot {
namespace mbconv {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kGroups = 8;                  // 16-byte chunks of a pixel's slab: 128 bytes
constexpr int kLanes = kThreads / kGroups;  // pixels a pass of the block
constexpr int kTaps3x3 = 9;
constexpr int kMaxSmem = 232448;            // bytes a block may take on sm_90
constexpr int kWalkSteps = 4;               // steps an image up to which blocks walk images

struct Geometry {
  int B, H, W, C, Ho, Wo;
  int slabs;  // channel slabs an image
  int rs;     // output rows a step
  int need;   // input rows a step reads: S (rs - 1) + 3
  int nslot;  // rows of the ring
};

// The conv's weight (C, 1, 3, 3) and, for BN1 ([0]) and BN2 ([1]), the
// running mean and variance, weight, bias (C,) and eps; the tensors in
// float32 or, where is_bf16 is 1, bfloat16.
struct Params {
  const void* taps;
  const void *mean[2], *var[2], *gamma[2], *beta[2];
  float eps[2];
  int is_bf16;
};

__device__ __forceinline__ float param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// two floats rounded to bfloat16 and widened back
__device__ __forceinline__ void round_pair(float& a, float& b) {
  const uint32_t p = pack_bf16(a, b);
  a = lo_bf16(p);
  b = hi_bf16(p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// GELU, tanh form (the JAX package's rule for bfloat16): x / (1 + 2^(x (k0
// + k1 x^2))), k0 = -2 sqrt(2/pi) log2(e), k1 = 0.044715 k0.  Past x ~ -9.5
// the denominator overflows and the result is -0, as 0.5 x (1 + tanh(u)).
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float k0 = -2.0f * 0.7978845608028654f * 1.4426950408889634f;
  constexpr float k1 = k0 * 0.044715f;
  return __fdividef(x, 1.0f + ex2(x * fmaf(k1, x * x, k0)));
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

// The per-type steps on one 16-byte chunk: 8 bfloat16 channels or 4 float ones.
template <typename T>
struct Ops;

template <>
struct Ops<bf16> {
  static constexpr int V = 8;
  __device__ static float tap(float w) { return __bfloat162float(__float2bfloat16_rn(w)); }
  // BN1 -> round -> GELU -> round
  __device__ static uint4 stage(uint4 v, const float* sc, const float* sh) {
    float s[V], t[V];
    load4(sc, s), load4(sc + 4, s + 4), load4(sh, t), load4(sh + 4, t + 4);
    uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float a = fmaf(lo_bf16(u[k]), s[2 * k], t[2 * k]);
      float b = fmaf(hi_bf16(u[k]), s[2 * k + 1], t[2 * k + 1]);
      round_pair(a, b);
      u[k] = pack_bf16(gelu_tanh(a), gelu_tanh(b));
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
  __device__ static void fma_tap(uint4 v, const float* w, float* acc) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] = fmaf(w[2 * k], lo_bf16(u[k]), acc[2 * k]);
      acc[2 * k + 1] = fmaf(w[2 * k + 1], hi_bf16(u[k]), acc[2 * k + 1]);
    }
  }
  // conv -> round -> BN2 -> round -> GELU -> round
  __device__ static uint4 finish(const float* acc, const float* sc, const float* sh) {
    float s[V], t[V];
    load4(sc, s), load4(sc + 4, s + 4), load4(sh, t), load4(sh + 4, t + 4);
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float a = acc[2 * k], b = acc[2 * k + 1];
      round_pair(a, b);
      a = fmaf(a, s[2 * k], t[2 * k]);
      b = fmaf(b, s[2 * k + 1], t[2 * k + 1]);
      round_pair(a, b);
      u[k] = pack_bf16(gelu_tanh(a), gelu_tanh(b));
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <>
struct Ops<float> {
  static constexpr int V = 4;
  __device__ static float tap(float w) { return w; }
  __device__ static uint4 stage(uint4 v, const float* sc, const float* sh) {
    float s[V], t[V];
    load4(sc, s), load4(sh, t);
    return make_uint4(__float_as_uint(gelu_erf(fmaf(__uint_as_float(v.x), s[0], t[0]))),
                      __float_as_uint(gelu_erf(fmaf(__uint_as_float(v.y), s[1], t[1]))),
                      __float_as_uint(gelu_erf(fmaf(__uint_as_float(v.z), s[2], t[2]))),
                      __float_as_uint(gelu_erf(fmaf(__uint_as_float(v.w), s[3], t[3]))));
  }
  __device__ static void fma_tap(uint4 v, const float* w, float* acc) {
    acc[0] = fmaf(w[0], __uint_as_float(v.x), acc[0]);
    acc[1] = fmaf(w[1], __uint_as_float(v.y), acc[1]);
    acc[2] = fmaf(w[2], __uint_as_float(v.z), acc[2]);
    acc[3] = fmaf(w[3], __uint_as_float(v.w), acc[3]);
  }
  __device__ static uint4 finish(const float* acc, const float* sc, const float* sh) {
    float s[V], t[V];
    load4(sc, s), load4(sh, t);
    return make_uint4(__float_as_uint(gelu_erf(fmaf(acc[0], s[0], t[0]))),
                      __float_as_uint(gelu_erf(fmaf(acc[1], s[1], t[1]))),
                      __float_as_uint(gelu_erf(fmaf(acc[2], s[2], t[2]))),
                      __float_as_uint(gelu_erf(fmaf(acc[3], s[3], t[3]))));
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A thread's pixels of a run of input rows, kLanes apart in row-major
// order: row rr (from 0), column ix, and the ring row of rr (from slot0,
// wrapping).  (rr0, ix0): the thread's first pixel, lane / W and lane % W.
struct Walk {
  int rr, ix, slot;
  __device__ Walk(int rr0, int ix0, int slot0, int nslot) : rr(rr0), ix(ix0), slot(slot0 + rr0) {
    while (slot >= nslot) slot -= nslot;
  }
  __device__ void next(int width, int nslot) {
    ix += kLanes;
    while (ix >= width) {
      ix -= width;
      ++rr;
      if (++slot == nslot) slot = 0;
    }
  }
};

// grid: slabs x G blocks of kThreads, G <= B; block j takes slab j % slabs
// of images j / slabs, j / slabs + G, ...  Dynamic shared memory: the slab's
// folded BN vectors (4 x 8V floats), then the ring (nslot x (W + 2) x
// kGroups chunks).
template <typename T, int S>
__global__ void __launch_bounds__(kThreads, 2)
    mbconv_dw_kernel(const T* __restrict__ x, T* __restrict__ out, const Params prm,
                     const Geometry g) {
  using O = Ops<T>;
  constexpr int V = O::V;
  constexpr int SC = kGroups * V;  // channels a slab
  extern __shared__ __align__(16) unsigned char smem[];
  float* folded = reinterpret_cast<float*>(smem);  // s1, t1, s2, t2: SC each
  uint4* ring = reinterpret_cast<uint4*>(smem + 4 * SC * sizeof(float));
  const int row_chunks = (g.W + 2) * kGroups;

  const int slab = blockIdx.x % g.slabs;
  const int images_apart = gridDim.x / g.slabs;
  const int t = threadIdx.x, grp = t % kGroups, lane = t / kGroups;
  const int c = slab * SC + grp * V;
  const bool live = c < g.C;  // C is a multiple of 8: a chunk is whole or absent

  for (int i = t; i < 2 * SC; i += kThreads) {
    const int k = i / SC, ch = slab * SC + i % SC;  // k: BN1, BN2
    float s = 0.f, sh = 0.f;
    if (ch < g.C) {
      const int b = prm.is_bf16;
      s = __fdiv_rn(param(k ? prm.gamma[1] : prm.gamma[0], ch, b),
                    __fsqrt_rn(__fadd_rn(param(k ? prm.var[1] : prm.var[0], ch, b),
                                         k ? prm.eps[1] : prm.eps[0])));
      sh = fmaf(-param(k ? prm.mean[1] : prm.mean[0], ch, b), s,
                param(k ? prm.beta[1] : prm.beta[0], ch, b));
    }
    folded[2 * k * SC + i % SC] = s;
    folded[(2 * k + 1) * SC + i % SC] = sh;
  }
  for (int i = t; i < g.nslot * 2 * kGroups; i += kThreads) {  // the padding columns
    const int r = i / (2 * kGroups), k = i % (2 * kGroups);
    ring[r * row_chunks + (k < kGroups ? k : (g.W + 1) * kGroups + k - kGroups)] =
        make_uint4(0, 0, 0, 0);
  }
  float w[kTaps3x3][V];
#pragma unroll
  for (int k = 0; k < kTaps3x3; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j)
      w[k][j] = live ? O::tap(param(prm.taps, (c + j) * kTaps3x3 + k, prm.is_bf16)) : 0.f;
  const float* s1 = folded + grp * V;
  const float* t1 = folded + SC + grp * V;
  const float* s2 = folded + 2 * SC + grp * V;
  const float* t2 = folded + 3 * SC + grp * V;
  const int rr0 = lane / g.W, ix0 = lane - rr0 * g.W;      // first input pixel
  const int orr0 = lane / g.Wo, oix0 = lane - orr0 * g.Wo;  // first output pixel
  __syncthreads();

  // input rows [r0, r0 + n) of image m from ring row slot0 on: cp.async of
  // this thread's chunks, then (once they landed) the transform in place
  auto issue = [&](int m, int r0, int n, int slot0) {
    const T* xm = x + static_cast<long long>(m) * g.H * g.W * g.C + c;
    if (live)
      for (Walk p(rr0, ix0, slot0, g.nslot); p.rr < n; p.next(g.W, g.nslot)) {
        const int iy = r0 + p.rr;
        if (iy >= 0 && iy < g.H)
          cp_async16(ring + p.slot * row_chunks + (p.ix + 1) * kGroups + grp,
                     xm + (static_cast<long long>(iy) * g.W + p.ix) * g.C);
      }
    cp_async_commit();
  };
  auto stage = [&](int r0, int n, int slot0) {
    cp_async_wait_all();
    if (live)
      for (Walk p(rr0, ix0, slot0, g.nslot); p.rr < n; p.next(g.W, g.nslot)) {
        const int iy = r0 + p.rr;
        uint4* v = ring + p.slot * row_chunks + (p.ix + 1) * kGroups + grp;
        *v = iy >= 0 && iy < g.H ? O::stage(*v, s1, t1) : make_uint4(0, 0, 0, 0);
      }
  };

  // The block's steps, image after image: a step reads `need` ring rows from
  // `base` on.  The next step's rows go in behind them while this one
  // computes: the `fresh` rows it adds, or a next image's first `need`.
  const int steps = (g.Ho + g.rs - 1) / g.rs;  // an image
  const int fresh = S * g.rs;
  int m = blockIdx.x / g.slabs, k = 0, base = 0;
  issue(m, -1, g.need, 0);
  for (;;) {
    const int oy0 = k * g.rs, r0 = S * oy0 - 1;
    if (k == 0) {
      stage(r0, g.need, base);
    } else {
      int s0 = base + g.need - fresh;
      if (s0 >= g.nslot) s0 -= g.nslot;
      stage(r0 + g.need - fresh, fresh, s0);
    }
    __syncthreads();  // the step's rows are staged; the last step's reads are done
    int next = base + g.need;
    if (next >= g.nslot) next -= g.nslot;
    const int nm = k + 1 < steps ? m : m + images_apart;
    if (nm == m) {
      issue(m, r0 + g.need, fresh, next);
      next = base + fresh;
      if (next >= g.nslot) next -= g.nslot;
    } else if (nm < g.B) {
      issue(nm, -1, g.need, next);
    }
    if (live) {
      T* om = out + static_cast<long long>(m) * g.Ho * g.Wo * g.C + c;
      for (int orr = orr0, ox = oix0; orr < g.rs;) {
        const int oy = oy0 + orr;
        if (oy >= g.Ho) break;
        int slot = base + S * orr;
        if (slot >= g.nslot) slot -= g.nslot;
        float acc[V];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const uint4* row = ring + slot * row_chunks + S * ox * kGroups + grp;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) O::fma_tap(row[dx * kGroups], w[dy * 3 + dx], acc);
          if (++slot == g.nslot) slot = 0;
        }
        *reinterpret_cast<uint4*>(om + (static_cast<long long>(oy) * g.Wo + ox) * g.C) =
            O::finish(acc, s2, t2);
        for (ox += kLanes; ox >= g.Wo; ++orr) ox -= g.Wo;
      }
    }
    if (nm >= g.B) break;
    k = nm == m ? k + 1 : 0;
    m = nm;
    base = next;
  }
}

// The blocks of kernel that the current card holds at once with smem bytes
// of shared memory each.  Asked of the runtime once a (kernel, card, smem):
// the first launch of a shape raises the kernel's shared memory limit if it
// needs more, and queries the card's SMs and the kernel's occupancy; later
// launches look the answer up.
cudaError_t resident_blocks(const void* kernel, int smem, long long* resident) {
  struct Seen {
    const void* kernel;
    int device, smem;
    long long resident;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  int limit = 0;  // the largest smem asked of this kernel on this card: its limit
  for (const Seen& e : seen) {
    if (e.kernel != kernel || e.device != device) continue;
    if (e.smem == smem) {
      *resident = e.resident;
      return cudaSuccess;
    }
    limit = e.smem > limit ? e.smem : limit;
  }
  if (smem > limit)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  *resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  seen.push_back({kernel, device, smem, *resident});
  return cudaSuccess;
}

template <typename T, int S>
int launch(const void* x, void* out, const Params& prm, int B, int H, int W, int C,
           cudaStream_t stream) {
  constexpr int SC = kGroups * Ops<T>::V;
  Geometry g;
  g.B = B, g.H = H, g.W = W, g.C = C;
  g.Ho = (H - 1) / S + 1;  // (H + 2 - 3) / S + 1
  g.Wo = (W - 1) / S + 1;
  g.slabs = (C + SC - 1) / SC;
  g.rs = 2 * kLanes / g.Wo;
  g.rs = g.rs < 1 ? 1 : g.rs > g.Ho ? g.Ho : g.rs;
  g.need = S * (g.rs - 1) + 3;
  g.nslot = 2 * g.need;  // a step's rows and the next step's (need > S * rs)
  const size_t smem = 4 * SC * sizeof(float) +
                      static_cast<size_t>(g.nslot) * (W + 2) * kGroups * sizeof(uint4);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const auto kernel = mbconv_dw_kernel<T, S>;
  long long resident = 0;
  const cudaError_t err =
      resident_blocks(reinterpret_cast<const void*>(kernel), static_cast<int>(smem), &resident);
  if (err != cudaSuccess) return err;
  // An image of a few steps leaves a block little to overlap: there, as many
  // blocks as the card holds at once (a whole number of them a slab) walk
  // image after image.  A taller image overlaps its own steps, and a block
  // an image lets the card balance the load (on the H100: 112 x 112 x 256
  // at stride 2 takes 14.2 ms a 3072 batch so and 16.4 ms walking, 7 x 7 x
  // 2048 2.37 ms so and 1.34 ms walking).
  const int steps = (g.Ho + g.rs - 1) / g.rs;
  long long per_slab = steps <= kWalkSteps ? resident / g.slabs : B;
  per_slab = per_slab < 1 ? 1 : per_slab > B ? B : per_slab;
  const long long blocks = per_slab * g.slabs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), prm, g);
  return cudaGetLastError();
}

}  // namespace mbconv
}  // namespace btsbot

// x (B, H, W, C) and out (B, ceil(H / stride), ceil(W / stride), C), NHWC,
// contiguous, float32 (is_bf16 0) or bfloat16 (1); taps the conv's weight
// (C, 1, 3, 3) and mean1 .. beta2 BN1's and BN2's running mean, running var,
// weight and bias (C,), contiguous, float32 (params_bf16 0) or bfloat16 (1);
// eps1, eps2 the BatchNorms' eps.  C a multiple of 8, stride 1 or 2.
extern "C" int btsbot_mbconv_dw(const void* x, const void* taps, const void* mean1,
                                const void* var1, const void* gamma1, const void* beta1,
                                const void* mean2, const void* var2, const void* gamma2,
                                const void* beta2, void* out, int B, int H, int W, int C,
                                int stride, float eps1, float eps2, int is_bf16,
                                int params_bf16, void* stream) {
  using namespace btsbot::mbconv;
  if (B <= 0) return cudaSuccess;
  if (H <= 0 || W <= 0 || C <= 0 || C % 8 || (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  for (const void* p : {x, static_cast<const void*>(out)})  // 16-byte chunks
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const Params prm{taps,         {mean1, mean2}, {var1, var2}, {gamma1, gamma2},
                   {beta1, beta2}, {eps1, eps2},  params_bf16};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return stride == 1 ? launch<bf16, 1>(x, out, prm, B, H, W, C, s)
                       : launch<bf16, 2>(x, out, prm, B, H, W, C, s);
  return stride == 1 ? launch<float, 1>(x, out, prm, B, H, W, C, s)
                     : launch<float, 2>(x, out, prm, B, H, W, C, s);
}
