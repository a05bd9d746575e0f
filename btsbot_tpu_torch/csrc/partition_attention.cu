// MaxViT's relative-position-biased multi-head attention over the P x P
// windows (block attention) or dilated P x P grids (grid attention) of a
// map, read from and written to the map in its natural NHWC order.
//
// Replaces no TPU kernel: the JAX package leaves MaxViT's attention to XLA
// (btsbot_tpu/models/maxvit.py: partition -> attention -> reverse).  It was
// added because the port's eager version of that chain moved ~31 MB an alert
// for each stage-0 attention: the partition and reverse copies, an f32 score
// tensor and its bias and softmax copies.  Here a block gathers its tokens
// by index arithmetic and writes each output row back to its own pixel.
//
// Per (image, partition, head), with n = P * P <= 64 tokens, head dim 32:
//   S = (q * scale) k^T + bias[rel(i, j)]   (q * scale rounded to the type,
//                                             S accumulated in float, the
//                                             bias in the type added in float)
//   A = softmax_j(S)                        (float, then rounded to the type)
//   O = A v                                 (accumulated in float)
// with rel(i, j) the swin index (y_i - y_j + P - 1)(2P - 1) + x_i - x_j + P - 1
// of the tokens' places in the partition: the rounding points of the port's
// plain version (ops/partition_attention.py).
//
// What bounds it on the H100: bytes.  Per token and head it reads q, k and v
// (3 x 32 values) and writes 32, for 4 * n * 32 operations: ~25 an input
// byte at n = 49 in bfloat16, far under the ~295 at which the tensor cores
// would be the limit.  So the design reads every input byte once and writes
// every output byte once, in whole 128-byte lines where it can:
//
// bfloat16: one block of 4 warps per (image, partition, pair of heads).  A
// pair's q (or k, v) of a token is 64 values, one 128-byte line of the qkv
// row; cp.async brings the n tokens' q, k and v of both heads into shared
// memory (rows padded to 64 tokens with zeros, an 80-byte pitch that keeps
// ldmatrix free of bank conflicts).  Warp w takes query rows 16w .. 16w + 15
// of each head in turn: both products are mma.sync m16n8k16 (bf16 in, float
// accumulators), the scores and the softmax stay in registers (the padded
// keys' scores are -inf), and the probabilities go from the first product's
// accumulators straight into the second's A fragments.  O is staged over the
// warp's own q rows and stored as 128-byte lines, one a token.  A head count
// that is odd takes one head a block.
//
// float32 (training and the f32 scorer): one block a (image, partition,
// head) on the CUDA cores, every step in float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace btsbot {
namespace pattn {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 32;
constexpr int kRows = 64;      // a partition's tokens, padded to four m16 tiles
constexpr int kPitch = 40;     // bf16 a shared row (80 bytes)
constexpr int kMaxP = 8;
constexpr int kThreads = 128;

struct Geometry {
  int H, W, hp, wp;  // hp = H / P, wp = W / P
  int grid;          // 0: P x P windows; 1: P x P grids strided by (hp, wp)
};

// Where the tokens of one partition lie: token t of partition (py, px) of
// image b.  P is a template argument, so the divisions by it are
// multiplications (the index arithmetic is most of a launch's instructions).
template <int P>
struct Partition {
  long long base;  // pixel of the partition's first token
  int dy, dx;      // pixels between a token and the next along y and x
  __device__ __forceinline__ Partition(const Geometry& g, int b, int part) {
    const int py = part / g.wp, px = part - py * g.wp;
    dy = g.grid ? g.hp * g.W : g.W;
    dx = g.grid ? g.wp : 1;
    base = (static_cast<long long>(b) * g.H + (g.grid ? py : py * P)) * g.W +
           (g.grid ? px : px * P);
  }
  __device__ __forceinline__ long long pixel(int t) const {
    const int ty = t / P;
    return base + static_cast<long long>(ty) * dy + (t - ty * P) * dx;
  }
};

// The swin index of the offset of token i from token j (both < P * P).
template <int P>
__device__ __forceinline__ int rel(int i, int j) {
  const int iy = i / P, jy = j / P;
  return (iy - jy + P - 1) * (2 * P - 1) + (i - iy * P) - (j - jy * P) + P - 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b, m16n8k16, bf16 operands, float accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x * scale) rounded to bf16, on both halves of a packed pair.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * scale, f.y * scale);
}

// GROUP heads a block (2, or 1 where the head count is odd).
template <int P, int GROUP>
__global__ void __launch_bounds__(kThreads)
    partition_attention_bf16_kernel(const bf16* __restrict__ qkv,
                                    const bf16* __restrict__ table, bf16* __restrict__ out,
                                    Geometry g, int c, int heads, float scale) {
  constexpr int n = P * P, ntab = (2 * P - 1) * (2 * P - 1);
  __shared__ __align__(128) bf16 tiles[3][GROUP][kRows * kPitch];  // q / k / v, head
  __shared__ float bias[GROUP][ntab];
  const int nparts = g.hp * g.wp;
  const int b = blockIdx.x / nparts;
  const Partition<P> part(g, b, blockIdx.x - b * nparts);
  const int h0 = blockIdx.y * GROUP;
  const long long pitch3 = 3LL * c;

  // q, k and v of the group's heads for the n tokens: 4 * GROUP 16-byte
  // chunks of each, consecutive threads on consecutive chunks
  constexpr int seg = 4 * GROUP, per_part = n * seg;
  for (int i = threadIdx.x; i < 3 * per_part; i += kThreads) {
    const int which = i / per_part, rem = i - which * per_part;
    const int t = rem / seg, ch = rem - t * seg, hg = ch >> 2, sub = ch & 3;
    cp_async16(&tiles[which][hg][t * kPitch + sub * 8],
               qkv + part.pixel(t) * pitch3 + which * c + (h0 + hg) * kHeadDim + sub * 8);
  }
  // the padded tokens' rows: zeros (a padded key's v must not be NaN)
  for (int i = threadIdx.x; i < 3 * GROUP * (kRows - n) * 4; i += kThreads) {
    const int r = i / (3 * GROUP * 4), rest = i - r * (3 * GROUP * 4);
    const int which = rest / (GROUP * 4), hg = (rest >> 2) % GROUP, sub = rest & 3;
    *reinterpret_cast<uint4*>(&tiles[which][hg][(n + r) * kPitch + sub * 8]) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < GROUP * ntab; i += kThreads) {
    const int hg = i / ntab, e = i - hg * ntab;
    bias[hg][e] = __bfloat162float(table[e * heads + h0 + hg]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp, g4 = lane >> 2, t4 = lane & 3;
  if (r0 < n) {
    // this lane's two query rows, clamped into the partition for the bias
    const int qi[2] = {min(r0 + g4, n - 1), min(r0 + g4 + 8, n - 1)};
#pragma unroll 1
    for (int hg = 0; hg < GROUP; ++hg) {
      bf16* q_tile = tiles[0][hg];
      const bf16* k_tile = tiles[1][hg];
      const bf16* v_tile = tiles[2][hg];
      uint32_t qa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        ldsm_x4(qa[kk], q_tile + (r0 + (lane & 15)) * kPitch + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[kk][e] = scale_bf16x2(qa[kk][e], scale);
      }
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t kb[4];
          ldsm_x4(kb, k_tile + (16 * np + (lane >> 4) * 8 + (lane & 7)) * kPitch + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
        }
      // bias, the padded keys' mask, and the softmax of each row
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          s[j][e] = col < n ? s[j][e] + bias[hg][rel<P>(qi[e >> 1], col)] : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      }
      // the probabilities, rounded, as the A fragments of A v (16 keys a step)
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0] / sum[0], s[2 * kk][1] / sum[0]);
        pa[kk][1] = pack_bf16(s[2 * kk][2] / sum[1], s[2 * kk][3] / sum[1]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0] / sum[0], s[2 * kk + 1][1] / sum[0]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2] / sum[1], s[2 * kk + 1][3] / sum[1]);
      }
      float o[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, v_tile + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch +
                                16 * np + (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa[kk], vb[0], vb[1]);
          mma_bf16(o[2 * np + 1], pa[kk], vb[2], vb[3]);
        }
      // O over this warp's own q rows (read only by this warp, already used)
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint32_t*>(q_tile + (r0 + g4) * kPitch + 8 * j + 2 * t4) =
            pack_bf16(o[j][0], o[j][1]);
        *reinterpret_cast<uint32_t*>(q_tile + (r0 + g4 + 8) * kPitch + 8 * j + 2 * t4) =
            pack_bf16(o[j][2], o[j][3]);
      }
    }
  }
  __syncthreads();
  // each token's output for the group's heads: 32 * GROUP contiguous values
  for (int i = threadIdx.x; i < n * seg; i += kThreads) {
    const int t = i / seg, ch = i - t * seg, hg = ch >> 2, sub = ch & 3;
    *reinterpret_cast<uint4*>(out + part.pixel(t) * c + (h0 + hg) * kHeadDim + sub * 8) =
        *reinterpret_cast<const uint4*>(&tiles[0][hg][t * kPitch + sub * 8]);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    partition_attention_f32_kernel(const float* __restrict__ qkv,
                                   const float* __restrict__ table, float* __restrict__ out,
                                   Geometry g, int c, int heads, float scale) {
  constexpr int n = P * P;
  __shared__ float q[n][kHeadDim + 1], k[n][kHeadDim + 1], v[n][kHeadDim + 1];
  __shared__ float s[n][n + 1];
  const int nparts = g.hp * g.wp;
  const int b = blockIdx.x / nparts, h = blockIdx.y;
  const Partition<P> part(g, b, blockIdx.x - b * nparts);
  const long long pitch3 = 3LL * c;
  for (int i = threadIdx.x; i < 3 * n * kHeadDim; i += kThreads) {
    const int which = i / (n * kHeadDim), t = (i / kHeadDim) % n, d = i % kHeadDim;
    const float x = qkv[part.pixel(t) * pitch3 + which * c + h * kHeadDim + d];
    if (which == 0) q[t][d] = x * scale;
    else if (which == 1) k[t][d] = x;
    else v[t][d] = x;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc = fmaf(q[i][d], k[j][d], acc);
    s[i][j] = acc + table[rel<P>(i, j) * heads + h];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += kThreads / 32) {
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, s[i][j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      s[i][j] = expf(s[i][j] - m);
      sum += s[i][j];
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < n; j += 32) s[i][j] /= sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * kHeadDim; e += kThreads) {
    const int i = e / kHeadDim, d = e % kHeadDim;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(s[i][j], v[j][d], acc);
    out[part.pixel(i) * c + h * kHeadDim + d] = acc;
  }
}

}  // namespace pattn
}  // namespace btsbot

// qkv (B, H, W, 3C) and out (B, H, W, C) contiguous, NHWC, on one card;
// table ((2P - 1)^2, C / 32) contiguous, in the same type (bfloat16 when
// is_bf16, else float32).  C a multiple of 32, 1 <= P <= 8 dividing H and
// W; grid 0 attends within P x P windows, 1 within P x P grids.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int btsbot_partition_attention(const void* qkv, const void* table, void* out, int B,
                                          int H, int W, int C, int P, int grid, float scale,
                                          int is_bf16, void* stream) {
  using namespace btsbot::pattn;
  if (B <= 0) return cudaSuccess;
  if (C <= 0 || C % kHeadDim || P < 1 || P > kMaxP || H % P || W % P) return cudaErrorInvalidValue;
  for (const void* p : {qkv, table, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const Geometry g{H, W, H / P, W / P, grid != 0};
  const int heads = C / kHeadDim;
  const long long blocks = static_cast<long long>(B) * g.hp * g.wp;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 threads(kThreads);
  const auto q16 = static_cast<const bf16*>(qkv);
  const auto t16 = static_cast<const bf16*>(table);
  const auto o16 = static_cast<bf16*>(out);
  const auto q32 = static_cast<const float*>(qkv);
  const auto t32 = static_cast<const float*>(table);
  const auto o32 = static_cast<float*>(out);
#define BTS_P(PP)                                                                              \
  case PP:                                                                                     \
    if (!is_bf16)                                                                              \
      partition_attention_f32_kernel<PP>                                                       \
          <<<dim3(static_cast<unsigned>(blocks), heads), threads, 0, s>>>(q32, t32, o32, g, C, \
                                                                          heads, scale);       \
    else if (heads % 2)                                                                        \
      partition_attention_bf16_kernel<PP, 1>                                                   \
          <<<dim3(static_cast<unsigned>(blocks), heads), threads, 0, s>>>(q16, t16, o16, g, C, \
                                                                          heads, scale);       \
    else                                                                                       \
      partition_attention_bf16_kernel<PP, 2>                                                   \
          <<<dim3(static_cast<unsigned>(blocks), heads / 2), threads, 0, s>>>(q16, t16, o16, g, \
                                                                              C, heads, scale); \
    break;
  switch (P) {
    BTS_P(1)
    BTS_P(2)
    BTS_P(3)
    BTS_P(4)
    BTS_P(5)
    BTS_P(6)
    BTS_P(7)
    BTS_P(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef BTS_P
  return cudaGetLastError();
}
