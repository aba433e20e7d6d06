// Int8-weight GEMV for small M, for Hopper (sm_90a).
//
// No Pallas kernel of the JAX package computes this: there it is XLA's
// fusion inside `_proj` (vnsum_tpu/models/llama.py:257-291) and the int8 arm
// of `_lm_head_logits` (:302-313), where the int8-to-bf16 convert folds
// into the matmul's tile loads so device memory sees int8. This kernel is
// that product for the forwards with few rows: decode (M = B <= 8), the
// spec verify forward (M = B * (k + 1) = 72), the slot segment, the long
// decode and the LM head of a last_only prefill. Inputs:
//   x [M, K] bf16, contiguous, 1 <= M <= MAX_M (128);
//   q [N, K] int8, the stored layout of models/quant.py (output channel
//     major, the contraction contiguous), K a multiple of 16;
//   s [N] f32, the per-channel scales.
// Per output it computes sum_k f32(x[m,k]) * f32(q[n,k]) (each product is
// exact in f32), then
//   projection mode: out[m,n] = bf16(f32(bf16(sum)) * s[n])  (bf16 out);
//   head mode:       out[m,n] = sum * s[n]                    (f32 out).
//
// What bounds it on this card: device-memory bytes. Every weight byte is
// read once a call: at Llama-3.2-3B's shapes (wq 3072 x 3072 ... the tied
// head 128256 x 3072) a decode step reads 3.21 GB of int8 weights plus
// their scales, ~0.96 ms at 3.35 TB/s, against ~0.05 ms of bf16
// tensor-core work at M = 8.
//
// Design: right and simple first. A block of 8 warps owns a tile of 16
// output channels, the 16 rows of an mma m16n8k16 A operand; the warps
// split K into 64-byte slabs (slab i goes to warp i % 8), so each weight
// byte comes from device memory once. In a slab, lane (g, t) reads the
// 16-byte chunk at k = 64 i + 16 t of rows g and g + 8 with a streaming
// load that leaves L1 to x, six slabs' loads in flight before the first
// is used (a warp's whole share at K = 3072; with one group of x rows, the
// decode case, x's loads go with them). int8 widens to bf16 exactly
// through an f32 magic number. The
// contraction order inside a slab is permuted so that a lane's own 16
// bytes feed its fragments directly: mma step j takes bytes 4j..4j+3 of
// each lane's chunk as that lane's four k columns, and the B operand (x,
// 8 rows a step) takes the same 16 bf16 of x row g at the same k, two
// 16-byte loads that L1 serves to every warp. M above 8 loops over groups
// of 8 rows on the same A fragments, so q is still read once. Each warp
// keeps an f32 accumulator fragment per group; after the loop the 8 warps'
// partial sums meet in shared memory and are added in warp order, so the
// result does not depend on timing. The tensor cores' f32 sums differ from
// a sequential f32 sum by summation order only. The kernel runs on the
// caller's stream, synchronises nothing and allocates nothing, so it runs
// inside a captured CUDA graph.
// Measured against variants in one call on an H100 (PERF.md): four slabs
// in flight cost ~5% a decode step; eight, with x preloaded, take ~190
// registers a thread and one block an SM, and cost ~25%.
// Not done: wgmma, TMA, split-K across blocks (a projection of 1024
// channels fills 64 blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_N = 16;   // output channels of a block: one m16 tile
constexpr int SLAB = 64;     // K bytes of a warp's step: 4 lanes x 16 bytes
constexpr int UNROLL = 6;    // slabs whose loads a warp keeps in flight
constexpr int MAX_M = 128;

__device__ __forceinline__ uint4 ld_stream(const int8_t *p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// four int8 -> two bf16x2 (bytes 0,1 in lo; 2,3 in hi), exactly: each byte
// becomes 2^23 + (b + 128) as f32 bits, minus the magic, then the upper
// half of the f32 (exact for these integers) is the bf16
__device__ __forceinline__ void widen_int8x4(uint32_t w, uint32_t &lo, uint32_t &hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float magic = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - magic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - magic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - magic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - magic;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NG groups of 8 rows of x; shared memory holds the warps' partial sums,
// [WARPS][TILE_N][NG * 8] f32
template <int NG>
__global__ void __launch_bounds__(THREADS)
    int8_gemv_kernel(const __nv_bfloat16 *__restrict__ x, const int8_t *__restrict__ q,
                     const float *__restrict__ s, void *__restrict__ out, int M, int N, int K,
                     int head) {
  extern __shared__ float red[];
  constexpr int MP = NG * 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int n0 = blockIdx.x * TILE_N;
  const bool row0 = n0 + g < N;
  const bool row1 = n0 + g + 8 < N;
  const int8_t *q0 = q + static_cast<size_t>(row0 ? n0 + g : 0) * K;
  const int8_t *q1 = q + static_cast<size_t>(row1 ? n0 + g + 8 : 0) * K;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float acc[NG][4];
#pragma unroll
  for (int G = 0; G < NG; ++G) acc[G][0] = acc[G][1] = acc[G][2] = acc[G][3] = 0.f;

  const int n_slabs = (K + SLAB - 1) / SLAB;
  for (int base = warp; base < n_slabs; base += WARPS * UNROLL) {
    // every load of the round first: q, and with one group (decode) x too
    uint4 w0[UNROLL], w1[UNROLL], xr[NG == 1 ? UNROLL : 1][2];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = (base + u * WARPS) * SLAB + 16 * t;
      const bool chunk = k < K;  // this lane's 16 bytes lie in the row
      w0[u] = chunk && row0 ? ld_stream(q0 + k) : zero;
      w1[u] = chunk && row1 ? ld_stream(q1 + k) : zero;
      if constexpr (NG == 1) {
        xr[u][0] = xr[u][1] = zero;
        if (g < M && k < K) {
          const uint4 *xp = reinterpret_cast<const uint4 *>(x + static_cast<size_t>(g) * K + k);
          xr[u][0] = __ldg(xp);
          xr[u][1] = __ldg(xp + 1);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * WARPS < n_slabs) {  // warp-uniform
        const int k = (base + u * WARPS) * SLAB + 16 * t;
        // A fragments of the slab's four k16 steps: step j is bytes
        // 4j..4j+3 of this lane's chunk, of rows g (a0, a2) and g + 8 (a1, a3)
        uint32_t a[4][4];
        widen_int8x4(w0[u].x, a[0][0], a[0][2]);
        widen_int8x4(w1[u].x, a[0][1], a[0][3]);
        widen_int8x4(w0[u].y, a[1][0], a[1][2]);
        widen_int8x4(w1[u].y, a[1][1], a[1][3]);
        widen_int8x4(w0[u].z, a[2][0], a[2][2]);
        widen_int8x4(w1[u].z, a[2][1], a[2][3]);
        widen_int8x4(w0[u].w, a[3][0], a[3][2]);
        widen_int8x4(w1[u].w, a[3][1], a[3][3]);
#pragma unroll
        for (int G = 0; G < NG; ++G) {
          // B fragments: the same 16 k of x row G * 8 + g, bf16 pairs in
          // order, so step j takes words 2j and 2j + 1
          const int m = G * 8 + g;
          uint4 xa = zero, xb = zero;
          if constexpr (NG == 1) {
            xa = xr[u][0];
            xb = xr[u][1];
          } else if (m < M && k < K) {
            const uint4 *xp = reinterpret_cast<const uint4 *>(x + static_cast<size_t>(m) * K + k);
            xa = __ldg(xp);
            xb = __ldg(xp + 1);
          }
          mma_bf16(acc[G], a[0], xa.x, xa.y);
          mma_bf16(acc[G], a[1], xa.z, xa.w);
          mma_bf16(acc[G], a[2], xb.x, xb.y);
          mma_bf16(acc[G], a[3], xb.z, xb.w);
        }
      }
    }
  }

  // the warps' partial sums: accumulator (row g / g + 8, columns 2t, 2t + 1)
  // of group G is (channel n0 + g / + 8, rows G * 8 + 2t, + 1 of x)
  float *mine = red + warp * TILE_N * MP;
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const int m = G * 8 + 2 * t;
    mine[g * MP + m] = acc[G][0];
    mine[g * MP + m + 1] = acc[G][1];
    mine[(g + 8) * MP + m] = acc[G][2];
    mine[(g + 8) * MP + m + 1] = acc[G][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_N * M; i += THREADS) {
    const int nl = i % TILE_N;
    const int m = i / TILE_N;
    const int n = n0 + nl;
    if (n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * TILE_N + nl) * MP + m];
    const float sc = s[n];
    const size_t o = static_cast<size_t>(m) * N + n;
    if (head) {
      static_cast<float *>(out)[o] = sum * sc;
    } else {
      const float y = __bfloat162float(__float2bfloat16_rn(sum));
      static_cast<__nv_bfloat16 *>(out)[o] = __float2bfloat16_rn(y * sc);
    }
  }
}

constexpr int smem_bytes(int ng) { return WARPS * TILE_N * ng * 8 * 4; }

template <int NG>
int launch(const void *x, const void *q, const void *s, void *out, int M, int N, int K,
           int head, cudaStream_t st) {
  static bool smem_set = false;  // above 48 KB a block must ask, once
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_gemv_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(NG));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  int8_gemv_kernel<NG><<<(N + TILE_N - 1) / TILE_N, THREADS, smem_bytes(NG), st>>>(
      static_cast<const __nv_bfloat16 *>(x), static_cast<const int8_t *>(q),
      static_cast<const float *>(s), out, M, N, K, head);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes: out [M, N] (bf16, or f32 when
// `head`) = x [M, K] bf16 times q [N, K] int8 with scales s [N] f32, on
// `stream`. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int vnsum_int8_gemv(const void *x, const void *q, const void *s, void *out, int M,
                               int N, int K, int head, void *stream) {
  if (M < 1 || M > MAX_M || N < 1 || K < 16 || K % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (M + 7) / 8;
  if (groups <= 1) return launch<1>(x, q, s, out, M, N, K, head, st);
  if (groups <= 2) return launch<2>(x, q, s, out, M, N, K, head, st);
  if (groups <= 4) return launch<4>(x, q, s, out, M, N, K, head, st);
  if (groups <= 9) return launch<9>(x, q, s, out, M, N, K, head, st);
  return launch<16>(x, q, s, out, M, N, K, head, st);
}
