// Int8-weight GEMV for small M, for Hopper (sm_90a): one launch for one
// weight, or for up to three weights that share their input (q/k/v,
// gate/up).
//
// No Pallas kernel of the JAX package computes this: there it is XLA's
// fusion inside `_proj` (vnsum_tpu/models/llama.py:257-291) and the int8 arm
// of `_lm_head_logits` (:302-313), where the int8-to-bf16 convert folds
// into the matmul's tile loads so device memory sees int8. This kernel is
// that product for the forwards with few rows: decode (M = B <= 8), the
// spec verify forward (M = B * (k + 1) = 72), the slot segment, the long
// decode and the LM head of a last_only prefill. Inputs:
//   x [M, K] bf16, contiguous, 1 <= M <= MAX_M (128), K a multiple of 16;
//   one to three members, each q [N, K] int8 in the stored layout of
//     models/quant.py (output channel major, the contraction contiguous),
//     s [N] f32 (the per-channel scales) and out [M, N].
// Per output it computes sum_k f32(x[m,k]) * f32(q[n,k]) (each product is
// exact in f32), then
//   projection mode: out[m,n] = bf16(f32(bf16(sum)) * s[n])  (bf16 out);
//   head mode:       out[m,n] = sum * s[n]                    (f32 out).
//
// What bounds it on this card: device-memory bytes. Every weight byte is
// read once a call: at Llama-3.2-3B's shapes a decode step reads 3.21 GB of
// int8 weights plus their scales, ~0.96 ms at 3.35 TB/s, against ~0.05 ms
// of bf16 tensor-core work at M = 8. A launch of a few megabytes is short
// (3-15 us), so what it pays besides its bytes, its start, its first
// round trip to memory and its end, counts as much as its streaming rate.
//
// Design:
// - One launch for a shared input. q/k/v and gate/up take one launch
//   each: the members' tiles lie one after another in one grid, and a
//   block finds its member from its tile. 113 launches a decode step in
//   place of 197, each large enough to fill the card.
// - Bytes in flight through TMA, not registers. A block owns TILE_N = 64
//   output channels. Thread 0 copies each chunk of CHUNK = 256 bytes of K
//   as two 2-D tensor-map boxes, [64, 256] of q and [M rounded up to 8,
//   256] of x, into a ring of STAGES stages in shared memory (three, 60
//   KB, at M <= 8: three blocks an SM), each stage guarded by a full and
//   an empty mbarrier; TMA fills rows past N or M
//   and k past K with zeros. The first stages leave before the block
//   meets at its first barrier. x reaches each block once a chunk, shared
//   by its warps. A consumer warp fences its reads of a stage
//   (fence.proxy.async) before it releases the stage: they go through the
//   generic proxy, TMA's next write into the stage through the async one,
//   and without the fence that write raced the reads (wrong sums on an
//   H100 in some cases of every run).
// - Eight consumer warps read their fragments from the stage: warp 1 + cw
//   takes the m16 tile cw % 4 and the 64-byte slabs cw / 4 and cw / 4 + 2
//   of the chunk. In a slab, lane (g, t) reads the 16 bytes at 16 t of
//   rows g and g + 8; mma step j takes bytes 4j..4j+3 of each lane's 16
//   as that lane's four k columns, and x's B operand the same 16 k of row
//   G * 8 + g, so a lane's own bytes feed its fragments. int8 widens to
//   bf16 exactly through an f32 magic number, and mma.sync m16n8k16 sums
//   in f32. M above 8 loops over groups of 8 rows on the same A
//   fragments, so q is still read once.
// - K split across a thread block cluster, at M <= 8. The host picks the
//   cluster size (ops/int8_matmul.py `gemv_plan`): the smallest power of
//   two up to 8 that puts a block on half the SMs (wo and w_down: 2;
//   q/k/v, gate/up and the head: 1). The blocks of a cluster take the same
//   64 channels and disjoint runs of chunks; each peer sends its block sum
//   into rank 0's shared memory with st.async, which completes on a
//   barrier there, and leaves; rank 0 adds them and writes the outputs.
//   (Ranks that met at two cluster-wide barriers and summed over
//   distributed shared memory paid more a launch; clusters at M = 72,
//   whose blocks need an SM each, ran slower than none.)
// Partial sums meet in a fixed order and never through float atomics:
// each warp's sum is its slabs' mma steps in chunk order; in a block the
// two warps of a tile are added (warp 1 + cw % 4, then 5 + cw % 4); rank 0
// adds the ranks' block sums in rank order. Two runs give the same bits.
// The kernel runs on the caller's stream, synchronises nothing and
// allocates nothing, so it runs inside a captured CUDA graph (its tensor
// maps are made on the host and cached by pointer and shape).
// Against a kernel that keeps its loads in registers, 16 channels a block
// and no cluster, with the same grouping (PERF.md): a few percent slower
// at M = 8, where a small launch pays for its TMA start and its cluster,
// and faster over a verify forward's launches at M = 72, where x
// outweighs q and this kernel reads it once a block, not once a warp.
// One 1-D bulk copy per 256-byte row in place of the boxes was far slower
// (TMA pays per copy).
// Not done: wgmma (the tensor cores are idle most of the time at M = 8);
// programmatic dependent launch (the kernels before a GEMV in a decode
// step are PyTorch's, which never signal their dependents early); an L2
// evict-first hint on the weights; clusters at M > 8.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int CONSUMERS = 8;                 // consumer warps
constexpr int THREADS = (CONSUMERS + 1) * 32;  // and one producer warp
constexpr int TILE_N = 64;     // output channels of a block: four m16 tiles
constexpr int CHUNK = 256;     // K bytes of a stage
constexpr int SLAB = 64;       // K bytes of a warp's step: 4 lanes x 16 bytes
constexpr int Q_ROW = CHUNK;       // a channel's row in a stage
constexpr int X_ROW = 2 * CHUNK;   // an x row in a stage (bf16)
constexpr int MAX_M = 128;
constexpr int MAX_CLUSTER = 8;

// a stage: the [TILE_N, CHUNK] box of q, then the [ng * 8, CHUNK] box of x
__host__ __device__ constexpr int stage_bytes(int ng) { return TILE_N * Q_ROW + ng * 8 * X_ROW; }
__host__ __device__ constexpr int stages(int ng) {
  return ng == 1 ? 3 : ng == 2 ? 4 : ng <= 9 ? 3 : 2;
}
// with one group of rows (M <= 8) a launch may split K across a cluster:
// rank 0 receives its peers' block sums, [TILE_N, 8] f32 each
constexpr int PEER_BYTES = TILE_N * 8 * 4;
__host__ __device__ constexpr int recv_bytes(int ng) {
  return ng == 1 ? (MAX_CLUSTER - 1) * PEER_BYTES : 0;
}
// the ring after a 128-byte-aligned base, then the peers' sums, then the
// barriers: full and empty a stage, and the peers' sums' arrival
constexpr int smem_bytes(int ng) {
  return 128 + stages(ng) * stage_bytes(ng) + recv_bytes(ng) + 8 * (2 * stages(ng) + 1);
}
// the warps' partial sums [CONSUMERS][16][ng * 8] f32 reuse the ring
constexpr int red_bytes(int ng) { return CONSUMERS * 16 * ng * 8 * 4; }
static_assert(smem_bytes(16) <= 232448 && red_bytes(16) <= stages(16) * stage_bytes(16), "");
static_assert(smem_bytes(9) <= 232448, "");
static_assert(3 * (smem_bytes(1) + 1024) <= 233472, "three blocks an SM at M <= 8");
static_assert(2 * (smem_bytes(4) + 1024) <= 233472, "two blocks an SM up to 32 rows");

struct Member {
  const float *s;
  void *out;
  int N;
  int tiles;  // ceil(N / TILE_N)
};

struct Group {
  Member m[3];
};

// the members' q [N, K] in [TILE_N, CHUNK] boxes and x [M, K] in
// [ng * 8, CHUNK] boxes; TMA fills the rows past N or M and the k past K
// with zeros
struct Maps {
  CUtensorMap q[3];
  CUtensorMap x;
};

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and bulk copies ----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// -- the thread block cluster ---------------------------------------------------

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// this CTA's shared address `a` in the shared memory of cluster rank `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// 16 bytes into another CTA's shared memory, completing on its barrier
__device__ __forceinline__ void st_async(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// one box of a 2-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap *map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// -- arithmetic ---------------------------------------------------------------------

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

// NG groups of 8 rows of x. Block b is rank b % cluster of the cluster
// that owns tile b / cluster of the members' tiles laid end to end.
template <int NG>
__global__ void __launch_bounds__(THREADS, NG == 1 ? 3 : NG <= 4 ? 2 : 1)
    int8_gemv_kernel(const __grid_constant__ Maps maps, const Group grp, int M, int K,
                     int head) {
  constexpr int MP = NG * 8;
  constexpr int STAGES = stages(NG);
  constexpr int STAGE = stage_bytes(NG);
  extern __shared__ uint8_t smem[];
  uint8_t *ring = reinterpret_cast<uint8_t *>(
      (reinterpret_cast<uintptr_t>(smem) + 127) & ~static_cast<uintptr_t>(127));
  float *red = reinterpret_cast<float *>(ring);
  float *recv = reinterpret_cast<float *>(ring + STAGES * STAGE);
  uint64_t *bars = reinterpret_cast<uint64_t *>(ring + STAGES * STAGE + recv_bytes(NG));
  const auto full_bar = [&](int i) { return smem_u32(bars + i); };
  const auto empty_bar = [&](int i) { return smem_u32(bars + STAGES + i); };
  const uint32_t recv_bar = smem_u32(bars + 2 * STAGES);

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());  // 1 unless NG == 1
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // this block's member and its channels n0 .. n0 + rows - 1
  int tile = blockIdx.x / csize;
  int j = 0;
  Member mb = grp.m[0];
  if (tile >= mb.tiles) {
    tile -= mb.tiles;
    mb = grp.m[1];
    j = 1;
    if (tile >= mb.tiles) {
      tile -= mb.tiles;
      mb = grp.m[2];
      j = 2;
    }
  }
  const int N = mb.N;
  const int n0 = tile * TILE_N;
  const int rows = min(TILE_N, N - n0);
  // this rank's chunks of K
  const int n_chunks = (K + CHUNK - 1) / CHUNK;
  const int c_lo = n_chunks * rank / csize;
  const int c_n = n_chunks * (rank + 1) / csize - c_lo;

  // chunk i's box of q and of x into stage i % STAGES
  const auto produce = [&](int i) {
    const int slot = i % STAGES;
    const int k0 = (c_lo + i) * CHUNK;
    const uint32_t dst = smem_u32(ring + slot * STAGE);
    mbar_expect_tx(full_bar(slot), STAGE);  // whole boxes, zero-filled past the edges
    tma_load(dst, &maps.q[j], full_bar(slot), k0, n0);
    tma_load(dst + TILE_N * Q_ROW, &maps.x, full_bar(slot), k0, 0);
  };

  if (threadIdx.x == 0) {
    // the maps' descriptors on their way before the first copy needs them
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.q[j]))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.x))
                 : "memory");
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full_bar(i), 1);
      mbar_init(empty_bar(i), CONSUMERS);  // one arrival per consumer warp
    }
    mbar_init(recv_bar, 1);
    // rank 0 expects every peer's block sum
    if (rank == 0 && csize > 1) mbar_expect_tx(recv_bar, (csize - 1) * PEER_BYTES);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the ring's first stages, free from the start, on their way before
    // the block meets
    for (int i = 0; i < min(c_n, STAGES); ++i) produce(i);
  }
  __syncthreads();
  // the peers may signal rank 0's barrier once it is initialised: they
  // wait for this arrival after their main loop, long after it happened
  if (csize > 1) cluster_arrive_relaxed();

  float acc[NG][4];
#pragma unroll
  for (int G = 0; G < NG; ++G) acc[G][0] = acc[G][1] = acc[G][2] = acc[G][3] = 0.f;

  if (warp == 0) {
    // ---- producer (thread 0): the rest of the chunks, each into its
    // stage once the consumers have released it ----
    if (lane == 0) {
      for (int i = STAGES; i < c_n; ++i) {
        mbar_wait(empty_bar(i % STAGES), ((i / STAGES) & 1) ^ 1);
        produce(i);
      }
    }
  } else {
    // ---- consumers: warp w = 1 + cw, m16 tile cw % 4, slabs cw / 4 and
    // cw / 4 + 2 ----
    const int cw = warp - 1;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int mt = cw & 3;
    for (int i = 0; i < c_n; ++i) {
      const int stage = i % STAGES;
      mbar_wait(full_bar(stage), (i / STAGES) & 1);
      const uint8_t *buf = ring + stage * STAGE;
      const uint8_t *xs = buf + TILE_N * Q_ROW;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        // this lane's 16 bytes of the slab; TMA wrote zeros past K
        const int kl = ((cw >> 2) + 2 * u) * SLAB + 16 * t;
        const uint8_t *qp = buf + (mt * 16 + g) * Q_ROW + kl;
        const uint4 w0 = *reinterpret_cast<const uint4 *>(qp);
        const uint4 w1 = *reinterpret_cast<const uint4 *>(qp + 8 * Q_ROW);
        // A fragments of the slab's four k16 steps: step j is bytes
        // 4j..4j+3 of this lane's chunk, of rows g (a0, a2) and g + 8 (a1, a3)
        uint32_t a[4][4];
        widen_int8x4(w0.x, a[0][0], a[0][2]);
        widen_int8x4(w1.x, a[0][1], a[0][3]);
        widen_int8x4(w0.y, a[1][0], a[1][2]);
        widen_int8x4(w1.y, a[1][1], a[1][3]);
        widen_int8x4(w0.z, a[2][0], a[2][2]);
        widen_int8x4(w1.z, a[2][1], a[2][3]);
        widen_int8x4(w0.w, a[3][0], a[3][2]);
        widen_int8x4(w1.w, a[3][1], a[3][3]);
#pragma unroll
        for (int G = 0; G < NG; ++G) {
          // B fragments: the same 16 k of x row G * 8 + g (zeros past M),
          // bf16 pairs in order, so step j takes words 2j and 2j + 1
          const uint4 *xp = reinterpret_cast<const uint4 *>(xs + (G * 8 + g) * X_ROW + 2 * kl);
          const uint4 xa = xp[0], xb = xp[1];
          mma_bf16(acc[G], a[0], xa.x, xa.y);
          mma_bf16(acc[G], a[1], xa.z, xa.w);
          mma_bf16(acc[G], a[2], xb.x, xb.y);
          mma_bf16(acc[G], a[3], xb.z, xb.w);
        }
      }
      // this warp's reads of the stage (generic proxy) before TMA's next
      // write into it (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(stage));
    }
  }

  // the ring is drained (every consumer waited for every stage): the warps'
  // partial sums go into it. Accumulator (row g / g + 8, columns 2t,
  // 2t + 1) of group G is (channel g / g + 8 of the warp's m16 tile, rows
  // G * 8 + 2t, + 1 of x)
  __syncthreads();
  if (warp > 0) {
    const int g = lane >> 2;
    const int t = lane & 3;
    float *mine = red + (warp - 1) * 16 * MP;
#pragma unroll
    for (int G = 0; G < NG; ++G) {
      const int m = G * 8 + 2 * t;
      mine[g * MP + m] = acc[G][0];
      mine[g * MP + m + 1] = acc[G][1];
      mine[(g + 8) * MP + m] = acc[G][2];
      mine[(g + 8) * MP + m + 1] = acc[G][3];
    }
  }
  __syncthreads();

  // the block sum of output (channel nl, row m): warp nl / 16 + 1, then
  // warp nl / 16 + 5 (the tile's two warps, in warp order)
  const auto block_sum = [&](int nl, int m) {
    const int o = ((nl >> 4) * 16 + (nl & 15)) * MP + m;
    return red[o] + red[o + 4 * 16 * MP];
  };
  if (csize > 1) {
    cluster_wait();  // rank 0's barrier is initialised
    if (rank > 0) {
      // a peer sends its block sums, [TILE_N, 8], into rank 0's slot
      // rank - 1 and leaves
      const uint32_t dst = map_rank(smem_u32(recv + (rank - 1) * TILE_N * 8), 0);
      const uint32_t bar = map_rank(recv_bar, 0);
      for (int i = threadIdx.x; i < TILE_N * 2; i += THREADS) {
        const int nl = i >> 1;
        const int m = (i & 1) * 4;
        st_async(dst + 16 * i, make_float4(block_sum(nl, m), block_sum(nl, m + 1),
                                           block_sum(nl, m + 2), block_sum(nl, m + 3)),
                 bar);
      }
      return;
    }
    mbar_wait(recv_bar, 0);  // every peer's block sums are here
  }

  // rank 0: the ranks' block sums added in rank order, then the epilogue
  for (int i = threadIdx.x; i < TILE_N * M; i += THREADS) {
    const int nl = i % TILE_N;
    const int m = i / TILE_N;
    if (nl >= rows) continue;
    float sum = block_sum(nl, m);
    for (int c = 1; c < csize; ++c) sum += recv[(c - 1) * TILE_N * 8 + nl * 8 + m];
    const int n = n0 + nl;
    const float sc = mb.s[n];
    const size_t o = static_cast<size_t>(m) * N + n;
    if (head) {
      static_cast<float *>(mb.out)[o] = sum * sc;
    } else {
      const float y = __bfloat162float(__float2bfloat16_rn(sum));
      static_cast<__nv_bfloat16 *>(mb.out)[o] = __float2bfloat16_rn(y * sc);
    }
  }
}

// -- tensor maps ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap *, CUtensorMapDataType, cuuint32_t, void *,
                                const cuuint64_t *, const cuuint64_t *, const cuuint32_t *,
                                const cuuint32_t *, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void *p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The map of a row-major [rows, K] matrix (int8 q, or bf16 x) in boxes of
// [box_rows, CHUNK] elements, unswizzled. Cached by (pointer, rows, K,
// box rows, dtype): the weights' maps are made once.
cudaError_t matrix_map(CUtensorMap *map, const void *p, int rows, int K, int box_rows, bool bf16) {
  static std::map<std::tuple<const void *, int, int, int, bool>, CUtensorMap> cache;
  const auto key = std::make_tuple(p, rows, K, box_rows, bf16);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return cudaSuccess;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * (bf16 ? 2 : 1)};
  const cuuint32_t box[2] = {CHUNK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
      const_cast<void *>(p), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

template <int NG>
int launch(const Maps &maps, const Group &grp, int tiles, int cluster, int M, int K, int head,
           cudaStream_t st) {
  static bool smem_set = false;  // above 48 KB a block must ask, once
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_gemv_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(NG));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(NG);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_gemv_kernel<NG>, maps, grp, M, K, head);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes: for each of the `count` (1-3)
// members j, out_j [M, N_j] (bf16, or f32 when `head`) = x [M, K] bf16
// times q_j [N_j, K] int8 with scales s_j [N_j] f32, in one launch of
// `cluster` (1-8) blocks per 64 channels, on `stream`. Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int vnsum_int8_gemv_group(const void *x, const void *q0, const void *s0, void *out0,
                                     int n0, const void *q1, const void *s1, void *out1, int n1,
                                     const void *q2, const void *s2, void *out2, int n2,
                                     int count, int M, int K, int head, int cluster,
                                     void *stream) {
  const int ns[3] = {n0, n1, n2};
  if (M < 1 || M > MAX_M || K < 16 || K % 16 != 0 || count < 1 || count > 3 || cluster < 1 ||
      cluster > MAX_CLUSTER || cluster > (K + CHUNK - 1) / CHUNK || (M > 8 && cluster > 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (M + 7) / 8;
  const int box_rows = 8 * (groups <= 2 ? groups : groups <= 4 ? 4 : groups <= 9 ? 9 : 16);
  Group grp = {};
  Maps maps;
  const void *qs[3] = {q0, q1, q2};
  const void *ss[3] = {s0, s1, s2};
  void *outs[3] = {out0, out1, out2};
  int tiles = 0;
  for (int j = 0; j < 3; ++j) {
    if (j < count && ns[j] < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int n = j < count ? ns[j] : 0;
    grp.m[j] = {static_cast<const float *>(ss[j]), outs[j], n, (n + TILE_N - 1) / TILE_N};
    tiles += grp.m[j].tiles;
    // a missing member's map repeats the first's; no block reads it
    const cudaError_t err = matrix_map(&maps.q[j], qs[j < count ? j : 0],
                                       j < count ? n : ns[0], K, TILE_N, false);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err = matrix_map(&maps.x, x, M, K, box_rows, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups <= 1) return launch<1>(maps, grp, tiles, cluster, M, K, head, st);
  if (groups <= 2) return launch<2>(maps, grp, tiles, cluster, M, K, head, st);
  if (groups <= 4) return launch<4>(maps, grp, tiles, cluster, M, K, head, st);
  if (groups <= 9) return launch<9>(maps, grp, tiles, cluster, M, K, head, st);
  return launch<16>(maps, grp, tiles, cluster, M, K, head, st);
}
