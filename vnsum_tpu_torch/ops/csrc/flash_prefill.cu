// Flash prefill attention over the stacked KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vnsum_tpu/ops/flash_attention.py
// (`_kernel`, reached through `flash_prefill_attention` and its
// `pl.pallas_call`). Same function: S prefill queries per row, sitting at
// cache slots [q_offset, q_offset+S), attend layer `layer` of the stacked
// cache [L, B, KV, C, hd] under the mask
//   pad_b <= k <= q   and   (window == 0 or k > q - window),
// with an online softmax. An int8 cache multiplies the scores by ks[k] and,
// after l has summed the unscaled p, multiplies p by vs[k] before the PV
// product. QK and PV run in bf16 with f32 accumulation, p is rounded to
// bf16 before PV, and a row that sees no key comes out as 0.
//
// What bounds it on this card: tensor-core operations. At the main path's
// shape (B=8, S=4096, H=24, hd=128) the causal work is ~8e11 FLOP against
// ~0.1 GB of q/out/cache bytes, far above the ~295 FLOP/byte ridge. Only
// wgmma reaches the full tensor-core rate, and it must be fed without the
// math warps stopping for copies.
//
// Design: one block of three warpgroups per (128 query rows, KV head,
// batch row). The 128 rows are (position, group head) pairs taken
// position-major, so one K/V tile in shared memory serves every query head
// of the GQA group. Warpgroup 0 is the producer (setmaxnreg lowers its
// registers): it keeps a ring of STAGES K/V tiles of BN = 128 slots full,
// each stage guarded by a full and an empty mbarrier. A bf16 cache arrives
// by TMA straight into the ring, each tile as two [BN, 64] boxes per
// tensor in the 128-byte swizzle that wgmma reads; TMA zero-fills slots
// past C. An int8 cache arrives by TMA into a staging buffer, which the
// producer widens to bf16 (exact for -127..127) into the swizzled stage,
// with ordinary loads of the f32 scales (their row stride, 4 C bytes, is no
// multiple of 16 at odd C, which TMA refuses), and a proxy fence before it
// marks the stage full. Warpgroups 1 and 2 (setmaxnreg raises theirs) own
// 64 rows each: Q sits in registers as wgmma's A operand, QK is wgmma
// m64n128k16 against the K tile (K-major), the softmax runs on the
// accumulator fragment in the log2 domain with ex2, and PV is wgmma
// m64n128k16 with P repacked from the accumulator into A registers and the
// V tile as an MN-major (transposed) operand. Only tiles that cross the
// diagonal, the left pad or the window floor are masked element by
// element; tiles above the diagonal, wholly below the window floor or
// wholly inside the pad are neither loaded nor computed (a warpgroup whose
// rows see none of a loaded tile only releases it). Blocks with the most
// tiles start first. Offsets into the cache are 64-bit: at the pipeline's
// defaults one K or V cache holds more than 2^31 elements; TMA addresses a
// layer through a tensor map over its [B*KV, C, hd] slab.
// Not done: a warpgroup overlapping one tile's softmax with the next
// tile's QK and the last tile's PV, and the two warpgroups taking turns to
// issue wgmma. A variant with both (and Q in shared memory, to stay clear
// of spills) ran a bf16 cache faster and an int8 cache, the main path's,
// no faster; what holds the int8 path back is not measured yet.
//
// head_dim 256 (Gemma3) takes a kernel of its own, flash_prefill_wide_kernel
// below: one consumer warpgroup of 64 rows over 64-slot tiles, with Q in
// shared memory; it says why.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <tuple>

namespace {

constexpr int HD = 128;                        // head_dim the kernel takes
constexpr int BM = 128;                        // query rows per block
constexpr int BN = 128;                        // cache slots per K/V tile
constexpr int STAGES = 2;                      // tiles in the ring
constexpr int NTHREADS = 3 * 128;              // producer + two consumer warpgroups
constexpr int HALF_BYTES = BN * 64 * 2;        // a [BN, 64] bf16 box, 128-byte rows
constexpr int TILE_BYTES = 2 * HALF_BYTES;     // a bf16 K or V tile
constexpr int STAGE_BYTES = 2 * TILE_BYTES;    // K then V
constexpr int I8_TILE_BYTES = BN * HD;         // an int8 K or V tile
constexpr int STAGING_BYTES = 2 * I8_TILE_BYTES;  // int8 K then V
// shared memory after the 1024-byte-aligned base: the ring, then (int8)
// two staging buffers, the scales of each stage and the barriers
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int SCALE_BYTES = STAGES * 2 * BN * 4;
constexpr int BAR_BYTES = 64;
constexpr int smem_bytes(bool q8) {
  return 1024 + RING_BYTES + (q8 ? 2 * STAGING_BYTES + SCALE_BYTES : 0) + BAR_BYTES;
}
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t *>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- mbarriers and TMA ---------------------------------------------------------

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

// waits for the completion of the barrier's phase of this parity. No
// timeout: a clock64 guard that trapped made the consumers spill and
// serialized their wgmma.
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

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap *map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the int8 K and V tiles of slots k0 .. k0 + BN - 1 into a staging buffer
__device__ __forceinline__ void stage_int8(uint32_t dst, const CUtensorMap *tm_k,
                                           const CUtensorMap *tm_v, uint32_t bar, int k0,
                                           int slab_row) {
  mbar_expect_tx(bar, STAGING_BYTES);
  tma_load(dst, tm_k, bar, 0, k0, slab_row);
  tma_load(dst + I8_TILE_BYTES, tm_v, bar, 0, k0, slab_row);
}

// the ring stage that holds the current tile, as a shared-memory address
template <int STAGE_BYTES_>
__device__ __forceinline__ uint32_t stage_addr(const unsigned char *ring, int stage) {
  return smem_u32(ring + stage * STAGE_BYTES_);
}

// generic-proxy shared-memory writes made visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma ---------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses to an accumulator across wgmma,
// or from reusing an A operand's registers while wgmma still reads them
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// d[64 x 128] = a[64 x 16] (bf16, registers) * b[16 x 128] (bf16, shared
// memory) + (accumulate ? d : 0); TRANS_B = 0: b stored K-major, 1: MN-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B),
        "r"(accumulate));
}

// d[64 x 64] = a[64 x 16] * b[16 x 64] + (accumulate ? d : 0), both bf16
// operands in shared memory, stored K-major
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// -- int8 widening -------------------------------------------------------------

// 4 int8 values (one word) -> 4 exact bf16 values (two words): each byte,
// offset to unsigned, lands in the mantissa of 2^23; subtracting 2^23 + 128
// leaves the integer, whose float has zero low 16 bits, so its bf16 is its
// high half
__device__ __forceinline__ void widen4(uint32_t w, uint32_t &lo, uint32_t &hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// one staged int8 tile [TN, HD_] -> the swizzled bf16 tile (HD_ / 64 boxes
// [TN, 64], chunk c8 of row s at ((c8 ^ (s & 7)) * 16)), TN HD_ / 2048
// chunks of 16 bytes per producer thread
template <int HD_, int TN>
__device__ __forceinline__ void widen_tile(const unsigned char *src, unsigned char *dst, int pt) {
#pragma unroll 2
  for (int j = 0; j < TN * HD_ / 16 / 128; ++j) {
    const int i = pt + j * 128;
    const int s = i / (HD_ / 16);  // slot in the tile
    const int c = i % (HD_ / 16);  // 16 int8 values: hd 16c .. 16c + 15
    const uint4 raw = *reinterpret_cast<const uint4 *>(src + i * 16);
    uint4 a, b;
    widen4(raw.x, a.x, a.y);
    widen4(raw.y, a.z, a.w);
    widen4(raw.z, b.x, b.y);
    widen4(raw.w, b.z, b.w);
    unsigned char *row = dst + (c >> 2) * (TN * 128) + s * 128;
    const int c8 = (c & 3) * 2;  // 8-value chunk of the box
    *reinterpret_cast<uint4 *>(row + ((c8 ^ (s & 7)) << 4)) = a;
    *reinterpret_cast<uint4 *>(row + (((c8 + 1) ^ (s & 7)) << 4)) = b;
  }
}

// -- the softmax on the score fragment ------------------------------------------

// Scales one tile's scores (this thread's 2 rows x TN / 4 columns of the
// accumulator of a TN-slot tile) into the log2 domain, masks them (MASKED
// tiles only), updates the running max and sum, and leaves in `sc` the
// probabilities that go into PV (times vs[k] for an int8 cache).
template <int TN, bool Q8, bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[TN / 2], float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2], const float *ksb, const float *vsb,
                                             float scale_log2, int k0, int tig,
                                             const int (&row_q)[2], const bool (&row_ok)[2],
                                             int pad, int window) {
  uint64_t live = 0;  // bit nt*4 + e: element passes the mask
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int nt = 0; nt < TN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int col = nt * 8 + tig * 2 + (e & 1);
      float s = sc[nt * 4 + e] * scale_log2;
      if (Q8) s *= ksb[col];
      if (MASKED) {
        const int slot = k0 + col;
        const bool ok = row_ok[i] && slot >= pad && slot <= row_q[i] &&
                        (window == 0 || slot > row_q[i] - window);
        s = ok ? s : NEG;
        live |= static_cast<uint64_t>(ok) << (nt * 4 + e);
      }
      sc[nt * 4 + e] = s;
      mx[i] = fmaxf(mx[i], s);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i]);
    corr[i] = ex2(m_run[i] - m_new);
    m_run[i] = m_new;
    l_run[i] *= corr[i];
  }
  // p = 2^(s - m); l sums the unscaled p, PV takes p * vs
#pragma unroll
  for (int nt = 0; nt < TN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float p = ex2(sc[nt * 4 + e] - m_run[i]);
      if (MASKED && !((live >> (nt * 4 + e)) & 1ull)) p = 0.f;
      l_run[i] += p;
      if (Q8) p *= vsb[nt * 8 + tig * 2 + (e & 1)];
      sc[nt * 4 + e] = p;
    }
  }
}

template <bool Q8>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_k,  // layer slab [B*KV, C, HD]
                     const __grid_constant__ CUtensorMap tm_v,
                     const __nv_bfloat16 *__restrict__ q,       // [B, S, H, HD]
                     const float *__restrict__ ks_all,          // [L, B, KV, C] (int8 only)
                     const float *__restrict__ vs_all,
                     const int *__restrict__ pad_lens,          // [B]
                     __nv_bfloat16 *__restrict__ out,           // [B, S, H, HD]
                     int B, int S, int H, int KV, int C, int layer, int window,
                     int q_offset, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 B
  const uint32_t raw_u32 = smem_u32(smem_raw);
  unsigned char *smem = smem_raw + (((raw_u32 + 1023) & ~1023u) - raw_u32);
  unsigned char *ring = smem;                                   // [STAGES][K | V]
  unsigned char *staging = ring + RING_BYTES;                   // int8: [2][K | V]
  float *scales = reinterpret_cast<float *>(staging + (Q8 ? 2 * STAGING_BYTES : 0));
  const uint32_t bars = smem_u32(staging + (Q8 ? 2 * STAGING_BYTES + SCALE_BYTES : 0));
  // full[s] at bars + 8 s, empty[s] at + 8 (STAGES + s), staged[j] at + 8 (2 STAGES + j)
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (STAGES + s); };
  auto staged_bar = [&](int j) { return bars + 8 * (2 * STAGES + j); };

  const int G = H / KV;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = S * G;
  // the last row tiles see the most slots: launch them first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int q_lo = q_offset + r0 / G;
  const int q_hi = q_offset + (min(r0 + BM, n_rows) - 1) / G;
  const int pad = pad_lens[b];
  int kt_lo = pad / BN;
  if (window > 0) kt_lo = max(kt_lo, max(q_lo - window + 1, 0) / BN);
  const int kt_hi = q_hi / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), Q8 ? 128 : 1);
      mbar_init(empty_bar(s), 8);  // one arrival per consumer warp
    }
    for (int j = 0; j < 2; ++j) mbar_init(staged_bar(j), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    if (Q8) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    }
    const int pt = threadIdx.x;
    const int slab_row = b * KV + kv;  // row of the layer's [B*KV, C, HD] slab
    if (!Q8) {
      if (pt == 0) {
        for (int kt = kt_lo, it = 0; kt <= kt_hi; ++kt, ++it) {
          const int stage = it % STAGES;
          mbar_wait(empty_bar(stage), ((it / STAGES) & 1) ^ 1);
          const uint32_t dst = smem_u32(ring + stage * STAGE_BYTES);
          const uint32_t bar = full_bar(stage);
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(dst, &tm_k, bar, 0, kt * BN, slab_row);
          tma_load(dst + HALF_BYTES, &tm_k, bar, 64, kt * BN, slab_row);
          tma_load(dst + TILE_BYTES, &tm_v, bar, 0, kt * BN, slab_row);
          tma_load(dst + TILE_BYTES + HALF_BYTES, &tm_v, bar, 64, kt * BN, slab_row);
        }
      }
    } else {
      // thread 0 keeps the next tile's int8 bytes in flight into the other
      // staging buffer while all 128 threads widen this one into the ring
      const size_t scale_base =
          ((static_cast<size_t>(layer) * B + b) * KV + kv) * static_cast<size_t>(C);
      if (pt == 0 && kt_lo <= kt_hi) {
        stage_int8(smem_u32(staging), &tm_k, &tm_v, staged_bar(0), kt_lo * BN, slab_row);
      }
      for (int kt = kt_lo, it = 0; kt <= kt_hi; ++kt, ++it) {
        const int stage = it % STAGES;
        const int j = it & 1;
        if (pt == 0 && kt < kt_hi) {
          stage_int8(smem_u32(staging + (j ^ 1) * STAGING_BYTES), &tm_k, &tm_v, staged_bar(j ^ 1),
                     (kt + 1) * BN, slab_row);
        }
        // thread pt loads slot pt's ks and vs
        const int slot = kt * BN + pt;
        const float kscale = slot < C ? ks_all[scale_base + slot] : 0.f;
        const float vscale = slot < C ? vs_all[scale_base + slot] : 0.f;
        mbar_wait(empty_bar(stage), ((it / STAGES) & 1) ^ 1);
        mbar_wait(staged_bar(j), (it >> 1) & 1);
        unsigned char *dst = ring + stage * STAGE_BYTES;
        const unsigned char *src = staging + j * STAGING_BYTES;
        widen_tile<HD, BN>(src, dst, pt);
        widen_tile<HD, BN>(src + I8_TILE_BYTES, dst + TILE_BYTES, pt);
        scales[stage * 2 * BN + pt] = kscale;
        scales[stage * 2 * BN + BN + pt] = vscale;
        fence_proxy_async();
        mbar_arrive(full_bar(stage));
        // every thread is done with staging[j] before TMA refills it
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    if (Q8) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    }
    const int ct = threadIdx.x - 128;
    const int wg = ct >> 7;
    const int warp = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int gid = lane >> 2;  // fragment row within the 8-row group
    const int tig = lane & 3;   // thread in group: fragment column pair

    // this warpgroup's 64 rows
    const int wr0 = r0 + wg * 64;
    const bool wg_rows = wr0 < n_rows;
    const bool wg_full = wr0 + 63 < n_rows;
    const int wq_lo = q_offset + min(wr0, n_rows - 1) / G;
    const int wq_hi = q_offset + min(wr0 + 63, n_rows - 1) / G;

    // this thread's two accumulator rows: gid and gid + 8 of its warp's 16
    int row_q[2];
    bool row_ok[2];
    size_t row_off[2];  // element offset of the row in q / out
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wr0 + warp * 16 + gid + 8 * i;
      row_ok[i] = r < n_rows;
      const int s = row_ok[i] ? r / G : 0;
      const int g = row_ok[i] ? r % G : 0;
      row_q[i] = q_offset + s;
      row_off[i] =
          ((static_cast<size_t>(b) * S + s) * H + static_cast<size_t>(kv) * G + g) * HD;
    }

    // Q as wgmma's A operand for the whole head_dim, held in registers
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j & 1;  // row gid (0) or gid + 8 (1)
        const int col = kk * 16 + tig * 2 + (j >> 1) * 8;
        qa[kk][j] = row_ok[i] ? *reinterpret_cast<const uint32_t *>(q + row_off[i] + col) : 0u;
      }
    }

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_run[2] = {NEG, NEG};
    float l_run[2] = {0.f, 0.f};  // partial over this thread's columns

    for (int kt = kt_lo, it = 0; kt <= kt_hi; ++kt, ++it) {
      const int k0 = kt * BN;
      const int stage = it % STAGES;
      mbar_wait(full_bar(stage), (it / STAGES) & 1);
      const bool active = wg_rows && k0 <= wq_hi && k0 + BN - 1 >= pad &&
                          (window == 0 || k0 + BN - 1 > wq_lo - window);
      if (active) {
        const uint32_t k_tile = stage_addr<STAGE_BYTES>(ring, stage);
        const uint32_t v_tile = k_tile + TILE_BYTES;
        const float *ksb = scales + stage * 2 * BN;
        const float *vsb = ksb + BN;

        // S = Q K^T: K tile K-major (slot rows of 128 B per 64-wide half),
        // 8-row groups 1024 B apart; k16 step kk at byte 32 (kk % 4) of half kk / 4
        float sc[64];
        fence_acc(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          wgmma_m64n128k16<0>(
              sc, qa[kk], smem_desc(k_tile + (kk >> 2) * HALF_BYTES + (kk & 3) * 32, 16, 1024),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(sc);

        const bool interior = wg_full && k0 >= pad && k0 + BN - 1 <= wq_lo &&
                              (window == 0 || k0 > wq_hi - window);
        float corr[2];
        if (interior) {
          softmax_tile<BN, Q8, false>(sc, m_run, l_run, corr, ksb, vsb, scale_log2, k0, tig, row_q,
                                  row_ok, pad, window);
        } else {
          softmax_tile<BN, Q8, true>(sc, m_run, l_run, corr, ksb, vsb, scale_log2, k0, tig, row_q,
                                 row_ok, pad, window);
        }
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          o[nt * 4 + 0] *= corr[0];
          o[nt * 4 + 1] *= corr[0];
          o[nt * 4 + 2] *= corr[1];
          o[nt * 4 + 3] *= corr[1];
        }
        // P as A registers: the accumulator's n8 blocks 2kk, 2kk + 1 are
        // the k16 step kk's fragment, rounded to bf16
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        // O += P V: V tile MN-major (hd contiguous), its two 64-wide halves
        // HALF_BYTES apart, 8-slot groups 1024 B apart; k16 step kk at
        // slot 16 kk
        fence_acc(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          wgmma_m64n128k16<1>(o, pa[kk], smem_desc(v_tile + kk * 16 * 128, HALF_BYTES, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(o);
        fence_a(pa);
      }
      // the stage goes back to the producer once every warp is done with it
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(stage));
    }

    // finalize: l over the row's four threads, then O / max(l, 1e-30)
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[i] = 1.f / fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int col = nt * 8 + tig * 2;
      if (row_ok[0]) {
        *reinterpret_cast<uint32_t *>(out + row_off[0] + col) =
            pack_bf16(o[nt * 4 + 0] * inv[0], o[nt * 4 + 1] * inv[0]);
      }
      if (row_ok[1]) {
        *reinterpret_cast<uint32_t *>(out + row_off[1] + col) =
            pack_bf16(o[nt * 4 + 2] * inv[1], o[nt * 4 + 3] * inv[1]);
      }
    }
  }
}

// -- head_dim 256 ----------------------------------------------------------------
//
// At head_dim 256 the tiling above does not fit: its ring alone would take
// 256 KB, and a consumer's O accumulator (64 x 256 f32, 128 registers a
// thread) beside Q held as A fragments (64 more) leaves no room for S and
// P. So a block here is two warpgroups, a producer and one consumer of
// BM = 64 rows, over tiles of BN = 64 slots: Q sits in shared memory (four
// [64, 64] boxes in the 128-byte swizzle) and QK is wgmma m64n64k16 with
// both operands in shared memory; PV is two wgmma m64n128k16 a k step, one
// per 128-dim half of O, with P from registers as above. The ring holds
// STAGES tiles of K and V, each four [BN, 64] boxes; an int8 cache is
// staged and widened by the producer exactly as above. Everything else (the
// row order, the tile skipping, the masks, the log2-domain softmax, p
// rounded to bf16 against the running max, zero output for a row that sees
// no key) is the kernel above's. Shared memory: 1024 alignment + Q 32 KB +
// ring 128 KB (+ int8 staging 64 KB + scales 1 KB) + barriers = 226 KB, one
// block a SM. No setmaxnreg: two warpgroups may hold 255 registers each.
struct Wide {
  static constexpr int HD = 256;
  static constexpr int BM = 64;                     // query rows per block
  static constexpr int BN = 64;                     // cache slots per K/V tile
  static constexpr int NTHREADS = 2 * 128;          // producer + one consumer warpgroup
  static constexpr int BOX_BYTES = BN * 128;        // a [BN, 64] bf16 box
  static constexpr int TILE_BYTES = 4 * BOX_BYTES;  // a bf16 K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int Q_BOX_BYTES = BM * 128;      // a [BM, 64] bf16 box of Q
  static constexpr int Q_BYTES = 4 * Q_BOX_BYTES;
  static constexpr int I8_TILE_BYTES = BN * HD;
  static constexpr int STAGING_BYTES = 2 * I8_TILE_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int SCALE_BYTES = STAGES * 2 * BN * 4;
  static constexpr int smem_bytes(bool q8) {
    return 1024 + Q_BYTES + RING_BYTES + (q8 ? 2 * STAGING_BYTES + SCALE_BYTES : 0) +
           BAR_BYTES;
  }
};
static_assert(Wide::smem_bytes(true) <= 232448, "head_dim 256 block over 227 KB");

template <bool Q8>
__global__ void __launch_bounds__(Wide::NTHREADS, 1)
flash_prefill_wide_kernel(const __grid_constant__ CUtensorMap tm_k,  // layer slab [B*KV, C, 256]
                          const __grid_constant__ CUtensorMap tm_v,
                          const __nv_bfloat16 *__restrict__ q,       // [B, S, H, 256]
                          const float *__restrict__ ks_all,          // [L, B, KV, C] (int8 only)
                          const float *__restrict__ vs_all,
                          const int *__restrict__ pad_lens,          // [B]
                          __nv_bfloat16 *__restrict__ out,           // [B, S, H, 256]
                          int B, int S, int H, int KV, int C, int layer, int window,
                          int q_offset, float scale_log2) {
  using W = Wide;
  constexpr int HD_ = W::HD, BM_ = W::BM, BN_ = W::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  unsigned char *smem = smem_raw + (((raw_u32 + 1023) & ~1023u) - raw_u32);
  unsigned char *q_s = smem;                                   // Q: four [BM, 64] boxes
  unsigned char *ring = q_s + W::Q_BYTES;                      // [STAGES][K | V]
  unsigned char *staging = ring + W::RING_BYTES;               // int8: [2][K | V]
  float *scales = reinterpret_cast<float *>(staging + (Q8 ? 2 * W::STAGING_BYTES : 0));
  const uint32_t bars = smem_u32(staging + (Q8 ? 2 * W::STAGING_BYTES + W::SCALE_BYTES : 0));
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (STAGES + s); };
  auto staged_bar = [&](int j) { return bars + 8 * (2 * STAGES + j); };

  const int G = H / KV;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = S * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM_;  // the most slots first
  const int q_lo = q_offset + r0 / G;
  const int q_hi = q_offset + (min(r0 + BM_, n_rows) - 1) / G;
  const int pad = pad_lens[b];
  int kt_lo = pad / BN_;
  if (window > 0) kt_lo = max(kt_lo, max(q_lo - window + 1, 0) / BN_);
  const int kt_hi = q_hi / BN_;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), Q8 ? 128 : 1);
      mbar_init(empty_bar(s), 4);  // one arrival per consumer warp
    }
    for (int j = 0; j < 2; ++j) mbar_init(staged_bar(j), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    const int pt = threadIdx.x;
    const int slab_row = b * KV + kv;
    if (!Q8) {
      if (pt == 0) {
        for (int kt = kt_lo, it = 0; kt <= kt_hi; ++kt, ++it) {
          const int stage = it % STAGES;
          mbar_wait(empty_bar(stage), ((it / STAGES) & 1) ^ 1);
          const uint32_t dst = smem_u32(ring + stage * W::STAGE_BYTES);
          const uint32_t bar = full_bar(stage);
          mbar_expect_tx(bar, W::STAGE_BYTES);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            tma_load(dst + c * W::BOX_BYTES, &tm_k, bar, 64 * c, kt * BN_, slab_row);
            tma_load(dst + W::TILE_BYTES + c * W::BOX_BYTES, &tm_v, bar, 64 * c, kt * BN_,
                     slab_row);
          }
        }
      }
    } else {
      const size_t scale_base =
          ((static_cast<size_t>(layer) * B + b) * KV + kv) * static_cast<size_t>(C);
      auto stage_tile = [&](int j, int kt) {
        const uint32_t dst = smem_u32(staging + j * W::STAGING_BYTES);
        mbar_expect_tx(staged_bar(j), W::STAGING_BYTES);
        tma_load(dst, &tm_k, staged_bar(j), 0, kt * BN_, slab_row);
        tma_load(dst + W::I8_TILE_BYTES, &tm_v, staged_bar(j), 0, kt * BN_, slab_row);
      };
      if (pt == 0 && kt_lo <= kt_hi) stage_tile(0, kt_lo);
      for (int kt = kt_lo, it = 0; kt <= kt_hi; ++kt, ++it) {
        const int stage = it % STAGES;
        const int j = it & 1;
        if (pt == 0 && kt < kt_hi) stage_tile(j ^ 1, kt + 1);
        // threads 0 .. BN - 1 load slot pt's ks and vs
        const int slot = kt * BN_ + pt;
        const float kscale = pt < BN_ && slot < C ? ks_all[scale_base + slot] : 0.f;
        const float vscale = pt < BN_ && slot < C ? vs_all[scale_base + slot] : 0.f;
        mbar_wait(empty_bar(stage), ((it / STAGES) & 1) ^ 1);
        mbar_wait(staged_bar(j), (it >> 1) & 1);
        unsigned char *dst = ring + stage * W::STAGE_BYTES;
        const unsigned char *src = staging + j * W::STAGING_BYTES;
        widen_tile<HD_, BN_>(src, dst, pt);
        widen_tile<HD_, BN_>(src + W::I8_TILE_BYTES, dst + W::TILE_BYTES, pt);
        if (pt < BN_) {
          scales[stage * 2 * BN_ + pt] = kscale;
          scales[stage * 2 * BN_ + BN_ + pt] = vscale;
        }
        fence_proxy_async();
        mbar_arrive(full_bar(stage));
        // every thread is done with staging[j] before TMA refills it
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
      }
    }
  } else {
    // ---- consumer warpgroup: BM = 64 rows ----
    const int ct = threadIdx.x - 128;
    const int warp = ct >> 5;
    const int lane = ct & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const bool rows_full = r0 + BM_ - 1 < n_rows;

    int row_q[2];
    bool row_ok[2];
    size_t row_off[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + warp * 16 + gid + 8 * i;
      row_ok[i] = r < n_rows;
      const int s = row_ok[i] ? r / G : 0;
      const int g = row_ok[i] ? r % G : 0;
      row_q[i] = q_offset + s;
      row_off[i] =
          ((static_cast<size_t>(b) * S + s) * H + static_cast<size_t>(kv) * G + g) * HD_;
    }

    // Q into shared memory in wgmma's swizzled K-major layout: chunk c (16
    // bytes, dims 8c .. 8c + 7) of row r in box c / 8 at row r, 16-byte
    // slot (c % 8) ^ (r % 8); rows past the last are zero
    for (int i = ct; i < BM_ * (HD_ / 8); i += 128) {
      const int r = i / (HD_ / 8), c = i % (HD_ / 8);
      const int rr = r0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (rr < n_rows) {
        v = *reinterpret_cast<const uint4 *>(
            q + ((static_cast<size_t>(b) * S + rr / G) * H + static_cast<size_t>(kv) * G +
                 rr % G) * HD_ + 8 * c);
      }
      *reinterpret_cast<uint4 *>(q_s + (c >> 3) * W::Q_BOX_BYTES + r * 128 +
                                 (((c & 7) ^ (r & 7)) << 4)) = v;
    }
    fence_proxy_async();
    asm volatile("bar.sync 2, 128;\n" ::: "memory");  // Q settled, for every consumer warp
    const uint32_t q_tile = smem_u32(q_s);

    float o[2][64];  // O's two 128-dim halves
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[h][i] = 0.f;
    }
    float m_run[2] = {NEG, NEG};
    float l_run[2] = {0.f, 0.f};

    for (int kt = kt_lo, it = 0; kt <= kt_hi; ++kt, ++it) {
      const int k0 = kt * BN_;
      const int stage = it % STAGES;
      mbar_wait(full_bar(stage), (it / STAGES) & 1);
      const bool active = k0 <= q_hi && k0 + BN_ - 1 >= pad &&
                          (window == 0 || k0 + BN_ - 1 > q_lo - window);
      if (active) {
        const uint32_t k_tile = stage_addr<W::STAGE_BYTES>(ring, stage);
        const uint32_t v_tile = k_tile + W::TILE_BYTES;
        const float *ksb = scales + stage * 2 * BN_;
        const float *vsb = ksb + BN_;

        // S = Q K^T: both K-major, k16 step kk at byte 32 (kk % 4) of box kk / 4
        float sc[32];
        fence_acc(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD_ / 16; ++kk) {
          wgmma_m64n64k16_ss(
              sc, smem_desc(q_tile + (kk >> 2) * W::Q_BOX_BYTES + (kk & 3) * 32, 16, 1024),
              smem_desc(k_tile + (kk >> 2) * W::BOX_BYTES + (kk & 3) * 32, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(sc);

        const bool interior = rows_full && k0 >= pad && k0 + BN_ - 1 <= q_lo &&
                              (window == 0 || k0 > q_hi - window);
        float corr[2];
        if (interior) {
          softmax_tile<BN_, Q8, false>(sc, m_run, l_run, corr, ksb, vsb, scale_log2, k0, tig,
                                       row_q, row_ok, pad, window);
        } else {
          softmax_tile<BN_, Q8, true>(sc, m_run, l_run, corr, ksb, vsb, scale_log2, k0, tig,
                                      row_q, row_ok, pad, window);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            o[h][nt * 4 + 0] *= corr[0];
            o[h][nt * 4 + 1] *= corr[0];
            o[h][nt * 4 + 2] *= corr[1];
            o[h][nt * 4 + 3] *= corr[1];
          }
        }
        uint32_t pa[BN_ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN_ / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        // O += P V: V MN-major, half h's two 64-wide boxes BOX_BYTES apart,
        // 8-slot groups 1024 B apart; k16 step kk at slot 16 kk
        fence_acc(o[0]);
        fence_acc(o[1]);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int kk = 0; kk < BN_ / 16; ++kk) {
            wgmma_m64n128k16<1>(
                o[h], pa[kk],
                smem_desc(v_tile + 2 * h * W::BOX_BYTES + kk * 16 * 128, W::BOX_BYTES, 1024), 1);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(o[0]);
        fence_acc(o[1]);
        fence_a(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(stage));
    }

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[i] = 1.f / fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int col = 128 * h + nt * 8 + tig * 2;
        if (row_ok[0]) {
          *reinterpret_cast<uint32_t *>(out + row_off[0] + col) =
              pack_bf16(o[h][nt * 4 + 0] * inv[0], o[h][nt * 4 + 1] * inv[0]);
        }
        if (row_ok[1]) {
          *reinterpret_cast<uint32_t *>(out + row_off[1] + col) =
              pack_bf16(o[h][nt * 4 + 2] * inv[1], o[h][nt * 4 + 3] * inv[1]);
        }
      }
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

// The map of one layer's [B*KV, C, hd] slab of a K or V cache: bf16 in
// [64, bn, 1] boxes with the 128-byte swizzle, int8 in [hd, bn, 1] boxes
// unswizzled (the producer widens those). Slots past C read as zeros.
// Cached by (slab pointer, rows, C, dtype, hd).
cudaError_t slab_map(CUtensorMap *map, const void *slab, int rows, int C, bool q8, int hd,
                     int bn) {
  static std::map<std::tuple<const void *, int, int, bool, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(slab, rows, C, q8, hd);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return cudaSuccess;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elem = q8 ? 1 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {hd * elem, static_cast<cuuint64_t>(C) * hd * elem};
  const cuuint32_t box[3] = {q8 ? static_cast<cuuint32_t>(hd) : 64u,
                             static_cast<cuuint32_t>(bn), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(
      map, q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void *>(slab), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      q8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// WIDE: the head_dim-256 kernel
template <bool WIDE, bool Q8>
cudaError_t launch(dim3 grid, cudaStream_t st, const CUtensorMap &tm_k, const CUtensorMap &tm_v,
                   const __nv_bfloat16 *q, const float *ks, const float *vs, const int *pads,
                   __nv_bfloat16 *out, int B, int S, int H, int KV, int C, int layer,
                   int window, int q_offset, float scale_log2) {
  const auto kernel = WIDE ? flash_prefill_wide_kernel<Q8> : flash_prefill_kernel<Q8>;
  const int threads = WIDE ? Wide::NTHREADS : NTHREADS;
  const int smem = WIDE ? Wide::smem_bytes(Q8) : smem_bytes(Q8);
  static bool configured = false;  // the shared-memory opt-in, once per process
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<grid, threads, smem, st>>>(tm_k, tm_v, q, ks, vs, pads, out, B, S, H, KV, C, layer,
                                      window, q_offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes: head_dim 128 or 256. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int vnsum_flash_prefill(const void *q, const void *k, const void *v,
                                   const void *ks, const void *vs, const void *pad_lens,
                                   void *out, int B, int S, int H, int KV, int C, int head_dim,
                                   int layer, int window, int q_offset, int quantized,
                                   float scale, void *stream) {
  if ((head_dim != HD && head_dim != Wide::HD) || KV <= 0 || H % KV != 0 || S <= 0 || B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = head_dim == Wide::HD;
  const int G = H / KV;
  const int bm = wide ? Wide::BM : BM;
  const int bn = wide ? Wide::BN : BN;
  const dim3 grid((S * G + bm - 1) / bm, KV, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16 *qb = static_cast<const __nv_bfloat16 *>(q);
  __nv_bfloat16 *ob = static_cast<__nv_bfloat16 *>(out);
  const int *pads = static_cast<const int *>(pad_lens);
  const float scale_log2 = scale * LOG2E;
  // the layer's slab of each cache: B*KV rows of C slots
  const size_t slab_bytes =
      static_cast<size_t>(B) * KV * C * head_dim * (quantized ? 1 : 2);
  const size_t offset = static_cast<size_t>(layer) * slab_bytes;
  CUtensorMap tm_k, tm_v;
  cudaError_t err = slab_map(&tm_k, static_cast<const char *>(k) + offset, B * KV, C,
                             quantized != 0, head_dim, bn);
  if (err == cudaSuccess) {
    err = slab_map(&tm_v, static_cast<const char *>(v) + offset, B * KV, C, quantized != 0,
                   head_dim, bn);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const float *ksf = quantized ? static_cast<const float *>(ks) : nullptr;
  const float *vsf = quantized ? static_cast<const float *>(vs) : nullptr;
#define VNSUM_PREFILL_LAUNCH(WIDE_, Q8_)                                                     \
  launch<WIDE_, Q8_>(grid, st, tm_k, tm_v, qb, ksf, vsf, pads, ob, B, S, H, KV, C, layer, \
                     window, q_offset, scale_log2)
  if (wide) {
    err = quantized ? VNSUM_PREFILL_LAUNCH(true, true) : VNSUM_PREFILL_LAUNCH(true, false);
  } else {
    err = quantized ? VNSUM_PREFILL_LAUNCH(false, true) : VNSUM_PREFILL_LAUNCH(false, false);
  }
#undef VNSUM_PREFILL_LAUNCH
  return static_cast<int>(err);
}

// Dynamic shared memory of a launch at head_dim 128 or 256, in bytes
// (quantized: int8 cache).
extern "C" int vnsum_flash_prefill_smem(int quantized, int head_dim) {
  return head_dim == Wide::HD ? Wide::smem_bytes(quantized != 0) : smem_bytes(quantized != 0);
}
