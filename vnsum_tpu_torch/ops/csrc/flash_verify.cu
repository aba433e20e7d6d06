// Multi-position ("verify") decode attention over the stacked KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vnsum_tpu/ops/decode_attention.py
// (`_verify_kernel`, reached through `flash_spec_verify_attention`). Same
// function: each batch row carries Sq query positions at its OWN cache
// offset fills_b, and query (b, s) attends layer `layer` of the stacked
// cache [L, B, KV, C, hd] under the mask
//   pad_b <= k <= fills_b + s   and   (window == 0 or k > fills_b + s - window).
// All arithmetic is f32. An int8 cache multiplies the scores by ks[k] and,
// after l has summed the unscaled p, multiplies p by vs[k] before PV. A
// (row, query) that sees no key comes out as 0. The speculative verify step
// calls it with Sq = spec_k + 1, the in-flight slot segment with Sq = 1.
//
// What bounds it on this card: a call reads each visible K and V slot once
// for all R = Sq * G query rows of its (row, KV head) and does 4 R FLOP
// per head dim of a slot, in f32: 2 R FLOP per byte of an int8 cache. The
// f32 ridge is ~20 FLOP per byte (67 TFLOP/s over 3.35 TB/s), so the slot
// segment (Sq = 1, R = 3: 6 FLOP/byte) is bound by device-memory bytes and
// the spec verify step (Sq = 9, R = 27: 54 FLOP/byte) by f32 operations.
//
// Design: K2's split-cache structure, generalised to R = Sq * G query rows
// per block and to per-row fills. Pass 1: one block of 8 warps per (cache
// split of SPLIT slots, KV head, batch row). The split count comes from C,
// not from the fills, which live on the device: reading them on the host
// would synchronise every layer. A split that lies wholly past its row's
// last limit fills_b + Sq - 1 (clamped to C - 1), or wholly below the
// window floor of its first query, loads nothing and writes an inert
// partial (m = -1e30, l = 0, o = 0). Otherwise the block stages each
// BK-slot K and V tile in shared memory with 16-byte loads, once for all R
// rows; scores go to shared memory (thread = slot x quarter of the rows),
// a warp per row runs the online softmax over the tile with shuffles (no
// block-wide barrier per row), and PV runs with each thread owning one head
// dim for half of the rows. Pass 2 merges a (row, KV head)'s splits with
// the log-sum-exp algebra and divides by max(l, 1e-30). No slot at or past
// C is ever read. Offsets into the cache are 64-bit: the stacked cache
// passes 2^31 elements at the pipeline's long bucket.
// Not yet done: cp.async/TMA pipelining, tensor cores for large Sq * G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;          // head_dim the kernel takes
constexpr int BK = 64;           // cache slots per K/V tile
constexpr int SPLIT = 512;       // cache slots per pass-1 block
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;          // largest GQA group the kernel takes
constexpr int MAXR = 64;         // largest Sq * G the kernel takes
constexpr int SCORE_GROUPS = NTHREADS / BK;           // 4 row groups score a tile
constexpr int PV_GROUPS = NTHREADS / HD;              // 2 row groups in PV
constexpr float NEG = -1e30f;

// Per-thread row counts for a block of at most RCAP = 8, 32 or 64 query
// rows: the launch picks the smallest RCAP >= Sq * G, so the slot segment's
// 3 rows do not walk the loops (and registers) of 64.
template <int RCAP>
struct Rows {
  static constexpr int SCORE = RCAP / SCORE_GROUPS;           // rows per scoring thread
  static constexpr int SOFTMAX = RCAP >= NWARPS ? RCAP / NWARPS : 1;  // rows per warp
  static constexpr int PV = RCAP / PV_GROUPS;                 // rows per PV thread
};

template <bool Q8>
struct Tile {
  static constexpr int WORDS_PER_ROW = Q8 ? HD / 4 : HD / 2;  // one cache slot
  // K rows padded by one 32-bit word: thread j reads row j, conflict-free
  static constexpr int KROW = WORDS_PER_ROW + 1;
  static constexpr int VROW = WORDS_PER_ROW;  // V rows are read across threads
  static constexpr int KBYTES = BK * KROW * 4;
  static constexpr int VBYTES = BK * VROW * 4;
  // dynamic shared memory: K tile, V tile, ks/vs of the tile, then the R
  // query rows (f32), the R x BK scores / probabilities and R corrections
  static constexpr int FIXED = KBYTES + VBYTES + 2 * BK * 4;
  static int smem(int R) { return FIXED + R * HD * 4 + R * BK * 4 + R * 4; }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

template <bool Q8, int RCAP>
__global__ void __launch_bounds__(NTHREADS)
flash_verify_split_kernel(const __nv_bfloat16 *__restrict__ q,  // [B, Sq, H, HD]
                          const void *__restrict__ k_all,       // [L, B, KV, C, HD]
                          const void *__restrict__ v_all,
                          const float *__restrict__ ks_all,     // [L, B, KV, C] (int8 only)
                          const float *__restrict__ vs_all,
                          const int *__restrict__ pad_lens,     // [B]
                          const int *__restrict__ fills,        // [B]
                          float *__restrict__ o_part,           // [B, KV, NS, R, HD]
                          float *__restrict__ m_part,           // [B, KV, NS, R]
                          float *__restrict__ l_part,
                          int B, int Sq, int H, int KV, int C, int layer, int window,
                          float scale) {
  using T = Tile<Q8>;
  constexpr int ROWS_SCORE = Rows<RCAP>::SCORE;
  constexpr int ROWS_SOFTMAX = Rows<RCAP>::SOFTMAX;
  constexpr int ROWS_PV = Rows<RCAP>::PV;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const int R = Sq * G;
  uint32_t *kbuf = reinterpret_cast<uint32_t *>(smem);                    // [BK][KROW]
  uint32_t *vbuf = reinterpret_cast<uint32_t *>(smem + T::KBYTES);        // [BK][VROW]
  float *kss = reinterpret_cast<float *>(smem + T::KBYTES + T::VBYTES);   // [BK]
  float *vss = kss + BK;                                                  // [BK]
  float *qs = vss + BK;                                                   // [R][HD]
  float *ps = qs + R * HD;                                                // [R][BK]
  float *corr_s = ps + R * BK;                                            // [R]

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // the slots this block may read: its split, from the row's pad (and the
  // window floor of query 0, the lowest of the row's floors) to its last
  // limit, never at or past C
  const int fill = fills[b];
  int lo = max(pad_lens[b], split * SPLIT);
  if (window > 0) lo = max(lo, fill - window + 1);
  const int hi = min(min(fill + Sq - 1, C - 1), split * SPLIT + SPLIT - 1);  // inclusive
  const size_t part = (static_cast<size_t>(b) * KV + kv) * n_split + split;

  if (lo > hi) {  // this split sees no slot: an inert partial
    for (int i = t; i < R * HD; i += NTHREADS) o_part[part * R * HD + i] = 0.f;
    for (int i = t; i < R; i += NTHREADS) {
      m_part[part * R + i] = NEG;
      l_part[part * R + i] = 0.f;
    }
    return;
  }

  // query rows r = s * G + g (position-major), f32 in shared memory
  for (int i = t; i < R * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int s = r / G, g = r % G;
    qs[i] = __bfloat162float(
        q[((static_cast<size_t>(b) * Sq + s) * H + static_cast<size_t>(kv) * G + g) * HD + d]);
  }
  const size_t slot_base =
      ((static_cast<size_t>(layer) * B + b) * KV + kv) * static_cast<size_t>(C);
  const uint32_t *kw = static_cast<const uint32_t *>(k_all);
  const uint32_t *vw = static_cast<const uint32_t *>(v_all);

  // softmax state of this warp's rows (r = warp + NWARPS * i), replicated
  // in every lane; PV accumulators of this thread's head dim and rows
  // (r = pv_group + PV_GROUPS * i)
  float m_run[ROWS_SOFTMAX], l_run[ROWS_SOFTMAX];
#pragma unroll
  for (int i = 0; i < ROWS_SOFTMAX; ++i) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
  }
  const int d_pv = t % HD;
  const int pv_group = t / HD;
  float acc[ROWS_PV];
#pragma unroll
  for (int i = 0; i < ROWS_PV; ++i) acc[i] = 0.f;

  const int j_score = t % BK;
  const int score_group = t / BK;

  for (int k0 = (lo / BK) * BK; k0 <= hi; k0 += BK) {
    __syncthreads();  // the previous tile (and, first time, qs) settled
    // stage the K and V tiles: 16-byte loads, consecutive threads on
    // consecutive addresses; slots at or past C are zero-filled
    constexpr int CHUNKS = BK * T::WORDS_PER_ROW / 4;  // 16-byte chunks per tile
    for (int i = t; i < CHUNKS; i += NTHREADS) {
      const int row = i / (T::WORDS_PER_ROW / 4);
      const int word = (i % (T::WORDS_PER_ROW / 4)) * 4;
      const int slot = k0 + row;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (slot < C) {
        const size_t off = (slot_base + slot) * T::WORDS_PER_ROW + word;
        kr = *reinterpret_cast<const uint4 *>(kw + off);
        vr = *reinterpret_cast<const uint4 *>(vw + off);
      }
      uint32_t *kd = kbuf + row * T::KROW + word;
      kd[0] = kr.x; kd[1] = kr.y; kd[2] = kr.z; kd[3] = kr.w;
      *reinterpret_cast<uint4 *>(vbuf + row * T::VROW + word) = vr;
    }
    if (t < BK) {
      const int slot = k0 + t;
      kss[t] = (Q8 && slot < C) ? ks_all[slot_base + slot] : 1.f;
      vss[t] = (Q8 && slot < C) ? vs_all[slot_base + slot] : 1.f;
    }
    __syncthreads();

    // scores: thread (score_group, j) takes slot k0 + j against rows
    // r = score_group + SCORE_GROUPS * i; one K row read serves them all
    {
      float sc[ROWS_SCORE];
#pragma unroll
      for (int i = 0; i < ROWS_SCORE; ++i) sc[i] = 0.f;
      const uint32_t *krow = kbuf + j_score * T::KROW;
#pragma unroll 2
      for (int w = 0; w < HD / 4; ++w) {
        float k0f, k1f, k2f, k3f;
        if (Q8) {
          const uint32_t word = krow[w];
          const char4 c = *reinterpret_cast<const char4 *>(&word);
          k0f = c.x; k1f = c.y; k2f = c.z; k3f = c.w;
        } else {
          const uint32_t w0 = krow[2 * w], w1 = krow[2 * w + 1];
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&w0));
          const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&w1));
          k0f = a.x; k1f = a.y; k2f = c.x; k3f = c.y;
        }
#pragma unroll
        for (int i = 0; i < ROWS_SCORE; ++i) {
          const int r = score_group + SCORE_GROUPS * i;
          if (r < R) {
            const float4 qv = *reinterpret_cast<const float4 *>(qs + r * HD + 4 * w);
            sc[i] += qv.x * k0f + qv.y * k1f + qv.z * k2f + qv.w * k3f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS_SCORE; ++i) {
        const int r = score_group + SCORE_GROUPS * i;
        if (r < R) ps[r * BK + j_score] = Q8 ? sc[i] * scale * kss[j_score] : sc[i] * scale;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows r = w + NWARPS * i, lane l the slots
    // k0 + l and k0 + l + 32; l sums the unscaled p, PV takes p * vs
#pragma unroll
    for (int i = 0; i < ROWS_SOFTMAX; ++i) {
      const int r = warp + NWARPS * i;
      if (r < R) {
        const int limit = fill + r / G;  // last slot query r sees
        const int top = min(hi, limit);
        float sv[BK / 32];
        bool ok[BK / 32];
        float tmax = NEG;
#pragma unroll
        for (int c = 0; c < BK / 32; ++c) {
          const int j = lane + 32 * c;
          const int slot = k0 + j;
          ok[c] = slot >= lo && slot <= top && (window == 0 || slot > limit - window);
          sv[c] = ok[c] ? ps[r * BK + j] : NEG;
          tmax = fmaxf(tmax, sv[c]);
        }
        const float m_new = fmaxf(m_run[i], warp_max(tmax));
        const float corr = __expf(m_run[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < BK / 32; ++c) {
          const int j = lane + 32 * c;
          const float p = ok[c] ? __expf(sv[c] - m_new) : 0.f;
          psum += p;
          ps[r * BK + j] = Q8 ? p * vss[j] : p;
        }
        l_run[i] = l_run[i] * corr + warp_sum(psum);
        m_run[i] = m_new;
        if (lane == 0) corr_s[r] = corr;
      }
    }
    __syncthreads();

    // O = O * corr + P V: thread t owns head dim t % HD of rows
    // r = pv_group + PV_GROUPS * i; V rows are read across threads, and
    // each row's probabilities four slots at a time. Slots past `hi` up to
    // the next multiple of 4 carry p = 0 and finite V (zero past C)
    const int rows4 = (min(BK, hi + 1 - k0) + 3) & ~3;
#pragma unroll
    for (int i = 0; i < ROWS_PV; ++i) {
      const int r = pv_group + PV_GROUPS * i;
      if (r < R) acc[i] *= corr_s[r];
    }
    for (int j = 0; j < rows4; j += 4) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (Q8) {
          v[c] = static_cast<float>(
              reinterpret_cast<const int8_t *>(vbuf + (j + c) * T::VROW)[d_pv]);
        } else {
          v[c] = __bfloat162float(
              reinterpret_cast<const __nv_bfloat16 *>(vbuf + (j + c) * T::VROW)[d_pv]);
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS_PV; ++i) {
        const int r = pv_group + PV_GROUPS * i;
        if (r < R) {
          const float4 p = *reinterpret_cast<const float4 *>(ps + r * BK + j);
          acc[i] += p.x * v[0] + p.y * v[1] + p.z * v[2] + p.w * v[3];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PV; ++i) {
    const int r = pv_group + PV_GROUPS * i;
    if (r < R) o_part[(part * R + r) * HD + d_pv] = acc[i];
  }
#pragma unroll
  for (int i = 0; i < ROWS_SOFTMAX; ++i) {
    const int r = warp + NWARPS * i;
    if (r < R && lane == 0) {
      m_part[part * R + r] = m_run[i];
      l_part[part * R + r] = l_run[i];
    }
  }
}

// pass 2: one block per (KV head, batch row); thread t owns head dim t
__global__ void __launch_bounds__(HD)
flash_verify_merge_kernel(const float *__restrict__ o_part, const float *__restrict__ m_part,
                          const float *__restrict__ l_part, __nv_bfloat16 *__restrict__ out,
                          int Sq, int H, int KV, int n_split) {
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int R = Sq * G;
  const int t = threadIdx.x;
  const size_t pair = (static_cast<size_t>(b) * KV + kv) * n_split;
  for (int r = 0; r < R; ++r) {
    float m = NEG;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, m_part[(pair + s) * R + r]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = __expf(m_part[(pair + s) * R + r] - m);
      l += l_part[(pair + s) * R + r] * f;
      o += o_part[((pair + s) * R + r) * HD + t] * f;
    }
    const int sq = r / G, g = r % G;
    const size_t q_off =
        ((static_cast<size_t>(b) * Sq + sq) * H + static_cast<size_t>(kv) * G + g) * HD;
    out[q_off + t] = __float2bfloat16(o / fmaxf(l, 1e-30f));
  }
}

// Both passes of one call on `st`; returns cudaGetLastError() (0 = launched).
// Blocks of up to RCAP rows need more than the 48 KB of shared memory a
// block gets without asking; the attribute is set once per instantiation, to
// the size its largest R takes.
template <bool Q8, int RCAP>
int launch(const __nv_bfloat16 *q, const void *k, const void *v, const void *ks,
           const void *vs, const int *pads, const int *fills, float *op, float *mp, float *lp,
           __nv_bfloat16 *out, int B, int Sq, int H, int KV, int C, int layer, int window,
           float scale, int n_split, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(flash_verify_split_kernel<Q8, RCAP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 Tile<Q8>::smem(RCAP));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int R = Sq * (H / KV);
  flash_verify_split_kernel<Q8, RCAP><<<dim3(n_split, KV, B), NTHREADS, Tile<Q8>::smem(R), st>>>(
      q, k, v, static_cast<const float *>(ks), static_cast<const float *>(vs), pads, fills, op,
      mp, lp, B, Sq, H, KV, C, layer, window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_verify_merge_kernel<<<dim3(KV, B), HD, 0, st>>>(op, mp, lp, out, Sq, H, KV, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of pass-1 splits for a cache of C slots; the caller sizes the
// partials with it.
extern "C" int vnsum_flash_verify_splits(int C) { return (C + SPLIT - 1) / SPLIT; }

// Dynamic shared memory of a pass-1 block for R = Sq * G query rows.
extern "C" int vnsum_flash_verify_smem(int R, int quantized) {
  return quantized ? Tile<true>::smem(R) : Tile<false>::smem(R);
}

// Plain C entry point, loaded with ctypes. Launches both passes on `stream`
// and returns cudaGetLastError() (0 = launched). `o_part`, `m_part` and
// `l_part` are f32 scratch of [B, KV, splits, Sq*G, HD] and
// [B, KV, splits, Sq*G].
extern "C" int vnsum_flash_verify(const void *q, const void *k, const void *v, const void *ks,
                                  const void *vs, const void *pad_lens, const void *fills,
                                  void *out, void *o_part, void *m_part, void *l_part, int B,
                                  int Sq, int H, int KV, int C, int head_dim, int layer,
                                  int window, int quantized, float scale, void *stream) {
  if (head_dim != HD || KV <= 0 || H % KV != 0 || H / KV > MAXG || Sq <= 0 ||
      Sq * (H / KV) > MAXR || B <= 0 || C <= 0 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int R = Sq * (H / KV);
  const int n_split = vnsum_flash_verify_splits(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16 *qb = static_cast<const __nv_bfloat16 *>(q);
  __nv_bfloat16 *ob = static_cast<__nv_bfloat16 *>(out);
  const int *pads = static_cast<const int *>(pad_lens);
  const int *fl = static_cast<const int *>(fills);
  float *op = static_cast<float *>(o_part);
  float *mp = static_cast<float *>(m_part);
  float *lp = static_cast<float *>(l_part);
  if (quantized) {
    if (R <= 8) return launch<true, 8>(qb, k, v, ks, vs, pads, fl, op, mp, lp, ob, B, Sq, H, KV, C,
                                       layer, window, scale, n_split, st);
    if (R <= 32) return launch<true, 32>(qb, k, v, ks, vs, pads, fl, op, mp, lp, ob, B, Sq, H, KV,
                                         C, layer, window, scale, n_split, st);
    return launch<true, 64>(qb, k, v, ks, vs, pads, fl, op, mp, lp, ob, B, Sq, H, KV, C, layer,
                            window, scale, n_split, st);
  }
  if (R <= 8) return launch<false, 8>(qb, k, v, ks, vs, pads, fl, op, mp, lp, ob, B, Sq, H, KV, C,
                                      layer, window, scale, n_split, st);
  if (R <= 32) return launch<false, 32>(qb, k, v, ks, vs, pads, fl, op, mp, lp, ob, B, Sq, H, KV, C,
                                        layer, window, scale, n_split, st);
  return launch<false, 64>(qb, k, v, ks, vs, pads, fl, op, mp, lp, ob, B, Sq, H, KV, C, layer,
                           window, scale, n_split, st);
}
