// Flash decode attention over the stacked KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vnsum_tpu/ops/decode_attention.py
// (`_kernel`, reached through `flash_decode_attention`) in both of its
// modes: return_partials=False (K2, `vnsum_flash_decode`) and
// return_partials=True (K2p, `vnsum_flash_decode_partials`). Same function:
// one query token per batch row attends layer `layer` of the stacked cache
// [L, B, KV, C, hd]; the batch shares one scalar `fill`, the last valid
// slot, and the mask is
//   pad_b <= k <= fill   and   (window == 0 or k > fill - window).
// All arithmetic is f32. An int8 cache multiplies the scores by ks[k] and,
// after l has summed the unscaled p, multiplies p by vs[k] before PV.
//
// What bounds it on this card: device-memory bytes. Each step reads the
// row's visible K and V slots once (B*KV*fill*hd bytes each for int8) and
// does ~4 FLOP per cached element, far below the ~295 FLOP/byte ridge.
//
// Design: the batch has few (row, KV head) pairs (64 at the pipeline's
// batch 8, fewer than the card's 132 SMs), so the cache range of each pair
// is split across blocks of SPLIT slots ("flash decoding"). Pass 1: a block
// of 4 warps takes one (split, KV head, row), stages each 128-slot K and V
// tile in shared memory with coalesced 16-byte loads, scores one slot per
// thread against the G query heads of the group (each slot is read once
// for all G heads), and keeps a block-wide online softmax; each thread
// owns one of the 128 head dims for PV. It writes the unnormalised state
// (m, l, o), the state the TPU kernel's return_partials mode defines; a
// split that sees no slot writes m = -1e30, l = 0, o = 0. Pass 2 merges a
// pair's splits with the log-sum-exp algebra. K2 then divides by
// max(l, 1e-30), so a row that sees no key comes out as 0. K2p writes the
// merged state (o [B, H, hd], m, l [B, H], f32) without dividing: the
// long-context decode merges it again across the ranks of its sequence
// group and with the decode cache. A row that sees no key (a shard wholly
// inside its left pad) comes out exactly m = -1e30, l = 0, o = 0, inert in
// those merges: every split is inert and exp(m_s - m) = 1 multiplies zeros.
// Offsets into the cache are 64-bit. Not yet done: cp.async/TMA pipelining
// of the tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;          // head_dim the kernel takes
constexpr int BK = 128;          // cache slots per tile, one per thread
constexpr int SPLIT = 512;       // cache slots per pass-1 block
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;          // largest GQA group the kernel takes
constexpr float NEG = -1e30f;

template <bool Q8>
struct Tile {
  static constexpr int WORDS_PER_ROW = Q8 ? HD / 4 : HD / 2;  // one cache slot
  // K rows padded by one 32-bit word: thread t reads row t, conflict-free
  static constexpr int KROW = WORDS_PER_ROW + 1;
  static constexpr int VROW = WORDS_PER_ROW;  // V rows are read across threads
  // dynamic shared memory: K tile, V tile, queries, p * vs, reduction
  static constexpr int KBYTES = BK * KROW * 4;
  static constexpr int VBYTES = BK * VROW * 4;
  static constexpr int SMEM = KBYTES + VBYTES + MAXG * HD * 4 + MAXG * BK * 4 + NWARPS * 4;
};

__device__ __forceinline__ float block_max(float v, float *red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ __forceinline__ float block_sum(float v, float *red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) s += red[w];
  return s;
}

template <bool Q8>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_split_kernel(const __nv_bfloat16 *__restrict__ q,  // [B, 1, H, HD]
                          const void *__restrict__ k_all,       // [L, B, KV, C, HD]
                          const void *__restrict__ v_all,
                          const float *__restrict__ ks_all,     // [L, B, KV, C] (int8 only)
                          const float *__restrict__ vs_all,
                          const int *__restrict__ pad_lens,     // [B]
                          float *__restrict__ o_part,           // [B, KV, NS, G, HD]
                          float *__restrict__ m_part,           // [B, KV, NS, G]
                          float *__restrict__ l_part,
                          int B, int H, int KV, int C, int layer, int fill, int window,
                          float scale) {
  using T = Tile<Q8>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t *kbuf = reinterpret_cast<uint32_t *>(smem);                    // [BK][KROW]
  uint32_t *vbuf = reinterpret_cast<uint32_t *>(smem + T::KBYTES);        // [BK][VROW]
  float *qs = reinterpret_cast<float *>(smem + T::KBYTES + T::VBYTES);    // [MAXG][HD]
  float *pv = qs + MAXG * HD;                                             // [MAXG][BK]
  float *red = pv + MAXG * BK;                                            // [NWARPS]

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int t = threadIdx.x;

  const int pad = pad_lens[b];
  int lo = max(pad, split * SPLIT);
  if (window > 0) lo = max(lo, fill - window + 1);
  const int hi = min(fill, split * SPLIT + SPLIT - 1);  // inclusive
  const size_t part = (static_cast<size_t>(b) * KV + kv) * n_split + split;

  if (lo > hi) {  // this split sees no slot: an inert partial
    for (int i = t; i < G * HD; i += NTHREADS) o_part[part * G * HD + i] = 0.f;
    if (t < G) {
      m_part[part * G + t] = NEG;
      l_part[part * G + t] = 0.f;
    }
    return;
  }

  const size_t q_off = (static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G) * HD;
  for (int i = t; i < G * HD; i += NTHREADS) qs[i] = __bfloat162float(q[q_off + i]);
  const size_t slot_base =
      ((static_cast<size_t>(layer) * B + b) * KV + kv) * static_cast<size_t>(C);
  const uint32_t *kw = static_cast<const uint32_t *>(k_all);
  const uint32_t *vw = static_cast<const uint32_t *>(v_all);

  float m_run[MAXG], l_run[MAXG], acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m_run[g] = NEG;
    l_run[g] = 0.f;  // partial over this thread's slots
    acc[g] = 0.f;    // head dim t of head g
  }

  for (int k0 = (lo / BK) * BK; k0 <= hi; k0 += BK) {
    __syncthreads();  // the previous tile (and, first time, qs) settled
    // stage the K and V tiles: 16-byte loads, consecutive threads on
    // consecutive addresses; slots past C are zero-filled
    constexpr int CHUNKS = BK * T::WORDS_PER_ROW / 4;  // 16-byte chunks per tile
#pragma unroll 4
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
    const int slot = k0 + t;
    float ksc = 1.f, vsc = 1.f;
    if (Q8 && slot < C) {
      ksc = ks_all[slot_base + slot];
      vsc = vs_all[slot_base + slot];
    }
    __syncthreads();

    // scores: thread t takes slot k0 + t against the G query heads
    const bool ok = slot >= lo && slot <= hi;
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    const uint32_t *krow = kbuf + t * T::KROW;
    if (Q8) {
#pragma unroll 4
      for (int w = 0; w < HD / 4; ++w) {
        const uint32_t word = krow[w];
        const char4 c = *reinterpret_cast<const char4 *>(&word);
        const float k0f = c.x, k1f = c.y, k2f = c.z, k3f = c.w;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4 *>(qs + g * HD + 4 * w);
            s[g] += qv.x * k0f + qv.y * k1f + qv.z * k2f + qv.w * k3f;
          }
        }
      }
    } else {
#pragma unroll 4
      for (int w = 0; w < HD / 4; ++w) {
        const uint32_t w0 = krow[2 * w], w1 = krow[2 * w + 1];
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&w0));
        const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&w1));
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4 *>(qs + g * HD + 4 * w);
            s[g] += qv.x * a.x + qv.y * a.y + qv.z * c.x + qv.w * c.y;
          }
        }
      }
    }

    // block-wide online softmax: l sums the unscaled p, PV takes p * vs
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float sg = s[g] * scale;
        if (Q8) sg *= ksc;
        sg = ok ? sg : NEG;
        const float m_new = fmaxf(m_run[g], block_max(sg, red));
        const float corr = __expf(m_run[g] - m_new);
        m_run[g] = m_new;
        const float p = ok ? __expf(sg - m_new) : 0.f;
        l_run[g] = l_run[g] * corr + p;
        acc[g] *= corr;
        pv[g * BK + t] = p * vsc;
      }
    }
    __syncthreads();

    // O += P V: thread t owns head dim t; V rows are read across threads
    const int rows = min(BK, hi + 1 - k0);
#pragma unroll 4
    for (int j = 0; j < rows; ++j) {
      float v;
      if (Q8) {
        v = static_cast<float>(reinterpret_cast<const int8_t *>(vbuf + j * T::VROW)[t]);
      } else {
        v = __bfloat162float(reinterpret_cast<const __nv_bfloat16 *>(vbuf + j * T::VROW)[t]);
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) acc[g] += pv[g * BK + j] * v;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      const float l = block_sum(l_run[g], red);
      o_part[(part * G + g) * HD + t] = acc[g];
      if (t == 0) {
        m_part[part * G + g] = m_run[g];
        l_part[part * G + g] = l;
      }
    }
  }
}

// pass 2: one block per (KV head, row); thread t owns head dim t. K2
// (PARTIALS false) writes o / max(l, 1e-30) as bf16 into `out`; K2p writes
// the unnormalised f32 state into `out` (o), `m_out` and `l_out`.
template <bool PARTIALS>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_merge_kernel(const float *__restrict__ o_part, const float *__restrict__ m_part,
                          const float *__restrict__ l_part, void *__restrict__ out,
                          float *__restrict__ m_out, float *__restrict__ l_out, int H, int KV,
                          int n_split) {
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int t = threadIdx.x;
  const size_t pair = (static_cast<size_t>(b) * KV + kv) * n_split;
  for (int g = 0; g < G; ++g) {
    float m = NEG;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, m_part[(pair + s) * G + g]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = __expf(m_part[(pair + s) * G + g] - m);
      l += l_part[(pair + s) * G + g] * f;
      o += o_part[((pair + s) * G + g) * HD + t] * f;
    }
    const size_t head = static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G + g;
    if (PARTIALS) {
      static_cast<float *>(out)[head * HD + t] = o;
      if (t == 0) {
        m_out[head] = m;
        l_out[head] = l;
      }
    } else {
      static_cast<__nv_bfloat16 *>(out)[head * HD + t] = __float2bfloat16(o / fmaxf(l, 1e-30f));
    }
  }
}

bool bad_shape(int B, int H, int KV, int C, int head_dim, int fill) {
  return head_dim != HD || KV <= 0 || H % KV != 0 || H / KV > MAXG || B <= 0 || fill < 0 ||
         fill >= C;
}

// pass 1 on `st`; the bf16 tiles need more than the 48 KB of shared memory
// a block gets without asking, so the attribute is set once per kernel
cudaError_t launch_split(const void *q, const void *k, const void *v, const void *ks,
                         const void *vs, const void *pad_lens, void *o_part, void *m_part,
                         void *l_part, int B, int H, int KV, int C, int layer, int fill,
                         int window, int quantized, float scale, int n_split, cudaStream_t st) {
  const dim3 grid1(n_split, KV, B);
  const __nv_bfloat16 *qb = static_cast<const __nv_bfloat16 *>(q);
  const int *pads = static_cast<const int *>(pad_lens);
  float *op = static_cast<float *>(o_part);
  float *mp = static_cast<float *>(m_part);
  float *lp = static_cast<float *>(l_part);
  static bool smem_set[2] = {false, false};
  cudaError_t err = cudaSuccess;
  if (quantized) {
    if (!smem_set[1]) {
      err = cudaFuncSetAttribute(flash_decode_split_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<true>::SMEM);
      if (err != cudaSuccess) return err;
      smem_set[1] = true;
    }
    flash_decode_split_kernel<true><<<grid1, NTHREADS, Tile<true>::SMEM, st>>>(
        qb, k, v, static_cast<const float *>(ks), static_cast<const float *>(vs), pads, op, mp,
        lp, B, H, KV, C, layer, fill, window, scale);
  } else {
    if (!smem_set[0]) {
      err = cudaFuncSetAttribute(flash_decode_split_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<false>::SMEM);
      if (err != cudaSuccess) return err;
      smem_set[0] = true;
    }
    flash_decode_split_kernel<false><<<grid1, NTHREADS, Tile<false>::SMEM, st>>>(
        qb, k, v, nullptr, nullptr, pads, op, mp, lp, B, H, KV, C, layer, fill, window, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// Number of pass-1 splits for a fill; the caller sizes the partials with it.
extern "C" int vnsum_flash_decode_splits(int fill) { return fill / SPLIT + 1; }

// Plain C entry points, loaded with ctypes. Each launches both passes on
// `stream` and returns cudaGetLastError() (0 = launched). `o_part`,
// `m_part` and `l_part` are f32 scratch of [B, KV, splits, G, HD] and
// [B, KV, splits, G].

// K2: `out` [B, 1, H, HD] bf16, normalised.
extern "C" int vnsum_flash_decode(const void *q, const void *k, const void *v, const void *ks,
                                  const void *vs, const void *pad_lens, void *out, void *o_part,
                                  void *m_part, void *l_part, int B, int H, int KV, int C,
                                  int head_dim, int layer, int fill, int window, int quantized,
                                  float scale, void *stream) {
  if (bad_shape(B, H, KV, C, head_dim, fill)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = vnsum_flash_decode_splits(fill);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_split(q, k, v, ks, vs, pad_lens, o_part, m_part, l_part, B, H, KV, C,
                                 layer, fill, window, quantized, scale, n_split, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_merge_kernel<false><<<dim3(KV, B), NTHREADS, 0, st>>>(
      static_cast<const float *>(o_part), static_cast<const float *>(m_part),
      static_cast<const float *>(l_part), out, nullptr, nullptr, H, KV, n_split);
  return static_cast<int>(cudaGetLastError());
}

// K2p: the unnormalised state, `o_out` [B, H, HD], `m_out` and `l_out`
// [B, H], all f32.
extern "C" int vnsum_flash_decode_partials(const void *q, const void *k, const void *v,
                                           const void *ks, const void *vs, const void *pad_lens,
                                           void *o_out, void *m_out, void *l_out, void *o_part,
                                           void *m_part, void *l_part, int B, int H, int KV,
                                           int C, int head_dim, int layer, int fill, int window,
                                           int quantized, float scale, void *stream) {
  if (bad_shape(B, H, KV, C, head_dim, fill)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = vnsum_flash_decode_splits(fill);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_split(q, k, v, ks, vs, pad_lens, o_part, m_part, l_part, B, H, KV, C,
                                 layer, fill, window, quantized, scale, n_split, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_merge_kernel<true><<<dim3(KV, B), NTHREADS, 0, st>>>(
      static_cast<const float *>(o_part), static_cast<const float *>(m_part),
      static_cast<const float *>(l_part), o_out, static_cast<float *>(m_out),
      static_cast<float *>(l_out), H, KV, n_split);
  return static_cast<int>(cudaGetLastError());
}
