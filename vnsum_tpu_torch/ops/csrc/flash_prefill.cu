// Flash prefill attention over the stacked KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vnsum_tpu/ops/flash_attention.py
// (`_kernel`, reached through `flash_prefill_attention`). Same function:
// S prefill queries per row, sitting at cache slots [q_offset, q_offset+S),
// attend layer `layer` of the stacked cache [L, B, KV, C, hd] under the mask
//   pad_b <= k <= q   and   (window == 0 or k > q - window),
// with an online softmax. An int8 cache multiplies the scores by ks[k] and,
// after l has summed the unscaled p, multiplies p by vs[k] before the PV
// product. QK and PV run in bf16 with f32 accumulation, p is rounded to
// bf16 before PV, and a row that sees no key comes out as 0.
//
// What bounds it on this card: tensor-core operations. At the main path's
// shape (B=8, S=4096, H=24, hd=128) the causal work is ~8e11 FLOP against
// ~0.1 GB of q/out/cache bytes, far above the ~295 FLOP/byte ridge.
//
// Design: one block of 8 warps per (128 query rows, KV head, batch row).
// The 128 rows are (position, group head) pairs taken position-major, so
// one K/V tile in shared memory serves every query head of the GQA group,
// as the TPU grid did. Each warp owns 16 rows, keeps its Q fragments in
// registers and runs bf16 mma.sync m16n8k16 with f32 accumulators; K and V
// fragments come from shared memory through ldmatrix (.trans for V). The
// K/V tiles are double-buffered: a bf16 cache streams the next tile with
// cp.async while the current one is computed; an int8 cache holds the next
// tile's bytes in registers meanwhile and widens them to bf16 (exact for
// -127..127) into the other buffer afterwards. Only tiles that cross the
// diagonal, the left pad or the window floor are masked element by element;
// tiles above the diagonal, wholly below the window floor or wholly inside
// the pad are neither loaded nor computed. Blocks with the most tiles start
// first. The softmax runs on log2-scaled scores with ex2. Offsets into the
// cache are 64-bit: at the pipeline's defaults one K or V cache holds more
// than 2^31 elements.
// Not yet done: TMA, wgmma, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;           // head_dim the kernel takes
constexpr int BM = 128;           // query rows (position, group head) per block
constexpr int BN = 64;            // cache slots per K/V tile
constexpr int NWARPS = BM / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SROW = HD + 8;      // padded smem row: conflict-free ldmatrix
constexpr int TILE = BN * SROW;   // elements of one K or V tile buffer
constexpr int SMEM_BYTES = 2 * 2 * TILE * 2 + 2 * 2 * BN * 4;
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void *p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void *p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16 bytes global -> shared; zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void *dst, const void *src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 16 int8 values -> 16 bf16 values (two 16-byte words)
__device__ __forceinline__ void widen_int8x16(const int4 raw, uint4 &lo, uint4 &hi) {
  const int8_t *c = reinterpret_cast<const int8_t *>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = pack_bf16(static_cast<float>(c[2 * i]), static_cast<float>(c[2 * i + 1]));
  }
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

// int8 tile: 512 16-byte chunks each of K and V, 2 + 2 per thread, plus
// one scale (threads 0..63: ks, 64..127: vs)
constexpr int I8_CHUNKS = BN * HD / 16 / NTHREADS;
// bf16 tile: 1024 16-byte chunks each of K and V, 4 + 4 per thread
constexpr int B16_CHUNKS = BN * HD / 8 / NTHREADS;

struct Int8Tile {
  int4 k[I8_CHUNKS];
  int4 v[I8_CHUNKS];
  float scale;
};

__device__ __forceinline__ void fetch_int8(Int8Tile &t, const int8_t *k8, const int8_t *v8,
                                           const float *ks, const float *vs, size_t slot_base,
                                           int k0, int C) {
#pragma unroll
  for (int j = 0; j < I8_CHUNKS; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    const int slot = k0 + i / (HD / 16);
    t.k[j] = t.v[j] = make_int4(0, 0, 0, 0);
    if (slot < C) {
      const size_t off = (slot_base + slot) * HD + (i % (HD / 16)) * 16;
      t.k[j] = *reinterpret_cast<const int4 *>(k8 + off);
      t.v[j] = *reinterpret_cast<const int4 *>(v8 + off);
    }
  }
  t.scale = 0.f;
  if (threadIdx.x < 2 * BN) {
    const int slot = k0 + (threadIdx.x & (BN - 1));
    if (slot < C) t.scale = (threadIdx.x < BN ? ks : vs)[slot_base + slot];
  }
}

__device__ __forceinline__ void store_int8(const Int8Tile &t, __nv_bfloat16 *Kb,
                                           __nv_bfloat16 *Vb, float *ksb, float *vsb) {
#pragma unroll
  for (int j = 0; j < I8_CHUNKS; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    const int off = (i / (HD / 16)) * SROW + (i % (HD / 16)) * 16;
    uint4 lo, hi;
    widen_int8x16(t.k[j], lo, hi);
    *reinterpret_cast<uint4 *>(Kb + off) = lo;
    *reinterpret_cast<uint4 *>(Kb + off + 8) = hi;
    widen_int8x16(t.v[j], lo, hi);
    *reinterpret_cast<uint4 *>(Vb + off) = lo;
    *reinterpret_cast<uint4 *>(Vb + off + 8) = hi;
  }
  if (threadIdx.x < 2 * BN) (threadIdx.x < BN ? ksb : vsb)[threadIdx.x & (BN - 1)] = t.scale;
}

__device__ __forceinline__ void copy_bf16(const __nv_bfloat16 *kb, const __nv_bfloat16 *vb,
                                          size_t slot_base, int k0, int C, __nv_bfloat16 *Kb,
                                          __nv_bfloat16 *Vb) {
#pragma unroll
  for (int j = 0; j < B16_CHUNKS; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    const int rr = i / (HD / 8);
    const int cc = (i % (HD / 8)) * 8;
    const int slot = k0 + rr;
    const bool valid = slot < C;
    const size_t off = (slot_base + (valid ? slot : 0)) * HD + cc;
    cp_async16(Kb + rr * SROW + cc, kb + off, valid);
    cp_async16(Vb + rr * SROW + cc, vb + off, valid);
  }
}

// Scales the scores of one tile into the log2 domain, masks them (MASKED
// tiles only), updates the running max and sum, and leaves in `sc` the
// probabilities that go into PV (times vs[k] for an int8 cache).
template <bool Q8, bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 8][4], float (&m_run)[2],
                                             float (&l_run)[2], float (&corr)[2],
                                             const float *ksb, const float *vsb,
                                             float scale_log2, int k0, int tig,
                                             const int (&row_q)[2], const bool (&row_ok)[2],
                                             int pad, int window) {
  uint32_t live = 0;  // bit nt*4 + e: element passes the mask
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int col = nt * 8 + tig * 2 + (e & 1);
      float s = sc[nt][e] * scale_log2;
      if (Q8) s *= ksb[col];
      if (MASKED) {
        const int slot = k0 + col;
        const bool ok = row_ok[i] && slot >= pad && slot <= row_q[i] &&
                        (window == 0 || slot > row_q[i] - window);
        s = ok ? s : NEG;
        live |= static_cast<uint32_t>(ok) << (nt * 4 + e);
      }
      sc[nt][e] = s;
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
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float p = ex2(sc[nt][e] - m_run[i]);
      if (MASKED && !((live >> (nt * 4 + e)) & 1u)) p = 0.f;
      l_run[i] += p;
      if (Q8) p *= vsb[nt * 8 + tig * 2 + (e & 1)];
      sc[nt][e] = p;
    }
  }
}

template <bool Q8>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_prefill_kernel(const __nv_bfloat16 *__restrict__ q,  // [B, S, H, HD]
                     const void *__restrict__ k_all,       // [L, B, KV, C, HD]
                     const void *__restrict__ v_all,
                     const float *__restrict__ ks_all,     // [L, B, KV, C] (int8 only)
                     const float *__restrict__ vs_all,
                     const int *__restrict__ pad_lens,     // [B]
                     __nv_bfloat16 *__restrict__ out,      // [B, S, H, HD]
                     int B, int S, int H, int KV, int C, int layer, int window,
                     int q_offset, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16 *Ks = reinterpret_cast<__nv_bfloat16 *>(smem);  // [2][TILE]
  __nv_bfloat16 *Vs = Ks + 2 * TILE;                              // [2][TILE]
  float *kscale = reinterpret_cast<float *>(Vs + 2 * TILE);      // [2][BN]
  float *vscale = kscale + 2 * BN;                                // [2][BN]

  const int G = H / KV;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // fragment row within the 8-row group
  const int tig = lane & 3;   // thread in group: fragment column pair

  const int n_rows = S * G;
  // the last row tiles see the most slots: launch them first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int q_lo = q_offset + r0 / G;
  const int q_hi = q_offset + (min(r0 + BM, n_rows) - 1) / G;
  const int pad = pad_lens[b];

  // this warp's 16 rows
  const int wr0 = r0 + warp * 16;
  const bool warp_rows = wr0 < n_rows;
  const bool warp_full = wr0 + 15 < n_rows;
  const int wq_lo = q_offset + wr0 / G;
  const int wq_hi = q_offset + (min(wr0 + 15, n_rows - 1)) / G;

  // this thread's two accumulator rows: gid and gid + 8 of the warp's 16
  int row_q[2];
  bool row_ok[2];
  size_t row_off[2];  // element offset of the row in q / out
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr0 + gid + 8 * i;
    row_ok[i] = r < n_rows;
    const int s = row_ok[i] ? r / G : 0;
    const int g = row_ok[i] ? r % G : 0;
    row_q[i] = q_offset + s;
    row_off[i] = ((static_cast<size_t>(b) * S + s) * H + static_cast<size_t>(kv) * G + g) * HD;
  }

  // Q fragments for the whole head_dim, held in registers
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1;                          // row gid (0) or gid + 8 (1)
      const int col = kk * 16 + tig * 2 + (j >> 1) * 8;
      qa[kk][j] = row_ok[i]
                      ? *reinterpret_cast<const uint32_t *>(q + row_off[i] + col)
                      : 0u;
    }
  }

  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }
  float m_run[2] = {NEG, NEG};
  float l_run[2] = {0.f, 0.f};  // partial over this thread's columns

  int kt_lo = pad / BN;
  if (window > 0) kt_lo = max(kt_lo, max(q_lo - window + 1, 0) / BN);
  const int kt_hi = q_hi / BN;
  const size_t slot_base = ((static_cast<size_t>(layer) * B + b) * KV + kv) * static_cast<size_t>(C);
  const int8_t *k8 = static_cast<const int8_t *>(k_all);
  const int8_t *v8 = static_cast<const int8_t *>(v_all);
  const __nv_bfloat16 *kb = static_cast<const __nv_bfloat16 *>(k_all);
  const __nv_bfloat16 *vb = static_cast<const __nv_bfloat16 *>(v_all);

  // ldmatrix row addresses: lane -> (matrix lane / 8, row lane % 8)
  const int lm_mat = lane >> 3;
  const int lm_row = lane & 7;

  Int8Tile pre;
  if (kt_lo <= kt_hi) {
    if (Q8) {
      fetch_int8(pre, k8, v8, ks_all, vs_all, slot_base, kt_lo * BN, C);
      store_int8(pre, Ks, Vs, kscale, vscale);
    } else {
      copy_bf16(kb, vb, slot_base, kt_lo * BN, C, Ks, Vs);
      cp_async_wait_all();
    }
  }
  __syncthreads();

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BN;
    const int cur = (kt - kt_lo) & 1;
    const bool more = kt < kt_hi;
    __nv_bfloat16 *Kc = Ks + cur * TILE;
    __nv_bfloat16 *Vc = Vs + cur * TILE;
    const float *ksc = kscale + cur * BN;
    const float *vsc = vscale + cur * BN;
    // the next tile goes into the other buffer, which the barrier that
    // ended the previous iteration released
    if (more) {
      if (Q8) {
        fetch_int8(pre, k8, v8, ks_all, vs_all, slot_base, k0 + BN, C);
      } else {
        copy_bf16(kb, vb, slot_base, k0 + BN, C, Ks + (cur ^ 1) * TILE, Vs + (cur ^ 1) * TILE);
      }
    }

    const bool active = warp_rows && k0 <= wq_hi && k0 + BN - 1 >= pad &&
                        (window == 0 || k0 + BN - 1 > wq_lo - window);
    if (active) {
      // scores S = Q K^T for this warp's 16 rows x 64 slots
      float sc[BN / 8][4];
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; kk += 2) {
          uint32_t kf[4];  // b0, b1 of kk; b0, b1 of kk + 1
          ldsm_x4(kf, Kc + (nt * 8 + lm_row) * SROW + kk * 16 + lm_mat * 8);
          mma_bf16(sc[nt], qa[kk], kf[0], kf[1]);
          mma_bf16(sc[nt], qa[kk + 1], kf[2], kf[3]);
        }
      }

      const bool interior = warp_full && k0 >= pad && k0 + BN - 1 <= wq_lo &&
                            (window == 0 || k0 > wq_hi - window);
      float corr[2];
      if (interior) {
        softmax_tile<Q8, false>(sc, m_run, l_run, corr, ksc, vsc, scale_log2, k0, tig, row_q,
                                row_ok, pad, window);
      } else {
        softmax_tile<Q8, true>(sc, m_run, l_run, corr, ksc, vsc, scale_log2, k0, tig, row_q,
                               row_ok, pad, window);
      }
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        o[nt][0] *= corr[0];
        o[nt][1] *= corr[0];
        o[nt][2] *= corr[1];
        o[nt][3] *= corr[1];
      }
      // O += P V, P rounded to bf16 as the A operand
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int nt = 0; nt < HD / 8; nt += 2) {
          uint32_t vf[4];  // b0, b1 of nt; b0, b1 of nt + 1
          ldsm_x4_trans(vf, Vc + (kk * 16 + (lm_mat & 1) * 8 + lm_row) * SROW + nt * 8 +
                                (lm_mat >> 1) * 8);
          mma_bf16(o[nt], pa, vf[0], vf[1]);
          mma_bf16(o[nt + 1], pa, vf[2], vf[3]);
        }
      }
    }

    if (more) {
      if (Q8) {
        store_int8(pre, Ks + (cur ^ 1) * TILE, Vs + (cur ^ 1) * TILE, kscale + (cur ^ 1) * BN,
                   vscale + (cur ^ 1) * BN);
      } else {
        cp_async_wait_all();
      }
    }
    __syncthreads();
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
          pack_bf16(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    }
    if (row_ok[1]) {
      *reinterpret_cast<uint32_t *>(out + row_off[1] + col) =
          pack_bf16(o[nt][2] * inv[1], o[nt][3] * inv[1]);
    }
  }
}

template <bool Q8>
cudaError_t launch(dim3 grid, cudaStream_t st, const __nv_bfloat16 *q, const void *k,
                   const void *v, const float *ks, const float *vs, const int *pads,
                   __nv_bfloat16 *out, int B, int S, int H, int KV, int C, int layer,
                   int window, int q_offset, float scale_log2) {
  static bool configured = false;  // the shared-memory opt-in, once per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  flash_prefill_kernel<Q8><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      q, k, v, ks, vs, pads, out, B, S, H, KV, C, layer, window, q_offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int vnsum_flash_prefill(const void *q, const void *k, const void *v,
                                   const void *ks, const void *vs, const void *pad_lens,
                                   void *out, int B, int S, int H, int KV, int C, int head_dim,
                                   int layer, int window, int q_offset, int quantized,
                                   float scale, void *stream) {
  if (head_dim != HD || KV <= 0 || H % KV != 0 || S <= 0 || B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = H / KV;
  const dim3 grid((S * G + BM - 1) / BM, KV, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16 *qb = static_cast<const __nv_bfloat16 *>(q);
  __nv_bfloat16 *ob = static_cast<__nv_bfloat16 *>(out);
  const int *pads = static_cast<const int *>(pad_lens);
  const float scale_log2 = scale * LOG2E;
  const cudaError_t err =
      quantized ? launch<true>(grid, st, qb, k, v, static_cast<const float *>(ks),
                               static_cast<const float *>(vs), pads, ob, B, S, H, KV, C, layer,
                               window, q_offset, scale_log2)
                : launch<false>(grid, st, qb, k, v, nullptr, nullptr, pads, ob, B, S, H, KV, C,
                                layer, window, q_offset, scale_log2);
  return static_cast<int>(err);
}
