// Flash decode attention over the stacked KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vnsum_tpu/ops/decode_attention.py
// (`_kernel`, reached through `flash_decode_attention`) in both of its
// modes: return_partials=False (K2, `vnsum_flash_decode`) and
// return_partials=True (K2p, `vnsum_flash_decode_partials`). Same function:
// one query token per batch row attends layer `layer` of the stacked cache
// [L, B, KV, C, hd]; the batch shares one `fill`, the last valid slot (a
// host int, or an int32 on the device clamped to [0, C - 1]), and the mask
// is
//   pad_b <= k <= fill   and   (window == 0 or k > fill - window).
// The reference is f32 throughout. An int8 cache multiplies the scores by
// ks[k] and, after l has summed the unscaled p, multiplies p by vs[k] before
// PV. K2 divides by max(l, 1e-30), so a row that sees no key comes out 0.
// K2p writes the unnormalised state (o [B, H, hd], m [B, H] in natural-log
// units, l [B, H], f32) that the long-context decode merges again across
// the ranks of its sequence group and with the decode cache; a row that
// sees no key (a shard wholly inside its left pad) comes out exactly
// m = -1e30, l = 0, o = 0, inert in those merges.
//
// What bounds it on this card: device-memory bytes. A call reads each
// visible K and V slot once for the G query heads of its (row, KV head):
// at the long path's shape (B=2, C=32768, bf16) ~220 MB, 66 us at 3.35
// TB/s, against ~10 us of bf16 tensor-core work (QK, and PV twice).
//
// Numerics. Both products run on bf16 tensor cores (mma.sync m16n8k16, f32
// accumulators) and stay the reference's f32 function up to summation
// order: q is bf16 and a bf16 or int8 key is exact in bf16, so QK forms
// every product exactly; p (times vs[k] for int8) is split into
// p_hi = bf16(p) and p_lo = bf16(p - p_hi), and PV runs once with each
// against the same exact bf16 V, which leaves p off by at most 2^-18 of
// itself. int8 widens to bf16 exactly (-128..127) through an f32 magic
// number. The softmax runs in the log2 domain (ex2); K2p converts m back
// to natural-log units, and an inert m stays exactly -1e30.
//
// Design. The products are transposed so that cache slots fill the 16-row
// M side of the mma and the G <= 8 query heads of a KV head its 8-wide N
// side: S^T = K Q^T, then O^T += V^T P^T, with P^T's fragments made from
// S^T's accumulators by movmatrix.trans. Pass 1: one block per (512-slot
// split, KV head, batch row); the split count comes from C, so a fill on
// the device needs no host read. A split past the fill exits at once (the
// merge never reads it); a split that sees no slot below it writes an
// inert partial (m = -1e30, l = 0, o = 0) and loads nothing. Inside a
// block the four warps split the 512 slots (128 each). A warp streams its
// own 16-slot K/V tiles (and scales) through its own cp.async ring in
// shared memory, so the loop has no block-wide barrier, and keeps its own
// online softmax in registers on the accumulator fragments, reduced over
// the 8 lanes of a column with shuffles. Only visible slots are copied; the
// rest of a tile is zero-filled, so nothing at or past C, or outside a
// warp's range, is read. Q is staged with 16-byte loads while the first
// tiles are in flight. After the loop the warps' (o, m, l) merge through
// shared memory into the split's partial. Pass 2 merges a row's splits up
// to the fill's with the log-sum-exp algebra, one warp per (query head, KV
// head, batch row): lanes over splits for m and the splits' factors, lanes
// over head dims for o, which pairs of lanes sum over chunks of two splits
// (so a lane keeps sixteen 16-byte loads in flight), l and o summed in
// split order within a chunk and in chunk order across chunks. K2 and K2p run
// the same two passes in the same order and differ only in what pass 2
// writes. Offsets into the cache are 64-bit: the stacked int8 cache passes
// 2^31 elements at the pipeline's long bucket.
// Not done: TMA, wgmma (64-row tiles would pad G <= 8 to 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// head_dim is a template parameter HD: 128 or 256 (the entry points refuse
// any other; K2p takes 128 only)
constexpr int SPLIT = 512;          // cache slots per pass-1 block
constexpr int NWARPS = 4;           // warps that share a split's slots
constexpr int NTHREADS = NWARPS * 32;
constexpr int WSLOTS = SPLIT / NWARPS;  // slots of one warp
constexpr int BK = 16;              // slots per tile: one m16 tile
constexpr int ROWS = 8;             // query heads of a KV head: one n8 tile
constexpr int MERGE_CHUNK = 2;      // splits a merge lane group sums in order
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One warp's ring of K/V tiles in shared memory. Slot rows are padded by 16
// bytes, so the fragment loads below are free of bank conflicts.
template <int HD, bool Q8>
struct Ring {
  static constexpr int ROW = Q8 ? HD + 16 : 2 * HD + 16;      // bytes of a slot row
  static constexpr int STAGES = Q8 ? 3 : 2;
  static constexpr int KV_BYTES = BK * ROW;                    // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES + (Q8 ? 2 * BK * 4 : 0);  // K, V, ks, vs
  static constexpr int WARP = STAGES * STAGE;
};

// Dynamic shared memory of a pass-1 block: Q (rows of QROW bf16, padded),
// the rings (after the loop, the warps' o), the warps' m and l. At HD = 256
// a bf16 block takes ~137 KB, so one block a SM.
template <int HD, bool Q8>
struct Layout {
  static constexpr int QROW = HD + 8;
  static constexpr int Q_BYTES = ROWS * QROW * 2;
  static constexpr int RING_BYTES = NWARPS * Ring<HD, Q8>::WARP;
  static constexpr int OBUF_BYTES = NWARPS * ROWS * HD * 4;
  static constexpr int BODY = RING_BYTES > OBUF_BYTES ? RING_BYTES : OBUF_BYTES;
  static constexpr int SMEM = Q_BYTES + BODY + 2 * NWARPS * ROWS * 4;
};

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

// the transpose of an 8x8 bf16 matrix held in the mma fragment layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

__device__ __forceinline__ uint4 lds128(const void *p) {
  return *reinterpret_cast<const uint4 *>(p);
}

// 16 bytes global -> shared; zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void *dst, const void *src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void *dst, const void *src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four int8 (one word, byte 0 first) -> bf16x2 of bytes (0, 1) and of
// bytes (2, 3), exact: 2^23 + (x + 128) is built in an f32's bits, 2^23 + 128
// subtracted, and an integer of at most 8 bits keeps its bf16 upper half
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

// The k position (0..HD) of head dim d in QK's contraction. bf16 keys
// take the natural order (their fragments come by ldmatrix); for an int8
// key, lane (gid, tig) reads HD / 4 contiguous bytes of a slot row, dims
// HD / 4 tig .. HD / 4 (tig + 1) - 1, and bytes (0, 1) and (2, 3) of word kk
// of them hold the k positions (2 tig, 2 tig + 1) and (2 tig + 8, 2 tig + 9)
// of k tile kk. Q is stored in shared memory in this order, so its
// fragments come by plain ldmatrix.
template <int HD, bool Q8>
__device__ __forceinline__ int k_pos(int d) {
  if (!Q8) return d;
  const int byte = d & 3;
  return 16 * ((d >> 2) % (HD / 16)) + 2 * (d / (HD / 4)) + (byte & 1) + 8 * (byte >> 1);
}

// The head dims of O^T's accumulator rows gid (first) and gid + 8 (second)
// in m tile mt. bf16 values come by ldmatrix.trans in the natural order; an
// int8 lane reads HD / 8 contiguous bytes of a slot row, dims HD / 8 gid ..
// HD / 8 (gid + 1) - 1.
template <int HD, bool Q8>
__device__ __forceinline__ int o_dim(int mt, int gid, int second) {
  return Q8 ? HD / 8 * gid + 2 * mt + second : 16 * mt + gid + 8 * second;
}

// the batch's last valid slot: the device's, clamped to [0, C - 1], or the host's
__device__ __forceinline__ int read_fill(const int *fill_dev, int fill_host, int C) {
  return fill_dev ? min(max(*fill_dev, 0), C - 1) : fill_host;
}

template <int HD, bool Q8>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_split_kernel(const __nv_bfloat16 *__restrict__ q,  // [B, 1, H, HD]
                          const void *__restrict__ k_all,       // [L, B, KV, C, HD]
                          const void *__restrict__ v_all,
                          const float *__restrict__ ks_all,     // [L, B, KV, C] (int8 only)
                          const float *__restrict__ vs_all,
                          const int *__restrict__ pad_lens,     // [B]
                          const int *__restrict__ fill_dev,     // [1] or null
                          float *__restrict__ o_part,           // [B, KV, NS, G, HD]
                          float *__restrict__ m_part,           // [B, KV, NS, G] (log2 domain)
                          float *__restrict__ l_part,
                          int B, int H, int KV, int C, int layer, int fill_host, int window,
                          float scale_log2) {
  using RG = Ring<HD, Q8>;
  using LY = Layout<HD, Q8>;
  constexpr int QROW = LY::QROW;
  constexpr int ELEM = Q8 ? 1 : 2;  // bytes of a cache element
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16 *qs = reinterpret_cast<__nv_bfloat16 *>(smem);   // [ROWS][QROW]
  unsigned char *ring = smem + LY::Q_BYTES;                        // [NWARPS][Ring]
  float *obuf = reinterpret_cast<float *>(ring);   // [NWARPS][ROWS][HD], after the loop
  float *ms = reinterpret_cast<float *>(ring + LY::BODY);  // [NWARPS][ROWS]
  float *ls = ms + NWARPS * ROWS;

  const int G = H / KV;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int gid = lane >> 2;  // fragment row within the 8-row group
  const int tig = lane & 3;   // thread in group: fragment column pair

  const int fill = read_fill(fill_dev, fill_host, C);
  if (split * SPLIT > fill) return;  // past the fill: the merge never reads it
  // the slots this block may read: its split, from the row's pad (and the
  // window floor) to the fill
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

  // this thread's two query heads (columns of S^T and O^T): 2 tig and 2 tig
  // + 1; a column past G is padding and sees no slot
  const bool head_ok[2] = {2 * tig < G, 2 * tig + 1 < G};

  // this warp's slots: a quarter of the split, within [lo, hi]
  const int w0 = split * SPLIT + warp * WSLOTS;
  const int w_lo = max(lo, w0);
  const int w_hi = min(hi, w0 + WSLOTS - 1);
  const int k_first = (w_lo / BK) * BK;
  const int n_tiles = w_lo <= w_hi ? (w_hi - k_first) / BK + 1 : 0;

  const size_t slot_base =
      ((static_cast<size_t>(layer) * B + b) * KV + kv) * static_cast<size_t>(C);
  const unsigned char *kbytes = static_cast<const unsigned char *>(k_all);
  const unsigned char *vbytes = static_cast<const unsigned char *>(v_all);
  unsigned char *my_ring = ring + warp * RG::WARP;

  // one tile's K and V rows (16-byte chunks) and, for int8, its scales
  // (lanes 0-15 ks, 16-31 vs); slots outside [w_lo, w_hi] are zero-filled
  auto load_tile = [&](int tile) {
    unsigned char *st = my_ring + (tile % RG::STAGES) * RG::STAGE;
    const int k0 = k_first + tile * BK;
    constexpr int CH = HD * ELEM / 16;  // chunks per slot row
#pragma unroll
    for (int i = lane; i < BK * CH; i += 32) {
      const int row = i / CH, c = i % CH;
      const int slot = k0 + row;
      const bool ok = slot >= w_lo && slot <= w_hi;
      const size_t off = (slot_base + (ok ? slot : w_lo)) * (HD * ELEM) + c * 16;
      cp_async16(st + row * RG::ROW + c * 16, kbytes + off, ok);
      cp_async16(st + RG::KV_BYTES + row * RG::ROW + c * 16, vbytes + off, ok);
    }
    if (Q8) {
      const int slot = k0 + (lane & 15);
      const bool ok = slot >= w_lo && slot <= w_hi;
      const float *src = (lane < 16 ? ks_all : vs_all) + slot_base + (ok ? slot : w_lo);
      cp_async4(st + 2 * RG::KV_BYTES + lane * 4, src, ok);
    }
  };

  // O^T [HD dims (HD / 16 m tiles) x 8 heads]; the softmax state of this
  // thread's two heads, m replicated over the 8 lanes of a column, l partial
  float o[HD / 16][4];
#pragma unroll
  for (int mt = 0; mt < HD / 16; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  // ldmatrix row addresses: lane -> (matrix lane / 8, row lane % 8)
  const int lm_mat = lane >> 3;
  const int lm_row = lane & 7;

#pragma unroll
  for (int s = 0; s < RG::STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // while the first tiles are in flight: the G query heads into shared
  // memory in QK's k order, rows past G zero; 16-byte chunks, each loaded
  // before it is stored
  constexpr int QCH = HD / 8;  // 16-byte chunks of a Q row
  for (int i = t; i < ROWS * QCH; i += NTHREADS) {
    const int r = i / QCH, c = i % QCH;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (r < G) {
      qv = *reinterpret_cast<const uint4 *>(
          q + (static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G + r) * HD + 8 * c);
    }
    const __nv_bfloat16 *e = reinterpret_cast<const __nv_bfloat16 *>(&qv);
#pragma unroll
    for (int y = 0; y < 8; ++y) qs[r * QROW + k_pos<HD, Q8>(8 * c + y)] = e[y];
  }
  __syncthreads();  // Q settled
  for (int tile = 0; tile < n_tiles; ++tile) {
    // the ring's oldest buffer, freed by the __syncwarp that ended the
    // previous tile, takes the tile STAGES - 1 ahead
    if (tile + RG::STAGES - 1 < n_tiles) load_tile(tile + RG::STAGES - 1);
    cp_async_commit();
    cp_async_wait<RG::STAGES - 1>();
    __syncwarp();
    const unsigned char *st = my_ring + (tile % RG::STAGES) * RG::STAGE;
    const unsigned char *Kt = st;
    const unsigned char *Vt = st + RG::KV_BYTES;
    const int k0 = k_first + tile * BK;

    // S^T = K Q^T: 16 slots x 8 heads
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t kw[2][HD / 16];  // int8: HD / 4 bytes of slots gid and gid + 8
    if (Q8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          const uint4 a = lds128(Kt + (gid + 8 * h) * RG::ROW + HD / 4 * tig + 16 * c);
          kw[h][4 * c] = a.x; kw[h][4 * c + 1] = a.y; kw[h][4 * c + 2] = a.z;
          kw[h][4 * c + 3] = a.w;
        }
      }
    }
#pragma unroll
    for (int kk2 = 0; kk2 < HD / 32; ++kk2) {
      uint32_t ka[2][4];  // A fragments of k tiles 2 kk2 and 2 kk2 + 1
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int kk = 2 * kk2 + x;
        if (Q8) {
          widen_int8x4(kw[0][kk], ka[x][0], ka[x][2]);
          widen_int8x4(kw[1][kk], ka[x][1], ka[x][3]);
        } else {
          ldsm_x4(ka[x], Kt + ((lm_mat & 1) * 8 + lm_row) * RG::ROW +
                             (kk * 16 + (lm_mat >> 1) * 8) * 2);
        }
      }
      uint32_t qb[4];  // b0, b1 of k tile 2 kk2; b0, b1 of 2 kk2 + 1
      ldsm_x4(qb, qs + lm_row * QROW + kk2 * 32 + lm_mat * 8);
      mma_bf16(sc, ka[0], qb[0], qb[1]);
      mma_bf16(sc, ka[1], qb[2], qb[3]);
    }

    // online softmax per head (column) in the log2 domain; this lane holds
    // slots gid (elements 0, 1) and gid + 8 (elements 2, 3). l sums the
    // unscaled p; PV takes p * vs
    const int slot0 = k0 + gid, slot1 = k0 + gid + 8;
    const bool vis0 = slot0 >= pad && slot0 <= fill && (window == 0 || slot0 > fill - window);
    const bool vis1 = slot1 >= pad && slot1 <= fill && (window == 0 || slot1 > fill - window);
    float ks0 = 1.f, ks1 = 1.f, vs0 = 1.f, vs1 = 1.f;
    if (Q8) {
      const float *scl = reinterpret_cast<const float *>(st + 2 * RG::KV_BYTES);
      ks0 = scl[gid];
      ks1 = scl[gid + 8];
      vs0 = scl[BK + gid];
      vs1 = scl[BK + gid + 8];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok0 = vis0 && head_ok[e];
      const bool ok1 = vis1 && head_ok[e];
      const float s0 = ok0 ? sc[e] * scale_log2 * ks0 : NEG;
      const float s1 = ok1 ? sc[2 + e] * scale_log2 * ks1 : NEG;
      float mx = fmaxf(s0, s1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m_run[e], mx);
      const float corr = ex2(m_run[e] - m_new);
      m_run[e] = m_new;
      const float p0 = ok0 ? ex2(s0 - m_new) : 0.f;
      const float p1 = ok1 ? ex2(s1 - m_new) : 0.f;
      l_run[e] = l_run[e] * corr + p0 + p1;
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt) {
        o[mt][e] *= corr;
        o[mt][2 + e] *= corr;
      }
      sc[e] = Q8 ? p0 * vs0 : p0;
      sc[2 + e] = Q8 ? p1 * vs1 : p1;
    }

    // P^T fragments, hi and lo: the S^T accumulator of slots gid / gid + 8
    // is the mma layout of an 8x8 (slot, head) matrix; its transpose is the
    // B fragment of P^T (k = slots, n = heads)
    uint32_t ph[2], pl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = sc[2 * h], c = sc[2 * h + 1];
      const uint32_t hiw = pack_bf16(a, c);
      const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162 *>(&hiw);
      const uint32_t low = pack_bf16(a - __low2float(hv), c - __high2float(hv));
      ph[h] = movmatrix_trans(hiw);
      pl[h] = movmatrix_trans(low);
    }

    // O^T += V^T P^T, once with p_hi and once with p_lo
    if (Q8) {
      // slots 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9: HD / 8 bytes each,
      // dims HD / 8 gid .. HD / 8 (gid + 1) - 1, in 16-byte chunks
      uint4 vr[4][HD / 128];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < HD / 128; ++c) {
          vr[j][c] = lds128(Vt + (2 * tig + (j & 1) + 8 * (j >> 1)) * RG::ROW + HD / 8 * gid +
                            16 * c);
        }
      }
#pragma unroll
      for (int w = 0; w < HD / 32; ++w) {
        // A fragments of m tiles 2 w and 2 w + 1 from byte i of word w of
        // each slot (dim HD / 8 gid + 4 w + i = HD / 8 gid + 2 mt + (i & 1)): element
        // (i & 1) + 2 h of m tile 2 w + (i >> 1), for the slot pairs h =
        // (2 tig, 2 tig + 1) and (2 tig + 8, 2 tig + 9); the mma's A order is
        // (row gid, k lo), (row gid + 8, k lo), (row gid, k hi), (row gid + 8, k hi).
        // The two slots' bytes interleave as (d0 s0, d0 s1, d1 s0, d1 s1)
        uint32_t va[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t x0 = (&vr[2 * h][w / 4].x)[w % 4];
          const uint32_t x1 = (&vr[2 * h + 1][w / 4].x)[w % 4];
          uint32_t lo_, hi_;
          widen_int8x4(__byte_perm(x0, x1, 0x5140), lo_, hi_);
          va[0][2 * h] = lo_;
          va[0][2 * h + 1] = hi_;
          widen_int8x4(__byte_perm(x0, x1, 0x7362), lo_, hi_);
          va[1][2 * h] = lo_;
          va[1][2 * h + 1] = hi_;
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint32_t a[4] = {va[x][0], va[x][1], va[x][2], va[x][3]};
          mma_bf16(o[2 * w + x], a, ph[0], ph[1]);
          mma_bf16(o[2 * w + x], a, pl[0], pl[1]);
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt) {
        uint32_t a[4];
        ldsm_x4_trans(a, Vt + ((lm_mat >> 1) * 8 + lm_row) * RG::ROW +
                             (mt * 16 + (lm_mat & 1) * 8) * 2);
        mma_bf16(o[mt], a, ph[0], ph[1]);
        mma_bf16(o[mt], a, pl[0], pl[1]);
      }
    }
    __syncwarp();  // every lane is done with this buffer
  }
  cp_async_wait<0>();

  // the warps' (o, m, l) -> the split's partial, through shared memory
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 4);
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 8);
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 16);
  }
  __syncthreads();  // every warp is done with its ring
  if (gid == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ms[warp * ROWS + 2 * tig + e] = m_run[e];
      ls[warp * ROWS + 2 * tig + e] = l_run[e];
    }
  }
  __syncthreads();
  float *my_o = obuf + warp * ROWS * HD;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int h = 2 * tig + e;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, ms[w * ROWS + h]);
    const float f = ex2(m_run[e] - M);
#pragma unroll
    for (int mt = 0; mt < HD / 16; ++mt) {
      my_o[h * HD + o_dim<HD, Q8>(mt, gid, 0)] = o[mt][e] * f;
      my_o[h * HD + o_dim<HD, Q8>(mt, gid, 1)] = o[mt][2 + e] * f;
    }
  }
  __syncthreads();
  for (int i = t; i < G * HD; i += NTHREADS) {
    float acc = 0.f;
    for (int w = 0; w < NWARPS; ++w) acc += obuf[w * ROWS * HD + i];
    o_part[part * G * HD + i] = acc;
  }
  if (t < G) {
    float M = NEG, L = 0.f;
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, ms[w * ROWS + t]);
    for (int w = 0; w < NWARPS; ++w) L += ls[w * ROWS + t] * ex2(ms[w * ROWS + t] - M);
    m_part[part * G + t] = M;
    l_part[part * G + t] = L;
  }
}

// pass 2: one warp per (query head, KV head, batch row) and 128 of its head
// dims (HD / 128 warps a head), over the splits up to the fill's, in rounds
// of 32: lanes over splits for m and each split's factor and weighted l;
// then each group of MERGE_CHUNK lanes sums a chunk of MERGE_CHUNK splits in
// order (a lane owns 128 / MERGE_CHUNK head dims: that many / 4 independent
// 16-byte loads a split), and the lanes, each owning head dims 4 lane .. 4
// lane + 3 of the warp's 128, add the round's 32 / MERGE_CHUNK chunks to the
// state in order, through shared memory. K2 (PARTIALS false) writes o /
// max(l, 1e-30) as bf16 into `out`; K2p writes the unnormalised f32 state
// into `out` (o), `m_out` (natural-log units) and `l_out`.
template <int HD, bool PARTIALS>
__global__ void __launch_bounds__(128)
flash_decode_merge_kernel(const float *__restrict__ o_part, const float *__restrict__ m_part,
                          const float *__restrict__ l_part, void *__restrict__ out,
                          float *__restrict__ m_out, float *__restrict__ l_out,
                          const int *__restrict__ fill_dev, int fill_host, int B, int H,
                          int KV, int C, int n_split) {
  constexpr int WD = 128;                   // head dims of a warp
  constexpr int GROUPS = 32 / MERGE_CHUNK;  // lane groups: the chunks of a round
  constexpr int DIMS = WD / MERGE_CHUNK;    // head dims of a lane in its group
  __shared__ float4 chunk_o[4][GROUPS][WD / 4];  // a warp's round of chunk partials
  __shared__ float chunk_l[4][GROUPS];
  const int warp = threadIdx.x >> 5;
  const int unit = blockIdx.x * 4 + warp;
  if (unit >= B * H * (HD / WD)) return;
  const int head = unit / (HD / WD);       // b * H + kv * G + g
  const int d0 = unit % (HD / WD) * WD;    // the warp's first head dim
  const int lane = threadIdx.x & 31;
  const int grp = lane / MERGE_CHUNK, sub = lane % MERGE_CHUNK;
  const int G = H / KV;
  const int b = head / H, kv = (head % H) / G, g = head % G;
  const int n_live = read_fill(fill_dev, fill_host, C) / SPLIT + 1;
  const size_t pair = (static_cast<size_t>(b) * KV + kv) * n_split;
  float m = NEG;
  for (int s = lane; s < n_live; s += 32) m = fmaxf(m, m_part[(pair + s) * G + g]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  // l and o are summed in split order within a chunk and in chunk order
  // across chunks: K2 over the splits up to the fill's then sums what K2p
  // over the leading ones (a multiple of MERGE_CHUNK) and a later merge of
  // its state with further keys sum, in the same order
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n_live; s0 += 32) {
    // this lane's split: its factor and its weighted l
    const int s = s0 + lane;
    const float f = s < n_live ? ex2(m_part[(pair + s) * G + g] - m) : 0.f;
    const float lf = s < n_live ? l_part[(pair + s) * G + g] * f : 0.f;
    // this group's chunk, splits s0 + MERGE_CHUNK grp + i in order; the
    // lane's dims 4 sub + 4 MERGE_CHUNK k, so the group's loads of one split
    // are contiguous; a split past the last adds nothing
    float4 p[DIMS / 4];
#pragma unroll
    for (int k = 0; k < DIMS / 4; ++k) p[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    float pl = 0.f;
#pragma unroll
    for (int i = 0; i < MERGE_CHUNK; ++i) {
      const int j = MERGE_CHUNK * grp + i;
      const float fj = __shfl_sync(0xffffffffu, f, j);
      pl += __shfl_sync(0xffffffffu, lf, j);
      if (s0 + j < n_live) {
        const float *src = o_part + ((pair + s0 + j) * G + g) * HD + d0 + 4 * sub;
        float4 v[DIMS / 4];
#pragma unroll
        for (int k = 0; k < DIMS / 4; ++k) {
          v[k] = *reinterpret_cast<const float4 *>(src + 4 * MERGE_CHUNK * k);
        }
#pragma unroll
        for (int k = 0; k < DIMS / 4; ++k) {
          p[k].x += v[k].x * fj;
          p[k].y += v[k].y * fj;
          p[k].z += v[k].z * fj;
          p[k].w += v[k].w * fj;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < DIMS / 4; ++k) chunk_o[warp][grp][sub + MERGE_CHUNK * k] = p[k];
    if (sub == 0) chunk_l[warp][grp] = pl;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < GROUPS; ++c) {
      const float4 x = chunk_o[warp][c][lane];
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
      l += chunk_l[warp][c];
    }
    __syncwarp();  // the round's slots are free
  }
  if (PARTIALS) {
    *reinterpret_cast<float4 *>(static_cast<float *>(out) + static_cast<size_t>(head) * HD + d0 +
                                4 * lane) = o;
    if (lane == 0 && d0 == 0) {
      m_out[head] = m == NEG ? NEG : m * LN2;  // an inert row stays exactly -1e30
      l_out[head] = l;
    }
  } else {
    const float den = fmaxf(l, 1e-30f);
    uint2 packed;
    packed.x = pack_bf16(o.x / den, o.y / den);
    packed.y = pack_bf16(o.z / den, o.w / den);
    *reinterpret_cast<uint2 *>(static_cast<__nv_bfloat16 *>(out) +
                               static_cast<size_t>(head) * HD + d0 + 4 * lane) = packed;
  }
}

bool bad_shape(int B, int H, int KV, int C, int fill, int window) {
  return KV <= 0 || H % KV != 0 || H / KV > ROWS || B <= 0 || C <= 0 || fill < 0 ||
         fill >= C || window < 0;
}

// Both passes of one call on `st`; returns cudaGetLastError() (0 = launched).
// A block takes more than the 48 KB of shared memory a block gets without
// asking; the attribute is set once per instantiation.
template <int HD, bool Q8, bool PARTIALS>
int launch(const void *q, const void *k, const void *v, const void *ks, const void *vs,
           const void *pad_lens, const void *fill_dev, void *out, void *m_out, void *l_out,
           void *o_part, void *m_part, void *l_part, int B, int H, int KV, int C, int layer,
           int fill, int window, float scale, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_split_kernel<HD, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<HD, Q8>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int n_split = (C + SPLIT - 1) / SPLIT;
  const int *fd = static_cast<const int *>(fill_dev);
  float *op = static_cast<float *>(o_part);
  float *mp = static_cast<float *>(m_part);
  float *lp = static_cast<float *>(l_part);
  flash_decode_split_kernel<HD, Q8>
      <<<dim3(n_split, KV, B), NTHREADS, Layout<HD, Q8>::SMEM, st>>>(
      static_cast<const __nv_bfloat16 *>(q), k, v, static_cast<const float *>(ks),
      static_cast<const float *>(vs), static_cast<const int *>(pad_lens), fd, op, mp, lp, B, H,
      KV, C, layer, fill, window, scale * LOG2E);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_merge_kernel<HD, PARTIALS><<<(B * H * (HD / 128) + 3) / 4, 128, 0, st>>>(
      op, mp, lp, out, static_cast<float *>(m_out), static_cast<float *>(l_out), fd, fill, B, H,
      KV, C, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <bool PARTIALS>
int launch_for(int quantized, const void *q, const void *k, const void *v, const void *ks,
               const void *vs, const void *pad_lens, const void *fill_dev, void *out,
               void *m_out, void *l_out, void *o_part, void *m_part, void *l_part, int B, int H,
               int KV, int C, int head_dim, int layer, int fill, int window, float scale,
               void *stream) {
  // a fill on the device is clamped there; the host's must lie in the cache.
  // K2 takes head_dim 128 and 256, K2p 128 only
  if (bad_shape(B, H, KV, C, fill_dev ? 0 : fill, window) ||
      !(head_dim == 128 || (head_dim == 256 && !PARTIALS))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VNSUM_DECODE_LAUNCH(HD_, Q8_)                                                          \
  launch<HD_, Q8_, PARTIALS>(q, k, v, Q8_ ? ks : nullptr, Q8_ ? vs : nullptr, pad_lens,       \
                             fill_dev, out, m_out, l_out, o_part, m_part, l_part, B, H, KV, C, \
                             layer, fill, window, scale, st)
  if (head_dim == 256) {
    return quantized ? VNSUM_DECODE_LAUNCH(256, true) : VNSUM_DECODE_LAUNCH(256, false);
  }
  return quantized ? VNSUM_DECODE_LAUNCH(128, true) : VNSUM_DECODE_LAUNCH(128, false);
#undef VNSUM_DECODE_LAUNCH
}

}  // namespace

// Number of pass-1 splits for a cache of C slots; the caller sizes the
// partials with it.
extern "C" int vnsum_flash_decode_splits(int C) { return (C + SPLIT - 1) / SPLIT; }

// Dynamic shared memory of a pass-1 block at head_dim 128 or 256.
extern "C" int vnsum_flash_decode_smem(int quantized, int head_dim) {
  if (head_dim == 256) return quantized ? Layout<256, true>::SMEM : Layout<256, false>::SMEM;
  return quantized ? Layout<128, true>::SMEM : Layout<128, false>::SMEM;
}

// Plain C entry points, loaded with ctypes. Each launches both passes on
// `stream` and returns cudaGetLastError() (0 = launched). `fill_dev` is a
// device int32 fill, or null to take `fill`. `o_part`, `m_part` and
// `l_part` are f32 scratch of [B, KV, splits, G, HD] and [B, KV, splits, G].

// K2: `out` [B, 1, H, HD] bf16, normalised.
extern "C" int vnsum_flash_decode(const void *q, const void *k, const void *v, const void *ks,
                                  const void *vs, const void *pad_lens, const void *fill_dev,
                                  void *out, void *o_part, void *m_part, void *l_part, int B,
                                  int H, int KV, int C, int head_dim, int layer, int fill,
                                  int window, int quantized, float scale, void *stream) {
  return launch_for<false>(quantized, q, k, v, ks, vs, pad_lens, fill_dev, out, nullptr,
                           nullptr, o_part, m_part, l_part, B, H, KV, C, head_dim, layer, fill,
                           window, scale, stream);
}

// K2p: the unnormalised state, `o_out` [B, H, HD], `m_out` and `l_out`
// [B, H], all f32.
extern "C" int vnsum_flash_decode_partials(const void *q, const void *k, const void *v,
                                           const void *ks, const void *vs, const void *pad_lens,
                                           const void *fill_dev, void *o_out, void *m_out,
                                           void *l_out, void *o_part, void *m_part,
                                           void *l_part, int B, int H, int KV, int C,
                                           int head_dim, int layer, int fill, int window,
                                           int quantized, float scale, void *stream) {
  return launch_for<true>(quantized, q, k, v, ks, vs, pad_lens, fill_dev, o_out, m_out, l_out,
                          o_part, m_part, l_part, B, H, KV, C, head_dim, layer, fill, window,
                          scale, stream);
}
