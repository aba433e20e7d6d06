// Multi-position ("verify") decode attention over the stacked KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vnsum_tpu/ops/decode_attention.py
// (`_verify_kernel`, reached through `flash_spec_verify_attention`). Same
// function: each batch row carries Sq query positions at its OWN cache
// offset fills_b, and query (b, s) attends layer `layer` of the stacked
// cache [L, B, KV, C, hd] under the mask
//   pad_b <= k <= fills_b + s   and   (window == 0 or k > fills_b + s - window).
// The reference is f32 throughout. An int8 cache multiplies the scores by
// ks[k] and, after l has summed the unscaled p, multiplies p by vs[k] before
// PV. A (row, query) that sees no key comes out as 0. The speculative verify
// step calls it with Sq = spec_k + 1, the in-flight slot segment with Sq = 1.
//
// What bounds it on this card: device-memory bytes. A call reads each
// visible K and V slot once for all R = Sq * G query rows of its (row, KV
// head): at the spec shape (B=8, Sq=9, G=3, C=4233, int8) ~67 MB, 20 us at
// 3.35 TB/s, against ~6 us of bf16 tensor-core work (QK, and PV twice);
// at Gemma3-4B's (head_dim 256, KV=4, G=2) ~70 MB on a global layer and
// ~17 MB on a sliding one (window 1024).
//
// Numerics. Both products run on bf16 tensor cores (mma.sync m16n8k16, f32
// accumulators) and stay the reference's f32 function up to summation
// order: q is bf16 and a bf16 or int8 key is exact in bf16, so QK forms
// every product exactly; p (times vs[k] for int8) is split into
// p_hi = bf16(p) and p_lo = bf16(p - p_hi), and PV runs once with each
// against the same exact bf16 V, which leaves p off by at most 2^-18 of
// itself. int8 widens to bf16 exactly (-128..127) through an f32 magic
// number.
//
// Design. The products are transposed so that cache slots fill the 16-row
// M side of the mma and the query rows its 8-wide N side: the slot segment's
// R = 3 rows pad to 8, not 16. S^T = K Q^T, then O^T += V^T P^T, with P^T's
// fragments made from S^T's accumulators by movmatrix.trans. Pass 1: one
// block per (512-slot split, KV head, batch row), as before; the split count
// comes from C, not from the fills, which stay on the device. A split wholly
// past its row's last limit (clamped to C - 1) or below the window floor of
// its first query writes an inert partial (m = -1e30, l = 0, o = 0) and
// loads nothing. Inside a block the four warps split the 512 slots (128
// each) and each takes all R rows (up to 32; above 32 rows the block has
// eight warps, and warps w and w + 4 take the two halves of the rows over
// the same slots). A warp streams its own 16-slot K/V tiles (and scales)
// through its own cp.async ring in shared memory, so the loop needs no
// block-wide barrier, and keeps its own online softmax (log2 domain, ex2)
// in registers on the accumulator fragments, reduced over the 8 lanes of a
// column with shuffles. Only its visible slots are copied; the rest of a
// tile is zero-filled, so nothing at or past C, or outside a warp's range,
// is read. After the loop the warps' (o, m, l) merge through shared memory
// into the block's partial. Pass 2 merges a row's splits with the
// log-sum-exp algebra, one warp per (query row, KV head, batch row), and
// divides by max(l, 1e-30). Offsets into the cache are 64-bit: the stacked
// cache passes 2^31 elements at the pipeline's long bucket.
//
// head_dim is a template parameter HD, 128 or 256 (Gemma3); a warp
// accumulates O over OD = 128 head dims. At 256 a warp's whole O^T would
// take 32 NT registers more, and eight warps with a ring each would pass a
// block's shared memory, so each ring is shared by the two warps that
// cover the same slots (w and w + 4): both copy half of each tile, meet at
// a named barrier (bar.sync, 64 threads) where a warp alone would
// __syncwarp, both form S over all 256 dims and run the same softmax, and
// each accumulates PV over its own 128 dims. QK's second pass costs
// little: the kernel is bound by bytes. At 256 a block takes up to
// Sq * G = 24 rows, in one or three n8 tiles (Gemma3's spec step: 18; its
// slot segment: 2); the merge's warp covers both 128-dim halves.
// Not done: TMA, wgmma (64-row tiles would pad R = 27 to 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OD = 128;             // head dims of O one warp accumulates
constexpr int SPLIT = 512;          // cache slots per pass-1 block
constexpr int QUARTERS = 4;         // warps that share a split's slots
constexpr int WSLOTS = SPLIT / QUARTERS;  // slots of one warp
constexpr int BK = 16;              // slots per tile: one m16 tile
constexpr int MAXG = 8;             // largest GQA group the kernel takes
constexpr int MAXR = 64;            // largest Sq * G the kernel takes at head_dim 128
constexpr int MAXR_WIDE = 24;       // ... and at head_dim 256
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// One ring of K/V tiles in shared memory. Slot rows are padded by 16
// bytes, so the fragment loads below are free of bank conflicts.
template <int HD, bool Q8>
struct Ring {
  static constexpr int ROW = Q8 ? HD + 16 : 2 * HD + 16;      // bytes of a slot row
  static constexpr int STAGES = Q8 ? 3 : 2;
  static constexpr int KV_BYTES = BK * ROW;                    // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES + (Q8 ? 2 * BK * 4 : 0);  // K, V, ks, vs
  static constexpr int SIZE = STAGES * STAGE;
};

// A block of NT n8 tiles of query rows per warp (ROWS = 8 NT), HALVES row
// halves and DPARTS = HD / OD head-dim parts: RCAP = ROWS * HALVES rows,
// RINGS = QUARTERS * HALVES rings, each read by the DPARTS warps that cover
// its slots and rows, RINGS * DPARTS warps. At head_dim 128 every warp has
// a ring of its own (DPARTS = 1); at 256 HALVES = 1 and two warps share one.
template <int HD, bool Q8, int NT, int HALVES>
struct Layout {
  static constexpr int DPARTS = HD / OD;
  static constexpr int QROW = HD + 8;           // padded bf16 row of Q in shared memory
  static constexpr int ROWS = NT * 8;
  static constexpr int RCAP = ROWS * HALVES;
  static constexpr int RINGS = QUARTERS * HALVES;
  static constexpr int NWARPS = RINGS * DPARTS;
  static constexpr int Q_BYTES = RCAP * QROW * 2;
  static constexpr int RING_BYTES = RINGS * Ring<HD, Q8>::SIZE;
  static constexpr int OBUF_BYTES = RINGS * ROWS * HD * 4;    // the merge, over the rings
  static constexpr int BODY = RING_BYTES > OBUF_BYTES ? RING_BYTES : OBUF_BYTES;
  static constexpr int SMEM = Q_BYTES + BODY + 2 * RINGS * ROWS * 4;
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

// the warps that read one ring meet: a warp alone at __syncwarp, the
// DPARTS warps of a shared ring at named barrier 1 + ring (0 is
// __syncthreads'), which also makes each warp's cp.async copies, waited
// for, visible to the other
template <int DPARTS>
__device__ __forceinline__ void ring_sync(int ring_id) {
  if constexpr (DPARTS == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + ring_id), "n"(DPARTS * 32) : "memory");
  }
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
  const unsigned u = d;  // unsigned: the divisions below are shifts
  const int byte = d & 3;
  return 16 * ((u >> 2) % (HD / 16)) + 2 * (u / (HD / 4)) + (byte & 1) + 8 * (byte >> 1);
}

// The head dims, within a warp's OD, of O^T's accumulator rows gid (first)
// and gid + 8 (second) in m tile mt. bf16 values come by ldmatrix.trans in
// the natural order; an int8 lane reads 16 contiguous bytes of a slot row,
// dims 16 gid .. 16 gid + 15 of the warp's part.
template <bool Q8>
__device__ __forceinline__ int o_dim(int mt, int gid, int second) {
  return Q8 ? 16 * gid + 2 * mt + second : 16 * mt + gid + 8 * second;
}

template <int HD, bool Q8, int NT, int HALVES>
__global__ void __launch_bounds__(Layout<HD, Q8, NT, HALVES>::NWARPS * 32)
flash_verify_split_kernel(const __nv_bfloat16 *__restrict__ q,  // [B, Sq, H, HD]
                          const void *__restrict__ k_all,       // [L, B, KV, C, HD]
                          const void *__restrict__ v_all,
                          const float *__restrict__ ks_all,     // [L, B, KV, C] (int8 only)
                          const float *__restrict__ vs_all,
                          const int *__restrict__ pad_lens,     // [B]
                          const int *__restrict__ fills,        // [B]
                          float *__restrict__ o_part,           // [B, KV, NS, R, HD]
                          float *__restrict__ m_part,           // [B, KV, NS, R] (log2 domain)
                          float *__restrict__ l_part,
                          int B, int Sq, int H, int KV, int C, int layer, int window,
                          float scale_log2) {
  using RG = Ring<HD, Q8>;
  using LY = Layout<HD, Q8, NT, HALVES>;
  constexpr int ROWS = LY::ROWS;
  constexpr int RCAP = LY::RCAP;
  constexpr int QROW = LY::QROW;
  constexpr int DPARTS = LY::DPARTS;
  constexpr int NTHREADS = LY::NWARPS * 32;
  constexpr int ELEM = Q8 ? 1 : 2;  // bytes of a cache element
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16 *qs = reinterpret_cast<__nv_bfloat16 *>(smem);   // [RCAP][QROW]
  unsigned char *ring = smem + LY::Q_BYTES;                        // [RINGS][Ring]
  float *obuf = reinterpret_cast<float *>(ring);   // [RINGS][ROWS][HD], after the loop
  float *ms = reinterpret_cast<float *>(ring + LY::BODY);  // [RINGS][ROWS]
  float *ls = ms + LY::RINGS * ROWS;

  const int G = H / KV;
  const int R = Sq * G;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int gid = lane >> 2;  // fragment row within the 8-row group
  const int tig = lane & 3;   // thread in group: fragment column pair
  // this warp's ring (its slots and rows) and its OD head dims of O; with
  // one warp a ring both are known to the compiler
  const int ring_id = DPARTS == 1 ? warp : warp % LY::RINGS;
  const int dpart = DPARTS == 1 ? 0 : warp / LY::RINGS;
  const int quarter = ring_id % QUARTERS;
  const int half = ring_id / QUARTERS;

  // the slots this block may read: its split, from the row's pad (and the
  // window floor of query 0, the lowest of the row's floors) to its last
  // limit, never at or past C
  const int fill = fills[b];
  const int pad = pad_lens[b];
  int lo = max(pad, split * SPLIT);
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

  // this thread's 2 NT query rows (columns of S^T and O^T): r = half * ROWS
  // + nt * 8 + 2 tig + e, each with its last visible slot (-1: a padding row)
  int limit[2 * NT];
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) {
    const int r = half * ROWS + (i >> 1) * 8 + 2 * tig + (i & 1);
    limit[i] = r < R ? fill + r / G : -1;
  }

  // this warp's slots: a quarter of the split, within [lo, hi]
  const int w0 = split * SPLIT + quarter * WSLOTS;
  const int w_lo = max(lo, w0);
  const int w_hi = min(hi, w0 + WSLOTS - 1);
  const int k_first = (w_lo / BK) * BK;
  const int n_tiles = (w_lo <= w_hi && half * ROWS < R) ? (w_hi - k_first) / BK + 1 : 0;

  const size_t slot_base =
      ((static_cast<size_t>(layer) * B + b) * KV + kv) * static_cast<size_t>(C);
  const unsigned char *kbytes = static_cast<const unsigned char *>(k_all);
  const unsigned char *vbytes = static_cast<const unsigned char *>(v_all);
  unsigned char *my_ring = ring + ring_id * RG::SIZE;

  // one tile's K and V rows (16-byte chunks, shared out over the lanes of
  // the ring's DPARTS warps) and, for int8, its scales (the first warp's
  // lanes 0-15 ks, 16-31 vs); slots outside [w_lo, w_hi] are zero-filled
  auto load_tile = [&](int tile) {
    unsigned char *st = my_ring + (tile % RG::STAGES) * RG::STAGE;
    const int k0 = k_first + tile * BK;
    constexpr int CH = HD * ELEM / 16;  // chunks per slot row
#pragma unroll
    for (int i = dpart * 32 + lane; i < BK * CH; i += DPARTS * 32) {
      const int row = i / CH, c = i % CH;
      const int slot = k0 + row;
      const bool ok = slot >= w_lo && slot <= w_hi;
      const size_t off = (slot_base + (ok ? slot : w_lo)) * (HD * ELEM) + c * 16;
      cp_async16(st + row * RG::ROW + c * 16, kbytes + off, ok);
      cp_async16(st + RG::KV_BYTES + row * RG::ROW + c * 16, vbytes + off, ok);
    }
    if (Q8 && dpart == 0) {
      const int slot = k0 + (lane & 15);
      const bool ok = slot >= w_lo && slot <= w_hi;
      const float *src = (lane < 16 ? ks_all : vs_all) + slot_base + (ok ? slot : w_lo);
      cp_async4(st + 2 * RG::KV_BYTES + lane * 4, src, ok);
    }
  };

  // O^T [this warp's OD head dims (8 m tiles) x ROWS rows]; the softmax
  // state of this thread's rows, m replicated over the 8 lanes of a column,
  // l partial
  float o[OD / 16][NT][4];
#pragma unroll
  for (int mt = 0; mt < OD / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) o[mt][nt][0] = o[mt][nt][1] = o[mt][nt][2] = o[mt][nt][3] = 0.f;
  float m_run[2 * NT], l_run[2 * NT];
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
  }

  // ldmatrix row addresses: lane -> (matrix lane / 8, row lane % 8)
  const int lm_mat = lane >> 3;
  const int lm_row = lane & 7;

#pragma unroll
  for (int s = 0; s < RG::STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // while the first tiles are in flight: Q rows r = s * G + g
  // (position-major) into shared memory in QK's k order, rows past R zero,
  // every 16-byte load issued before the first store
  constexpr int QCH = HD / 8;                 // 16-byte chunks of a Q row
  constexpr int QIT = RCAP * QCH / NTHREADS;  // chunks per thread
  static_assert(RCAP * QCH % NTHREADS == 0, "whole Q chunks per thread");
  uint4 qv[QIT];
#pragma unroll
  for (int x = 0; x < QIT; ++x) {
    const int i = t + x * NTHREADS;
    const int r = i / QCH, c = i % QCH;
    qv[x] = make_uint4(0, 0, 0, 0);
    if (r < R) {
      const int s = r / G, g = r % G;
      qv[x] = *reinterpret_cast<const uint4 *>(
          q + ((static_cast<size_t>(b) * Sq + s) * H + static_cast<size_t>(kv) * G + g) * HD +
          8 * c);
    }
  }
#pragma unroll
  for (int x = 0; x < QIT; ++x) {
    const int i = t + x * NTHREADS;
    const int r = i / QCH, c = i % QCH;
    const __nv_bfloat16 *e = reinterpret_cast<const __nv_bfloat16 *>(&qv[x]);
#pragma unroll
    for (int y = 0; y < 8; ++y) qs[r * QROW + k_pos<HD, Q8>(8 * c + y)] = e[y];
  }
  __syncthreads();  // Q settled
  for (int tile = 0; tile < n_tiles; ++tile) {
    // the ring's oldest buffer, freed by the ring_sync that ended the
    // previous tile, takes the tile STAGES - 1 ahead
    if (tile + RG::STAGES - 1 < n_tiles) load_tile(tile + RG::STAGES - 1);
    cp_async_commit();
    cp_async_wait<RG::STAGES - 1>();
    ring_sync<DPARTS>(ring_id);
    const unsigned char *st = my_ring + (tile % RG::STAGES) * RG::STAGE;
    const unsigned char *Kt = st;
    const unsigned char *Vt = st + RG::KV_BYTES;
    const int k0 = k_first + tile * BK;

    // S^T = K Q^T over all HD dims: 16 slots x ROWS rows
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
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
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t qb[4];  // b0, b1 of k tile 2 kk2; b0, b1 of 2 kk2 + 1
        ldsm_x4(qb, qs + (half * ROWS + nt * 8 + lm_row) * QROW + kk2 * 32 + lm_mat * 8);
        mma_bf16(sc[nt], ka[0], qb[0], qb[1]);
        mma_bf16(sc[nt], ka[1], qb[2], qb[3]);
      }
    }

    // online softmax per row (column) in the log2 domain; this lane holds
    // slots gid (elements 0, 1) and gid + 8 (elements 2, 3). l sums the
    // unscaled p; PV takes p * vs
    const int slot0 = k0 + gid, slot1 = k0 + gid + 8;
    const bool live0 = slot0 >= pad && slot0 < C;
    const bool live1 = slot1 >= pad && slot1 < C;
    float ks0 = 1.f, ks1 = 1.f, vs0 = 1.f, vs1 = 1.f;
    if (Q8) {
      const float *scl = reinterpret_cast<const float *>(st + 2 * RG::KV_BYTES);
      ks0 = scl[gid];
      ks1 = scl[gid + 8];
      vs0 = scl[BK + gid];
      vs1 = scl[BK + gid + 8];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * nt + e;
        const int L = limit[i];
        const bool ok0 = live0 && slot0 <= L && (window == 0 || slot0 > L - window);
        const bool ok1 = live1 && slot1 <= L && (window == 0 || slot1 > L - window);
        const float s0 = ok0 ? sc[nt][e] * scale_log2 * ks0 : NEG;
        const float s1 = ok1 ? sc[nt][2 + e] * scale_log2 * ks1 : NEG;
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_run[i], mx);
        const float corr = ex2(m_run[i] - m_new);
        m_run[i] = m_new;
        const float p0 = ok0 ? ex2(s0 - m_new) : 0.f;
        const float p1 = ok1 ? ex2(s1 - m_new) : 0.f;
        l_run[i] = l_run[i] * corr + p0 + p1;
#pragma unroll
        for (int mt = 0; mt < OD / 16; ++mt) {
          o[mt][nt][e] *= corr;
          o[mt][nt][2 + e] *= corr;
        }
        sc[nt][e] = Q8 ? p0 * vs0 : p0;
        sc[nt][2 + e] = Q8 ? p1 * vs1 : p1;
      }
    }

    // P^T fragments, hi and lo: the S^T accumulator of slots gid / gid + 8
    // is the mma layout of an 8x8 (slot, row) matrix; its transpose is the
    // B fragment of P^T (k = slots, n = rows)
    uint32_t ph[NT][2], pl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a = sc[nt][2 * h], c = sc[nt][2 * h + 1];
        const uint32_t hiw = pack_bf16(a, c);
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162 *>(&hiw);
        const uint32_t low = pack_bf16(a - __low2float(hv), c - __high2float(hv));
        ph[nt][h] = movmatrix_trans(hiw);
        pl[nt][h] = movmatrix_trans(low);
      }
    }

    // O^T += V^T P^T over this warp's OD head dims, once with p_hi and
    // once with p_lo
    if (Q8) {
      // slots 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9: 16 bytes each, dims
      // 16 gid .. 16 gid + 15 of the warp's part
      uint4 vr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vr[j] = lds128(Vt + (2 * tig + (j & 1) + 8 * (j >> 1)) * RG::ROW + dpart * OD +
                       16 * gid);
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        // A fragments of m tiles 2 w and 2 w + 1 from byte i of word w of
        // each slot (dim 16 gid + 4 w + i = 16 gid + 2 mt + (i & 1)): element
        // (i & 1) + 2 h of m tile 2 w + (i >> 1), for the slot pairs h =
        // (2 tig, 2 tig + 1) and (2 tig + 8, 2 tig + 9); the mma's A order is
        // (row gid, k lo), (row gid + 8, k lo), (row gid, k hi), (row gid + 8, k hi).
        // The two slots' bytes interleave as (d0 s0, d0 s1, d1 s0, d1 s1)
        uint32_t va[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t x0 = (&vr[2 * h].x)[w], x1 = (&vr[2 * h + 1].x)[w];
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
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_bf16(o[2 * w + x][nt], a, ph[nt][0], ph[nt][1]);
            mma_bf16(o[2 * w + x][nt], a, pl[nt][0], pl[nt][1]);
          }
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < OD / 16; ++mt) {
        uint32_t a[4];
        ldsm_x4_trans(a, Vt + ((lm_mat >> 1) * 8 + lm_row) * RG::ROW +
                             (dpart * OD + mt * 16 + (lm_mat & 1) * 8) * 2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(o[mt][nt], a, ph[nt][0], ph[nt][1]);
          mma_bf16(o[mt][nt], a, pl[nt][0], pl[nt][1]);
        }
      }
    }
    ring_sync<DPARTS>(ring_id);  // every lane of the ring is done with this buffer
  }
  cp_async_wait<0>();

  // the warps' (o, m, l) -> the block's partial, through shared memory
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 4);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 8);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 16);
  }
  __syncthreads();  // every warp is done with its ring
  // the DPARTS warps of a ring ran the same softmax: the first writes it
  if (gid == 0 && dpart == 0) {
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      const int rl = (i >> 1) * 8 + 2 * tig + (i & 1);
      ms[ring_id * ROWS + rl] = m_run[i];
      ls[ring_id * ROWS + rl] = l_run[i];
    }
  }
  __syncthreads();
  float *my_o = obuf + ring_id * ROWS * HD + dpart * OD;
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) {
    const int nt = i >> 1, e = i & 1;
    const int rl = nt * 8 + 2 * tig + e;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < QUARTERS; ++w) M = fmaxf(M, ms[(half * QUARTERS + w) * ROWS + rl]);
    const float f = ex2(m_run[i] - M);
#pragma unroll
    for (int mt = 0; mt < OD / 16; ++mt) {
      my_o[rl * HD + o_dim<Q8>(mt, gid, 0)] = o[mt][nt][e] * f;
      my_o[rl * HD + o_dim<Q8>(mt, gid, 1)] = o[mt][nt][2 + e] * f;
    }
  }
  __syncthreads();
  for (int i = t; i < R * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int h = r / ROWS, rl = r % ROWS;
    float acc = 0.f;
    for (int w = 0; w < QUARTERS; ++w) acc += obuf[((h * QUARTERS + w) * ROWS + rl) * HD + d];
    o_part[part * R * HD + i] = acc;
  }
  for (int r = t; r < R; r += NTHREADS) {
    const int h = r / ROWS, rl = r % ROWS;
    float M = NEG, L = 0.f;
    for (int w = 0; w < QUARTERS; ++w) M = fmaxf(M, ms[(h * QUARTERS + w) * ROWS + rl]);
    for (int w = 0; w < QUARTERS; ++w) {
      const int x = (h * QUARTERS + w) * ROWS + rl;
      L += ls[x] * ex2(ms[x] - M);
    }
    m_part[part * R + r] = M;
    l_part[part * R + r] = L;
  }
}

// pass 2: one warp per (query row, KV head, batch row); lane owns head dims
// 4 lane .. 4 lane + 3 of each 128
template <int HD>
__global__ void __launch_bounds__(128)
flash_verify_merge_kernel(const float *__restrict__ o_part, const float *__restrict__ m_part,
                          const float *__restrict__ l_part, __nv_bfloat16 *__restrict__ out,
                          int B, int Sq, int H, int KV, int n_split) {
  const int G = H / KV;
  const int R = Sq * G;
  const int item = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (item >= B * KV * R) return;
  const int lane = threadIdx.x & 31;
  const int r = item % R;
  const int kv = (item / R) % KV;
  const int b = item / (R * KV);
  const size_t pair = (static_cast<size_t>(b) * KV + kv) * n_split;
  float m = NEG;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, m_part[(pair + s) * R + r]);
  float l = 0.f;
  float4 o[HD / 128];
#pragma unroll
  for (int c = 0; c < HD / 128; ++c) o[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    const float f = ex2(m_part[(pair + s) * R + r] - m);
    l += l_part[(pair + s) * R + r] * f;
#pragma unroll
    for (int c = 0; c < HD / 128; ++c) {
      const float4 v = *reinterpret_cast<const float4 *>(o_part + ((pair + s) * R + r) * HD +
                                                         128 * c + 4 * lane);
      o[c].x += v.x * f;
      o[c].y += v.y * f;
      o[c].z += v.z * f;
      o[c].w += v.w * f;
    }
  }
  const float den = fmaxf(l, 1e-30f);
  const int sq = r / G, g = r % G;
  const size_t q_off =
      ((static_cast<size_t>(b) * Sq + sq) * H + static_cast<size_t>(kv) * G + g) * HD;
#pragma unroll
  for (int c = 0; c < HD / 128; ++c) {
    uint2 packed;
    packed.x = pack_bf16(o[c].x / den, o[c].y / den);
    packed.y = pack_bf16(o[c].z / den, o[c].w / den);
    *reinterpret_cast<uint2 *>(out + q_off + 128 * c + 4 * lane) = packed;
  }
}

// Both passes of one call on `st`; returns cudaGetLastError() (0 = launched).
// A block takes more than the 48 KB of shared memory a block gets without
// asking; the attribute is set once per instantiation.
template <int HD, bool Q8, int NT, int HALVES>
int launch(const __nv_bfloat16 *q, const void *k, const void *v, const void *ks,
           const void *vs, const int *pads, const int *fills, float *op, float *mp, float *lp,
           __nv_bfloat16 *out, int B, int Sq, int H, int KV, int C, int layer, int window,
           float scale_log2, int n_split, cudaStream_t st) {
  using LY = Layout<HD, Q8, NT, HALVES>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(flash_verify_split_kernel<HD, Q8, NT, HALVES>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 LY::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  flash_verify_split_kernel<HD, Q8, NT, HALVES>
      <<<dim3(n_split, KV, B), LY::NWARPS * 32, LY::SMEM, st>>>(
          q, k, v, static_cast<const float *>(ks), static_cast<const float *>(vs), pads, fills,
          op, mp, lp, B, Sq, H, KV, C, layer, window, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = B * KV * Sq * (H / KV);
  flash_verify_merge_kernel<HD><<<(items + 3) / 4, 128, 0, st>>>(op, mp, lp, out, B, Sq, H, KV,
                                                                 n_split);
  return static_cast<int>(cudaGetLastError());
}

// The block for R = Sq * G rows: at head_dim 128 one n8 tile of rows
// (R <= 8), four, or four in each of two row halves; at 256 one or three.
template <int HD, bool Q8>
int smem_of(int R) {
  if constexpr (HD == 256) {
    return R <= 8 ? Layout<HD, Q8, 1, 1>::SMEM : Layout<HD, Q8, 3, 1>::SMEM;
  } else {
    if (R <= 8) return Layout<HD, Q8, 1, 1>::SMEM;
    if (R <= 32) return Layout<HD, Q8, 4, 1>::SMEM;
    return Layout<HD, Q8, 4, 2>::SMEM;
  }
}

template <int HD, bool Q8>
int launch_for(int R, const __nv_bfloat16 *q, const void *k, const void *v, const void *ks,
               const void *vs, const int *pads, const int *fills, float *op, float *mp,
               float *lp, __nv_bfloat16 *out, int B, int Sq, int H, int KV, int C, int layer,
               int window, float scale_log2, int n_split, cudaStream_t st) {
#define VNSUM_VERIFY_LAUNCH(NT_, HALVES_)                                                     \
  launch<HD, Q8, NT_, HALVES_>(q, k, v, ks, vs, pads, fills, op, mp, lp, out, B, Sq, H, KV, C, \
                               layer, window, scale_log2, n_split, st)
  if constexpr (HD == 256) {
    return R <= 8 ? VNSUM_VERIFY_LAUNCH(1, 1) : VNSUM_VERIFY_LAUNCH(3, 1);
  } else {
    if (R <= 8) return VNSUM_VERIFY_LAUNCH(1, 1);
    if (R <= 32) return VNSUM_VERIFY_LAUNCH(4, 1);
    return VNSUM_VERIFY_LAUNCH(4, 2);
  }
#undef VNSUM_VERIFY_LAUNCH
}

// the largest Sq * G the kernel takes at this head_dim; 0 for one it does
// not take
int max_rows(int head_dim) {
  return head_dim == 128 ? MAXR : head_dim == 256 ? MAXR_WIDE : 0;
}

}  // namespace

// Number of pass-1 splits for a cache of C slots; the caller sizes the
// partials with it.
extern "C" int vnsum_flash_verify_splits(int C) { return (C + SPLIT - 1) / SPLIT; }

// Dynamic shared memory of a pass-1 block for R = Sq * G query rows at
// head_dim 128 or 256.
extern "C" int vnsum_flash_verify_smem(int R, int quantized, int head_dim) {
  if (head_dim == 256) return quantized ? smem_of<256, true>(R) : smem_of<256, false>(R);
  return quantized ? smem_of<128, true>(R) : smem_of<128, false>(R);
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
  if (max_rows(head_dim) == 0 || KV <= 0 || H % KV != 0 || H / KV > MAXG || Sq <= 0 ||
      Sq * (H / KV) > max_rows(head_dim) || B <= 0 || C <= 0 || window < 0) {
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
  const float scale_log2 = scale * LOG2E;
#define VNSUM_VERIFY_FOR(HD_, Q8_)                                                            \
  launch_for<HD_, Q8_>(R, qb, k, v, ks, vs, pads, fl, op, mp, lp, ob, B, Sq, H, KV, C, layer, \
                       window, scale_log2, n_split, st)
  if (head_dim == 256) {
    return quantized ? VNSUM_VERIFY_FOR(256, true) : VNSUM_VERIFY_FOR(256, false);
  }
  return quantized ? VNSUM_VERIFY_FOR(128, true) : VNSUM_VERIFY_FOR(128, false);
#undef VNSUM_VERIFY_FOR
}
