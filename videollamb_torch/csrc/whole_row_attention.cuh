// Whole-row softmax attention for Hopper, shared by kernels K1, K8 and K11.
//
// Computes, for every query row of every (batch, head), with the TPU
// kernels' numerics: s = (q . k) in f32 times a scale; m = the maximum of s
// over ALL visible keys; p = exp(s - m) / l with l = sum exp(s - m) (l == 0
// counted as 1); p rounded to bf16; o = p V summed in f32 and rounded once
// to bf16. Causal masking, where asked, counts q and k positions from 0.
// (K3 rounds the unnormalised p instead: other rounding, other kernel.)
//
// Layouts come as element strides (batch, head, row) of q / out and of k / v,
// so the packed (B, N, heads * e) projection outputs of K1 and the split
// (B, H, N, e) layout of K8 and K11 both go through without a copy.
//
// Bound: at the tower's shape (256 frames x 16 heads x 257 tokens, e = 64)
// q, k, v read once and out written once are 539 MB, 0.161 ms at 3.35 TB/s,
// above its 69 GFLOP (0.070 ms at 989 TFLOP/s).
//
// Design. No score or probability goes to shared memory: each warp owns 16
// query rows, holds their Q fragments in registers and gets its scores as
// f32 accumulators; the row max and sum are quad shuffles over the
// accumulator layout, and the accumulators of a 16 x 16 score tile become,
// normalised and packed to bf16, the A fragment of the PV product. K and V
// arrive by 16-byte cp.async into rows of 128 bytes (per 64 columns) whose
// 16-byte chunks are XORed with row & 7, free of bank conflicts without
// padding. Two passes over the keys keep the normalisation exact without a
// per-row register array: pass 1 computes the scores and keeps only the
// running (max, sum) per thread, combined over the quad at the end; pass 2
// computes the scores again, forms the normalised probabilities and
// accumulates PV. (Holding a 16 x 272 score row in registers instead, one
// pass, needs 136 f32 a thread; ptxas spilled it at 168 and at 255
// registers, and the spilling kernels ran slower than two passes.)
//
// - Resident route (e = 64, Skv <= 272: all of K1 and K8, and K11 at the
//   tower's shape): one block of four warps, a warpgroup, stages one head's
//   whole K and V (at most 68 KB, three blocks an SM) once, in copy groups
//   of 64 keys that the first round waits for one by one, and walks all the
//   head's 16-row query tiles, four a round. Both products are wgmma
//   (m64n64k16, bf16 in, f32 accumulators): A (Q, then P) from registers, B
//   (K, then V transposed) read by the tensor cores straight from the
//   swizzled tile, so no ldmatrix competes with the exp unit for the
//   shared-memory pipe.
// - Streaming route (e = 128, or Skv > 272): a block of four warps takes 64
//   query rows and streams the head's K and V in 64-key tiles through a
//   double-buffered cp.async ring, so the next tile lands while the current
//   one is multiplied. Its shared memory does not grow with Skv, so the
//   route has no length cap. Products are mma.sync.m16n8k16 (bf16 in, f32
//   accumulators) on ldmatrix operands (.trans for V).
//
// A warp does a group of four 16-key chunks whole or skips it: its products
// are independent accumulator chains that interleave, where a branch around
// each chunk serialises them. Under causal masking both routes skip the
// groups (streamed tiles) wholly above the diagonal and mask element by
// element only those the diagonal crosses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace whole_row {
namespace {  // every including file gets its own kernels

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;  // same layout as q
  int heads, sq, skv;
  long long q_batch, q_head, q_row;     // element strides of q and out
  long long kv_batch, kv_head, kv_row;  // element strides of k and v
  float scale_log2;                     // scale * log2(e) > 0: exp(x) = exp2(x * log2(e))
  int block_rows;                       // query rows per block (resident route)
};

constexpr int WARPS = 4;           // a block: one warpgroup
constexpr int MIN_BLOCKS = 3;      // an SM, which caps a thread at 168 registers
constexpr int RES_DH = 64;         // head dim of the resident route
constexpr int RES_CHUNKS = 17;     // 16-key chunks of a resident head: Skv <= 272
constexpr int RES_MAX_SKV = RES_CHUNKS * 16;
constexpr int RES_MAX_ROUNDS = 5;  // 16-row tiles a resident warp takes per block
constexpr int GROUP = 4;           // 16-key chunks a group
constexpr int KT = GROUP * 16;     // keys a streamed tile: one group

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// The same for an n known only once a loop is unrolled (0 <= n < 10).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    default: cp_async_wait<9>(); break;
  }
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8. Plain: a thread gets row lane / 4, columns 2 * (lane % 4) and + 1;
// transposed: column lane / 4, rows 2 * (lane % 4) and + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row major) * b (16 x 8, bf16, column
// major). a: a[0] row g, columns 2t and + 1; a[1] row g + 8; a[2], a[3] the
// same rows, columns + 8 (g = lane / 4, t = lane % 4). c[0], c[1]: row g,
// columns 2t and + 1; c[2], c[3]: row g + 8.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Element offset of 16-byte chunk `c` of row `r` in a swizzled tile of
// DH-wide rows.
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DH + ((c ^ (r & 7)) << 3);
}

// cp.async rows [r_begin, r_end) of one head into a swizzled tile; rows at or
// past `rows_valid` are zero-filled.
template <int DH, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int r_begin, int r_end,
                                          int rows_valid) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < (r_end - r_begin) * CH; i += THREADS) {
    const int r = r_begin + i / CH, c = i % CH;
    const bool ok = r < rows_valid;
    cp_async16(smem_addr(dst + swz<DH>(r, c)), ok ? src + r * row_stride + c * 8 : src, ok);
  }
}

// A fragment of query columns [col, col + 16) for rows g and g + 8; rows past
// the end are zero.
__device__ __forceinline__ void load_q(uint32_t (&a)[4], const __nv_bfloat16* qg,
                                       const __nv_bfloat16* qg8, bool ok_g, bool ok_g8, int col) {
  a[0] = ok_g ? ldg_u32(qg + col) : 0u;
  a[1] = ok_g8 ? ldg_u32(qg8 + col) : 0u;
  a[2] = ok_g ? ldg_u32(qg + col + 8) : 0u;
  a[3] = ok_g8 ? ldg_u32(qg8 + col + 8) : 0u;
}

// Lane addresses of the ldmatrix operands. A 16-key chunk of K gives the B
// fragments of two 8-key n-tiles for one 16-column k-step: lane l addresses
// key (l & 7) + 8 (l >> 4), chunk 2 kk + ((l >> 3) & 1). A 16-key chunk of V
// (transposed) gives those of two 8-column n-tiles: key (l & 7) + 8 ((l >> 3)
// & 1), chunk 2 j + (l >> 4). Under the swizzle the chunk 2 kk + b of a row
// r with r & 7 == l & 7 lies at 16 * ((2 kk) ^ (b ^ (l & 7))) bytes.
struct Lane {
  uint32_t k_row, v_row;  // byte offsets of this lane's row in a chunk, times DH / 64
  uint32_t k_x, v_x;      // the XOR of its 16-byte chunk index
};

template <int DH>
__device__ __forceinline__ Lane lane_addrs(int lane) {
  Lane a;
  a.k_row = 2 * DH * ((lane & 7) + ((lane >> 4) << 3));
  a.v_row = 2 * DH * ((lane & 7) + (((lane >> 3) & 1) << 3));
  a.k_x = ((lane >> 3) & 1) ^ (lane & 7);
  a.v_x = (lane >> 4) ^ (lane & 7);
  return a;
}

// Scores of keys [krow, krow + 16) of a tile at shared address `kbase` as two
// 16 x 8 accumulators: (DH / 16) k-steps, one ldmatrix.x4 of K each.
template <int DH>
__device__ __forceinline__ void qk_chunk(float (&s)[2][4], const uint32_t (&qa)[DH / 16][4],
                                         uint32_t kbase, int krow, const Lane& ln) {
  const uint32_t row = kbase + ln.k_row + 2 * DH * krow;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, row + (((2 * kk) ^ ln.k_x) << 4));
    mma_16816(s[0], qa[kk], b[0], b[1]);
    mma_16816(s[1], qa[kk], b[2], b[3]);
  }
}

// o (16 x DH) += pa (16 x 16 keys) V[krow, krow + 16).
template <int DH>
__device__ __forceinline__ void pv_chunk(float (&o)[DH / 8][4], const uint32_t (&pa)[4],
                                         uint32_t vbase, int krow, const Lane& ln) {
  const uint32_t row = vbase + ln.v_row + 2 * DH * krow;
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    uint32_t b[4];
    ldsm_x4_t(b, row + (((2 * j) ^ ln.v_x) << 4));
    mma_16816(o[2 * j], pa, b[0], b[1]);
    mma_16816(o[2 * j + 1], pa, b[2], b[3]);
  }
}

// Keys past Skv, or above the diagonal when causal, get a score of -inf.
// Element e of accumulator n-tile `nt` of the chunk at `key0`: key key0 +
// 8 nt + 2t + (e & 1), row rg (e < 2) or rg + 8.
template <bool CAUSAL>
__device__ __forceinline__ void mask(float (&s)[2][4], int key0, int rg, int t, int skv) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * nt + 2 * t + (e & 1);
      const int row = rg + (e < 2 ? 0 : 8);
      if (key >= skv || (CAUSAL && key > row)) s[nt][e] = -INFINITY;
    }
}

// exp(scale (s - m)) as exp2(s c - m c), c = scale * log2(e) > 0; `mc` is
// m c, or 0 where m is -inf (no visible key yet).
__device__ __forceinline__ float scaled_mc(float m, float c) {
  return m == -INFINITY ? 0.0f : m * c;
}
__device__ __forceinline__ float exp_s(float s, float c, float mc) {
  return ex2(fmaf(s, c, -mc));
}

// Maximum and sum over the four threads of a quad (the threads that share a
// row of the accumulator layout).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store_out(const float (&o)[4], __nv_bfloat16* og,
                                          __nv_bfloat16* og8, bool ok_g, bool ok_g8, int col) {
  if (ok_g) *reinterpret_cast<uint32_t*>(og + col) = pack_bf16(o[0], o[1]);
  if (ok_g8) *reinterpret_cast<uint32_t*>(og8 + col) = pack_bf16(o[2], o[3]);
}

// ---------------------------------------------------------------------------
// Warpgroup products (wgmma): the four warps of a block multiply a 64-row A,
// 16 rows from each warp's registers in the mma.sync A-fragment layout, by a
// B tile that the tensor cores read from shared memory through a descriptor;
// the f32 accumulators keep the mma.sync C layout, one 16 x 8 tile per 8
// columns (d[4j + e] is element e of columns 8j to 8j + 7). B tiles are
// swz<64> tiles: rows of 128 bytes whose 16-byte chunks are XORed with
// row & 7, which is the 128-byte swizzle of the tensor cores when the tile
// starts on 1024 bytes. K is read K-major (its rows are the columns of B =
// K^T); V, whose rows are the k index of B, is read MN-major (TRANS_B = 1).

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async writes are made visible to the tensor cores' reads (the async
// proxy) before the barrier that publishes them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The accumulators are not read before wg_wait (a compiler-level fence).
template <int N>
__device__ __forceinline__ void wg_reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a 128-byte-swizzled tile at shared address `addr`: 16-byte
// leading offset (the second 8 k-values of a row), 1024 bytes between groups
// of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x N, f32) = (accumulate ? d : 0) + a (64 x 16, bf16) * B (16 x N).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

// ---------------------------------------------------------------------------
// The two passes over a group of GROUP 16-key chunks. A warp does a group
// whole or skips it: its products are independent accumulator chains that
// interleave, where a branch around each chunk would serialise them. Keys of
// a done group past Skv or above the diagonal are masked.

struct Rows {  // what a warp knows of its 16 query rows
  int row0, g, t;
};

// Scores of the group whose first key is `key0`, from the tile at `kbase`;
// masked keys are -inf.
template <int DH, bool CAUSAL>
__device__ __forceinline__ void group_scores(float (&s)[GROUP][2][4],
                                             const uint32_t (&qa)[DH / 16][4], uint32_t kbase,
                                             int key0, const Rows& w, int skv, const Lane& ln) {
#pragma unroll
  for (int c = 0; c < GROUP; ++c) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][nt][e] = 0.0f;
    qk_chunk<DH>(s[c], qa, kbase, c * 16, ln);
  }
#pragma unroll
  for (int c = 0; c < GROUP; ++c) {
    const int k0 = key0 + c * 16;
    if (k0 + 16 > skv || (CAUSAL && k0 + 15 > w.row0))
      mask<CAUSAL>(s[c], k0, w.row0 + w.g, w.t, skv);
  }
}

// Pass 1: fold the first `nch` chunks of a group's scores into this thread's
// running max and sum (of its own columns; the quad combines them at the
// end). `nch` is a constant once the caller's loops unroll.
struct Stats {
  float m0, m1, l0, l1;  // rows g and g + 8
};

__device__ __forceinline__ void fold(Stats& st, const float (&s)[GROUP][2][4], int nch, float c2) {
  float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
  for (int c = 0; c < GROUP; ++c)
    if (c < nch)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mt0 = fmaxf(mt0, fmaxf(s[c][nt][0], s[c][nt][1]));
        mt1 = fmaxf(mt1, fmaxf(s[c][nt][2], s[c][nt][3]));
      }
  const float mn0 = fmaxf(st.m0, mt0), mn1 = fmaxf(st.m1, mt1);
  const float mc0 = scaled_mc(mn0, c2), mc1 = scaled_mc(mn1, c2);
  st.l0 *= exp_s(st.m0, c2, mc0);
  st.l1 *= exp_s(st.m1, c2, mc1);
#pragma unroll
  for (int c = 0; c < GROUP; ++c)
    if (c < nch)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        st.l0 += exp_s(s[c][nt][0], c2, mc0) + exp_s(s[c][nt][1], c2, mc0);
        st.l1 += exp_s(s[c][nt][2], c2, mc1) + exp_s(s[c][nt][3], c2, mc1);
      }
  st.m0 = mn0;
  st.m1 = mn1;
}

// The row statistics over the quad: exp2 offsets m c and 1 / l.
struct Norm {
  float mc0, mc1, inv0, inv1;
};

__device__ __forceinline__ Norm combine(const Stats& st, float c2) {
  Norm n;
  n.mc0 = scaled_mc(quad_max(st.m0), c2);
  n.mc1 = scaled_mc(quad_max(st.m1), c2);
  const float l0 = quad_sum(st.l0 * exp_s(st.m0, c2, n.mc0));
  const float l1 = quad_sum(st.l1 * exp_s(st.m1, c2, n.mc1));
  n.inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0);
  n.inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
  return n;
}

// The normalised probabilities of a chunk's scores, rounded to bf16, as the A
// fragment of PV.
__device__ __forceinline__ void probs(uint32_t (&pa)[4], const float (&x)[2][4], float c2,
                                      const Norm& n) {
  pa[0] = pack_bf16(exp_s(x[0][0], c2, n.mc0) * n.inv0, exp_s(x[0][1], c2, n.mc0) * n.inv0);
  pa[1] = pack_bf16(exp_s(x[0][2], c2, n.mc1) * n.inv1, exp_s(x[0][3], c2, n.mc1) * n.inv1);
  pa[2] = pack_bf16(exp_s(x[1][0], c2, n.mc0) * n.inv0, exp_s(x[1][1], c2, n.mc0) * n.inv0);
  pa[3] = pack_bf16(exp_s(x[1][2], c2, n.mc1) * n.inv1, exp_s(x[1][3], c2, n.mc1) * n.inv1);
}

template <int DH>
__device__ __forceinline__ void load_q_tile(uint32_t (&qa)[DH / 16][4], const Args& p,
                                            long long q_off, const Rows& w) {
  const int rg = w.row0 + w.g;
  const __nv_bfloat16* qg = p.q + q_off + min(rg, p.sq - 1) * p.q_row;
  const __nv_bfloat16* qg8 = p.q + q_off + min(rg + 8, p.sq - 1) * p.q_row;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    load_q(qa[kk], qg, qg8, rg < p.sq, rg + 8 < p.sq, kk * 16 + 2 * w.t);
}

template <int DH>
__device__ __forceinline__ void store_tile(const float (&o)[DH / 8][4], const Args& p,
                                           long long q_off, const Rows& w) {
  const int rg = w.row0 + w.g;
  __nv_bfloat16* og = p.out + q_off + rg * p.q_row;
  __nv_bfloat16* og8 = og + 8 * p.q_row;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
    store_out(o[j], og, og8, rg < p.sq, rg + 8 < p.sq, j * 8 + 2 * w.t);
}

template <int DH>
__device__ __forceinline__ void zero(float (&o)[DH / 8][4]) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
}

// ---------------------------------------------------------------------------
// Resident route: e = 64, Skv <= 272. Grid (B * H, row blocks); one
// warpgroup a block. K and V stay in shared memory for all the head's query
// rows of the block; each warp takes a 16-row tile per round, and the
// warpgroup's products cover its four tiles.

constexpr int GROUPS = (RES_CHUNKS + GROUP - 1) / GROUP;  // 5: the last holds one chunk

// Rows of the resident K (and V) tile for Skv keys: whole groups, at most
// RES_MAX_SKV.
__host__ __device__ inline int resident_rows(int skv) {
  const int rows = (skv + GROUP * 16 - 1) / (GROUP * 16) * GROUP * 16;
  return rows < RES_MAX_SKV ? rows : RES_MAX_SKV;
}

// Scores of the nch (GROUP or 1) chunks of the group at K row `krow` for the
// warpgroup's rows; this warp's 16 are masked.
template <bool CAUSAL>
__device__ __forceinline__ void group_scores_wg(float (&s)[GROUP][2][4], int nch,
                                                const uint32_t (&qa)[RES_DH / 16][4],
                                                uint32_t kbase, int krow, const Rows& w,
                                                int skv) {
  const uint32_t kg = kbase + 2 * RES_DH * krow;
  if (nch == GROUP) {
    float d[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < RES_DH / 16; ++kk) wgmma_n64<0>(d, qa[kk], sw128_desc(kg + 32 * kk), kk);
    wg_commit();
    wg_wait();
    wg_reg_fence(d);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i / 8][(i / 4) % 2][i % 4] = d[i];
  } else {
    float d[8];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < RES_DH / 16; ++kk) wgmma_n16<0>(d, qa[kk], sw128_desc(kg + 32 * kk), kk);
    wg_commit();
    wg_wait();
    wg_reg_fence(d);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[0][i / 4][i % 4] = d[i];
  }
#pragma unroll
  for (int c = 0; c < GROUP; ++c) {
    const int k0 = krow + c * 16;
    if (c < nch && (k0 + 16 > skv || (CAUSAL && k0 + 15 > w.row0)))
      mask<CAUSAL>(s[c], k0, w.row0 + w.g, w.t, skv);
  }
}

// Pass 2 of a group: its normalised probabilities, rounded to bf16, times V.
__device__ __forceinline__ void group_pv_wg(float (&o)[32], const float (&s)[GROUP][2][4],
                                            int nch, float c2, const Norm& n, uint32_t vbase,
                                            int vrow) {
  uint32_t pa[GROUP][4];
#pragma unroll
  for (int c = 0; c < GROUP; ++c)
    if (c < nch) probs(pa[c], s[c], c2, n);
  wg_fence();
#pragma unroll
  for (int c = 0; c < GROUP; ++c)
    if (c < nch) wgmma_n64<1>(o, pa[c], sw128_desc(vbase + 2 * RES_DH * (vrow + c * 16)), 1);
  wg_commit();
  wg_wait();
  wg_reg_fence(o);
}

template <bool CAUSAL>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
resident_kernel(const Args p) {
  constexpr int DH = RES_DH, W = WARPS;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row_begin = blockIdx.y * p.block_rows;
  const int rows_here = min(p.block_rows, p.sq - row_begin);
  const float c2 = p.scale_log2;

  // Keys this block needs: all of them, or up to its last row when causal.
  // K and V arrive in copy groups of 64 keys, so that the first round starts
  // on the first keys while the rest are in flight; rows past Skv are zero.
  const int res_rows = resident_rows(p.skv);
  const int kv_keys = CAUSAL ? min(p.skv, row_begin + rows_here) : p.skv;
  const int kv_rows = min(res_rows, resident_rows(kv_keys));
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + res_rows * DH;
  const long long kv_off = b * p.kv_batch + h * p.kv_head;
#pragma unroll
  for (int kv = 0; kv < 2; ++kv)
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      load_rows<DH, W * 32>(kv ? vs : ks, (kv ? p.v : p.k) + kv_off, p.kv_row,
                            min(j * GROUP * 16, kv_rows), min((j + 1) * GROUP * 16, kv_rows),
                            p.skv);
      cp_async_commit();
    }
  const uint32_t kbase = smem_addr(ks), vbase = smem_addr(vs);

  const long long q_off = b * p.q_batch + h * p.q_head;
  const int tiles = (rows_here + 15) / 16;
  const int rounds = (tiles + W - 1) / W;
  for (int round = 0; round < rounds; ++round) {
    const Rows w{row_begin + (round * W + warp) * 16, lane >> 2, lane & 3};
    uint32_t qa[DH / 16][4];
    load_q_tile<DH>(qa, p, q_off, w);
    // Groups with a visible key for some row of the warpgroup: the
    // warpgroup's products are done by all four warps or by none.
    const int keys = CAUSAL ? min(kv_keys, row_begin + (round + 1) * W * 16) : kv_keys;
    const int g_end = (keys + GROUP * 16 - 1) / (GROUP * 16);

    // Pass 1. In the first round each copy group is waited for just before
    // its first use.
    Stats st{-INFINITY, -INFINITY, 0.0f, 0.0f};
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      if (round == 0) {
        cp_async_wait_n(2 * GROUPS - 1 - grp);
        fence_async_smem();
        __syncthreads();
      }
      if (grp < g_end) {
        const int nch = min(GROUP, RES_CHUNKS - grp * GROUP);
        float s[GROUP][2][4];
        group_scores_wg<CAUSAL>(s, nch, qa, kbase, grp * GROUP * 16, w, p.skv);
        fold(st, s, nch, c2);
      }
    }
    const Norm nm = combine(st, c2);

    // Pass 2.
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      if (round == 0) {
        cp_async_wait_n(GROUPS - 1 - grp);
        fence_async_smem();
        __syncthreads();
      }
      if (grp < g_end) {
        const int nch = min(GROUP, RES_CHUNKS - grp * GROUP);
        float s[GROUP][2][4];
        group_scores_wg<CAUSAL>(s, nch, qa, kbase, grp * GROUP * 16, w, p.skv);
        group_pv_wg(o, s, nch, c2, nm, vbase, grp * GROUP * 16);
      }
    }
    if (w.row0 < row_begin + rows_here) {
      float of[DH / 8][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) of[i / 4][i % 4] = o[i];
      store_tile<DH>(of, p, q_off, w);
    }
  }
}

// ---------------------------------------------------------------------------
// Streaming route: any Skv, e = 64 or 128. Grid (B * H, Sq / 64 rounded up):
// a block of four warps takes 64 query rows. K (pass 1), then K and V (pass
// 2), pass through a double-buffered ring of 64-key tiles, one group each; a
// warp skips the tiles above its diagonal.

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
stream_kernel(const Args p) {
  constexpr int W = WARPS;
  constexpr int TILE = KT * DH;  // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][K, V][TILE]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Lane ln = lane_addrs<DH>(lane);
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const float c2 = p.scale_log2;
  // Causal row blocks with the most keys go first.
  const int rb = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int rb0 = rb * W * 16;
  const Rows w{rb0 + warp * 16, lane >> 2, lane & 3};

  int n_kt = (p.skv + KT - 1) / KT;
  if (CAUSAL) n_kt = min(n_kt, (min(p.sq, rb0 + W * 16) - 1) / KT + 1);
  // This warp's tiles: those with a visible key for one of its rows.
  const int w_kt = w.row0 >= p.sq ? 0 : CAUSAL ? min(n_kt, w.row0 / KT + 1) : n_kt;

  const long long kv_off = b * p.kv_batch + h * p.kv_head;
  // Step s < n_kt stages K tile s (pass 1); step n_kt + i stages K and V tile i.
  auto fetch = [&](int step) {
    if (step < 2 * n_kt) {
      const int kt = step < n_kt ? step : step - n_kt;
      __nv_bfloat16* dst = ring + (step & 1) * 2 * TILE;
      const int rows = min(KT, p.skv - kt * KT);
      const long long at = kv_off + static_cast<long long>(kt) * KT * p.kv_row;
      load_rows<DH, W * 32>(dst, p.k + at, p.kv_row, 0, KT, rows);
      if (step >= n_kt) load_rows<DH, W * 32>(dst + TILE, p.v + at, p.kv_row, 0, KT, rows);
    }
    cp_async_commit();
  };

  const long long q_off = b * p.q_batch + h * p.q_head;
  uint32_t qa[DH / 16][4];
  load_q_tile<DH>(qa, p, q_off, w);

  Stats st{-INFINITY, -INFINITY, 0.0f, 0.0f};
  fetch(0);
  for (int kt = 0; kt < n_kt; ++kt) {
    fetch(kt + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (kt < w_kt) {
      float s[GROUP][2][4];
      group_scores<DH, CAUSAL>(s, qa, smem_addr(ring + (kt & 1) * 2 * TILE), kt * KT, w, p.skv,
                               ln);
      fold(st, s, GROUP, c2);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  const Norm nm = combine(st, c2);

  float o[DH / 8][4];
  zero<DH>(o);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int step = n_kt + kt;
    fetch(step + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (kt < w_kt) {
      const uint32_t kbase = smem_addr(ring + (step & 1) * 2 * TILE);
      float s[GROUP][2][4];
      group_scores<DH, CAUSAL>(s, qa, kbase, kt * KT, w, p.skv, ln);
#pragma unroll
      for (int c = 0; c < GROUP; ++c) {
        uint32_t pa[4];
        probs(pa, s[c], c2, nm);
        pv_chunk<DH>(o, pa, kbase + 2 * TILE, c * 16, ln);
      }
    }
    __syncthreads();
  }
  if (w.row0 < p.sq) store_tile<DH>(o, p, q_off, w);
}

// ---------------------------------------------------------------------------
// Host side.

inline int rounds_up(int a, int b) { return (a + b - 1) / b; }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Whether (e, Skv) takes the resident route.
inline bool resident(int dh, int skv) { return dh == RES_DH && skv <= RES_MAX_SKV; }

template <bool CAUSAL>
int launch_resident(Args p, int batch, cudaStream_t stream) {
  const size_t smem = 2ull * resident_rows(p.skv) * RES_DH * sizeof(__nv_bfloat16);
  cudaError_t err = prepare(resident_kernel<CAUSAL>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One block per head (up to RES_MAX_ROUNDS tiles a warp); fewer rows a
  // block only where that leaves fewer blocks than MIN_BLOCKS an SM.
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long bh = static_cast<long long>(batch) * p.heads;
  const int tiles = rounds_up(p.sq, 16);
  int rounds = std::min(rounds_up(tiles, WARPS), RES_MAX_ROUNDS);
  while (rounds > 1 && bh * rounds_up(tiles, rounds * WARPS) < 1LL * MIN_BLOCKS * sms) --rounds;
  p.block_rows = rounds * WARPS * 16;
  dim3 grid(static_cast<unsigned>(bh), rounds_up(p.sq, p.block_rows));
  resident_kernel<CAUSAL><<<grid, WARPS * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool CAUSAL>
int launch_stream(Args p, int batch, cudaStream_t stream) {
  const size_t smem = 2ull * 2 * KT * DH * sizeof(__nv_bfloat16);
  cudaError_t err = prepare(stream_kernel<DH, CAUSAL>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(static_cast<long long>(batch) * p.heads),
            rounds_up(p.sq, WARPS * 16));
  stream_kernel<DH, CAUSAL><<<grid, WARPS * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Every pointer and row stride must allow 16-byte copies.
inline bool aligned(const Args& p) {
  const auto a16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  return a16(p.q) && a16(p.k) && a16(p.v) && a16(p.out) && p.kv_row % 8 == 0 &&
         p.kv_head % 8 == 0 && p.kv_batch % 8 == 0 && p.q_row % 2 == 0 && p.q_head % 2 == 0 &&
         p.q_batch % 2 == 0;
}

// dh in {64, 128}; 1 <= Skv; 1 <= Sq.
inline int launch(const Args& p, int batch, int dh, bool causal, cudaStream_t stream) {
  if (p.sq < 1 || p.skv < 1 || batch < 1 || p.heads < 1 || !aligned(p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (resident(dh, p.skv))
    return causal ? launch_resident<true>(p, batch, stream)
                  : launch_resident<false>(p, batch, stream);
  if (dh == 64)
    return causal ? launch_stream<64, true>(p, batch, stream)
                  : launch_stream<64, false>(p, batch, stream);
  if (dh == 128)
    return causal ? launch_stream<128, true>(p, batch, stream)
                  : launch_stream<128, false>(p, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace whole_row
