// int8 paged decode attention over the token-major pool (kernel K4).
//
// Replaces videollamb_tpu/ops/gathered_paged_attention.py::
// gathered_paged_attention_int8 (_gathered_kernel). For every slot b and
// query head h, attention of the pre-scaled query over the slot's first
// lengths[b] resident tokens, returning the normalised output and the
// softmax statistics (m, l) that the decode step folds the current token
// into. A length past the table's width (pps x page) is cut to it before
// any page is read, as in the plain version and the TPU grid, which see
// only the table's tokens. A zero-length slot gives out = 0, m = -inf,
// l = 0.
//
// Numerics are the TPU kernel's, per (head, block of T = pages_per_block x
// page tokens):
//   - q quantised per head: rint(q * (127.5 / max(absmax, 1e-30))), saturated;
//   - exact int32 Q.K (__dp4a), dequantised by (qs * ks) / 127.5^2;
//   - probabilities times vs / 127.5, requantised per (head, block) against
//     their absmax, then an exact int32 P.V dequantised by wscale / 127.5.
// The products and sums whose rounding feeds a requantisation use the _rn
// intrinsics, so the compiler contracts none of them into an FMA.
//
// One thing differs: each block takes exp against its own block's max
// m_blk, where the TPU kernel takes the running max m_run of this and the
// earlier blocks. In exact arithmetic that scales every probability of the
// block, and so w and wscale, by the same factor exp(m_run - m_blk); the
// requantised w / wscale, and so the int8 weights, are the same integers,
// and the merge below puts the factor back. In float a rint can flip where
// w * 127.5 / wscale lies on a tie, the same class of difference as the
// one-ulp exp flips that the tolerances already allow.
//
// Bound: about 4 int8 operations a byte, far below the card's ridge, so
// device memory bounds it: sum_b min(lengths[b], pps x page) x H_kv x (256
// bytes of K and V + 8 bytes of scales), each kv head read once whatever
// H / H_kv (81.9 MB at 8 slots of Vicuna-7B over 9665 tokens, 0.0245 ms at
// 3.35 TB/s).
//
// Design (split and merge). The TPU grid walks (slot, block) in order and
// carries m, l and the output in VMEM from block to block; one block per
// (slot, head) walking its slot serially leaves most SMs idle behind the
// longest slot. Here the grid is (H_kv, B, pps / pages_per_block): one block
// owns one kv head and one requantisation block of a slot, exactly one
// (head, block) step of the TPU kernel, for all G = H / H_kv query heads of
// that kv head (G <= 8), so a kv head's bytes are read once. Blocks that
// start at or past the slot's cut length exit at once.
//   - In the token-major pool one kv head's slice of a token is 128
//     contiguous bytes. Tiles of 16 tokens (8 lanes a token, 16 bytes a
//     lane) go through a cp.async ring of STAGES tiles: each copies the
//     tile's K into the ring and its V, k-scales and v-scales into the
//     block's own V slice in shared memory (up to 64 KB at 512 tokens), so
//     V arrives while Q.K, the softmax and the requantisation run. About
//     32 KB a block is in flight, two blocks an SM.
//   - Q.K: each lane reads back the 16 bytes it copied and takes four
//     __dp4a for every query head; three shuffles sum a token's 8 lanes.
//   - P.V: a warp reads four tokens' 128-byte slices of V from shared
//     memory, transposes the bytes in registers and accumulates __dp4a of
//     four tokens at a time for every query head.
// Merge: a slot with one live block writes its result. Otherwise each block
// leaves its normalised partial o_i = acc_i / l_i with (m_i, l_i), and the
// block of a (slot, kv head) that arrives last merges them in block order
// by the log-sum-exp rule (split_merge.cuh), so a call is one launch and
// repeated calls give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_merge.cuh"

namespace {

constexpr int DH = 128;         // head dim: one kv head's slice of a token is 128 bytes
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TT = THREADS / 8;  // tokens a tile: 8 lanes a token
constexpr int STAGES = 8;        // tiles in flight
constexpr int T_MAX = 1024;      // tokens a requantisation block
constexpr int G_MAX = 8;         // query heads a kv head
constexpr int RING_BYTES = STAGES * TT * DH;
constexpr float MAX_INT8 = 127.5f;
static_assert(WARPS == 4, "the block reductions below combine four warps");

struct Params {
  const float* q;          // (B, H, DH), pre-scaled
  const int8_t* k_pool;    // (P, page, H_kv * DH), one layer
  const int8_t* v_pool;
  const float* k_scales;   // (P, page, H_kv)
  const float* v_scales;
  const int* table;        // (B, pps)
  const int* lengths;      // (B,)
  float* out;              // (B, H, DH)
  float* m_out;            // (B, H)
  float* l_out;
  float* part_o;           // (B * H, n_blocks, DH): normalised output of each block
  float2* part_ml;         // (B * H, n_blocks): (m, l) of each block
  unsigned int* counters;  // (B * H_kv), zero between launches
  int h, h_kv, pps, page, block_tokens, n_blocks;
};

__device__ __forceinline__ int8_t sat_int8(float x) {
  // rint half to even, saturate (an absmax element lands on +-127.5 -> +-128).
  float r = rintf(x);
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bytes of dynamic shared memory: V slice, K ring (later the P.V partial
// sums), k- and v-scales, scores (later w), int8 w, int8 q, page ids.
inline size_t smem_bytes(int t, int g, int page) {
  return static_cast<size_t>(t) * DH + RING_BYTES + 8 * static_cast<size_t>(t) +
         5 * static_cast<size_t>(g) * t + static_cast<size_t>(g) * DH +
         4 * static_cast<size_t>(t / page);
}

template <int G>
__global__ void __launch_bounds__(THREADS)
gathered_paged_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_m[WARPS][G], red_l[WARPS][G], red_w[WARPS][G];
  __shared__ float qs_s[G];
  __shared__ int last_flag;
  const int kh = blockIdx.x, b = blockIdx.y, blk = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = p.block_tokens;
  const int len = min(max(p.lengths[b], 0), p.pps * p.page);
  const long long row0 = static_cast<long long>(b) * p.h + kh * G;  // first query head
  if (len == 0) {
    if (blk == 0) {
      for (int i = tid; i < G * DH; i += THREADS) p.out[row0 * DH + i] = 0.0f;
      if (tid < G) {
        p.m_out[row0 + tid] = -INFINITY;
        p.l_out[row0 + tid] = 0.0f;
      }
    }
    return;
  }
  const int n_live = (len + T - 1) / T;
  if (blk >= n_live) return;
  const int n_valid = min(T, len - blk * T);
  const int n_tiles = (n_valid + TT - 1) / TT;
  const int ppb = T / p.page;

  int8_t* v_s = reinterpret_cast<int8_t*>(smem);          // [T][DH]
  int8_t* ring = v_s + static_cast<size_t>(T) * DH;        // [STAGES][TT][DH]
  float* ks_s = reinterpret_cast<float*>(ring + RING_BYTES);  // [T]
  float* vs_s = ks_s + T;                                  // [T]
  float* s_s = vs_s + T;                                   // [G][T]
  int8_t* w8 = reinterpret_cast<int8_t*>(s_s + G * T);     // [G][T]
  int8_t* q8 = w8 + G * T;                                 // [G][DH]
  int* pg_s = reinterpret_cast<int*>(q8 + G * DH);         // [ppb]
  int* part = reinterpret_cast<int*>(ring);                // [WARPS][G][DH], after the ring

  const int* tab = p.table + static_cast<long long>(b) * p.pps + blk * ppb;
  for (int i = tid; i < ppb; i += THREADS) pg_s[i] = tab[i];
  __syncthreads();

  const int kd = p.h_kv * DH;
  const int tok_in_tile = tid >> 3, sub = tid & 7;
  auto issue = [&](int j) {
    if (j < n_tiles) {
      const int tl = j * TT + tok_in_tile;  // token of the block
      const bool ok = tl < n_valid;
      const long long tok =
          ok ? static_cast<long long>(pg_s[tl / p.page]) * p.page + tl % p.page : 0;
      const long long off = tok * kd + kh * DH + sub * 16;
      cp_async16(ring + ((j % STAGES) * TT + tok_in_tile) * DH + sub * 16, p.k_pool + off, ok);
      cp_async16(v_s + tl * DH + sub * 16, p.v_pool + off, ok);
      if (sub == 0) cp_async4(ks_s + tl, p.k_scales + tok * p.h_kv + kh, ok);
      if (sub == 1) cp_async4(vs_s + tl, p.v_scales + tok * p.h_kv + kh, ok);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  // Query heads: warp w quantises heads w, w + WARPS, ... (4 values a lane).
  for (int g = warp; g < G; g += WARPS) {
    const float4 qv = reinterpret_cast<const float4*>(p.q + (row0 + g) * DH)[lane];
    const float qs = fmaxf(warp_max(fmaxf(fmaxf(fabsf(qv.x), fabsf(qv.y)),
                                          fmaxf(fabsf(qv.z), fabsf(qv.w)))), 1e-30f);
    const float qm = __fdiv_rn(MAX_INT8, qs);
    char4 c;
    c.x = sat_int8(__fmul_rn(qv.x, qm));
    c.y = sat_int8(__fmul_rn(qv.y, qm));
    c.z = sat_int8(__fmul_rn(qv.z, qm));
    c.w = sat_int8(__fmul_rn(qv.w, qm));
    reinterpret_cast<char4*>(q8 + g * DH)[lane] = c;
    if (lane == 0) qs_s[g] = qs;
  }
  __syncthreads();
  int4 qw[G];
  float qs[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    qw[g] = reinterpret_cast<const int4*>(q8 + g * DH)[sub];
    qs[g] = qs_s[g];
  }

  // Scores. Each lane reads back only the bytes it copied: no barrier.
  float mloc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mloc[g] = -INFINITY;
  for (int j = 0; j < n_tiles; ++j) {
    issue(j + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    const int tl = j * TT + tok_in_tile;
    const int4 kw = *reinterpret_cast<const int4*>(ring + ((j % STAGES) * TT + tok_in_tile) * DH +
                                                   sub * 16);
    const float ks = ks_s[tl];  // copied by this lane when sub == 0
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int dot = __dp4a(kw.x, qw[g].x, 0);
      dot = __dp4a(kw.y, qw[g].y, dot);
      dot = __dp4a(kw.z, qw[g].z, dot);
      dot = __dp4a(kw.w, qw[g].w, dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (sub == 0 && tl < n_valid) {
        const float sc = __fmul_rn(static_cast<float>(dot),
                                   __fdiv_rn(__fmul_rn(qs[g], ks), MAX_INT8 * MAX_INT8));
        s_s[g * T + tl] = sc;
        mloc[g] = fmaxf(mloc[g], sc);
      }
    }
  }
  cp_async_wait<0>();

  // The block's max, sum and w absmax per query head.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float mw = warp_max(mloc[g]);
    if (lane == 0) red_m[warp][g] = mw;
  }
  __syncthreads();  // also: V, the scales and the scores are in
  float m_blk[G], psum[G], wmax[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_blk[g] = fmaxf(fmaxf(red_m[0][g], red_m[1][g]), fmaxf(red_m[2][g], red_m[3][g]));
    psum[g] = 0.0f;
    wmax[g] = 0.0f;
  }
  for (int tl = tid; tl < n_valid; tl += THREADS) {
    const float vq = __fdiv_rn(vs_s[tl], MAX_INT8);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pr = expf(s_s[g * T + tl] - m_blk[g]);
      psum[g] += pr;
      const float w = __fmul_rn(pr, vq);
      s_s[g * T + tl] = w;
      wmax[g] = fmaxf(wmax[g], fabsf(w));
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float ps = warp_sum(psum[g]);
    const float wm = warp_max(wmax[g]);
    if (lane == 0) {
      red_l[warp][g] = ps;
      red_w[warp][g] = wm;
    }
  }
  __syncthreads();
  float l_blk[G], wscale[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l_blk[g] = (red_l[0][g] + red_l[1][g]) + (red_l[2][g] + red_l[3][g]);
    wscale[g] = fmaxf(fmaxf(fmaxf(red_w[0][g], red_w[1][g]), fmaxf(red_w[2][g], red_w[3][g])),
                      1e-30f);
  }
  // Requantise; the tail of the last tile (V zero-filled there) gets w = 0.
  for (int tl = tid; tl < n_tiles * TT; tl += THREADS) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      w8[g * T + tl] =
          tl < n_valid ? sat_int8(__fmul_rn(s_s[g * T + tl], __fdiv_rn(MAX_INT8, wscale[g]))) : 0;
  }
  __syncthreads();

  // P.V: warp w takes token quads w, w + WARPS, ...; lane owns dims 4*lane..+3.
  int o[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) o[g][0] = o[g][1] = o[g][2] = o[g][3] = 0;
  for (int qd = warp; qd * 4 < n_valid; qd += WARPS) {
    int vw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      vw[j] = *reinterpret_cast<const int*>(v_s + (qd * 4 + j) * DH + lane * 4);
    // 4x4 byte transpose: column word j holds dim 4*lane+j of the 4 tokens.
    const unsigned lo01 = __byte_perm(vw[0], vw[1], 0x5140);
    const unsigned hi01 = __byte_perm(vw[0], vw[1], 0x7362);
    const unsigned lo23 = __byte_perm(vw[2], vw[3], 0x5140);
    const unsigned hi23 = __byte_perm(vw[2], vw[3], 0x7362);
    const int c0 = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
    const int c1 = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
    const int c2 = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
    const int c3 = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int wp = *reinterpret_cast<const int*>(w8 + g * T + qd * 4);
      o[g][0] = __dp4a(c0, wp, o[g][0]);
      o[g][1] = __dp4a(c1, wp, o[g][1]);
      o[g][2] = __dp4a(c2, wp, o[g][2]);
      o[g][3] = __dp4a(c3, wp, o[g][3]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<int4*>(part + (warp * G + g) * DH + lane * 4) =
        make_int4(o[g][0], o[g][1], o[g][2], o[g][3]);
  __syncthreads();

  // Thread tid owns column tid of each query head. A live block has a token,
  // whose probability is 1 at the block's max, so its l >= 1.
  const bool single = n_live == 1;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int o_i32 = (part[(0 * G + g) * DH + tid] + part[(1 * G + g) * DH + tid]) +
                      (part[(2 * G + g) * DH + tid] + part[(3 * G + g) * DH + tid]);
    const float acc = __fmul_rn(static_cast<float>(o_i32), __fdiv_rn(wscale[g], MAX_INT8));
    const long long row = row0 + g;
    if (single) {
      p.out[row * DH + tid] = __fdiv_rn(acc, fmaxf(l_blk[g], 1e-30f));
      if (tid == 0) {
        p.m_out[row] = m_blk[g];
        p.l_out[row] = l_blk[g];
      }
    } else {
      p.part_o[(row * p.n_blocks + blk) * DH + tid] = __fdiv_rn(acc, l_blk[g]);
      if (tid == 0) p.part_ml[row * p.n_blocks + blk] = make_float2(m_blk[g], l_blk[g]);
    }
  }
  if (single) return;

  if (!split_merge::arrive_last(p.counters + static_cast<long long>(b) * p.h_kv + kh, n_live,
                                &last_flag))
    return;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long row = row0 + g;
    float mr, lr;
    const float out = split_merge::merge_column(p.part_o + row * p.n_blocks * DH, DH,
                                                p.part_ml + row * p.n_blocks, n_live, tid, mr,
                                                lr);
    p.out[row * DH + tid] = out;
    if (tid == 0) {
      p.m_out[row] = mr;
      p.l_out[row] = lr;
    }
  }
}

template <int G>
int launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.block_tokens, G, p.page);
  cudaError_t err = cudaFuncSetAttribute(gathered_paged_attention_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gathered_paged_attention_kernel<G>
      <<<dim3(p.h_kv, b, p.n_blocks), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, H, 128) f32, pre-scaled; k/v pools: one layer, (P, page, H_kv * 128)
// int8; scales: (P, page, H_kv) f32; table: (B, pps) int32; lengths: (B,)
// int32. Outputs out (B, H, 128), m and l (B, H), all f32. Scratch:
// partials, B * H * n_blocks * 130 f32 (each block's output, then its
// (m, l)), and counters (B * H_kv) uint32, zero on entry and left zero.
// H / H_kv <= 8; block_tokens = pages_per_block * page, a multiple of 16 and
// at most 1024, dividing pps * page; n_blocks = pps * page / block_tokens.
extern "C" int gathered_paged_attention_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
    const void* v_scales, const void* table, const void* lengths, void* out, void* m,
    void* l, void* partials, void* counters, int b, int h, int h_kv, int pps, int page,
    int block_tokens, void* stream) {
  if (h_kv < 1 || h % h_kv != 0 || h / h_kv > G_MAX || page < 1 || block_tokens % 16 != 0 ||
      block_tokens % page != 0 || block_tokens > T_MAX || (pps * page) % block_tokens != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const float*>(q);
  p.k_pool = static_cast<const int8_t*>(k_pool);
  p.v_pool = static_cast<const int8_t*>(v_pool);
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<float*>(out);
  p.m_out = static_cast<float*>(m);
  p.l_out = static_cast<float*>(l);
  p.counters = static_cast<unsigned int*>(counters);
  p.h = h;
  p.h_kv = h_kv;
  p.pps = pps;
  p.page = page;
  p.block_tokens = block_tokens;
  p.n_blocks = pps * page / block_tokens;
  p.part_o = static_cast<float*>(partials);
  p.part_ml =
      reinterpret_cast<float2*>(p.part_o + static_cast<long long>(b) * h * p.n_blocks * DH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h / h_kv) {
    case 1: return launch<1>(p, b, s);
    case 2: return launch<2>(p, b, s);
    case 3: return launch<3>(p, b, s);
    case 4: return launch<4>(p, b, s);
    case 5: return launch<5>(p, b, s);
    case 6: return launch<6>(p, b, s);
    case 7: return launch<7>(p, b, s);
    case 8: return launch<8>(p, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
