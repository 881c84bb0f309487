// bf16 paged decode attention over the head-major pool, keeping the softmax
// statistics (kernel K6).
//
// Replaces videollamb_tpu/ops/paged_attention_stats.py::
// paged_attention_with_stats, which launches the stock TPU paged-attention
// kernel body (jax.experimental.pallas.ops.tpu.paged_attention) and keeps
// the running max m and normaliser l that its public wrapper drops. For
// every slot b and query head, softmax attention of the pre-scaled query
// over the slot's first lengths[b] resident tokens; scores, max, sum and PV
// in f32 from bf16 K and V. A zero-length slot gives out = 0, m = -inf,
// l = 0.
//
// Bound: the work is about 2 G FLOPs a byte of K and V (G = H / H_kv query
// heads share a kv head), far below the card's ridge, so device memory
// bounds it: sum_b lengths[b] x 2 x H_kv x 256 bytes a launch (158.6 MB at
// 8 slots of Vicuna-7B over 9665 tokens, 0.047 ms at 3.35 TB/s).
//
// Design (flash-decoding). The TPU grid walks (slot, kv head, page block)
// in order and carries m, l and the output in VMEM between grid steps; a
// block per (slot, kv head) walking its slot serially leaves most SMs idle
// behind the longest slot. Here the grid is (H_kv, B, splits): a split is a
// fixed number of tokens, whole pages, and the block of split i of slot b
// attends over tokens [i * split, (i + 1) * split) of it; blocks whose split
// starts past the slot's length exit at once. In a block each warp takes
// every fourth tile of 8 tokens and streams them through its own cp.async
// ring (16-byte copies, four stages): one head's token row is 256
// contiguous bytes of the head-major pool, so a half-warp copies, and later
// reads, one row, 16 bytes a lane, the same 16 bytes each lane copied. The
// G queries sit in registers (8 columns a lane); a score is a dot product
// over the half-warp and four shuffles. Each half-warp keeps its own online
// softmax (m, l and an 8-column accumulator per query head); the halves,
// then the warps (through shared memory) combine by the log-sum-exp rule.
// A slot with one split writes its result; otherwise each block writes its
// split's partial and the last block of the (slot, kv head) to arrive merges
// them (split_merge.cuh), so a call is one launch.
//
// The split is chosen by the wrapper (ops/paged_attention_stats.py); PERF.md
// records the splits timed on the H100.
//
// A length past the table's width (pps x page) is cut to it, as in the plain
// version, so at most `splits` blocks of a (slot, kv head) are live and each
// launch brings its counters back to zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_merge.cuh"

namespace {

constexpr int DH = 128;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TT = 8;          // tokens a tile
constexpr int STAGES = 4;      // tiles a warp's ring holds
constexpr int G_MAX = 8;       // query heads a kv head
constexpr int TILE = TT * DH;  // elements of one K or V tile
constexpr size_t SMEM = static_cast<size_t>(WARPS) * STAGES * 2 * TILE * 2;

struct Params {
  const void* q;                 // (B, H, DH), f32 or bf16, pre-scaled
  const __nv_bfloat16* k_pages;  // (H_kv, P, page, DH)
  const __nv_bfloat16* v_pages;
  const int* table;    // (B, pps)
  const int* lengths;  // (B,)
  void* out;           // (B, H, DH), q's type
  float* m_out;        // (B, H)
  float* l_out;
  float* part_o;    // (B * H, splits, DH): normalised output of each split
  float2* part_ml;  // (B * H, splits): (m, l) of each split
  unsigned int* counters;  // (B * H_kv), zero between launches
  int h, h_kv, total_pages, pps, page, split, splits;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Eight bf16 values (16 bytes of shared memory) as f32.
__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// exp(a - b) for a <= b, 0 where a is -inf and b is not; 1 where both are.
__device__ __forceinline__ float rescale(float a, float b) {
  return b == -INFINITY ? 1.0f : expf(a - b);
}

template <int G, typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_stats_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_flag;
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane >> 4, c = lane & 15;  // token parity, 16-byte column chunk
  const int len = min(max(p.lengths[b], 0), p.pps * p.page);
  const long long row0 = static_cast<long long>(b) * p.h + kh * G;  // first query head
  T* out = static_cast<T*>(p.out);
  if (len == 0) {
    if (sp == 0) {
      for (int i = tid; i < G * DH; i += THREADS) store(out + row0 * DH + i, 0.0f);
      if (tid < G) {
        p.m_out[row0 + tid] = -INFINITY;
        p.l_out[row0 + tid] = 0.0f;
      }
    }
    return;
  }
  const int n_live = (len + p.split - 1) / p.split;
  if (sp >= n_live) return;
  const int s0 = sp * p.split, s1 = min(s0 + p.split, len);

  float qf[G][8];
  const T* q = static_cast<const T*>(p.q) + row0 * DH + 8 * c;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] = to_f32(q[g * DH + e]);

  // This warp's tiles: every WARPS-th of the split's, from tile `warp`.
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) + warp * STAGES * 2 * TILE;
  const int n_tiles = (s1 - s0 + TT - 1) / TT;
  const int n_w = warp < n_tiles ? (n_tiles - 1 - warp) / WARPS + 1 : 0;
  const int* tab = p.table + static_cast<long long>(b) * p.pps;
  const long long head_row0 = static_cast<long long>(kh) * p.total_pages * p.page;
  auto issue = [&](int j) {
    if (j < n_w) {
      const int t0 = s0 + (warp + WARPS * j) * TT;
      __nv_bfloat16* kdst = ring + (j % STAGES) * 2 * TILE;
#pragma unroll
      for (int i = 0; i < TT / 2; ++i) {
        const int tok = 2 * i + half, t = t0 + tok;
        const bool ok = t < s1;
        const long long row =
            ok ? head_row0 + static_cast<long long>(tab[t / p.page]) * p.page + t % p.page : 0;
        const int at = tok * DH + 8 * c;
        cp_async16(smem_addr(kdst + at), p.k_pages + row * DH + 8 * c, ok);
        cp_async16(smem_addr(kdst + TILE + at), p.v_pages + row * DH + 8 * c, ok);
      }
    }
    cp_async_commit();
  };

  // Online softmax of this half-warp's tokens: m, l and columns 8c..8c+7.
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.0f;
  }

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);
  for (int j = 0; j < n_w; ++j) {
    issue(j + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // tile j is in; each lane reads only what it copied
    const __nv_bfloat16* kt = ring + (j % STAGES) * 2 * TILE;
    const int t0 = s0 + (warp + WARPS * j) * TT;
    float s[TT / 2][G];
#pragma unroll
    for (int i = 0; i < TT / 2; ++i) {
      const int tok = 2 * i + half;
      float kf[8];
      load8(kf, kt + tok * DH + 8 * c);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        s[i][g] = t0 + tok < s1 ? d : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = -INFINITY;
#pragma unroll
      for (int i = 0; i < TT / 2; ++i) mt = fmaxf(mt, s[i][g]);
      const float mn = fmaxf(m[g], mt);
      const float corr = rescale(m[g], mn);
      m[g] = mn;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int i = 0; i < TT / 2; ++i) {
        s[i][g] = mn == -INFINITY ? 0.0f : expf(s[i][g] - mn);
        l[g] += s[i][g];
      }
    }
#pragma unroll
    for (int i = 0; i < TT / 2; ++i) {
      float vf[8];
      load8(vf, kt + TILE + (2 * i + half) * DH + 8 * c);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(s[i][g], vf[e], acc[g][e]);
    }
  }
  cp_async_wait<0>();

  // The two halves of the warp, then the warps, by the log-sum-exp rule.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float mo = __shfl_xor_sync(0xffffffffu, m[g], 16);
    const float lo = __shfl_xor_sync(0xffffffffu, l[g], 16);
    const float mn = fmaxf(m[g], mo);
    const float a = mn == -INFINITY ? 0.0f : expf(m[g] - mn);
    const float bo = mn == -INFINITY ? 0.0f : expf(mo - mn);
    m[g] = mn;
    l[g] = l[g] * a + lo * bo;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], 16) * bo;
  }
  __syncthreads();  // every warp is done with its ring: reuse it
  float* wacc = reinterpret_cast<float*>(smem);  // [WARPS][G][DH]
  float* wm = wacc + WARPS * G * DH;              // [WARPS][G]
  float* wl = wm + WARPS * G;
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) wacc[(warp * G + g) * DH + 8 * c + e] = acc[g][e];
    if (c == 0)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
  }
  __syncthreads();

  // Thread tid owns column tid of each query head. A live split has a token,
  // so its l >= 1.
  const bool single = n_live == 1;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, wm[w * G + g]);
    float lb = 0.0f, ob = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float x = wm[w * G + g] == -INFINITY ? 0.0f : expf(wm[w * G + g] - mb);
      lb += wl[w * G + g] * x;
      ob += wacc[(w * G + g) * DH + tid] * x;
    }
    const long long row = row0 + g;
    if (single) {
      store(out + row * DH + tid, ob / lb);
      if (tid == 0) {
        p.m_out[row] = mb;
        p.l_out[row] = lb;
      }
    } else {
      p.part_o[(row * p.splits + sp) * DH + tid] = ob / lb;
      if (tid == 0) p.part_ml[row * p.splits + sp] = make_float2(mb, lb);
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
    const float o = split_merge::merge_column(p.part_o + row * p.splits * DH, DH,
                                              p.part_ml + row * p.splits, n_live, tid, mr, lr);
    store(out + row * DH + tid, o);
    if (tid == 0) {
      p.m_out[row] = mr;
      p.l_out[row] = lr;
    }
  }
}

template <int G, typename T>
int launch(const Params& p, int b, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(paged_attention_stats_kernel<G, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attention_stats_kernel<G, T>
      <<<dim3(p.h_kv, b, p.splits), THREADS, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int b, int g, cudaStream_t s) {
  switch (g) {
    case 1: return launch<1, T>(p, b, s);
    case 2: return launch<2, T>(p, b, s);
    case 3: return launch<3, T>(p, b, s);
    case 4: return launch<4, T>(p, b, s);
    case 5: return launch<5, T>(p, b, s);
    case 6: return launch<6, T>(p, b, s);
    case 7: return launch<7, T>(p, b, s);
    case 8: return launch<8, T>(p, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, 128) pre-scaled, f32 (q_bf16 = 0) or bf16; k/v pages: one layer,
// (H_kv, P, page, 128) bf16; table: (B, pps) int32; lengths: (B,) int32.
// Outputs: out (B, H, 128) in q's type, m and l (B, H) f32. Scratch:
// partials, B * H * splits * 130 f32 (each split's output, then its (m, l)),
// and counters (B * H_kv) uint32, zero on entry and left zero. H / H_kv <= 8;
// split: tokens a block, a multiple of page; splits = ceil(pps * page / split).
extern "C" int paged_attention_stats(const void* q, int q_bf16, const void* k_pages,
                                     const void* v_pages, const void* table,
                                     const void* lengths, void* out, void* m, void* l,
                                     void* partials, void* counters, int b, int h, int h_kv,
                                     int total_pages, int pps, int page, int split,
                                     void* stream) {
  if (h_kv < 1 || h % h_kv != 0 || h / h_kv > G_MAX || split < 1 || page < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k_pages = static_cast<const __nv_bfloat16*>(k_pages);
  p.v_pages = static_cast<const __nv_bfloat16*>(v_pages);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.m_out = static_cast<float*>(m);
  p.l_out = static_cast<float*>(l);
  p.counters = static_cast<unsigned int*>(counters);
  p.h = h;
  p.h_kv = h_kv;
  p.total_pages = total_pages;
  p.pps = pps;
  p.page = page;
  p.split = split;
  p.splits = (pps * page + split - 1) / split;
  p.part_o = static_cast<float*>(partials);
  p.part_ml = reinterpret_cast<float2*>(p.part_o + static_cast<long long>(b) * h * p.splits * DH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? dispatch<__nv_bfloat16>(p, b, h / h_kv, s) : dispatch<float>(p, b, h / h_kv, s);
}
