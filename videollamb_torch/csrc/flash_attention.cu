// Flash attention forward for the LM prefill (kernel K3).
//
// Replaces videollamb_tpu/ops/flash_attention.py::flash_attention
// (_flash_kernel): for every query row of every (batch, head), online-softmax
// attention over the keys with an optional causal mask (q_pos >= k_pos, both
// counted from 0), an optional per-key validity mask (B, Skv) and, with the
// causal mask, an optional sliding window (q_pos - k_pos < window: Mistral's
// band, which the JAX package leaves to XLA because its Pallas kernel has no
// window). K3's own
// numerics, not K11's: s = (q . k) in f32 times the scale; a running max m
// and sum l per row; p = exp(s - m_running) unnormalised and rounded to bf16
// before PV; the f32 accumulator rescaled by exp(m_old - m_new) when the max
// moves; one division by l at the end. A row with no valid, visible key
// (l == 0) takes the f32 mean of v over all Skv keys of its (batch, head),
// rounded to bf16: the port's contract, which the JAX package's
// _xla_attention gives there. Grouped-query heads are repeated by the caller.
//
// Bound: at the prefill shape (1, 32, 2048, 128), causal with 1400 valid
// keys, the pairs with a valid visible key are 30.9 GFLOP (0.031 ms at 989
// TFLOP/s), above q, k, v and out read or written once (67 MB, 0.020 ms):
// the tensor cores bound it.
//
// Design, on the streaming route of whole_row_attention.cuh and its
// primitives. A block of four warps (one warpgroup) takes 64 query rows of
// one (batch, head); each warp holds its 16 rows' Q fragments, the f32 scores
// of one 64-key tile and the f32 output accumulator (16 x Dh) in registers.
// K and V stream in 64-key tiles through a double-buffered cp.async ring
// (16-byte copies), each tile in 64-column halves of 128-byte rows whose
// 16-byte chunks are XORed with row & 7: the tensor cores' 128-byte swizzle.
// Both products are warpgroup wgmma (m64n64k16, bf16 in, f32 accumulators):
// A from registers (Q, then the scores of each 16-key chunk turned into bf16
// probabilities), B (K, then V transposed) read straight from the swizzled
// tile, so neither ldmatrix nor a score or probability goes through shared
// memory. Tiles are skipped where that is exact: those wholly above the
// block's causal diagonal are never loaded, and those whose 64 keys are all
// masked by k_mask are neither loaded nor multiplied: the block votes on the
// tile's mask bytes (__syncthreads_or, folded into the ring's barrier) one
// tile ahead of its copy. With a window, a block's key loop starts at the
// tile that holds its first row's oldest visible key (row0 - window + 1):
// tiles wholly older than the band are never loaded either, so a windowed
// row block reads about window / 64 + 1 tiles whatever its position. Inside a
// tile that the diagonal, the band's lower edge, the end of the keys or a
// partial mask crosses, keys are masked element by element.
// Causal row blocks with the most keys start first.
//
// A variant with warp-level mma.sync on ldmatrix operands in place of wgmma
// was slower on the H100 at the prefill shape and spilled at its register
// cap (PERF.md, K3's entry).
//
// Layouts come as element strides (batch, head, row) of q / out and of k / v,
// so the (B, S, H, Dh) projections of the LM go through as transposed views,
// without a copy, and the output is written in their layout.

#include "whole_row_attention.cuh"

namespace flash {
namespace {

using whole_row::Args;
using whole_row::GROUP;
using whole_row::KT;
using whole_row::Rows;

constexpr int WARPS = 4;  // a block: one warpgroup, 64 query rows

// Scores of keys whose bit in `bits` (the tile's 64 mask bits) is clear
// become -inf. Element e of n-tile nt of chunk c: key 16 c + 8 nt + 2 t + (e & 1).
__device__ __forceinline__ void key_mask(float (&s)[GROUP][2][4], uint64_t bits, int t) {
#pragma unroll
  for (int c = 0; c < GROUP; ++c)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 16 * c + 8 * nt + 2 * t + (e & 1);
        if (!((bits >> key) & 1ull)) s[c][nt][e] = -INFINITY;
      }
}

// Scores of keys older than the window (row - key >= window) become -inf.
__device__ __forceinline__ void band_mask(float (&s)[2][4], int key0, int rg, int t,
                                          int window) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * nt + 2 * t + (e & 1);
      const int row = rg + (e < 2 ? 0 : 8);
      if (row - key >= window) s[nt][e] = -INFINITY;
    }
}

// Divide by l (summed over the quad here) and store; a row without a valid
// key (l == 0) takes the f32 mean of v over all Skv keys of its head.
template <int DH>
__device__ __forceinline__ void epilogue(float (&o)[DH / 8][4], float l0, float l1, const Args& p,
                                         long long kv_off, long long q_off, const Rows& w) {
  l0 = whole_row::quad_sum(l0);
  l1 = whole_row::quad_sum(l1);
  const int rg = w.row0 + w.g;
  const bool empty0 = rg < p.sq && l0 == 0.0f, empty1 = rg + 8 < p.sq && l1 == 0.0f;
  const float inv0 = l0 == 0.0f ? 1.0f : 1.0f / l0, inv1 = l1 == 0.0f ? 1.0f : 1.0f / l1;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    o[j][0] *= inv0;
    o[j][1] *= inv0;
    o[j][2] *= inv1;
    o[j][3] *= inv1;
  }
  if (__any_sync(0xffffffffu, empty0 || empty1)) {
    // Columns 8 j + 2 t and + 1 of this thread; the eight row groups of the
    // warp take every eighth key, then sum over the groups.
    const __nv_bfloat16* vh = p.v + kv_off;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int key = w.g; key < p.skv; key += 8) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            vh + key * p.kv_row + j * 8 + 2 * w.t));
        a0 += x.x;
        a1 += x.y;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        a0 += __shfl_xor_sync(0xffffffffu, a0, off);
        a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      }
      a0 /= static_cast<float>(p.skv);
      a1 /= static_cast<float>(p.skv);
      if (empty0) {
        o[j][0] = a0;
        o[j][1] = a1;
      }
      if (empty1) {
        o[j][2] = a0;
        o[j][3] = a1;
      }
    }
  }
  whole_row::store_tile<DH>(o, p, q_off, w);
}

constexpr int HALF = KT * 64;  // elements of one 64-column half of a K or V tile

// cp.async a tile of KT rows into its 64-column halves; rows at or past
// `rows_valid` are zero-filled.
template <int DH>
__device__ __forceinline__ void load_halves(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            long long row_stride, int rows_valid) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < KT * CH; i += WARPS * 32) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < rows_valid;
    whole_row::cp_async16(
        whole_row::smem_addr(dst + (c >> 3) * HALF + r * 64 + (((c & 7) ^ (r & 7)) << 3)),
        ok ? src + r * row_stride + c * 8 : src, ok);
  }
}

// Two blocks an SM (64 KB of ring each at Dh 128): at most 255 registers.
template <int DH, bool CAUSAL, bool MASKED>
__global__ void __launch_bounds__(WARPS * 32, 2)
flash_kernel(const Args p, const uint8_t* __restrict__ kmask, int window) {
  constexpr int W = WARPS, NH = DH / 64;
  constexpr int TILE = KT * DH;
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][K, V][NH][HALF]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const float c2 = p.scale_log2;
  const int rb = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int rb0 = rb * W * 16;
  const Rows w{rb0 + warp * 16, lane >> 2, lane & 3};

  int n_kt = (p.skv + KT - 1) / KT;
  if (CAUSAL) n_kt = min(n_kt, (min(p.sq, rb0 + W * 16) - 1) / KT + 1);
  // First tile of the band (window > 0 comes with CAUSAL only).
  const int kt0 = window > 0 ? max(0, rb0 - window + 1) / KT : 0;

  const long long kv_off = b * p.kv_batch + h * p.kv_head;
  const uint8_t* mrow = MASKED ? kmask + static_cast<long long>(b) * p.skv : nullptr;
  // Thread tid < KT votes with the mask byte of key tid of tile kt.
  auto key_byte = [&](int kt) -> int {
    const int key = kt * KT + tid;
    return (MASKED && tid < KT && kt < n_kt && key < p.skv) ? mrow[key] : 0;
  };
  auto fetch = [&](int kt, int live) {
    if (kt < n_kt && live) {
      __nv_bfloat16* dst = ring + (kt & 1) * 2 * TILE;
      const int rows = min(KT, p.skv - kt * KT);
      const long long at = kv_off + static_cast<long long>(kt) * KT * p.kv_row;
      load_halves<DH>(dst, p.k + at, p.kv_row, rows);
      load_halves<DH>(dst + TILE, p.v + at, p.kv_row, rows);
    }
    whole_row::cp_async_commit();
  };

  const long long q_off = b * p.q_batch + h * p.q_head;
  uint32_t qa[DH / 16][4];
  whole_row::load_q_tile<DH>(qa, p, q_off, w);

  float o[NH][32];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hf][i] = 0.0f;
  // Running max (of the unscaled scores) and this thread's share of the sum,
  // for rows g and g + 8; the max is kept equal across the quad.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  int live = MASKED ? __syncthreads_or(key_byte(kt0)) : 1;
  int next_byte = key_byte(kt0 + 1);
  fetch(kt0, live);
  for (int kt = kt0; kt < n_kt; ++kt) {
    // Every warp is done with the stage that tile kt + 1 refills; the vote
    // says whether that tile has a valid key.
    int live_next = 1;
    if (MASKED) {
      live_next = __syncthreads_or(next_byte);
      next_byte = key_byte(kt + 2);
    } else {
      __syncthreads();
    }
    fetch(kt + 1, live_next);
    whole_row::cp_async_wait<1>();
    whole_row::fence_async_smem();
    __syncthreads();
    if (live) {  // uniform over the block: the warpgroup's products are collective
      const uint32_t kbase = whole_row::smem_addr(ring + (kt & 1) * 2 * TILE);
      const uint32_t vbase = kbase + 2 * TILE;
      float s[GROUP][2][4];
      {  // Q K^T for the warpgroup's 64 rows; this warp gets its 16
        float d[32];
        whole_row::wg_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          whole_row::wgmma_n64<0>(
              d, qa[kk], whole_row::sw128_desc(kbase + (kk >> 2) * 2 * HALF + 32 * (kk & 3)), kk);
        whole_row::wg_commit();
        whole_row::wg_wait();
        whole_row::wg_reg_fence(d);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i / 8][(i / 4) % 2][i % 4] = d[i];
      }
#pragma unroll
      for (int c = 0; c < GROUP; ++c) {
        const int k0 = kt * KT + c * 16;
        if (k0 + 16 > p.skv || (CAUSAL && k0 + 15 > w.row0))
          whole_row::mask<CAUSAL>(s[c], k0, w.row0 + w.g, w.t, p.skv);
        if (window > 0 && w.row0 + 15 - k0 >= window)
          band_mask(s[c], k0, w.row0 + w.g, w.t, window);
      }
      if (MASKED) {
        const int a = kt * KT + lane, a2 = a + 32;
        const uint32_t lo = __ballot_sync(0xffffffffu, a < p.skv && mrow[a]);
        const uint32_t hi = __ballot_sync(0xffffffffu, a2 < p.skv && mrow[a2]);
        const uint64_t bits = lo | (static_cast<uint64_t>(hi) << 32);
        if (bits != ~0ull) key_mask(s, bits, w.t);
      }
      float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
      for (int c = 0; c < GROUP; ++c)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mt0 = fmaxf(mt0, fmaxf(s[c][nt][0], s[c][nt][1]));
          mt1 = fmaxf(mt1, fmaxf(s[c][nt][2], s[c][nt][3]));
        }
      const float mn0 = fmaxf(m0, whole_row::quad_max(mt0));
      const float mn1 = fmaxf(m1, whole_row::quad_max(mt1));
      const float mc0 = whole_row::scaled_mc(mn0, c2), mc1 = whole_row::scaled_mc(mn1, c2);
      // exp(scale (m_old - m_new)); 0 while a row has seen no valid key.
      const float cr0 = whole_row::exp_s(m0, c2, mc0), cr1 = whole_row::exp_s(m1, c2, mc1);
      m0 = mn0;
      m1 = mn1;
      l0 *= cr0;
      l1 *= cr1;
#pragma unroll
      for (int hf = 0; hf < NH; ++hf)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[hf][i] *= (i & 2) ? cr1 : cr0;
      uint32_t pa[GROUP][4];
#pragma unroll
      for (int c = 0; c < GROUP; ++c) {
        float e[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          e[nt][0] = whole_row::exp_s(s[c][nt][0], c2, mc0);
          e[nt][1] = whole_row::exp_s(s[c][nt][1], c2, mc0);
          e[nt][2] = whole_row::exp_s(s[c][nt][2], c2, mc1);
          e[nt][3] = whole_row::exp_s(s[c][nt][3], c2, mc1);
          l0 += e[nt][0] + e[nt][1];
          l1 += e[nt][2] + e[nt][3];
        }
        pa[c][0] = whole_row::pack_bf16(e[0][0], e[0][1]);
        pa[c][1] = whole_row::pack_bf16(e[0][2], e[0][3]);
        pa[c][2] = whole_row::pack_bf16(e[1][0], e[1][1]);
        pa[c][3] = whole_row::pack_bf16(e[1][2], e[1][3]);
      }
      whole_row::wg_fence();  // O += P V, each 64-column half of V in turn
#pragma unroll
      for (int c = 0; c < GROUP; ++c)
#pragma unroll
        for (int hf = 0; hf < NH; ++hf)
          whole_row::wgmma_n64<1>(
              o[hf], pa[c], whole_row::sw128_desc(vbase + hf * 2 * HALF + 128 * 16 * c), 1);
      whole_row::wg_commit();
      whole_row::wg_wait();
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) whole_row::wg_reg_fence(o[hf]);
    }
    live = live_next;
  }
  if (w.row0 >= p.sq) return;

  float of[DH / 8][4];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) of[hf * 8 + i / 4][i % 4] = o[hf][i];
  epilogue<DH>(of, l0, l1, p, kv_off, q_off, w);
}

template <int DH, bool CAUSAL, bool MASKED>
int launch(const Args& p, const uint8_t* kmask, int window, int batch, cudaStream_t stream) {
  const size_t smem = 2ull * 2 * KT * DH * sizeof(__nv_bfloat16);
  const auto kernel = flash_kernel<DH, CAUSAL, MASKED>;
  cudaError_t err = whole_row::prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(static_cast<long long>(batch) * p.heads),
            whole_row::rounds_up(p.sq, WARPS * 16));
  kernel<<<grid, WARPS * 32, smem, stream>>>(p, kmask, window);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int dispatch(const Args& p, const uint8_t* kmask, int window, int batch, bool causal,
             cudaStream_t s) {
  if (kmask != nullptr)
    return causal ? launch<DH, true, true>(p, kmask, window, batch, s)
                  : launch<DH, false, true>(p, kmask, 0, batch, s);
  return causal ? launch<DH, true, false>(p, kmask, window, batch, s)
                : launch<DH, false, false>(p, kmask, 0, batch, s);
}

}  // namespace
}  // namespace flash

// q, out: (B, H, Sq, dh) bf16 with element strides (q_batch, q_head, q_row)
// and a last-dim stride of 1; k, v: (B, H, Skv, dh) bf16 sharing the strides
// (kv_batch, kv_head, kv_row); rows 16-byte aligned. kmask: (B, Skv) bytes
// (0 = masked; bool or uint8) or null. dh in {64, 128}; Sq, Skv >= 1;
// scale > 0 (the wrapper turns another scale into this one); window 0 (none)
// or, with causal, >= 1: a row sees the keys with 0 <= row - key < window.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* kmask, void* out, int b, int heads, int sq,
                                    int skv, int dh, float scale, int causal, int window,
                                    long long q_batch, long long q_head, long long q_row,
                                    long long kv_batch, long long kv_head, long long kv_row,
                                    void* stream) {
  if (!(scale > 0.0f) || window < 0 || (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  whole_row::Args p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.q_batch = q_batch;
  p.q_head = q_head;
  p.q_row = q_row;
  p.kv_batch = kv_batch;
  p.kv_head = kv_head;
  p.kv_row = kv_row;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (sq < 1 || skv < 1 || b < 1 || heads < 1 || !whole_row::aligned(p))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* mask = static_cast<const uint8_t*>(kmask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 128) return flash::dispatch<128>(p, mask, window, b, causal != 0, s);
  if (dh == 64) return flash::dispatch<64>(p, mask, window, b, causal != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
