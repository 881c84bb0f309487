// bf16 paged decode attention over the head-major pool, keeping the softmax
// statistics (kernel K6).
//
// Replaces videollamb_tpu/ops/paged_attention_stats.py::
// paged_attention_with_stats, which launches the stock TPU paged-attention
// kernel body (jax.experimental.pallas.ops.tpu.paged_attention) and keeps
// the running max m and normaliser l that its public wrapper drops. For
// every slot b and query head, softmax attention of the pre-scaled f32
// query over the slot's first lengths[b] resident tokens; scores, the
// online softmax and the output accumulate in f32 from bf16 K and V.
//
// Design: the TPU grid walks (slot, kv head, page block) in order and
// carries m, l and the output in VMEM between grid steps. Here one block of
// 128 threads owns one (slot, kv head) with its G = H / H_kv query heads and
// walks the slot's pages itself in tiles of 64 tokens. In the head-major
// pool a token's head row is 256 contiguous bytes: for Q.K two threads read
// one token's row (eight 16-byte loads each) against all G queries kept in
// shared memory; for P.V 64 threads read one token's row as bf16 pairs, two
// tokens at a time, and keep the G x 2 accumulators in registers. The work
// is about 2 G FLOPs per byte, far below the card's ridge, so the kernel is
// bound by device memory: sum_b lengths[b] x 2 x H_kv x 256 bytes of K and
// V per launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 128;
constexpr int THREADS = 128;
constexpr int TILE = 64;   // tokens per tile
constexpr int G_MAX = 8;   // query heads per kv head

__global__ void __launch_bounds__(THREADS)
paged_attention_stats_kernel(const float* __restrict__ q,                 // (B, H, DH)
                             const __nv_bfloat16* __restrict__ k_pages,   // (H_kv, P, page, DH)
                             const __nv_bfloat16* __restrict__ v_pages,
                             const int* __restrict__ table,               // (B, pps)
                             const int* __restrict__ lengths,             // (B,)
                             float* __restrict__ out,                     // (B, H, DH)
                             float* __restrict__ m_out,                   // (B, H)
                             float* __restrict__ l_out,
                             int h, int h_kv, int total_pages, int pps, int page) {
  __shared__ float qs[G_MAX][DH];
  __shared__ float p[G_MAX][TILE];
  __shared__ float alpha_s[G_MAX];
  __shared__ float2 merge[G_MAX][DH / 2];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int groups = h / h_kv;
  const int length = lengths[b];
  const long long row0 = static_cast<long long>(b) * h + static_cast<long long>(kh) * groups;
  if (length <= 0) {  // uniform across the block
    for (int i = tid; i < groups * DH; i += THREADS) out[row0 * DH + i] = 0.0f;
    if (tid < groups) {
      m_out[row0 + tid] = -INFINITY;
      l_out[row0 + tid] = 0.0f;
    }
    return;
  }
  for (int i = tid; i < groups * DH; i += THREADS) qs[i / DH][i % DH] = q[row0 * DH + i];

  const int* tab = table + static_cast<long long>(b) * pps;
  const __nv_bfloat16* kbase = k_pages + static_cast<long long>(kh) * total_pages * page * DH;
  const __nv_bfloat16* vbase = v_pages + static_cast<long long>(kh) * total_pages * page * DH;
  const int pair = tid & 63;  // P.V: dims 2*pair, 2*pair+1
  const int half = tid >> 6;  // P.V: tokens of this parity
  float2 acc[G_MAX];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) acc[g] = make_float2(0.0f, 0.0f);
  float m_g[2] = {-INFINITY, -INFINITY}, l_g[2] = {0.0f, 0.0f};  // heads warp, warp + 4
  __syncthreads();

  for (int start = 0; start < length; start += TILE) {
    // Scores: two threads per token, 64 dims each.
    {
      const int tl = tid >> 1;
      const int t = start + tl;
      float dot[G_MAX];
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) dot[g] = 0.0f;
      if (t < length) {
        const long long tok = static_cast<long long>(tab[t / page]) * page + t % page;
        const uint4* src = reinterpret_cast<const uint4*>(kbase + tok * DH + (tid & 1) * 64);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint4 raw = src[c];
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 kf = __bfloat1622float2(k2[j]);
            const int d = (tid & 1) * 64 + c * 8 + j * 2;
#pragma unroll
            for (int g = 0; g < G_MAX; ++g) {
              if (g < groups) dot[g] += qs[g][d] * kf.x + qs[g][d + 1] * kf.y;
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        const float other = __shfl_xor_sync(0xffffffffu, dot[g], 1);
        if (g < groups && (tid & 1) == 0) p[g][tl] = t < length ? dot[g] + other : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax per head: warp w handles heads w and w + 4.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + 4 * r;
      if (g < groups) {
        float mx = fmaxf(p[g][lane], p[g][lane + 32]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_g[r], mx);
        const float e0 = expf(p[g][lane] - m_new);  // -inf scores give 0
        const float e1 = expf(p[g][lane + 32] - m_new);
        p[g][lane] = e0;
        p[g][lane + 32] = e1;
        float sum = e0 + e1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float alpha = expf(m_g[r] - m_new);
        l_g[r] = l_g[r] * alpha + sum;
        m_g[r] = m_new;
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // P.V over this tile's valid tokens.
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g < groups) {
        acc[g].x *= alpha_s[g];
        acc[g].y *= alpha_s[g];
      }
    }
    const int n_valid = min(TILE, length - start);
    for (int tl = half; tl < n_valid; tl += 2) {
      const int t = start + tl;
      const long long tok = static_cast<long long>(tab[t / page]) * page + t % page;
      const float2 vf = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(vbase + tok * DH)[pair]);
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g < groups) {
          acc[g].x += p[g][tl] * vf.x;
          acc[g].y += p[g][tl] * vf.y;
        }
      }
    }
    __syncthreads();  // p is rewritten by the next tile
  }

  // Combine the two token parities, normalise, write.
  if (half == 1) {
#pragma unroll
    for (int g = 0; g < G_MAX; ++g)
      if (g < groups) merge[g][pair] = acc[g];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = warp + 4 * r;
    if (g < groups && lane == 0) {
      alpha_s[g] = l_g[r];
      m_out[row0 + g] = m_g[r];
      l_out[row0 + g] = l_g[r];
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g < groups) {
        const float inv = 1.0f / fmaxf(alpha_s[g], 1e-30f);
        float2* dst = reinterpret_cast<float2*>(out + (row0 + g) * DH) + pair;
        *dst = make_float2((acc[g].x + merge[g][pair].x) * inv,
                           (acc[g].y + merge[g][pair].y) * inv);
      }
    }
  }
}

}  // namespace

// q: (B, H, 128) f32 pre-scaled; k/v pages: one layer, (H_kv, P, page, 128)
// bf16; table: (B, pps) int32; lengths: (B,) int32. Outputs out (B, H, 128),
// m and l (B, H), all f32. H / H_kv <= 8.
extern "C" int paged_attention_stats_bf16(const void* q, const void* k_pages,
                                          const void* v_pages, const void* table,
                                          const void* lengths, void* out, void* m, void* l,
                                          int b, int h, int h_kv, int total_pages, int pps,
                                          int page, void* stream) {
  if (h % h_kv != 0 || h / h_kv > G_MAX) return static_cast<int>(cudaErrorInvalidValue);
  paged_attention_stats_kernel<<<dim3(h_kv, b), THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(l), h, h_kv, total_pages, pps, page);
  return static_cast<int>(cudaGetLastError());
}
