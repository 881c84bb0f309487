// int8 paged decode attention over the token-major pool (kernel K4).
//
// Replaces videollamb_tpu/ops/gathered_paged_attention.py::
// gathered_paged_attention_int8 (_gathered_kernel). For every slot b and
// query head h, attention of the pre-scaled query over the slot's first
// lengths[b] resident tokens, returning the normalised output and the
// softmax statistics (m, l) that the decode step folds the current token
// into. Numerics are the TPU kernel's, step for step:
//   - q quantised per head: rint(q * (127.5 / max(absmax, 1e-30))), saturated;
//   - exact int32 Q.K, dequantised by (qs * ks) / 127.5^2;
//   - a flash (m, l) over blocks of T = pages_per_block * page tokens, tokens
//     past the length at -0.7 * FLT_MAX;
//   - probabilities times vs / 127.5, requantised per (head, block) against
//     their absmax, then an exact int32 P.V dequantised by wscale / 127.5.
// The products and sums whose rounding feeds a requantisation use the _rn
// intrinsics, so the compiler contracts none of them into an FMA.
//
// Design: the TPU kernel packs all H heads block-diagonally into one
// (T, KD) x (KD, H) matmul so its matrix unit has rows to chew on, and only
// 1/H_kv of that product is useful. Here one block of 128 threads owns one
// (slot, head) and walks the slot's pages through the page table. In the
// token-major pool a token's 128-byte slice of one kv head is contiguous:
// for Q.K eight lanes read one token's slice as four 16-byte loads and
// reduce four __dp4a each over shuffles; for P.V a warp reads four tokens'
// slices (128 contiguous bytes each), transposes the bytes in registers and
// accumulates __dp4a of four tokens at a time per dimension. The work is
// about 4 int8 operations per byte read, so the kernel is bound by device
// memory: sum_b lengths[b] x (256 bytes of K and V + 8 bytes of scales) per
// head, read once when H == H_kv.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 128;       // head dim
constexpr int THREADS = 128;  // 4 warps
constexpr float MAX_INT8 = 127.5f;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

__device__ __forceinline__ int8_t sat_int8(float x) {
  // rint half to even, saturate (an absmax element lands on +-127.5 -> +-128).
  float r = rintf(x);
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return (red[0] + red[1]) + (red[2] + red[3]);
}

__global__ void __launch_bounds__(THREADS)
gathered_paged_attention_kernel(const float* __restrict__ q,       // (B, H, DH)
                                const int8_t* __restrict__ k_pool,  // (P, page, KD)
                                const int8_t* __restrict__ v_pool,
                                const float* __restrict__ k_scales, // (P, page, H_kv)
                                const float* __restrict__ v_scales,
                                const int* __restrict__ table,      // (B, pps)
                                const int* __restrict__ lengths,    // (B,)
                                float* __restrict__ out,            // (B, H, DH)
                                float* __restrict__ m_out,          // (B, H)
                                float* __restrict__ l_out,
                                int h, int h_kv, int pps, int page, int block_tokens) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);                           // block_tokens
  int8_t* w8 = reinterpret_cast<int8_t*>(s + block_tokens);            // block_tokens
  int* part = reinterpret_cast<int*>(w8 + block_tokens);               // 4 x DH
  __shared__ float red[4];
  __shared__ __align__(16) int8_t q8[DH];

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kh = head / (h / h_kv);
  const int kd = h_kv * DH;
  const int length = lengths[b];
  const long long row = static_cast<long long>(b) * h + head;
  if (length <= 0) {  // uniform across the block
    out[row * DH + tid] = 0.0f;
    if (tid == 0) {
      m_out[row] = -INFINITY;
      l_out[row] = 0.0f;
    }
    return;
  }

  // Query: per-head absmax int8.
  const float qv = q[row * DH + tid];
  const float qs = fmaxf(block_max(fabsf(qv), red), 1e-30f);
  q8[tid] = sat_int8(__fmul_rn(qv, __fdiv_rn(MAX_INT8, qs)));
  __syncthreads();
  const int sub = lane & 7;  // Q.K: 8 lanes per token, 16 bytes each
  const int4 qw = reinterpret_cast<const int4*>(q8)[sub];
  const int* tab = table + static_cast<long long>(b) * pps;

  float m_prev = -INFINITY, l_prev = 0.0f, acc = 0.0f;
  for (int start = 0; start < length; start += block_tokens) {
    // Scores of this block's tokens.
    for (int t0 = 0; t0 < block_tokens; t0 += THREADS / 8) {
      const int tl = t0 + warp * 4 + (lane >> 3);
      const int t = start + tl;
      int dot = 0;
      long long tok = 0;
      if (t < length) {
        tok = static_cast<long long>(tab[t / page]) * page + t % page;
        const int4 kw = *reinterpret_cast<const int4*>(k_pool + tok * kd + kh * DH + sub * 16);
        dot = __dp4a(kw.x, qw.x, dot);
        dot = __dp4a(kw.y, qw.y, dot);
        dot = __dp4a(kw.z, qw.z, dot);
        dot = __dp4a(kw.w, qw.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (sub == 0) {
        float sc = MASK_VALUE;
        if (t < length) {
          const float ks = k_scales[tok * h_kv + kh];
          sc = __fmul_rn(static_cast<float>(dot),
                         __fdiv_rn(__fmul_rn(qs, ks), MAX_INT8 * MAX_INT8));
        }
        s[tl] = sc;
      }
    }
    __syncthreads();

    // Flash statistics over the block.
    float mx = -INFINITY;
    for (int t = tid; t < block_tokens; t += THREADS) mx = fmaxf(mx, s[t]);
    const float m_new = fmaxf(m_prev, block_max(mx, red));
    const float alpha = expf(m_prev - m_new);
    float psum = 0.0f, wmax = 0.0f;
    for (int tl = tid; tl < block_tokens; tl += THREADS) {
      const int t = start + tl;
      const float p = expf(s[tl] - m_new);  // masked tokens underflow to 0
      psum += p;
      float w = 0.0f;
      if (t < length) {
        const long long tok = static_cast<long long>(tab[t / page]) * page + t % page;
        w = __fmul_rn(p, __fdiv_rn(v_scales[tok * h_kv + kh], MAX_INT8));
      }
      s[tl] = w;
      wmax = fmaxf(wmax, fabsf(w));
    }
    const float l_new = __fadd_rn(__fmul_rn(alpha, l_prev), block_sum(psum, red));
    const float wscale = fmaxf(block_max(wmax, red), 1e-30f);
    const float wq = __fdiv_rn(MAX_INT8, wscale);
    for (int tl = tid; tl < block_tokens; tl += THREADS) w8[tl] = sat_int8(__fmul_rn(s[tl], wq));
    __syncthreads();

    // P.V: warp w takes token quads w, w+4, ...; lane owns dims 4*lane..+3.
    int o0 = 0, o1 = 0, o2 = 0, o3 = 0;
    const int n_valid = min(block_tokens, length - start);
    for (int qd = warp; qd * 4 < n_valid; qd += 4) {
      int vw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = start + qd * 4 + j;
        vw[j] = 0;
        if (t < length) {
          const long long tok = static_cast<long long>(tab[t / page]) * page + t % page;
          vw[j] = *reinterpret_cast<const int*>(v_pool + tok * kd + kh * DH + lane * 4);
        }
      }
      const int wp = *reinterpret_cast<const int*>(w8 + qd * 4);
      // 4x4 byte transpose: column word j holds dim 4*lane+j of the 4 tokens.
      const unsigned lo01 = __byte_perm(vw[0], vw[1], 0x5140);
      const unsigned hi01 = __byte_perm(vw[0], vw[1], 0x7362);
      const unsigned lo23 = __byte_perm(vw[2], vw[3], 0x5140);
      const unsigned hi23 = __byte_perm(vw[2], vw[3], 0x7362);
      o0 = __dp4a(static_cast<int>(__byte_perm(lo01, lo23, 0x5410)), wp, o0);
      o1 = __dp4a(static_cast<int>(__byte_perm(lo01, lo23, 0x7632)), wp, o1);
      o2 = __dp4a(static_cast<int>(__byte_perm(hi01, hi23, 0x5410)), wp, o2);
      o3 = __dp4a(static_cast<int>(__byte_perm(hi01, hi23, 0x7632)), wp, o3);
    }
    int* mine = part + warp * DH + lane * 4;
    mine[0] = o0;
    mine[1] = o1;
    mine[2] = o2;
    mine[3] = o3;
    __syncthreads();
    const int o_i32 = part[tid] + part[DH + tid] + part[2 * DH + tid] + part[3 * DH + tid];
    const float contrib = __fmul_rn(static_cast<float>(o_i32), __fdiv_rn(wscale, MAX_INT8));
    acc = __fadd_rn(__fmul_rn(acc, alpha), contrib);
    m_prev = m_new;
    l_prev = l_new;
    __syncthreads();  // s, w8 and part are rewritten by the next block
  }
  out[row * DH + tid] = __fdiv_rn(acc, fmaxf(l_prev, 1e-30f));
  if (tid == 0) {
    m_out[row] = m_prev;
    l_out[row] = l_prev;
  }
}

}  // namespace

// Dynamic shared memory of one block for block_tokens tokens.
extern "C" size_t gathered_paged_attention_smem_bytes(int block_tokens) {
  return static_cast<size_t>(block_tokens) * 5 + 4 * DH * sizeof(int);
}

// q: (B, H, 128) f32; k/v pools: one layer, (P, page, H_kv * 128) int8;
// scales: (P, page, H_kv) f32; table: (B, pps) int32; lengths: (B,) int32.
// Outputs out (B, H, 128), m and l (B, H), all f32. block_tokens is
// pages_per_block * page, a multiple of 16.
extern "C" int gathered_paged_attention_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
    const void* v_scales, const void* table, const void* lengths, void* out,
    void* m, void* l, int b, int h, int h_kv, int pps, int page, int block_tokens,
    void* stream) {
  if (h % h_kv != 0 || block_tokens % 16 != 0 || block_tokens % page != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = gathered_paged_attention_smem_bytes(block_tokens);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gathered_paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gathered_paged_attention_kernel<<<dim3(h, b), THREADS, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const int8_t*>(v_pool), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(l), h, h_kv, pps, page, block_tokens);
  return static_cast<int>(cudaGetLastError());
}
