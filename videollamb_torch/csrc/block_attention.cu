// Whole-row softmax attention for short sequences (K11).
//
// Replaces videollamb_tpu/ops/flash_attention.py::block_attention
// (_block_attn_kernel): for each (batch, head), scores over ALL keys at once
// (no online softmax), s = (q . k) * scale in f32, causal measured from
// position 0 for both q and k (even when Sq != Skv), no key mask; the row
// maximum over all keys, p = exp(s - m) / l, the NORMALISED probabilities
// rounded to the value type, then one product with V. (K3 rounds the
// unnormalised p and divides at the end: other rounding.)
//
// Bound: at (256, 16, 257, 64) non-causal it moves 539 MB (q, k, v read
// once, out written once): 0.161 ms at 3.35 TB/s, above its 69 GFLOP
// (0.070 ms at 989 TFLOP/s). At (4, 32, 512, 128) causal: 67 MB, 0.020 ms,
// against 8.6 GFLOP of visible pairs (0.009 ms).
//
// Design: the TPU kernel held all heads' whole (Sq, Skv) score tiles in
// VMEM. Here a block of four warps takes 64 query rows of one (batch, head),
// 16 rows a warp, and keeps each warp's 16 x Skv f32 score strip in shared
// memory (at Skv = 512, 33 KB a warp). One head's K and V at (512, 128) take
// 256 KB, more than a block's 227 KB, so they pass through shared memory in
// 64-key tiles: first K tile by tile for the scores (WMMA bf16 products,
// f32 accumulators), then the row softmax in f32 (each lane holds its
// columns in registers while the normalised bf16 probabilities overwrite the
// front half of the row's f32 strip in place), then V tile by tile for the
// output, kept in WMMA accumulators. Every block stages all of its head's K
// and V once; the (Sq / 64) blocks of one head read them again from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int WARPS = 4;
constexpr int TILE = 16;     // query rows per warp
constexpr int KT = 64;       // keys per staged K / V tile
constexpr int MAX_SKV = 512;

__host__ __device__ inline int pad_keys(int skv) { return (skv + KT - 1) / KT * KT; }
// f32 stride of a warp's score strip, which also holds its 16 x dh output.
__host__ __device__ inline int s_ld(int skv_pad, int dh) {
  return (skv_pad > dh ? skv_pad : dh) + 4;
}

size_t smem_bytes(int skv, int dh) {
  const size_t ld = dh + 8;
  return KT * ld * sizeof(__nv_bfloat16)
       + WARPS * (TILE * ld * sizeof(__nv_bfloat16)
                  + TILE * static_cast<size_t>(s_ld(pad_keys(skv), dh)) * sizeof(float));
}

// Copy `rows` rows of DH bf16 (row stride DH) to shared memory (row stride
// DH + 8); rows in [rows, rows_pad) are zeroed.
template <int DH>
__device__ inline void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows,
                                  int rows_pad, int tid, int nthreads) {
  constexpr int LD = DH + 8;
  const int chunks = rows_pad * (DH / 8);  // 16-byte chunks
  for (int i = tid; i < chunks; i += nthreads) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
block_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       int heads, int sq, int skv, float scale, int causal) {
  constexpr int LD = DH + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long bh = static_cast<long long>(blockIdx.z) * heads + blockIdx.y;
  const int skv_pad = pad_keys(skv);
  const int sld = s_ld(skv_pad, DH);
  const int pld = 2 * sld;  // bf16 stride of the probabilities written over the strip

  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* wb = reinterpret_cast<unsigned char*>(kv + KT * LD)
                    + warp * (TILE * LD * sizeof(__nv_bfloat16) + TILE * sld * sizeof(float));
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(wb);
  float* ss = reinterpret_cast<float*>(qs + TILE * LD);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(ss);

  const int row0 = (blockIdx.x * WARPS + warp) * TILE;
  const int rows = max(0, min(TILE, sq - row0));
  const __nv_bfloat16* kh = k + bh * skv * DH;
  const __nv_bfloat16* vh = v + bh * skv * DH;
  if (rows > 0) stage_rows<DH>(qs, q + (bh * sq + row0) * DH, rows, TILE, lane, 32);

  // S = Q K^T over all keys, 64 keys at a time, f32 into the strip.
  for (int kt = 0; kt < skv_pad; kt += KT) {
    __syncthreads();
    stage_rows<DH>(kv, kh + static_cast<long long>(kt) * DH, min(KT, skv - kt), KT, tid,
                   blockDim.x);
    __syncthreads();
    if (rows == 0) continue;
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + kk * 16, LD);
        wmma::load_matrix_sync(b, kv + j * 16 * LD + kk * 16, LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ss + kt + j * 16, acc, sld, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // Row softmax in f32 over the visible keys; p / l rounded to bf16 in place.
  if (rows > 0) {
    for (int r = 0; r < TILE; ++r) {
      const float* srow = ss + r * sld;
      const int visible = causal ? min(skv, row0 + r + 1) : skv;
      float vals[MAX_SKV / 32];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < MAX_SKV / 32; ++i) {
        const int c = lane + 32 * i;
        vals[i] = c < visible ? srow[c] * scale : -INFINITY;
        m = fmaxf(m, vals[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < MAX_SKV / 32; ++i) {
        vals[i] = lane + 32 * i < visible ? expf(vals[i] - m) : 0.0f;
        sum += vals[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();  // every lane has read the row before it is overwritten
      __nv_bfloat16* prow = ps + r * pld;
#pragma unroll
      for (int i = 0; i < MAX_SKV / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < skv_pad) prow[c] = __float2bfloat16(vals[i] / sum);
      }
      __syncwarp();
    }
  }

  // O = P V, 64 keys at a time, in accumulators.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_acc[DH / 16];
#pragma unroll
  for (int ct = 0; ct < DH / 16; ++ct) wmma::fill_fragment(o_acc[ct], 0.0f);
  for (int kt = 0; kt < skv_pad; kt += KT) {
    __syncthreads();
    stage_rows<DH>(kv, vh + static_cast<long long>(kt) * DH, min(KT, skv - kt), KT, tid,
                   blockDim.x);
    __syncthreads();
    if (rows == 0) continue;
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, ps + kt + j * 16, pld);
#pragma unroll
      for (int ct = 0; ct < DH / 16; ++ct) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, kv + j * 16 * LD + ct * 16, LD);
        wmma::mma_sync(o_acc[ct], a, b, o_acc[ct]);
      }
    }
  }
  if (rows == 0) return;
  __syncwarp();  // the warp's last reads of its probabilities are done
#pragma unroll
  for (int ct = 0; ct < DH / 16; ++ct)
    wmma::store_matrix_sync(ss + ct * 16, o_acc[ct], sld, wmma::mem_row_major);
  __syncwarp();
  __nv_bfloat16* oh = out + (bh * sq + row0) * DH;
  for (int i = lane; i < rows * (DH / 2); i += 32) {
    const int r = i / (DH / 2);
    const int c = (i % (DH / 2)) * 2;
    *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<long long>(r) * DH + c) =
        __floats2bfloat162_rn(ss[r * sld + c], ss[r * sld + c + 1]);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int b, int heads, int sq,
           int skv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(skv, DH);
  cudaError_t err = cudaFuncSetAttribute(block_attention_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + WARPS * TILE - 1) / (WARPS * TILE), heads, b);
  block_attention_kernel<DH><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), heads, sq, skv,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t block_attention_smem_bytes(int skv, int dh) { return smem_bytes(skv, dh); }

// q, out: (B, H, Sq, dh); k, v: (B, H, Skv, dh); bf16 contiguous; dh in {64, 128};
// 1 <= Skv <= 512.
extern "C" int block_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int b, int heads, int sq, int skv, int dh, float scale,
                                    int causal, void* stream) {
  if (skv < 1 || skv > MAX_SKV || sq < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch<64>(q, k, v, out, b, heads, sq, skv, scale, causal, s);
  if (dh == 128) return launch<128>(q, k, v, out, b, heads, sq, skv, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
