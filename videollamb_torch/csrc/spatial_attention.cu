// Spatial attention core of the vision tower, in two layouts.
//
// spatial_attention_bf16 (K1) replaces
// videollamb_tpu/ops/spatial_attention.py::fused_spatial_core_packed
// (_kernel_packed): softmax attention over the N patch tokens of each frame,
// q pre-scaled, heads sliced from the packed (B, N, D) projection output at
// column offset h * E, output written in the same packed layout.
// spatial_core_bf16 (K8) replaces ::fused_spatial_core (_kernel): the same
// math on the split (B, H, N, E) layout, where a head's rows are contiguous.
// Both run the one kernel below; only the strides differ.
//
// Bound: at 256 frames x 16 heads x 257 tokens each layout moves 539 MB
// (q, k, v read once, out written once): 0.161 ms at 3.35 TB/s, above the
// 69 GFLOP of its two products (0.070 ms at 989 TFLOP/s).
//
// Design: one block per (frame, head). The head's K and V (N x 64 bf16, about
// 33 KB each at N = 257) are staged once in shared memory; four warps then
// walk the 16-row query tiles of the frame. For each tile a warp computes the
// full 16 x N score row block with bf16 tensor-core MMAs (WMMA) into f32
// shared memory, runs the softmax in f32, rounds the normalised
// probabilities to bf16 (as the TPU kernel does before its second dot) and
// multiplies them with V. The TPU kernel kept a whole (N, N) f32 tile per
// head; that is 264 KB here, above the 227 KB a block may hold, so the score
// tile is cut to 16 rows per warp instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int E = 64;          // head dim
constexpr int WARPS = 4;
constexpr int TILE = 16;
constexpr int KV_LD = E + 8;   // bf16 row stride of staged K/V/Q (multiple of 8)

// f32 stride of a warp's score strip, which also holds its 16 x E output.
__host__ __device__ inline int s_ld(int n_pad) { return (n_pad > E ? n_pad : E) + 4; }
__host__ __device__ inline int p_ld(int n_pad) { return n_pad + 8; }   // bf16

size_t smem_bytes(int n_pad) {
  size_t kv = 2ull * n_pad * KV_LD * sizeof(__nv_bfloat16);
  size_t per_warp = TILE * KV_LD * sizeof(__nv_bfloat16)
                  + TILE * s_ld(n_pad) * sizeof(float)
                  + TILE * p_ld(n_pad) * sizeof(__nv_bfloat16);
  return kv + WARPS * per_warp;
}

// Copy `rows` rows of 64 bf16 (128 bytes) from global (row stride `stride`
// elements) to shared (row stride KV_LD); rows in [rows, rows_pad) are zeroed.
__device__ inline void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                  long long stride, int rows, int rows_pad,
                                  int tid, int nthreads) {
  const int chunks = rows_pad * (E / 8);  // 16-byte chunks
  for (int i = tid; i < chunks; i += nthreads) {
    const int r = i / (E / 8);
    const int c = (i % (E / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * KV_LD + c) = val;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
spatial_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out,
                         int n, long long frame_stride, long long head_stride,
                         int row_stride, int n_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int frame = blockIdx.x;
  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_tiles = n_pad / TILE;
  const int sld = s_ld(n_pad);
  const int pld = p_ld(n_pad);

  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + n_pad * KV_LD;
  unsigned char* warp_base = reinterpret_cast<unsigned char*>(vs + n_pad * KV_LD);
  const size_t per_warp = TILE * KV_LD * sizeof(__nv_bfloat16)
                        + TILE * sld * sizeof(float)
                        + TILE * pld * sizeof(__nv_bfloat16);
  warp_base += warp * per_warp;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(warp_base);
  float* ss = reinterpret_cast<float*>(qs + TILE * KV_LD);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(ss + TILE * sld);

  const long long frame_off = frame * frame_stride + head * head_stride;
  stage_rows(ks, k + frame_off, row_stride, n, n_pad, tid, blockDim.x);
  stage_rows(vs, v + frame_off, row_stride, n, n_pad, tid, blockDim.x);
  __syncthreads();

  for (int rt = warp; rt < n_tiles; rt += WARPS) {
    const int row0 = rt * TILE;
    const int rows = min(TILE, n - row0);
    stage_rows(qs, q + frame_off + static_cast<long long>(row0) * row_stride, row_stride,
               rows, TILE, lane, 32);
    __syncwarp();

    // S = Q K^T, 16 x n_pad, f32.
    for (int j = 0; j < n_tiles; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < E / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + kk * 16, KV_LD);
        wmma::load_matrix_sync(b, ks + j * 16 * KV_LD + kk * 16, KV_LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ss + j * 16, acc, sld, wmma::mem_row_major);
    }
    __syncwarp();

    // Row softmax in f32; normalised probabilities rounded to bf16.
    for (int r = 0; r < TILE; ++r) {
      float* srow = ss + r * sld;
      float m = -INFINITY;
      for (int c = lane; c < n; c += 32) m = fmaxf(m, srow[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.0f;
      for (int c = lane; c < n; c += 32) {
        const float e = expf(srow[c] - m);
        srow[c] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float inv = 1.0f / sum;
      __nv_bfloat16* prow = ps + r * pld;
      for (int c = lane; c < n_pad; c += 32)
        prow[c] = __float2bfloat16(c < n ? srow[c] * inv : 0.0f);
    }
    __syncwarp();

    // O = P V, 16 x 64, f32 into the score buffer.
#pragma unroll
    for (int ct = 0; ct < E / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int j = 0; j < n_tiles; ++j) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + j * 16, pld);
        wmma::load_matrix_sync(b, vs + j * 16 * KV_LD + ct * 16, KV_LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ss + ct * 16, acc, sld, wmma::mem_row_major);
    }
    __syncwarp();

    for (int i = lane; i < rows * (E / 2); i += 32) {
      const int r = i / (E / 2);
      const int c = (i % (E / 2)) * 2;
      const __nv_bfloat162 val = __floats2bfloat162_rn(ss[r * sld + c], ss[r * sld + c + 1]);
      *reinterpret_cast<__nv_bfloat162*>(
          out + frame_off + static_cast<long long>(row0 + r) * row_stride + c) = val;
    }
    __syncwarp();
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int frames, int heads,
           int n, long long frame_stride, long long head_stride, int row_stride,
           void* stream) {
  const int n_pad = (n + TILE - 1) / TILE * TILE;
  const size_t smem = smem_bytes(n_pad);
  cudaError_t err = cudaFuncSetAttribute(
      spatial_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(frames, heads);
  spatial_attention_kernel<<<grid, WARPS * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), n,
      frame_stride, head_stride, row_stride, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t spatial_attention_smem_bytes(int n) {
  return smem_bytes((n + TILE - 1) / TILE * TILE);
}

// q, k, v, out: (B, N, D) bf16, contiguous; D == heads * 64.
extern "C" int spatial_attention_bf16(const void* q, const void* k, const void* v,
                                      void* out, int b, int n, int d, int heads,
                                      void* stream) {
  if (d != heads * E) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, out, b, heads, n, static_cast<long long>(n) * d, E, d, stream);
}

// q, k, v, out: (B, H, N, 64) bf16, contiguous.
extern "C" int spatial_core_bf16(const void* q, const void* k, const void* v, void* out,
                                 int b, int heads, int n, void* stream) {
  return launch(q, k, v, out, b, heads, n, static_cast<long long>(heads) * n * E,
                static_cast<long long>(n) * E, E, stream);
}
