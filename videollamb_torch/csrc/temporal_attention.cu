// Temporal attention core of the video tower, in three layouts.
//
// For every (video, patch position, head): softmax attention across the t
// frames, q pre-scaled, probabilities rounded to bf16 before the product
// with v. One kernel, three entry points that differ only in addressing:
//
// - temporal_attention_bf16 (K2) replaces
//   videollamb_tpu/ops/temporal_attention.py::fused_temporal_core_fm3
//   (_core_kernel_fm3): one packed frame-major (b, t, n, 3d) operand
//   [q * scale | k | v], head h at columns h*e, d + h*e and 2d + h*e;
// - temporal_core_bntd_bf16 (K9) replaces ::fused_temporal_core
//   (_core_kernel): three (b, n, t, d) operands, the t frames of one position
//   consecutive rows, head h at columns h*e of each row;
// - temporal_core_fm_bf16 (K10) replaces ::fused_temporal_core_fm
//   (_core_kernel_fm): three frame-major (b, t, n, d) operands, frame stride
//   n * d.
// All write the output in the layout of q.
//
// Bound: at 32 videos x 8 frames x 257 positions x 1024 the op reads q, k, v
// once and writes out once, 539 MB: 0.161 ms at 3.35 TB/s. Its products are
// 2.2 GFLOP, about 4 FLOPs per byte, far below the card's ridge of about
// 295, so it is bound by device memory.
//
// Design: the TPU kernels packed (t * block_n) or (t * h) rows under a
// same-position or same-head mask to fill the matrix unit, paying block_n or
// h times the FLOPs. Here each (b, n, head) is its own t x t problem over
// 64-wide rows, and one warp solves it: lane l holds dims 2l and 2l+1 of
// every frame's q, k and v (bf16x2 loads, so a warp reads 128 contiguous
// bytes per row), the t x t scores are warp-reduced in f32, the softmax runs
// in f32, probabilities are rounded to bf16 as on the TPU, and the output is
// accumulated in f32. Warps of one block take consecutive heads of one
// position, so a block reads 8 x 128 contiguous bytes of every row it
// touches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int E = 64;       // head dim
constexpr int T_MAX = 8;    // frames per temporal window
constexpr int WARPS = 8;

// Row r of frame i of (video bi, position pos): frame-major layouts keep the
// n positions of a frame together, the (b, n, t, d) layout the t frames of a
// position.
__device__ inline long long row_of(int bi, int i, int pos, int t, int n, bool frame_major) {
  return frame_major ? (static_cast<long long>(bi) * t + i) * n + pos
                     : (static_cast<long long>(bi) * n + pos) * t + i;
}

__global__ void __launch_bounds__(WARPS * 32)
temporal_attention_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          int b, int t, int n, int heads, int in_stride, int out_stride,
                          bool frame_major) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long item = static_cast<long long>(blockIdx.x) * WARPS + warp;
  const long long total = static_cast<long long>(b) * n * heads;
  if (item >= total) return;
  const int h = static_cast<int>(item % heads);
  const int pos = static_cast<int>((item / heads) % n);
  const int bi = static_cast<int>(item / (static_cast<long long>(heads) * n));
  const int col = h * E + 2 * lane;

  float2 qf[T_MAX], kf[T_MAX], vf[T_MAX];
#pragma unroll
  for (int i = 0; i < T_MAX; ++i) {
    if (i < t) {
      const long long off = row_of(bi, i, pos, t, n, frame_major) * in_stride + col;
      qf[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + off));
      kf[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k + off));
      vf[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + off));
    }
  }

#pragma unroll
  for (int i = 0; i < T_MAX; ++i) {
    if (i >= t) break;
    float s[T_MAX];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < T_MAX; ++j) {
      if (j < t) {
        float part = qf[i].x * kf[j].x + qf[i].y * kf[j].y;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        s[j] = part;
        m = fmaxf(m, part);
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < T_MAX; ++j) {
      if (j < t) {
        s[j] = expf(s[j] - m);
        sum += s[j];
      }
    }
    const float inv = 1.0f / sum;
    float2 o = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < T_MAX; ++j) {
      if (j < t) {
        const float p = __bfloat162float(__float2bfloat16(s[j] * inv));
        o.x += p * vf[j].x;
        o.y += p * vf[j].y;
      }
    }
    __nv_bfloat16* dst = out + row_of(bi, i, pos, t, n, frame_major) * out_stride + col;
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o.x, o.y);
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int b, int t, int n,
           int d, int heads, int in_stride, bool frame_major, void* stream) {
  if (d != heads * E || t < 1 || t > T_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(b) * n * heads;
  const long long blocks = (total + WARPS - 1) / WARPS;
  temporal_attention_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), b, t, n,
      heads, in_stride, d, frame_major);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. qkv: (b, t, n, 3d) bf16 contiguous; out: (b, t, n, d); d == heads * 64; t <= 8.
extern "C" int temporal_attention_bf16(const void* qkv, void* out, int b, int t,
                                       int n, int d, int heads, void* stream) {
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  return launch(base, base + d, base + 2 * d, out, b, t, n, d, heads, 3 * d, true, stream);
}

// K9. q, k, v, out: (b, n, t, d) bf16 contiguous; d == heads * 64; t <= 8.
extern "C" int temporal_core_bntd_bf16(const void* q, const void* k, const void* v,
                                       void* out, int b, int n, int t, int d, int heads,
                                       void* stream) {
  return launch(q, k, v, out, b, t, n, d, heads, d, false, stream);
}

// K10. q, k, v, out: (b, t, n, d) bf16 contiguous; d == heads * 64; t <= 8.
extern "C" int temporal_core_fm_bf16(const void* q, const void* k, const void* v,
                                     void* out, int b, int t, int n, int d, int heads,
                                     void* stream) {
  return launch(q, k, v, out, b, t, n, d, heads, d, true, stream);
}
