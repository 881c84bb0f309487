// Spatial attention core of the vision tower, in two layouts (K1, K8).
//
// spatial_attention_bf16 (K1) replaces
// videollamb_tpu/ops/spatial_attention.py::fused_spatial_core_packed
// (_kernel_packed): softmax attention over the N patch tokens of each frame,
// q pre-scaled, heads sliced from the packed (B, N, D) projection output at
// column offset h * 64, output written in the same packed layout.
// spatial_core_bf16 (K8) replaces ::fused_spatial_core (_kernel): the same
// math on the split (B, H, N, 64) layout. Both are the whole-row attention
// of whole_row_attention.cuh with a scale of 1; only the strides differ.
//
// Bound: at 256 frames x 16 heads x 257 tokens each layout moves 539 MB
// (q, k, v read once, out written once): 0.161 ms at 3.35 TB/s, above the
// 69 GFLOP of its two products (0.070 ms at 989 TFLOP/s).
//
// Design (details in the header): at N <= 272 one block of four warps stages
// one (frame, head)'s K and V once by cp.async (68 KB, three blocks an SM)
// and walks the frame's 16-row query tiles, four a round; both products are
// warpgroup wgmma with the scores kept in registers, B read straight from the
// swizzled shared tile, and the softmax exact in two passes over the keys
// (max and sum, then the normalised bf16 probabilities times V). No score or
// probability touches shared memory. The TPU kernel kept a (257, 257) f32
// score tile per head in VMEM, larger than a block's shared memory. Longer N
// takes the header's streaming route (64-key tiles through a cp.async ring),
// so N has no limit.

#include "whole_row_attention.cuh"

namespace {

constexpr int E = 64;  // head dim
constexpr float LOG2E = 1.4426950408889634f;

int run(const void* q, const void* k, const void* v, void* out, int b, int heads, int n,
        long long batch_stride, long long head_stride, long long row_stride, void* stream) {
  whole_row::Args p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.heads = heads;
  p.sq = p.skv = n;
  p.q_batch = p.kv_batch = batch_stride;
  p.q_head = p.kv_head = head_stride;
  p.q_row = p.kv_row = row_stride;
  p.scale_log2 = LOG2E;  // q comes pre-scaled
  return whole_row::launch(p, b, E, false, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q, k, v, out: (B, N, D) bf16, contiguous; D == heads * 64.
extern "C" int spatial_attention_bf16(const void* q, const void* k, const void* v,
                                      void* out, int b, int n, int d, int heads,
                                      void* stream) {
  if (d != heads * E) return static_cast<int>(cudaErrorInvalidValue);
  return run(q, k, v, out, b, heads, n, static_cast<long long>(n) * d, E, d, stream);
}

// q, k, v, out: (B, H, N, 64) bf16, contiguous.
extern "C" int spatial_core_bf16(const void* q, const void* k, const void* v, void* out,
                                 int b, int heads, int n, void* stream) {
  return run(q, k, v, out, b, heads, n, static_cast<long long>(heads) * n * E,
             static_cast<long long>(n) * E, E, stream);
}
