// Whole-row softmax attention for short sequences (K11).
//
// Replaces videollamb_tpu/ops/flash_attention.py::block_attention
// (_block_attn_kernel): for each (batch, head), scores over ALL keys at once
// (no online softmax), s = (q . k) * scale in f32, causal measured from
// position 0 for both q and k (even when Sq != Skv), no key mask; the row
// maximum over all keys, p = exp(s - m) / l, the NORMALISED probabilities
// rounded to bf16, then one product with V. (K3 rounds the unnormalised p
// and divides at the end: other rounding.) It is the whole-row attention of
// whole_row_attention.cuh on the (B, H, S, dh) layout.
//
// Bound: at (256, 16, 257, 64) non-causal it moves 539 MB (q, k, v read
// once, out written once): 0.161 ms at 3.35 TB/s, above its 69 GFLOP
// (0.070 ms at 989 TFLOP/s). At (4, 32, 512, 128) causal: 67 MB, 0.020 ms,
// against 8.6 GFLOP of visible pairs (0.009 ms).
//
// Design (details in the header): scores stay in registers and the softmax
// is exact in two passes over the keys (max and sum, then the normalised bf16
// probabilities times V). At dh = 64 and Skv <= 272 a block of four warps
// stages one head's K and V once by cp.async and multiplies with warpgroup
// wgmma (B straight from the swizzled shared tile). Otherwise (dh = 128, or
// longer Skv) a block of 64 query rows streams K and V in 64-key tiles
// through a double-buffered cp.async ring and multiplies with mma.sync on
// ldmatrix operands, so Skv has no cap. The TPU kernel held all heads'
// (Sq, Skv) score tiles in VMEM; at (512, 128) one head's K and V alone
// exceed a block's 227 KB. Under causal masking the key groups above the
// diagonal are skipped; only those the diagonal crosses are masked element
// by element.

#include "whole_row_attention.cuh"

// q, out: (B, H, Sq, dh); k, v: (B, H, Skv, dh); bf16 contiguous; dh in {64, 128};
// Sq, Skv >= 1; scale > 0 (the wrapper turns another scale into this one).
extern "C" int block_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int b, int heads, int sq, int skv, int dh, float scale,
                                    int causal, void* stream) {
  if (!(scale > 0.0f)) return static_cast<int>(cudaErrorInvalidValue);
  whole_row::Args p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.q_row = p.kv_row = dh;
  p.q_head = static_cast<long long>(sq) * dh;
  p.q_batch = p.q_head * heads;
  p.kv_head = static_cast<long long>(skv) * dh;
  p.kv_batch = p.kv_head * heads;
  p.scale_log2 = scale * 1.4426950408889634f;
  return whole_row::launch(p, b, dh, causal != 0, static_cast<cudaStream_t>(stream));
}
