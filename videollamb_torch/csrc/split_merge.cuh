// Exact merge of attention results over disjoint key splits (flash-decoding),
// shared by the paged decode kernels.
//
// A row's keys are cut into splits that separate blocks attend over; each
// block leaves its split's normalised output o_i with the split's running
// max m_i and sum l_i = sum exp(s - m_i). The union of the splits is, by the
// log-sum-exp rule (the one merge_one_token applies to one extra key):
//   m = max_i m_i,  l = sum_i l_i exp(m_i - m),  o = sum_i o_i l_i exp(m_i - m) / l.
// A split with no key (m_i = -inf, l_i = 0) weighs nothing; a row whose every
// split is empty gives o = 0, m = -inf, l = 0.
//
// One launch does both: every block of a row group arrives at a counter
// after writing its partials, and the block that arrives last merges them
// and sets the counter back to 0 for the next launch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace split_merge {
namespace {

// Column `col` of the merge of n partials of one row: o_parts[i * o_stride +
// col] is split i's normalised output, ml[i] its (m_i, l_i). Partials are
// read through L2 (other blocks wrote them). Returns o; sets m and l.
__device__ __forceinline__ float merge_column(const float* o_parts, long long o_stride,
                                              const float2* ml, int n, int col, float& m,
                                              float& l) {
  m = -INFINITY;
  for (int i = 0; i < n; ++i) m = fmaxf(m, __ldcg(ml + i).x);
  l = 0.0f;
  float o = 0.0f;
  if (m == -INFINITY) return o;
  for (int i = 0; i < n; ++i) {
    const float2 x = __ldcg(ml + i);
    if (x.x == -INFINITY) continue;
    const float wgt = x.y * expf(x.x - m);
    l += wgt;
    o += wgt * __ldcg(o_parts + i * o_stride + col);
  }
  return o / l;
}

// Called by every thread of a block after it wrote its partials: true in the
// block that arrives last of `expected` at `counter`, whose reads then see
// every other block's partials. The last block resets the counter.
__device__ __forceinline__ bool arrive_last(unsigned int* counter, unsigned int expected,
                                            int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1u) == expected - 1;
    if (last) *counter = 0u;  // every block of this launch has arrived
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

}  // namespace
}  // namespace split_merge
