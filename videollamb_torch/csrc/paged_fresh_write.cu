// In-place install of each slot's fresh K/V row into the token-major int8
// pools, for every layer (kernel K5).
//
// Replaces videollamb_tpu/ops/paged_fresh_write.py::paged_fresh_write
// (_write_kernel): after a decode step, slot b's new token of layer l lands
// at pool[l, page[b], off[b]] in the K pool and in the V pool.
//
// Design: the TPU kernel read-modify-writes an aligned 8-token window per
// row because Mosaic's DMAs must cover whole 8-sublane tiles; a GPU store
// has no such rule, so one block per (slot, layer) copies the two rows
// directly, one 16-byte vector per thread. Slots that share the trash page
// (page 0) may race there; that page only ever holds garbage. The op moves
// B x L x 2 rows of KD bytes in and out (4 KB each at 7B), about 4 MB per
// step, so it is bound by launch latency more than by device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
paged_fresh_write_kernel(int8_t* __restrict__ k_pool,             // (L, P, page, KD)
                         int8_t* __restrict__ v_pool,
                         const int8_t* __restrict__ fresh_k,      // (L, B, KD)
                         const int8_t* __restrict__ fresh_v,
                         const int* __restrict__ write_page,      // (B,)
                         const int* __restrict__ write_off,       // (B,)
                         int b, int total_pages, int page, int kd) {
  const int slot = blockIdx.x;
  const int layer = blockIdx.y;
  const long long dst =
      ((static_cast<long long>(layer) * total_pages + write_page[slot]) * page +
       write_off[slot]) * kd;
  const long long src = (static_cast<long long>(layer) * b + slot) * kd;
  const int n_vec = kd / 16;
  for (int i = threadIdx.x; i < n_vec; i += THREADS) {
    reinterpret_cast<int4*>(k_pool + dst)[i] = reinterpret_cast<const int4*>(fresh_k + src)[i];
    reinterpret_cast<int4*>(v_pool + dst)[i] = reinterpret_cast<const int4*>(fresh_v + src)[i];
  }
}

}  // namespace

// Pools (L, P, page, KD) int8, updated in place; fresh rows (L, B, KD) int8;
// write_page / write_off (B,) int32. KD is a multiple of 16.
extern "C" int paged_fresh_write_int8(void* k_pool, void* v_pool, const void* fresh_k,
                                      const void* fresh_v, const void* write_page,
                                      const void* write_off, int layers, int b,
                                      int total_pages, int page, int kd, void* stream) {
  if (kd % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  paged_fresh_write_kernel<<<dim3(b, layers), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(k_pool), static_cast<int8_t*>(v_pool),
      static_cast<const int8_t*>(fresh_k), static_cast<const int8_t*>(fresh_v),
      static_cast<const int*>(write_page), static_cast<const int*>(write_off), b, total_pages,
      page, kd);
  return static_cast<int>(cudaGetLastError());
}
