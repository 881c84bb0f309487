// Int4 weight-only dequantise-and-multiply for small M (kernel K7).
//
// Replaces videollamb_tpu/ops/int4_matmul.py::int4_matmul (_int4_kernel):
// out (M, N) = x (M, K) @ dequant(q4, scale), with q4 (K/2, N) uint8 in the
// split-half layout (low nibble = row i, high nibble = row i + K/2, both
// offset-binary, value + 8) and scale (K/g, N) bf16, one per group of g rows
// and output column. The arithmetic is the TPU kernel's: nibbles become
// integers in [-8, 7], exact in x's type; each group's dot product is summed
// in f32; the group's sum is multiplied by the f32 of its scale; groups are
// summed in f32; one cast to x's type at the end.
//
// Bound: bytes. A decode step multiplies M = 1..8 rows by every LM weight,
// a speculative verify step up to 64: 2 * M operations per packed nibble
// against half a byte read. The design is built around the weight stream.
//
// Two kernels share that arithmetic. The first below does the products as
// f32 FMAs and takes f32 activations, groups that are not multiples of 32
// rows, and M = 1; the second, further down, does them on the tensor cores
// and takes bf16 activations from M = 2 on.
//
// - A thread owns 4 neighbouring columns, so a warp reads 128 contiguous
//   bytes of one packed row per load and a block owns a 128-column tile.
//   Each byte yields two rows K/2 apart: the low nibble multiplies
//   x[m, i], the high nibble x[m, i + K/2], and each side has its own
//   group sum and scale. Several rows' loads are in flight per thread.
// - K is split by "packed groups" (g packed rows = one low and one high
//   group): warp w of K-split s takes packed groups s * WARPS + w,
//   + ksplit * WARPS, ... so that N = 4096 (32 column tiles) still fills
//   the card's 132 SMs. Each warp stages its own x tile (8 rows of M by 2 g
//   values, as f32) in shared memory; nothing but the final reduction
//   needs a block-wide barrier.
// - The warps' sums are added in warp order through shared memory; with
//   ksplit > 1 each block writes its f32 partial tile and a second small
//   kernel adds the splits in split order. No float atomics: a run repeats
//   bit for bit.
// - M is tiled by MT = 1, 2, 4 or 8 rows along grid.z (the accumulators of
//   MT rows by 4 columns, low and high, are what the registers hold): the
//   products are f32 FMAs, 2 * MT per nibble, so a one-row decode step does
//   not pay for eight rows. M need not be a multiple of MT and N need not
//   divide the tile: edges are masked.
//
// The TPU kernel's (n_tiles, group_blocks) grid with a resident accumulator,
// its 8 groups per program, the uniform low/high select and the pad of M to
// a multiple of 8 answer Mosaic's needs and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 4;             // columns per thread: one 32-bit load of packed bytes
constexpr int TILE_N = 32 * COLS;   // columns per block
constexpr int MAX_MT = 8;           // most rows of x per block
constexpr int UNROLL = 16;          // packed rows whose loads are in flight per thread
constexpr int MAX_GROUP = 128;
constexpr int TARGET_BLOCKS = 2 * 132;
constexpr int TC_MIN_M = 2;         // fewest rows of x that go to the tensor-core kernel

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// Four packed bytes of one row at this thread's columns; columns past N read
// as 0x88 (both nibbles 0 after the offset).
__device__ __forceinline__ uint32_t load_packed(const uint8_t* row, bool vec, int cols_left) {
  if (vec) return *reinterpret_cast<const uint32_t*>(row);
  uint32_t w = 0x88888888u;
  for (int c = 0; c < COLS; ++c) {
    if (c < cols_left) w = (w & ~(0xFFu << (8 * c))) | (static_cast<uint32_t>(row[c]) << (8 * c));
  }
  return w;
}

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const T* __restrict__ x,                   // (M, K)
                   const uint8_t* __restrict__ q4,            // (K/2, N)
                   const __nv_bfloat16* __restrict__ scale,   // (K/g, N)
                   T* __restrict__ out,                       // (M, N), written when ksplit == 1
                   float* __restrict__ partial,               // (ksplit, M, N) otherwise
                   int m, int k, int n, int group, int ksplit) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile_n0 = blockIdx.x * TILE_N;
  const int n0 = tile_n0 + lane * COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_half = k / 2;
  const int half_groups = k_half / group;
  const int cols_left = n - n0;  // <= 0: this thread owns no column
  const bool vec = (n % COLS == 0) && cols_left >= COLS &&
                   (reinterpret_cast<uintptr_t>(q4) & 3u) == 0;

  // Per warp: x_lo[group][MT] then x_hi[group][MT], f32.
  float* xs = smem + warp * (2 * group * MT);

  float total[MT][COLS];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) total[i][c] = 0.f;

  for (int pg = split * WARPS + warp; pg < half_groups; pg += ksplit * WARPS) {
    __syncwarp();
    for (int i = 0; i < MT; ++i) {
      const bool live = m0 + i < m;
      const T* row = x + static_cast<size_t>(live ? m0 + i : 0) * k + pg * group;
      for (int r = lane; r < group; r += 32) {
        xs[r * MT + i] = live ? to_float(row[r]) : 0.f;
        xs[(group + r) * MT + i] = live ? to_float(row[k_half + r]) : 0.f;
      }
    }
    __syncwarp();

    float lo[MT][COLS], hi[MT][COLS];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < COLS; ++c) lo[i][c] = hi[i][c] = 0.f;

    const uint8_t* wp = q4 + static_cast<size_t>(pg) * group * n + n0;
    // The next UNROLL rows are loaded before the current ones are consumed.
    uint32_t w[UNROLL], w_next[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      w[u] = cols_left > 0 ? load_packed(wp + static_cast<size_t>(u) * n, vec, cols_left)
                           : 0x88888888u;
    }
    for (int r0 = 0; r0 < group; r0 += UNROLL) {
      const bool more = r0 + UNROLL < group;
      if (more) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          w_next[u] = cols_left > 0 ? load_packed(wp + static_cast<size_t>(r0 + UNROLL + u) * n,
                                                  vec, cols_left)
                                    : 0x88888888u;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float xlo[MT], xhi[MT];
        const float* xl = xs + (r0 + u) * MT;
        const float* xh = xs + (group + r0 + u) * MT;
        if constexpr (MT % 4 == 0) {
#pragma unroll
          for (int i = 0; i < MT; i += 4) {
            const float4 l = *reinterpret_cast<const float4*>(xl + i);
            const float4 h = *reinterpret_cast<const float4*>(xh + i);
            xlo[i] = l.x, xlo[i + 1] = l.y, xlo[i + 2] = l.z, xlo[i + 3] = l.w;
            xhi[i] = h.x, xhi[i + 1] = h.y, xhi[i + 2] = h.z, xhi[i + 3] = h.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < MT; ++i) xlo[i] = xl[i], xhi[i] = xh[i];
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const uint32_t byte = (w[u] >> (8 * c)) & 0xFFu;
          // 2^23 + nibble as f32 bits, minus (2^23 + 8): exact, and cheaper
          // than an integer-to-float conversion.
          const float nl = __uint_as_float(0x4B000000u | (byte & 0xFu)) - 8388616.0f;
          const float nh = __uint_as_float(0x4B000000u | (byte >> 4)) - 8388616.0f;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            lo[i][c] = fmaf(xlo[i], nl, lo[i][c]);
            hi[i][c] = fmaf(xhi[i], nh, hi[i][c]);
          }
        }
      }
      if (more) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) w[u] = w_next[u];
      }
    }

    // The group's sum times its scale, then into the running sum: two
    // roundings, as the plain version has them.
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float s_lo = 0.f, s_hi = 0.f;
      if (c < cols_left) {
        s_lo = __bfloat162float(scale[static_cast<size_t>(pg) * n + n0 + c]);
        s_hi = __bfloat162float(scale[static_cast<size_t>(pg + half_groups) * n + n0 + c]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        total[i][c] = __fadd_rn(total[i][c], __fmul_rn(lo[i][c], s_lo));
        total[i][c] = __fadd_rn(total[i][c], __fmul_rn(hi[i][c], s_hi));
      }
    }
  }

  // Sum the warps in warp order: red[warp][MT][TILE_N] reuses the x tiles.
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      red[(warp * MT + i) * TILE_N + lane * COLS + c] = total[i][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < MT * TILE_N; idx += THREADS) {
    const int i = idx / TILE_N, col = idx % TILE_N;
    if (m0 + i >= m || tile_n0 + col >= n) continue;
    float sum = red[idx];
#pragma unroll
    for (int w2 = 1; w2 < WARPS; ++w2) sum = __fadd_rn(sum, red[w2 * MT * TILE_N + idx]);
    const size_t at = static_cast<size_t>(m0 + i) * n + tile_n0 + col;
    if (ksplit == 1) {
      from_float(sum, out + at);
    } else {
      partial[static_cast<size_t>(split) * m * n + at] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 activations, groups that are multiples of 32 rows: the same arithmetic
// on the tensor cores. The f32 FMAs above cost 2 * MT operations per nibble
// and set that kernel's time from M = 4 on; here a block unpacks 32 packed
// rows of its 128 columns to bf16 in shared memory (0x4300 | nibble is 128 +
// nibble in bf16, and one __hsub2 takes 136 off a pair: exact), and its four
// warps multiply them with mma.sync m16n8k16 products (bf16 in, f32 sums),
// 32 columns a warp, up to 32 rows of x (two 16-row fragments) a block, all
// of which share the one unpack. The fragments come from shared memory by
// ldmatrix (x as stored, the weights transposed on the way); the rows are
// padded by 16 bytes so that eight of them fall into eight different banks.
// A thread knows which rows and columns its accumulators hold, so a group's
// sums are multiplied by the scales and added to the running sums in
// registers, as in the kernel above. K is split over blocks only; the splits
// are added by the same finishing pass. A block multiplies 16 rows of x
// (MF = 1: fewer registers, more blocks on an SM) or 32 (MF = 2).

constexpr int TC_CHUNK = 32;                 // packed rows unpacked per step
constexpr int TC_ROWS = TC_CHUNK / WARPS;    // of them, rows a warp unpacks
constexpr int TC_MAX_MF = 2;                 // most 16-row fragments of x per block
constexpr int TC_NT = 4;                     // 8-column tiles a warp multiplies
constexpr int W_LD = TILE_N + 8;             // bf16 elements
constexpr int X_LD = 2 * MAX_GROUP + 8;

// Four nibbles (one per byte of `nib`) as four bf16 integers in [-8, 7].
__device__ __forceinline__ uint2 nibbles_to_bf16(uint32_t nib) {
  const __nv_bfloat162 offset = __float2bfloat162_rn(136.0f);
  uint32_t p01 = __byte_perm(nib, 0x43434343u, 0x4140);  // (128 + n0, 128 + n1)
  uint32_t p23 = __byte_perm(nib, 0x43434343u, 0x4342);  // (128 + n2, 128 + n3)
  __nv_bfloat162 v01 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p01), offset);
  __nv_bfloat162 v23 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p23), offset);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&v01);
  packed.y = *reinterpret_cast<uint32_t*>(&v23);
  return packed;
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: a thread gets row lane / 4, columns
// 2 * (lane % 4) and + 1 of each matrix; transposed: column lane / 4, rows
// 2 * (lane % 4) and + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, rows of x) * b (16 x 8, bf16, weights).
// c[0], c[1]: row lane / 4, columns 2 * (lane % 4) and + 1; c[2], c[3]: row + 8.
__device__ __forceinline__ void mma_16x8x16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MF>
__global__ void __launch_bounds__(THREADS)
int4_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x,        // (M, K)
                      const uint8_t* __restrict__ q4,             // (K/2, N)
                      const __nv_bfloat16* __restrict__ scale,    // (K/g, N)
                      __nv_bfloat16* __restrict__ out,            // (M, N) when ksplit == 1
                      float* __restrict__ partial,                // (ksplit, M, N) otherwise
                      int m, int k, int n, int group, int ksplit) {
  __shared__ __align__(16) __nv_bfloat16 w_lo[TC_CHUNK * W_LD];
  __shared__ __align__(16) __nv_bfloat16 w_hi[TC_CHUNK * W_LD];
  __shared__ __align__(16) __nv_bfloat16 xs[MF * 16 * X_LD];  // [row][x_lo | x_hi]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile_n0 = blockIdx.x * TILE_N;
  const int n0 = tile_n0 + lane * COLS;   // columns this thread unpacks
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MF * 16;
  const int k_half = k / 2;
  const int half_groups = k_half / group;
  const int cols_left = n - n0;
  const bool vec = (n % COLS == 0) && cols_left >= COLS &&
                   (reinterpret_cast<uintptr_t>(q4) & 3u) == 0;
  const int warp_n = warp * 8 * TC_NT;    // columns this warp multiplies, within the tile
  // ldmatrix: this lane's row of its 8 x 8 matrix, and the matrix's offsets.
  const int ld_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // x row, or weight row (k)
  const int ld_col = (lane >> 4) * 8;                     // x column (k), or weight column (n)
  // Accumulators: rows acc_row and acc_row + 8, columns acc_col and acc_col + 1 of a tile.
  const int acc_row = lane >> 2;
  const int acc_col = (lane & 3) * 2;

  float total[MF][TC_NT][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int t = 0; t < TC_NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[f][t][e] = 0.f;

  for (int pg = split; pg < half_groups; pg += ksplit) {
    __syncthreads();  // the previous group's products have read xs
    // x rows of this block, the group's low rows then its high rows, two values a copy.
    for (int idx = threadIdx.x; idx < MF * 16 * group; idx += THREADS) {
      const int row = idx / group;
      const int col = (idx % group) * 2;
      const int src = (col < group ? 0 : k_half - group) + pg * group + col;
      uint32_t pair = 0u;
      if (m0 + row < m) {
        pair = *reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(m0 + row) * k + src);
      }
      *reinterpret_cast<uint32_t*>(xs + row * X_LD + col) = pair;
    }

    float lo[MF][TC_NT][4], hi[MF][TC_NT][4];
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int t = 0; t < TC_NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) lo[f][t][e] = hi[f][t][e] = 0.f;

    // The next chunk's packed rows are loaded before this one's are unpacked.
    const uint8_t* wp = q4 + (static_cast<size_t>(pg) * group + warp * TC_ROWS) * n + n0;
    uint32_t w[TC_ROWS], w_next[TC_ROWS];
#pragma unroll
    for (int j = 0; j < TC_ROWS; ++j) {
      w[j] = cols_left > 0 ? load_packed(wp + static_cast<size_t>(j) * n, vec, cols_left)
                           : 0x88888888u;
    }
    for (int r0 = 0; r0 < group; r0 += TC_CHUNK) {
      const bool more = r0 + TC_CHUNK < group;
      if (more) {
#pragma unroll
        for (int j = 0; j < TC_ROWS; ++j) {
          w_next[j] = cols_left > 0
                          ? load_packed(wp + static_cast<size_t>(r0 + TC_CHUNK + j) * n, vec,
                                        cols_left)
                          : 0x88888888u;
        }
      }
#pragma unroll
      for (int j = 0; j < TC_ROWS; ++j) {
        const int at = (warp * TC_ROWS + j) * W_LD + lane * COLS;
        *reinterpret_cast<uint2*>(w_lo + at) = nibbles_to_bf16(w[j] & 0x0F0F0F0Fu);
        *reinterpret_cast<uint2*>(w_hi + at) = nibbles_to_bf16((w[j] >> 4) & 0x0F0F0F0Fu);
      }
      __syncthreads();  // the chunk is unpacked (and, the first time, xs is staged)

#pragma unroll
      for (int ks = 0; ks < TC_CHUNK; ks += 16) {
        uint32_t a_lo[MF][4], a_hi[MF][4];
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          const __nv_bfloat16* row = xs + (f * 16 + ld_row) * X_LD + r0 + ks + ld_col;
          ldmatrix_x4(a_lo[f], row);
          ldmatrix_x4(a_hi[f], row + group);
        }
#pragma unroll
        for (int t = 0; t < TC_NT; t += 2) {  // two 8-column tiles per load
          uint32_t b_lo[4], b_hi[4];
          const int at = (ks + ld_row) * W_LD + warp_n + t * 8 + ld_col;
          ldmatrix_x4_trans(b_lo, w_lo + at);
          ldmatrix_x4_trans(b_hi, w_hi + at);
#pragma unroll
          for (int f = 0; f < MF; ++f) {
            mma_16x8x16(lo[f][t], a_lo[f], b_lo[0], b_lo[1]);
            mma_16x8x16(lo[f][t + 1], a_lo[f], b_lo[2], b_lo[3]);
            mma_16x8x16(hi[f][t], a_hi[f], b_hi[0], b_hi[1]);
            mma_16x8x16(hi[f][t + 1], a_hi[f], b_hi[2], b_hi[3]);
          }
        }
      }
      __syncthreads();  // the chunk has been read: the next may overwrite it
      if (more) {
#pragma unroll
        for (int j = 0; j < TC_ROWS; ++j) w[j] = w_next[j];
      }
    }

    // The group's sums times its scales, into the running sums.
#pragma unroll
    for (int t = 0; t < TC_NT; ++t) {
      const int col = tile_n0 + warp_n + t * 8 + acc_col;
      float s_lo[2], s_hi[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = col + e < n;
        s_lo[e] = live ? __bfloat162float(scale[static_cast<size_t>(pg) * n + col + e]) : 0.f;
        s_hi[e] = live ? __bfloat162float(
                             scale[static_cast<size_t>(pg + half_groups) * n + col + e])
                       : 0.f;
      }
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          total[f][t][e] = __fadd_rn(total[f][t][e], __fmul_rn(lo[f][t][e], s_lo[e & 1]));
          total[f][t][e] = __fadd_rn(total[f][t][e], __fmul_rn(hi[f][t][e], s_hi[e & 1]));
        }
    }
  }

#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int t = 0; t < TC_NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + f * 16 + acc_row + (e >> 1) * 8;
        const int col = tile_n0 + warp_n + t * 8 + acc_col + (e & 1);
        if (row >= m || col >= n) continue;
        const size_t at = static_cast<size_t>(row) * n + col;
        if (ksplit == 1) {
          from_float(total[f][t][e], out + at);
        } else {
          partial[static_cast<size_t>(split) * m * n + at] = total[f][t][e];
        }
      }
}

// Adds the K splits in split order and casts.
template <typename T>
__global__ void int4_matmul_finish_kernel(const float* __restrict__ partial, T* __restrict__ out,
                                          int total, int ksplit) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = partial[idx];
  for (int s = 1; s < ksplit; ++s) sum = __fadd_rn(sum, partial[static_cast<size_t>(s) * total + idx]);
  from_float(sum, out + idx);
}

// Rows of x per block: the smallest of 1, 2, 4, 8 that holds M, else 8.
int pick_mt(int m) {
  int mt = 1;
  while (mt < m && mt < MAX_MT) mt *= 2;
  return mt;
}

// 16-row fragments of x per block of the tensor-core kernel.
int pick_mf(int m) { return m > 16 ? TC_MAX_MF : 1; }

// The tensor-core kernel takes bf16 activations and groups of whole chunks.
bool use_tensor_cores(int m, int group, bool x_is_bf16) {
  return x_is_bf16 && group % TC_CHUNK == 0 && m >= TC_MIN_M;
}

int pick_ksplit(int m, int k, int n, int group, bool x_is_bf16) {
  const int half_groups = k / 2 / group;
  const bool tc = use_tensor_cores(m, group, x_is_bf16);
  const int rows = tc ? 16 * pick_mf(m) : pick_mt(m);
  const int blocks = ((n + TILE_N - 1) / TILE_N) * ((m + rows - 1) / rows);
  // Every block (tensor cores) or every warp (FMAs) keeps at least one packed group.
  const int max_split = tc ? half_groups : half_groups / WARPS;
  int ksplit = 1;
  while (blocks * ksplit < TARGET_BLOCKS && ksplit * 2 <= max_split) ksplit *= 2;
  return ksplit;
}

size_t smem_bytes(int group, int mt) {
  const size_t tiles = static_cast<size_t>(WARPS) * 2 * group * mt;
  const size_t red = static_cast<size_t>(WARPS) * mt * TILE_N;
  return (tiles > red ? tiles : red) * sizeof(float);
}

template <typename T, int MT>
void launch_tile(const void* x, const void* q4, const void* scale, void* out, void* partial,
                 int m, int k, int n, int group, int ksplit, cudaStream_t stream) {
  const dim3 grid((n + TILE_N - 1) / TILE_N, ksplit, (m + MT - 1) / MT);
  int4_matmul_kernel<T, MT><<<grid, THREADS, smem_bytes(group, MT), stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q4),
      static_cast<const __nv_bfloat16*>(scale), static_cast<T*>(out),
      static_cast<float*>(partial), m, k, n, group, ksplit);
}

template <typename T>
int launch(const void* x, const void* q4, const void* scale, void* out, void* partial, int m,
           int k, int n, int group, bool x_is_bf16, cudaStream_t stream) {
  const int ksplit = pick_ksplit(m, k, n, group, x_is_bf16);
  if (ksplit > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (use_tensor_cores(m, group, x_is_bf16)) {
    const int rows = 16 * pick_mf(m);
    const dim3 grid((n + TILE_N - 1) / TILE_N, ksplit, (m + rows - 1) / rows);
    auto kernel = pick_mf(m) == 1 ? int4_matmul_tc_kernel<1> : int4_matmul_tc_kernel<2>;
    kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4),
        static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(partial), m, k, n, group, ksplit);
  } else {
    switch (pick_mt(m)) {
      case 1: launch_tile<T, 1>(x, q4, scale, out, partial, m, k, n, group, ksplit, stream); break;
      case 2: launch_tile<T, 2>(x, q4, scale, out, partial, m, k, n, group, ksplit, stream); break;
      case 4: launch_tile<T, 4>(x, q4, scale, out, partial, m, k, n, group, ksplit, stream); break;
      default: launch_tile<T, 8>(x, q4, scale, out, partial, m, k, n, group, ksplit, stream);
    }
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || ksplit == 1) return err;
  const int total = m * n;
  int4_matmul_finish_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), total, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of K splits the launch will use: the caller allocates the
// (ksplit, M, N) f32 scratch when it is above 1.
extern "C" int int4_matmul_ksplit(int m, int k, int n, int group, int x_is_bf16) {
  return pick_ksplit(m, k, n, group, x_is_bf16 != 0);
}

// x (M, K) bf16 (x_is_bf16) or f32; q4 (K/2, N) uint8; scale (K/g, N) bf16;
// out (M, N) in x's type; partial (ksplit, M, N) f32 or null when ksplit == 1.
// g is a multiple of 16, at most 128, and divides K/2; x is 4-byte aligned.
extern "C" int int4_matmul(const void* x, const void* q4, const void* scale, void* out,
                           void* partial, int m, int k, int n, int group, int x_is_bf16,
                           void* stream) {
  if (m < 1 || k < 2 || n < 1 || group < UNROLL || group % UNROLL != 0 || group > MAX_GROUP ||
      k % 2 != 0 || (k / 2) % group != 0 || (reinterpret_cast<uintptr_t>(x) & 3u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(x, q4, scale, out, partial, m, k, n, group, true, s)
                   : launch<float>(x, q4, scale, out, partial, m, k, n, group, false, s);
}
