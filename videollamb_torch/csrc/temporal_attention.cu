// Temporal attention core of the video tower, in three layouts.
//
// For every (video, patch position, head): softmax attention across the t
// frames (1 <= t <= 8), q pre-scaled, f32 scores and softmax, probabilities
// rounded to bf16 before the product with v, f32 accumulation, the output
// rounded once to bf16. One kernel, three entry points that differ only in
// addressing:
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
// 295, so it is bound by device memory, provided the instructions per item
// stay few and the loads overlap the math.
//
// Design. An item is one (video, position, head): an 8 x 8 problem over
// 64-wide rows. A warp takes two items at a time (consecutive in (video,
// position, head) order, so usually two neighbouring heads) and packs their
// frames into the 16 rows of one mma.sync m16n8k16 bf16 tile: rows 0-7 are
// the first item's frames, rows 8-15 the second's, unused frames zero.
//   - Staging: each warp keeps a ring of STAGES pairs in shared memory (q, k
//     and v, 16 rows x 128 bytes each, 16-byte chunks XOR-swizzled by row so
//     ldmatrix reads them without bank conflicts), filled by 16-byte
//     cp.async: the next pairs' copies are in flight while this pair's math
//     runs.
//   - S = Q K^T: ldmatrix and four k-steps of two mma.sync against the two
//     items' keys; each item keeps the 8 x 8 block of its own rows and keys
//     (the cross-item half is computed and dropped: at 4 FLOPs a byte the
//     tensor cores have room to spare).
//   - Softmax in f32 on the accumulator fragments (a row's 8 keys live in
//     the four lanes of a quad: two shuffles for the max, two for the sum),
//     keys past t masked, p = bf16(e / sum) as on the TPU.
//   - O = P V: the probabilities are already the A fragment of m16n8k16,
//     block-diagonal (cross-item entries 0), with V through ldmatrix.trans;
//     eight mma.sync give the 16 x 64 output in f32.
//   - The output goes, rounded to bf16, through the pair's q slot in shared
//     memory back to 16-byte stores.
// The grid is persistent (as many blocks as fit on the card); warp w of all
// W takes pairs w, w + W, ..., so the warps of a block stream neighbouring
// heads. Counted from the code, an item takes an order of magnitude fewer
// warp instructions than when one warp solved one item with a shuffle
// reduction per score.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int E = 64;       // head dim: 128 bytes, eight 16-byte chunks a row
constexpr int T_MAX = 8;    // frames per temporal window
constexpr int WARPS = 4;
constexpr int STAGES = 3;   // pairs a warp's ring holds
constexpr int TILE = 16 * E;            // bf16 elements of one operand of a pair
constexpr int PAIR = 3 * TILE;          // q, k, v
constexpr size_t SMEM = static_cast<size_t>(WARPS) * STAGES * PAIR * 2;

// x / d for 0 <= x < 2^31 by a multiply and a shift (d >= 1): s = ceil(log2 d),
// m = floor(2^32 (2^s - d) / d) + 1.
struct FastDiv {
  uint32_t m, s;
  FastDiv() = default;
  explicit FastDiv(uint32_t div) : m(0), s(0) {
    while ((1ull << s) < div) ++s;
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << s) - div)) / div + 1);
  }
  __device__ __forceinline__ int operator()(int x) const {
    return static_cast<int>((__umulhi(static_cast<uint32_t>(x), m) + static_cast<uint32_t>(x)) >> s);
  }
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  int items;  // b * n * heads
  int pairs;
  int t, n, heads, in_stride, out_stride;
  int frame_step;  // rows from one frame of an item to the next
  FastDiv by_heads, by_n;
  bool frame_major;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Element offset of 16-byte chunk c of row r in a 16 x 64 tile.
__device__ __forceinline__ int swz(int r, int c) { return r * E + ((c ^ (r & 7)) << 3); }

// First row of an item (frame 0) and its head: frame-major layouts keep the
// n positions of a frame together, the (b, n, t, d) layout the t frames of a
// position.
__device__ __forceinline__ long long item_row0(const Params& p, int item, int& head) {
  const int bn = p.by_heads(item);  // bi * n + pos
  head = item - bn * p.heads;
  const int bi = p.by_n(bn);
  const int pos = bn - bi * p.n;
  return p.frame_major ? static_cast<long long>(bi) * p.t * p.n + pos
                       : static_cast<long long>(bn) * p.t;
}

__global__ void __launch_bounds__(WARPS * 32)
temporal_attention_kernel(const Params p) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * WARPS;
  const int first = blockIdx.x * WARPS + warp;
  const int n_w = first < p.pairs ? (p.pairs - 1 - first) / n_warps + 1 : 0;
  __nv_bfloat16* ring = smem + static_cast<size_t>(warp) * STAGES * PAIR;
  const uint32_t ring_addr = smem_addr(ring);

  // Copies: lane takes chunk c of frames f and f + 4 of both items.
  const int c = lane & 7, f = lane >> 3;
  auto issue = [&](int j) {
    if (j < n_w) {
      const int pair = first + j * n_warps;
      const uint32_t slot = ring_addr + (j % STAGES) * PAIR * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int item = 2 * pair + half;
        int head = 0;
        const long long row0 = item < p.items ? item_row0(p, item, head) : 0;
#pragma unroll
        for (int ff = 0; ff < 2; ++ff) {
          const int fr = f + 4 * ff, r = half * 8 + fr;
          const bool ok = item < p.items && fr < p.t;
          const long long off =
              ok ? (row0 + fr * p.frame_step) * p.in_stride + head * E + c * 8 : 0;
          const uint32_t dst = slot + swz(r, c) * 2;
          cp_async16(dst, p.q + off, ok);
          cp_async16(dst + TILE * 2, p.k + off, ok);
          cp_async16(dst + 2 * TILE * 2, p.v + off, ok);
        }
      }
    }
    cp_async_commit();
  };

  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, lane in the quad
  const bool key0 = 2 * tig < p.t, key1 = 2 * tig + 1 < p.t;
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);
  for (int j = 0; j < n_w; ++j) {
    issue(j + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const uint32_t sq = ring_addr + (j % STAGES) * PAIR * 2;
    const uint32_t sk = sq + TILE * 2, sv = sq + 2 * TILE * 2;

    // S = Q K^T over the two items' keys (n-tile 0: first item, 1: second).
    float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks = 0; ks < E / 16; ++ks) {
      uint32_t a[4], bk[4];
      ldmatrix_x4(a, sq + swz(lane & 15, 2 * ks + (lane >> 4)) * 2);
      ldmatrix_x4(bk, sk + swz(((lane >> 4) << 3) + (lane & 7), 2 * ks + ((lane >> 3) & 1)) * 2);
      mma16816(s0, a, bk[0], bk[1]);
      mma16816(s1, a, bk[2], bk[3]);
    }

    // Row g of the first item is s0[0..1], row g of the second s1[2..3]:
    // keys 2 * tig and 2 * tig + 1, the row's other keys in the quad.
    float x[2][2] = {{key0 ? s0[0] : -INFINITY, key1 ? s0[1] : -INFINITY},
                     {key0 ? s1[2] : -INFINITY, key1 ? s1[3] : -INFINITY}};
    uint32_t pk[2];
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      float mx = fmaxf(x[it][0], x[it][1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float e0 = expf(x[it][0] - mx), e1 = expf(x[it][1] - mx);
      float sum = e0 + e1;
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.0f / sum;
      pk[it] = pack_bf16(e0 * inv, e1 * inv);
    }
    // A fragment of P (16 rows x 16 keys), block-diagonal.
    const uint32_t pa[4] = {pk[0], 0u, 0u, pk[1]};

    // O = P V: n-tiles of 8 dims, two per ldmatrix.x4.trans.
    float o[E / 8][4];
#pragma unroll
    for (int nt = 0; nt < E / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
#pragma unroll
    for (int np = 0; np < E / 16; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, sv + swz(((lane >> 3) & 1) * 8 + (lane & 7), 2 * np + (lane >> 4)) * 2);
      mma16816(o[2 * np], pa, bv[0], bv[1]);
      mma16816(o[2 * np + 1], pa, bv[2], bv[3]);
    }

    // Output through the q slot: row g (first item) and g + 8 (second).
    __syncwarp();  // every lane is done reading q
    __nv_bfloat16* tile = ring + (j % STAGES) * PAIR;
#pragma unroll
    for (int nt = 0; nt < E / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(tile + swz(g, nt) + 2 * tig) = pack_bf16(o[nt][0], o[nt][1]);
      *reinterpret_cast<uint32_t*>(tile + swz(g + 8, nt) + 2 * tig) =
          pack_bf16(o[nt][2], o[nt][3]);
    }
    __syncwarp();
    const int pair = first + j * n_warps;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int item = 2 * pair + half;
      if (item >= p.items) continue;
      int head;
      const long long row0 = item_row0(p, item, head);
#pragma unroll
      for (int ff = 0; ff < 2; ++ff) {
        const int fr = f + 4 * ff;
        if (fr < p.t)
          *reinterpret_cast<uint4*>(p.out + (row0 + fr * p.frame_step) * p.out_stride +
                                    head * E + c * 8) =
              *reinterpret_cast<const uint4*>(tile + swz(half * 8 + fr, c));
      }
    }
    __syncwarp();  // the slot is refilled by the next pair's copies
  }
  cp_async_wait<0>();
}

int launch(const void* q, const void* k, const void* v, void* out, int b, int t, int n,
           int d, int heads, int in_stride, bool frame_major, void* stream) {
  const long long items = static_cast<long long>(b) * n * heads;
  if (d != heads * E || t < 1 || t > T_MAX || n < 1 || heads < 1 || items >= (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return static_cast<int>(cudaSuccess);
  static int blocks_per_sm = 0;  // the same for every launch: one kernel, fixed shared memory
  if (blocks_per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        temporal_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, temporal_attention_kernel,
                                                        WARPS * 32, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.items = static_cast<int>(items);
  p.pairs = static_cast<int>((items + 1) / 2);
  p.t = t;
  p.n = n;
  p.heads = heads;
  p.by_heads = FastDiv(heads);
  p.by_n = FastDiv(n);
  p.in_stride = in_stride;
  p.out_stride = d;
  p.frame_major = frame_major;
  p.frame_step = frame_major ? n : 1;
  const int blocks = std::min((p.pairs + WARPS - 1) / WARPS, sms * blocks_per_sm);
  temporal_attention_kernel<<<blocks, WARPS * 32, SMEM,
                              static_cast<cudaStream_t>(stream)>>>(p);
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
