// Depth-ordered tile binning over the pairs a frame has (the `bin_shared`
// stage of the client render).
//
// Replaces: no TPU kernel. The reference (src/repro/core/binning.py:
// bin_tiles) bins with `jnp` sorts over the whole (splat, tile) pair
// budget, and the port's plain version (core/binning.py:bin_tiles_plain)
// does the same: a budget-wide searchsorted, gathers and two stable int64
// argsorts, whatever the frame needs. At the session's budget of 2^28 pairs
// that was 150 device ms of a 183 ms frame, for frames that needed 20-37%
// of the budget before the precise cull.
//
// Function (the plain version's, bit for bit): each visible splat covers
// the tiles of its α-box, row-major; the pairs are numbered in splat-index
// order and those at or past `max_pairs` are dropped; a pair is kept if its
// tile's nearest point lies within the splat's cull radius²
// (dx·dx + dy·dy <= r2, rounded as PyTorch rounds it: no contraction). Each
// tile lists its kept splats by (depth rank, index), up to L of them, -1
// padded; counts = min(pairs a tile, L).
//
// What bounds it on the H100: bytes. Each splat's box and counts are read
// and written a few times (about 60 B a splat), each kept pair is written
// once by the emit (2-byte tile key, 4-byte splat id) and read and written
// once by each of the sort's two 8-bit passes, and the lists are written
// once (n_tiles · L · 4 B). The pairs that the cull drops cost arithmetic
// only, and the pairs past the need cost nothing.
//
// Design, one launch each:
//   1. nebula_bin_spans, a thread a splat: the visibility test, the tile
//      span and its pair count.
//   (torch: an inclusive sum of the counts in index order, the pre-cull
//   pair numbers, whose last entry is the need.)
//   2. nebula_bin_count, balanced over pairs: a block takes chunks of 2048
//      consecutive pair numbers (8 consecutive a thread), finds each pair's
//      splat by a binary search into the offsets of its chunk's splats only,
//      culls it, and counts the kept pairs a splat (one atomic a run of a
//      thread's pairs in one splat) and a chunk.
//   (torch: exclusive sums of the kept counts over splats in (rank, index)
//   order, and in index order, and over chunks; the kept total is read to
//   the host, the chain's one blocking read, and sizes every buffer.)
//   3. nebula_bin_emit: the same walk; a block scan numbers the kept pairs
//      in index order, which with the two sums places each pair in (rank,
//      index, row-major) order. It writes the pair's tile as the key (16
//      bits where the grid has at most 65536 tiles, else 32) and its splat
//      id.
//   4. nebula_bin_sort: CUB's stable radix sort by tile over the kept pairs
//      only (DeviceRadixSort::SortPairs on double buffers, end_bit = the
//      bits of n_tiles - 1: two 8-bit passes on a 16-bit key, each moving
//      the 2-byte key and the 4-byte id in and out). Stability keeps each
//      tile's pairs in (rank, index) order, which a splat meeting a tile at
//      most once makes the plain version's order.
//   5. nebula_bin_fill, a block a tile: two binary searches of the sorted
//      keys find the tile's run (so no pass counts pairs a tile, and no
//      atomics do); the first min(run, L) ids, -1 after, the clamped count,
//      and the overflow flag, set where a run exceeds L or the need exceeds
//      the budget (every writer stores 1: the result is the same every run).
//
// The wrapper allocates every buffer with torch.empty; scratch for CUB's
// sort is asked of it first (nebula_bin_sort with temp == NULL).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                       // consecutive pairs a thread
constexpr int kChunk = kThreads * kItems;       // pairs a block takes at a time
constexpr float kIntLimit = 1073741824.0f;      // 2^30, the plain version's clamp

// torch.maximum and clamp_min: NaN in, NaN out
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// floor(v / tile) as the plain version's _floor_div_tile: a correctly
// rounded division, the floor, a clamp to ±2^30, then the cast
__device__ __forceinline__ int floor_div_tile(float v, float tile) {
  const float f = floorf(__fdiv_rn(v, tile));
  return static_cast<int>(fminf(fmaxf(f, -kIntLimit), kIntLimit));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__global__ void __launch_bounds__(kThreads) bin_spans_kernel(
    const float* __restrict__ mean2d, const float* __restrict__ ext,
    const uint8_t* __restrict__ visible, int4* __restrict__ box,
    long long* __restrict__ n_pairs, int m, float width, float height, int tile,
    int tiles_x, int tiles_y) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= m) return;
  const float mx = mean2d[2 * g], my = mean2d[2 * g + 1];
  const float ex = ext[2 * g], ey = ext[2 * g + 1];
  const bool vis = visible[g] != 0 && __fadd_rn(mx, ex) >= 0.0f &&
                   __fsub_rn(mx, ex) <= width && __fadd_rn(my, ey) >= 0.0f &&
                   __fsub_rn(my, ey) <= height;
  const float ft = static_cast<float>(tile);
  const int x0 = clampi(floor_div_tile(__fsub_rn(mx, ex), ft), 0, tiles_x - 1);
  const int x1 = clampi(floor_div_tile(__fadd_rn(mx, ex), ft), 0, tiles_x - 1);
  const int y0 = clampi(floor_div_tile(__fsub_rn(my, ey), ft), 0, tiles_y - 1);
  const int y1 = clampi(floor_div_tile(__fadd_rn(my, ey), ft), 0, tiles_y - 1);
  const int w = vis ? x1 - x0 + 1 : 0;
  const int h = vis ? y1 - y0 + 1 : 0;
  box[g] = make_int4(x0, y0, w, h);
  n_pairs[g] = static_cast<long long>(w) * h;
}

// the first g in [lo, hi) with off[g] > p (off is non-decreasing)
__device__ __forceinline__ int first_above(const long long* __restrict__ off, int lo, int hi,
                                           long long p) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (off[mid] > p) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// One block's chunk of pair numbers: each thread's kItems pairs, their
// splats, tiles and kept bits. `off` is the inclusive sum of the pair counts.
struct Pairs {
  int gid[kItems];
  int tile[kItems];
  unsigned keep;
};

struct Walk {
  const long long* off;
  const int4* box;
  const float* mean2d;
  const float* r2;       // NULL: no precise cull
  int m;
  long long max_pairs;
  int tile;
  int tiles_x;

  __device__ long long limit() const {
    return m > 0 ? min(off[m - 1], max_pairs) : 0;
  }

  // The chunk at `base`: the block's splat range, then each thread's pairs.
  __device__ void chunk(long long base, long long lim, int* range, Pairs& out) const {
    if (threadIdx.x == 0)          // two warps search at once
      range[0] = first_above(off, 0, m, base);
    else if (threadIdx.x == 32)
      range[1] = first_above(off, 0, m, min(base + kChunk, lim) - 1) + 1;
    __syncthreads();
    const int lo = range[0], hi = range[1];
    out.keep = 0u;
    const long long p0 = base + static_cast<long long>(threadIdx.x) * kItems;
    if (p0 >= lim) return;
    int g = first_above(off, lo, hi, p0);
    long long start = 0;
    int4 b = make_int4(0, 0, 1, 0);
    float mx = 0.0f, my = 0.0f, rr = 0.0f;
    int loaded = -1;
    const float ft = static_cast<float>(tile);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long p = p0 + i;
      if (p < lim) {
        if (off[g] <= p) g = first_above(off, g + 1, hi, p);
        if (g != loaded) {
          b = box[g];
          start = off[g] - static_cast<long long>(b.z) * b.w;
          mx = mean2d[2 * g];
          my = mean2d[2 * g + 1];
          if (r2) rr = r2[g];
          loaded = g;
        }
        const int local = static_cast<int>(p - start);
        const int tx = b.x + local % b.z;
        const int ty = b.y + local / b.z;
        bool kept = true;
        if (r2) {
          const float cx0 = static_cast<float>(tx * tile);
          const float cy0 = static_cast<float>(ty * tile);
          const float dx = nan_max(nan_max(__fsub_rn(cx0, mx), __fsub_rn(mx, __fadd_rn(cx0, ft))),
                                   0.0f);
          const float dy = nan_max(nan_max(__fsub_rn(cy0, my), __fsub_rn(my, __fadd_rn(cy0, ft))),
                                   0.0f);
          kept = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= rr;
        }
        out.gid[i] = g;
        out.tile[i] = ty * tiles_x + tx;
        if (kept) out.keep |= 1u << i;
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads) bin_count_kernel(
    Walk walk, int* __restrict__ kept, int* __restrict__ chunk_kept) {
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename Reduce::TempStorage temp;
  __shared__ int range[2];
  const long long lim = walk.limit();
  const long long n_chunks = (lim + kChunk - 1) / kChunk;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    Pairs pr;
    walk.chunk(c * kChunk, lim, range, pr);
    int run_g = -1, run_n = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (pr.keep >> i & 1u) {
        if (pr.gid[i] != run_g) {
          if (run_n) atomicAdd(kept + run_g, run_n);
          run_g = pr.gid[i];
          run_n = 0;
        }
        ++run_n;
      }
    }
    if (run_n) atomicAdd(kept + run_g, run_n);
    const int total = Reduce(temp).Sum(__popc(pr.keep));
    if (threadIdx.x == 0) chunk_kept[c] = total;
    __syncthreads();
  }
}

// pos_base[g] = (kept pairs of the splats before g in (rank, index) order)
// - (kept pairs of the splats before g in index order); a kept pair whose
// index-order kept number is q goes to pos_base[g] + q.
template <class Key>
__global__ void __launch_bounds__(kThreads) bin_emit_kernel(
    Walk walk, const long long* __restrict__ chunk_base,
    const long long* __restrict__ pos_base, Key* __restrict__ keys,
    int32_t* __restrict__ vals) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage temp;
  __shared__ int range[2];
  const long long lim = walk.limit();
  const long long n_chunks = (lim + kChunk - 1) / kChunk;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    Pairs pr;
    walk.chunk(c * kChunk, lim, range, pr);
    int before;
    Scan(temp).ExclusiveSum(__popc(pr.keep), before);
    long long q = chunk_base[c] + before;
    int base_g = -1;
    long long base = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (pr.keep >> i & 1u) {
        const int g = pr.gid[i];
        if (g != base_g) {
          base = pos_base[g];
          base_g = g;
        }
        const long long pos = base + q;
        keys[pos] = static_cast<Key>(pr.tile[i]);
        vals[pos] = g;
        ++q;
      }
    }
    __syncthreads();
  }
}

constexpr int kFillThreads = 128;

// the first i in [0, n) with keys[i] >= t (keys sorted)
template <class Key>
__device__ __forceinline__ long long first_at_least(const Key* __restrict__ keys, long long n,
                                                    unsigned t) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (static_cast<unsigned>(keys[mid]) >= t) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <class Key>
__global__ void __launch_bounds__(kFillThreads) bin_fill_kernel(
    const Key* __restrict__ keys, const int32_t* __restrict__ vals, long long n_kept,
    const long long* __restrict__ need, long long max_pairs, int32_t* __restrict__ lists,
    int32_t* __restrict__ counts, bool* __restrict__ overflow, int L) {
  __shared__ long long run[2];
  const unsigned t = blockIdx.x;
  if (threadIdx.x == 0)          // two warps search at once
    run[0] = first_at_least(keys, n_kept, t);
  else if (threadIdx.x == 32)
    run[1] = first_at_least(keys, n_kept, t + 1);
  __syncthreads();
  const long long c = run[1] - run[0];
  const int n = static_cast<int>(min(c, static_cast<long long>(L)));
  int32_t* row = lists + static_cast<long long>(t) * L;
  for (int i = threadIdx.x; i < L; i += kFillThreads) row[i] = i < n ? vals[run[0] + i] : -1;
  if (threadIdx.x == 0) {
    counts[t] = n;
    if (c > L || (t == 0 && *need > max_pairs)) *overflow = true;
  }
}

Walk make_walk(const void* off, const void* box, const void* mean2d, const void* r2, int m,
               long long max_pairs, int tile, int tiles_x) {
  return Walk{static_cast<const long long*>(off), static_cast<const int4*>(box),
              static_cast<const float*>(mean2d), static_cast<const float*>(r2), m, max_pairs,
              tile, tiles_x};
}

template <class Key>
cudaError_t sort_pairs(void* keys, void* vals, int n, int end_bit, void* temp,
                       long long* temp_bytes, int* selector, cudaStream_t stream) {
  Key* k = static_cast<Key*>(keys);
  int32_t* v = static_cast<int32_t*>(vals);
  cub::DoubleBuffer<Key> dk(k, k + n);
  cub::DoubleBuffer<int32_t> dv(v, v + n);
  size_t bytes = static_cast<size_t>(*temp_bytes);
  const cudaError_t e =
      cub::DeviceRadixSort::SortPairs(temp, bytes, dk, dv, n, 0, end_bit, stream);
  *temp_bytes = static_cast<long long>(bytes);
  if (temp != nullptr) *selector = dk.selector;
  return e;
}

}  // namespace

extern "C" int nebula_bin_spans(const void* mean2d, const void* ext, const void* visible,
                                void* box, void* n_pairs, int m, int width, int height,
                                int tile, int tiles_x, int tiles_y, void* stream) {
  if (tile < 1 || tiles_x < 1 || tiles_y < 1 || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  bin_spans_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean2d), static_cast<const float*>(ext),
      static_cast<const uint8_t*>(visible), static_cast<int4*>(box),
      static_cast<long long*>(n_pairs), m, static_cast<float>(width),
      static_cast<float>(height), tile, tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nebula_bin_count(const void* offsets, const void* box, const void* mean2d,
                                const void* r2, void* kept, void* chunk_kept, int m,
                                long long max_pairs, int tile, int tiles_x, int grid,
                                void* stream) {
  if (m < 0 || grid < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || grid == 0) return 0;
  bin_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_walk(offsets, box, mean2d, r2, m, max_pairs, tile, tiles_x),
      static_cast<int*>(kept), static_cast<int*>(chunk_kept));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nebula_bin_emit(const void* offsets, const void* box, const void* mean2d,
                               const void* r2, const void* chunk_base, const void* pos_base,
                               void* keys, void* vals, int m, long long max_pairs, int tile,
                               int tiles_x, int wide_key, int grid, void* stream) {
  if (m < 0 || grid < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || grid == 0) return 0;
  const Walk walk = make_walk(offsets, box, mean2d, r2, m, max_pairs, tile, tiles_x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* cb = static_cast<const long long*>(chunk_base);
  const long long* pb = static_cast<const long long*>(pos_base);
  if (wide_key)
    bin_emit_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        walk, cb, pb, static_cast<uint32_t*>(keys), static_cast<int32_t*>(vals));
  else
    bin_emit_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        walk, cb, pb, static_cast<uint16_t*>(keys), static_cast<int32_t*>(vals));
  return static_cast<int>(cudaGetLastError());
}

// keys and vals each hold 2n entries (the double buffer: input in the first
// n). With temp == NULL, writes the scratch bytes CUB needs to *temp_bytes
// (a host long long) and sorts nothing; else sorts and writes to *selector
// (a host int) which half holds the result.
extern "C" int nebula_bin_sort(void* keys, void* vals, int n, int wide_key, int end_bit,
                               void* temp, void* temp_bytes, void* selector, void* stream) {
  if (n < 0 || end_bit < 1 || end_bit > (wide_key ? 32 : 16))
    return static_cast<int>(cudaErrorInvalidValue);
  long long* tb = static_cast<long long*>(temp_bytes);
  int* sel = static_cast<int*>(selector);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      wide_key ? sort_pairs<uint32_t>(keys, vals, n, end_bit, temp, tb, sel, s)
               : sort_pairs<uint16_t>(keys, vals, n, end_bit, temp, tb, sel, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// keys, vals: the sorted half of the double buffers; need: the pairs needed
// before the budget (a device long long); overflow: a device bool, false
extern "C" int nebula_bin_fill(const void* keys, const void* vals, long long n_kept,
                               const void* need, long long max_pairs, void* lists, void* counts,
                               void* overflow, int n_tiles, int list_len, int wide_key,
                               void* stream) {
  if (n_tiles < 0 || list_len < 0 || n_kept < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* v = static_cast<const int32_t*>(vals);
  const long long* nd = static_cast<const long long*>(need);
  int32_t* l = static_cast<int32_t*>(lists);
  int32_t* c = static_cast<int32_t*>(counts);
  bool* o = static_cast<bool*>(overflow);
  if (wide_key)
    bin_fill_kernel<uint32_t><<<n_tiles, kFillThreads, 0, s>>>(
        static_cast<const uint32_t*>(keys), v, n_kept, nd, max_pairs, l, c, o, list_len);
  else
    bin_fill_kernel<uint16_t><<<n_tiles, kFillThreads, 0, s>>>(
        static_cast<const uint16_t*>(keys), v, n_kept, nd, max_pairs, l, c, o, list_len);
  return static_cast<int>(cudaGetLastError());
}
