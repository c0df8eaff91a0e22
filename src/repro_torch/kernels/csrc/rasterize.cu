// K2 — tile rasterization (the paper's volume rendering core, §5).
//
// Replaces: src/repro/kernels/rasterize.py:rasterize_slabs_pallas (body
// _raster_kernel; rasterize_tiles_pallas only derives the origins), the TPU
// kernel that blends one tile's pre-gathered entries per grid cell.
//
// What bounds it on the H100: instruction issue. A tile reads its entries
// once (36 B each) and writes T*T*3 floats, but every entry costs each of
// the T*T pixels the α polynomial, one expf and the blend: about 30
// float32 instructions (built with --fmad=false, so nothing is fused), at
// L = 256 entries ~2 M instructions a tile against ~10 KB of traffic, so
// the design spends as few instructions as it can around that core.
//
// Design: one block a tile, P pixels of one row a thread (P = 4 where
// tile*tile/4 is a multiple of 32, else 2), so dy and conic_c·dy·dy are
// computed once for P pixels and every shared load serves P pixels.
// Entries go through shared memory in windows of kW = 8 (8 was faster
// than 16 and 32 on the H100 at the session's shapes, see PERF.md), staged by
// cp.async into a double buffer (the next window loads while this one
// blends) as 48-byte rows [mx, my, ca, cb | cc, r, g, b | opa] read with
// two 16-byte broadcast loads and one 4-byte load. A partial last window
// is padded with rows of zeros and a NaN opacity, which are exact no-ops
// under any thresholds (α = 0: T·1 = T and c + (T·0)·0 = c).
//
// α thresholds. splat_alpha computes α = min(opa·expf(−power), alpha_max),
// then 0 unless it is ≥ alpha_min (a NaN fails the test). The kernel
// computes "pass = a ≥ alpha_min, α = pass ? fminf(a, alpha_max) : 0" and
// hit = α > 0. The two are equal wherever alpha_min ≤ alpha_max: if a ≥
// alpha_min then min(a, alpha_max) ≥ alpha_min too, if a < alpha_min then
// min(a, alpha_max) < alpha_min, and a NaN fails both. The wrapper turns
// every pair with no α that can pass (alpha_max < alpha_min, or a NaN)
// into alpha_min = NaN, so nothing passes.
//
// Early exit without a barrier per entry. A tile may stop only while a
// pixel's T cannot increase: with 0 < alpha_min and alpha_max ≤ 1, α ∈
// {0} ∪ [alpha_min, 1], so 1 − α ∈ [0, 1] and T·(1 − α) ≤ T in
// round-to-nearest, and once T ≤ eps_t it stays so. "Some pixel of this
// thread is alive after entry j" is therefore true for j below some index
// and false from it on, and a thread only has to count the entries of a
// window after which it was alive. Other thresholds (α < 0 or α > 1
// possible) set can_stop = 0: every entry up to the count is blended and
// eps_t is ignored. Within the window each thread also keeps a hit mask
// (bit j: α > 0 at one of its pixels). At the window's end the warps
// reduce both (__reduce_or_sync / __reduce_max_sync) and meet at one
// __syncthreads: the block's hit bits are the OR, and the block was alive
// after entry j of the window iff j < the largest count. If that is below
// the window's length, the block stopped inside it: every thread restores
// the (T, c0, c1, c2) saved at the window's start and blends again up to
// the stop, which is exact and happens at most once a tile. The α
// expression is splat_alpha's (repro_torch/render/common.py) in its op
// order, with expf (no fast math) and --fmad=false, so it rounds as the
// plain version; 2·conic_b is the only value computed once an entry, and
// doubling is exact.
//
// Hits past the stop. With hits_past_stop = 0 (the reference's Pallas
// contract) hit bytes past the stop are 0. With hits_past_stop = 1 (the
// reference's default path, which has no stop) every entry up to the count
// gets its flag: the stopping window's mask already holds all of its
// entries (a hit does not depend on T), and the windows after it run a
// hit-only pass, the α core and the block-wide OR with no T and no color.
// Hit bytes past the count are 0 in both. The contract is a template
// argument (kFlagPast), so the Pallas-contract kernel carries none of the
// hit-only code.
//
// The hit-only pass takes a window in up to three stages, each ended by a
// block-wide OR of the window's bits. First one thread an entry evaluates
// α at the tile's pixel nearest the splat's centre. The entries no thread
// found a hit for then take stage 2: every thread evaluates the pixel of
// its own row nearest the centre in x. The entries still without a hit
// take stage 3: every thread evaluates all its pixels. Each evaluation is
// the blend's own ops on that pixel's own position, so it is that pixel's
// α. This is exact under any thresholds: it never reports a hit it did
// not compute, and it computes every pixel of the tile before it reports
// none.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kW = 8;          // entries blended between two block-wide votes
constexpr int kCols = 9;       // an entry in device memory
constexpr int kRow = 12;       // an entry in shared memory (48 B)
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage entries [base, base + n) of a tile into a window buffer; rows
// n..kW-1 are no-op entries (see the note).
__device__ __forceinline__ void stage_window(float* buf, const float* E, int base, int n,
                                             int tid, int nthreads) {
  for (int k = tid; k < kW * kCols; k += nthreads) {
    const int j = k / kCols, c = k - j * kCols;
    float* dst = buf + j * kRow + c;
    if (j < n) {
      cp_async4(dst, E + static_cast<size_t>(base) * kCols + k);
    } else {
      *dst = c == 8 ? __int_as_float(0x7fc00000) : 0.0f;  // opacity NaN
    }
  }
}

// Write hit bytes [a, b) of a tile's row: bit (k - a) of `bits` for k <
// a + 32, 0 after; 4-byte stores where the row is aligned.
__device__ __forceinline__ void write_hits(uint8_t* H, int a, int b, uint32_t bits,
                                           int tid, int nthreads) {
  const int head = min(b, a + static_cast<int>((4 - (reinterpret_cast<uintptr_t>(H + a) & 3)) & 3));
  for (int k = a + tid; k < head; k += nthreads)
    H[k] = (k - a < 32) ? static_cast<uint8_t>((bits >> (k - a)) & 1u) : 0;
  const int words = (b - head) / 4;
  uint32_t* H4 = reinterpret_cast<uint32_t*>(H + head);
  for (int w = tid; w < words; w += nthreads) {
    uint32_t v = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int off = head + 4 * w + q - a;
      if (off < 32) v |= ((bits >> off) & 1u) << (8 * q);
    }
    H4[w] = v;
  }
  for (int k = head + 4 * words + tid; k < b; k += nthreads)
    H[k] = (k - a < 32) ? static_cast<uint8_t>((bits >> (k - a)) & 1u) : 0;
}

struct Pixels {
  float T, c0, c1, c2;
};

struct Alpha {
  float amin, amax;
};

// α after the thresholds, and whether it is > 0 (see the note above).
__device__ __forceinline__ float threshold(float a, Alpha t, bool* hit) {
  const float al = a >= t.amin ? fminf(a, t.amax) : 0.0f;
  *hit = al > 0.0f;
  return al;
}

// Blend one staged entry into a thread's P pixels (one row). Returns
// whether α > 0 at one of them; `alive` tells whether one has T > eps_t.
template <int P>
__device__ __forceinline__ bool blend(const float* row, const float* px, float py,
                                      float eps_t, Alpha t, Pixels* s, bool* alive) {
  const float4 e0 = *reinterpret_cast<const float4*>(row);      // mx, my, ca, cb
  const float4 e1 = *reinterpret_cast<const float4*>(row + 4);  // cc, r, g, b
  const float opa = row[8];
  const float cb2 = 2.0f * e0.w;
  const float dy = py - e0.y;
  const float cyy = e1.x * dy * dy;
  bool hit = false, al = false;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float dx = px[p] - e0.x;
    const float power = 0.5f * (e0.z * dx * dx + cb2 * dx * dy + cyy);
    bool h;
    const float a = threshold(opa * expf(-power), t, &h);
    const float contrib = s[p].T * a;
    s[p].c0 = s[p].c0 + contrib * e1.y;
    s[p].c1 = s[p].c1 + contrib * e1.z;
    s[p].c2 = s[p].c2 + contrib * e1.w;
    s[p].T = s[p].T * (1.0f - a);
    hit |= h;
    al |= s[p].T > eps_t;
  }
  *alive = al;
  return hit;
}

// The α core of the hit-only pass: α > 0 at pixel x-centre `px` of row
// `py` (the blend's op order).
__device__ __forceinline__ bool hit_at(const float4& e0, float cyy, float dy, float opa,
                                       float px, Alpha t) {
  const float dx = px - e0.x;
  const float power = 0.5f * (e0.z * dx * dx + (2.0f * e0.w) * dx * dy + cyy);
  bool h;
  threshold(opa * expf(-power), t, &h);
  return h;
}

// Stage 2 of the hit-only pass: α > 0 at the thread's pixel nearest the
// splat's centre in x (pixel p's centre is (tx0 + p + ox) + 0.5, as the
// blend's). Stage 3 (`all_pixels`): at one of the thread's P pixels.
template <int P>
__device__ __forceinline__ bool hit_nearest(const float* row, int tx0, float ox, float py,
                                            Alpha t) {
  const float4 e0 = *reinterpret_cast<const float4*>(row);  // mx, my, ca, cb
  const float dy = py - e0.y;
  const float cyy = row[4] * dy * dy;
  const float px0 = (static_cast<float>(tx0) + ox) + 0.5f;
  // nearest of 0..P-1 (a NaN centre picks 0)
  const int p = static_cast<int>(fminf(fmaxf(rintf(e0.x - px0), 0.0f), P - 1.0f));
  return hit_at(e0, cyy, dy, row[8], (static_cast<float>(tx0 + p) + ox) + 0.5f, t);
}

template <int P>
__device__ __forceinline__ bool all_pixels(const float* row, const float* px, float py,
                                           Alpha t) {
  const float4 e0 = *reinterpret_cast<const float4*>(row);
  const float dy = py - e0.y;
  const float cyy = row[4] * dy * dy;
  bool hit = false;
#pragma unroll
  for (int p = 0; p < P; ++p) hit |= hit_at(e0, cyy, dy, row[8], px[p], t);
  return hit;
}

template <int P, bool kFlagPast>
__global__ void rasterize_kernel(const float* __restrict__ entries,
                                 const int32_t* __restrict__ counts,
                                 const int32_t* __restrict__ origins,
                                 float* __restrict__ out,
                                 uint8_t* __restrict__ hits, int L, int tile,
                                 float eps_t, Alpha thr, int can_stop) {
  static_assert(kW <= 32, "a window's hit bits are one 32-bit mask");
  __shared__ __align__(16) float s_e[2][kW * kRow];
  __shared__ uint32_t s_hit[2][kMaxWarps];
  __shared__ int s_alive[2][kMaxWarps];
  __shared__ uint32_t s_rest[2][kMaxWarps];  // the hit-only pass's stages 2 and 3
  const int slab = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int pix = tid * P;
  const int ty = pix / tile, tx0 = pix - ty * tile;
  const float ox = static_cast<float>(origins[2 * slab]);
  const float oy = static_cast<float>(origins[2 * slab + 1]);
  const float py = (static_cast<float>(ty) + oy) + 0.5f;
  float px[P];
#pragma unroll
  for (int p = 0; p < P; ++p) px[p] = (static_cast<float>(tx0 + p) + ox) + 0.5f;
  const int count = min(static_cast<int>(counts[slab]), L);
  const float* E = entries + static_cast<size_t>(slab) * L * kCols;
  uint8_t* H = hits + static_cast<size_t>(slab) * L;

  Pixels s[P];
#pragma unroll
  for (int p = 0; p < P; ++p) s[p] = Pixels{1.0f, 0.0f, 0.0f, 0.0f};
  int written = 0;  // hit bytes [0, written) are final
  // block-uniform: blending until the tile stops, then (hits_past_stop)
  // flags only; the tile is tested before its first entry too (T = 1)
  bool blending = !can_stop || 1.0f > eps_t;
  if (count > 0 && (blending || kFlagPast)) {
    stage_window(s_e[0], E, 0, min(kW, count), tid, nthreads);
    cp_async_commit();
    if (count > kW) stage_window(s_e[1], E, kW, min(kW, count - kW), tid, nthreads);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    for (int win = 0;; ++win) {
      const int base = win * kW, n = min(kW, count - base), b = win & 1;
      const float* buf = s_e[b];
      Pixels saved[P];
      uint32_t mask = 0;
      int n_alive = 0;  // entries of the window after which a pixel of mine is alive
      // (the Pallas contract leaves the loop at the stop: it always blends)
      if (!kFlagPast || blending) {
#pragma unroll
        for (int p = 0; p < P; ++p) saved[p] = s[p];
#pragma unroll
        for (int j = 0; j < kW; ++j) {
          bool al;
          if (blend<P>(buf + j * kRow, px, py, eps_t, thr, s, &al))
            mask |= 1u << j;
          n_alive += al ? 1 : 0;
        }
        n_alive = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(n_alive)));
      } else if (kFlagPast && tid < n) {  // stage 1: thread j, entry j
        const float* row = buf + tid * kRow;
        const float4 e0 = *reinterpret_cast<const float4*>(row);
        // the tile's pixel nearest the centre: whole numbers 0..tile-1 (a
        // NaN centre picks 0), so (c + o) + 0.5 is that pixel's centre
        const float last = static_cast<float>(tile - 1);
        const float cx = fminf(fmaxf(rintf(e0.x - (ox + 0.5f)), 0.0f), last);
        const float cy = fminf(fmaxf(rintf(e0.y - (oy + 0.5f)), 0.0f), last);
        const float dy = ((cy + oy) + 0.5f) - e0.y;
        if (hit_at(e0, row[4] * dy * dy, dy, row[8], (cx + ox) + 0.5f, thr))
          mask = 1u << tid;
      }
      mask = __reduce_or_sync(kFull, mask);
      if (lane == 0) {
        s_hit[b][warp] = mask;
        s_alive[b][warp] = n_alive;
      }
      cp_async_wait<0>();  // the next window, staged one window ago
      __syncthreads();
      mask = 0;
      n_alive = 0;
      for (int w = 0; w < nwarps; ++w) {
        mask |= s_hit[b][w];
        n_alive = max(n_alive, s_alive[b][w]);
      }
      // the hit-only pass: entries of the window (not the padding) without a
      // hit take stage 2, then stage 3
      uint32_t rest = (blending || !kFlagPast) ? 0u : ((1u << n) - 1u) & ~mask;
#pragma unroll
      for (int stage = 0; stage < 2; ++stage) {
        if (!kFlagPast || !rest) break;
        uint32_t more = 0;
#pragma unroll
        for (int j = 0; j < kW; ++j) {
          if (!((rest >> j) & 1u)) continue;
          const float* row = buf + j * kRow;
          if (stage == 0 ? hit_nearest<P>(row, tx0, ox, py, thr)
                         : all_pixels<P>(row, px, py, thr))
            more |= 1u << j;
        }
        more = __reduce_or_sync(kFull, more);
        if (lane == 0) s_rest[stage][warp] = more;
        __syncthreads();
        for (int w = 0; w < nwarps; ++w) mask |= s_rest[stage][w];
        rest &= ~mask;
      }
      uint32_t keep = kFull;
      if (!kFlagPast || blending) {
        // the block blends entry j + 1 iff it was alive after entry j
        const bool stopped = can_stop && n_alive < n;
        const int done = stopped ? n_alive + 1 : n;
        if (done < n) {  // blended past the stop: blend again from the window's start
#pragma unroll
          for (int p = 0; p < P; ++p) s[p] = saved[p];
          for (int j = 0; j < done; ++j) {
            bool al;
            blend<P>(buf + j * kRow, px, py, eps_t, thr, s, &al);
          }
        }
        if (!kFlagPast) keep = done >= 32 ? kFull : ((1u << done) - 1u);
        blending = !stopped;
      }
      written = min(base + kW, L);
      write_hits(H, base, written, mask & keep, tid, nthreads);
      if ((!blending && !kFlagPast) || base + kW >= count) break;
      // every thread is past this window's reads: its buffer takes window + 2
      if (base + 2 * kW < count)
        stage_window(s_e[b], E, base + 2 * kW, min(kW, count - base - 2 * kW), tid,
                     nthreads);
      cp_async_commit();
    }
  }
  write_hits(H, written, L, 0u, tid, nthreads);
  float2* o = reinterpret_cast<float2*>(
      out + ((static_cast<size_t>(slab) * tile + ty) * tile + tx0) * 3);
#pragma unroll
  for (int p = 0; p < P; p += 2) {
    o[3 * (p / 2)] = make_float2(s[p].c0, s[p].c1);
    o[3 * (p / 2) + 1] = make_float2(s[p].c2, s[p + 1].c0);
    o[3 * (p / 2) + 2] = make_float2(s[p + 1].c1, s[p + 1].c2);
  }
}

struct Args {
  const float* e;
  const int32_t* c;
  const int32_t* org;
  float* out;
  uint8_t* hits;
  int L, tile;
  float eps_t;
  Alpha thr;
  int can_stop;
};

template <int P, bool kFlagPast>
int launch(int n, int threads, cudaStream_t st, const Args& a) {
  rasterize_kernel<P, kFlagPast><<<n, threads, 0, st>>>(
      a.e, a.c, a.org, a.out, a.hits, a.L, a.tile, a.eps_t, a.thr, a.can_stop);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch(int n, int threads, cudaStream_t st, const Args& a, bool flag_past) {
  return flag_past ? launch<P, true>(n, threads, st, a) : launch<P, false>(n, threads, st, a);
}

// Pixels a thread for a tile side: 4 where tile*tile/4 threads fill whole
// warps, else 2; 0 if the kernel does not take the tile.
int pixels_per_thread(int tile) {
  const int px = tile * tile;
  if (tile <= 0 || px > 1024 || tile % 2 != 0) return 0;
  if (tile % 4 == 0 && (px / 4) % 32 == 0) return 4;
  if ((px / 2) % 32 == 0) return 2;
  return 0;
}

}  // namespace

// alpha_min/alpha_max: the α thresholds (see the note; the wrapper has
// mapped a pair under which nothing passes to alpha_min = NaN). can_stop:
// the tile may stop once max T ≤ eps_t (the wrapper sets it iff 0 <
// alpha_min and alpha_max ≤ 1). hits_past_stop: flag the entries after a
// stop too (the reference's default path).
extern "C" int nebula_rasterize_slabs(const void* entries, const void* counts,
                                      const void* origins, void* out, void* hits,
                                      int n, int L, int tile, float eps_t,
                                      float alpha_min, float alpha_max, int can_stop,
                                      int hits_past_stop, void* stream) {
  const int p = pixels_per_thread(tile);
  if (p == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = tile * tile / p;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(entries), static_cast<const int32_t*>(counts),
               static_cast<const int32_t*>(origins), static_cast<float*>(out),
               static_cast<uint8_t*>(hits), L, tile, eps_t, Alpha{alpha_min, alpha_max},
               can_stop};
  const bool f = hits_past_stop != 0;
  return p == 4 ? launch<4>(n, threads, st, a, f) : launch<2>(n, threads, st, a, f);
}
