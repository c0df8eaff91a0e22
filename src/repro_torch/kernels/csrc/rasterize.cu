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
// is padded with zero rows, which are exact no-ops (α = 0: T·1 = T and
// c + (T·0)·0 = c).
//
// Early exit without a barrier per entry. After the select, α ∈ {0} ∪
// [1/255, 0.99] (NaN fails `a >= 1/255` and becomes 0), so 1 − α ∈ (0, 1]
// and T·(1 − α) ≤ T in round-to-nearest: a pixel's T never increases, and
// once T ≤ eps_t it stays so. "Some pixel of this thread is alive after
// entry j" is therefore true for j below some index and false from it on,
// and a thread only has to count the entries of a window after which it
// was alive. Within the window each thread also keeps a hit mask (bit j:
// α > 0 at one of its pixels). At the window's end the warps reduce both
// (__reduce_or_sync / __reduce_max_sync) and meet at one __syncthreads:
// the block's hit bits are the OR, and the block was alive after entry j
// of the window iff j < the largest count. If that is below the window's
// length, the block stopped inside it: every thread restores the
// (T, c0, c1, c2) saved at the window's start and blends again up to the
// stop, which is exact and happens at most once a tile. Hit bytes past the
// stop and past the count are written 0. The α expression is splat_alpha's
// (repro_torch/render/common.py) in its op order, with expf (no fast math)
// and --fmad=false, so it rounds as the plain version; 2·conic_b is the
// only value computed once an entry, and doubling is exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kW = 8;          // entries blended between two block-wide votes
constexpr int kCols = 9;       // an entry in device memory
constexpr int kRow = 12;       // an entry in shared memory (48 B)
constexpr int kMaxWarps = 32;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
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
// n..kW-1 are zeroed (no-op entries).
__device__ __forceinline__ void stage_window(float* buf, const float* E, int base, int n,
                                             int tid, int nthreads) {
  for (int k = tid; k < kW * kCols; k += nthreads) {
    const int j = k / kCols, c = k - j * kCols;
    float* dst = buf + j * kRow + c;
    if (j < n) {
      cp_async4(dst, E + static_cast<size_t>(base) * kCols + k);
    } else {
      *dst = 0.0f;
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

// Blend one staged entry into a thread's P pixels (one row). Returns
// whether α > 0 at one of them; `alive` tells whether one has T > eps_t.
template <int P>
__device__ __forceinline__ bool blend(const float* row, const float* px, float py,
                                      float eps_t, Pixels* s, bool* alive) {
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
    float a = opa * expf(-power);
    // == min(a, 0.99) then (>= 1/255 ? : 0), NaN included: a NaN fails the
    // test; α > 0 exactly where it passes
    const bool h = a >= kAlphaMin;
    a = h ? fminf(a, kAlphaMax) : 0.0f;
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

template <int P>
__global__ void rasterize_kernel(const float* __restrict__ entries,
                                 const int32_t* __restrict__ counts,
                                 const int32_t* __restrict__ origins,
                                 float* __restrict__ out,
                                 uint8_t* __restrict__ hits, int L, int tile,
                                 float eps_t) {
  static_assert(kW <= 32, "a window's hit bits are one 32-bit mask");
  __shared__ __align__(16) float s_e[2][kW * kRow];
  __shared__ uint32_t s_hit[2][kMaxWarps];
  __shared__ int s_alive[2][kMaxWarps];
  const int slab = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int pix = tid * P;
  const int ty = pix / tile, tx0 = pix - ty * tile;
  const float ox = static_cast<float>(origins[2 * slab]);
  const float py = (static_cast<float>(ty) + static_cast<float>(origins[2 * slab + 1])) + 0.5f;
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
  if (1.0f > eps_t && count > 0) {
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
#pragma unroll
      for (int p = 0; p < P; ++p) saved[p] = s[p];
      uint32_t mask = 0;
      int n_alive = 0;  // entries of the window after which a pixel of mine is alive
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        bool al;
        if (blend<P>(buf + j * kRow, px, py, eps_t, s, &al)) mask |= 1u << j;
        n_alive += al ? 1 : 0;
      }
      mask = __reduce_or_sync(kFull, mask);
      n_alive = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(n_alive)));
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
      // the block blends entry j + 1 iff it was alive after entry j
      const bool stopped = n_alive < n;
      const int done = stopped ? n_alive + 1 : n;
      if (done < n) {  // blended past the stop: blend again from the window's start
#pragma unroll
        for (int p = 0; p < P; ++p) s[p] = saved[p];
        for (int j = 0; j < done; ++j) {
          bool al;
          blend<P>(buf + j * kRow, px, py, eps_t, s, &al);
        }
      }
      const uint32_t keep = done >= 32 ? kFull : ((1u << done) - 1u);
      written = min(base + kW, L);
      write_hits(H, base, written, mask & keep, tid, nthreads);
      if (stopped || base + kW >= count) break;
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

template <int P>
int launch(int n, int threads, cudaStream_t st, const float* e, const int32_t* c,
           const int32_t* org, float* out, uint8_t* hits, int L, int tile, float eps_t) {
  rasterize_kernel<P><<<n, threads, 0, st>>>(e, c, org, out, hits, L, tile, eps_t);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int nebula_rasterize_slabs(const void* entries, const void* counts,
                                      const void* origins, void* out, void* hits,
                                      int n, int L, int tile, float eps_t,
                                      void* stream) {
  const int p = pixels_per_thread(tile);
  if (p == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = tile * tile / p;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* e = static_cast<const float*>(entries);
  const int32_t* c = static_cast<const int32_t*>(counts);
  const int32_t* org = static_cast<const int32_t*>(origins);
  float* o = static_cast<float*>(out);
  uint8_t* h = static_cast<uint8_t*>(hits);
  return p == 4 ? launch<4>(n, threads, st, e, c, org, o, h, L, tile, eps_t)
                : launch<2>(n, threads, st, e, c, org, o, h, L, tile, eps_t);
}
