// K2 — tile rasterization (the paper's volume rendering core, §5).
//
// Replaces: src/repro/kernels/rasterize.py:rasterize_slabs_pallas (body
// _raster_kernel; rasterize_tiles_pallas only derives the origins), the TPU
// kernel that blends one tile's pre-gathered entries per grid cell.
//
// What bounds it on the H100: operations, not bytes. A tile reads its
// entries once (36 B each) and writes T*T*3 floats, but every entry costs
// every one of the T*T pixels about 20 float32 operations (the α
// polynomial, one expf, the blend), so at L = 256 entries a tile does
// ~1.3 M operations against ~10 KB of traffic.
//
// Design: one thread block per tile, one thread per pixel (T*T = 256 at
// tile 16). The tile's entries are staged through shared memory in chunks
// of 32 and broadcast to all pixels (the Fig. 14 attribute broadcast).
// Before each entry the block checks `i < count` and takes a vote that some
// pixel still has transmittance above eps_t (__syncthreads_or), as the
// Pallas while-loop's cond does; a second vote gives the entry's α-hit
// flag. Entries the block never processes get hit = 0. The α expression is
// splat_alpha's (repro_torch/render/common.py) in its op order, built with
// --fmad=false and expf (no fast math), so it rounds as the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;
constexpr int kCols = 9;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;

// A min that returns a NaN first argument, as torch.clamp_max and
// jnp.minimum do (fminf would return the other operand).
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : fminf(a, b);
}

__global__ void rasterize_kernel(const float* __restrict__ entries,
                                 const int32_t* __restrict__ counts,
                                 const int32_t* __restrict__ origins,
                                 float* __restrict__ out,
                                 uint8_t* __restrict__ hits, int L, int tile,
                                 float eps_t) {
  __shared__ float s_e[kChunk * kCols];
  const int slab = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % tile, ty = tid / tile;
  const float px = (static_cast<float>(tx) + static_cast<float>(origins[2 * slab])) + 0.5f;
  const float py = (static_cast<float>(ty) + static_cast<float>(origins[2 * slab + 1])) + 0.5f;
  const int count = min(static_cast<int>(counts[slab]), L);
  const float* E = entries + static_cast<size_t>(slab) * L * kCols;
  uint8_t* H = hits + static_cast<size_t>(slab) * L;

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  bool alive = 1.0f > eps_t;
  int processed = 0;
  for (int base = 0; base < count && alive; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();
    for (int k = tid; k < n * kCols; k += blockDim.x) s_e[k] = E[base * kCols + k];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* e = s_e + j * kCols;
      const float dx = px - e[0], dy = py - e[1];
      const float power = 0.5f * (e[2] * dx * dx + 2.0f * e[3] * dx * dy + e[4] * dy * dy);
      float a = e[8] * expf(-power);
      a = min_nan(a, kAlphaMax);
      a = a >= kAlphaMin ? a : 0.0f;
      const float contrib = T * a;
      c0 = c0 + contrib * e[5];
      c1 = c1 + contrib * e[6];
      c2 = c2 + contrib * e[7];
      T = T * (1.0f - a);
      const int hit = __syncthreads_or(a > 0.0f);
      if (tid == 0) H[base + j] = hit ? 1 : 0;
      ++processed;
      alive = __syncthreads_or(T > eps_t) != 0;
      if (!alive) break;
    }
  }
  for (int k = processed + tid; k < L; k += blockDim.x) H[k] = 0;
  float* o = out + ((static_cast<size_t>(slab) * tile + ty) * tile + tx) * 3;
  o[0] = c0;
  o[1] = c1;
  o[2] = c2;
}

}  // namespace

extern "C" int nebula_rasterize_slabs(const void* entries, const void* counts,
                                      const void* origins, void* out, void* hits,
                                      int n, int L, int tile, float eps_t,
                                      void* stream) {
  const int threads = tile * tile;
  if (threads > 1024 || threads % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  rasterize_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entries), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(origins), static_cast<float*>(out),
      static_cast<uint8_t*>(hits), L, tile, eps_t);
  return static_cast<int>(cudaGetLastError());
}
