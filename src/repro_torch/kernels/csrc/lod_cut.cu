// K1 — fully-streaming LoD slab sweep (paper §4.2), and K6 — the same
// sweep over pooled (client, slab) pairs.
//
// Replaces: src/repro/kernels/lod_cut.py:lod_slab_sweep_pallas (K1; body
// _sweep_body), the TPU kernel that sweeps one subtree slab per grid cell
// with one shared camera and τ, and lod_pair_sweep_pallas (K6), which runs
// the same body over K gathered (client, slab) pairs, each with its own
// camera and τ. One kernel template serves both: kPerPair reads cam[slab]
// and tau[slab] where K1 reads the shared camera and τ.
//
// What bounds it on the H100: bytes. Each node is read once (mu 12 B, size,
// parent and level 4 B each, leaf and valid 1 B each) and its cut bit is
// written once; the arithmetic is a few flops per node. The level loop is a
// chain of max_depth+1 dependent passes over the slab, so the work of one
// slab is latency bound unless the slab stays on chip.
//
// Design: one thread block per slab. A first pass computes each node's
// distance, `proj > tau` bit and ρ margin, and stages gt/parent/level in
// shared memory (11 B per node: about 16 KB at S = 1488). The level loop
// then runs entirely out of shared memory, one pass per level with a
// __syncthreads() between levels; S exceeds the block size, so each thread
// strides over several nodes. ρ is a block min (warp shuffles, then one
// value per warp). Float order matches the plain PyTorch version: dist =
// sqrtf(fmaf(d2, d2, fmaf(d1, d1, d0*d0))), the rounding of the reference's
// compiled norm; the library is built with --fmad=false, so no other
// multiply is contracted. An all-invalid slab gets ρ = +inf, as the reference's
// _slab_sweep_one gives (the Pallas body wrote 3.4e38).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr float kEpsDist = 1e-6f;

// a max that returns a NaN first argument, as torch.clamp and jnp.maximum
// do (fmaxf would return the other operand).
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : fmaxf(a, b);
}
template <bool kPerPair>
__global__ void lod_sweep_kernel(
    const float* __restrict__ mu, const float* __restrict__ size,
    const int32_t* __restrict__ parent, const int32_t* __restrict__ level,
    const uint8_t* __restrict__ leaf, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ rpe, const float* __restrict__ cams,
    const float* __restrict__ taus, float focal, float tau_shared,
    uint8_t* __restrict__ out_cut,
    uint8_t* __restrict__ out_rexp, float* __restrict__ out_rho, int S,
    int max_depth) {
  extern __shared__ unsigned char smem[];
  int32_t* s_parent = reinterpret_cast<int32_t*>(smem);
  int32_t* s_level = s_parent + S;
  uint8_t* s_gt = reinterpret_cast<uint8_t*>(s_level + S);
  uint8_t* s_exp = s_gt + S;
  uint8_t* s_pexp = s_exp + S;
  __shared__ float s_min[kThreads / 32];

  const int slab = blockIdx.x;
  const size_t base = static_cast<size_t>(slab) * S;
  const float* cam = kPerPair ? cams + 3 * static_cast<size_t>(slab) : cams;
  const float c0 = cam[0], c1 = cam[1], c2 = cam[2];
  const float tau = kPerPair ? taus[slab] : tau_shared;
  const uint8_t root_pe = rpe[slab] != 0;

  float local_min = INFINITY;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const float* m = mu + (base + j) * 3;
    float d0 = m[0] - c0, d1 = m[1] - c1, d2 = m[2] - c2;
    float dist = sqrtf(fmaf(d2, d2, fmaf(d1, d1, d0 * d0)));
    float sz = size[base + j];
    float proj = sz * focal / max_nan(dist, kEpsDist);
    s_gt[j] = proj > tau;
    s_parent[j] = parent[base + j];
    s_level[j] = level[base + j];
    s_exp[j] = 0;
    s_pexp[j] = 0;
    if (valid[base + j]) {
      float rstar = sz * focal / tau;
      local_min = fminf(local_min, fabsf(dist - rstar));
    }
  }
  __syncthreads();

  for (int l = 0; l <= max_depth; ++l) {
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
      if (s_level[j] == l) {
        int p = s_parent[j];
        uint8_t pe = p < 0 ? root_pe : s_exp[min(max(p, 0), S - 1)];
        s_pexp[j] = pe;
        s_exp[j] = pe & s_gt[j];
      }
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    uint8_t v = valid[base + j] != 0;
    uint8_t lf = leaf[base + j] != 0;
    out_cut[base + j] = s_pexp[j] & ((!s_gt[j]) | lf) & v;
  }
  if (threadIdx.x == 0) out_rexp[slab] = s_exp[0] & (valid[base] != 0);

  for (int off = 16; off > 0; off >>= 1)
    local_min = fminf(local_min, __shfl_xor_sync(0xffffffffu, local_min, off));
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = local_min;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < (blockDim.x >> 5) ? s_min[threadIdx.x] : INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (threadIdx.x == 0) out_rho[slab] = v;
  }
}

}  // namespace

extern "C" int nebula_lod_slab_sweep_smem_bytes(int S) {
  return S * (4 + 4 + 1 + 1 + 1);
}

namespace {

template <bool kPerPair>
int launch(const void* mu, const void* size, const void* parent,
           const void* level, const void* leaf, const void* valid,
           const void* rpe, const void* cams, const void* taus, float focal,
           float tau, void* out_cut, void* out_rexp, void* out_rho, int n,
           int S, int max_depth, void* stream) {
  int smem = nebula_lod_slab_sweep_smem_bytes(S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lod_sweep_kernel<kPerPair>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lod_sweep_kernel<kPerPair>
      <<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(mu), static_cast<const float*>(size),
          static_cast<const int32_t*>(parent), static_cast<const int32_t*>(level),
          static_cast<const uint8_t*>(leaf), static_cast<const uint8_t*>(valid),
          static_cast<const uint8_t*>(rpe), static_cast<const float*>(cams),
          static_cast<const float*>(taus), focal, tau,
          static_cast<uint8_t*>(out_cut), static_cast<uint8_t*>(out_rexp),
          static_cast<float*>(out_rho), S, max_depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: ns slabs, one camera (3 floats) and one τ.
extern "C" int nebula_lod_slab_sweep(
    const void* mu, const void* size, const void* parent, const void* level,
    const void* leaf, const void* valid, const void* rpe, const void* cam,
    float focal, float tau, void* out_cut, void* out_rexp, void* out_rho,
    int ns, int S, int max_depth, void* stream) {
  return launch<false>(mu, size, parent, level, leaf, valid, rpe, cam, nullptr,
                       focal, tau, out_cut, out_rexp, out_rho, ns, S, max_depth,
                       stream);
}

// K6: k gathered (client, slab) pairs, a camera (k, 3) and a τ (k,) each.
extern "C" int nebula_lod_pair_sweep(
    const void* mu, const void* size, const void* parent, const void* level,
    const void* leaf, const void* valid, const void* rpe, const void* cams,
    const void* taus, float focal, void* out_cut, void* out_rexp,
    void* out_rho, int k, int S, int max_depth, void* stream) {
  return launch<true>(mu, size, parent, level, leaf, valid, rpe, cams, taus,
                      focal, 0.0f, out_cut, out_rexp, out_rho, k, S, max_depth,
                      stream);
}
