// K7 — flash attention (online softmax) for the LM serving path's prefill.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas
// (body _flash_kernel), the TPU kernel on a (batch, head, q-block) grid
// that streams (block_k, D) K/V chunks through VMEM with a running
// (max, denom, acc) carry.
//
// Computes, for q (B, H, Lq, D) and k, v (B, Hkv, Lk, D), head h reading kv
// head h / (H / Hkv):
//   qs  = q * scale, rounded to the input type (scale = 1/sqrt(D), itself
//         rounded to the input type by the caller);
//   s   = qs . k in float32, set to -1e30 where col >= Lk, or (causal)
//         col > row, or (window > 0) col <= row - window;
//   m, l, acc carried over kv blocks: m' = max(m, rowmax s), p = exp(s - m'),
//         alpha = exp(m - m'), l = alpha l + sum p, acc = alpha acc +
//         (p rounded to v's type) . v, all float32;
//   out = acc / max(l, 1e-30), rounded to q's type.
// The mask value is the finite -1e30 of the Pallas body, not -inf: a kv
// block whose columns are all masked for a row gives p = exp(0) = 1 there,
// and the row's first visible block wipes that with alpha = exp(-1e30 - m')
// = 0. Blocks masked for every row of a q block are skipped, which gives the
// same result. A row with no visible column at all (never the case in
// self-attention, where the diagonal is visible) gets 0, where the Pallas
// body would average the values it read.
//
// What bounds it on the H100: operations, 4 D per visible (row, col) pair.
// The card's bound is the bf16 tensor-core rate; this kernel runs on the
// float32 FMA units and is far from it (PERF.md has the ratio).
//
// Design (right and simple first; wgmma, TMA and a warp-specialised
// pipeline are later work): one block of 256 threads per (q block of 64
// rows, head, batch). The scaled Q block and one K or V tile of 64 rows
// live in shared memory as float32, rows padded to D + 1 words so that the
// 16 rows a warp reads at once fall in 16 banks; the probabilities of the
// tile go through shared memory too. Thread (ty, tx) of a 16 x 16 grid owns
// rows 4 ty .. 4 ty + 3 of the block: it computes their scores against
// columns tx + 16 j (j < 4) and accumulates their outputs in columns
// tx + 16 j (j < D / 16) in registers. Row max and row sum are shuffles
// over the 16 lanes that share a row. The running (m, l, acc) is float32 in
// registers. Shared memory: (128 (D + 1) + 64 * 65) floats, 83 KB at
// D = 128 and 181 KB at D = 320. Q blocks go from the last to the first,
// so that the causal blocks with the most kv blocks start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // rows of the block a thread owns
constexpr int kCols = 4;       // score columns of a tile a thread owns
constexpr int kLdP = kBlockK + 1;
constexpr int kMaxD = 320;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T and back: the Pallas body's casts to the input type
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

struct Strides {
  long long b, h, l;  // in elements; the last axis is contiguous
};

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long sl,
                                          int r0, int n_valid, int D, int ld) {
  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = r0 + r < n_valid ? to_f(src[(r0 + r) * sl + d]) : 0.f;
  }
}

// NJ >= D / 16: the output columns a thread owns, fixed at compile time so
// that the accumulator stays in registers.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int group,
                       int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs,
                       Strides os, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* s_q = smem;                 // kBlockQ x ld
  float* s_kv = s_q + kBlockQ * ld;  // kBlockK x ld: K, then V
  float* s_p = s_kv + kBlockK * ld;  // kBlockQ x kLdP
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qb * kBlockQ;
  const int nj = D / 16;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* op = o + b * os.b + h * os.h;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    s_q[r * ld + d] = row < Lq ? round_to<T>(to_f(qp[row * qs.l + d]) * scale) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // the kv blocks that hold a visible column for some row of this q block
  const int last_row = min(q0 + kBlockQ, Lq) - 1;
  int kb_end = (Lk + kBlockK - 1) / kBlockK;
  if (causal) kb_end = min(kb_end, last_row / kBlockK + 1);
  int kb_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kb_begin = (q0 - window + 1) / kBlockK;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int c0 = kb * kBlockK;
    __syncthreads();  // the previous tile's readers are done (and s_q is written)
    load_tile(s_kv, kp, ks.l, c0, Lk, D, ld);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[kRows], c[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = s_q[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = s_kv[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = c0 + tx + 16 * j;
        bool ok = col < Lk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        s_p[(ty * kRows + i) * kLdP + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every score of the tile is read: K can go
    load_tile(s_kv, vp, vs.l, c0, Lk, D, ld);
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = s_p[(ty * kRows + i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float x = s_kv[c * ld + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nj) op[row * os.l + tx + 16 * j] = from_f<T>(acc[i][j] / den);
  }
}

int smem_bytes(int D) {
  return ((kBlockQ + kBlockK) * (D + 1) + kBlockQ * kLdP) * static_cast<int>(sizeof(float));
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H / Hkv, Lq, Lk, D, qs, ks, vs, os, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H,
             int Hkv, int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs,
             Strides os, int causal, int window, float scale, cudaStream_t stream) {
  const int nj = D / 16;
  if (nj <= 2)
    return launch<T, 2>(q, k, v, o, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os, causal,
                        window, scale, stream);
  if (nj <= 4)
    return launch<T, 4>(q, k, v, o, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os, causal,
                        window, scale, stream);
  if (nj <= 8)
    return launch<T, 8>(q, k, v, o, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os, causal,
                        window, scale, stream);
  return launch<T, kMaxD / 16>(q, k, v, o, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os,
                               causal, window, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike). Strides in elements,
// (batch, head, row) for each tensor; the head-dim axis is contiguous.
// D must be a multiple of 16 in [16, 320], and H a multiple of Hkv.
extern "C" int nebula_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B, int H,
    int Hkv, int Lq, int Lk, int D, long long qsb, long long qsh, long long qsl,
    long long ksb, long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, long long osb, long long osh, long long osl, int causal,
    int window, float scale, void* stream) {
  if (D < 16 || D > kMaxD || D % 16 != 0 || B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      Lq < 1 || Lk < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl}, os{osb, osh, osl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os, causal,
                           window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os,
                                   causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
