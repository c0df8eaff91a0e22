// K5 — vector-quantization codeword assignment (paper §4.3, the Δcut
// codec's SH AC band).
//
// Replaces: src/repro/kernels/vq_assign.py:vq_assign_pallas (body
// _vq_kernel), the TPU kernel that scores a block of rows against the
// codebook in blocks of 128 on the MXU and carries a running (best, index).
//
// Computes, per row x: argmin_k (|c_k|^2 - 2 x.c_k). The running best is
// taken with strict `<`, so the lowest index wins a tie, which is the
// Pallas kernel's result (argmin within a block, strict `<` across blocks)
// and torch.argmin's. A NaN score wins over every number and the first NaN
// is kept, as torch.argmin does.
//
// What bounds it on the H100: operations. A row of D = 9 floats (36 B) is
// scored against all Kc = 256 codewords at 2D + 2 float32 operations each
// (~5 K operations for 40 B of traffic).
//
// Design: one thread per row. The whole codebook (256 x 9 floats, 9 KB) and
// its squared norms sit in shared memory; every thread of a warp reads the
// same codeword at the same time, so the loads are broadcasts. The row
// stays in registers (D is a template argument). The dot product sums
// d = 0..D-1 in order, one rounded product and one rounded add at a time
// (the library is built with --fmad=false), and |c_k|^2 is summed the same
// way: that is the plain PyTorch version's order, so both give the same
// bits. D = 9 is too thin for the tensor cores to pay.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int D>
__global__ void vq_assign_kernel(const float* __restrict__ x,
                                 const float* __restrict__ codebook,
                                 int32_t* __restrict__ out, int M, int Kc) {
  extern __shared__ float smem[];
  float* s_cb = smem;           // Kc * D
  float* s_c2 = smem + Kc * D;  // Kc
  for (int i = threadIdx.x; i < Kc * D; i += blockDim.x) s_cb[i] = codebook[i];
  __syncthreads();
  for (int k = threadIdx.x; k < Kc; k += blockDim.x) {
    const float* c = s_cb + k * D;
    float s = c[0] * c[0];
#pragma unroll
    for (int d = 1; d < D; ++d) s = s + c[d] * c[d];
    s_c2[k] = s;
  }
  __syncthreads();

  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < M;
       row += gridDim.x * blockDim.x) {
    float xr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xr[d] = x[static_cast<size_t>(row) * D + d];
    float best = INFINITY;
    int best_k = 0;
    bool best_nan = false;
    for (int k = 0; k < Kc; ++k) {
      const float* c = s_cb + k * D;
      float dot = xr[0] * c[0];
#pragma unroll
      for (int d = 1; d < D; ++d) dot = dot + xr[d] * c[d];
      const float score = s_c2[k] - 2.0f * dot;
      if (!best_nan) {
        if (isnan(score)) {
          best_nan = true;
          best_k = k;
        } else if (score < best) {
          best = score;
          best_k = k;
        }
      }
    }
    out[row] = best_k;
  }
}

template <int D>
int launch(const float* x, const float* cb, int32_t* out, int M, int Kc,
           int blocks, cudaStream_t stream) {
  const int smem = (Kc * D + Kc) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        vq_assign_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  vq_assign_kernel<D><<<blocks, kThreads, smem, stream>>>(x, cb, out, M, Kc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nebula_vq_assign_smem_bytes(int Kc, int D) {
  return (Kc * D + Kc) * static_cast<int>(sizeof(float));
}

// D must be one of the SH AC widths the codec produces: 1 (degree 0, the
// codec's placeholder column), 9, 24 or 45 (degrees 1-3).
extern "C" int nebula_vq_assign(const void* x, const void* codebook, void* out,
                                int M, int Kc, int D, int blocks, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(codebook);
  int32_t* op = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: return launch<1>(xp, cp, op, M, Kc, blocks, s);
    case 9: return launch<9>(xp, cp, op, M, Kc, blocks, s);
    case 24: return launch<24>(xp, cp, op, M, Kc, blocks, s);
    case 45: return launch<45>(xp, cp, op, M, Kc, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
