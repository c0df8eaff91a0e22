// K3 — shared stereo EWA preprocessing (paper Fig. 13 left).
//
// Replaces: src/repro/kernels/preprocess.py:preprocess_pallas (body
// _preprocess_kernel), the TPU kernel that projects one block of Gaussians
// per grid cell.
//
// What bounds it on the H100: bytes. Per Gaussian it reads 3+3+4+1+3K floats
// and writes 16 and a byte (about 116 B in, 65 B out at K = 4) against roughly 250
// flops, far below the card's 20 flops per byte of float32 balance.
//
// Design: a block of kRows = 256 threads takes a run of 256 rows, one
// thread a row. The rows arrive in array-of-structs layout (strides of 3,
// 4 and 3K words), which one thread a row would read as scattered words, so
// the block first stages each input array's run into shared memory with
// 16-byte cp.async copies (every run is a multiple of 16 bytes at 256 rows,
// for K = 1, 4 and 9; a tail block or an unaligned array takes 4-byte
// copies). Each thread then reads its row from shared memory (strides 3,
// 4-as-one-16-byte-load, 1 and 3K; at K = 4 the 12-word SH row is read as
// three 16-byte loads, which no two threads of a quarter-warp share a bank
// for), computes, and writes its 16 floats into a shared output tile at
// stride 17 (odd: no bank conflicts); the block stores the tile with
// coalesced 16-byte stores, and `visible` as a bool array.
//
// The camera: the tensors that live on the card (the widened camera's
// position, camera→world rotation and focal, both eyes' positions, the
// right one as StereoRig.right makes it) are read where they lie, the host
// scalars (cx, cy, near, far, baseline, width, height) come by value, so
// the wrapper launches no copy to the device and does not wait on the
// stream. Every 3x3 product is written out as
// ((a0*b0 + a1*b1) + a2*b2), in the order of the plain PyTorch version
// (repro_torch/kernels/preprocess.py:preprocess_plain), and the library is
// built with --fmad=false and without fast math (expf/logf/sqrtf), so the
// visibility bit and the extents round as the plain version rounds.
// Output rows are [mean2d(2), depth, conic(3), ext(2), color_l(3),
// color_r(3), opacity, disparity].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kShC0 = 0.28209479177387814f;
constexpr float kShC1 = 0.4886025119029199f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kCovBlur = 0.3f;
constexpr int kOutCols = 16;
constexpr int kTileStride = kOutCols + 1;  // odd: a warp's row writes miss no bank twice
constexpr int kRows = 256;     // rows (threads) a block

struct HostCam {
  float cx, cy, near, far, baseline, width, height;
};

// A max that returns a NaN first argument, as torch.clamp_min and
// jnp.maximum do (fmaxf would return the other operand). Splats behind the
// camera reach det = inf - inf = NaN, and their conic must stay NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : fmaxf(a, b);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return a0 * b0 + a1 * b1 + a2 * b2;
}

template <int K>
__device__ __forceinline__ void sh_color(const float* sh, float x, float y,
                                         float z, float* out) {
  for (int ch = 0; ch < 3; ++ch) {
    float c = kShC0 * sh[0 * 3 + ch];
    if (K >= 4) {
      c = c - kShC1 * y * sh[1 * 3 + ch] + kShC1 * z * sh[2 * 3 + ch] -
          kShC1 * x * sh[3 * 3 + ch];
    }
    if (K >= 9) {
      float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z,
            xz = x * z;
      c = c + 1.0925484305920792f * xy * sh[4 * 3 + ch] -
          1.0925484305920792f * yz * sh[5 * 3 + ch] +
          0.31539156525252005f * (2.0f * zz - xx - yy) * sh[6 * 3 + ch] -
          1.0925484305920792f * xz * sh[7 * 3 + ch] +
          0.5462742152960396f * (xx - yy) * sh[8 * 3 + ch];
    }
    out[ch] = max_nan(c + 0.5f, 0.0f);
  }
}

__device__ __forceinline__ void unit_dir(float m0, float m1, float m2,
                                         const float* eye, float* d) {
  float d0 = m0 - eye[0], d1 = m1 - eye[1], d2 = m2 - eye[2];
  float n = sqrtf(d0 * d0 + d1 * d1 + d2 * d2) + 1e-12f;
  d[0] = d0 / n;
  d[1] = d1 / n;
  d[2] = d2 / n;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copy n floats of a block's run into shared memory (coalesced).
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int tid) {
  if (n % 4 == 0 && aligned16(src)) {
    for (int i = tid; i < n / 4; i += kRows) cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = tid; i < n; i += kRows) cp_async4(dst + i, src + i);
  }
}

template <int K>
constexpr int smem_floats() {
  return kRows * (3 + 3 + 4 + 1 + 3 * K + kTileStride);
}

template <int K>
__global__ void __launch_bounds__(kRows) preprocess_kernel(
    const float* __restrict__ mu, const float* __restrict__ log_scale,
    const float* __restrict__ quat, const float* __restrict__ opacity,
    const float* __restrict__ sh, const float* __restrict__ cam_pos,
    const float* __restrict__ cam_rot, const float* __restrict__ cam_focal,
    const float* __restrict__ left_pos, const float* __restrict__ right_pos, HostCam hc,
    float* __restrict__ out, bool* __restrict__ visible_out, int m) {
  extern __shared__ __align__(16) float smem[];
  float* s_mu = smem;                    // every offset a multiple of 4 floats
  float* s_ls = s_mu + 3 * kRows;
  float* s_q = s_ls + 3 * kRows;
  float* s_opa = s_q + 4 * kRows;
  float* s_sh = s_opa + kRows;
  float* s_out = s_sh + 3 * K * kRows;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - row0);
  stage(s_mu, mu + 3 * static_cast<size_t>(row0), 3 * rows, tid);
  stage(s_ls, log_scale + 3 * static_cast<size_t>(row0), 3 * rows, tid);
  stage(s_q, quat + 4 * static_cast<size_t>(row0), 4 * rows, tid);
  stage(s_opa, opacity + row0, rows, tid);
  stage(s_sh, sh + 3 * K * static_cast<size_t>(row0), 3 * K * rows, tid);
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (tid < rows) {
    const int i = tid;
    const float f = __ldg(cam_focal);
    float P[3], W[9], el[3], er[3];
    for (int k = 0; k < 3; ++k) {
      P[k] = __ldg(cam_pos + k);
      el[k] = __ldg(left_pos + k);
      er[k] = __ldg(right_pos + k);
    }
    // w2c row r is W[3r .. 3r + 2]: column r of the camera→world rotation
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) W[3 * r + c] = __ldg(cam_rot + 3 * c + r);

    float m0 = s_mu[3 * i], m1 = s_mu[3 * i + 1], m2 = s_mu[3 * i + 2];
    float d0 = m0 - P[0], d1 = m1 - P[1], d2 = m2 - P[2];
    float t0 = dot3(d0, d1, d2, W[0], W[1], W[2]);
    float t1 = dot3(d0, d1, d2, W[3], W[4], W[5]);
    float z = dot3(d0, d1, d2, W[6], W[7], W[8]);
    float inv_z = 1.0f / max_nan(z, 1e-6f);
    float mx = f * t0 * inv_z + hc.cx;
    float my = f * t1 * inv_z + hc.cy;

    const float4 q = *reinterpret_cast<const float4*>(s_q + 4 * i);
    float qn = sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w) + 1e-12f;
    float w_ = q.x / qn, x_ = q.y / qn, y_ = q.z / qn, z_ = q.w / qn;
    float R[3][3] = {
        {1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_), 2 * (x_ * z_ + w_ * y_)},
        {2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_), 2 * (y_ * z_ - w_ * x_)},
        {2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_), 1 - 2 * (x_ * x_ + y_ * y_)}};
    float s[3] = {expf(s_ls[3 * i]), expf(s_ls[3 * i + 1]), expf(s_ls[3 * i + 2])};
    float rs[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) rs[a][b] = R[a][b] * s[b];
    float cov3[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        cov3[a][b] = dot3(rs[a][0], rs[a][1], rs[a][2], rs[b][0], rs[b][1], rs[b][2]);

    float J[2][3] = {{f * inv_z, 0.0f, -f * t0 * inv_z * inv_z},
                     {0.0f, f * inv_z, -f * t1 * inv_z * inv_z}};
    float jw[2][3];
    for (int r = 0; r < 2; ++r)
      for (int c = 0; c < 3; ++c)
        jw[r][c] = dot3(J[r][0], J[r][1], J[r][2], W[c], W[3 + c], W[6 + c]);
    float tmp[2][3];
    for (int r = 0; r < 2; ++r)
      for (int c = 0; c < 3; ++c)
        tmp[r][c] = dot3(jw[r][0], jw[r][1], jw[r][2], cov3[0][c], cov3[1][c], cov3[2][c]);
    float cov2[2][2];
    for (int r = 0; r < 2; ++r)
      for (int c = 0; c < 2; ++c)
        cov2[r][c] = dot3(tmp[r][0], tmp[r][1], tmp[r][2], jw[c][0], jw[c][1], jw[c][2]);
    float a = cov2[0][0] + kCovBlur;
    float b = cov2[0][1];
    float c = cov2[1][1] + kCovBlur;
    float det = max_nan(a * c - b * b, 1e-12f);

    float opa = s_opa[i];
    float tau2 = max_nan(2.0f * logf(max_nan(opa, kAlphaMin) / kAlphaMin), 0.0f);
    float ext_x = sqrtf(tau2 * a);
    float ext_y = sqrtf(tau2 * c);

    float shr[3 * K];
    const float* srow = s_sh + 3 * K * i;
    if constexpr (K == 4) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(srow + 4 * k);
        shr[4 * k] = v.x;
        shr[4 * k + 1] = v.y;
        shr[4 * k + 2] = v.z;
        shr[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3 * K; ++k) shr[k] = srow[k];
    }
    float dl[3], dr[3], col_l[3], col_r[3];
    unit_dir(m0, m1, m2, el, dl);
    unit_dir(m0, m1, m2, er, dr);
    sh_color<K>(shr, dl[0], dl[1], dl[2], col_l);
    sh_color<K>(shr, dr[0], dr[1], dr[2], col_r);

    bool visible = (z > hc.near) && (z < hc.far) && (opa > kAlphaMin) &&
                   (mx + ext_x >= 0.0f) && (mx - ext_x <= hc.width) &&
                   (my + ext_y >= 0.0f) && (my - ext_y <= hc.height);

    float* o = s_out + i * kTileStride;
    o[0] = mx;
    o[1] = my;
    o[2] = z;
    o[3] = c / det;
    o[4] = -b / det;
    o[5] = a / det;
    o[6] = ext_x;
    o[7] = ext_y;
    o[8] = col_l[0];
    o[9] = col_l[1];
    o[10] = col_l[2];
    o[11] = col_r[0];
    o[12] = col_r[1];
    o[13] = col_r[2];
    o[14] = opa;
    o[15] = hc.baseline * f * inv_z;
    visible_out[row0 + i] = visible;
  }
  __syncthreads();
  // `out` is the wrapper's own allocation: every row is 64 B, 16-byte aligned
  float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(row0) * kOutCols);
  for (int k = tid; k < rows * (kOutCols / 4); k += kRows) {
    const float* src = s_out + (k / (kOutCols / 4)) * kTileStride + 4 * (k % (kOutCols / 4));
    dst[k] = make_float4(src[0], src[1], src[2], src[3]);
  }
}

template <int K>
int launch(int m, cudaStream_t st, const float* const* a, HostCam hc, float* o, bool* vis) {
  constexpr int bytes = smem_floats<K>() * 4;
  // above 48 KB (K = 9) only after opting in, which is per device: set on
  // every launch
  cudaError_t e = cudaFuncSetAttribute(preprocess_kernel<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  preprocess_kernel<K><<<(m + kRows - 1) / kRows, kRows, bytes, st>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], hc, o, vis, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nebula_preprocess(const void* mu, const void* log_scale,
                                 const void* quat, const void* opacity,
                                 const void* sh, const void* cam_pos, const void* cam_rot,
                                 const void* cam_focal, const void* left_pos,
                                 const void* right_pos, float cx, float cy, float near,
                                 float far, float baseline, float width, float height,
                                 void* out, void* visible, int m, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a[10] = {
      static_cast<const float*>(mu),      static_cast<const float*>(log_scale),
      static_cast<const float*>(quat),    static_cast<const float*>(opacity),
      static_cast<const float*>(sh),      static_cast<const float*>(cam_pos),
      static_cast<const float*>(cam_rot), static_cast<const float*>(cam_focal),
      static_cast<const float*>(left_pos), static_cast<const float*>(right_pos)};
  const HostCam hc{cx, cy, near, far, baseline, width, height};
  float* o = static_cast<float*>(out);
  bool* vis = static_cast<bool*>(visible);
  switch (k) {
    case 1: return launch<1>(m, st, a, hc, o, vis);
    case 4: return launch<4>(m, st, a, hc, o, vis);
    case 9: return launch<9>(m, st, a, hc, o, vis);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
