// K3 — shared stereo EWA preprocessing (paper Fig. 13 left).
//
// Replaces: src/repro/kernels/preprocess.py:preprocess_pallas (body
// _preprocess_kernel), the TPU kernel that projects one block of Gaussians
// per grid cell.
//
// What bounds it on the H100: bytes. Per Gaussian it reads 3+3+4+1+3K floats
// and writes 17 (about 116 B in, 68 B out at K = 4) against roughly 250
// flops, far below the card's 20 flops per byte of float32 balance.
//
// Design: one thread per Gaussian, no shared memory; the 26-float packed
// camera (layout of the reference's pack_camera) is read through the
// read-only path and stays in L1. Every 3x3 product is written out as
// ((a0*b0 + a1*b1) + a2*b2), in the order of the plain PyTorch version
// (repro_torch/kernels/preprocess.py:preprocess_plain), and the library is
// built with --fmad=false and without fast math (expf/logf/sqrtf), so the
// visibility bit and the extents round as the plain version rounds.
// Output rows are [mean2d(2), depth, conic(3), ext(2), color_l(3),
// color_r(3), opacity, disparity, visible].

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kShC0 = 0.28209479177387814f;
constexpr float kShC1 = 0.4886025119029199f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kCovBlur = 0.3f;
constexpr int kOutCols = 17;

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

template <int K>
__global__ void preprocess_kernel(const float* __restrict__ mu,
                                  const float* __restrict__ log_scale,
                                  const float* __restrict__ quat,
                                  const float* __restrict__ opacity,
                                  const float* __restrict__ sh,
                                  const float* __restrict__ cam,
                                  float* __restrict__ out, int m) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float* P = cam;
  const float f = P[12], cx = P[13], cy = P[14], near = P[15], far = P[16];
  const float baseline = P[17], width = P[24], height = P[25];
  // w2c row r is P[3 + 3r .. 3 + 3r + 2]
  const float* W = P + 3;

  float m0 = mu[3 * i], m1 = mu[3 * i + 1], m2 = mu[3 * i + 2];
  float d0 = m0 - P[0], d1 = m1 - P[1], d2 = m2 - P[2];
  float t0 = dot3(d0, d1, d2, W[0], W[1], W[2]);
  float t1 = dot3(d0, d1, d2, W[3], W[4], W[5]);
  float z = dot3(d0, d1, d2, W[6], W[7], W[8]);
  float inv_z = 1.0f / max_nan(z, 1e-6f);
  float mx = f * t0 * inv_z + cx;
  float my = f * t1 * inv_z + cy;

  float q0 = quat[4 * i], q1 = quat[4 * i + 1], q2 = quat[4 * i + 2],
        q3 = quat[4 * i + 3];
  float qn = sqrtf(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3) + 1e-12f;
  float w_ = q0 / qn, x_ = q1 / qn, y_ = q2 / qn, z_ = q3 / qn;
  float R[3][3] = {
      {1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_), 2 * (x_ * z_ + w_ * y_)},
      {2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_), 2 * (y_ * z_ - w_ * x_)},
      {2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_), 1 - 2 * (x_ * x_ + y_ * y_)}};
  float s[3] = {expf(log_scale[3 * i]), expf(log_scale[3 * i + 1]),
                expf(log_scale[3 * i + 2])};
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

  float opa = opacity[i];
  float tau2 = max_nan(2.0f * logf(max_nan(opa, kAlphaMin) / kAlphaMin), 0.0f);
  float ext_x = sqrtf(tau2 * a);
  float ext_y = sqrtf(tau2 * c);

  float dl[3], dr[3], col_l[3], col_r[3];
  unit_dir(m0, m1, m2, P + 18, dl);
  unit_dir(m0, m1, m2, P + 21, dr);
  sh_color<K>(sh + static_cast<size_t>(i) * K * 3, dl[0], dl[1], dl[2], col_l);
  sh_color<K>(sh + static_cast<size_t>(i) * K * 3, dr[0], dr[1], dr[2], col_r);

  bool visible = (z > near) && (z < far) && (opa > kAlphaMin) &&
                 (mx + ext_x >= 0.0f) && (mx - ext_x <= width) &&
                 (my + ext_y >= 0.0f) && (my - ext_y <= height);

  float* o = out + static_cast<size_t>(i) * kOutCols;
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
  o[15] = baseline * f * inv_z;
  o[16] = visible ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int nebula_preprocess(const void* mu, const void* log_scale,
                                 const void* quat, const void* opacity,
                                 const void* sh, const void* cam, void* out,
                                 int m, int k, void* stream) {
  const int threads = 256;
  const int blocks = (m + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a[6] = {static_cast<const float*>(mu), static_cast<const float*>(log_scale),
                       static_cast<const float*>(quat), static_cast<const float*>(opacity),
                       static_cast<const float*>(sh), static_cast<const float*>(cam)};
  float* o = static_cast<float*>(out);
  switch (k) {
    case 1: preprocess_kernel<1><<<blocks, threads, 0, st>>>(a[0], a[1], a[2], a[3], a[4], a[5], o, m); break;
    case 4: preprocess_kernel<4><<<blocks, threads, 0, st>>>(a[0], a[1], a[2], a[3], a[4], a[5], o, m); break;
    case 9: preprocess_kernel<9><<<blocks, threads, 0, st>>>(a[0], a[1], a[2], a[3], a[4], a[5], o, m); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
