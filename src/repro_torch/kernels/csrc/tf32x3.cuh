// float32 products on Hopper's tensor cores as three TF32 products, shared by
// K7's forward (flash_attention.cu) and its backward (flash_attention_bwd.cu).
//
// One TF32 product keeps 11 bits of each operand, which misses K7's float32
// contract (2e-5). Split each operand x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest, ties away (cvt.rna's rounding:
// the tensor core would truncate whatever low bits it is given); x - hi is
// exact in float32.
// Then a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi: the dropped a_lo b_lo and
// the rounding of lo are about 2^-22 of |a b|, close to float32's own
// rounding. The two small products go first into the float32 accumulator,
// then the large one, each k-step's three into a fresh fragment that is
// added to the float32 accumulator (`mma3_group` says why).
//
// The products are mma.sync m16n8k8 (.row.col, tf32 in, f32 sums). Lane
// (g = lane / 4, t = lane % 4) of a warp holds
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8):  b0 (k t, n g), b1 (k t + 4, n g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// A product's k order is free, so an accumulator feeds the next product's A
// operand as it lies: logical k t is column 2t and k t + 4 is 2t + 1, that is
// a = (c0, c2, c1, c3), and the B operand's rows 2t and 2t + 1 of each
// 8-row k-step are read (`a_from_acc`). Shared tiles have rows of
// (bucket + 4) words, so (row stride in words) % 32 == 4: the K-major
// fragment loads (rows g, columns t and t + 4) and the row-major ones in
// that k order (rows 2t and 2t + 1, columns g) each fall in 32 banks.

#pragma once

#include "sm90.cuh"

namespace {
namespace x3 {

// Words a shared row of a tile of the head-dim bucket DM takes.
template <int DM>
struct Row {
  static constexpr int LD = DM + 4;
  static_assert(LD % 32 == 4, "fragment loads in 32 banks");
};

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) as integer
// ops on the bits: float32 is sign and magnitude, so adding half of the 13
// dropped bits' unit and clearing them rounds the magnitude. ptxas expands
// cvt.rna on sm_90 into four instructions and a guard for infinities; this
// is two, and gives the same bits for every finite x and for infinities.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, a fresh sum (C = 0)
__device__ __forceinline__ void mma0(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// c[j] += a b_j for G n-tiles as a_lo b_hi + a_hi b_lo + a_hi b_hi, B_j's
// fragments at word offsets o0 + j step and o1 + j step of the tiles hi and
// lo. Each n-tile's three products go into a fresh fragment, which is then
// added to c in float32: the tensor core truncates its sums, so a chain of
// k-steps in one accumulator drifts toward zero (measured 4.8e-5 of scale
// over the 1,536 products of a dK at L 4096, against 1e-5 allowed), while
// rounded adds of the k-steps' sums do not. The G chains are issued
// interleaved, so that a product's latency hides behind the other chains'.
template <int G>
__device__ __forceinline__ void mma3_group(float (*c)[4], const uint32_t* ah, const uint32_t* al,
                                           const uint32_t* hi, const uint32_t* lo, int o0,
                                           int o1, int step) {
  uint32_t bh[G][2], bl[G][2];
  float d[G][4];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    bh[j][0] = hi[o0 + j * step];
    bh[j][1] = hi[o1 + j * step];
    bl[j][0] = lo[o0 + j * step];
    bl[j][1] = lo[o1 + j * step];
  }
#pragma unroll
  for (int j = 0; j < G; ++j) mma0(d[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma(d[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma(d[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += d[j][e];
}

// Two products' groups at once, their 2 G chains interleaved:
// c[j] += a b_j (tiles hi, lo) and e[j] += f g_j (tiles ghi, glo), at the
// same offsets.
template <int G>
__device__ __forceinline__ void mma3_group2(float (*c)[4], const uint32_t* ah, const uint32_t* al,
                                            const uint32_t* hi, const uint32_t* lo,
                                            float (*e)[4], const uint32_t* fh, const uint32_t* fl,
                                            const uint32_t* ghi, const uint32_t* glo, int o0,
                                            int o1, int step) {
  uint32_t bh[2 * G][2], bl[2 * G][2];
  float d[2 * G][4];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    bh[j][0] = hi[o0 + j * step];
    bh[j][1] = hi[o1 + j * step];
    bl[j][0] = lo[o0 + j * step];
    bl[j][1] = lo[o1 + j * step];
    bh[G + j][0] = ghi[o0 + j * step];
    bh[G + j][1] = ghi[o1 + j * step];
    bl[G + j][0] = glo[o0 + j * step];
    bl[G + j][1] = glo[o1 + j * step];
  }
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) mma0(d[j], j < G ? al : fl, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) mma(d[j], j < G ? ah : fh, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) mma(d[j], j < G ? ah : fh, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      c[j][x] += d[j][x];
      e[j][x] += d[G + j][x];
    }
}

// c[n] += a b_n over the n-tiles n < D / 8 of a row-major B read at rows
// 2t and 2t + 1 (the fragment of n-tile n at word offsets base + 8 n and
// base + 8 n + ld), 4 chains at a time (D is a multiple of 16).
template <int DM>
__device__ __forceinline__ void mma3_rows(float (*c)[4], const uint32_t* ah, const uint32_t* al,
                                          const uint32_t* hi, const uint32_t* lo, int base,
                                          int ld, int D) {
#pragma unroll
  for (int n = 0; n < DM / 8; n += 4) {
    if (8 * (n + 4) <= D)
      mma3_group<4>(c + n, ah, al, hi, lo, base + 8 * n, base + 8 * n + ld, 8);
    else if (8 * n < D)
      mma3_group<2>(c + n, ah, al, hi, lo, base + 8 * n, base + 8 * n + ld, 8);
  }
}

// mma3_rows for two products at once: c[n] += a b_n and e[n] += f g_n.
template <int DM>
__device__ __forceinline__ void mma3_rows2(float (*c)[4], const uint32_t* ah, const uint32_t* al,
                                           const uint32_t* hi, const uint32_t* lo,
                                           float (*e)[4], const uint32_t* fh, const uint32_t* fl,
                                           const uint32_t* ghi, const uint32_t* glo, int base,
                                           int ld, int D) {
#pragma unroll
  for (int n = 0; n < DM / 8; n += 2)
    if (8 * n < D)
      mma3_group2<2>(c + n, ah, al, hi, lo, e + n, fh, fl, ghi, glo, base + 8 * n,
                     base + 8 * n + ld, 8);
}

// The A fragment of rows g and g + 8 of a raw float32 tile (row stride ld)
// at k-step column kk, split on read.
__device__ __forceinline__ void a_from_tile(uint32_t* ah, uint32_t* al, const float* p, int ld) {
  split(p[0], ah[0], al[0]);
  split(p[8 * ld], ah[1], al[1]);
  split(p[4], ah[2], al[2]);
  split(p[8 * ld + 4], ah[3], al[3]);
}

// The A fragment of an accumulator's 8 columns (see above), split.
__device__ __forceinline__ void a_from_acc(uint32_t* ah, uint32_t* al, const float* c) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

// c[j] += A B_j^T over the head dim (D, a multiple of 16) for NT n-tiles of
// a K-major B: A is a warp's 16 rows of a raw float32 tile, split on read
// (a at row g, column t; row stride lda), B_j's fragment of k-step kk at
// word offsets o0 + kk + 8 j ld and + 4 of the tiles hi and lo (o0 at row
// g, column t). Each (k-step, n-tile) is a chain of its own: with fewer
// than 4 n-tiles two k-steps go at once, so that a warp has 2 to 4 chains
// in flight.
template <int NT>
__device__ __forceinline__ void mma3_kdim(float (*c)[4], const float* a, int lda,
                                          const uint32_t* hi, const uint32_t* lo, int o0,
                                          int ld, int D) {
  constexpr int KG = NT >= 4 ? 1 : 2, G = NT >= 4 ? 4 : NT;
  static_assert(NT % G == 0, "groups of n-tiles");
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8 * KG) {
    uint32_t ah[KG][4], al[KG][4];
#pragma unroll
    for (int i = 0; i < KG; ++i) a_from_tile(ah[i], al[i], a + kk + 8 * i, lda);
#pragma unroll
    for (int j = 0; j < NT; j += G) {
      uint32_t bh[KG * G][2], bl[KG * G][2];
      float d[KG * G][4];
#pragma unroll
      for (int x = 0; x < KG * G; ++x) {
        const int o = o0 + kk + 8 * (x / G) + 8 * (j + x % G) * ld;
        bh[x][0] = hi[o];
        bh[x][1] = hi[o + 4];
        bl[x][0] = lo[o];
        bl[x][1] = lo[o + 4];
      }
#pragma unroll
      for (int x = 0; x < KG * G; ++x) mma0(d[x], al[x / G], bh[x][0], bh[x][1]);
#pragma unroll
      for (int x = 0; x < KG * G; ++x) mma(d[x], ah[x / G], bl[x][0], bl[x][1]);
#pragma unroll
      for (int x = 0; x < KG * G; ++x) mma(d[x], ah[x / G], bh[x][0], bh[x][1]);
#pragma unroll
      for (int x = 0; x < KG * G; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j + x % G][e] += d[x][e];
    }
  }
}

// mma3_kdim for two products at once, their chains interleaved:
// c[j] += A B_j^T (tiles hi, lo) and e[j] += F G_j^T (tiles ghi, glo), F at
// f with A's stride, G_j at B_j's offsets.
template <int NT>
__device__ __forceinline__ void mma3_kdim2(float (*c)[4], const float* a, const uint32_t* hi,
                                           const uint32_t* lo, float (*e)[4], const float* f,
                                           const uint32_t* ghi, const uint32_t* glo, int lda,
                                           int o0, int ld, int D) {
  constexpr int KG = NT >= 2 ? 1 : 2, G = NT >= 2 ? 2 : 1;
  static_assert(NT % G == 0, "groups of n-tiles");
  constexpr int X = KG * G;  // chains of one product a group
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8 * KG) {
    uint32_t ah[2 * KG][4], al[2 * KG][4];  // A's k-steps, then F's
#pragma unroll
    for (int i = 0; i < KG; ++i) {
      a_from_tile(ah[i], al[i], a + kk + 8 * i, lda);
      a_from_tile(ah[KG + i], al[KG + i], f + kk + 8 * i, lda);
    }
#pragma unroll
    for (int j = 0; j < NT; j += G) {
      uint32_t bh[2 * X][2], bl[2 * X][2];
      float d[2 * X][4];
#pragma unroll
      for (int x = 0; x < 2 * X; ++x) {
        const int y = x % X, o = o0 + kk + 8 * (y / G) + 8 * (j + y % G) * ld;
        const uint32_t* th = x < X ? hi : ghi;
        const uint32_t* tl = x < X ? lo : glo;
        bh[x][0] = th[o];
        bh[x][1] = th[o + 4];
        bl[x][0] = tl[o];
        bl[x][1] = tl[o + 4];
      }
#pragma unroll
      for (int x = 0; x < 2 * X; ++x) {
        const int i = (x / X) * KG + (x % X) / G;
        mma0(d[x], al[i], bh[x][0], bh[x][1]);
      }
#pragma unroll
      for (int x = 0; x < 2 * X; ++x) {
        const int i = (x / X) * KG + (x % X) / G;
        mma(d[x], ah[i], bl[x][0], bl[x][1]);
      }
#pragma unroll
      for (int x = 0; x < 2 * X; ++x) {
        const int i = (x / X) * KG + (x % X) / G;
        mma(d[x], ah[i], bh[x][0], bh[x][1]);
      }
#pragma unroll
      for (int x = 0; x < 2 * X; ++x)
#pragma unroll
        for (int q = 0; q < 4; ++q) (x < X ? c : e)[j + x % G][q] += d[x][q];
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// ---- copies -----------------------------------------------------------------

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool vec, bool valid) {
  const uint32_t d = tc::smem_u32(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows r0 .. r0 + R - 1 of an (L, D) slice with row stride sl into an R x ld
// shared tile by cp.async, in 16-byte pieces where the slice allows (vec),
// else 4-byte ones; rows >= L arrive as zeros. Columns >= D are not written.
template <int R, int THREADS>
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src, long long sl,
                                          int r0, int L, int D, bool vec) {
  const int e = vec ? 4 : 1, per_row = D / e;
  for (int i = threadIdx.x; i < R * per_row; i += THREADS) {
    const int r = i / per_row, c = (i - r * per_row) * e;
    const bool valid = r0 + r < L;
    cp_async(dst + r * ld + c, valid ? src + static_cast<long long>(r0 + r) * sl + c : src, vec,
             valid);
  }
}

// An R x D tile of raw values (times `scale` first) into its hi and lo tiles.
template <int R, int THREADS>
__device__ __forceinline__ void split_tile(const float* raw, float* hi, float* lo, int ld, int D,
                                           float scale) {
  const int per_row = D / 4;
  for (int i = threadIdx.x; i < R * per_row; i += THREADS) {
    const int o = (i / per_row) * ld + (i % per_row) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + o);
    const float xs[4] = {x.x * scale, x.y * scale, x.z * scale, x.w * scale};
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split(xs[j], h[j], l[j]);
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Rows r0 .. r0 + R - 1 of an (L, D) slice times `scale` into an R x ld
// shared tile by plain loads (16 bytes where vec); rows >= L are zeros.
template <int R, int THREADS>
__device__ __forceinline__ void load_scaled(float* dst, int ld, const float* src, long long sl,
                                            int r0, int L, int D, bool vec, float scale) {
  const int per_row = D / 4;
  for (int i = threadIdx.x; i < R * per_row; i += THREADS) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L) {
      const float* p = src + static_cast<long long>(r0 + r) * sl + c;
      if (vec) {
        x = *reinterpret_cast<const float4*>(p);
      } else {
        x = make_float4(p[0], p[1], p[2], p[3]);
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
}

// A float32 slice can be read 16 bytes at a time: base and strides.
inline bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 && s.h % 4 == 0 &&
         s.l % 4 == 0;
}

}  // namespace x3
}  // namespace
