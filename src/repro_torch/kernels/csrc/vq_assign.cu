// K5 — vector-quantization codeword assignment (paper §4.3, the Δcut
// codec's SH AC band).
//
// Replaces: src/repro/kernels/vq_assign.py:vq_assign_pallas (body
// _vq_kernel), the TPU kernel that scores a block of rows against the
// codebook in blocks of 128 on the MXU and carries a running (best, index).
//
// Computes, per row x: argmin_k s_k, s_k = c2_k − 2·dot_k, where dot_k sums
// x_d·c_kd over d = 0..D−1 in order and c2_k sums c_kd·c_kd the same way,
// one rounded product and one rounded add at a time (the library is built
// with --fmad=false): the plain PyTorch version's order, so both give the
// same bits. The lowest index wins a tie (strict `<`), which is the Pallas
// kernel's result and torch.argmin's; a NaN score wins over every number
// and the first NaN is kept, as torch.argmin does.
//
// What bounds it on the H100: the arithmetic, 2D + 2 float32 operations a
// (row, code), against 4(D + 1) bytes a row. A (rows × D)·(D × Kc) product
// is what the tensor cores are for, but TF32 does not reproduce the
// sequential float32 sums, and the codes must be exact. So the tensor cores
// only filter, and the candidates they leave are settled exactly.
//
// Design. A persistent block of 8 warps (3 at D = 45) keeps the codebook
// in shared memory for its whole life: the exact rows (for rescoring), c2,
// and the B fragments of mma.sync, each value split in two TF32 parts, hi
// = tf32(c) and lo = tf32(c − hi) (cvt.rna; the codebook zero-padded to
// Kp = 8⌈Kc/8⌉ codes), laid out so a lane loads a k-step's values with one
// 8-byte load a part. The columns go in k-steps of 8 (m16n8k8) and, where
// D mod 8 is 1..4, one of 4 (m16n8k4): D = 9 costs 12 columns, not 16. A
// k-step is three MMAs, lo·hi + hi·lo + hi·hi (split TF32: the product of
// the parts misses x·c by about 2^-21 of |x||c|, where one TF32 MMA misses
// it by 2^-10, a window that real SH rows, which lie close to several
// codewords, fall into half of the time). Each warp walks tiles of 32
// rows, staged by cp.async (16-byte copies where the tile is whole and
// aligned; 32 rows are one contiguous run of 128·D bytes) into a double
// buffer, so the next tile loads while this one is scored. mma.sync (two
// m16 tiles a warp) rather than wgmma m64n256k8: the product is small
// (2^20 rows × 256 codes × 12 columns × 3), the epilogue sets the pace,
// and mma.sync leaves each score in a register of a known lane (row g or
// g + 8, column 2t or 2t + 1 of an n-tile), where it is folded at once;
// wgmma would need the 64×256 accumulator (128 registers a thread) and
// shared memory descriptors for the same result.
//
// The accumulator starts at −c2_k/2 (the C operand, float32), so the MMA
// gives h_k ≈ dot_k − c2_k/2 = −s_k/2 and the argmin is an argmax. Pass 1
// keeps, per row, the largest h (m1) with its code and the second largest
// (m2), merged across the 4 lanes of a row by two shuffles. The candidates
// are the codes with h_k ≥ m1 − 2E (E below). If m2 < m1 − 2E the argmax is
// the only one, and so the answer, with no rescoring. A row of zeros
// scores exactly c2_k (every product is ±0), so its answer is the first
// code of least c2, found once a block. A codeword equal to an earlier one
// scores the same on every row and loses the tie: its h is set to −1e38,
// so it is never a candidate. The other rows ("hard": a tie or a near-tie
// within the bound) are copied to a per-warp list; each 32 of them take
// pass 2, which recomputes their MMA, appends every candidate to its
// lane's own queue and scores it exactly, folding (score, code) into the
// row's best with a 64-bit atomicMin on (order-preserving bits of score +
// 0.0, code): the lowest score and, among equal ones, the lowest code —
// the strict-`<` scan's answer among the candidates, whatever the order
// (score + 0.0 makes −0 equal +0, as `<`).
//
// Why the candidates hold every exact minimum. Let E0 bound |h_k + s_k/2|
// for every k of a row. For an exact minimum k* and the filter's argmax j:
// h_k* ≥ −s_k*/2 − E0 ≥ −s_j/2 − E0 ≥ h_j − 2E0 = m1 − 2E0. The kernel uses
// E = 2·E0 (a safety factor of 2), so every exact minimum, ties included,
// is a candidate, and so is j: the result is the plain version's. Pass 2
// may compute other h values than pass 1 (the argument holds for any
// evaluation within E0).
//
// The bound E0, per row, from X ≥ ‖x‖₂ and, over the codebook, C ≥
// max_k ‖c_k‖₂, C2 = max c2_k and Cinf = max|c_kd| (so Σ_d |x_d c_kd| ≤
// X·C; u = 2^-24), with N = 27·(k-steps) the MMA chain's additions (three
// MMAs a k-step, each at most 9 terms):
//   - the split: x = xh + xl + rx with |xl| ≤ 2^-11|x|, |rx| ≤ 2^-22|x|,
//     and c alike, so the three products miss x·c by ≤ 3.01·2^-22·|x||c|:
//     6.02·2^-23·X·C in all;
//   - the MMA's float32 accumulation, in an unspecified order and rounding,
//     bounded as truncation (2^-23 a step) of terms summing to at most
//     C2/2 + 2.02·X·C: N·2^-23·(C2/2 + 2.02·X·C);
//   - the exact path's own rounding: |dot − x·c| ≤ γ_D·X·C ≤ 23·2^-23·X·C,
//     and the final c2 − 2·dot rounds by u·|s| ≤ u·(C2 + 2.02·X·C), half
//     of that in h;
//   - subnormals: a TF32 part below 2^-126 may be rounded or flushed
//     (≤ 2^-126 each: ≤ 3·2^-126·√D·(X + C) in all), and products or
//     partial sums below 2^-126 flushed: ≤ 2^-120·(X + C) + 2^-110.
//   Summed: E0 ≤ (2.02·N + 30)·2^-23·X·C + (N/2 + 1)·2^-23·C2 +
//   2^-120·(X + C) + 2^-110 (at D = 9, N = 54: about 2^-15.9·X·C +
//   2^-18.2·C2), and E = 2·E0, evaluated in float32 with operands that are
//   all normal or zero, where its own rounding (a few u) is far inside the
//   factor of 2. X = 1.0001·sqrt(Σ x_d²) and C = 1.0001·sqrt(C2) (the
//   sums' own rounding is below 2^-18); where Σ x_d² < 2^-100 (it may have
//   underflowed) X = 1.0001·Σ|x_d| instead, and C = 7·Cinf where C2 <
//   2^-100 (√45 < 7).
//
// Rows that take the exact full scan (the plain loop over every code, with
// the NaN rule): a row with a non-finite value or Σ|x_d| > 2^40 (its bound
// or scores could overflow); every row when the codebook holds a non-finite
// value or Cinf > 2^40; every row at D = 1, where the tensor cores do not
// pay, and every row whose codebook does not fit the filter's shared
// memory (the scan kernel, `vq_scan_kernel`, needs only the exact rows and
// c2). With Σ|x_d|, Cinf ≤ 2^40 every |h|, |s| ≤ 2^87: nothing overflows.
// The counters record rows filtered, rows scanned, candidates (codes within
// the bound: one for a row that pass 1 settles), the most candidates of one
// row, and the rows that took pass 2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // the scan kernel's block
constexpr int kRows = 32;            // rows a warp tile: two m16 tiles
constexpr int kHard = 64;            // a warp's list of rows for pass 2
constexpr int kLaneQueue = 16;       // a lane's candidate queue in pass 2
constexpr float kMaxNorm = 1099511627776.0f;  // 2^40
constexpr float kTiny = 7.888609052210118e-31f;  // 2^-100
constexpr float kPadScore = -1e38f;  // h of the padding codes: never a candidate
constexpr unsigned kFull = 0xffffffffu;

enum Counter { kFiltered, kScanned, kCandidates, kMostCandidates, kSecondPass, kCounters };
static_assert(kCounters == 5, "vq_assign.py's COUNTERS names these five, in this order");

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int pad_dim(int d) { return (d + 7) / 8 * 8; }

// The k-steps of a row of d columns: 8 columns each, and where d mod 8 is
// 1..4 a last one of 4.
__host__ __device__ constexpr int k4_steps(int d) {
  return (d % 8 != 0 && d % 8 <= 4) ? 1 : 0;
}
__host__ __device__ constexpr int k_steps(int d) { return (d + 7) / 8; }

template <int D>
struct Steps {
  static constexpr int KS = k_steps(D);
  static constexpr int K4 = k4_steps(D);
  static constexpr int K8 = KS - K4;
};

// Warps of a filter block: 8, or 3 at D > 24, where a warp's rows take
// 25 KB of shared memory.
__host__ __device__ constexpr int filter_warps(int d) { return d <= 24 ? 8 : 3; }

// Shared-memory layout of the filter kernel, in floats.
struct Layout {
  int cb, c2, bf, nh, warps, warp_stride, total;
};

__host__ __device__ inline Layout filter_layout(int Kc, int D) {
  Layout l;
  const int kp = pad_dim(Kc);
  l.cb = 0;
  l.c2 = l.cb + align4(Kc * D);
  l.bf = l.c2 + align4(Kc);
  l.nh = l.bf + 2 * kp * k_steps(D) * 8;  // hi and lo: a float2 a lane, k-step, n-tile
  l.warps = l.nh + align4(kp);
  // per warp: two x tiles; the hard rows' x, row index and threshold; their
  // best keys (64-bit) and candidate counts; the lanes' queues
  l.warp_stride = 2 * align4(kRows * D) + align4(kHard * D) + 2 * kHard + 3 * kRows +
                  32 * kLaneQueue;
  l.total = l.warps + filter_warps(D) * l.warp_stride;
  return l;
}

inline int scan_smem_bytes(int Kc, int D) {
  return (Kc * D + Kc) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_k8(float* d, const uint32_t* a, float2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b.x)),
        "r"(__float_as_uint(b.y)));
}

__device__ __forceinline__ void mma_k4(float* d, const uint32_t* a, float b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(__float_as_uint(b)));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
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

// The plain version's score of one (row, code), in its op order.
template <int D>
__device__ __forceinline__ float exact_score(const float* xr, const float* c, float c2) {
  float dot = xr[0] * c[0];
#pragma unroll
  for (int d = 1; d < D; ++d) dot = dot + xr[d] * c[d];
  return c2 - 2.0f * dot;
}

// The plain scan over every code: strict `<`, the first NaN wins.
template <int D>
__device__ int full_scan(const float* xr, const float* s_cb, const float* s_c2, int Kc) {
  float best = INFINITY;
  int best_k = 0;
  bool best_nan = false;
  for (int k = 0; k < Kc; ++k) {
    const float score = exact_score<D>(xr, s_cb + k * D, s_c2[k]);
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
  return best_k;
}

// Stage the codebook rows and their norms (codeword_norms' order).
template <int D>
__device__ void stage_codebook(const float* __restrict__ codebook, float* s_cb, float* s_c2,
                               int Kc) {
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
}

// The plain scan, a thread a row, over the rows of a grid-stride loop;
// adds them to the scanned counter.
template <int D>
__device__ void scan_rows(const float* __restrict__ x, const float* s_cb, const float* s_c2,
                          int32_t* __restrict__ out, int M, int Kc,
                          unsigned long long* counters) {
  unsigned long long scanned = 0;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < M;
       row += gridDim.x * blockDim.x) {
    float xr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xr[d] = x[static_cast<size_t>(row) * D + d];
    out[row] = full_scan<D>(xr, s_cb, s_c2, Kc);
    ++scanned;
  }
  if (scanned) atomicAdd(counters + kScanned, scanned);
}

// The scan kernel: one thread a row, every code, for the rows the filter
// does not take (D = 1, or a codebook too large for the filter's layout).
template <int D>
__global__ void __launch_bounds__(kThreads) vq_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ codebook,
    int32_t* __restrict__ out, int M, int Kc, unsigned long long* counters) {
  extern __shared__ __align__(16) float smem[];
  float* s_cb = smem;
  float* s_c2 = smem + Kc * D;
  stage_codebook<D>(codebook, s_cb, s_c2, Kc);
  scan_rows<D>(x, s_cb, s_c2, out, M, Kc, counters);
}

// Stage warp tile `tile` (rows tile·32 ..) into `buf`; rows past M are 0.
template <int D>
__device__ __forceinline__ void stage_rows(float* buf, const float* __restrict__ x,
                                           int tile, int M, bool aligned16, int lane) {
  const long long first = static_cast<long long>(tile) * kRows;
  const float* src = x + first * D;
  if (aligned16 && first + kRows <= M) {
    for (int i = lane; i < kRows * D / 4; i += 32) cp_async16(buf + 4 * i, src + 4 * i);
  } else {
    const long long n = (M - first < kRows ? M - first : kRows) * D;
    for (int i = lane; i < kRows * D; i += 32) {
      if (i < n) {
        cp_async4(buf + i, src + i);
      } else {
        buf[i] = 0.0f;
      }
    }
  }
}

__device__ __forceinline__ unsigned long long score_key(float s, int k) {
  uint32_t u = __float_as_uint(s + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<uint32_t>(k);
}

// A fragments of 32 staged rows (row r at rows + r·D), each value split
// as hi = tf32(v), lo = tf32(v − hi); the rows of slot i (r = 8i + g)
// zeroed where `take[i]` is false.
template <int D>
__device__ __forceinline__ void load_a(const float* rows, const bool* take, int g, int tq,
                                       uint32_t (*ah)[Steps<D>::KS][4],
                                       uint32_t (*al)[Steps<D>::KS][4]) {
  using S = Steps<D>;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int s = 0; s < S::KS; ++s) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // k8: a0 (g, tq), a1 (g + 8, tq), a2 (g, tq + 4), a3 (g + 8, tq + 4);
        // k4: a0 (g, tq), a1 (g + 8, tq)
        const int h = q & 1, col = 8 * s + tq + 4 * (q >> 1);
        const int r = 16 * mt + 8 * h + g;
        const bool in = col < D && take[2 * mt + h] && (s < S::K8 || q < 2);
        const float v = in ? rows[r * D + col] : 0.0f;
        ah[mt][s][q] = to_tf32(v);
        al[mt][s][q] = to_tf32(v - __uint_as_float(ah[mt][s][q]));
      }
    }
  }
}

// h for n-tile t of both m16 tiles: d[mt][q] (rows 16mt + g, + 8; columns
// 8t + 2tq, + 1), as hi·hi + hi·lo + lo·hi a k-step.
template <int D>
__device__ __forceinline__ void tile_scores(const float2* s_bh, const float2* s_bl,
                                            const float2* s_nh, int t, int lane, int tq,
                                            uint32_t (*ah)[Steps<D>::KS][4],
                                            uint32_t (*al)[Steps<D>::KS][4],
                                            float (*d)[4]) {
  using S = Steps<D>;
  const float2 nh = s_nh[4 * t + tq];
  float2 bh[S::KS], bl[S::KS];
#pragma unroll
  for (int s = 0; s < S::KS; ++s) {
    bh[s] = s_bh[(t * S::KS + s) * 32 + lane];
    bl[s] = s_bl[(t * S::KS + s) * 32 + lane];
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    d[mt][0] = nh.x;
    d[mt][1] = nh.y;
    d[mt][2] = nh.x;
    d[mt][3] = nh.y;
#pragma unroll
    for (int s = 0; s < S::K8; ++s) {
      mma_k8(d[mt], al[mt][s], bh[s]);
      mma_k8(d[mt], ah[mt][s], bl[s]);
      mma_k8(d[mt], ah[mt][s], bh[s]);
    }
    if constexpr (S::K4 > 0) {
      mma_k4(d[mt], al[mt][S::K8], bh[S::K8].x);
      mma_k4(d[mt], ah[mt][S::K8], bl[S::K8].x);
      mma_k4(d[mt], ah[mt][S::K8], bh[S::K8].x);
    }
  }
}

// Fold two scores of one row (codes k, k + 1) into (m1, i1, m2): the
// largest, its code, and the second largest (a tie makes m2 = m1).
__device__ __forceinline__ void top2(float v0, float v1, int k, float& m1, int& i1,
                                     float& m2) {
  const float hi = fmaxf(v0, v1), lo = fminf(v0, v1);
  const int ih = v1 > v0 ? k + 1 : k;
  m2 = fmaxf(m2, fmaxf(lo, fminf(hi, m1)));
  i1 = hi > m1 ? ih : i1;
  m1 = fmaxf(m1, hi);
}

template <int D>
__global__ void __launch_bounds__(32 * filter_warps(D), 2) vq_filter_kernel(
    const float* __restrict__ x, const float* __restrict__ codebook,
    int32_t* __restrict__ out, int M, int Kc, int aligned16,
    unsigned long long* counters) {
  using S = Steps<D>;
  // E0's coefficients (see the note): the MMA chain's truncation steps,
  // then X·C's and C2's factors
  constexpr float kSteps = 27.0f * S::KS;
  constexpr float kBoundXC = (2.02f * kSteps + 30.0f) * 1.1920928955078125e-07f;
  constexpr float kBoundC2 = (0.5f * kSteps + 1.0f) * 1.1920928955078125e-07f;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned int s_cinf, s_c2max;
  __shared__ unsigned long long s_zero;
  __shared__ int s_bad;
  const Layout lay = filter_layout(Kc, D);
  float* s_cb = smem + lay.cb;
  float* s_c2 = smem + lay.c2;
  const float2* s_bh = reinterpret_cast<const float2*>(smem + lay.bf);
  const float2* s_bl = s_bh + (pad_dim(Kc) / 8) * Steps<D>::KS * 32;
  const float2* s_nh = reinterpret_cast<const float2*>(smem + lay.nh);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Kp = pad_dim(Kc), NT = Kp / 8;
  if (tid == 0) {
    s_cinf = 0u;
    s_c2max = 0u;
    s_zero = ~0ull;
    s_bad = 0;
  }
  stage_codebook<D>(codebook, s_cb, s_c2, Kc);

  // B fragments (lane l of k-step s of n-tile t: code 8t + l/4, columns
  // 8s + l%4 and + 4; a k4 step has only the first), −c2/2, and the
  // codebook's Cinf, C2 and finiteness.
  {
    float2* bh = reinterpret_cast<float2*>(smem + lay.bf);
    float2* bl = bh + NT * S::KS * 32;
    float* nh = smem + lay.nh;
    for (int i = tid; i < NT * S::KS * 32; i += blockDim.x) {
      const int l = i & 31, ts = i >> 5, st = ts % S::KS;
      const int n = (ts / S::KS) * 8 + (l >> 2), c = st * 8 + (l & 3);
      float v0 = 0.0f, v1 = 0.0f;
      if (n < Kc) {
        if (c < D) v0 = s_cb[n * D + c];
        if (st < S::K8 && c + 4 < D) v1 = s_cb[n * D + c + 4];
      }
      const float h0 = __uint_as_float(to_tf32(v0)), h1 = __uint_as_float(to_tf32(v1));
      bh[i] = make_float2(h0, h1);
      bl[i] = make_float2(__uint_as_float(to_tf32(v0 - h0)), __uint_as_float(to_tf32(v1 - h1)));
    }
    // a codeword equal to an earlier one scores the same on every row, and
    // the earlier wins the tie: it is never a candidate
    for (int k = tid; k < Kp; k += blockDim.x) {
      bool dup = k >= Kc;
      for (int j = 0; j < k && !dup; ++j) {
        bool same = true;
#pragma unroll
        for (int d = 0; d < D; ++d) same = same && s_cb[j * D + d] == s_cb[k * D + d];
        dup = same;
      }
      nh[k] = dup ? kPadScore : -0.5f * s_c2[k];
    }
    // a zero row scores c2_k exactly: its code is the first least c2
    for (int k = tid; k < Kc; k += blockDim.x)
      atomicMin(&s_zero, (static_cast<unsigned long long>(__float_as_uint(s_c2[k])) << 32) |
                             static_cast<unsigned int>(k));
    unsigned int cinf = 0u, c2max = 0u;
    int bad = 0;
    for (int i = tid; i < Kc * D; i += blockDim.x) {
      const float v = fabsf(s_cb[i]);
      bad |= !(v <= kMaxNorm);  // NaN and inf too
      cinf = max(cinf, __float_as_uint(v));
    }
    for (int k = tid; k < Kc; k += blockDim.x) c2max = max(c2max, __float_as_uint(s_c2[k]));
    if (bad) atomicOr(&s_bad, 1);
    atomicMax(&s_cinf, cinf);  // non-negative floats order as their bits
    atomicMax(&s_c2max, c2max);
  }
  __syncthreads();

  const int n_tiles = (M + kRows - 1) / kRows;
  constexpr int kWarps = filter_warps(D);
  const int first = blockIdx.x * kWarps + warp, stride = gridDim.x * kWarps;
  if (s_bad) {  // a non-finite or huge codeword: every row takes the scan
    scan_rows<D>(x, s_cb, s_c2, out, M, Kc, counters);
    return;
  }
  const float cinf = __uint_as_float(s_cinf), c2max = __uint_as_float(s_c2max);
  const int zero_code = static_cast<int>(s_zero & 0xffffffffull);
  const float cnorm = c2max >= kTiny ? 1.0001f * sqrtf(c2max) : 7.0f * cinf;

  float* wbase = smem + lay.warps + warp * lay.warp_stride;
  float* xbuf[2] = {wbase, wbase + align4(kRows * D)};
  float* hard_x = wbase + 2 * align4(kRows * D);
  int* hard_row = reinterpret_cast<int*>(hard_x + align4(kHard * D));
  float* hard_thr = reinterpret_cast<float*>(hard_row + kHard);
  unsigned long long* best = reinterpret_cast<unsigned long long*>(hard_thr + kHard);
  uint32_t* row_cand = reinterpret_cast<uint32_t*>(best + kRows);
  uint32_t* lq = row_cand + kRows;  // entry i of lane l at lq[32 i + l]
  const int g = lane >> 2, tq = lane & 3;
  // uniform across the warp: rows filtered, scanned, settled by pass 1,
  // taken by pass 2; a lane's own: the candidates it rescored, and the most
  // candidates of a row it wrote
  unsigned long long n_filtered = 0, n_scanned = 0, n_easy = 0, n_second = 0;
  unsigned int n_rescored = 0, most = 1;
  int n_hard = 0;
  uint32_t ah[2][S::KS][4], al[2][S::KS][4];

  // Pass 2 over hard rows 0..n-1: every code with h ≥ the row's threshold
  // is queued by its lane and scored exactly.
  auto second_pass = [&](int n) {
    bool take[4];
    float thr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      take[i] = 8 * i + g < n;
      thr[i] = take[i] ? hard_thr[8 * i + g] : INFINITY;
    }
    best[lane] = ~0ull;
    row_cand[lane] = 0u;
    load_a<D>(hard_x, take, g, tq, ah, al);
    __syncwarp();
    int nq = 0;
    auto flush = [&]() {
      for (int i = 0; i < nq; ++i) {
        const uint32_t v = lq[32 * i + lane];
        const int r = static_cast<int>(v >> 16), k = static_cast<int>(v & 0xffffu);
        const float sc = exact_score<D>(hard_x + r * D, s_cb + k * D, s_c2[k]);
        atomicMin(best + r, score_key(sc, k));
        atomicAdd(row_cand + r, 1u);
      }
      n_rescored += nq;
      nq = 0;
    };
#pragma unroll 2
    for (int t = 0; t < NT; ++t) {
      float d[2][4];
      tile_scores<D>(s_bh, s_bl, s_nh, t, lane, tq, ah, al, d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int mt = j >> 2, q = j & 3;
        if (d[mt][q] >= thr[2 * mt + (q >> 1)]) {
          lq[32 * nq + lane] = (static_cast<uint32_t>(16 * mt + 8 * (q >> 1) + g) << 16) |
                               static_cast<uint32_t>(8 * t + 2 * tq + (q & 1));
          ++nq;
        }
      }
      if (nq > kLaneQueue - 8) flush();
    }
    flush();
    __syncwarp();
    if (lane < n) {
      out[hard_row[lane]] = static_cast<int>(best[lane] & 0xffffffffull);
      most = max(most, row_cand[lane]);
    }
    n_second += n;
    __syncwarp();
  };

  if (first < n_tiles) stage_rows<D>(xbuf[0], x, first, M, aligned16, lane);
  cp_async_commit();
  for (int tile = first, it = 0; tile < n_tiles; tile += stride, ++it) {
    const float* xb = xbuf[it & 1];
    if (tile + stride < n_tiles)
      stage_rows<D>(xbuf[(it + 1) & 1], x, tile + stride, M, aligned16, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int r0 = tile * kRows;

    // lane r: row r's norms, whether the filter takes it, and its E
    float x1 = 0.0f, ss = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float v = xb[lane * D + d];
      x1 = x1 + fabsf(v);
      ss = ss + v * v;
    }
    const bool valid = r0 + lane < M;
    const bool filt = valid && x1 <= kMaxNorm;
    const float xn = ss >= kTiny ? 1.0001f * sqrtf(ss) : 1.0001f * x1;
    const float e = 2.0f * (kBoundXC * xn * cnorm + kBoundC2 * c2max +
                            7.52316384526264e-37f * (xn + cnorm) + 7.70371977754894e-34f);

    // pass 1: per row slot i = 2·mt + h (row 8i + g), the two largest h
    bool take[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) take[i] = __shfl_sync(kFull, filt, 8 * i + g);
    load_a<D>(xb, take, g, tq, ah, al);
    float m1[4], m2[4];
    int i1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m1[i] = -INFINITY;
      m2[i] = -INFINITY;
      i1[i] = 0;
    }
#pragma unroll 4
    for (int t = 0; t < NT; ++t) {
      float d[2][4];
      tile_scores<D>(s_bh, s_bl, s_nh, t, lane, tq, ah, al, d);
      const int k = 8 * t + 2 * tq;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        top2(d[mt][0], d[mt][1], k, m1[2 * mt], i1[2 * mt], m2[2 * mt]);
        top2(d[mt][2], d[mt][3], k, m1[2 * mt + 1], i1[2 * mt + 1], m2[2 * mt + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float b1 = __shfl_xor_sync(kFull, m1[i], o);
        const float b2 = __shfl_xor_sync(kFull, m2[i], o);
        const int bi = __shfl_xor_sync(kFull, i1[i], o);
        m2[i] = fmaxf(fmaxf(m2[i], b2), fminf(m1[i], b1));
        i1[i] = b1 > m1[i] ? bi : i1[i];
        m1[i] = fmaxf(m1[i], b1);
      }
    }
    // lane r takes row r's (m1, m2, code) from lane 4·(r mod 8), slot r / 8
    float rm1 = 0.0f, rm2 = 0.0f;
    int ri1 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v1 = __shfl_sync(kFull, m1[i], 4 * (lane & 7));
      const float v2 = __shfl_sync(kFull, m2[i], 4 * (lane & 7));
      const int vi = __shfl_sync(kFull, i1[i], 4 * (lane & 7));
      if ((lane >> 3) == i) {
        rm1 = v1;
        rm2 = v2;
        ri1 = vi;
      }
    }
    const bool zero = valid && x1 == 0.0f;  // every x_d is ±0
    const float thr = rm1 - 2.0f * e;
    const bool easy = filt && (zero || rm2 < thr);
    const bool hard = filt && !easy;
    if (easy) out[r0 + lane] = zero ? zero_code : ri1;
    if (valid && !filt) {  // the plain scan, a lane a row
      float xr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) xr[d] = xb[lane * D + d];
      out[r0 + lane] = full_scan<D>(xr, s_cb, s_c2, Kc);
    }
    n_filtered += __popc(__ballot_sync(kFull, filt));
    n_scanned += __popc(__ballot_sync(kFull, valid && !filt));
    n_easy += __popc(__ballot_sync(kFull, easy));
    // hard rows join the warp's list; each 32 take pass 2
    const unsigned hm = __ballot_sync(kFull, hard);
    if (hard) {
      const int pos = n_hard + __popc(hm & ((1u << lane) - 1u));
      hard_row[pos] = r0 + lane;
      hard_thr[pos] = thr;
#pragma unroll
      for (int d = 0; d < D; ++d) hard_x[pos * D + d] = xb[lane * D + d];
    }
    n_hard += __popc(hm);
    __syncwarp();
    if (n_hard >= kRows) {
      second_pass(kRows);
      n_hard -= kRows;
      if (lane < n_hard) {  // the rest move to the front
        hard_row[lane] = hard_row[kRows + lane];
        hard_thr[lane] = hard_thr[kRows + lane];
#pragma unroll
        for (int d = 0; d < D; ++d) hard_x[lane * D + d] = hard_x[(kRows + lane) * D + d];
      }
      __syncwarp();
    }
    __syncwarp();  // every lane is past this tile's buffer before it is refilled
  }
  cp_async_wait<0>();
  if (n_hard > 0) second_pass(n_hard);
  most = __reduce_max_sync(kFull, most);
  const unsigned long long n_cand = n_easy + __reduce_add_sync(kFull, n_rescored);
  if (lane == 0) {
    if (n_filtered) {
      atomicAdd(counters + kFiltered, n_filtered);
      atomicMax(counters + kMostCandidates, static_cast<unsigned long long>(most));
    }
    if (n_scanned) atomicAdd(counters + kScanned, n_scanned);
    if (n_cand) atomicAdd(counters + kCandidates, n_cand);
    if (n_second) atomicAdd(counters + kSecondPass, n_second);
  }
}

template <int D>
int launch(const float* x, const float* cb, int32_t* out, int M, int Kc, bool filter,
           int sms, bool aligned16, unsigned long long* counters, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(vq_scan_kernel<D>);
  int smem = scan_smem_bytes(Kc, D), threads = kThreads, rows_per_block = kThreads;
  if constexpr (D > 1) {
    if (filter) {
      fn = reinterpret_cast<const void*>(vq_filter_kernel<D>);
      smem = filter_layout(Kc, D).total * static_cast<int>(sizeof(float));
      threads = 32 * filter_warps(D);
      rows_per_block = filter_warps(D) * kRows;
    }
  }
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  const int want = (M + rows_per_block - 1) / rows_per_block;
  const int blocks = want < most ? want : most;
  if constexpr (D > 1) {
    if (filter) {
      vq_filter_kernel<D><<<blocks, threads, smem, stream>>>(x, cb, out, M, Kc,
                                                             aligned16 ? 1 : 0, counters);
      return static_cast<int>(cudaGetLastError());
    }
  }
  vq_scan_kernel<D><<<blocks, kThreads, smem, stream>>>(x, cb, out, M, Kc, counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a block needs: the filter kernel's (filter = 1) or the
// scan kernel's. The wrapper takes the filter where D > 1 and it fits.
extern "C" int nebula_vq_assign_smem_bytes(int Kc, int D, int filter) {
  if (filter) return filter_layout(Kc, D).total * static_cast<int>(sizeof(float));
  return scan_smem_bytes(Kc, D);
}

// D must be one of the SH AC widths the codec produces: 1 (degree 0, the
// codec's placeholder column), 9, 24 or 45 (degrees 1-3). counters:
// kCounters uint64 on the device (see the note; the most candidates of a
// row is raised to, the others added to). M ≥ 1.
extern "C" int nebula_vq_assign(const void* x, const void* codebook, void* out, int M,
                                int Kc, int D, int filter, int sms, int aligned16,
                                void* counters, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(codebook);
  int32_t* op = static_cast<int32_t*>(out);
  auto* cn = static_cast<unsigned long long*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f = filter != 0, al = aligned16 != 0;
  switch (D) {
    case 1: return launch<1>(xp, cp, op, M, Kc, false, sms, al, cn, s);
    case 9: return launch<9>(xp, cp, op, M, Kc, f, sms, al, cn, s);
    case 24: return launch<24>(xp, cp, op, M, Kc, f, sms, al, cn, s);
    case 45: return launch<45>(xp, cp, op, M, Kc, f, sms, al, cn, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
