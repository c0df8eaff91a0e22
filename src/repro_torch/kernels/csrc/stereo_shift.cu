// K4 — SRU re-projection line-buffer k-way merge (paper §5).
//
// Replaces: src/repro/kernels/stereo_shift.py:stereo_merge_pallas (body
// _merge_kernel), the TPU kernel that merges one right-eye tile per grid
// cell in a fixed loop of n_cat·L trips.
//
// Function: each right tile has n_cat rank-sorted source rows of L entries,
// INF-padded. The merge emits ids in the stable order of (rank, row,
// position); an entry is emitted unless its rank equals the previous
// popped rank (the same splat seen from two columns, or a rank repeated
// inside a row). count is the untruncated number of emits, ids are written
// for the first L of them and -1 after, overflow = count > L.
//
// What bounds it on the H100: bytes, in principle (every live rank is read
// once, and an id only for the <= L entries that are written). A serial
// merge that pops one entry per step is bound instead by the latency of
// that chain, so the design has no chain longer than a thread's share.
//
// Design: one block of 512 threads per right tile, everything in shared
// memory.
//   1. Stage the tile's n_cat x L ranks with cp.async (16 bytes a thread
//      where the row block is 16-byte aligned).
//   2. Each row's live length is a binary search for INF; a prefix sum
//      gives every row its offset in the compacted order.
//   3. ceil(log2 n_cat) rounds (at least one) of pairwise merges: round k
//      merges groups of 2^k rows into groups of 2^(k+1). The round's
//      output positions are split evenly over the threads; each finds its
//      start on the merge path of its pair of groups by a binary search
//      (ties go to the lower group, so the merge is stable) and then merges
//      its share sequentially from shared memory. Every entry carries a
//      16-bit source index (row · L + position) beside its rank. The first
//      round reads the staged rows in place and writes them compacted; the
//      rounds then alternate between two buffers (the staged rows' space is
//      the second).
//   4. keep = (rank differs from the previous one in merged order); a
//      block-wide scan of each thread's keep count gives every emit its
//      place and the count. Only the first L emits read their id from
//      global memory.
// Shared memory: 12 · n_cat · L bytes (ranks twice, indices twice) plus the
// row offsets: 70 KB at n_cat = 23, L = 256; the host refuses tiles that
// do not fit (nebula_stereo_merge_smem_bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

int smem_bytes(int n_cat, int L) {
  const long long nl = static_cast<long long>(n_cat) * L;
  const long long bytes = 12 * nl + 4LL * (n_cat + 1 + kWarps + 1);
  return bytes > (1LL << 30) ? (1 << 30) : static_cast<int>(bytes);
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

// exclusive prefix of v over the block; *total gets the sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// Output positions [p_lo, p_hi) of one round: round w merges groups of w
// rows (rows [2 g w, 2 g w + w) with [2 g w + w, 2 g w + 2 w)) into one.
// The first round reads the staged rows in place (row r at r · L, and an
// entry's source index is its staged position); later rounds read the
// compacted order of the previous one (row r at off[r]).
template <bool kFirst>
__device__ __forceinline__ void merge_round(const int32_t* __restrict__ in_r,
                                            const uint16_t* __restrict__ in_s,
                                            int32_t* __restrict__ out_r,
                                            uint16_t* __restrict__ out_s, const int* off,
                                            int n_cat, int L, int w, int p_lo, int p_hi) {
  const int n_groups = (n_cat + 2 * w - 1) / (2 * w);
  int p = p_lo;
  while (p < p_hi) {
    // the group whose output range holds p: the last one starting at or before it
    int lo = 0, hi = n_groups - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid * 2 * w] <= p) lo = mid;
      else hi = mid - 1;
    }
    const int a0 = lo * 2 * w, a1 = min(a0 + w, n_cat), b1 = min(a0 + 2 * w, n_cat);
    const int base_a = kFirst ? a0 * L : off[a0];
    const int base_b = kFirst ? a1 * L : off[a1];
    const int len_a = off[a1] - off[a0], len_b = off[b1] - off[a1];
    const int32_t* A = in_r + base_a;
    const int32_t* B = in_r + base_b;
    const int q_end = min(p_hi, off[b1]);
    // merge path: i entries of A and diag - i of B precede output p
    const int diag = p - off[a0];
    int i_lo = max(0, diag - len_b), i_hi = min(diag, len_a);
    while (i_lo < i_hi) {
      const int mid = (i_lo + i_hi) >> 1;
      if (A[mid] <= B[diag - 1 - mid]) i_lo = mid + 1;
      else i_hi = mid;
    }
    // positions in in_r of the two heads and of the ends of A and B
    int ia = base_a + i_lo, ib = base_b + diag - i_lo;
    const int ea = base_a + len_a, eb = base_b + len_b;
    int va = ia < ea ? in_r[ia] : INT32_MAX;
    int vb = ib < eb ? in_r[ib] : INT32_MAX;
    for (; p < q_end; ++p) {  // branch-free: the lanes of a warp pick A or B freely
      const bool ta = va <= vb;  // ties to the lower group
      const int at = ta ? ia : ib;
      out_r[p] = ta ? va : vb;
      out_s[p] = kFirst ? static_cast<uint16_t>(at) : in_s[at];
      const int nx = at + 1;
      const int nv = nx < (ta ? ea : eb) ? in_r[nx] : INT32_MAX;
      ia = ta ? nx : ia;
      ib = ta ? ib : nx;
      va = ta ? nv : va;
      vb = ta ? vb : nv;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
stereo_merge_kernel(const int32_t* __restrict__ ranks, const int32_t* __restrict__ ids,
                    int32_t* __restrict__ out, int32_t* __restrict__ count_out,
                    uint8_t* __restrict__ overflow, int n_cat, int L) {
  extern __shared__ int4 smem4[];
  const int nl = n_cat * L;
  int32_t* staged = reinterpret_cast<int32_t*>(smem4);  // n_cat x L, later buffer 2
  int32_t* buf = staged + nl;                           // compacted ranks, buffer 1
  uint16_t* src1 = reinterpret_cast<uint16_t*>(buf + nl);
  uint16_t* src2 = src1 + nl;
  int* off = reinterpret_cast<int*>(src2 + nl);  // n_cat + 1 row offsets
  int* warp_sums = off + n_cat + 1;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const int32_t* R = ranks + tile * nl;

  // 1. stage the ranks
  if ((reinterpret_cast<uintptr_t>(R) & 15) == 0 && (nl & 3) == 0) {
    for (int i = tid; i < nl / 4; i += kThreads) cp_async16(staged + 4 * i, R + 4 * i);
  } else {
    for (int i = tid; i < nl; i += kThreads) cp_async4(staged + i, R + i);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. live lengths and row offsets
  for (int r = tid; r < n_cat; r += kThreads) {
    const int32_t* row = staged + r * L;
    int lo = 0, hi = L;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] < kInf) lo = mid + 1;
      else hi = mid;
    }
    off[r + 1] = lo;
  }
  __syncthreads();
  if (tid == 0) {
    off[0] = 0;
    for (int r = 0; r < n_cat; ++r) off[r + 1] += off[r];
  }
  __syncthreads();
  const int n = off[n_cat];
  // an odd share: the threads of a warp write words an odd stride apart,
  // in 32 different banks
  const int share = ((n + kThreads - 1) / kThreads) | 1;
  const int p_lo = min(n, tid * share), p_hi = min(n, p_lo + share);

  // 3. pairwise merge rounds
  merge_round<true>(staged, nullptr, buf, src1, off, n_cat, L, 1, p_lo, p_hi);
  __syncthreads();
  const int32_t* in_r = buf;
  const uint16_t* in_s = src1;
  int32_t* out_r = staged;
  uint16_t* out_s = src2;
  for (int w = 2; w < n_cat; w *= 2) {
    merge_round<false>(in_r, in_s, out_r, out_s, off, n_cat, L, w, p_lo, p_hi);
    __syncthreads();
    const int32_t* r = in_r;
    const uint16_t* x = in_s;
    in_r = out_r;
    in_s = out_s;
    out_r = const_cast<int32_t*>(r);
    out_s = const_cast<uint16_t*>(x);
  }

  // 4. emits: a rank that differs from the one before it in merged order
  int kept = 0;
  for (int p = p_lo; p < p_hi; ++p) kept += (p == 0 || in_r[p] != in_r[p - 1]);
  int count;
  int e = block_exclusive_scan(kept, warp_sums, &count);
  int32_t* o = out + tile * L;
  const int32_t* I = ids + tile * nl;
  for (int p = p_lo; p < p_hi && e < L; ++p) {
    if (p == 0 || in_r[p] != in_r[p - 1]) {
      o[e] = I[in_s[p]];
      ++e;
    }
  }
  for (int k = count + tid; k < L; k += kThreads) o[k] = -1;
  if (tid == 0) {
    count_out[tile] = count;
    overflow[tile] = count > L;
  }
}

}  // namespace

// Shared memory the merge of one tile needs; the host refuses tiles above
// the card's 232448 bytes (and n_cat · L above 65536, the 16-bit indices).
extern "C" int nebula_stereo_merge_smem_bytes(int n_cat, int L) {
  return smem_bytes(n_cat, L);
}

extern "C" int nebula_stereo_merge(const void* ranks, const void* ids, void* out,
                                   void* count, void* overflow, int n_tiles,
                                   int n_cat, int L, void* stream) {
  const int smem = smem_bytes(n_cat, L);
  if (n_cat < 1 || L < 1 || static_cast<long long>(n_cat) * L > 65536 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(stereo_merge_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // as much shared memory as the SM has, so that three 70 KB tiles fit at once
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(stereo_merge_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  stereo_merge_kernel<<<n_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ranks), static_cast<const int32_t*>(ids),
      static_cast<int32_t*>(out), static_cast<int32_t*>(count),
      static_cast<uint8_t*>(overflow), n_cat, L);
  return static_cast<int>(cudaGetLastError());
}
