// K4 — SRU re-projection line-buffer k-way merge (paper §5).
//
// Replaces: src/repro/kernels/stereo_shift.py:stereo_merge_pallas (body
// _merge_kernel), the TPU kernel that merges one right-eye tile per grid
// cell in a fixed loop of n_cat·L trips.
//
// What bounds it on the H100: neither bytes nor flops but the serial merge.
// The inputs are 2·n_cat·L int32 per tile (47 KB at n_cat = 23, L = 256),
// of which a tile touches only its rows' live prefixes; each emitted entry
// is one dependent step (a 5-round warp arg-min). The time is latency of
// that chain times the number of entries, spread over many tiles.
//
// Design: one warp per right tile, one merge head per lane (n_cat <= 32, so
// every line-buffer row has its own lane and the arg-min is five shuffles).
// Each lane keeps its head rank in a register and only the winning lane
// reloads its next entry, so a step touches one word of memory. Ties go to
// the lowest row, as jnp.argmin returns the first minimum. The loop stops
// once every head is exhausted (the Pallas loop's remaining trips change
// nothing). Emits past L are counted and not written; overflow = count > L.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kWarpsPerBlock = 4;

__global__ void stereo_merge_kernel(const int32_t* __restrict__ ranks,
                                    const int32_t* __restrict__ ids,
                                    int32_t* __restrict__ out,
                                    int32_t* __restrict__ count_out,
                                    uint8_t* __restrict__ overflow, int n_tiles,
                                    int n_cat, int L) {
  const int tile = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= n_tiles) return;  // uniform across the warp
  const size_t base = static_cast<size_t>(tile) * n_cat * L;
  const int32_t* R = ranks + base + static_cast<size_t>(lane) * L;
  const int32_t* I = ids + base + static_cast<size_t>(lane) * L;
  int32_t* o = out + static_cast<size_t>(tile) * L;

  int ptr = 0;
  int head = (lane < n_cat && L > 0) ? R[0] : kInf;
  int count = 0;
  int prev = -1;
  while (true) {
    int v = head, c = lane;
    for (int off = 16; off > 0; off >>= 1) {
      int ov = __shfl_xor_sync(0xffffffffu, v, off);
      int oc = __shfl_xor_sync(0xffffffffu, c, off);
      if (ov < v || (ov == v && oc < c)) {
        v = ov;
        c = oc;
      }
    }
    if (v >= kInf) break;
    const bool emit = v != prev;
    if (lane == c) {
      if (emit && count < L) o[count] = I[ptr];
      ++ptr;
      head = ptr < L ? R[ptr] : kInf;
    }
    count += emit ? 1 : 0;
    prev = v;
  }
  for (int j = min(count, L) + lane; j < L; j += 32) o[j] = -1;
  if (lane == 0) {
    count_out[tile] = count;
    overflow[tile] = count > L;
  }
}

}  // namespace

extern "C" int nebula_stereo_merge(const void* ranks, const void* ids, void* out,
                                   void* count, void* overflow, int n_tiles,
                                   int n_cat, int L, void* stream) {
  if (n_cat > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  stereo_merge_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ranks), static_cast<const int32_t*>(ids),
      static_cast<int32_t*>(out), static_cast<int32_t*>(count),
      static_cast<uint8_t*>(overflow), n_tiles, n_cat, L);
  return static_cast<int>(cudaGetLastError());
}
