// Stable stream compaction of the cascade's pending set, int32, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel `compact_pallas` (body `_compact_kernel`)
// in src/repro/kernels/cascade_compact/kernel.py, with its wrapper
// `ops.py::compact`. Same function: given pending indices idx (n,) and a
// keep mask (n,), write the kept indices in their original order to
// out[:count], `fill` to out[count:], and count to *count. Bit-exact
// against idx[keep] (int32 only, no arithmetic on the values).
//
// The TPU kernel walks blocks in order on one core and carries the running
// base in SMEM, turning each block's gather into a 0/1 select matmul. Here
// blocks run in parallel in no order, so the running base becomes a second
// pass:
//   1. count: each block of 1024 rows counts its kept rows with one
//      __ballot_sync / __popc per warp and a 32-lane shuffle sum;
//   2. scatter: each block sums the counts of the blocks before it (its
//      base) and of all blocks (the total), ranks its kept rows by warp
//      ballot prefix + block prefix of warp counts, writes them to
//      out[base + rank], writes `fill` to out[i] for every i >= total,
//      and block 0 writes the total.
//
// What bounds it on this card: it moves 9 bytes per row (4 read from idx,
// 1 from keep, 4 written) and does no arithmetic worth counting, so it is
// bound by bytes; at the serving sizes (n <= 512 misses a batch) the whole
// job is one block per pass and the two launches' latency is the cost. The
// design reads each input row once per pass with coalesced loads, keeps all
// ranks in registers and shared memory, and launches a fixed two kernels
// whatever n is (no host round trip between them).
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;          // rows per block, one per thread
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__global__ void __launch_bounds__(kBlock)
count_kept(const unsigned char* __restrict__ keep, int n,
           int* __restrict__ block_counts) {
  __shared__ int warp_counts[kWarps];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool kept = i < n && keep[i];
  const unsigned ballot = __ballot_sync(kFull, kept);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int c = warp_sum(warp_counts[lane]);
    if (lane == 0) block_counts[blockIdx.x] = c;
  }
}

__global__ void __launch_bounds__(kBlock)
scatter_kept(const int* __restrict__ idx, const unsigned char* __restrict__ keep,
             int n, int fill, const int* __restrict__ block_counts,
             int n_blocks, int* __restrict__ out, int* __restrict__ count) {
  __shared__ int part_before[kWarps];
  __shared__ int part_total[kWarps];
  __shared__ int warp_offset[kWarps];
  __shared__ int base_s, total_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // this block's base (kept rows in earlier blocks) and the total
  int before = 0, total = 0;
  for (int blk = threadIdx.x; blk < n_blocks; blk += kBlock) {
    const int c = block_counts[blk];
    total += c;
    if (blk < (int)blockIdx.x) before += c;
  }
  before = warp_sum(before);
  total = warp_sum(total);
  if (lane == 0) {
    part_before[warp] = before;
    part_total[warp] = total;
  }

  // rank of each kept row within its warp, and the warps' counts
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool kept = i < n && keep[i];
  const unsigned ballot = __ballot_sync(kFull, kept);
  const int lane_rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_offset[warp] = __popc(ballot);
  __syncthreads();

  if (warp == 0) {
    const int b = warp_sum(part_before[lane]);
    const int t = warp_sum(part_total[lane]);
    // exclusive prefix of the warp counts
    const int c = warp_offset[lane];
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += up;
    }
    warp_offset[lane] = incl - c;
    if (lane == 0) {
      base_s = b;
      total_s = t;
    }
  }
  __syncthreads();

  if (kept) out[base_s + warp_offset[warp] + lane_rank] = idx[i];
  if (i < n && i >= total_s) out[i] = fill;
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = total_s;
}

}  // namespace

// C entry point: returns the first non-zero cudaError_t of the two
// launches (0 = both launched). `block_counts` is int32 scratch of
// ceil(n / 1024) entries; n >= 1.
extern "C" int repro_cascade_compact(const void* idx, const void* keep,
                                     void* out, void* count,
                                     void* block_counts, int n, int fill,
                                     void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (n + kBlock - 1) / kBlock;
  count_kept<<<n_blocks, kBlock, 0, st>>>(
      static_cast<const unsigned char*>(keep), n,
      static_cast<int*>(block_counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_kept<<<n_blocks, kBlock, 0, st>>>(
      static_cast<const int*>(idx), static_cast<const unsigned char*>(keep), n,
      fill, static_cast<const int*>(block_counts), n_blocks,
      static_cast<int*>(out), static_cast<int*>(count));
  return cudaGetLastError();
}
