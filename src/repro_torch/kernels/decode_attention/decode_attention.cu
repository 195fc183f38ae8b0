// GQA decode attention for Hopper (sm_90a): one query token per head
// against a KV cache, split over the keys (flash-decoding), fp32
// statistics and sums, float32 or bfloat16 in and out.
//
// Replaces: the Pallas TPU kernel `decode_attention` (body `_decode_kernel`)
// in src/repro/kernels/decode_attention/kernel.py, with its GQA wrapper
// `ops.py::gqa_decode`. Same function: for each (batch, KV head), the G
// query heads of the group attend to the keys at positions < length,
// softmax(q k^T / sqrt(hd)) v, a row's denominator clamped at 1e-30. Unlike
// the TPU kernel it needs no S % block == 0: the keys are cut at `length`,
// so any cache length runs, and the model's sliding-window ring caches use
// it too (models/attention.py says why a ring is a prefix of slots).
//
// Layout: q, o are (B, 1, H, hd) and k, v are (B, S, KVH, hd), contiguous,
// read in place. Query head h reads KV head h / (H / KVH). hd <= 256.
//
// What bounds it on this card: one query token does 4 hd flops per cached
// key and head, against 2 hd elements of K and V read per key and KV head:
// at G = 4 query heads per KV head that is 8 flops per 2-byte element in
// bf16, far below the ~20 flops/byte at which even the fp32 CUDA cores
// (67 TFLOP/s) overtake HBM (3.35 TB/s). So it is bound by bytes (1 KB of
// K+V per cached token per KV head at hd 256, bf16) and, at the short
// caches of a serve, by launch latency. The design reads K and V once:
//   - The TPU kernel walks the KV blocks of one (batch, KV head) in order
//     on one core. Here that would give B * KVH blocks (8 at Gemma's B = 8,
//     KVH = 1) on 132 SMs, so the keys are split instead: a first kernel
//     runs one block per (split, batch, KV head, group of up to 4 query
//     heads) and writes each split's unnormalised sum with its running max
//     and denominator; a second kernel merges the splits. The wrapper
//     picks the split so that about 264 blocks run, at least 64 keys each;
//     when one split holds every key the first kernel writes the output
//     and the second is not launched.
//   - All query heads of a group share a block, so each K/V row is read
//     once for the G heads (the TPU kernel's (G, d) x (d, bk) product).
//   - In a block, each of 4 warps takes every 4th key of the split with
//     its own online softmax; lane l owns dims l, l + 32, ... so every
//     load is coalesced; a key's dot product reduces with 5 xor shuffles.
//     The warps merge through shared memory at the end.
// Tensor cores are not used: at one query row per head the products are
// matrix-vector and the card waits on memory, not arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHd = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One block = keys [split * chunk, min(split * chunk + chunk, length)) of one
// (batch, KV head) for GB query heads of its group. DPT = head-dim elements
// per lane (ceil(hd / 32), rounded up to an instantiated value).
template <typename T, int GB, int DPT>
__global__ void __launch_bounds__(kThreads)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ part_o, float* __restrict__ part_ml,
               int B, int S, int H, int KVH, int hd, int length, int chunk,
               float scale) {
  __shared__ float sm_m[kWarps][GB];
  __shared__ float sm_l[kWarps][GB];
  __shared__ float sm_acc[kWarps][GB][kMaxHd];

  const int split = blockIdx.x;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y - b * KVH;
  const int G = H / KVH;
  const int g0 = blockIdx.z * GB;
  const int rows = min(GB, G - g0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x - warp * 32;

  float qr[GB][DPT], acc[GB][DPT], m[GB], l[GB];
#pragma unroll
  for (int r = 0; r < GB; ++r) {
    const long long q_off = ((long long)b * H + kvh * G + g0 + r) * hd;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + 32 * i;
      qr[r][i] = (r < rows && d < hd) ? to_float(q[q_off + d]) : 0.f;
      acc[r][i] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  const int start = split * chunk;
  const int end = min(start + chunk, length);
  const long long pos_stride = (long long)KVH * hd;
  const T* kb = k + (long long)b * S * pos_stride + (long long)kvh * hd;
  const T* vb = v + (long long)b * S * pos_stride + (long long)kvh * hd;

  for (int j = start + warp; j < end; j += kWarps) {
    float kr[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < hd ? to_float(kb[j * pos_stride + d]) : 0.f;
    }
    float p[GB];
#pragma unroll
    for (int r = 0; r < GB; ++r) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[r][i] * kr[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const float s = part * scale;
      const float m_new = fmaxf(m[r], s);
      const float alpha = expf(m[r] - m_new);            // m = -inf -> 0
      p[r] = expf(s - m_new);
      l[r] = l[r] * alpha + p[r];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + 32 * i;
      const float vv = d < hd ? to_float(vb[j * pos_stride + d]) : 0.f;
#pragma unroll
      for (int r = 0; r < GB; ++r) acc[r][i] += p[r] * vv;
    }
  }

  // merge the 4 warps' states (a warp with no key has m = -inf, l = 0)
#pragma unroll
  for (int r = 0; r < GB; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) sm_acc[warp][r][d] = acc[r][i];
    }
  }
  __syncthreads();

  const int n_split = (length + chunk - 1) / chunk;
  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][r]);
    float ll = 0.f, aa = 0.f;                  // split start < length: mm finite
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][r] - mm);
      ll += c * sm_l[w][r];
      aa += c * sm_acc[w][r][d];
    }
    const long long row = (long long)b * H + kvh * G + g0 + r;
    if (n_split == 1) {
      store(o + row * hd + d, aa / fmaxf(ll, 1e-30f));
    } else {
      const long long prow = (long long)split * B * H + row;
      part_o[prow * hd + d] = aa;
      if (d == 0) {
        part_ml[prow * 2] = mm;
        part_ml[prow * 2 + 1] = ll;
      }
    }
  }
}

// One block per (batch, head) row: merge the n_split partial results.
template <typename T>
__global__ void __launch_bounds__(kMaxHd)
decode_combine(const float* __restrict__ part_o,
               const float* __restrict__ part_ml, T* __restrict__ o, int BH,
               int hd, int n_split) {
  const int row = blockIdx.x;
  float mm = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    mm = fmaxf(mm, part_ml[((long long)s * BH + row) * 2]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long long prow = (long long)s * BH + row;
      const float c = expf(part_ml[prow * 2] - mm);
      ll += c * part_ml[prow * 2 + 1];
      aa += c * part_o[prow * hd + d];
    }
    store(o + (long long)row * hd + d, aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int GB>
cudaError_t launch_gb(const void* q, const void* k, const void* v, void* o,
                      float* part_o, float* part_ml, int B, int S, int H,
                      int KVH, int hd, int length, int chunk, float scale,
                      cudaStream_t stream) {
  const int G = H / KVH;
  const int n_split = (length + chunk - 1) / chunk;
  const dim3 grid(n_split, B * KVH, (G + GB - 1) / GB);
  const int dpt = (hd + 31) / 32;
#define REPRO_DECODE_CASE(N)                                                  \
  if (dpt <= N) {                                                             \
    decode_partial<T, GB, N><<<grid, kThreads, 0, stream>>>(                  \
        static_cast<const T*>(q), static_cast<const T*>(k),                   \
        static_cast<const T*>(v), static_cast<T*>(o), part_o, part_ml, B, S,  \
        H, KVH, hd, length, chunk, scale);                                    \
  } else
  REPRO_DECODE_CASE(1)
  REPRO_DECODE_CASE(2)
  REPRO_DECODE_CASE(4)
  REPRO_DECODE_CASE(8)
  return cudaErrorInvalidValue;        // hd > 256
#undef REPRO_DECODE_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  decode_combine<T><<<B * H, kMaxHd, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(o), B * H, hd, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* part_o, float* part_ml, int B, int S, int H,
                   int KVH, int hd, int length, int chunk, float scale,
                   cudaStream_t stream) {
  const int G = H / KVH;
  if (G == 1)
    return launch_gb<T, 1>(q, k, v, o, part_o, part_ml, B, S, H, KVH, hd,
                           length, chunk, scale, stream);
  if (G == 2)
    return launch_gb<T, 2>(q, k, v, o, part_o, part_ml, B, S, H, KVH, hd,
                           length, chunk, scale, stream);
  return launch_gb<T, 4>(q, k, v, o, part_o, part_ml, B, S, H, KVH, hd,
                         length, chunk, scale, stream);
}

}  // namespace

// C entry point: returns the cudaError_t of the launches (0 = launched).
// part_o (n_split, B*H, hd) and part_ml (n_split, B*H, 2) are fp32 scratch,
// n_split = ceil(length / chunk); unused when n_split == 1.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, void* o, void* part_o,
                                      void* part_ml, int B, int S, int H,
                                      int KVH, int hd, int length, int chunk,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH || hd <= 0 ||
      hd > kMaxHd || length < 1 || length > S || chunk < 1 ||
      B * KVH > 65535 || (H / KVH + 3) / 4 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (dtype == 0)
    return launch<float>(q, k, v, o, po, pml, B, S, H, KVH, hd, length,
                         chunk, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, po, pml, B, S, H, KVH, hd,
                                 length, chunk, scale, st);
  return cudaErrorInvalidValue;
}
