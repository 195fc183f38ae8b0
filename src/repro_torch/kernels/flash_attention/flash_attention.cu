// Flash-attention forward for Hopper (sm_90a): blocked online softmax,
// fp32 statistics and accumulator, float32 or bfloat16 in and out.
//
// Replaces: the Pallas TPU kernel `flash_attention` (body `_flash_kernel`)
// in src/repro/kernels/flash_attention/kernel.py, with its GQA wrapper
// `ops.py::mha`. Same function: softmax(q k^T / sqrt(hd)) v per head, with
// optional causal (kpos <= qpos) and sliding-window (kpos > qpos - window)
// masks. Unlike the TPU kernel it needs no S % block == 0: keys at or past
// S are masked and rows at or past S are not stored, so the encoders'
// S = 64 and S = 66 run through it. GQA is by index (query head h reads
// KV head h / (H / KVH)); nothing is repeated in memory. A row whose keys
// are all masked gives 0 / max(l, 1e-30) = 0.
//
// Layout: q, o are (B, S, H, hd) and k, v are (B, S, KVH, hd), contiguous,
// read in place (no transposes). hd <= 128; dv == hd.
//
// What bounds it on this card: at the serving shapes (S <= 66, hd <= 32)
// each (batch, head) is ~66 x 32 x 4 tensors of 4 bytes and needs
// 4 S^2 hd flops, about 2 flops per byte moved, far below the ~20
// flops/byte at which fp32 CUDA cores (67 TFLOP/s) overtake HBM
// (3.35 TB/s): the kernel is bound by bytes and by launch latency. So the
// design reads q, k, v and writes o exactly once from HBM, keeps the
// running max / sum / accumulator in registers, and stages each K/V tile
// once in shared memory for the 16 query rows of a block. Eight threads
// share one query row, each owning hd/8 of the head dimension, so small
// head dims (16, 24, 32) still give every thread work and the per-key dot
// product reduces with three warp shuffles. Tensor cores (wgmma) are not
// used: at hd <= 32 and S ~ 64 the math is not the limit; moving the
// products to mma/wgmma is the lever for long sequences.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreadsPerRow = 8;                       // share one query row
constexpr int kRows = 16;                               // query rows per block
constexpr int kThreads = kRows * kThreadsPerRow;        // 128
constexpr int kTile = 32;                               // keys per K/V tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One block = kRows query rows of one (batch, head). DPT = head-dim
// elements per thread (ceil(hd / 8), rounded up to an instantiated value);
// thread `sub` of a row owns dims sub, sub + 8, sub + 16, ...
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H, int KVH,
          int hd, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* ks = smem;                  // [kTile][hd]
  float* vs = smem + kTile * hd;     // [kTile][hd]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  const int row = threadIdx.x / kThreadsPerRow;
  const int sub = threadIdx.x - row * kThreadsPerRow;
  const int q0 = blockIdx.y * kRows;
  const int qi = q0 + row;
  const bool live = qi < S;

  const long long q_off = ((long long)b * S + qi) * H * hd + (long long)h * hd;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = sub + i * kThreadsPerRow;
    qr[i] = (live && d < hd) ? to_float(q[q_off + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // keys any row of this block can attend to
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + kRows);
  if (window > 0) k_lo = max(0, q0 - window + 1);

  const long long kv_pos = (long long)KVH * hd;       // stride between positions
  const T* kb = k + (long long)b * S * kv_pos + (long long)kvh * hd;
  const T* vb = v + (long long)b * S * kv_pos + (long long)kvh * hd;

  for (int t0 = k_lo; t0 < k_hi; t0 += kTile) {
    __syncthreads();                 // the previous tile is consumed
    for (int e = threadIdx.x; e < kTile * hd; e += kThreads) {
      const int j = e / hd;
      const int d = e - j * hd;
      const int kp = t0 + j;
      const bool in = kp < k_hi;
      ks[e] = in ? to_float(kb[kp * kv_pos + d]) : 0.f;
      vs[e] = in ? to_float(vb[kp * kv_pos + d]) : 0.f;
    }
    __syncthreads();

    float s[kTile];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = sub + i * kThreadsPerRow;
        if (d < hd) part += qr[i] * ks[j * hd + d];
      }
      // the 8 threads of a row are 8 aligned lanes of one warp
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      const int kp = t0 + j;
      bool ok = kp < k_hi;
      if (causal) ok = ok && kp <= qi;
      if (window > 0) ok = ok && kp > qi - window;
      s[j] = ok ? part * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    if (m_new != -INFINITY) {        // same value in all 8 threads of the row
      const float alpha = expf(m - m_new);               // m = -inf -> 0
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float p = expf(s[j] - m_new);              // masked -> 0
        l += p;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          const int d = sub + i * kThreadsPerRow;
          if (d < hd) acc[i] += p * vs[j * hd + d];
        }
      }
      m = m_new;
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + i * kThreadsPerRow;
      if (d < hd) store(o + q_off + d, acc[i] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KVH, int hd, float scale,
                   int causal, int window, cudaStream_t stream) {
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  const size_t smem = 2 * kTile * hd * sizeof(float);
  const int dpt = (hd + kThreadsPerRow - 1) / kThreadsPerRow;
#define REPRO_FLASH_CASE(N)                                                   \
  if (dpt <= N) {                                                             \
    flash_fwd<T, N><<<grid, kThreads, smem, stream>>>(                        \
        static_cast<const T*>(q), static_cast<const T*>(k),                   \
        static_cast<const T*>(v), static_cast<T*>(o), S, H, KVH, hd, scale,   \
        causal, window);                                                      \
    return cudaGetLastError();                                                \
  }
  REPRO_FLASH_CASE(1)
  REPRO_FLASH_CASE(2)
  REPRO_FLASH_CASE(3)
  REPRO_FLASH_CASE(4)
  REPRO_FLASH_CASE(8)
  REPRO_FLASH_CASE(16)
#undef REPRO_FLASH_CASE
  return cudaErrorInvalidValue;      // hd > 128
}

}  // namespace

// C entry point: returns the cudaError_t of the launch (0 = launched).
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int H, int KVH, int hd, float scale,
                                     int causal, int window, int dtype,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH || hd <= 0 ||
      hd > 128 || S > 65535 * kRows)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, S, H, KVH, hd, scale, causal, window,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KVH, hd, scale, causal,
                                 window, st);
  return cudaErrorInvalidValue;
}
