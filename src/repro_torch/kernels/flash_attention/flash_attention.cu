// Flash-attention forward for Hopper (sm_90a): blocked online softmax,
// fp32 statistics and accumulator, float32 or bfloat16 in and out.
//
// Replaces: the Pallas TPU kernel `flash_attention` (body `_flash_kernel`)
// in src/repro/kernels/flash_attention/kernel.py, with its GQA wrapper
// `ops.py::mha`. Same function: softmax(q k^T / sqrt(hd)) v per head, with
// optional causal (kpos <= qpos) and sliding-window (kpos > qpos - window)
// masks. Unlike the TPU kernel it needs no S % block == 0: keys at or past
// S are masked and rows at or past S are not stored, so the encoders'
// S = 64 and S = 66 and any prompt length run through it. GQA is by index
// (query head h reads KV head h / (H / KVH)); nothing is repeated in
// memory. A row whose keys are all masked gives 0 / max(l, 1e-30) = 0.
//
// Layout: q, o are (B, S, H, hd) and k, v are (B, S, KVH, hd), contiguous,
// read in place (no transposes). hd <= 256; dv == hd.
//
// What bounds it on this card: at the encoders' serving shapes (S <= 66,
// hd <= 32) each (batch, head) is ~66 x 32 x 4 tensors of 4 bytes and needs
// 4 S^2 hd flops, about 2 flops per byte moved, far below the ~20
// flops/byte at which fp32 CUDA cores (67 TFLOP/s) overtake HBM
// (3.35 TB/s): the kernel is bound by bytes and by launch latency. So the
// design reads q, k, v and writes o once from HBM per block of query rows,
// keeps the running max / sum / accumulator in registers, and stages each
// K/V tile once in shared memory for the query rows of a block. TPR
// threads share one query row, each owning hd/TPR of the head dimension,
// and the per-key dot product reduces with log2(TPR) warp shuffles:
//   - hd <= 128: TPR = 8, 16 rows per 128-thread block, so small head dims
//     (16, 24, 32) still give every thread work;
//   - 128 < hd <= 256 (Gemma-3's 256): TPR = 32, one warp per row, 4 rows
//     per block, so a thread holds at most 8 elements of q and of the
//     accumulator. At TPR = 8 it would hold 32 of each and spill (hd 65-128
//     at 16 each already takes 168 registers with spills).
// K/V tiles are staged in the input type (bf16 halves the bytes), 32 keys
// x hd x 2; above 48 KB (fp32 at hd > 192) the launch opts in to more
// dynamic shared memory. At Gemma's prefill (hd 256, S up to ~1024) the
// flops per byte rise to ~S/2 and the tensor cores would pay; moving the
// products to mma/wgmma is the lever for long prompts, not taken here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;                           // threads per block
constexpr int kTile = 32;                               // keys per K/V tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// One block = kThreads / TPR query rows of one (batch, head). TPR = threads
// sharing a row; DPT = head-dim elements per thread (ceil(hd / TPR),
// rounded up to an instantiated value); thread `sub` of a row owns dims
// sub, sub + TPR, sub + 2 TPR, ...
template <typename T, int DPT, int TPR>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H, int KVH,
          int hd, float scale, int causal, int window) {
  constexpr int kRows = kThreads / TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);      // [kTile][hd]
  T* vs = ks + kTile * hd;                     // [kTile][hd]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  const int row = threadIdx.x / TPR;
  const int sub = threadIdx.x - row * TPR;
  const int q0 = blockIdx.y * kRows;
  const int qi = q0 + row;
  const bool live = qi < S;

  const long long q_off = ((long long)b * S + qi) * H * hd + (long long)h * hd;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = sub + i * TPR;
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
      ks[e] = in ? kb[kp * kv_pos + d] : zero<T>();
      vs[e] = in ? vb[kp * kv_pos + d] : zero<T>();
    }
    __syncthreads();

    float s[kTile];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = sub + i * TPR;
        if (d < hd) part += qr[i] * to_float(ks[j * hd + d]);
      }
      // the TPR threads of a row are TPR aligned lanes of one warp
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int kp = t0 + j;
      bool ok = kp < k_hi;
      if (causal) ok = ok && kp <= qi;
      if (window > 0) ok = ok && kp > qi - window;
      s[j] = ok ? part * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    if (m_new != -INFINITY) {        // same value in all TPR threads of the row
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
          const int d = sub + i * TPR;
          if (d < hd) acc[i] += p * to_float(vs[j * hd + d]);
        }
      }
      m = m_new;
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + i * TPR;
      if (d < hd) store(o + q_off + d, acc[i] / denom);
    }
  }
}

template <typename T, int DPT, int TPR>
cudaError_t launch_one(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KVH, int hd, float scale,
                       int causal, int window, cudaStream_t stream) {
  constexpr int kRows = kThreads / TPR;
  if (S > 65535 * kRows) return cudaErrorInvalidValue;   // grid.y limit
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  const size_t smem = 2 * kTile * hd * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, DPT, TPR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  flash_fwd<T, DPT, TPR><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KVH, hd, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KVH, int hd, float scale,
                   int causal, int window, cudaStream_t stream) {
#define REPRO_FLASH_CASE(N, TPR)                                              \
  if ((hd + TPR - 1) / TPR <= N)                                              \
    return launch_one<T, N, TPR>(q, k, v, o, B, S, H, KVH, hd, scale,         \
                                 causal, window, stream);
  if (hd <= 128) {
    REPRO_FLASH_CASE(1, 8)
    REPRO_FLASH_CASE(2, 8)
    REPRO_FLASH_CASE(3, 8)
    REPRO_FLASH_CASE(4, 8)
    REPRO_FLASH_CASE(8, 8)
    REPRO_FLASH_CASE(16, 8)
  }
  REPRO_FLASH_CASE(8, 32)
#undef REPRO_FLASH_CASE
  return cudaErrorInvalidValue;      // hd > 256
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
      hd > 256)
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
