// Grouped (per-expert) matmul for Hopper (sm_90a): out[e] = x[e] @ w[e] for
// every expert in one launch, fp32 accumulation, float32 or bfloat16 in and
// out.
//
// Replaces: the Pallas TPU kernel `gmm` (body `_gmm_kernel`) in
// src/repro/kernels/moe_gmm/kernel.py, with its SwiGLU wrapper
// `ops.py::expert_mlp`. Same function: x (E, C, K) times w (E, K, F) gives
// (E, C, F) in x's type, each product accumulated in fp32 and rounded once.
// Unlike the TPU kernel it needs no C, K or F multiple of a block: the
// ragged edges are masked, so any capacity C runs.
//
// Layout: x (E, C, K), w (E, K, F) and out (E, C, F), contiguous.
//
// What bounds it on this card: in the MoE layers of a decode step C is the
// batch times a capacity of 1 (8 to 64 rows), so each weight element is
// used C times: 2 C flops per 2-byte element in bf16, below the ~20
// flops/byte at which the fp32 CUDA cores (67 TFLOP/s) overtake HBM (3.35
// TB/s). Decode is bound by reading the weights (33.5 MB per call at
// Granite's 32 x 1024 x 512 bf16), prefill at larger C by arithmetic. The
// design:
//   - The TPU kernel walks K in order on one core with a VMEM accumulator
//     per (expert, C block, F block). Here one block per (expert, C tile,
//     F tile) keeps its accumulators in registers and loops over K inside
//     the block, staging a BC x 32 tile of x and a 32 x 64 tile of w
//     through shared memory (as fp32) per step.
//   - The C tile follows C: 8 rows when C <= 8 (a decode step's group of
//     one token per row), 32 when C <= 32, else 64, so a decode step does
//     not spend a 64-row tile on 8 rows. 256 threads; each owns TM rows x
//     TN columns of the tile, columns strided by 64 / TN so that a warp's
//     loads and stores touch consecutive addresses.
//   - w is read once per C tile: at decode there is one C tile, so each
//     weight byte crosses HBM once. Granite's F = 512 or 1024 gives 8 or 16
//     column tiles, so its 32 experts give 256-512 blocks on 132 SMs.
// Tensor cores (mma.sync / wgmma) are not used: a first, simple kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBF = 64;      // output columns per block
constexpr int kBK = 32;      // contraction depth per shared-memory step

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One block: rows [c0, c0 + BC) x columns [f0, f0 + 64) of expert e.
// Threads form a (BC / TM) x (64 / TN) grid; thread (ty, tx) owns rows
// c0 + ty + (BC / TM) * i and columns f0 + tx + (64 / TN) * j.
template <typename T, int BC, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, int C, int K, int F) {
  constexpr int RY = BC / TM;          // thread rows
  constexpr int RX = kBF / TN;         // thread columns
  static_assert(RY * RX == kThreads, "tile does not match the block");
  // x tile, transposed (xs[k][c]) and padded a column so that the
  // stores, which walk k, fall in distinct banks
  __shared__ float xs[kBK][BC + 1];
  __shared__ float ws[kBK][kBF];

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BC;
  const int f0 = blockIdx.x * kBF;
  const int tx = threadIdx.x % RX;
  const int ty = threadIdx.x / RX;
  const T* xe = x + (long long)e * C * K;
  const T* we = w + (long long)e * K * F;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile: BC rows x 32 of K; neighbouring threads read neighbouring k
    for (int idx = threadIdx.x; idx < BC * kBK; idx += kThreads) {
      const int r = idx / kBK;
      const int kk = idx - r * kBK;
      const int c = c0 + r, k = k0 + kk;
      xs[kk][r] = (c < C && k < K) ? to_float(xe[(long long)c * K + k]) : 0.f;
    }
    // w tile: 32 rows of K x 64 columns; neighbouring threads read
    // neighbouring f
    for (int idx = threadIdx.x; idx < kBK * kBF; idx += kThreads) {
      const int kk = idx / kBF;
      const int ff = idx - kk * kBF;
      const int k = k0 + kk, f = f0 + ff;
      ws[kk][ff] = (k < K && f < F) ? to_float(we[(long long)k * F + f]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + RY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + RX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  T* oe = out + (long long)e * C * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + ty + RY * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx + RX * j;
      if (f < F) store(oe + (long long)c * F + f, acc[i][j]);
    }
  }
}

template <typename T, int BC, int TM, int TN>
cudaError_t launch_tile(const void* x, const void* w, void* out, int E, int C,
                        int K, int F, cudaStream_t stream) {
  const dim3 grid((F + kBF - 1) / kBF, (C + BC - 1) / BC, E);
  gmm_kernel<T, BC, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, K, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C,
                   int K, int F, cudaStream_t stream) {
  if (C <= 8) return launch_tile<T, 8, 1, 2>(x, w, out, E, C, K, F, stream);
  if (C <= 32) return launch_tile<T, 32, 2, 4>(x, w, out, E, C, K, F, stream);
  return launch_tile<T, 64, 4, 4>(x, w, out, E, C, K, F, stream);
}

}  // namespace

// C entry point: returns the cudaError_t of the launch (0 = launched).
// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).
extern "C" int repro_moe_gmm(const void* x, const void* w, void* out, int E,
                             int C, int K, int F, int dtype, void* stream) {
  if (E <= 0 || C <= 0 || K <= 0 || F <= 0 || E > 65535 ||
      (C + 7) / 8 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, E, C, K, F, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, E, C, K, F, st);
  return cudaErrorInvalidValue;
}
