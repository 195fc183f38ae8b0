// Grouped (per-expert) matmul for Hopper (sm_90a): out[e] = x[e] @ w[e] for
// every expert in one launch, fp32 accumulation, float32 or bfloat16 in and
// out.
//
// Replaces: the Pallas TPU kernel `gmm` (body `_gmm_kernel`) in
// src/repro/kernels/moe_gmm/kernel.py, with its SwiGLU wrapper
// `ops.py::expert_mlp`. Same function: x (E, C, K) times w (E, K, F) gives
// (E, C, F) in x's type, each product accumulated in fp32 and rounded once.
// Unlike the TPU kernel it needs no C, K or F multiple of a block: the
// ragged edges are masked or zero-filled, so any capacity C runs.
//
// Layout: x (E, C, K), w (E, K, F) and out (E, C, F), contiguous.
//
// What bounds it on this card, at Granite-3.0-1B-A400M's experts (E 32,
// K/F 1024/512 for gate and up, 512/1024 for down; C = batch x capacity,
// 8-64 rows at decode, 40-320 at prefill): the weights are 33.5 MB of bf16
// per call, 0.010 ms at 3.35 TB/s, and an expert does 2 C K F flops, C
// flops per weight byte. That stays below the ~295 flops per byte at which
// bf16 tensor cores (989 TFLOP/s) overtake HBM up to C ~ 300, so every
// Granite shape is bound by bytes, the B=64 prefill (C 320) at the ridge.
// On fp32 CUDA cores (67 TFLOP/s) the C 320 shape alone needs 0.16 ms, so
// bf16 goes through the tensor cores.
//
// Which type takes which path, chosen from the type, the shape and the
// pointers before the launch (never after a failed one); the entry point
// reports the instance it launched:
//
// - bfloat16: tensor cores, mma.sync.aligned.m16n8k16 (bf16 in, fp32
//   accumulators in registers), operands read from shared memory with
//   ldmatrix. Tiles are staged by 16-byte cp.async.cg into a ring over K,
//   the next stages' loads in flight while a stage is multiplied; shared
//   rows are padded by 16 bytes so that ldmatrix's eight row reads fall in
//   distinct banks. A K, F or C edge is zero-filled through cp.async's
//   source size, so no multiple of a tile is needed. The tile follows C:
//   * C <= 16 (decode groups, one token per batch row and expert): the
//     operands swap, out[e]^T = w[e]^T x[e]^T. 64 columns of w fill the
//     MMA's 16-row side (ldmatrix.trans reads w^T from w's rows) and C the
//     8-column side (one or two n-tiles), so no tensor-core rows are spent
//     on padding C. This shape streams the weights: each block's four
//     warps split every 128-deep K stage four ways (split-K inside the
//     block), 4 stages of 16 KB of w, 2 blocks per SM, ~96 KB in flight
//     per SM; the four partial sums meet in shared memory in fp32, in a
//     fixed order, and are rounded once. 8 (F 512) or 16 (F 1024) column
//     tiles per expert give 256-512 blocks on 132 SMs.
//   * C > 16: x is the A operand as it stands (K-contiguous, ldmatrix.x4)
//     and w the B operand in row layout (ldmatrix.x4.trans); a 64 x 128
//     block tile with 4 warps, 128 x 128 with 8 warps at C >= 128, each
//     warp 32 x 64; 3 stages of BK 64.
//   * 16-byte loads need K % 8 == 0, F % 8 == 0 and 16-byte aligned x and
//     w. Any other shape takes the 64 x 128 tensor-core instance with
//     masked scalar loads into the same shared tiles and scalar stores:
//     an explicit instance, not a fallback.
// - float32: CUDA cores, no TF32. fp32 is the port's precision oracle:
//   fp32 generation on the card must choose the CPU's experts and tokens,
//   which TF32 or 3xTF32 (10 or ~21 mantissa bits per product) would not
//   hold. One block per (expert, C tile, F tile) keeps its accumulators in
//   registers and loops over K, staging a BC x 32 tile of x and a 32 x 64
//   tile of w through shared memory; the C tile is 8, 32 or 64 rows
//   following C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- float32: CUDA cores -------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBF = 64;      // output columns per block
constexpr int kBK = 32;      // contraction depth per shared-memory step

// One block: rows [c0, c0 + BC) x columns [f0, f0 + 64) of expert e.
// Threads form a (BC / TM) x (64 / TN) grid; thread (ty, tx) owns rows
// c0 + ty + (BC / TM) * i and columns f0 + tx + (64 / TN) * j.
template <int BC, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
gmm_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int C, int K, int F) {
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
  const float* xe = x + (long long)e * C * K;
  const float* we = w + (long long)e * K * F;

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
      xs[kk][r] = (c < C && k < K) ? xe[(long long)c * K + k] : 0.f;
    }
    // w tile: 32 rows of K x 64 columns; neighbouring threads read
    // neighbouring f
    for (int idx = threadIdx.x; idx < kBK * kBF; idx += kThreads) {
      const int kk = idx / kBF;
      const int ff = idx - kk * kBF;
      const int k = k0 + kk, f = f0 + ff;
      ws[kk][ff] = (k < K && f < F) ? we[(long long)k * F + f] : 0.f;
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

  float* oe = out + (long long)e * C * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + ty + RY * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx + RX * j;
      if (f < F) oe[(long long)c * F + f] = acc[i][j];
    }
  }
}

template <int BC, int TM, int TN>
cudaError_t launch_fp32_tile(const void* x, const void* w, void* out, int E,
                             int C, int K, int F, cudaStream_t stream) {
  const dim3 grid((F + kBF - 1) / kBF, (C + BC - 1) / BC, E);
  gmm_fp32_kernel<BC, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), C, K, F);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const void* x, const void* w, void* out, int E,
                        int C, int K, int F, cudaStream_t stream) {
  if (C <= 8) return launch_fp32_tile<8, 1, 2>(x, w, out, E, C, K, F, stream);
  if (C <= 32)
    return launch_fp32_tile<32, 2, 4>(x, w, out, E, C, K, F, stream);
  return launch_fp32_tile<64, 4, 4>(x, w, out, E, C, K, F, stream);
}

// ---- bfloat16: tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major (R, Cn)
// bf16 matrix into a shared tile of row stride LDS elements, 8 columns
// (16 bytes) per step of NT threads; what lies outside the matrix is 0.
// kVec: 16-byte cp.async (Cn % 8 == 0, 16-byte aligned g); else masked
// scalar loads, stored 16 bytes at a time.
template <int ROWS, int COLS, int LDS, int NT, bool kVec>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int R,
                                          int Cn, int r0, int c0, int tid) {
  constexpr int kPerRow = COLS / 8;
  constexpr int kSteps = ROWS * kPerRow / NT;
  static_assert(ROWS * kPerRow % NT == 0, "tile does not match the block");
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int i = tid + it * NT;
    const int r = i / kPerRow, cc = (i % kPerRow) * 8;
    const int gr = r0 + r, gc = c0 + cc;
    bf16* dst = s + r * LDS + cc;
    if constexpr (kVec) {
      const bool ok = gr < R && gc < Cn;
      cp_async16(dst, ok ? g + (long long)gr * Cn + gc : g, ok);
    } else {
      const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = gc + 2 * j;
        const uint32_t lo =
            gr < R && c < Cn ? gs[(long long)gr * Cn + c] : 0u;
        const uint32_t hi =
            gr < R && c + 1 < Cn ? gs[(long long)gr * Cn + c + 1] : 0u;
        v[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Opt in to `bytes` of dynamic shared memory once per kernel instance and
// device (bit d of `done` marks device d).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

// C > 16: block tile (32 WM) x 128 of out[e], WM x 2 warps, each warp 32
// rows x 64 columns (2 x 8 m16n8 accumulators); 3 stages of 64-deep
// slices of x and w. (64 x 128 and 128 x 128, 3 stages of 64, were the
// fastest of the tile, warp-tile, depth and stage variants timed on the
// card at Granite's shapes.)
constexpr int kTcBN = 128;
constexpr int kTcBK = 64;
constexpr int kTcStages = 3;
constexpr int kLdA = kTcBK + 8;          // padded row strides, elements
constexpr int kLdB = kTcBN + 8;

template <int WM>
__host__ __device__ constexpr int tc_smem() {
  return kTcStages * (32 * WM * kLdA + kTcBK * kLdB) * 2;
}

template <int WM, bool kVec>
__global__ void __launch_bounds__(64 * WM)
gmm_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              bf16* __restrict__ out, int C, int K, int F) {
  constexpr int BM = 32 * WM, NT = 64 * WM;
  constexpr int kA = BM * kLdA, kStage = kA + kTcBK * kLdB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z, c0 = blockIdx.y * BM, f0 = blockIdx.x * kTcBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const bf16* xe = x + (long long)e * C * K;
  const bf16* we = w + (long long)e * K * F;

  auto load = [&](int slot, int kt) {
    bf16* sa = smem + slot * kStage;
    load_tile<BM, kTcBK, kLdA, NT, kVec>(sa, xe, C, K, c0, kt * kTcBK, tid);
    load_tile<kTcBK, kTcBN, kLdB, NT, kVec>(sa + kA, we, K, F, kt * kTcBK,
                                            f0, tid);
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int nk = (K + kTcBK - 1) / kTcBK;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();          // stage kt landed; stage kt - 1 is free
    const int nxt = kt + kTcStages - 1;
    if (nxt < nk) load(nxt % kTcStages, nxt);
    cp_async_commit();
    const bf16* sa = smem + (kt % kTcStages) * kStage;
    const bf16* sb = sa + kA;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], sa + (wm * 32 + mi * 16 + (lane & 15)) * kLdA +
                               kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sb + (kk + (lane & 15)) * kLdB + wn * 64 +
                                 nj * 16 + (lane >> 4) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  // accumulator (mi, ni): rows g and g + 8, columns 2 t and 2 t + 1
  bf16* oe = out + (long long)e * C * F;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm * 32 + mi * 16 + g + 8 * h;
        const int f = f0 + wn * 64 + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (c >= C || f >= F) continue;
        bf16* o = oe + (long long)c * F + f;
        if constexpr (kVec) {       // F even, so f + 1 < F too
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (f + 1 < F) o[1] = __float2bfloat16(v1);
        }
      }
}

template <int WM, bool kVec>
cudaError_t launch_tc(const void* x, const void* w, void* out, int E, int C,
                      int K, int F, cudaStream_t stream) {
  static unsigned long long opted = 0;
  auto kernel = gmm_tc_kernel<WM, kVec>;
  const cudaError_t err = allow_smem(kernel, tc_smem<WM>(), opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kTcBN - 1) / kTcBN, (C + 32 * WM - 1) / (32 * WM), E);
  kernel<<<grid, 64 * WM, tc_smem<WM>(), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), C, K, F);
  return cudaGetLastError();
}

// C <= 16 (operands swapped): block tile 64 columns of w x all C rows of x,
// out^T[f][c] = sum_k w[k][f] x[c][k]; 4 warps, each a quarter of every
// 128-deep K stage, 4 m16 tiles (f) x NTILE n8 tiles (c) of partial sums.
constexpr int kSwThreads = 128;
constexpr int kSwBF = 64;
constexpr int kSwBK = 128;
constexpr int kSwStages = 4;
constexpr int kLdW = kSwBF + 8;
constexpr int kLdX = kSwBK + 8;

template <int NTILE>
__host__ __device__ constexpr int swap_smem() {
  return kSwStages * (kSwBK * kLdW + 8 * NTILE * kLdX) * 2;
}

template <int NTILE>
__global__ void __launch_bounds__(kSwThreads)
gmm_tc_swap_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ out, int C, int K, int F) {
  constexpr int CR = 8 * NTILE;            // rows of x staged (C <= CR)
  constexpr int kW = kSwBK * kLdW, kStage = kW + CR * kLdX;
  static_assert(4 * CR * kSwBF * 4 <= swap_smem<NTILE>(),
                "the partial sums do not fit the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.y, f0 = blockIdx.x * kSwBF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* xe = x + (long long)e * C * K;
  const bf16* we = w + (long long)e * K * F;

  auto load = [&](int slot, int kt) {
    bf16* sw = smem + slot * kStage;
    load_tile<kSwBK, kSwBF, kLdW, kSwThreads, true>(sw, we, K, F,
                                                    kt * kSwBK, f0, tid);
    load_tile<CR, kSwBK, kLdX, kSwThreads, true>(sw + kW, xe, C, K, 0,
                                                 kt * kSwBK, tid);
  };

  float acc[4][NTILE][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NTILE; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int nk = (K + kSwBK - 1) / kSwBK;
#pragma unroll
  for (int s = 0; s < kSwStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kSwStages - 2>();
    __syncthreads();
    const int nxt = kt + kSwStages - 1;
    if (nxt < nk) load(nxt % kSwStages, nxt);
    cp_async_commit();
    const bf16* sw = smem + (kt % kSwStages) * kStage;
    const bf16* sx = sw + kW;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k = warp * 32 + ks * 16;
      // A = w^T (16 f x 16 k) read transposed from w's rows (k)
      uint32_t a[4][4], b[NTILE][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(a[mi], sw + (k + (lane & 7) + ((lane >> 4) << 3)) *
                                          kLdW +
                                      mi * 16 + ((lane >> 3) & 1) * 8);
      // B = x^T (16 k x 8 c): x's rows (c) are B's columns
      if constexpr (NTILE == 1) {
        ldmatrix_x2(b[0], sx + (lane & 7) * kLdX + k + ((lane >> 3) & 1) * 8);
      } else {
        uint32_t r[4];
        ldmatrix_x4(r, sx + ((lane & 7) + ((lane >> 4) << 3)) * kLdX + k +
                           ((lane >> 3) & 1) * 8);
        b[0][0] = r[0];
        b[0][1] = r[1];
        b[1][0] = r[2];
        b[1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NTILE; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // every warp is done with the ring

  // the four warps' partial sums, red[warp][c][f], fp32
  float* red = reinterpret_cast<float*>(smem_raw);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NTILE; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int f = mi * 16 + g + 8 * (r >> 1);
        const int c = ni * 8 + 2 * t + (r & 1);
        red[(warp * CR + c) * kSwBF + f] = acc[mi][ni][r];
      }
  __syncthreads();
  bf16* oe = out + (long long)e * C * F;
  for (int i = tid; i < CR * kSwBF; i += kSwThreads) {
    const int c = i / kSwBF, f = i % kSwBF;
    if (c >= C || f0 + f >= F) continue;
    float s = red[c * kSwBF + f];
#pragma unroll
    for (int wp = 1; wp < 4; ++wp) s += red[(wp * CR + c) * kSwBF + f];
    oe[(long long)c * F + f0 + f] = __float2bfloat16(s);
  }
}

template <int NTILE>
cudaError_t launch_swap(const void* x, const void* w, void* out, int E,
                        int C, int K, int F, cudaStream_t stream) {
  static unsigned long long opted = 0;
  auto kernel = gmm_tc_swap_kernel<NTILE>;
  const cudaError_t err = allow_smem(kernel, swap_smem<NTILE>(), opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kSwBF - 1) / kSwBF, E);
  kernel<<<grid, kSwThreads, swap_smem<NTILE>(), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), C, K, F);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Dynamic shared memory of instance `instance` (codes below), in bytes.
extern "C" int repro_moe_gmm_smem(int instance) {
  switch (instance) {
    case 1: return swap_smem<1>();
    case 2: return swap_smem<2>();
    case 3: case 5: return tc_smem<2>();
    case 4: return tc_smem<4>();
    default: return 0;
  }
}

// C entry point: returns the cudaError_t of the launch (0 = launched). On
// entry *instance is -1, to choose the instance from the type, the shape
// and the pointers, or the code of a bf16 instance to force where it can
// run the shape (1 needs C <= 8, 2 needs C <= 16, 1-4 need 16-byte loads),
// so that instances can be timed against each other; on return it holds
// the instance launched:
//   0 fp32 on CUDA cores,
//   1 bf16 tensor cores, operands swapped, C <= 8,
//   2 bf16 tensor cores, operands swapped, C <= 16,
//   3 bf16 tensor cores, 64 x 128 tiles, 16 < C < 128,
//   4 bf16 tensor cores, 128 x 128 tiles, C >= 128,
//   5 bf16 tensor cores, 64 x 128 tiles, masked scalar loads (K or F not a
//     multiple of 8, or x / w not 16-byte aligned), any C.
// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).
extern "C" int repro_moe_gmm(const void* x, const void* w, void* out, int E,
                             int C, int K, int F, int dtype, void* stream,
                             int* instance) {
  if (E <= 0 || C <= 0 || K <= 0 || F <= 0 || E > 65535 ||
      (C + 7) / 8 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int want = *instance;
  if (dtype == 0) {
    if (want > 0) return cudaErrorInvalidValue;
    *instance = 0;
    return launch_fp32(x, w, out, E, C, K, F, st);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const bool vec = K % 8 == 0 && F % 8 == 0 && aligned(x, 16) &&
                   aligned(w, 16) && aligned(out, 4);
  int pick = !vec ? 5 : C <= 8 ? 1 : C <= 16 ? 2 : C < 128 ? 3 : 4;
  if (want >= 0) {
    if (want == 0 || want > 5 || (want < 5 && !vec) || (want == 1 && C > 8) ||
        (want == 2 && C > 16))
      return cudaErrorInvalidValue;
    pick = want;
  }
  *instance = pick;
  switch (pick) {
    case 1: return launch_swap<1>(x, w, out, E, C, K, F, st);
    case 2: return launch_swap<2>(x, w, out, E, C, K, F, st);
    case 3: return launch_tc<2, true>(x, w, out, E, C, K, F, st);
    case 4: return launch_tc<4, true>(x, w, out, E, C, K, F, st);
    default: return launch_tc<2, false>(x, w, out, E, C, K, F, st);
  }
}
