// Mamba-2 SSD chunked scan for Hopper (sm_90a): y = SSD(x * dt) without the
// D skip term, and the final (P, N) state, fp32 state and statistics,
// float32 or bfloat16 x / B / C / y.
//
// Replaces: the Pallas TPU kernel `ssd_scan` (body `_ssd_kernel`) in
// src/repro/kernels/ssd_scan/kernel.py, with its wrapper `ops.py::ssd`.
// Same function, per (batch, head), chunk by chunk of Q steps:
//   cs[i]  = inclusive cumsum of dt[i] * a within the chunk (fp32),
//   y[i]   = sum_{j <= i} (C_i . B_j) exp(cs[i] - cs[j]) dt[j] x[j]
//            + exp(cs[i]) (C_i . state),
//   state <- exp(cs[Q-1]) state + sum_j exp(cs[Q-1] - cs[j]) dt[j] x[j] B_j^T,
// the exponent masked (j <= i) before exp. It follows the model's prefill
// path, `ssd_chunked` (src/repro/models/ssm.py), in two more ways: it
// returns the final state, and in bf16 it rounds the intra-chunk weights
// M[i][j] = (C_i . B_j) exp(cs[i] - cs[j]) and dt[j] x[j] to bf16 before
// their product (fp32 accumulation), as `ssd_chunked` does; the state and
// the inter-chunk term stay fp32. A ragged last chunk (S % Q != 0) runs
// its L < Q true rows only: the reference pads it with dt = 0, an identity
// step, so the state after the true last token is the same.
//
// Layout: x, y (B, S, H, P); dt (B, S, H) fp32; a (H,) fp32; bm, cm
// (B, S, N); state (B, H, P, N) fp32; all contiguous.
//
// What bounds it on this card: per chunk and head it does ~Q^2 N / 2 +
// Q^2 P / 2 + 2 Q P N multiply-adds (7.3 MFLOP at Mamba2-1.3B's Q 128,
// P 64, N 128) against 2 Q P elements of x and y (32 KB in bf16; the heads
// of a batch row share B and C): ~200 flops per byte, ten times the ~20 at
// which the fp32 CUDA cores (67 TFLOP/s) overtake HBM. So this kernel,
// which runs on the CUDA cores, is bound by arithmetic; tensor cores
// (mma.sync / wgmma on the (Q, N) x (N, Q) and (Q, Q) x (Q, P) products)
// are later work. The design:
//   - The TPU kernel walks the chunks of one (batch, head) in order, with
//     the state in VMEM scratch. Here one block per (batch, head) walks its
//     chunks in a loop, the state resident in shared memory: 512 blocks at
//     Mamba2's B = 8, H = 64.
//   - Shared memory is the constraint: fp32 tiles of x, B, C, the state
//     and a (Q, Q) weight tile would take ~256 KB at Q 128, N 128, P 64,
//     over the 227 KB a block may use. So x, B and C are staged in their
//     own type (bf16 halves them), the state (P, N) is fp32, and the
//     weights are built 32 rows at a time (a 32 x Q fp32 tile): 216 KB in
//     fp32, 134 KB in bf16, one block per SM.
//   - Rows of B, C and the state are padded so that threads walking j (or
//     p) fall in distinct banks; a chunk's B and C are read from device
//     memory once per head (the heads of a batch row share them through
//     L2).
//
// Two paths, chosen from the shared memory the chunk needs (the entry
// point reports which one it launched):
//   - single pass, whenever the whole chunk's B, C and x fit the 227 KB a
//     block may use, as above: up to 253 steps in bf16 and 139 in fp32 at
//     P 64, N 128 (134 KB in bf16 at Q 128). Mamba2-1.3B's prefill (chunk
//     128) takes it in either type.
//   - sub-tiled, longer chunks: a chunk of any length is walked in
//     sub-tiles of 128 rows in bf16, 64 in fp32, so shared memory depends
//     on P and N only (167 KB in bf16, 141 KB in fp32 at P 64, N 128).
//     Where a chunk fits, the single pass is the faster (by a fifth to a
//     quarter at P 64, N 128: the sub-tiled path builds a sub-tile's
//     weights over whole column sub-tiles and loads B and x twice; PERF.md
//     times both). For each output sub-tile i it adds exp(cs[i])
//     (C_i . state) and, over the column sub-tiles j <= i, M[i][j] (dt x)_j
//     with
//     M[i][j] = (C_i . B_j) exp(cs[i] - cs[j]) built from the chunk's own
//     cumulative decay cs; the state update at the chunk's end sums over
//     the column sub-tiles the same way. Sub-tiles are not chunks: the
//     state enters and leaves per chunk, nothing is rounded at a sub-tile
//     boundary, and M and dt x are still rounded to bf16 before their
//     product in bf16. cs is not kept for the whole chunk (its length would
//     then bound Q): one thread recomputes a sub-tile's cs from the running
//     sum of the sub-tiles before it, in the same sequential order wherever
//     it runs, so cs[j] on the diagonal pair equals cs[i] bit for bit. B
//     and x of a column sub-tile are reloaded per pair, from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;         // rows of the weight tile built at a time

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T and back: the identity for float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 4) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16(x));
  }
}

// Row stride, in elements, of a shared (rows, n) tile of T: n, rounded up
// to whole 4-byte words, plus one word, so that consecutive rows start in
// different banks.
template <typename T>
__host__ __device__ constexpr int padded(int n) {
  return sizeof(T) == 4 ? n + 1 : ((n + 1) / 2) * 2 + 2;
}

// Rows of a sub-tile (sub-tiled path): 128 in bf16, 64 in fp32, whose
// tiles take twice the bytes.
template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(T) == 2 ? 128 : 64;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Bytes of dynamic shared memory for chunk Q, head dim P, state N.
template <typename T>
__host__ __device__ size_t smem_bytes(int Q, int P, int N) {
  return align16((size_t)Q * padded<T>(N) * sizeof(T)) * 2  // B, C
         + align16((size_t)Q * P * sizeof(T))                 // x
         + align16((size_t)P * (N + 1) * sizeof(float))       // state
         + align16((size_t)kRows * Q * sizeof(float))         // weights
         + align16((size_t)Q * sizeof(float)) * 3;            // dt, cs, w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, T* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sn = padded<T>(N);          // row stride of B and C tiles
  const int ss = N + 1;                 // row stride of the state
  unsigned char* ptr = smem;
  T* Bs = reinterpret_cast<T*>(ptr);
  ptr += align16((size_t)Q * sn * sizeof(T));
  T* Cs = reinterpret_cast<T*>(ptr);
  ptr += align16((size_t)Q * sn * sizeof(T));
  T* Xs = reinterpret_cast<T*>(ptr);
  ptr += align16((size_t)Q * P * sizeof(T));
  float* St = reinterpret_cast<float*>(ptr);
  ptr += align16((size_t)P * ss * sizeof(float));
  float* Mt = reinterpret_cast<float*>(ptr);
  ptr += align16((size_t)kRows * Q * sizeof(float));
  float* dts = reinterpret_cast<float*>(ptr);
  ptr += align16((size_t)Q * sizeof(float));
  float* cs = reinterpret_cast<float*>(ptr);
  ptr += align16((size_t)Q * sizeof(float));
  float* wdec = reinterpret_cast<float*>(ptr);   // exp(cs[L-1] - cs[j]) dt[j]

  const int bi = blockIdx.x / H;
  const int h = blockIdx.x - bi * H;
  const float ah = a[h];
  const int tid = threadIdx.x;

  for (int e = tid; e < P * ss; e += kThreads) St[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int L = min(Q, S - t0);       // true rows of this chunk
    __syncthreads();                    // the previous chunk is done
    for (int e = tid; e < L * N; e += kThreads) {
      const int j = e / N, n = e - j * N;
      const long long g = ((long long)bi * S + t0 + j) * N + n;
      Bs[j * sn + n] = bm[g];
      Cs[j * sn + n] = cm[g];
    }
    for (int e = tid; e < L * P; e += kThreads) {
      const int j = e / P, p = e - j * P;
      Xs[j * P + p] = x[(((long long)bi * S + t0 + j) * H + h) * P + p];
    }
    for (int j = tid; j < L; j += kThreads)
      dts[j] = dt[((long long)bi * S + t0 + j) * H + h];
    __syncthreads();
    if (tid == 0) {                     // chunk-local inclusive cumsum
      float c = 0.f;
      for (int j = 0; j < L; ++j) {
        c += dts[j] * ah;
        cs[j] = c;
      }
    }
    __syncthreads();
    const float cs_last = cs[L - 1];
    for (int j = tid; j < L; j += kThreads)
      wdec[j] = expf(cs_last - cs[j]) * dts[j];

    // y, kRows rows at a time (reads the state entering the chunk)
    for (int i0 = 0; i0 < L; i0 += kRows) {
      const int jn = min(i0 + kRows, L);  // columns j < jn can be <= a row
      for (int e = tid; e < kRows * jn; e += kThreads) {
        const int r = e / jn, j = e - r * jn;
        const int i = i0 + r;
        float m = 0.f;
        if (i < L && j <= i) {
          float dot = 0.f;
          for (int n = 0; n < N; ++n)
            dot += to_float(Cs[i * sn + n]) * to_float(Bs[j * sn + n]);
          m = round_to<T>(dot * expf(cs[i] - cs[j]));
        }
        Mt[r * Q + j] = m;
      }
      __syncthreads();
      for (int e = tid; e < kRows * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        const int i = i0 + r;
        if (i >= L) continue;
        float diag = 0.f;
        for (int j = 0; j <= i; ++j)
          diag += Mt[r * Q + j] *
                  round_to<T>(to_float(Xs[j * P + p]) * dts[j]);
        float off = 0.f;
        for (int n = 0; n < N; ++n)
          off += to_float(Cs[i * sn + n]) * St[p * ss + n];
        store(y + (((long long)bi * S + t0 + i) * H + h) * P + p,
              diag + expf(cs[i]) * off);
      }
      __syncthreads();
    }

    // state <- exp(cs_last) state + sum_j wdec[j] x[j] B_j^T
    const float decay = expf(cs_last);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      float upd = 0.f;
      for (int j = 0; j < L; ++j)
        upd += wdec[j] * to_float(Xs[j * P + p]) * to_float(Bs[j * sn + n]);
      St[p * ss + n] = decay * St[p * ss + n] + upd;
    }
  }
  if (state_out != nullptr) {
    __syncthreads();
    float* so = state_out + ((long long)bi * H + h) * P * N;
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      so[e] = St[p * ss + n];
    }
  }
}

// Bytes of dynamic shared memory of the sub-tiled path (any chunk length).
template <typename T>
__host__ __device__ size_t tiled_smem_bytes(int P, int N) {
  constexpr int kTile = tile_rows<T>();
  return align16((size_t)kTile * padded<T>(N) * sizeof(T)) * 2  // C_i, B_j
         + align16((size_t)kTile * P * sizeof(T))                 // x_j
         + align16((size_t)P * (N + 1) * sizeof(float))           // state
         + align16((size_t)kTile * P * sizeof(float))             // y_i
         + align16((size_t)kRows * kTile * sizeof(float))         // weights
         + align16((size_t)kTile * sizeof(float)) * 4;  // cs_i, dt, cs_j, w
}

// Inclusive cumsum of dts[r] * a over rows [0, n), starting from c, into
// cs; returns the last value. One thread, one order: the same inputs give
// the same bits wherever it is called.
__device__ __forceinline__ float cumsum_rows(const float* dts, float a, int n,
                                             float c, float* cs) {
  for (int r = 0; r < n; ++r) {
    c = __fmaf_rn(dts[r], a, c);
    cs[r] = c;
  }
  return c;
}

// Rows [t, t + n) of the (batch-row) B or C matrix into a padded tile.
template <typename T>
__device__ __forceinline__ void load_bc(T* dst, const T* src, long long row0,
                                        int n, int N, int sn, int tid) {
  for (int e = tid; e < n * N; e += kThreads) {
    const int j = e / N, c = e - j * N;
    dst[j * sn + c] = src[(row0 + j) * N + c];
  }
}

// Rows [t, t + n) of head h's x, and their dt, into shared tiles.
template <typename T>
__device__ __forceinline__ void load_x_dt(T* xs, float* dts, const T* x,
                                          const float* dt, long long row0,
                                          int n, int H, int h, int P,
                                          int tid) {
  for (int e = tid; e < n * P; e += kThreads) {
    const int j = e / P, p = e - j * P;
    xs[j * P + p] = x[((row0 + j) * H + h) * P + p];
  }
  for (int j = tid; j < n; j += kThreads) dts[j] = dt[(row0 + j) * H + h];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_tiled_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 const T* __restrict__ cm, T* __restrict__ y,
                 float* __restrict__ state_out, int S, int H, int P, int N,
                 int Q) {
  constexpr int kTile = tile_rows<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float cs_end;              // cs at the chunk's last step
  const int sn = padded<T>(N);
  const int ss = N + 1;
  unsigned char* ptr = smem;
  T* Ci = reinterpret_cast<T*>(ptr);
  ptr += align16((size_t)kTile * sn * sizeof(T));
  T* Bj = reinterpret_cast<T*>(ptr);
  ptr += align16((size_t)kTile * sn * sizeof(T));
  T* Xj = reinterpret_cast<T*>(ptr);
  ptr += align16((size_t)kTile * P * sizeof(T));
  float* St = reinterpret_cast<float*>(ptr);
  ptr += align16((size_t)P * ss * sizeof(float));
  float* Yi = reinterpret_cast<float*>(ptr);
  ptr += align16((size_t)kTile * P * sizeof(float));
  float* Mt = reinterpret_cast<float*>(ptr);
  ptr += align16((size_t)kRows * kTile * sizeof(float));
  float* csi = reinterpret_cast<float*>(ptr);
  ptr += align16((size_t)kTile * sizeof(float));
  float* dts = reinterpret_cast<float*>(ptr);
  ptr += align16((size_t)kTile * sizeof(float));
  float* csj = reinterpret_cast<float*>(ptr);
  ptr += align16((size_t)kTile * sizeof(float));
  float* wj = reinterpret_cast<float*>(ptr);

  const int bi = blockIdx.x / H;
  const int h = blockIdx.x - bi * H;
  const float ah = a[h];
  const int tid = threadIdx.x;
  const long long brow = (long long)bi * S;

  for (int e = tid; e < P * ss; e += kThreads) St[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int L = min(Q, S - t0);       // true rows of this chunk
    float base = 0.f;                   // thread 0: cs before sub-tile i
    for (int i0 = 0; i0 < L; i0 += kTile) {
      const int Li = min(kTile, L - i0);
      __syncthreads();                  // the last readers of Ci, Yi done
      load_bc(Ci, cm, brow + t0 + i0, Li, N, sn, tid);
      for (int r = tid; r < Li; r += kThreads)
        dts[r] = dt[(brow + t0 + i0 + r) * H + h];
      __syncthreads();
      if (tid == 0) base = cumsum_rows(dts, ah, Li, base, csi);
      __syncthreads();
      // the state's term: y_i = exp(cs_i) (C_i . state entering the chunk)
      for (int e = tid; e < Li * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        float off = 0.f;
        for (int n = 0; n < N; ++n)
          off += to_float(Ci[r * sn + n]) * St[p * ss + n];
        Yi[e] = expf(csi[r]) * off;
      }
      // the intra-chunk term over the column sub-tiles j <= i
      float c = 0.f;                    // thread 0: cs before sub-tile j
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int Lj = min(kTile, L - j0);
        __syncthreads();                // the last readers of Bj, Xj done
        load_bc(Bj, bm, brow + t0 + j0, Lj, N, sn, tid);
        load_x_dt(Xj, dts, x, dt, brow + t0 + j0, Lj, H, h, P, tid);
        __syncthreads();
        if (tid == 0) c = cumsum_rows(dts, ah, Lj, c, csj);
        // x dt, rounded to T before the product as ssd_chunked rounds it
        for (int e = tid; e < Lj * P; e += kThreads)
          store(Xj + e, to_float(Xj[e]) * dts[e / P]);
        __syncthreads();
        for (int r0 = 0; r0 < Li; r0 += kRows) {
          for (int e = tid; e < kRows * Lj; e += kThreads) {
            const int r = e / Lj, jj = e - r * Lj;
            const int ri = r0 + r;
            float m = 0.f;
            if (ri < Li && j0 + jj <= i0 + ri) {
              float dot = 0.f;
              for (int n = 0; n < N; ++n)
                dot += to_float(Ci[ri * sn + n]) * to_float(Bj[jj * sn + n]);
              m = round_to<T>(dot * expf(csi[ri] - csj[jj]));
            }
            Mt[r * kTile + jj] = m;
          }
          __syncthreads();
          for (int e = tid; e < kRows * P; e += kThreads) {
            const int r = e / P, p = e - r * P;
            if (r0 + r >= Li) continue;
            float diag = 0.f;
            for (int jj = 0; jj < Lj; ++jj)
              diag += Mt[r * kTile + jj] * to_float(Xj[jj * P + p]);
            Yi[(r0 + r) * P + p] += diag;
          }
          __syncthreads();
        }
      }
      for (int e = tid; e < Li * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        store(y + ((brow + t0 + i0 + r) * H + h) * P + p, Yi[e]);
      }
    }

    // state <- exp(cs_end) state + sum_j exp(cs_end - cs_j) dt_j x_j B_j^T
    __syncthreads();
    if (tid == 0) cs_end = base;
    __syncthreads();
    const float last = cs_end;
    const float decay = expf(last);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      St[p * ss + n] *= decay;
    }
    float c = 0.f;
    for (int j0 = 0; j0 < L; j0 += kTile) {
      const int Lj = min(kTile, L - j0);
      __syncthreads();
      load_bc(Bj, bm, brow + t0 + j0, Lj, N, sn, tid);
      load_x_dt(Xj, dts, x, dt, brow + t0 + j0, Lj, H, h, P, tid);
      __syncthreads();
      if (tid == 0) c = cumsum_rows(dts, ah, Lj, c, csj);
      __syncthreads();
      for (int j = tid; j < Lj; j += kThreads)
        wj[j] = expf(last - csj[j]) * dts[j];
      __syncthreads();
      for (int e = tid; e < P * N; e += kThreads) {
        const int p = e / N, n = e - p * N;
        float upd = 0.f;
        for (int j = 0; j < Lj; ++j)
          upd += wj[j] * to_float(Xj[j * P + p]) * to_float(Bj[j * sn + n]);
        St[p * ss + n] += upd;
      }
    }
  }
  if (state_out != nullptr) {
    __syncthreads();
    float* so = state_out + ((long long)bi * H + h) * P * N;
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      so[e] = St[p * ss + n];
    }
  }
}

// Dynamic shared memory a block may use on an H100 (227 KB).
constexpr size_t kMaxSmem = 232448;

// The path chunk Q takes: 0 = single pass where the chunk fits, else 1.
template <typename T>
int choose_path(int Q, int P, int N) {
  return smem_bytes<T>(Q, P, N) <= kMaxSmem ? 0 : 1;
}

template <typename T>
size_t path_smem(int path, int Q, int P, int N) {
  return path == 0 ? smem_bytes<T>(Q, P, N) : tiled_smem_bytes<T>(P, N);
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* bm, const void* cm, void* y, float* state,
                   int B, int S, int H, int P, int N, int Q,
                   cudaStream_t stream, int* path) {
  if (*path < 0) *path = choose_path<T>(Q, P, N);
  if (*path > 1) return cudaErrorInvalidValue;
  const bool tiled = *path == 1;
  auto kernel = tiled ? ssd_tiled_kernel<T> : ssd_kernel<T>;
  const size_t bytes = path_smem<T>(*path, Q, P, N);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), state, S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory that chunk Q needs at head dim P, state N on the
// path it takes (the wrapper refuses shapes above the card's 227 KB per
// block).
extern "C" long long repro_ssd_scan_smem(int Q, int P, int N, int dtype) {
  if (dtype == 0)
    return (long long)path_smem<float>(choose_path<float>(Q, P, N), Q, P, N);
  return (long long)path_smem<__nv_bfloat16>(
      choose_path<__nv_bfloat16>(Q, P, N), Q, P, N);
}

// C entry point: returns the cudaError_t of the launch (0 = launched). On
// entry *path is -1, to choose the path from the shared memory the chunk
// needs, or the path to force (one whose tiles fit), so that the two can
// be timed against each other; on return it holds the path launched: 0 =
// single pass (the whole chunk in shared memory), 1 = sub-tiled. state may be
// null (no final state written). dtype: 0 = float32, 1 = bfloat16 (x, bm,
// cm and y share it; dt, a and state are fp32).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y,
                              void* state, int B, int S, int H, int P, int N,
                              int Q, int dtype, void* stream, int* path) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      (long long)B * H > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return launch<float>(x, dtf, af, bm, cm, y, sf, B, S, H, P, N, Q, st,
                         path);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, af, bm, cm, y, sf, B, S, H, P, N, Q,
                                 st, path);
  return cudaErrorInvalidValue;
}
