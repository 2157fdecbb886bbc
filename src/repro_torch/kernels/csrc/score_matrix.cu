// Batched score matrix: out[r, b, m] = 2<q[r,b], x[r,m]> - xsq[r,m] (l2) or
// <q[r,b], x[r,m]> (ip/cos), fp32 accumulation, x and q in fp32 or bf16.
//
// Replaces score_matrix_pallas in src/repro/kernels/distance_matrix.py (body
// _score_kernel): the tiled [B, M] fp32 score matrix with the l2 correction
// applied once the whole of d has been summed. The Pallas kernel computes one
// matrix; here a leading batch axis r runs R independent matrices in one
// launch, because SELECT-NEIGHBORS needs one small [n, n] pair matrix per
// row it selects for (R = 64 * d_in = 4,096 rows of n = 8..96 candidates on
// the repair paths). The 2-D call is R = 1.
//
// Bound on this card: at the repair shape (R = 4,096, n = 64, d = 128) the
// work is 2*R*n*n*d = 4.3 GFLOP against (R*n*d + R*n + R*n*n) * 4 bytes =
// 202 MB (q and x are one tensor there), about 0.064 ms of fp32 FMA on the
// CUDA cores against 0.060 ms of HBM: the two are balanced. No TF32: integer-valued inputs must give the
// exact fp32 result of the plain version.
//
// The design is the simple tiled one: one block per (r, 64 x 64 output tile),
// 256 threads, each holding a 4 x 4 patch of accumulators in registers (rows
// ty + 16*i, columns tx + 16*j, so the shared-memory reads of a warp are
// broadcasts or 16 consecutive words). The q and x tiles are staged through
// shared memory in d-chunks of 32, transposed to [k][row], with 16-byte
// loads where d and the base pointers allow it (4 floats or 8 bf16 values,
// widened to fp32 on load) and 4- or 2-byte loads otherwise; rows past B or
// M and columns past d load as zero. For n <= 64 the grid is one block per
// row r. The l2 epilogue is written with __fmul_rn/__fsub_rn so nvcc cannot
// contract it into an FMA, which keeps integer-valued data byte-equal to the
// plain PyTorch version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;     // output rows (b) and columns (m) per block
constexpr int DK = 32;       // d-chunk staged per step
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage rows [row0, row0 + TILE) x columns [k0, k0 + DK) of src (row-major,
// row stride d, nrows rows) into dst[k][row], zero outside the matrix.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(float (*dst)[TILE + PAD], const T* __restrict__ src,
                                      int nrows, int d, int row0, int k0) {
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    constexpr int PER_ROW = DK / V;
    for (int e = threadIdx.x; e < TILE * PER_ROW; e += THREADS) {
      const int row = e / PER_ROW, cv = e % PER_ROW;
      const int gr = row0 + row, gc = k0 + cv * V;
      if (gr < nrows && gc < d) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + gc);
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) dst[cv * V + j][row] = widen(v[j]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) dst[cv * V + j][row] = 0.f;
      }
    }
  } else {
    for (int e = threadIdx.x; e < TILE * DK; e += THREADS) {
      const int row = e / DK, c = e % DK;
      const int gr = row0 + row, gc = k0 + c;
      dst[c][row] = (gr < nrows && gc < d) ? widen(src[(size_t)gr * d + gc]) : 0.f;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
score_matrix_kernel(const T* __restrict__ x, const float* __restrict__ xsq,
                    const T* __restrict__ q, float* __restrict__ out, int B, int M,
                    int d, int metric) {
  __shared__ __align__(16) float qs[DK][TILE + PAD];
  __shared__ __align__(16) float xs[DK][TILE + PAD];
  const int r = blockIdx.x;
  const int b0 = blockIdx.y * TILE;
  const int m0 = blockIdx.z * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* qr = q + (size_t)r * B * d;
  const T* xr = x + (size_t)r * M * d;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += DK) {
    stage<T, VEC>(qs, qr, B, d, b0, k0);
    stage<T, VEC>(xs, xr, M, d, m0, k0);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = xs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tx + 16 * j;
    if (m >= M) continue;
    const float sq = metric == 0 ? xsq[(size_t)r * M + m] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty + 16 * i;
      if (b >= B) continue;
      out[((size_t)r * B + b) * M + m] =
          metric == 0 ? __fsub_rn(__fmul_rn(2.f, acc[i][j]), sq) : acc[i][j];
    }
  }
}

template <typename T>
int launch(const T* x, const float* xsq, const T* q, float* out, int R, int B,
           int M, int d, int metric, void* stream) {
  const int tb = (B + TILE - 1) / TILE, tm = (M + TILE - 1) / TILE;
  if (R < 1 || tb > 65535 || tm > 65535) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  dim3 grid(R, tb, tm);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    score_matrix_kernel<T, true><<<grid, THREADS, 0, st>>>(x, xsq, q, out, B, M, d, metric);
  } else {
    score_matrix_kernel<T, false><<<grid, THREADS, 0, st>>>(x, xsq, q, out, B, M, d, metric);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int score_matrix_f32(const float* x, const float* xsq, const float* q,
                                float* out, int R, int B, int M, int d, int metric,
                                void* stream) {
  return launch<float>(x, xsq, q, out, R, B, M, d, metric, stream);
}

extern "C" int score_matrix_bf16(const void* x, const float* xsq, const void* q,
                                 float* out, int R, int B, int M, int d, int metric,
                                 void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), xsq,
                               static_cast<const __nv_bfloat16*>(q), out, R, B, M,
                               d, metric, stream);
}
