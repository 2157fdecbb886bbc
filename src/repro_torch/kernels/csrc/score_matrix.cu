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
//
// The self path (score_matrix_self_f32) is for SELECT-NEIGHBORS, which always
// passes one tensor as both q and x (fp32, n = 8..64 candidates on the
// repair and refine paths). The general kernel stages that [n, d] block
// twice and pays a whole 64 x 64 tile at any n, so n = 8 costs what n = 64
// costs. Here a block of 256 threads takes a group of G = 128 / NP rows r
// (NP: n rounded up to 8, 16, 32 or 64), so every group stages 128
// candidate rows, each once, and computes G n x n matrices with NP / 2
// outputs per thread (1x4, 2x4, 4x4, 4x8), strided so that the eight
// threads of a quarter-warp read eight consecutive staged rows (float4
// reads without bank conflicts: the row stride of 68 floats shifts each row
// by 4 banks). d is staged in chunks of 64 so that two buffers take 68 KB and
// two blocks share an SM. Blocks are persistent: each walks its groups and
// their d-chunks with cp.async double buffering, so the next chunk's load is
// in flight while this one computes and stores. The G matrices of a group
// are contiguous in the output; they are assembled in shared memory and
// written with 16-byte stores. The k order of each sum is the general
// kernel's (ascending fmaf from 0), so both paths give the same bits. Every
// score is computed, not mirrored from the symmetric half: at these shapes
// the loads, the stores and the shared-memory reads bound the kernel, not
// the FMAs. For n > 64 the general kernel stays: at the insert's n = 96
// (R = 64) its four blocks per row fill the card better than one.
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

// ---- self path: q is x, fp32, n <= 64, d % 4 == 0 ----

constexpr int SELF_ROWS = 128;     // staged candidate rows per step (G * NP)
constexpr int SELF_DC = 64;        // dims staged per step
constexpr int SELF_LD = SELF_DC + 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 2)
score_matrix_self(const float* __restrict__ x, const float* __restrict__ xsq,
                  float* __restrict__ out, int R, int n, int d, int metric) {
  constexpr int G = SELF_ROWS / NP;            // rows r per group
  constexpr int P = NP * NP * G / THREADS;     // outputs per thread
  constexpr int TJ = P >= 32 ? 8 : 4;
  constexpr int TI = P / TJ;
  constexpr int NI = NP / TI, NJ = NP / TJ;    // thread grid per r
  static_assert(NI * NJ * G == THREADS && TI >= 1, "thread mapping");
  constexpr int STAGE = SELF_ROWS * SELF_LD;   // floats per buffer
  static_assert(STAGE >= SELF_ROWS * NP, "the output tile fits a buffer");
  extern __shared__ __align__(16) float smem[];

  const int t = threadIdx.x;
  const int g = t / (NI * NJ);
  const int u = t % (NI * NJ);
  const int ti = u / NJ, tj = u % NJ;
  const int ngroups = (R + G - 1) / G;
  const int nchunks = (d + SELF_DC - 1) / SELF_DC;
  const int mine = (int)blockIdx.x < ngroups
                       ? (ngroups - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = mine * nchunks;            // steps: (group, d-chunk)

  // stage step s: d-chunk s % nchunks of the [G, n] rows of this block's
  // group s / nchunks (contiguous in x), row (g, i) at (g * NP + i) * LD
  auto stage = [&](int s) {
    const int r0 = ((int)blockIdx.x + (s / nchunks) * (int)gridDim.x) * G;
    const int k0 = (s % nchunks) * SELF_DC;
    const int per_row = min(SELF_DC, d - k0) / 4;
    const int rows = min(G, R - r0) * n;
    float* buf = smem + (s & 1) * STAGE;
    const float* src = x + (size_t)r0 * n * d + k0;
    for (int e = t; e < rows * per_row; e += THREADS) {
      const int row = e / per_row, c = e % per_row;
      cp_async16(buf + ((row / n) * NP + row % n) * SELF_LD + 4 * c,
                 src + (size_t)row * d + 4 * c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (total > 0) stage(0);
  float acc[TI][TJ];
  for (int s = 0; s < total; ++s) {
    // step s has landed and every thread is done with the other buffer
    // (read, or copied out, at step s - 1): refill it meanwhile
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (s + 1 < total) stage(s + 1);
    const int chunk = s % nchunks;
    float* cur = smem + (s & 1) * STAGE;
    if (chunk == 0) {
#pragma unroll
      for (int a = 0; a < TI; ++a)
#pragma unroll
        for (int b = 0; b < TJ; ++b) acc[a][b] = 0.f;
    }
    const int kc = min(SELF_DC, d - chunk * SELF_DC);
    const float* base = cur + g * NP * SELF_LD;
    for (int k = 0; k < kc; k += 4) {
      float4 xi[TI], xj[TJ];
#pragma unroll
      for (int a = 0; a < TI; ++a)
        xi[a] = *reinterpret_cast<const float4*>(base + (ti + NI * a) * SELF_LD + k);
#pragma unroll
      for (int b = 0; b < TJ; ++b)
        xj[b] = *reinterpret_cast<const float4*>(base + (tj + NJ * b) * SELF_LD + k);
#pragma unroll
      for (int a = 0; a < TI; ++a)
#pragma unroll
        for (int b = 0; b < TJ; ++b) {
          float v = acc[a][b];
          v = fmaf(xi[a].x, xj[b].x, v);
          v = fmaf(xi[a].y, xj[b].y, v);
          v = fmaf(xi[a].z, xj[b].z, v);
          v = fmaf(xi[a].w, xj[b].w, v);
          acc[a][b] = v;
        }
    }
    if (chunk != nchunks - 1) continue;

    // the group is summed: assemble its G contiguous [n, n] matrices in
    // cur, then store them with 16-byte stores
    __syncthreads();
    const int r0 = ((int)blockIdx.x + (s / nchunks) * (int)gridDim.x) * G;
    const int g_valid = min(G, R - r0);
    if (g < g_valid) {
#pragma unroll
      for (int b = 0; b < TJ; ++b) {
        const int j = tj + NJ * b;
        if (j >= n) continue;
        const float sq = metric == 0 ? __ldg(xsq + (size_t)(r0 + g) * n + j) : 0.f;
#pragma unroll
        for (int a = 0; a < TI; ++a) {
          const int i = ti + NI * a;
          if (i >= n) continue;
          cur[(g * n + i) * n + j] =
              metric == 0 ? __fsub_rn(__fmul_rn(2.f, acc[a][b]), sq) : acc[a][b];
        }
      }
    }
    __syncthreads();
    const int count = g_valid * n * n;
    float* dst = out + (size_t)r0 * n * n;
    if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      const int n4 = count / 4;
      for (int e = t; e < n4; e += THREADS)
        reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(cur)[e];
      for (int e = 4 * n4 + t; e < count; e += THREADS) dst[e] = cur[e];
    } else {
      for (int e = t; e < count; e += THREADS) dst[e] = cur[e];
    }
  }
}

template <int NP>
int launch_self(const float* x, const float* xsq, float* out, int R, int n, int d,
                int metric, cudaStream_t st) {
  constexpr size_t dyn = 2 * SELF_ROWS * SELF_LD * sizeof(float);
  // resident blocks on the card, asked once (host calls cost as much as a
  // small launch)
  static int resident = 0;
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        score_matrix_self<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    int per_sm = 0, dev = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score_matrix_self<NP>,
                                                          THREADS, dyn);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    resident = max(1, per_sm) * sms;
  }
  const int ngroups = (R + SELF_ROWS / NP - 1) / (SELF_ROWS / NP);
  score_matrix_self<NP><<<max(1, min(ngroups, resident)), THREADS, dyn, st>>>(
      x, xsq, out, R, n, d, metric);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int score_matrix_self_f32(const float* x, const float* xsq, float* out,
                                     int R, int n, int d, int metric, void* stream) {
  if (R < 1 || n < 1 || n > 64 || d < 4 || d % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 8) return launch_self<8>(x, xsq, out, R, n, d, metric, st);
  if (n <= 16) return launch_self<16>(x, xsq, out, R, n, d, metric, st);
  if (n <= 32) return launch_self<32>(x, xsq, out, R, n, d, metric, st);
  return launch_self<64>(x, xsq, out, R, n, d, metric, st);
}

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
