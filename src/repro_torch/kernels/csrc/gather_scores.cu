// Fused gather + score over candidate ids: fp32 or bf16 rows, int8 codes.
//
// Replaces the Pallas kernels of src/repro/kernels/gather_distance.py:
//   gather_scores_pallas    (:37, _gd_kernel)  -> gather_scores_f32 and
//                                                 gather_scores_bf16 below
//   gather_scores_q8_pallas (:87, _gdq_kernel) -> gather_scores_q8 below
// The Pallas kernel takes a table of any dtype and widens each row to f32
// in its body; gather_scores_bf16 is the bf16-row instantiation of the
// fp32 kernel (the sharded index stores its vectors in bf16): each element
// widens exactly (its bits shifted into the top half of an f32) and feeds
// the same fmaf chain, so a bf16 table and the f32 table of its widened
// values give bit-equal scores. Its rows are half the bytes: B*C*(2d + 12).
// For each query b and candidate slot c the score of row table[ids[b,c]]
// against q[b]: l2 = 2<x,q> - tsq[id], ip/cos = <x,q>; the q8 variant scores
// the dequantized row s*codes: l2 = s*(2<c,q> - s*sum(c^2)), ip/cos = s*<c,q>.
// Ids < 0 or >= N write -inf without touching the table. fp32 accumulation.
//
// Bound on this card: bytes. Each (b, c) reads one row (4d bytes, or d for
// codes), its id, its norm or scale and writes a score: B*C*(4d + 12) bytes
// plus q, against 2d FLOPs a row, far below the H100's FLOP/byte balance.
// At the GLOBAL-repair block (B 4,096, C 32, d 128) that is 0.0211 ms
// (fp32) and 0.0061 ms (q8) at 3.35 TB/s. The rows are random in a table
// far larger than the 50 MB L2, so they come from DRAM, and what limits the
// kernel is how many row bytes are in flight: 3.35 TB/s at ~1-1.5 us of
// loaded latency needs ~25-40 KB a SM (Little's law).
//
// Design (register-staged, chosen over a 1-D bulk copy into shared memory:
// a row lands in the registers of the lanes that reduce it, with no
// mbarrier and no shared-memory round trip):
//  1. Ids first, then every row of a warp's tile in flight. A warp owns R
//     consecutive (b, c) pairs of the flat [B*C] range; lanes 0..R-1 load
//     the R ids with one coalesced load (and each its tsq[id] or scale[id]),
//     the ids are broadcast by shuffles, and the warp issues all R row loads
//     before its first FMA. The earlier kernel did id -> row -> reduce one
//     candidate at a time, two dependent round trips each. At R = 8 a warp
//     has 4 KB of fp32 rows (or 32 code rows, 4 KB) in flight; the launch
//     bounds keep >= 16 warps a SM resident, >= 64 KB a SM.
//  2. q8 rows at full width: 8 lanes a row, 16 bytes a lane, so one warp
//     load instruction brings 4 whole 128-byte code rows (the earlier kernel
//     loaded one char4 a lane, one row a warp). Each random scales[id]
//     (and tsq[id]) read still costs a whole 32-byte DRAM sector, which puts
//     the q8 floor ~1.2x above the counted bound ((128 + 4 + 32 + 4) bytes
//     a row at d 128 against 128 + 12).
//  3. A grid sized to the card, not to B. kernels/ops.py's planner picks R
//     (1, 2, 4, 8 rows a warp; q8 4, 8, 16, 32) as the largest that still
//     gives every SM a block of kWarps warps: at the beam trip's B 64, C 32
//     (2,048 rows) that is 256 blocks of 8 rows (q8 the same), one wave on
//     132 SMs with every row in flight at once; at B 4,096 R is 8 (q8 32).
//  4. Bits. A fp32 lane accumulates its float4 pieces (lanes stride by 32)
//     with fmaf in the order x, y, z, w, then the xor butterfly 16..1 and
//     the __fmul_rn/__fsub_rn epilogue: the summation order of the earlier
//     kernel, so scores are bit-identical to it. The q8 lane sums its 16
//     codes in order, then the 8-lane butterfly 4, 2, 1 (another order than
//     the earlier kernel; exact on integer data), and keeps the
//     __fmul_rn/__fsub_rn epilogue so nvcc cannot contract it into an FMA.
//  5. Other widths. fp32 rows take float4 pieces when d % 4 == 0 and the
//     table is 16-byte aligned, else single floats (lanes stride by 32, the
//     earlier kernel's order on that path too); q8 rows take 16-byte pieces
//     when d % 16 == 0 and the codes are 16-byte aligned, else single bytes.
//     bf16 rows take 4-value (8-byte) pieces when d % 4 == 0 and the table
//     is 8-byte aligned, else single values, in the fp32 path's order.
//     Widths over one warp-piece loop over chunks of pieces in order.
// q is read through the read-only cache, reloaded only where the query of
// the next row changes (once per tile at C = 32).
// Timing: calls on one id set find their rows in L2 from the second call
// on, which the beam loop never does; chip_smoke.py and
// tools/torch_kernel_compare.py time each call on the next id set of a
// rotation whose rows exceed twice the L2.
// Valid lanes: each entry point takes a counter, a 64-bit integer or NULL.
// Given one, every block adds the number of its (b, c) pairs whose id lies in
// [0, N) with one atomicAdd (a ballot a warp, the warps summed in shared
// memory), the rows a trace prices; NULL (kernels/ops.py unless
// tracing.set_sink armed it) skips the count. No launch is added.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 2;                // warps a block, both kernels
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocksPerSM = 8;       // launch bounds: <= 128 registers a thread
constexpr int kMaxRowsPerWarp = 8;       // fp32: R = 1, 2, 4 or 8
constexpr int kQ8LanesPerRow = 8;        // q8: 4 lane groups a warp
constexpr int kQ8MaxRowsPerGroup = 8;    // q8: 1, 2, 4 or 8 rows a group
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kQ8LanesPerRow / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// fp32 pieces: VEC consecutive floats a lane
template <int VEC> struct F32Piece;
template <> struct F32Piece<4> {
  using Elem = float;
  static constexpr int kVec = 4;
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float fma(const T& v, const float* qv, float acc) {
    acc = fmaf(v.x, qv[0], acc);
    acc = fmaf(v.y, qv[1], acc);
    acc = fmaf(v.z, qv[2], acc);
    return fmaf(v.w, qv[3], acc);
  }
};
template <> struct F32Piece<1> {
  using Elem = float;
  static constexpr int kVec = 1;
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float fma(const T& v, const float* qv, float acc) {
    return fmaf(v, qv[0], acc);
  }
};

// bf16 pieces: VEC consecutive bf16 values a lane (raw 16-bit words). A
// bf16 value is the top half of an f32, so widening is a shift: exact, and
// the fmaf order is F32Piece's, element by element.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <int VEC> struct Bf16Piece;
template <> struct Bf16Piece<4> {
  using Elem = uint16_t;
  static constexpr int kVec = 4;
  using T = uint2;
  static __device__ __forceinline__ T load(const uint16_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ T zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ float fma(const T& v, const float* qv, float acc) {
    acc = fmaf(bf16_lo(v.x), qv[0], acc);
    acc = fmaf(bf16_hi(v.x), qv[1], acc);
    acc = fmaf(bf16_lo(v.y), qv[2], acc);
    return fmaf(bf16_hi(v.y), qv[3], acc);
  }
};
template <> struct Bf16Piece<1> {
  using Elem = uint16_t;
  static constexpr int kVec = 1;
  using T = unsigned;
  static __device__ __forceinline__ T load(const uint16_t* p) {
    return static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ T zero() { return 0u; }
  static __device__ __forceinline__ float fma(const T& v, const float* qv, float acc) {
    return fmaf(bf16_lo(v), qv[0], acc);
  }
};

// int8 pieces: VEC consecutive codes a lane
template <int VEC> struct Q8Piece;
template <> struct Q8Piece<16> {
  using T = int4;
  static __device__ __forceinline__ T load(const int8_t* p) {
    return __ldg(reinterpret_cast<const int4*>(p));
  }
  static __device__ __forceinline__ T zero() { return make_int4(0, 0, 0, 0); }
  static __device__ __forceinline__ float code(const T& v, int e) {
    const int w = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
    return static_cast<float>(static_cast<int>(static_cast<unsigned>(w) << (24 - 8 * (e & 3))) >> 24);
  }
};
template <> struct Q8Piece<1> {
  using T = int;
  static __device__ __forceinline__ T load(const int8_t* p) {
    return static_cast<int>(__ldg(reinterpret_cast<const signed char*>(p)));
  }
  static __device__ __forceinline__ T zero() { return 0; }
  static __device__ __forceinline__ float code(const T& v, int) { return static_cast<float>(v); }
};

__device__ __forceinline__ bool in_table(int id, int N) { return id >= 0 && id < N; }

// Adds the block's valid lanes to *valid. Every thread of the block calls
// it (valid is uniform over the launch), each with its own lane's flag.
__device__ __forceinline__ void count_valid(bool mine, unsigned long long* valid) {
  __shared__ unsigned warp_valid[kWarps];
  const unsigned n = __popc(__ballot_sync(kFull, mine));
  if ((threadIdx.x & 31) == 0) warp_valid[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_valid[w];
    if (sum) atomicAdd(valid, sum);
  }
}

// Warp w of the grid owns rows [w*R, w*R + R) of the flat [B*C] range.
// Piece is F32Piece (fp32 rows) or Bf16Piece (bf16 rows).
template <class Piece, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
gather_rows_kernel(const typename Piece::Elem* __restrict__ table,
                   const float* __restrict__ tsq, const int* __restrict__ ids,
                   const float* __restrict__ q, float* __restrict__ out, int N,
                   int d, int C, long long total, int metric,
                   unsigned long long* __restrict__ valid) {
  constexpr int VEC = Piece::kVec;
  const int lane = threadIdx.x & 31;
  const long long r0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  // 1. the tile's ids, one coalesced load; lane i < R keeps row r0 + i's
  int my_id = -1;
  if (lane < R && r0 + lane < total) my_id = __ldg(ids + r0 + lane);
  const bool my_valid = in_table(my_id, N);
  if (valid != nullptr) count_valid(my_valid, valid);
  if (r0 >= total) return;
  const float my_tsq = (metric == 0 && my_valid) ? __ldg(tsq + my_id) : 0.f;
  int id[R];
#pragma unroll
  for (int i = 0; i < R; ++i) id[i] = __shfl_sync(kFull, my_id, i);
  const int b0 = (int)(r0 / C), c0 = (int)(r0 % C);
  const int pieces = d / VEC;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  for (int p0 = 0; p0 < pieces; p0 += 32) {
    const int p = p0 + lane;
    const bool in = p < pieces;
    // 2. every row of the tile in flight before the first FMA
    typename Piece::T v[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      v[i] = (in && in_table(id[i], N)) ? Piece::load(table + (size_t)id[i] * d + (size_t)p * VEC)
                                         : Piece::zero();
    if (in) {
      int b = b0, c = c0, qb = -1;
      float qv[VEC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (in_table(id[i], N)) {                 // warp-uniform
          if (b != qb) {
            const float* qp = q + (size_t)b * d + (size_t)p * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) qv[e] = __ldg(qp + e);
            qb = b;
          }
          acc[i] = Piece::fma(v[i], qv, acc[i]);
        }
        if (++c == C) { c = 0; ++b; }
      }
    }
  }
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (in_table(id[i], N)) {                     // warp-uniform
      const float s = warp_sum(acc[i]);
      if (lane == i) mine = s;
    }
  }
  if (lane < R && r0 + lane < total) {
    out[r0 + lane] = !my_valid ? -INFINITY
                     : metric == 0 ? __fsub_rn(__fmul_rn(2.f, mine), my_tsq) : mine;
  }
}

// Lane group g (8 lanes) of warp w owns rows w*R + g*RG + [0, RG), R = 4*RG.
template <int VEC, int RG>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
gather_q8_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scales,
                 const int* __restrict__ ids, const float* __restrict__ q,
                 float* __restrict__ out, int N, int d, int C, long long total,
                 int metric, unsigned long long* __restrict__ valid) {
  using Piece = Q8Piece<VEC>;
  constexpr int R = (32 / kQ8LanesPerRow) * RG;
  const int lane = threadIdx.x & 31;
  const int g = lane / kQ8LanesPerRow, sub = lane % kQ8LanesPerRow;
  const long long r0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  int my_id = -1;
  if (lane < R && r0 + lane < total) my_id = __ldg(ids + r0 + lane);
  const bool my_valid = in_table(my_id, N);
  if (valid != nullptr) count_valid(my_valid, valid);
  if (r0 >= total) return;
  const float my_scale = my_valid ? __ldg(scales + my_id) : 0.f;
  int id[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) id[i] = __shfl_sync(kFull, my_id, g * RG + i);
  const long long rg0 = r0 + g * RG;
  const int b0 = (int)(rg0 / C), c0 = (int)(rg0 % C);
  const int pieces = (d + VEC - 1) / VEC;
  float dot[RG], sq[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) dot[i] = sq[i] = 0.f;
  for (int p0 = 0; p0 < pieces; p0 += kQ8LanesPerRow) {
    const int p = p0 + sub;
    const bool in = p < pieces;
    typename Piece::T v[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i)
      v[i] = (in && in_table(id[i], N)) ? Piece::load(codes + (size_t)id[i] * d + (size_t)p * VEC)
                                         : Piece::zero();
    if (in) {
      int b = b0, c = c0, qb = -1;
      float qv[VEC];
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        if (in_table(id[i], N)) {
          if (b != qb) {
            const float* qp = q + (size_t)b * d + (size_t)p * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) qv[e] = __ldg(qp + e);
            qb = b;
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float ce = Piece::code(v[i], e);
            dot[i] = fmaf(ce, qv[e], dot[i]);
            sq[i] = fmaf(ce, ce, sq[i]);
          }
        }
        if (++c == C) { c = 0; ++b; }
      }
    }
  }
  // row l = g'*RG + i' of the tile goes to lane l for the epilogue
  const int src = ((lane / RG) * kQ8LanesPerRow) & 31;
  float my_dot = 0.f, my_sq = 0.f;
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const float sd = group_sum(dot[i]);
    const float ss = group_sum(sq[i]);
    const float td = __shfl_sync(kFull, sd, src);
    const float ts = __shfl_sync(kFull, ss, src);
    if (lane % RG == i) { my_dot = td; my_sq = ts; }
  }
  if (lane < R && r0 + lane < total) {
    float r = -INFINITY;
    if (my_valid) {
      const float s = my_scale;
      r = metric == 0 ? __fmul_rn(s, __fsub_rn(__fmul_rn(2.f, my_dot), __fmul_rn(s, my_sq)))
                      : __fmul_rn(s, my_dot);
    }
    out[r0 + lane] = r;
  }
}

inline unsigned blocks_for(long long total, int rows_per_warp) {
  const long long per_block = (long long)rows_per_warp * kWarps;
  return (unsigned)((total + per_block - 1) / per_block);
}

template <class Piece>
int launch_rows(const typename Piece::Elem* table, const float* tsq, const int* ids,
                const float* q, float* out, int N, int d, int C, long long total,
                int metric, int rows_per_warp, cudaStream_t stream,
                unsigned long long* valid) {
  const dim3 grid(blocks_for(total, rows_per_warp));
  switch (rows_per_warp) {
    case 1: gather_rows_kernel<Piece, 1><<<grid, kThreads, 0, stream>>>(table, tsq, ids, q, out, N, d, C, total, metric, valid); break;
    case 2: gather_rows_kernel<Piece, 2><<<grid, kThreads, 0, stream>>>(table, tsq, ids, q, out, N, d, C, total, metric, valid); break;
    case 4: gather_rows_kernel<Piece, 4><<<grid, kThreads, 0, stream>>>(table, tsq, ids, q, out, N, d, C, total, metric, valid); break;
    case kMaxRowsPerWarp: gather_rows_kernel<Piece, kMaxRowsPerWarp><<<grid, kThreads, 0, stream>>>(table, tsq, ids, q, out, N, d, C, total, metric, valid); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_q8(const int8_t* codes, const float* scales, const int* ids, const float* q,
              float* out, int N, int d, int C, long long total, int metric,
              int rows_per_warp, cudaStream_t stream, unsigned long long* valid) {
  const dim3 grid(blocks_for(total, rows_per_warp));
  switch (rows_per_warp / (32 / kQ8LanesPerRow)) {
    case 1: gather_q8_kernel<VEC, 1><<<grid, kThreads, 0, stream>>>(codes, scales, ids, q, out, N, d, C, total, metric, valid); break;
    case 2: gather_q8_kernel<VEC, 2><<<grid, kThreads, 0, stream>>>(codes, scales, ids, q, out, N, d, C, total, metric, valid); break;
    case 4: gather_q8_kernel<VEC, 4><<<grid, kThreads, 0, stream>>>(codes, scales, ids, q, out, N, d, C, total, metric, valid); break;
    case kQ8MaxRowsPerGroup: gather_q8_kernel<VEC, kQ8MaxRowsPerGroup><<<grid, kThreads, 0, stream>>>(codes, scales, ids, q, out, N, d, C, total, metric, valid); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows_per_warp comes from kernels/ops.py's planner: 1, 2, 4 or 8 (fp32),
// 4, 8, 16 or 32 (q8); anything else returns cudaErrorInvalidValue.
extern "C" int gather_scores_f32(const float* table, const float* tsq,
                                 const int* ids, const float* q, float* out,
                                 int N, int d, int B, int C, int metric,
                                 int rows_per_warp, void* stream, unsigned long long* valid) {
  const long long total = (long long)B * C;
  if (rows_per_warp < 1) return (int)cudaErrorInvalidValue;
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(table) % 16 == 0);
  return vec4 ? launch_rows<F32Piece<4>>(table, tsq, ids, q, out, N, d, C, total, metric,
                                         rows_per_warp, (cudaStream_t)stream, valid)
              : launch_rows<F32Piece<1>>(table, tsq, ids, q, out, N, d, C, total, metric,
                                         rows_per_warp, (cudaStream_t)stream, valid);
}

// table holds bf16 values as raw 16-bit words. Four-element pieces need
// d % 4 == 0 and an 8-byte-aligned table, as the fp32 path's need 16 bytes:
// on the same d and alignment class both take the same piece width, and
// so the same summation order.
extern "C" int gather_scores_bf16(const uint16_t* table, const float* tsq,
                                  const int* ids, const float* q, float* out,
                                  int N, int d, int B, int C, int metric,
                                  int rows_per_warp, void* stream, unsigned long long* valid) {
  const long long total = (long long)B * C;
  if (rows_per_warp < 1) return (int)cudaErrorInvalidValue;
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(table) % 8 == 0);
  return vec4 ? launch_rows<Bf16Piece<4>>(table, tsq, ids, q, out, N, d, C, total, metric,
                                          rows_per_warp, (cudaStream_t)stream, valid)
              : launch_rows<Bf16Piece<1>>(table, tsq, ids, q, out, N, d, C, total, metric,
                                          rows_per_warp, (cudaStream_t)stream, valid);
}

extern "C" int gather_scores_q8(const int8_t* codes, const float* scales,
                                const int* ids, const float* q, float* out,
                                int N, int d, int B, int C, int metric,
                                int rows_per_warp, void* stream, unsigned long long* valid) {
  const long long total = (long long)B * C;
  if (rows_per_warp < 1 || rows_per_warp % (32 / kQ8LanesPerRow) != 0) return (int)cudaErrorInvalidValue;
  const bool vec16 = (d % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  return vec16 ? launch_q8<16>(codes, scales, ids, q, out, N, d, C, total, metric,
                               rows_per_warp, (cudaStream_t)stream, valid)
               : launch_q8<1>(codes, scales, ids, q, out, N, d, C, total, metric,
                              rows_per_warp, (cudaStream_t)stream, valid);
}
