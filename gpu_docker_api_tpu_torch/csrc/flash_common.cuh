// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): tile shapes per element type, the
// global->shared row loader, the shared-memory tile product and the mask.
//
// Layouts are the JAX package's public ones, read in place (no transposes):
//   q, o, do   [B, S, H, D]      row (b, s, h) at ((b*S + s)*H + h)*D
//   k, v       [B, S, Hkv, D]    q head h reads kv head h / (H / Hkv)
//   lse, dlse  [B, H, S] f32
// Every kernel masks a ragged tail (S % tile != 0) itself: rows and columns
// at or past S load as zeros, score as -inf and are never written.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;

// Tile shapes. bf16 feeds the tensor cores through WMMA (16x16x16, f32
// accumulate), so its shared rows are padded by 8 elements (16 bytes: keeps
// WMMA's 32-byte fragment alignment and staggers banks). f32 runs on the CUDA
// cores; one float of padding makes the column walks conflict-free, and the
// smaller tiles keep the dK/dV kernel's five f32 tiles under 227 KB.
template <typename T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int BQ = 64, BK = 64, PAD = 8;
  static constexpr bool kTensorCores = true;
};
template <>
struct Tile<float> {
  static constexpr int BQ = 32, BK = 32, PAD = 1;
  static constexpr bool kTensorCores = false;
};
constexpr int kAccPad = 4;  // f32 scratch rows: WMMA wants ldm % 4 == 0

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Bytes of a carved shared buffer, rounded up to 128 so that every buffer
// starts 128-byte aligned.
__host__ __device__ constexpr int carve(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// Rows [row0, row0 + R) of one head of a [B, S, heads, D] tensor into shared
// memory (row stride ld elements). `g` points at row 0 of the head; rows are
// `row_stride` elements apart. Rows at or past S are zero-filled.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* g,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kChunks = D / kVec;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * kVec;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) {
      val = *reinterpret_cast<const uint4*>(g + row * row_stride + c);
    }
    if constexpr (sizeof(T) == 2) {
      // (D + 8) * 2 bytes per row: 16-byte aligned stores
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    } else {
      // the odd f32 row stride forbids vector stores
      const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[r * ld + c + e] = f[e];
    }
  }
}

// C[M x N] (+)= A[M x K] * B[K x N], all in shared memory; C is f32.
// A_T: A is stored transposed (A(m, k) at A[k * lda + m]), else row-major.
// B_T: B is stored transposed (B(k, n) at B[n * ldb + k]), else row-major.
// bf16 runs on the tensor cores (WMMA, one 16x16 output tile per warp at a
// time, f32 accumulate); f32 is a plain CUDA-core dot product per element.
// The caller synchronises before (operands written) and after (C read).
template <typename T, bool A_T, bool B_T, int M, int N, int K>
__device__ __forceinline__ void tile_mm(float* C, int ldc, const T* A, int lda,
                                        const T* B, int ldb, bool accumulate) {
  if constexpr (Tile<T>::kTensorCores) {
    using namespace nvcuda;
    using ALayout =
        typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
    using BLayout =
        typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
    constexpr int TM = M / 16, TN = N / 16;
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < TM * TN; t += kWarps) {
      const int tm = t / TN, tn = t % TN;
      float* cp = C + tm * 16 * ldc + tn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (accumulate) {
        wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc, 0.0f);
      }
#pragma unroll 4
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> b;
        const T* ap = A_T ? A + k0 * lda + tm * 16 : A + tm * 16 * lda + k0;
        const T* bp = B_T ? B + tn * 16 * ldb + k0 : B + k0 * ldb + tn * 16;
        wmma::load_matrix_sync(a, ap, lda);
        wmma::load_matrix_sync(b, bp, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int m = idx / N, n = idx % N;
      float s = accumulate ? C[m * ldc + n] : 0.0f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float a = to_f(A_T ? A[k * lda + m] : A[m * lda + k]);
        const float b = to_f(B_T ? B[n * ldb + k] : B[k * ldb + n]);
        s = fmaf(a, b, s);
      }
      C[m * ldc + n] = s;
    }
  }
}

// Which (row, col) scores survive: in range, causal (col <= row) and inside a
// sliding window (col > row - window) when those are on.
__device__ __forceinline__ bool visible(int row, int col, int S, int causal,
                                        int window) {
  return row < S && col < S && (!causal || col <= row) &&
         (!window || col > row - window);
}

// Sum over the `width` consecutive lanes that share one row.
template <int width>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
template <int width>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// delta_r = sum_d dO[r, d] * O[r, d] (minus dlse_r when given), for the R rows
// of one tile: dO from shared memory, O straight from global memory. Rows past
// S get 0. `width` threads share a row.
template <typename T, int D, int R>
__device__ __forceinline__ void row_delta(float* delta, const T* sdO, int ld,
                                          const T* o_head, long long row_stride,
                                          const float* dlse_head, int row0,
                                          int S) {
  constexpr int width = kThreads / R;
  const int r = threadIdx.x / width, part = threadIdx.x % width;
  const int row = row0 + r;
  float acc = 0.0f;
  if (row < S) {
    const T* orow = o_head + row * row_stride;
    for (int d = part; d < D; d += width)
      acc = fmaf(to_f(sdO[r * ld + d]), to_f(orow[d]), acc);
  }
  acc = row_sum<width>(acc);
  if (part == 0) {
    if (row < S && dlse_head != nullptr) acc -= dlse_head[row];
    delta[r] = acc;
  }
}

}  // namespace flash

// One dispatch over the supported head dims; anything else is refused.
#define FLASH_DISPATCH_D(D_VAL, ...)                 \
  switch (D_VAL) {                                   \
    case 16: { constexpr int D = 16; __VA_ARGS__; break; }   \
    case 32: { constexpr int D = 32; __VA_ARGS__; break; }   \
    case 64: { constexpr int D = 64; __VA_ARGS__; break; }   \
    case 128: { constexpr int D = 128; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;      \
  }
