// Flash-attention forward for Hopper.
//
// Replaces the TPU kernel `_flash_kernel`, launched by `_flash_fwd_raw`
// (gpu_docker_api_tpu/ops/attention.py): causal / windowed / full
// online-softmax attention with zero-copy GQA, and the optional per-row
// logsumexp lse = m + log(l) of the scaled scores that the backward kernels
// read. The TPU stores lse lane-replicated [B*H, S, 128]; here it is [B, H, S].
//
// What bounds it on the H100: at the training shape (S = 2048, D = 128, bf16)
// it does 4*D flops per visible score against a few bytes per row, far above
// the card's ridge (dense bf16 rate over HBM bandwidth), so it is bound by
// tensor-core throughput.
// What the design does about that: one block per (batch*head, q tile of 64
// rows in bf16, 32 in f32) keeps Q in shared memory for the whole kv walk,
// the two products per kv tile run on the tensor cores (WMMA bf16, f32
// accumulate), and the walk stops at the causal diagonal and starts at the
// window's first tile, so masked tiles cost nothing. The f32 running max /
// sum / accumulator live in shared memory.
// This is the simple form; wgmma + TMA pipelining is later work.
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int Hkv,
                     float scale, int causal, int window) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  constexpr int LDT = D + PAD;        // Q, K, V rows
  constexpr int LDP = BK + PAD;       // P rows (operand of P @ V)
  constexpr int LDS = BK + kAccPad;   // f32 scores
  constexpr int LDA = D + kAccPad;    // f32 accumulator
  constexpr int width = kThreads / BQ;  // threads per row

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* sQ = reinterpret_cast<T*>(p);      p += carve(BQ * LDT * sizeof(T));
  T* sK = reinterpret_cast<T*>(p);      p += carve(BK * LDT * sizeof(T));
  T* sV = reinterpret_cast<T*>(p);      p += carve(BK * LDT * sizeof(T));
  T* sP = reinterpret_cast<T*>(p);      p += carve(BQ * LDP * sizeof(T));
  float* sS = reinterpret_cast<float*>(p);   p += carve(BQ * LDS * 4);
  float* sAcc = reinterpret_cast<float*>(p); p += carve(BQ * LDA * 4);
  float* sM = reinterpret_cast<float*>(p);   p += carve(BQ * 4);
  float* sL = reinterpret_cast<float*>(p);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int row0 = blockIdx.y * BQ;
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const T* q_head = q + ((long long)b * S * H + h) * D;
  const T* k_head = k + ((long long)b * S * Hkv + hk) * D;
  const T* v_head = v + ((long long)b * S * Hkv + hk) * D;

  load_rows<T, D, BQ>(sQ, LDT, q_head, q_stride, row0, S);
  for (int i = threadIdx.x; i < BQ * LDA; i += kThreads) sAcc[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    sM[i] = -INFINITY;
    sL[i] = 0.0f;
  }

  const int n_kv_total = cdiv(S, BK);
  // kv tiles strictly above the diagonal contribute nothing
  const int n_kv = causal ? min(cdiv(row0 + BQ, BK), n_kv_total) : n_kv_total;
  // tiles wholly left of (first row - window) are dead
  const int kv_lo = window ? max((row0 - window + 1) / BK, 0) : 0;

  const int r = threadIdx.x / width, part = threadIdx.x % width;
  const int row = row0 + r;
  for (int j = kv_lo; j < n_kv; ++j) {
    __syncthreads();  // the previous tile's P @ V is done with sK / sV / sP
    load_rows<T, D, BK>(sK, LDT, k_head, kv_stride, j * BK, S);
    load_rows<T, D, BK>(sV, LDT, v_head, kv_stride, j * BK, S);
    __syncthreads();
    tile_mm<T, false, true, BQ, BK, D>(sS, LDS, sQ, LDT, sK, LDT, false);
    __syncthreads();

    // online softmax of row r, `width` threads per row
    float mx = -INFINITY;
    for (int c = part; c < BK; c += width) {
      const bool keep = visible(row, j * BK + c, S, causal, window);
      const float s = keep ? sS[r * LDS + c] * scale : -INFINITY;
      sS[r * LDS + c] = s;
      mx = fmaxf(mx, s);
    }
    mx = row_max<width>(mx);
    const float m_prev = sM[r];
    const float m_new = fmaxf(m_prev, mx);
    // guard the all-masked row: exp(-inf - -inf) must not turn into NaN
    const float m_safe = isfinite(m_new) ? m_new : 0.0f;
    float sum = 0.0f;
    for (int c = part; c < BK; c += width) {
      const float s = sS[r * LDS + c];
      const float pv = isfinite(s) ? expf(s - m_safe) : 0.0f;
      sP[r * LDP + c] = from_f<T>(pv);
      sum += pv;
    }
    sum = row_sum<width>(sum);
    const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
    for (int d = part; d < D; d += width) sAcc[r * LDA + d] *= alpha;
    if (part == 0) {  // every lane of the row has read sM[r] by now
      sL[r] = sL[r] * alpha + sum;
      sM[r] = m_new;
    }
    __syncthreads();
    tile_mm<T, false, false, BQ, D, BK>(sAcc, LDA, sP, LDP, sV, LDT, true);
  }
  __syncthreads();

  if (row < S) {
    const float denom = fmaxf(sL[r], 1e-30f);
    T* orow = o + ((long long)b * S * H + h) * D + row * q_stride;
    for (int d = part; d < D; d += width)
      orow[d] = from_f<T>(sAcc[r * LDA + d] / denom);
    if (lse != nullptr && part == 0) {
      const float m = sM[r];
      lse[(long long)bh * S + row] = (isfinite(m) ? m : 0.0f) + logf(denom);
    }
  }
}

template <typename T, int D>
constexpr int fwd_smem_bytes() {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  return carve(BQ * (D + PAD) * sizeof(T)) +
         2 * carve(BK * (D + PAD) * sizeof(T)) +
         carve(BQ * (BK + PAD) * sizeof(T)) + carve(BQ * (BK + kAccPad) * 4) +
         carve(BQ * (D + kAccPad) * 4) + 2 * carve(BQ * 4);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int S, int H, int Hkv, int causal, int window,
               cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<T, D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, cdiv(S, Tile<T>::BQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, Hkv, 1.0f / sqrtf((float)D), causal, window);
  return (int)cudaGetLastError();
}

}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16. lse may be null (no residual wanted).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* o, void* lse, int B, int S,
                         int H, int Hkv, int D, int causal, int window,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FLASH_DISPATCH_D(D, return flash::launch_fwd<float, D>(
                            q, k, v, o, lse, B, S, H, Hkv, causal, window, st));
  } else if (dtype == 1) {
    FLASH_DISPATCH_D(D, return flash::launch_fwd<flash::bf16, D>(
                            q, k, v, o, lse, B, S, H, Hkv, causal, window, st));
  }
  return (int)cudaErrorInvalidValue;
}
