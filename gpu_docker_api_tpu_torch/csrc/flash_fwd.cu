// Flash-attention forward for Hopper.
//
// Replaces the TPU kernel `_flash_kernel`, launched by `_flash_fwd_raw`
// (gpu_docker_api_tpu/ops/attention.py): causal / windowed / full
// online-softmax attention with zero-copy GQA, and the optional per-row
// logsumexp lse = m + log(l) of the scaled scores (natural log) that the
// backward kernels read. The TPU stores lse lane-replicated [B*H, S, 128];
// here it is [B, H, S].
//
// What bounds it on the H100: 4*D flops per visible score against a few
// bytes per row. At the training shape (bf16, causal, B=4, S=2048, 16 q
// heads, D=128) that is 68.7 GFLOP against 42 MB, about 0.07 ms at the
// dense bf16 rate and 0.013 ms at the HBM rate: tensor-core bound.
//
// bf16 (every head dim) runs the wgmma design, flash_fwd_kernel_wgmma:
// - one block per (batch*head, 128-row q tile), heaviest q tiles first
//   (the causal tail is the longest walk); two consumer warpgroups own 64
//   q rows each, one producer warp issues every load;
// - the producer TMA-loads Q once and walks K / V tiles of 128 kv rows
//   through a 2-stage ring guarded by full / empty mbarriers, so the next
//   tile lands while the current one is multiplied;
// - S = Q K^T is a wgmma with both operands in shared memory and its f32
//   accumulator in registers; the online softmax runs in registers (the
//   row max and sum reduced over the 4 lanes that share a row, exp2 of
//   scores pre-scaled by scale*log2 e), masking only the diagonal, the
//   window's edge and the ragged last tile;
// - O += P V takes P from registers (packed to bf16) and V from shared
//   memory read MN-major; O stays in registers for the whole walk and the
//   rescale by alpha is a register multiply;
// - the epilogue stages O in the warpgroup's own rows of the Q buffer and
//   stores it with TMA; rows at or past S are never written.
// f32 is the CUDA-core parity path (wgmma has no f32 mode, and TF32 would
// change the numerics): flash_fwd_kernel below, one block per (batch*head,
// 32-row q tile) with the running max / sum / accumulator in shared memory.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash {

// ---- bf16: wgmma + TMA, warp-specialised ------------------------------------

namespace hop {

constexpr int kConsumers = 2;                    // warpgroups of 64 q rows
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int BQ = 64 * kConsumers;               // q rows per block
constexpr int BK = 128;                           // kv rows per ring stage
constexpr int kStages = 2;
constexpr float kLn2 = 0.69314718055994531f;

template <int D>
struct FwdSmem {
  bf16 q[BQ * D];  // then O, each warpgroup in its own rows
  bf16 k[kStages][BK * D];
  bf16 v[kStages][BK * D];
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_o,
                           float* __restrict__ lse, int S, int H, int Hkv,
                           float scale_log2, int causal, int window) {
  using Ch = hopper::Chunk<D>;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int n_kv_total = cdiv(S, BK);
  // kv tiles strictly above the diagonal, or wholly left of the window of
  // the block's first row, contribute nothing
  const int kv_hi = causal ? min(cdiv(m0 + BQ, BK), n_kv_total) : n_kv_total;
  const int kv_lo = window ? max((m0 - window + 1) / BK, 0) : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.k_full[s], 1);
      hopper::mbar_init(&sm.v_full[s], 1);
      hopper::mbar_init(&sm.empty[s], kConsumers * 4);  // one per warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x != kConsumers * 128) return;
    hopper::mbar_arrive_expect_tx(&sm.q_full, BQ * D * 2);
    for (int c = 0; c < Ch::N; ++c)
      hopper::tma_load_4d(sm.q + c * BQ * Ch::C, &map_q, &sm.q_full,
                          c * Ch::C, h, m0, b);
    for (int j = kv_lo, it = 0; j < kv_hi; ++j, ++it) {
      const int st = it % kStages;
      hopper::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&sm.k_full[st], BK * D * 2);
      for (int c = 0; c < Ch::N; ++c)
        hopper::tma_load_4d(sm.k[st] + c * BK * Ch::C, &map_k, &sm.k_full[st],
                            c * Ch::C, hk, j * BK, b);
      hopper::mbar_arrive_expect_tx(&sm.v_full[st], BK * D * 2);
      for (int c = 0; c < Ch::N; ++c)
        hopper::tma_load_4d(sm.v[st] + c * BK * Ch::C, &map_v, &sm.v_full[st],
                            c * Ch::C, hk, j * BK, b);
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows [r_lo, r_lo + 64) ----
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r_lo = m0 + wg * 64;
    const int row0 = r_lo + warp * 16 + lane / 4;  // and row0 + 8
    const int col_t = 2 * (lane % 4);
    bf16* q_rows = sm.q + wg * 64 * Ch::C;
    const uint32_t q_addr = hopper::smem_u32(q_rows);
    const uint32_t k_addr = hopper::smem_u32(sm.k[0]);
    const uint32_t v_addr = hopper::smem_u32(sm.v[0]);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
    float l[2] = {0.0f, 0.0f};            // this lane's share of the sum

    hopper::mbar_wait(&sm.q_full, 0);
    for (int j = kv_lo, it = 0; j < kv_hi; ++j, ++it) {
      const int st = it % kStages;
      const uint32_t par = (it / kStages) & 1;
      const uint32_t ka = k_addr + st * BK * D * 2;
      const uint32_t va = v_addr + st * BK * D * 2;
      float s[BK / 2];
      hopper::mbar_wait(&sm.k_full[st], par);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::Wgmma<BK>::template ss<0>(
            s, hopper::desc_k_major<D, BQ>(q_addr, ks),
            hopper::desc_k_major<D, BK>(ka, ks), ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      const int c_lo = j * BK;
      const bool edge = c_lo + BK > S || (causal && c_lo + BK - 1 > r_lo) ||
                        (window && c_lo <= r_lo + 63 - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int row = row0 + 8 * ((i >> 1) & 1);
          const int col = c_lo + 8 * (i / 4) + col_t + (i & 1);
          if (!visible(row, col, S, causal, window)) s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = row_max<4>(mx[r]);
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        // guard the all-masked row: exp(-inf - -inf) must not turn into NaN
        const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
        alpha[r] = hopper::exp2_approx(m[r] - m_safe);
        neg_m[r] = -m_safe;
        m[r] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = hopper::exp2_approx(fmaf(s[i], scale_log2, neg_m[r]));
        sum[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      uint32_t a[BK / 16][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) hopper::acc_to_a(a[ks], s, ks);
      hopper::mbar_wait(&sm.v_full[st], par);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        hopper::Wgmma<D>::template rs<1>(
            o, a[ks], hopper::desc_mn_major<D, BK>(va, ks), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) hopper::fence_regs(a[ks]);
      if (lane == 0) hopper::mbar_arrive(&sm.empty[st]);
    }

    // epilogue: O / l into this warpgroup's rows of the Q buffer, then TMA
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = row_sum<4>(l[r]);
      inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
    }
    hopper::stage_acc<D, BQ>(o, inv, q_rows);
    hopper::store_staged<D, BQ>({{&map_o, q_rows}}, h, r_lo, b, S);
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const float mr = m[r] == -INFINITY ? 0.0f : m[r];
        if (row < S)
          lse[(long long)bh * S + row] =
              mr * kLn2 + logf(fmaxf(l[r], 1e-30f));
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int Hkv, int causal, int window,
           cudaStream_t stream) {
  // a runtime call first: it makes a context current, which make_map needs
  constexpr int smem = sizeof(FwdSmem<D>) + 1024;  // + base alignment
  auto kernel = flash_fwd_kernel_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv, mo;
  int rc = hopper::make_map<D>(&mq, q, B, S, H, BQ);
  if (!rc) rc = hopper::make_map<D>(&mk, k, B, S, Hkv, BK);
  if (!rc) rc = hopper::make_map<D>(&mv, v, B, S, Hkv, BK);
  if (!rc) rc = hopper::make_map<D>(&mo, o, B, S, H, 64);
  if (rc) return rc;
  const float log2e = 1.4426950408889634f;
  dim3 grid(B * H, cdiv(S, BQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mo, static_cast<float*>(lse), S, H, Hkv,
      log2e / sqrtf((float)D), causal, window);
  return (int)cudaGetLastError();
}

}  // namespace hop

// ---- f32: the CUDA-core parity path ------------------------------------------

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
    FLASH_DISPATCH_D(D, return flash::hop::launch<D>(
                            q, k, v, o, lse, B, S, H, Hkv, causal, window, st));
  }
  return (int)cudaErrorInvalidValue;
}
