// Flash-attention backward, dQ, for Hopper.
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel`, launched by `_flash_bwd_raw`
// (gpu_docker_api_tpu/ops/attention.py):
//   P  = exp(scale * Q K^T - lse)            recomputed tile by tile
//   dS = P * (dO V^T - delta),  delta = rowsum(dO * O) - dlse
//   dQ = scale * sum_j dS_j K_j
// with the forward's causal / window bounds and zero-copy GQA.
//
// What bounds it on the H100: three tile products per (q tile, kv tile)
// pair, 6*D flops per visible score. At the training shape (bf16, causal,
// B=4, S=2048, 16 q / 8 kv heads, D=128) that is 103 GFLOP against about
// 42 MB, 0.10 ms at the dense bf16 rate: tensor-core bound.
//
// bf16 (every head dim) runs the wgmma design, flash_bwd_dq_kernel_wgmma:
// - one block per (batch*head, 128-row q tile), heaviest q tiles first
//   (the causal tail is the longest walk); two consumer warpgroups own 64
//   q rows each, one producer warp issues every load;
// - the producer TMA-loads Q and dO once and walks K / V tiles of 64 kv
//   rows through a 2-stage ring guarded by full / empty mbarriers;
// - a thread's two q rows are the same for the whole walk, so lse * log2 e
//   and delta live in registers: the consumers compute delta in their
//   prologue (16-byte loads of O and dO, row_dot, the same sum the dK/dV
//   pre-pass takes) while the first tiles land;
// - S = Q K^T and dP = dO V^T are wgmmas with both operands in shared
//   memory (K-major) and f32 accumulators in registers; P = exp2(S scale
//   log2 e - lse log2 e) and dS = P (dP - delta) are formed in registers,
//   masked only on diagonal, window-edge and ragged tiles;
// - dQ += dS K takes dS from registers (packed to bf16) and K from the same
//   ring stage, read MN-major; dQ (64 x D f32 per warpgroup) stays in
//   registers for the whole walk, and the epilogue stages it in the
//   warpgroup's own rows of the Q buffer and stores it with TMA.
// f32 is the CUDA-core parity path (wgmma has no f32 mode, and TF32 would
// change the numerics): flash_bwd_dq_kernel below, one block per
// (batch*head, 32-row q tile) with Q, dO and the dQ accumulator in shared
// memory and delta computed in the block.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash {

// ---- bf16: wgmma + TMA, warp-specialised ------------------------------------

namespace hop {

constexpr int kConsumers = 2;                     // warpgroups of 64 q rows
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int BQ = 64 * kConsumers;               // q rows per block
constexpr int BK = 64;                            // kv rows per ring stage
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DqSmem {
  bf16 q[BQ * D];  // then dQ, each warpgroup in its own rows
  bf16 dout[BQ * D];
  bf16 k[kStages][BK * D];
  bf16 v[kStages][BK * D];
  float lse2[BQ];  // lse * log2 e of the block's q rows
  float delta[BQ];
  uint64_t qdo_full, full[kStages], empty[kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const __grid_constant__ CUtensorMap map_dq,
                              const bf16* __restrict__ o,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dlse, int S, int H,
                              int Hkv, float scale, int causal, int window) {
  using Ch = hopper::Chunk<D>;
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(
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
    hopper::mbar_init(&sm.qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], kConsumers * 4);  // one per warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x != kConsumers * 128) return;
    hopper::mbar_arrive_expect_tx(&sm.qdo_full, 2 * BQ * D * 2);
    for (int c = 0; c < Ch::N; ++c) {
      hopper::tma_load_4d(sm.q + c * BQ * Ch::C, &map_q, &sm.qdo_full,
                          c * Ch::C, h, m0, b);
      hopper::tma_load_4d(sm.dout + c * BQ * Ch::C, &map_do, &sm.qdo_full,
                          c * Ch::C, h, m0, b);
    }
    for (int j = kv_lo, it = 0; j < kv_hi; ++j, ++it) {
      const int st = it % kStages;
      hopper::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&sm.full[st], 2 * BK * D * 2);
      for (int c = 0; c < Ch::N; ++c) {
        hopper::tma_load_4d(sm.k[st] + c * BK * Ch::C, &map_k, &sm.full[st],
                            c * Ch::C, hk, j * BK, b);
        hopper::tma_load_4d(sm.v[st] + c * BK * Ch::C, &map_v, &sm.full[st],
                            c * Ch::C, hk, j * BK, b);
      }
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
    const uint32_t do_addr = hopper::smem_u32(sm.dout + wg * 64 * Ch::C);
    const uint32_t k_addr = hopper::smem_u32(sm.k[0]);
    const uint32_t v_addr = hopper::smem_u32(sm.v[0]);
    const float scale_log2 = scale * kLog2e;

    // prologue, while the first tiles land: lse * log2 e and delta of the
    // warpgroup's 64 rows (D / 8 lanes a row), 0 for rows at or past S so
    // that no NaN enters P there
    {
      constexpr int L = D / 8;
      const long long head = (long long)bh * S;
      for (int idx = tid; idx < 64 * L; idx += 128) {
        const int r = wg * 64 + idx / L, part = idx % L;
        const int row = m0 + r;
        const bool valid = row < S;
        const long long off = (((long long)b * S + row) * H + h) * D;
        const float acc = row_dot<D>(o + off, dout + off, part, valid);
        if (part == 0) {
          sm.delta[r] =
              valid ? acc - (dlse != nullptr ? dlse[head + row] : 0.0f) : 0.0f;
          sm.lse2[r] = valid ? lse[head + row] * kLog2e : 0.0f;
        }
      }
      hopper::named_sync(1 + wg, 128);
    }
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r - m0;
      lse2[r] = sm.lse2[i];
      dl[r] = sm.delta[i];
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

    hopper::mbar_wait(&sm.qdo_full, 0);
    for (int j = kv_lo, it = 0; j < kv_hi; ++j, ++it) {
      const int st = it % kStages;
      const uint32_t ka = k_addr + st * BK * D * 2;
      const uint32_t va = v_addr + st * BK * D * 2;
      float s[BK / 2], dp[BK / 2];
      hopper::mbar_wait(&sm.full[st], (it / kStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::Wgmma<BK>::template ss<0>(
            s, hopper::desc_k_major<D, BQ>(q_addr, ks),
            hopper::desc_k_major<D, BK>(ka, ks), ks > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::Wgmma<BK>::template ss<0>(
            dp, hopper::desc_k_major<D, BQ>(do_addr, ks),
            hopper::desc_k_major<D, BK>(va, ks), ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S is in
      hopper::fence_regs(s);

      const int c_lo = j * BK;
      const bool edge = c_lo + BK > S || (causal && c_lo + BK - 1 > r_lo) ||
                        (window && c_lo <= r_lo + 63 - window);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = hopper::exp2_approx(fmaf(s[i], scale_log2, -lse2[r]));
        if (edge && !visible(row0 + 8 * r, c_lo + 8 * (i / 4) + col_t + (i & 1),
                             S, causal, window))
          s[i] = 0.0f;
      }
      hopper::wgmma_wait<0>();  // dP is in
      hopper::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
      // dS as bf16 A fragments; the f32 tiles are dead from here
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) hopper::acc_to_a(a[ks], dp, ks);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        hopper::Wgmma<D>::template rs<1>(
            dq, a[ks], hopper::desc_mn_major<D, BK>(ka, ks), 1);
      hopper::wgmma_commit();
      // the stage's last reader, dS K, has completed before the warp
      // releases it (S and dP completed at the two waits above)
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) hopper::fence_regs(a[ks]);
      if (lane == 0) hopper::mbar_arrive(&sm.empty[st]);
    }

    // epilogue: dQ (scaled) into this warpgroup's rows of the Q buffer (its
    // last wgmma reading them has completed), then TMA
    const float dq_scale[2] = {scale, scale};
    hopper::stage_acc<D, BQ>(dq, dq_scale, q_rows);
    hopper::store_staged<D, BQ>({{&map_dq, q_rows}}, h, r_lo, b, S);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* dlse, void* dq,
           int B, int S, int H, int Hkv, int causal, int window,
           cudaStream_t stream) {
  // a runtime call first: it makes a context current, which make_map needs
  constexpr int smem = sizeof(DqSmem<D>) + 1024;  // + base alignment
  auto kernel = flash_bwd_dq_kernel_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv, mdo, mdq;
  int rc = hopper::make_map<D>(&mq, q, B, S, H, BQ);
  if (!rc) rc = hopper::make_map<D>(&mdo, dout, B, S, H, BQ);
  if (!rc) rc = hopper::make_map<D>(&mk, k, B, S, Hkv, BK);
  if (!rc) rc = hopper::make_map<D>(&mv, v, B, S, Hkv, BK);
  if (!rc) rc = hopper::make_map<D>(&mdq, dq, B, S, H, 64);
  if (rc) return rc;
  dim3 grid(B * H, cdiv(S, BQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, mdq, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dlse), S, H, Hkv, 1.0f / sqrtf((float)D),
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace hop

// ---- f32: the CUDA-core parity path ------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dlse, T* __restrict__ dq,
                        int S, int H, int Hkv, float scale, int causal,
                        int window) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  constexpr int LDT = D + PAD;
  constexpr int LDP = BK + PAD;
  constexpr int LDS = BK + kAccPad;
  constexpr int LDA = D + kAccPad;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* sQ = reinterpret_cast<T*>(p);    p += carve(BQ * LDT * sizeof(T));
  T* sdO = reinterpret_cast<T*>(p);   p += carve(BQ * LDT * sizeof(T));
  T* sK = reinterpret_cast<T*>(p);    p += carve(BK * LDT * sizeof(T));
  T* sV = reinterpret_cast<T*>(p);    p += carve(BK * LDT * sizeof(T));
  T* sdS = reinterpret_cast<T*>(p);   p += carve(BQ * LDP * sizeof(T));
  float* sS = reinterpret_cast<float*>(p);     p += carve(BQ * LDS * 4);
  float* sdP = reinterpret_cast<float*>(p);    p += carve(BQ * LDS * 4);
  float* sdQ = reinterpret_cast<float*>(p);    p += carve(BQ * LDA * 4);
  float* sLse = reinterpret_cast<float*>(p);   p += carve(BQ * 4);
  float* sDelta = reinterpret_cast<float*>(p);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int row0 = blockIdx.y * BQ;
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const long long q_off = ((long long)b * S * H + h) * D;
  const T* k_head = k + ((long long)b * S * Hkv + hk) * D;
  const T* v_head = v + ((long long)b * S * Hkv + hk) * D;
  const float* lse_head = lse + (long long)bh * S;
  const float* dlse_head = dlse ? dlse + (long long)bh * S : nullptr;

  load_rows<T, D, BQ>(sQ, LDT, q + q_off, q_stride, row0, S);
  load_rows<T, D, BQ>(sdO, LDT, dout + q_off, q_stride, row0, S);
  for (int i = threadIdx.x; i < BQ * LDA; i += kThreads) sdQ[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += kThreads)
    sLse[i] = row0 + i < S ? lse_head[row0 + i] : 0.0f;
  __syncthreads();
  row_delta<T, D, BQ>(sDelta, sdO, LDT, o + q_off, q_stride, dlse_head, row0,
                      S);

  const int n_kv_total = cdiv(S, BK);
  const int n_kv = causal ? min(cdiv(row0 + BQ, BK), n_kv_total) : n_kv_total;
  const int kv_lo = window ? max((row0 - window + 1) / BK, 0) : 0;

  for (int j = kv_lo; j < n_kv; ++j) {
    __syncthreads();  // previous dS @ K is done with sK / sdS
    load_rows<T, D, BK>(sK, LDT, k_head, kv_stride, j * BK, S);
    load_rows<T, D, BK>(sV, LDT, v_head, kv_stride, j * BK, S);
    __syncthreads();
    tile_mm<T, false, true, BQ, BK, D>(sS, LDS, sQ, LDT, sK, LDT, false);
    tile_mm<T, false, true, BQ, BK, D>(sdP, LDS, sdO, LDT, sV, LDT, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
      const int r = idx / BK, c = idx % BK;
      const bool keep = visible(row0 + r, j * BK + c, S, causal, window);
      const float pv =
          keep ? expf(sS[r * LDS + c] * scale - sLse[r]) : 0.0f;
      sdS[r * LDP + c] = from_f<T>(pv * (sdP[r * LDS + c] - sDelta[r]));
    }
    __syncthreads();
    tile_mm<T, false, false, BQ, D, BK>(sdQ, LDA, sdS, LDP, sK, LDT, true);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    if (row < S) dq[q_off + row * q_stride + d] = from_f<T>(sdQ[r * LDA + d] * scale);
  }
}

template <typename T, int D>
constexpr int dq_smem_bytes() {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  return 2 * carve(BQ * (D + PAD) * sizeof(T)) +
         2 * carve(BK * (D + PAD) * sizeof(T)) +
         carve(BQ * (BK + PAD) * sizeof(T)) +
         2 * carve(BQ * (BK + kAccPad) * 4) + carve(BQ * (D + kAccPad) * 4) +
         2 * carve(BQ * 4);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, const void* dlse, void* dq,
              int B, int S, int H, int Hkv, int causal, int window,
              cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<T, D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, cdiv(S, Tile<T>::BQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dlse), static_cast<T*>(dq), S, H, Hkv,
      1.0f / sqrtf((float)D), causal, window);
  return (int)cudaGetLastError();
}

}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16. dlse may be null (no lse cotangent).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const void* lse, const void* dlse, void* dq, int B,
                            int S, int H, int Hkv, int D, int causal,
                            int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FLASH_DISPATCH_D(D, return flash::launch_dq<float, D>(
                            q, k, v, o, dout, lse, dlse, dq, B, S, H, Hkv,
                            causal, window, st));
  } else if (dtype == 1) {
    FLASH_DISPATCH_D(D, return flash::hop::launch<D>(
                            q, k, v, o, dout, lse, dlse, dq, B, S, H, Hkv,
                            causal, window, st));
  }
  return (int)cudaErrorInvalidValue;
}
