// The train step's optimizer for Hopper: the gradient norm's sum of
// squares (sum_squares, then sum_partials) and the AdamW update (adamw),
// behind train.global_norm and train.AdamW.update.
//
// Replaces no Pallas kernel: the JAX package leaves the optimizer to optax
// under XLA, which fuses each leaf's chain into one loop. Eager PyTorch runs
// the same chain as about 17 elementwise passes a leaf, each through device
// memory; these kernels are that fusion, written by hand.
//
// What bounds them on the H100: bytes. The update reads g, p, mu and nu
// once and writes p, mu and nu once, 14 bytes a bf16 parameter (28 in f32),
// for about 20 flops: under 2 flops a byte, far below the card's ridge of
// about 295. The sum of squares reads each gradient once, 2 bytes a bf16
// parameter. So each byte crosses device memory once:
// - a thread takes 16 bytes of each operand (8 bf16 or 4 f32 values) with
//   one vector load, computes in f32 in registers and stores each result
//   with one vector store; nothing lands in device memory in between;
// - the clip reads the global norm on the device (one f32 that every thread
//   reads through the cache), so no host sync decides it; lr and the bias
//   corrections are kernel arguments, so nothing is copied to the device
//   for a leaf either;
// - the arithmetic is optax's chain in f32, each operation rounded as the
//   plain PyTorch version (ops/optim.py) rounds it: __fmul_rn and its
//   kin keep the compiler from fusing a multiply into an add;
// - the sum of squares: at most `blocks` blocks stride over a tensor, each
//   thread sums its squares in f32, each block reduces its threads in a
//   fixed tree into one partial, and sum_partials adds every tensor's
//   partials in a fixed order (in f64) into one f32. No atomics: the same
//   gradients give the same norm on every run.
// A tensor whose operands are not all 16-byte aligned, and a ragged tail,
// take the scalar path inside the same threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace optim {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T through registers: one streaming load, one streaming store
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  alignas(16) T e[N];
  __device__ __forceinline__ void load(const T* src) {
    *reinterpret_cast<uint4*>(e) = __ldcs(reinterpret_cast<const uint4*>(src));
  }
  __device__ __forceinline__ void store(T* dst) const {
    __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(e));
  }
};

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

// ---- sum of squares -----------------------------------------------------

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sum_squares_kernel(const T* __restrict__ x, long long n,
                       float* __restrict__ partials) {
  constexpr int N = Vec<T>::N;
  const bool vec = aligned16(x, x, x, x);
  const long long nvec = (n + N - 1) / N;
  const long long stride = (long long)gridDim.x * kThreads;
  float acc = 0.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += stride) {
    const long long base = i * N;
    if (vec && base + N <= n) {
      Vec<T> v;
      v.load(x + base);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_f32(v.e[j]);
        s = fmaf(f, f, s);
      }
      acc += s;
    } else {
      for (long long j = base; j < n && j < base + N; ++j) {
        const float f = to_f32(x[j]);
        acc = fmaf(f, f, acc);
      }
    }
  }
  __shared__ float warps[kThreads / 32];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < kThreads / 32 ? warps[threadIdx.x] : 0.f;
    acc = warp_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const float* __restrict__ partials, int n,
                        float* __restrict__ out) {
  __shared__ double s[kThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = (float)s[0];
}

// ---- AdamW ----------------------------------------------------------------

struct Hyper {
  float clip, lr, b1, omb1, b2, omb2, bc1, bc2, eps, wd;
};

// optax.chain(clip_by_global_norm, adamw) on one element, in f32:
// g <- (g / norm) * clip when the norm is not under the clip;
// m = b1 mu + (1 - b1) g; v = b2 nu + (1 - b2) g^2;
// p <- p - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p)
__device__ __forceinline__ void adamw_one(float g, float& p, float& m,
                                          float& v, bool clip_on, float norm,
                                          const Hyper& h) {
  if (clip_on) g = __fmul_rn(__fdiv_rn(g, norm), h.clip);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fadd_rn(p, -__fmul_rn(h.lr, u));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(T* __restrict__ p, const T* __restrict__ g,
                 T* __restrict__ mu, T* __restrict__ nu, long long n,
                 const float* __restrict__ norm, Hyper h) {
  constexpr int N = Vec<T>::N;
  const long long base =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * N;
  if (base >= n) return;
  const float nrm = __ldg(norm);
  const bool clip_on = !(nrm < h.clip);
  if (aligned16(p, g, mu, nu) && base + N <= n) {
    Vec<T> pv, gv, mv, vv;
    gv.load(g + base);
    pv.load(p + base);
    mv.load(mu + base);
    vv.load(nu + base);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float pf = to_f32(pv.e[j]), mf = to_f32(mv.e[j]), vf = to_f32(vv.e[j]);
      adamw_one(to_f32(gv.e[j]), pf, mf, vf, clip_on, nrm, h);
      pv.e[j] = from_f32<T>(pf);
      mv.e[j] = from_f32<T>(mf);
      vv.e[j] = from_f32<T>(vf);
    }
    pv.store(p + base);
    mv.store(mu + base);
    vv.store(nu + base);
  } else {
    for (long long j = base; j < n && j < base + N; ++j) {
      float pf = to_f32(p[j]), mf = to_f32(mu[j]), vf = to_f32(nu[j]);
      adamw_one(to_f32(g[j]), pf, mf, vf, clip_on, nrm, h);
      p[j] = from_f32<T>(pf);
      mu[j] = from_f32<T>(mf);
      nu[j] = from_f32<T>(vf);
    }
  }
}

template <typename T>
int launch_sum_squares(const void* x, long long n, void* partials, int blocks,
                       cudaStream_t st) {
  sum_squares_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), n, static_cast<float*>(partials));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_adamw(void* p, const void* g, void* mu, void* nu, long long n,
                 const void* norm, const Hyper& h, cudaStream_t st) {
  const long long vecs = (n + Vec<T>::N - 1) / Vec<T>::N;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  adamw_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<T*>(mu),
      static_cast<T*>(nu), n, static_cast<const float*>(norm), h);
  return (int)cudaGetLastError();
}

}  // namespace optim

// One tensor's sum of squares into partials[0, blocks): dtype 0 f32, 1 bf16.
extern "C" int sum_squares(int dtype, const void* x, long long n,
                           void* partials, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return optim::launch_sum_squares<float>(x, n, partials, blocks, st);
  if (dtype == 1)
    return optim::launch_sum_squares<__nv_bfloat16>(x, n, partials, blocks, st);
  return (int)cudaErrorInvalidValue;
}

// The sum of n f32 partials into out[0] (dtype 0: the partials are f32).
extern "C" int sum_partials(int dtype, const void* partials, int n, void* out,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 || n < 0) return (int)cudaErrorInvalidValue;
  optim::sum_partials_kernel<<<1, optim::kThreads, 0, st>>>(
      static_cast<const float*>(partials), n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// One leaf's update in place: p, mu, nu of n elements in the dtype's type,
// g the same, norm one f32 on the device. omb1 / omb2 are 1 - b1 / 1 - b2
// as the host computes them.
extern "C" int adamw(int dtype, void* p, const void* g, void* mu, void* nu,
                     long long n, const void* norm, float clip, float lr,
                     float b1, float omb1, float b2, float omb2, float bc1,
                     float bc2, float eps, float wd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const optim::Hyper h{clip, lr, b1, omb1, b2, omb2, bc1, bc2, eps, wd};
  if (dtype == 0) return optim::launch_adamw<float>(p, g, mu, nu, n, norm, h, st);
  if (dtype == 1)
    return optim::launch_adamw<__nv_bfloat16>(p, g, mu, nu, n, norm, h, st);
  return (int)cudaErrorInvalidValue;
}
