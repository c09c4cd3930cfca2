// One RAdam step over every leaf of a training step, in one launch.
//
// For each element of each leaf, in float32, in the order of the eager
// loop of train/optim.py::radam_update_plain (each product, sum, quotient
// and root rounded once, to nearest even, nothing contracted into an FMA):
//
//   nu = nu * beta2 + (g * g) * (1 - beta2)
//   mu = mu * beta1 + g * (1 - beta1)
//   if adaptive:                      (N_sma >= 5: from step 6 at beta2 0.99)
//     if weight decay != 0:  p = p - p * (wd * lr)
//     p = p - (mu * (lr * rect)) / (sqrt(nu) + eps)
//
// so the result is bit for bit the eager loop's on the same card. A null
// g counts as zero (a leaf without a gradient), as the eager loop's
// zeros_like does. While the step is not adaptive p is neither read nor
// written.
//
// Replaces no TPU kernel: the JAX package leaves the update to XLA, which
// fuses it. Eager PyTorch does not: at the flagship the [65536, 256] f32
// table alone took 12 elementwise launches a step, each reading and
// writing 64 MiB, and each small MLP leaf 14 more.
//
// What bounds it on an H100: bytes. Reading p, g, mu, nu once and writing
// p, mu, nu once is 28 B an element (20 B before the rectified steps).
// The design keeps that traffic and enough of it in flight:
//
// - Every leaf goes into one launch, multi-tensor style. The leaf table
//   (pointers, sizes, the float32 scalars, the flags) is a kernel
//   parameter passed by value: no host-to-device copy, no synchronize.
//   Block b takes chunk b - chunk_start[i] of the leaf i whose chunks
//   hold it; a step with more leaves than one Params holds takes more
//   launches (the host's plan).
// - A chunk is kChunk elements: each thread moves kVecPerThread float4s
//   of each of the four arrays, all loads issued before the first store,
//   so 256 B a thread are in flight.
// - A leaf whose four arrays share their offset modulo 16 B (every
//   allocation of PyTorch's caching allocator does) moves float4s after
//   a scalar head of `head` elements, taken by chunk 0; the tail of the
//   last chunk is scalar. A leaf that does not (a view at an odd offset)
//   takes the scalar path throughout, over the same chunks.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() so the wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr int kChunk = kThreads * 4 * kVecPerThread;  // elements a block takes
constexpr int kMaxLeaves = 32;
constexpr int kScalars = 7;

// Leaf flags (train/optim.py sets the same bits).
constexpr int kAdaptive = 1;
constexpr int kDecay = 2;
constexpr int kVector = 4;

struct Leaf {
  float* p;
  const float* g;  // nullptr: no gradient, counted as zero
  float* mu;
  float* nu;
  long long n;
  int head;  // chunk 0's scalar elements before the first 16 B boundary
  int flags;
  float beta1, omb1, beta2, omb2, eps, wd_lr, lr_rect;
};

struct Params {
  Leaf leaf[kMaxLeaves];
  int chunk_start[kMaxLeaves + 1];  // leaf i holds blocks [start[i], start[i+1])
  int n_leaves;
};

__device__ __forceinline__ void radam(float& p, float g, float& mu, float& nu,
                                      const Leaf& L, bool adaptive,
                                      bool decay) {
  nu = __fadd_rn(__fmul_rn(nu, L.beta2), __fmul_rn(__fmul_rn(g, g), L.omb2));
  mu = __fadd_rn(__fmul_rn(mu, L.beta1), __fmul_rn(g, L.omb1));
  if (adaptive) {
    if (decay) p = __fsub_rn(p, __fmul_rn(p, L.wd_lr));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(mu, L.lr_rect),
                               __fadd_rn(__fsqrt_rn(nu), L.eps)));
  }
}

template <bool kAdapt>
__device__ __forceinline__ void scalar_range(const Leaf& L, bool decay,
                                             long long begin, long long end) {
  for (long long e = begin + threadIdx.x; e < end; e += kThreads) {
    const float g = L.g ? L.g[e] : 0.0f;
    float mu = L.mu[e], nu = L.nu[e];
    float p = kAdapt ? L.p[e] : 0.0f;
    radam(p, g, mu, nu, L, kAdapt, decay);
    L.mu[e] = mu;
    L.nu[e] = nu;
    if (kAdapt) L.p[e] = p;
  }
}

__device__ __forceinline__ void radam4(float4& p, const float4& g, float4& mu,
                                       float4& nu, const Leaf& L,
                                       bool adaptive, bool decay) {
  radam(p.x, g.x, mu.x, nu.x, L, adaptive, decay);
  radam(p.y, g.y, mu.y, nu.y, L, adaptive, decay);
  radam(p.z, g.z, mu.z, nu.z, L, adaptive, decay);
  radam(p.w, g.w, mu.w, nu.w, L, adaptive, decay);
}

// The float4s [begin, begin + 4 * nvec) of one chunk, nvec <= kChunk / 4.
template <bool kAdapt>
__device__ __forceinline__ void vector_range(const Leaf& L, bool decay,
                                             long long begin, int nvec) {
  float4 p[kVecPerThread], g[kVecPerThread], mu[kVecPerThread],
      nu[kVecPerThread];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int u = 0; u < kVecPerThread; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j < nvec) {
      const long long e = begin + 4LL * j;
      mu[u] = *reinterpret_cast<const float4*>(L.mu + e);
      nu[u] = *reinterpret_cast<const float4*>(L.nu + e);
      g[u] = L.g ? __ldg(reinterpret_cast<const float4*>(L.g + e)) : zero;
      p[u] = kAdapt ? *reinterpret_cast<const float4*>(L.p + e) : zero;
    }
  }
#pragma unroll
  for (int u = 0; u < kVecPerThread; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j < nvec) {
      const long long e = begin + 4LL * j;
      radam4(p[u], g[u], mu[u], nu[u], L, kAdapt, decay);
      *reinterpret_cast<float4*>(L.mu + e) = mu[u];
      *reinterpret_cast<float4*>(L.nu + e) = nu[u];
      if (kAdapt) *reinterpret_cast<float4*>(L.p + e) = p[u];
    }
  }
}

// Chunk c of leaf L: the elements [head + c*kChunk, head + (c+1)*kChunk)
// that lie below n, and chunk 0 also [0, min(head, n)).
template <bool kAdapt>
__device__ __forceinline__ void chunk(const Leaf& L, long long c) {
  const bool decay = L.flags & kDecay;
  const long long begin = L.head + c * kChunk;
  const long long end = min(begin + kChunk, L.n);
  if (c == 0) scalar_range<kAdapt>(L, decay, 0, min(static_cast<long long>(L.head), L.n));
  if (begin >= end) return;
  if (L.flags & kVector) {
    const int nvec = static_cast<int>((end - begin) / 4);
    vector_range<kAdapt>(L, decay, begin, nvec);
    scalar_range<kAdapt>(L, decay, begin + 4LL * nvec, end);
  } else {
    scalar_range<kAdapt>(L, decay, begin, end);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_radam_kernel(const __grid_constant__ Params P) {
  const int b = static_cast<int>(blockIdx.x);
  int i = 0;
  while (i + 1 < P.n_leaves && P.chunk_start[i + 1] <= b) ++i;
  const Leaf& L = P.leaf[i];
  const long long c = b - P.chunk_start[i];
  if (L.flags & kAdaptive) {
    chunk<true>(L, c);
  } else {
    chunk<false>(L, c);
  }
}

}  // namespace

extern "C" {

int fused_radam_chunk() { return kChunk; }
int fused_radam_max_leaves() { return kMaxLeaves; }

// k leaves (1 <= k <= kMaxLeaves) in one launch of chunk_start[k] blocks:
// ptrs [k, 4] (p, g or 0, mu, nu), numel [k], head [k], flags [k],
// scalars [k, 7] (beta1, 1 - beta1, beta2, 1 - beta2, eps, wd * lr,
// lr * rect), chunk_start [k + 1] from 0. Host arrays, read here: the
// kernel gets them by value.
int fused_radam(const void* ptrs, const void* numel, const void* head,
                const void* flags, const void* scalars,
                const void* chunk_start, int k, void* stream) {
  if (k < 1 || k > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  const long long* ptr = static_cast<const long long*>(ptrs);
  const long long* n = static_cast<const long long*>(numel);
  const int* hd = static_cast<const int*>(head);
  const int* fl = static_cast<const int*>(flags);
  const float* s = static_cast<const float*>(scalars);
  const int* cs = static_cast<const int*>(chunk_start);
  Params P = {};
  for (int i = 0; i < k; ++i) {
    Leaf& L = P.leaf[i];
    L.p = reinterpret_cast<float*>(ptr[4 * i]);
    L.g = reinterpret_cast<const float*>(ptr[4 * i + 1]);
    L.mu = reinterpret_cast<float*>(ptr[4 * i + 2]);
    L.nu = reinterpret_cast<float*>(ptr[4 * i + 3]);
    L.n = n[i];
    L.head = hd[i];
    L.flags = fl[i];
    const float* si = s + kScalars * i;
    L.beta1 = si[0], L.omb1 = si[1], L.beta2 = si[2], L.omb2 = si[3];
    L.eps = si[4], L.wd_lr = si[5], L.lr_rect = si[6];
  }
  for (int i = 0; i <= k; ++i) P.chunk_start[i] = cs[i];
  P.n_leaves = k;
  if (cs[0] != 0 || cs[k] < 1) return static_cast<int>(cudaErrorInvalidValue);
  fused_radam_kernel<<<static_cast<unsigned int>(cs[k]), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_radam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
