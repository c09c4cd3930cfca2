// Occupancy-guided sampling in one launch: for each ray, the ladder of
// candidate depths, each candidate's nearest cell of the density grid, the
// candidates' weights, their CDF and the inverse-CDF samples, as
// ops/occupancy.py::occupancy_z_vals_plain computes them. For ray r with M
// candidates, S samples and a grid of G^3 cells over [bmin, bmin + ext]:
//
//   t_j   = j * f32(1 / (M - 1)), t_{M-1} = 1     (sampling.py::linspace01)
//   z_j   = near * (1 - t_j) + far * t_j, jittered within its stratum by
//           t_rand[r, j] where given               (stratified_z_vals)
//   w_j   = density[cell(o + d * z_j)]             (truncate, then clamp)
//   transmittance: tau_i = w_i * (z_{i+1} - z_i) * |d|, alpha_i = 1 -
//           exp(-tau_i), T_i = exp(-sum_{k<i} tau_k), wt_i = (1 - mix) *
//           T_i alpha_i / max(sum T alpha, 1e-10) + mix * alpha_i /
//           max(sum alpha, 1e-10) + floor / (M - 1), over the M edges z
//   density: wt_i = max(w_{i+1}, floor), over the M - 1 edges
//           0.5 * (z_{i+1} + z_i)
//   warm-up: every wt_i = 1
//   z[r, s] = the inverse CDF of (wt + 1e-5) / sum at u[r, s], or at
//           s / (S - 1) without draws                (sampling.py::sample_pdf)
//
// to the bit as the plain chain computes it on the card: float32 in the
// eager code's order, each product, sum and quotient rounded once, to
// nearest even (__fmul_rn / __fadd_rn / __fdiv_rn: nothing contracted into
// an FMA), expf and not __expf, and each sum over a ray in the order that
// torch's CUDA kernels take for a float32 [rays, n] tensor (the host picks
// the order from n and the ray count, ops/occupancy.py::torch_sum_width and
// torch_scan_chunk):
//
// - torch.sum over the last dim (aten/src/ATen/native/cuda/Reduce.cuh, n <
//   128): thread l of a row of `width` threads sums x_l, x_{l+width},
//   ... in that order (at width 64, the two halves' sums then meet in
//   shared memory), then a shuffle tree with offsets width/2 .. 1.
// - torch.cumsum over the last dim (ScanUtils.cuh, the innermost scan):
//   chunks of `chunk` entries, each a Sklansky scan after its first entry
//   took the previous chunks' total.
// - torch.linalg.norm of the direction: sqrt((x^2 + z^2) + y^2).
// - searchsorted(right=True): the same binary search (upper_bound).
//
// So the kernel's samples are the plain chain's bits on every ray, and the
// renders, losses and gradients downstream with them.
//
// Replaces no TPU kernel: the JAX package leaves the sampler to XLA, which
// fuses it. Eager PyTorch does not: a tile took ~70 launches, each
// streaming [rays, 128] (or [rays, 128, 3], int64 cell indices among them)
// through device memory, and two cumsum scans, ~26 ms of an 800x800
// request.
//
// What bounds it on an H100: the ray needs 32 B in (origin, direction,
// near, far), its draws where given (4 B a candidate and a sample) and
// 4 B a sample out; at 640,000 rays x 32 samples that is 102 MB, 0.03 ms
// at 3.35 TB/s. The grid (1 MB at 64^3) stays in L2; its lookups touch at
// most its 32,768 sectors. The work is a few hundred float32 operations a
// candidate, and the sums' shuffles, so the design keeps everything of a
// ray in registers and shared memory and never writes an intermediate to
// device memory:
//
// - One warp a ray. Lane l holds candidates l, l + 32, l + 64, l + 96 (K
//   = ceil(M / 32) of them, a template parameter: 1, 2 or 4), the layout
//   in which torch's sums and chunked scans run along a row, so both are
//   shuffles and register adds. A candidate's right neighbour (z_{j+1},
//   w_{j+1}) and an entry's left one come by one shuffle.
// - The CDF and the bin edges go to shared memory; each lane then takes
//   samples lane, lane + 32, ... and binary-searches its draw.
// - Reads of rays, draws and the grid go through the read-only cache; the
//   samples are written once, coalesced.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() so the wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRaysPerBlock = 8;  // one warp a ray
constexpr int kMaxK = 4;          // candidates a lane
constexpr int kMaxCandidates = kWarp * kMaxK;
constexpr int kMaxSamples = 256;
constexpr unsigned kFull = 0xffffffffu;

// The scalars the host sends (ops/occupancy.py::_kernel_scalars), in order.
enum Scalar {
  kBminX, kBminY, kBminZ,   // f32(bbox_min)
  kExtX, kExtY, kExtZ,      // f32(bbox_max) - f32(bbox_min), in float32
  kTStep,                   // f32(1 / (M - 1))
  kUStep,                   // f32(1 / (S - 1)), 0 where S is 1
  kFloor,                   // transmittance: f32(floor / (M - 1)); density: f32(floor)
  kMix,                     // f32(occlusion_mix)
  kKeepVis,                 // f32(1 - occlusion_mix)
  kScalars
};

// torch's orders for this launch's row lengths and ray count.
enum Order {
  kAlphaWidth,  // the sums of T alpha and of alpha (M - 1 entries)
  kPdfWidth,    // the sum of the weights (B - 1 entries)
  kTauChunk,    // the optical depth's cumsum (M - 2 entries), in slots
  kCdfChunk,    // the pdf's cumsum (B - 1 entries), in slots
  kOrders
};

struct Params {
  const float* rays_o;   // [N, 3]
  const float* rays_d;   // [N, 3]
  const float* near;     // [N]
  const float* far;      // [N]
  const float* density;  // [G^3]
  const float* t_rand;   // [N, M] or null
  const float* u;        // [N, S] or null
  float* z;              // [N, S]
  long long n_rays;
  int m, s, g;
  int warmup;
  int order[kOrders];
  float c[kScalars];
};

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }

// The candidate ladder's un-jittered depth j.
__device__ __forceinline__ float ladder(int j, const Params& p, float near,
                                        float far) {
  const float t = j == p.m - 1 ? 1.0f
                               : __fmul_rn(static_cast<float>(j), p.c[kTStep]);
  return __fadd_rn(__fmul_rn(near, __fsub_rn(1.0f, t)), __fmul_rn(far, t));
}

// Candidate j's depth: the ladder, jittered within its stratum (bounded by
// the mid-points to its neighbours, the ends by the ladder's ends).
__device__ __forceinline__ float candidate(int j, const Params& p, float near,
                                           float far, const float* t_row) {
  const float zj = ladder(j, p, near, far);
  if (t_row == nullptr) return zj;
  const float upper = j < p.m - 1
      ? __fmul_rn(0.5f, __fadd_rn(ladder(j + 1, p, near, far), zj)) : zj;
  const float lower = j > 0
      ? __fmul_rn(0.5f, __fadd_rn(zj, ladder(j - 1, p, near, far))) : zj;
  return __fadd_rn(lower, __fmul_rn(__fsub_rn(upper, lower), ldg(t_row + j)));
}

// One axis of a point's cell: (o + d z - lo) / ext * G, truncated toward
// zero (cvt.rzi, as a float-to-int32 cast), clamped to [0, G).
__device__ __forceinline__ int axis_cell(float o, float d, float z, float lo,
                                         float ext, int g) {
  const float pt = __fadd_rn(o, __fmul_rn(d, z));
  const float rel = __fdiv_rn(__fsub_rn(pt, lo), ext);
  const int i = __float2int_rz(__fmul_rn(rel, static_cast<float>(g)));
  return min(max(i, 0), g - 1);
}

// Entry j + 1 of entry j = lane + 32 k (0 past the row's slots).
template <int K>
__device__ __forceinline__ void next_entries(const float (&v)[K], float (&out)[K],
                                             int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float down = __shfl_down_sync(kFull, v[k], 1);
    const float wrap = __shfl_sync(kFull, k + 1 < K ? v[k + 1] : 0.0f, 0);
    out[k] = lane < kWarp - 1 ? down : wrap;
  }
}

// Entry j - 1 of entry j = lane + 32 k (0 for entry 0).
template <int K>
__device__ __forceinline__ void previous_entries(const float (&v)[K],
                                                 float (&out)[K], int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float up = __shfl_up_sync(kFull, v[k], 1);
    const float wrap = __shfl_sync(kFull, k > 0 ? v[k - 1] : 0.0f, kWarp - 1);
    out[k] = lane > 0 ? up : wrap;
  }
}

// torch.sum of a row held as entry lane + 32 k = v[k] (0 past its end),
// in the order of torch's reduction at `width` threads a row; every lane
// gets the result.
template <int K>
__device__ __forceinline__ float torch_sum(const float (&v)[K], int width) {
  float acc;
  int span = width;
  if (width > kWarp) {  // 64: thread l sums x_l, x_{l+64}; l and l + 32 meet
    acc = __fadd_rn(__fadd_rn(v[0], K > 2 ? v[2 % K] : 0.0f),
                    __fadd_rn(K > 1 ? v[1 % K] : 0.0f, K > 3 ? v[3 % K] : 0.0f));
    span = kWarp;
  } else if (width == kWarp) {  // thread l sums x_l, x_{l+32}, ... in order
    acc = v[0];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, v[k]);
  } else {  // a row under 32 entries: thread l sums x_l, x_{l+width}
    acc = __fadd_rn(v[0], __shfl_down_sync(kFull, v[0], width));
  }
  for (int off = span / 2; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  return __shfl_sync(kFull, acc, 0);
}

// torch.cumsum, in place, of a row held as entry lane + 32 k = v[k] (0
// past its end): chunks of `chunk_slots` slots (32 entries each; a chunk
// of at least K slots is the whole row), each a Sklansky scan after its
// first entry took the previous chunk's last.
template <int K>
__device__ __forceinline__ void torch_cumsum(float (&v)[K], int chunk_slots,
                                             int lane) {
  const int cs = min(chunk_slots, K);
  float carry = 0.0f;
  for (int q = 0; q < K; q += cs) {
    if (q > 0 && lane == 0) v[q] = __fadd_rn(v[q], carry);
#pragma unroll
    for (int m = 0; m < 5; ++m) {  // levels inside a slot's 32 entries
      const int src = ((lane >> (m + 1)) << (m + 1)) + (1 << m) - 1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < q || k >= q + cs) continue;
        const float o = __shfl_sync(kFull, v[k], src);
        if ((lane >> m) & 1) v[k] = __fadd_rn(v[k], o);
      }
    }
    for (int mm = 0; (1 << mm) < cs; ++mm) {  // levels across slots
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = k - q;
        if (r < 0 || r >= cs || !((r >> mm) & 1)) continue;
        const int src = q + ((r >> (mm + 1)) << (mm + 1)) + (1 << mm) - 1;
        float o = 0.0f;
#pragma unroll
        for (int kk = 0; kk < K; ++kk)
          if (kk == src) o = __shfl_sync(kFull, v[kk], kWarp - 1);
        v[k] = __fadd_rn(v[k], o);
      }
    }
    float last = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k == q + cs - 1) last = v[k];
    carry = __shfl_sync(kFull, last, kWarp - 1);
  }
}

template <int K, bool kTransmittance>
__global__ void __launch_bounds__(kWarp * kRaysPerBlock)
occ_sample_kernel(const Params p) {
  __shared__ float s_cdf[kRaysPerBlock][K * kWarp];
  __shared__ float s_edge[kRaysPerBlock][K * kWarp];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const long long ray = static_cast<long long>(blockIdx.x) * kRaysPerBlock + w;
  if (ray >= p.n_rays) return;  // the whole warp: ray is the warp's

  const float ox = ldg(p.rays_o + 3 * ray), oy = ldg(p.rays_o + 3 * ray + 1),
              oz = ldg(p.rays_o + 3 * ray + 2);
  const float dx = ldg(p.rays_d + 3 * ray), dy = ldg(p.rays_d + 3 * ray + 1),
              dz = ldg(p.rays_d + 3 * ray + 2);
  const float near = ldg(p.near + ray), far = ldg(p.far + ray);
  const float* t_row = p.t_rand == nullptr ? nullptr : p.t_rand + ray * p.m;
  const int g = p.g;

  // Candidates (entry lane + 32 k) and their cells' densities (0 past the
  // ladder's end).
  float z[K], w_c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + kWarp * k;
    z[k] = 0.0f;
    w_c[k] = 0.0f;
    if (j < p.m) {
      z[k] = candidate(j, p, near, far, t_row);
      const int ci = axis_cell(ox, dx, z[k], p.c[kBminX], p.c[kExtX], g);
      const int cj = axis_cell(oy, dy, z[k], p.c[kBminY], p.c[kExtY], g);
      const int ck = axis_cell(oz, dz, z[k], p.c[kBminZ], p.c[kExtZ], g);
      w_c[k] = ldg(p.density + (static_cast<long long>(ci * g + cj) * g + ck));
    }
  }
  float z_next[K];
  next_entries(z, z_next, lane);

  // Entry j is edge j of the CDF (j < B) and the interval from it to edge
  // j + 1 (j < B - 1).
  const int B = kTransmittance ? p.m : p.m - 1;
  float edge[K], wt[K];
  if (kTransmittance) {
    const float dnorm = sqrtf(__fadd_rn(
        __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)), __fmul_rn(dy, dy)));
    float tau[K], alpha[K], depth[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + kWarp * k;
      tau[k] = 0.0f;
      alpha[k] = 0.0f;
      if (j < B - 1) {
        tau[k] = __fmul_rn(__fmul_rn(w_c[k], __fsub_rn(z_next[k], z[k])), dnorm);
        alpha[k] = __fsub_rn(1.0f, expf(-tau[k]));
      }
      depth[k] = j < B - 2 ? tau[k] : 0.0f;  // the cumsum's row: tau[:-1]
    }
    torch_cumsum(depth, p.order[kTauChunk], lane);
    float before[K], vis[K];
    previous_entries(depth, before, lane);  // 0 before entry 0
#pragma unroll
    for (int k = 0; k < K; ++k) vis[k] = __fmul_rn(expf(-before[k]), alpha[k]);
    const float vis_sum = fmaxf(torch_sum(vis, p.order[kAlphaWidth]), 1e-10f);
    const float occ_sum = fmaxf(torch_sum(alpha, p.order[kAlphaWidth]), 1e-10f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + kWarp * k;
      edge[k] = z[k];
      wt[k] = 0.0f;
      if (j < B - 1) {
        wt[k] = p.warmup ? 1.0f : __fadd_rn(
            __fadd_rn(__fdiv_rn(__fmul_rn(p.c[kKeepVis], vis[k]), vis_sum),
                      __fdiv_rn(__fmul_rn(p.c[kMix], alpha[k]), occ_sum)),
            p.c[kFloor]);
      }
    }
  } else {
    float w_next[K];
    next_entries(w_c, w_next, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + kWarp * k;
      edge[k] = __fmul_rn(0.5f, __fadd_rn(z_next[k], z[k]));
      wt[k] = 0.0f;
      if (j < B - 1) wt[k] = p.warmup ? 1.0f : fmaxf(w_next[k], p.c[kFloor]);
    }
  }

  // sample_pdf: the pdf of wt + 1e-5, its cumsum, and the CDF at each edge
  // (0 at edge 0).
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + kWarp * k;
    wt[k] = j < B - 1 ? __fadd_rn(wt[k], 1e-5f) : 0.0f;
  }
  const float total = torch_sum(wt, p.order[kPdfWidth]);
  float pdf[K], cdf[K];
#pragma unroll
  for (int k = 0; k < K; ++k) pdf[k] = __fdiv_rn(wt[k], total);
  torch_cumsum(pdf, p.order[kCdfChunk], lane);
  previous_entries(pdf, cdf, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + kWarp * k;
    if (j < B) {
      s_cdf[w][j] = cdf[k];
      s_edge[w][j] = edge[k];
    }
  }
  __syncwarp();

  const float* cdf_s = s_cdf[w];
  const float* edge_s = s_edge[w];
  const float* u_row = p.u == nullptr ? nullptr : p.u + ray * p.s;
  float* z_row = p.z + ray * p.s;
  for (int s = lane; s < p.s; s += kWarp) {
    const float u = u_row != nullptr ? ldg(u_row + s)
        : (s == p.s - 1 && p.s > 1 ? 1.0f
                                   : __fmul_rn(static_cast<float>(s), p.c[kUStep]));
    int lo = 0, hi = B;  // upper_bound: the count of CDF entries <= u
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(cdf_s[mid] > u)) lo = mid + 1; else hi = mid;
    }
    const int below = max(lo - 1, 0), above = min(lo, B - 1);
    const float c_b = cdf_s[below], c_a = cdf_s[above];
    const float e_b = edge_s[below], e_a = edge_s[above];
    float denom = __fsub_rn(c_a, c_b);
    if (denom < 1e-5f) denom = 1.0f;
    const float t = __fdiv_rn(__fsub_rn(u, c_b), denom);
    z_row[s] = __fadd_rn(e_b, __fmul_rn(t, __fsub_rn(e_a, e_b)));
  }
}

template <int K, bool kTransmittance>
int launch(const Params& p, cudaStream_t stream) {
  const long long blocks = (p.n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  occ_sample_kernel<K, kTransmittance>
      <<<static_cast<unsigned>(blocks), kWarp * kRaysPerBlock, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTransmittance>
int launch_for_candidates(const Params& p, cudaStream_t stream) {
  const int k = (p.m + kWarp - 1) / kWarp;
  if (k <= 1) return launch<1, kTransmittance>(p, stream);
  if (k <= 2) return launch<2, kTransmittance>(p, stream);
  return launch<4, kTransmittance>(p, stream);
}

bool valid_width(int w) {
  return w >= 1 && w <= 2 * kWarp && (w & (w - 1)) == 0;
}

}  // namespace

extern "C" {

// The largest n_candidates and n_samples the kernel takes.
int occ_sample_max_candidates() { return kMaxCandidates; }

int occ_sample_max_samples() { return kMaxSamples; }

// z [n_rays, n_samples] of rays_o, rays_d [n_rays, 3], near, far [n_rays],
// the grid's density [resolution^3], t_rand [n_rays, n_candidates] and
// u [n_rays, n_samples] (read only where has_t_rand, has_u), each array
// float32; the host's float scalars (Scalar's order) and torch's orders
// (Order's order: two sum widths in threads, two scan chunks in slots of
// 32 entries).
int occ_sample(const void* rays_o, const void* rays_d, const void* near,
               const void* far, const void* density, const void* t_rand,
               const void* u, void* z, long long n_rays, int n_candidates,
               int n_samples, int resolution, int transmittance, int warmup,
               int has_t_rand, int has_u, const void* scalars,
               const int* orders, void* stream) {
  const int min_candidates = transmittance ? 2 : 3;
  if (n_rays < 1 || n_candidates < min_candidates ||
      n_candidates > kMaxCandidates || n_samples < 1 ||
      n_samples > kMaxSamples || resolution < 1 ||
      n_rays > 0x7fffffffLL * kRaysPerBlock ||
      !valid_width(orders[kAlphaWidth]) || !valid_width(orders[kPdfWidth]) ||
      orders[kTauChunk] < 1 || orders[kCdfChunk] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.rays_o = static_cast<const float*>(rays_o);
  p.rays_d = static_cast<const float*>(rays_d);
  p.near = static_cast<const float*>(near);
  p.far = static_cast<const float*>(far);
  p.density = static_cast<const float*>(density);
  p.t_rand = has_t_rand ? static_cast<const float*>(t_rand) : nullptr;
  p.u = has_u ? static_cast<const float*>(u) : nullptr;
  p.z = static_cast<float*>(z);
  p.n_rays = n_rays;
  p.m = n_candidates;
  p.s = n_samples;
  p.g = resolution;
  p.warmup = warmup;
  for (int i = 0; i < kOrders; ++i) p.order[i] = orders[i];
  const auto* c = static_cast<const float*>(scalars);
  for (int i = 0; i < kScalars; ++i) p.c[i] = c[i];
  const auto s = static_cast<cudaStream_t>(stream);
  return transmittance ? launch_for_candidates<true>(p, s)
                       : launch_for_candidates<false>(p, s);
}

const char* occ_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
