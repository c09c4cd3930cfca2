// Grouped block-hash encode backward: each group of G consecutive samples
// of a ray, at one level, adds ONE merged cotangent row to its anchor tile.
//
//   grad[row(r, grp, l), f*lpf + lane] +=
//       round( sum_{member j} ((g_j[f] * tx_j) * ty_j) * tz_j )
//
// with (tx_j, ty_j, tz_j) member j's tent factors at its position in the
// ANCHOR tile, the member sum taken in f32 in member order, round() the
// scatter dtype's rounding (bf16 round-to-nearest-even for the flagship,
// none for f32) applied once to the sum, and the adds f32 atomics. A level
// whose G is 1 is table_scatter.cu's arithmetic.
//
// Replaces indoor_nerf_tpu/ops/pallas/table_scatter.py::
// scatter_add_table_ragged together with what fed it in
// ops/blockhash.py::_encode_grouped_fused_bwd (:847-922): the per-sample
// cotangent rows in anchor coordinates, their group sum
// (cot_s.reshape(..., G, W).sum(axis=1).astype(dt), :871-872) and the
// level-major ragged stream. The TPU kernel accumulates one level at a
// time in VMEM over a stream padded to 2048-row chunks; here every
// (ray, level, group) of every level is one launch, and nothing of the
// [M, W] cotangent reaches device memory.
//
// What bounds it on an H100: f32 atomics into the [L*R, F*lpf] table, as
// table_scatter.cu. One thread takes one (ray, level, group, feature). It
// walks the G members in order, adds each member's 8 bracketing entries
// (tent_bracket.cuh) into an f32 slab of lpf lanes in shared memory, marks
// the lanes it touched in a 128-bit mask, then rounds each touched lane
// once and issues one atomic for it. Members of a group share most of
// their brackets, so a group issues at most 8*G atomics per feature and
// usually far fewer. The slab is laid out [lane][thread], so a
// warp's accesses fall in 32 distinct banks whatever lanes its threads
// touch. Products and sums use __fmul_rn / __fadd_rn: the compiler may not
// contract a product into the following add (an FMA rounds once where the
// plain version rounds twice), so the merged sums are bitwise those of
// ops/group_scatter.py::group_scatter_plain.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() so the wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tent_bracket.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kSlabBytes = 32 * 1024;  // shared memory per block

struct LevelGroups {
  int n_levels;
  int items_per_ray;            // sum over levels of S / G[l]
  int G[kMaxLevels];            // group size per level (divides S)
  int start[kMaxLevels + 1];    // first item of each level within a ray
};

template <bool kRoundBf16>
__global__ void group_scatter_kernel(const float* __restrict__ g,
                                     const float* __restrict__ p,
                                     const int32_t* __restrict__ row,
                                     float* __restrict__ grad,
                                     int64_t n_rays, int S, int F, int lpf,
                                     int side, int64_t n_rows,
                                     LevelGroups lg) {
  extern __shared__ float slab[];  // [lpf][blockDim.x]
  // The level table in shared memory: indexing the kernel parameter at a
  // run-time index would copy it to each thread's local memory.
  __shared__ int s_G[kMaxLevels];
  __shared__ int s_start[kMaxLevels + 1];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {
      s_G[i] = lg.G[i];
      s_start[i + 1] = lg.start[i + 1];
    }
    s_start[0] = 0;
  }
  __syncthreads();

  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_rays * lg.items_per_ray * F) return;
  const int f = static_cast<int>(t % F);
  const int64_t item = t / F;
  const int64_t ray = item / lg.items_per_ray;
  const int k = static_cast<int>(item - ray * lg.items_per_ray);
  int l = 0;
  while (k >= s_start[l + 1]) ++l;
  const int G = s_G[l];
  const int L = lg.n_levels;
  // (ray, sample, level) rows are level-minor: m = (ray * S + s) * L + l.
  const int64_t m0 = (ray * S + static_cast<int64_t>(k - s_start[l]) * G) * L + l;

  const int32_t r = row[m0];
  // Out-of-range rows are dropped: the kernel never writes outside the
  // table (the encode's rows are always in range).
  if (r < 0 || r >= n_rows) return;

  float* my = slab + threadIdx.x;  // lane v of this thread at my[v * stride]
  const int stride = blockDim.x;
  uint64_t lo = 0, hi = 0;  // touched lanes 0-63 and 64-127
  for (int j = 0; j < G; ++j) {
    const int64_t m = m0 + static_cast<int64_t>(j) * L;
    const float gv = g[m * F + f];
    const tent_bracket::Bracket b =
        tent_bracket::bracket(p[3 * m], p[3 * m + 1], p[3 * m + 2], side);
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float gx = __fmul_rn(gv, b.tx[dx]);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float gxy = __fmul_rn(gx, b.ty[dy]);
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const float v = __fmul_rn(gxy, b.tz[dz]);
          const int lane = b.lane0 + dx * b.stride_x + dy * b.stride_y + dz;
          const uint64_t bit = 1ull << (lane & 63);
          const bool first = lane < 64;
          float& s = my[lane * stride];
          s = ((first ? lo : hi) & bit) ? __fadd_rn(s, v) : v;
          if (first) {
            lo |= bit;
          } else {
            hi |= bit;
          }
        }
      }
    }
  }

  float* out = grad + static_cast<int64_t>(r) * F * lpf +
               static_cast<int64_t>(f) * lpf;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint64_t mask = h ? hi : lo;
    while (mask) {
      const int lane = h * 64 + __ffsll(static_cast<long long>(mask)) - 1;
      mask &= mask - 1;
      float v = my[lane * stride];
      if (kRoundBf16) v = __bfloat162float(__float2bfloat16_rn(v));
      if (v != 0.0f) atomicAdd(out + lane, v);
    }
  }
}

template <bool kRoundBf16>
int launch(const float* g, const float* p, const int32_t* row, float* grad,
           int64_t n_rays, int S, int F, int lpf, int side, int64_t n_rows,
           const LevelGroups& lg, void* stream) {
  const int threads = kSlabBytes / (lpf * static_cast<int>(sizeof(float)));
  const int64_t n = n_rays * lg.items_per_ray * F;
  const int64_t blocks = (n + threads - 1) / threads;
  group_scatter_kernel<kRoundBf16>
      <<<static_cast<unsigned int>(blocks), threads, kSlabBytes,
         static_cast<cudaStream_t>(stream)>>>(g, p, row, grad, n_rays, S, F,
                                              lpf, side, n_rows, lg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// groups: host array [L] of per-level group sizes, each dividing S.
// lpf must be 64 or 128 (the slab holds 32 KiB / (4 * lpf) threads).
// round_bf16 != 0 rounds each merged entry to bfloat16 before the f32 add.
int group_scatter(const void* g, const void* p, const void* row, void* grad,
                  long long n_rays, int S, int L, int F, int lpf, int side,
                  long long n_rows, const int* groups, int round_bf16,
                  void* stream) {
  if (L < 1 || L > kMaxLevels || (lpf != 64 && lpf != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelGroups lg;
  lg.n_levels = L;
  lg.start[0] = 0;
  for (int l = 0; l < L; ++l) {
    if (groups[l] < 1 || S % groups[l] != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    lg.G[l] = groups[l];
    lg.start[l + 1] = lg.start[l] + S / groups[l];
  }
  for (int l = L; l < kMaxLevels; ++l) {
    lg.G[l] = 1;
    lg.start[l + 1] = lg.start[L];
  }
  lg.items_per_ray = lg.start[L];
  const float* gf = static_cast<const float*>(g);
  const float* pf = static_cast<const float*>(p);
  const int32_t* rows = static_cast<const int32_t*>(row);
  float* out = static_cast<float*>(grad);
  if (round_bf16) {
    return launch<true>(gf, pf, rows, out, n_rays, S, F, lpf, side, n_rows,
                        lg, stream);
  }
  return launch<false>(gf, pf, rows, out, n_rays, S, F, lpf, side, n_rows,
                       lg, stream);
}

const char* group_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
