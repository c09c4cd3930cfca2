// Block-hash encode backward: cotangent formation fused into the table
// scatter-add, and the un-pack pass that returns the gradient in the
// master's layout.
//
//   grad[flat_row[m], f*lpf + lane] += round(g[m, f] * w(m, lane))
//   w(m, lane) = tent(lx - px) * tent(ly - py) * tent(lz - pz)
//
// with round() the scatter dtype's rounding (bf16 round-to-nearest-even
// for the flagship, none for f32) and the sum taken in f32.
//
// Replaces indoor_nerf_tpu/ops/pallas/table_scatter.py::scatter_add_table
// (the VMEM-resident accumulation kernel) together with the cotangent rows
// that fed it (ops/blockhash.py::_cot_rows, cast to scatter_dtype in
// _encode_fused_bwd): no [M, F*lpf] cotangent array ever reaches device
// memory (at the flagship that array is 1M x 256 x 2 B = 512 MiB of bf16).
//
// Per (point, level) row m, only the 8 lanes bracketing p have a nonzero
// tent weight (tent_bracket.cuh: the same weights, bitwise, as the
// full-lane formula). Each product is formed in the JAX order
// ((g * tx) * ty) * tz and rounded to the scatter dtype ONCE, before any
// sum; every sum after that is f32. Lanes of zero weight add exactly 0 in
// the JAX sum, so they are skipped. Only the order of the f32 sum differs
// from the reference, which sums the same rounded entries in f32.
//
// What bounds it on an H100: atomic reductions at L2, not bytes (the reads
// are 32 B per row). The design makes fewer, wider ones:
//
// - The sums go into a vertex-major packed f32 buffer [rows, lpf, F]
//   (element lane*F + f), where the F features of a vertex are adjacent:
//   one vector reduction per vertex (red.global.add.v4.f32 at F 4, .v2 at
//   F 2: Hopper's atomicAdd on float4 / float2) instead of F scalar ones
//   that no sector shares (packed_row.cuh::reduce_vec, shared with
//   group_scatter.cu). table_scatter_unpack then transposes the buffer
//   into the master's feature-plane layout [rows, F, lpf].
// - One thread per (point, level) row forms all F features' entries, in
//   memory order: a warp reads 32 consecutive g rows (a float4 per thread
//   at F 4), p and flat_row. A vertex whose F entries are all 0 (a zero
//   weight, a zero cotangent row) adds nothing.
//
// Measured on the card and dropped (PERF.md): a block tile of consecutive
// points x all levels staged through shared memory and walked level-major
// took the same time as this memory order; and summing, by a segmented
// warp shuffle, the runs of a ray's samples that stay in one cell of one
// row before the reduction took 6% of the reductions off a real step's
// stream and made the kernel slower.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() so the wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_row.cuh"
#include "tent_bracket.cuh"

namespace {

using namespace packed_row;

template <bool kRoundBf16, int VEC>
__global__ void __launch_bounds__(kThreads)
table_scatter_kernel(const float* __restrict__ g, const float* __restrict__ p,
                     const int32_t* __restrict__ flat_row,
                     float* __restrict__ packed, int64_t M, int F, int lpf,
                     int side, int64_t n_rows) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  const int32_t row = flat_row[m];
  // Out-of-range rows are dropped: the kernel never writes outside the
  // table (the encode's rows are always in range).
  if (row < 0 || row >= n_rows) return;
  const tent_bracket::Bracket b =
      tent_bracket::bracket(p[3 * m], p[3 * m + 1], p[3 * m + 2], side);
  float* dst = packed + (static_cast<int64_t>(row) * lpf + b.lane0) * F;
  for (int f0 = 0; f0 < F; f0 += VEC) {
    float gv[VEC];
    load_vec<VEC>(g + m * F + f0, gv);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      float v[VEC];
      bool any = false;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        float e = ((gv[c] * b.tx[dx]) * b.ty[dy]) * b.tz[dz];
        if (kRoundBf16) e = __bfloat162float(__float2bfloat16_rn(e));
        v[c] = e;
        any = any || e != 0.0f;
      }
      if (any) {
        reduce_vec<VEC>(
            dst + (dx * b.stride_x + dy * b.stride_y + dz) * F + f0, v);
      }
    }
  }
}

template <bool kRoundBf16, int VEC>
int launch_vec(const float* g, const float* p, const int32_t* flat_row,
               float* packed, int64_t M, int F, int lpf, int side,
               int64_t n_rows, cudaStream_t stream) {
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  table_scatter_kernel<kRoundBf16, VEC>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          g, p, flat_row, packed, M, F, lpf, side, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRoundBf16>
int launch(const float* g, const float* p, const int32_t* flat_row,
           float* packed, int64_t M, int F, int lpf, int side, int64_t n_rows,
           cudaStream_t st) {
  if (F % 4 == 0)
    return launch_vec<kRoundBf16, 4>(g, p, flat_row, packed, M, F, lpf, side,
                                     n_rows, st);
  if (F % 2 == 0)
    return launch_vec<kRoundBf16, 2>(g, p, flat_row, packed, M, F, lpf, side,
                                     n_rows, st);
  return launch_vec<kRoundBf16, 1>(g, p, flat_row, packed, M, F, lpf, side,
                                   n_rows, st);
}

// grad[row, f, lane] = packed[row, lane, f]: one thread per (row, lane)
// reads its F adjacent sums as vectors and writes each a plane apart
// (consecutive threads write consecutive lanes of a plane).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
unpack_rows_kernel(const float* __restrict__ packed, float* __restrict__ grad,
                   int64_t total, int F, int lpf) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / lpf;
  const int lane = static_cast<int>(t - row * lpf);
  const float* src = packed + t * F;
  float* dst = grad + row * F * lpf + lane;
  for (int f0 = 0; f0 < F; f0 += VEC) {
    float v[VEC];
    load_vec<VEC>(src + f0, v);
#pragma unroll
    for (int c = 0; c < VEC; ++c) dst[(f0 + c) * lpf] = v[c];
  }
}

}  // namespace

extern "C" {

// packed: zeroed f32 [n_rows, lpf, F]; g and packed 16-byte aligned;
// round_bf16 != 0 rounds each entry to bfloat16 before the f32 sums.
int table_scatter(const void* g, const void* p, const void* flat_row,
                  void* packed, long long M, int F, int lpf, int side,
                  long long n_rows, int round_bf16, void* stream) {
  const float* gf = static_cast<const float*>(g);
  const float* pf = static_cast<const float*>(p);
  const int32_t* rows = static_cast<const int32_t*>(flat_row);
  float* out = static_cast<float*>(packed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (round_bf16) {
    return launch<true>(gf, pf, rows, out, M, F, lpf, side, n_rows, st);
  }
  return launch<false>(gf, pf, rows, out, M, F, lpf, side, n_rows, st);
}

// packed f32 [n_rows, lpf, F] -> grad f32 [n_rows, F, lpf].
int table_scatter_unpack(const void* packed, void* grad, long long n_rows,
                         int F, int lpf, void* stream) {
  const float* src = static_cast<const float*>(packed);
  float* dst = static_cast<float*>(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total = n_rows * lpf;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  if (F % 4 == 0) {
    unpack_rows_kernel<4><<<blocks, kThreads, 0, st>>>(src, dst, total, F, lpf);
  } else if (F % 2 == 0) {
    unpack_rows_kernel<2><<<blocks, kThreads, 0, st>>>(src, dst, total, F, lpf);
  } else {
    unpack_rows_kernel<1><<<blocks, kThreads, 0, st>>>(src, dst, total, F, lpf);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* table_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
