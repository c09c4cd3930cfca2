// Block-hash encode backward: cotangent formation fused into the table
// scatter-add.
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
// Per (point, level) row m and feature f, only the 8 lanes bracketing p
// have a nonzero tent weight (tent_bracket.cuh: the same weights, bitwise,
// as the full-lane formula). Each product is formed in the JAX order
// ((g * tx) * ty) * tz, rounded to the scatter dtype, and atomically added
// in f32. Lanes of zero weight add exactly 0 in the JAX sum, so they are
// skipped. Only the order in which the atomics land differs from the
// reference, which sums the same rounded entries in f32.
//
// What bounds it on an H100: f32 atomics. The flagship step issues
// 1,048,576 rows x 4 features x 8 = 33.5M atomic adds into a
// [65536, 256] f32 table (64 MiB, most of which the 50 MB L2 holds); the
// reads (g, p, flat_row: 32 B per row) are ~34 MB. Coarse levels hold few
// distinct rows, so many atomics land on one address and serialize in L2.
// This first version is one thread per (m, f), as the forward: a warp
// covers 8 consecutive (point, level) rows, so the loads coalesce, and the
// adds are fire-and-forget reductions (the result is unused). Fewer
// atomics (vector atomics, a sort by row, warp pre-reduction) come later.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() so the wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tent_bracket.cuh"

namespace {

template <bool kRoundBf16>
__global__ void table_scatter_kernel(const float* __restrict__ g,
                                     const float* __restrict__ p,
                                     const int32_t* __restrict__ flat_row,
                                     float* __restrict__ grad, int64_t M,
                                     int F, int lpf, int side,
                                     int64_t n_rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= M * F) return;
  const int64_t m = t / F;
  const int f = static_cast<int>(t - m * F);

  const int32_t row = flat_row[m];
  // Out-of-range rows are dropped: the kernel never writes outside the
  // table (the encode's rows are always in range).
  if (row < 0 || row >= n_rows) return;
  const float gv = g[t];  // g is [M, F] contiguous
  const tent_bracket::Bracket b =
      tent_bracket::bracket(p[3 * m], p[3 * m + 1], p[3 * m + 2], side);

  float* r = grad + static_cast<int64_t>(row) * F * lpf +
             static_cast<int64_t>(f) * lpf + b.lane0;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const float gx = gv * b.tx[dx];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float gxy = gx * b.ty[dy];
      float* ry = r + dx * b.stride_x + dy * b.stride_y;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        float v = gxy * b.tz[dz];
        if (kRoundBf16) v = __bfloat162float(__float2bfloat16_rn(v));
        if (v != 0.0f) atomicAdd(ry + dz, v);
      }
    }
  }
}

template <bool kRoundBf16>
int launch(const float* g, const float* p, const int32_t* flat_row,
           float* grad, int64_t M, int F, int lpf, int side, int64_t n_rows,
           void* stream) {
  const int threads = 256;
  const int64_t blocks = (M * F + threads - 1) / threads;
  table_scatter_kernel<kRoundBf16>
      <<<static_cast<unsigned int>(blocks), threads, 0,
         static_cast<cudaStream_t>(stream)>>>(g, p, flat_row, grad, M, F,
                                              lpf, side, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// round_bf16 != 0 rounds each entry to bfloat16 before the f32 add.
int table_scatter(const void* g, const void* p, const void* flat_row,
                  void* grad, long long M, int F, int lpf, int side,
                  long long n_rows, int round_bf16, void* stream) {
  const float* gf = static_cast<const float*>(g);
  const float* pf = static_cast<const float*>(p);
  const int32_t* rows = static_cast<const int32_t*>(flat_row);
  float* out = static_cast<float*>(grad);
  if (round_bf16) {
    return launch<true>(gf, pf, rows, out, M, F, lpf, side, n_rows, stream);
  }
  return launch<false>(gf, pf, rows, out, M, F, lpf, side, n_rows, stream);
}

const char* table_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
