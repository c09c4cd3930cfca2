// Block-hash encode forward: fused row gather + tent-product contraction.
//
//   out[m, f] = sum_lane table[flat_row[m], f*lpf + lane] * w(m, lane)
//   w(m, lane) = tent(lx - px) * tent(ly - py) * tent(lz - pz),
//   tent(t) = max(0, 1 - |t|), lane -> (lx, ly, lz) = (l / side^2,
//   (l / side) % side, l % side).
//
// Replaces indoor_nerf_tpu/ops/pallas/tent_contract.py::tent_contract
// together with the XLA row gather that feeds it
// (indoor_nerf_tpu/ops/blockhash.py:397-400): the gather is fused here, so
// no [M, F*lpf] rows array ever reaches device memory.
//
// Only the 8 vertices bracketing p have nonzero tent weight, so each
// thread reads those 8 lanes of its feature and nothing else
// (tent_bracket.cuh: the weights are bitwise the full-lane ones, and every
// other lane's weight is exactly 0), so the result equals the full-lane
// tent sum up to summation order. Accumulation is f32; the table may be
// f32 or bf16 (bf16 widens to f32 exactly by a 16-bit shift).
//
// What bounds it on an H100: gather transactions. Each (point, level)
// touches 8 scattered 2-byte values per feature inside one 512-byte table
// row; the arithmetic is ~40 flops per (m, f). The flagship bf16 table is
// [65536, 256] = 33.5 MB, which fits in the 50 MB L2, so the random row
// reads are served from L2 rather than HBM. This first version is one
// thread per (m, f): threads of a warp cover 8 consecutive points, so the
// p and flat_row loads coalesce and the F threads of a point share one
// table row. Speed (one warp per row segment, vector loads) comes later.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() so the wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tent_bracket.cuh"

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const uint16_t* p) {
  // bfloat16 is the top half of a float32.
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

template <typename T>
__global__ void tent_contract_kernel(const T* __restrict__ table,
                                     const int32_t* __restrict__ flat_row,
                                     const float* __restrict__ p,
                                     float* __restrict__ out, int64_t M,
                                     int F, int lpf, int side,
                                     int64_t n_rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= M * F) return;
  const int64_t m = t / F;
  const int f = static_cast<int>(t - m * F);

  const int32_t row = flat_row[m];
  if (row < 0 || row >= n_rows) {
    // Out-of-range row: never read outside the table; make it visible.
    out[t] = __int_as_float(0x7fc00000);
    return;
  }
  const tent_bracket::Bracket b =
      tent_bracket::bracket(p[3 * m], p[3 * m + 1], p[3 * m + 2], side);

  const T* r = table + static_cast<int64_t>(row) * F * lpf +
               static_cast<int64_t>(f) * lpf + b.lane0;
  float acc = 0.0f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wxy = b.tx[dx] * b.ty[dy];
      const T* ry = r + dx * b.stride_x + dy * b.stride_y;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        acc += load_f32(ry + dz) * (wxy * b.tz[dz]);
      }
    }
  }
  out[t] = acc;
}

template <typename T>
int launch(const T* table, const int32_t* flat_row, const float* p,
           float* out, int64_t M, int F, int lpf, int side, int64_t n_rows,
           void* stream) {
  const int threads = 256;
  const int64_t total = M * F;
  const int64_t blocks = (total + threads - 1) / threads;
  tent_contract_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      table, flat_row, p, out, M, F, lpf, side, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tent_contract_f32(const void* table, const void* flat_row, const void* p,
                      void* out, long long M, int F, int lpf, int side,
                      long long n_rows, void* stream) {
  return launch(static_cast<const float*>(table),
                static_cast<const int32_t*>(flat_row),
                static_cast<const float*>(p), static_cast<float*>(out), M, F,
                lpf, side, n_rows, stream);
}

int tent_contract_bf16(const void* table, const void* flat_row, const void* p,
                       void* out, long long M, int F, int lpf, int side,
                       long long n_rows, void* stream) {
  return launch(static_cast<const uint16_t*>(table),
                static_cast<const int32_t*>(flat_row),
                static_cast<const float*>(p), static_cast<float*>(out), M, F,
                lpf, side, n_rows, stream);
}

const char* tent_contract_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
