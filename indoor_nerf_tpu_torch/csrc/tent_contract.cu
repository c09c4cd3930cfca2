// Block-hash encode forward: fused row gather + tent-product contraction,
// and the pack pass that lays the table out for it.
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
// Only the 8 vertices bracketing p have nonzero tent weight, so a thread
// reads those 8 lanes and nothing else (tent_bracket.cuh: the weights are
// bitwise the full-lane ones, and every other lane's weight is exactly 0),
// so the result equals the full-lane tent sum up to summation order.
// Accumulation is f32; the table may be f32 or bf16 (bf16 widens to f32
// exactly by a 16-bit shift).
//
// What bounds it on an H100: L2 sector requests of the gather, not device
// memory (the flagship bf16 table is 33.5 MB and lives in the 50 MB L2) and
// not arithmetic (~160 flops per (point, level)). The design cuts the
// requests:
//
// - The table is read in a vertex-major packed layout [rows, lpf, F]
//   (element lane*F + f; tent_pack_rows below makes it from the master's
//   feature-plane layout [rows, F, lpf], casting in the same pass). The F
//   features of a vertex are adjacent, so a thread reads one vector per
//   vertex (8 B of bf16 at the flagship): 8 loads per (point, level)
//   instead of 8 F, and ~4 sectors instead of ~10 (the z pair is
//   contiguous, the y pair side*F elements on).
// - One thread per (point, level) row computes all F features, in memory
//   order: a warp reads 32 consecutive flat_row and p and writes 32
//   consecutive out rows (whole lines, a float4 per thread at F 4).
//
// Measured on the card and dropped: a block tile of consecutive points x
// all levels staged through shared memory and walked level-major (a warp =
// 32 samples of a ray at one level) took the same time as this memory
// order on random rows and on a serving render's rows (PERF.md): the
// block's working set in L1 is the same either way.
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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
tent_contract_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ flat_row,
                     const float* __restrict__ p, float* __restrict__ out,
                     int64_t M, int F, int lpf, int side, int64_t n_rows) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  float* o = out + m * F;
  const int32_t row = flat_row[m];
  if (row < 0 || row >= n_rows) {
    // Out-of-range row: never read outside the table; make it visible.
    for (int f = 0; f < F; ++f) o[f] = __int_as_float(0x7fc00000);
    return;
  }
  const tent_bracket::Bracket b =
      tent_bracket::bracket(p[3 * m], p[3 * m + 1], p[3 * m + 2], side);
  float w[8];
  int lane[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    w[k] = (b.tx[dx] * b.ty[dy]) * b.tz[dz];
    lane[k] = b.lane0 + dx * b.stride_x + dy * b.stride_y + dz;
  }
  const T* r = table + static_cast<int64_t>(row) * lpf * F;
  for (int f0 = 0; f0 < F; f0 += VEC) {
    float v[8][VEC];
#pragma unroll
    for (int k = 0; k < 8; ++k) load_vec<VEC>(r + lane[k] * F + f0, v[k]);
    float acc[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      acc[c] = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[c] += v[k][c] * w[k];
    }
    store_vec<VEC>(o + f0, acc);
  }
}

template <typename T, int VEC>
int launch_vec(const T* table, const int32_t* flat_row, const float* p,
               float* out, int64_t M, int F, int lpf, int side, int64_t n_rows,
               cudaStream_t stream) {
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  tent_contract_kernel<T, VEC>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          table, flat_row, p, out, M, F, lpf, side, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* table, const void* flat_row, const void* p, void* out,
           int64_t M, int F, int lpf, int side, int64_t n_rows, void* stream) {
  const T* t = static_cast<const T*>(table);
  const int32_t* rows = static_cast<const int32_t*>(flat_row);
  const float* pf = static_cast<const float*>(p);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F % 4 == 0)
    return launch_vec<T, 4>(t, rows, pf, o, M, F, lpf, side, n_rows, st);
  if (F % 2 == 0)
    return launch_vec<T, 2>(t, rows, pf, o, M, F, lpf, side, n_rows, st);
  return launch_vec<T, 1>(t, rows, pf, o, M, F, lpf, side, n_rows, st);
}

// packed[row, lane, f] = cast(master[row, f, lane]): one thread per
// (row, lane) reads F values a plane apart (consecutive threads read
// consecutive lanes of a plane) and writes them as adjacent vectors.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(const float* __restrict__ master, T* __restrict__ packed,
                 int64_t total, int F, int lpf) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / lpf;
  const int lane = static_cast<int>(t - row * lpf);
  const float* src = master + row * F * lpf + lane;
  T* dst = packed + t * F;
  for (int f0 = 0; f0 < F; f0 += VEC) {
    float v[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) v[c] = __ldg(src + (f0 + c) * lpf);
    store_vec<VEC>(dst + f0, v);
  }
}

template <typename T>
int launch_pack(const void* master, void* packed, int64_t n_rows, int F,
                int lpf, void* stream) {
  const float* src = static_cast<const float*>(master);
  T* dst = static_cast<T*>(packed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total = n_rows * lpf;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  if (F % 4 == 0) {
    pack_rows_kernel<T, 4><<<blocks, kThreads, 0, st>>>(src, dst, total, F, lpf);
  } else if (F % 2 == 0) {
    pack_rows_kernel<T, 2><<<blocks, kThreads, 0, st>>>(src, dst, total, F, lpf);
  } else {
    pack_rows_kernel<T, 1><<<blocks, kThreads, 0, st>>>(src, dst, total, F, lpf);
  }
  return static_cast<int>(cudaGetLastError());
}

// The int8 gather's pack pass (--block_io int8): packed[row, lane, f] =
// rint(master[row, f, lane] / s) * s in f32, s = scale[row / rows_per_level],
// the level's absmax / 127 (the wrapper computes it). It replaces the
// quantize-gather-dequantize of indoor_nerf_tpu/ops/blockhash.py:344-354:
// the rows are the same values in every gather, so they are dequantized
// once per table, in the same pass that packs it. rintf rounds half to
// even, as jnp.round; the division and product are the IEEE ones (_rn),
// so the table equals the plain form's bit for bit. Bound by its bytes:
// one f32 read and one f32 write per element.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
pack_rows_int8_kernel(const float* __restrict__ master,
                      const float* __restrict__ scale,
                      float* __restrict__ packed, int64_t total, int F,
                      int lpf, int64_t rows_per_level) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / lpf;
  const int lane = static_cast<int>(t - row * lpf);
  const float s = __ldg(scale + row / rows_per_level);
  const float* src = master + row * F * lpf + lane;
  float* dst = packed + t * F;
  for (int f0 = 0; f0 < F; f0 += VEC) {
    float v[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      v[c] = __fmul_rn(rintf(__fdiv_rn(__ldg(src + (f0 + c) * lpf), s)), s);
    store_vec<VEC>(dst + f0, v);
  }
}

int launch_pack_int8(const void* master, const void* scale, void* packed,
                     int64_t n_rows, int F, int lpf, int64_t rows_per_level,
                     void* stream) {
  const float* src = static_cast<const float*>(master);
  const float* sc = static_cast<const float*>(scale);
  float* dst = static_cast<float*>(packed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total = n_rows * lpf;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  if (F % 4 == 0) {
    pack_rows_int8_kernel<4><<<blocks, kThreads, 0, st>>>(
        src, sc, dst, total, F, lpf, rows_per_level);
  } else if (F % 2 == 0) {
    pack_rows_int8_kernel<2><<<blocks, kThreads, 0, st>>>(
        src, sc, dst, total, F, lpf, rows_per_level);
  } else {
    pack_rows_int8_kernel<1><<<blocks, kThreads, 0, st>>>(
        src, sc, dst, total, F, lpf, rows_per_level);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table: packed [n_rows, lpf, F], 16-byte aligned.
int tent_contract_f32(const void* table, const void* flat_row, const void* p,
                      void* out, long long M, int F, int lpf, int side,
                      long long n_rows, void* stream) {
  return launch<float>(table, flat_row, p, out, M, F, lpf, side, n_rows,
                       stream);
}

int tent_contract_bf16(const void* table, const void* flat_row, const void* p,
                       void* out, long long M, int F, int lpf, int side,
                       long long n_rows, void* stream) {
  return launch<uint16_t>(table, flat_row, p, out, M, F, lpf, side, n_rows,
                          stream);
}

// master: f32 [n_rows, F, lpf] -> packed [n_rows, lpf, F], f32 or bf16.
int tent_pack_rows_f32(const void* master, void* packed, long long n_rows,
                       int F, int lpf, void* stream) {
  return launch_pack<float>(master, packed, n_rows, F, lpf, stream);
}

int tent_pack_rows_bf16(const void* master, void* packed, long long n_rows,
                        int F, int lpf, void* stream) {
  return launch_pack<uint16_t>(master, packed, n_rows, F, lpf, stream);
}

// master: f32 [n_rows, F, lpf], scale: f32 [n_rows / rows_per_level] ->
// packed f32 [n_rows, lpf, F], each element int8-rounded on its level's
// scale and dequantized.
int tent_pack_rows_int8(const void* master, const void* scale, void* packed,
                        long long n_rows, int F, int lpf,
                        long long rows_per_level, void* stream) {
  return launch_pack_int8(master, scale, packed, n_rows, F, lpf,
                          rows_per_level, stream);
}

const char* tent_contract_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
