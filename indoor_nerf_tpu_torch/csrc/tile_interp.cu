// Tent-product interpolation over gathered 5^3 tiles, and its d rows.
//
//   forward:   out[m, f]   = sum_{lane < 128} rows[m, f*128 + lane] * w(m, lane)
//   backward:  drows[m, f*128 + lane] = g[m, f] * w(m, lane)
//   w(m, lane) = tent(lx - px) * tent(ly - py) * tent(lz - pz),
//   tent(t) = max(0, 1 - |t|), lane -> (lx, ly, lz) = (lane / 25,
//   (lane / 5) % 5, lane % 5); rows [M, 256] f32 (two 128-lane feature
//   planes), p [M, 3] f32, g and out [M, 2] f32.
//
// Replaces indoor_nerf_tpu/ops/pallas/tile_interp.py::_tile_interp_fwd_tpu
// (body _fwd_kernel) and ::_tile_interp_bwd_rows_tpu (body
// _bwd_rows_kernel), the two Pallas kernels behind the custom VJP
// tile_interp. As there, the rows are ALREADY gathered: the row gather and
// its transpose (the scatter-add of drows into the table) stay outside
// these kernels, under autograd. That is what tells this route from
// tent_contract.cu / table_scatter.cu, which fuse the gather and the
// scatter and never hold an [M, 256] array.
//
// What bounds both on an H100: bytes. A row is 1 KiB and the arithmetic is
// ~10 flops per lane, so the forward reads 1,024 + 12 B and writes 8 B per
// row, and the backward reads 20 B and writes 1,024 B per row (2.19 GB
// each at the training step's M = 2,097,152, far past the 50 MB L2). The
// design streams: one warp per row, each thread reads or writes one 16-byte
// float4 per feature plane, so a warp moves a plane's 512 B as one
// coalesced transaction run; p and g are 12 and 8 bytes that the whole
// warp reads from one address (one broadcast load). The forward reads ALL
// 128 lanes of both planes rather than the 8 bracketing ones: the rows are
// contiguous and dense in memory, a 32-byte sector holds 8 lanes, so the
// bracket would still touch 4 to 8 sectors per plane at scattered offsets,
// and the full stream is the simple form with the TPU kernel's own
// summation (every lane times its weight). Each thread forms the weights of
// its 4 lanes from the lane index (tent_bracket::tent, the formula shared
// with the other kernels), accumulates both features in f32, and a shuffle
// reduction sums the warp; lane 0 writes the two outputs as one float2.
//
// The backward's products use __fmul_rn in the plain version's order,
// g * ((tx * ty) * tz), so no FMA contraction can change a bit: drows
// equals the plain version bit for bit. Lanes 125..127 decode to lx = 5,
// whose tent weight is 0 for every p in [0, 4], so they are written as
// zeros by the same formula.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() so the wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tent_bracket.cuh"

namespace {

constexpr int kSide = 5;
constexpr int kLanes = 128;
constexpr int kWarpsPerBlock = 8;

// Tent-product weights of the 4 tile lanes 4*t .. 4*t+3 held by thread t
// of the warp, each ((tx * ty) * tz) without contraction.
__device__ __forceinline__ void lane_weights(int t, float px, float py,
                                             float pz, float w[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int lane = 4 * t + c;
    const float lx = static_cast<float>(lane / (kSide * kSide));
    const float ly = static_cast<float>((lane / kSide) % kSide);
    const float lz = static_cast<float>(lane % kSide);
    const float tx = tent_bracket::tent(lx, px);
    const float ty = tent_bracket::tent(ly, py);
    const float tz = tent_bracket::tent(lz, pz);
    w[c] = __fmul_rn(__fmul_rn(tx, ty), tz);
  }
}

__global__ void tile_interp_fwd_kernel(const float* __restrict__ rows,
                                       const float* __restrict__ p,
                                       float* __restrict__ out, int64_t M) {
  const int t = threadIdx.x & 31;
  const int64_t m =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;  // whole warps leave together
  const float px = __ldg(p + 3 * m);
  const float py = __ldg(p + 3 * m + 1);
  const float pz = __ldg(p + 3 * m + 2);
  float w[4];
  lane_weights(t, px, py, pz, w);

  const float4* r = reinterpret_cast<const float4*>(rows + m * (2 * kLanes));
  const float4 a = __ldg(r + t);               // feature 0, lanes 4t..4t+3
  const float4 b = __ldg(r + kLanes / 4 + t);  // feature 1
  float acc0 = a.x * w[0] + a.y * w[1] + a.z * w[2] + a.w * w[3];
  float acc1 = b.x * w[0] + b.y * w[1] + b.z * w[2] + b.w * w[3];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc0 += __shfl_down_sync(0xffffffffu, acc0, off);
    acc1 += __shfl_down_sync(0xffffffffu, acc1, off);
  }
  if (t == 0) {
    reinterpret_cast<float2*>(out)[m] = make_float2(acc0, acc1);
  }
}

__global__ void tile_interp_bwd_rows_kernel(const float* __restrict__ p,
                                            const float* __restrict__ g,
                                            float* __restrict__ drows,
                                            int64_t M) {
  const int t = threadIdx.x & 31;
  const int64_t m =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;
  const float px = __ldg(p + 3 * m);
  const float py = __ldg(p + 3 * m + 1);
  const float pz = __ldg(p + 3 * m + 2);
  const float g0 = __ldg(g + 2 * m);
  const float g1 = __ldg(g + 2 * m + 1);
  float w[4];
  lane_weights(t, px, py, pz, w);

  float4* d = reinterpret_cast<float4*>(drows + m * (2 * kLanes));
  d[t] = make_float4(__fmul_rn(g0, w[0]), __fmul_rn(g0, w[1]),
                     __fmul_rn(g0, w[2]), __fmul_rn(g0, w[3]));
  d[kLanes / 4 + t] =
      make_float4(__fmul_rn(g1, w[0]), __fmul_rn(g1, w[1]),
                  __fmul_rn(g1, w[2]), __fmul_rn(g1, w[3]));
}

unsigned int blocks_for(int64_t M) {
  return static_cast<unsigned int>((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// rows [M, 256] f32, p [M, 3] f32 -> out [M, 2] f32. All 16-byte aligned.
int tile_interp_fwd(const void* rows, const void* p, void* out, long long M,
                    void* stream) {
  tile_interp_fwd_kernel<<<blocks_for(M), kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(p),
      static_cast<float*>(out), M);
  return static_cast<int>(cudaGetLastError());
}

// p [M, 3] f32, g [M, 2] f32 -> drows [M, 256] f32.
int tile_interp_bwd_rows(const void* p, const void* g, void* drows,
                         long long M, void* stream) {
  tile_interp_bwd_rows_kernel<<<blocks_for(M), kWarpsPerBlock * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<float*>(drows), M);
  return static_cast<int>(cudaGetLastError());
}

const char* tile_interp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
