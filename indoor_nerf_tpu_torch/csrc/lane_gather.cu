// Within-row (lane) gather of 128-lane rows, and its gradient.
//
//   forward:   out[i, j]     = values[i, idx[i, j]]
//   backward:  dvalues[i, l] = sum_j g[i, j] * (idx[i, j] == l)
//   values, dvalues [N, 128] f32; idx [N, k] int32 in [0, 128); out, g
//   [N, k] f32; k <= 128; duplicate indices add in the backward.
//
// Replaces indoor_nerf_tpu/ops/pallas/lane_gather.py::_select_tpu (body
// _select_kernel, Mosaic's lane-dimension dynamic_gather) and ::_grad_tpu
// (body _grad_kernel, the one-hot masked reduction), the two Pallas kernels
// behind the custom VJP lane_select.
//
// What bounds both on an H100: bytes. There is one load and at most one add
// per element. The forward reads 512 B of values and 4k B of indices and
// writes 4k B per row; a row's k picks fall inside its own 512 B, so every
// sector that is fetched from device memory is fetched once and the picks
// hit L1/L2. The backward reads 8k B and writes 512 B per row.
//
// On the TPU the hard part was the lane-dimension select itself (the
// generic gather is slow there, so the kernel pre-broadcasts the indices to
// 128 lanes and uses a dynamic_gather; the backward unrolls k one-hot
// compares to keep the [N, k, 128] mask out of memory). A GPU thread
// addresses any lane, so none of that carries over:
//
// - forward: one thread per (i, j); threads of a warp read consecutive
//   indices (coalesced) and write consecutive outputs, and their loads land
//   in at most a few 512 B rows.
// - backward: one warp per row; thread t owns outputs 4t .. 4t+3 and walks
//   j = 0 .. k-1 in order, adding g[i, j] to the owned lane that idx[i, j]
//   names. No atomics, no one-hot array, and a fixed summation order (j
//   ascending, __fadd_rn), so the result does not change from run to run.
//   Each g and idx element is read by the whole warp from one address (a
//   broadcast load); the output leaves as one coalesced float4 per thread.
//
// An index outside [0, 128) is the caller's error. The kernels never touch
// memory outside the row for it: the forward writes a NaN there, the
// backward drops the entry.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() so the wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarpsPerBlock = 8;

__global__ void lane_select_fwd_kernel(const float* __restrict__ values,
                                       const int32_t* __restrict__ idx,
                                       float* __restrict__ out, int64_t total,
                                       int k) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t i = t / k;
  const int32_t l = idx[t];
  if (l < 0 || l >= kLanes) {
    out[t] = __int_as_float(0x7fc00000);  // visible, and no read outside
    return;
  }
  out[t] = __ldg(values + i * kLanes + l);
}

__global__ void lane_select_grad_kernel(const int32_t* __restrict__ idx,
                                        const float* __restrict__ g,
                                        float* __restrict__ dvalues, int64_t N,
                                        int k) {
  const int t = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= N) return;  // whole warps leave together
  const int32_t* ri = idx + i * k;
  const float* rg = g + i * k;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < k; ++j) {
    const int32_t l = __ldg(ri + j);
    const float gv = __ldg(rg + j);
    if ((l >> 2) == t) {  // false for any l outside [0, 128)
      const int c = l & 3;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q == c) acc[q] = __fadd_rn(acc[q], gv);
      }
    }
  }
  reinterpret_cast<float4*>(dvalues + i * kLanes)[t] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

}  // namespace

extern "C" {

// values [N, 128] f32, idx [N, k] int32 -> out [N, k] f32.
int lane_select_fwd(const void* values, const void* idx, void* out,
                    long long N, int k, void* stream) {
  const int threads = 256;
  const int64_t total = static_cast<int64_t>(N) * k;
  const int64_t blocks = (total + threads - 1) / threads;
  lane_select_fwd_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), total, k);
  return static_cast<int>(cudaGetLastError());
}

// idx [N, k] int32, g [N, k] f32 -> dvalues [N, 128] f32 (16-byte aligned).
int lane_select_grad(const void* idx, const void* g, void* dvalues,
                     long long N, int k, void* stream) {
  const int64_t blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lane_select_grad_kernel<<<static_cast<unsigned int>(blocks),
                            kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(g),
      static_cast<float*>(dvalues), N, k);
  return static_cast<int>(cudaGetLastError());
}

const char* lane_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
