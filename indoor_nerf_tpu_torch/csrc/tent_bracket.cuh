// The 8 tile vertices that bracket an in-tile position, and their tent
// weights: the shared core of the block-hash encode forward
// (tent_contract.cu) and backward (table_scatter.cu, group_scatter.cu).
//
// Tile lane l holds vertex (l / side^2, (l / side) % side, l % side). The
// full-lane tent product w(l) = tent(lx - px) tent(ly - py) tent(lz - pz),
// tent(t) = max(0, 1 - |t|), is zero except at the two lanes i0, i0 + 1 per
// axis with i0 = clamp(floor(p), 0, side - 2). The weights below use that
// same formula, so they are bitwise the full-lane weights of those lanes,
// including integer p and p = side - 1 (where one of the two is exactly 0).

#pragma once

#include <cuda_runtime.h>

namespace tent_bracket {

__device__ __forceinline__ float tent(float l, float p) {
  return fmaxf(0.0f, 1.0f - fabsf(l - p));
}

struct Bracket {
  int ix, iy, iz;  // the bracket's origin vertex in the tile
  int lane0;     // lane of vertex (ix, iy, iz) within the feature's lanes
  int stride_x;  // side^2: lane step of +1 vertex along x
  int stride_y;  // side
  float tx[2], ty[2], tz[2];
};

__device__ __forceinline__ Bracket bracket(float px, float py, float pz,
                                           int side) {
  const float hi = static_cast<float>(side - 2);
  // fminf/fmaxf pick the number over a NaN, so the casts stay defined.
  const int ix = static_cast<int>(fminf(fmaxf(floorf(px), 0.0f), hi));
  const int iy = static_cast<int>(fminf(fmaxf(floorf(py), 0.0f), hi));
  const int iz = static_cast<int>(fminf(fmaxf(floorf(pz), 0.0f), hi));
  Bracket b;
  b.ix = ix, b.iy = iy, b.iz = iz;
  b.stride_y = side;
  b.stride_x = side * side;
  b.lane0 = ix * b.stride_x + iy * side + iz;
  b.tx[0] = tent(ix, px);
  b.tx[1] = tent(ix + 1, px);
  b.ty[0] = tent(iy, py);
  b.ty[1] = tent(iy + 1, py);
  b.tz[0] = tent(iz, pz);
  b.tz[1] = tent(iz + 1, pz);
  return b;
}

}  // namespace tent_bracket
