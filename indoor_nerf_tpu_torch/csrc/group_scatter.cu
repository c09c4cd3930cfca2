// Grouped block-hash encode backward: each group of G consecutive samples
// of a ray, at one level, adds ONE merged cotangent row to its anchor tile.
//
//   grad[row(r, grp, l), f*lpf + lane] +=
//       round( sum_{member j} ((g_j[f] * tx_j) * ty_j) * tz_j )
//
// with (tx_j, ty_j, tz_j) member j's tent factors at its position in the
// ANCHOR tile, the member sum taken in f32 in member order, round() the
// scatter dtype's rounding (bf16 round-to-nearest-even for the flagship,
// none for f32) applied once to the sum, and the table sums f32. A level
// whose G is 1 is table_scatter.cu's arithmetic.
//
// Replaces indoor_nerf_tpu/ops/pallas/table_scatter.py::
// scatter_add_table_ragged together with what fed it in
// ops/blockhash.py::_encode_grouped_fused_bwd (:837-934): the per-sample
// cotangent rows in anchor coordinates, their group sum
// (cot_s.reshape(..., G, W).sum(axis=1).astype(dt), :871-872), the
// level-major ragged stream and, on the training path, the anchor
// coordinates themselves (_grouped_coords, :730-774). The TPU kernel
// accumulates one level at a time in VMEM over a stream padded to 2048-row
// chunks; here every (ray, level, group) of every level is one launch, and
// neither the [M, W] cotangent nor the anchor rows and positions reach
// device memory.
//
// What bounds it on an H100: atomic reductions at L2, as table_scatter.cu,
// and the design makes the same fewer, wider ones:
//
// - One thread takes one member, a (ray, sample, level) row, with all F
//   features, in memory order: a warp reads 32 consecutive rows of g (a
//   float4 per thread at F 4) and of the coordinates, as table_scatter.cu
//   does, and a level whose G is 1 runs that kernel's instructions. It sums
//   into the vertex-major packed f32 buffer [rows, lpf, F] of
//   table_scatter.cu with ONE vector reduction (red.global.add.v4.f32 at
//   F 4) per vertex the group touches; a vertex whose F rounded sums are
//   all 0 adds nothing. table_scatter_unpack then returns the master's
//   layout.
// - The merge runs in registers. A member brackets 8 vertices of the anchor
//   tile; member j emits those of its 8 that no earlier member brackets
//   (the test is on vertex coordinates, so members clamped onto one face
//   of the anchor block share vertices like any others), and each emitted
//   vertex carries the sum over the members j, j + 1, ... that bracket it,
//   in member order: the thread walks the other G - 1 members once, whose
//   coordinates its neighbours in the warp have just loaded. Every vertex
//   of the group's union is emitted once. Members before the owner add
//   exact zeros in the dense member sum, so the sums are bitwise those of
//   ops/group_scatter.py::group_scatter_plain (__fmul_rn / __fadd_rn: the
//   compiler may not contract a product into the following add, which
//   would round once where the plain version rounds twice). No shared
//   memory beyond the level table, whatever lpf, and any G that divides S.
// - The anchor math inside (the second entry point): from the lattice
//   vertex v0 and weights w that the encode's forward keeps, the thread
//   takes the group's anchor (member G / 2), its partition block
//   floor(v0 / B), the row level * R + (hash & (R - 1)) with the
//   XOR-of-primes hash in uint32 wraparound products, and each member's
//   position clamp(float(v0 - block * B) + w, 0, B): the integer part is
//   exact and the one add is __fadd_rn, so rows and positions are bit for
//   bit those of ops/blockhash.py::_grouped_coords (group_anchor_coords
//   writes them out for the tests that hold this). One merge body serves
//   both sources of coordinates.
//
// - Two early returns, both exact, for what a real step's rows are like
//   (they change nothing on uniformly random rows): a member whose own and
//   later members' cotangents are all 0 has only zero sums to add (two
//   thirds of a step's samples carry no weight), and a member whose 8
//   vertices earlier members all bracket emits nothing (at the coarse
//   levels, where groups are used, most members lie in their
//   predecessor's cell).
//
// Measured on the card and dropped (PERF.md): one thread per (ray, level,
// group) walking its members in run-time loops took the same time on
// random rows and within 7% either way on a real grouped step's rows
// (without the early returns, which a thread per member takes one member
// at a time); __launch_bounds__(256, 3) gave 3% on the step's rows before
// the second early return and spills after it, (256, 4) spills and loses
// 11% on random rows.
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
using tent_bracket::Bracket;

constexpr int kMaxLevels = 32;

struct LevelGroups {
  int n_levels;
  int G[kMaxLevels];  // group size per level (divides S)
};

// Where a (ray, sample, level) row m = (ray * S + s) * L + l lies in its
// group: the level, the group size, the member index and the group's first
// row. The level table goes through shared memory: indexing the kernel
// parameter at a run-time index would copy it to each thread's local memory.
struct Member {
  int l, G, j;
  int64_t m0;
};

// Every thread of the block calls this (it holds a barrier).
__device__ __forceinline__ Member locate(int64_t m, int S,
                                         const LevelGroups& lg) {
  __shared__ int s_G[kMaxLevels];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) s_G[i] = lg.G[i];
  }
  __syncthreads();
  const int L = lg.n_levels;
  Member me;
  me.l = static_cast<int>(m % L);
  me.G = s_G[me.l];
  me.j = static_cast<int>((m / L) % S) % me.G;
  me.m0 = m - static_cast<int64_t>(me.j) * L;
  return me;
}

// Coordinates as the caller gives them: the group's row at its first
// member, each member's position in the anchor tile.
struct GivenCoords {
  const int32_t* row;
  const float* p;

  __device__ int32_t begin(int64_t m0, int, int, int) { return __ldg(row + m0); }

  __device__ Bracket member(int64_t m, int side) const {
    return tent_bracket::bracket(__ldg(p + 3 * m), __ldg(p + 3 * m + 1),
                                 __ldg(p + 3 * m + 2), side);
  }
};

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return q - ((a % b) < 0);
}

// Coordinates from the lattice: ops/blockhash.py::_grouped_coords.
struct AnchorCoords {
  const int32_t* v0;         // [Rn, S, L, 3] bottom-left vertex
  const float* w;            // [Rn, S, L, 3] trilinear weights
  const int64_t* level_ids;  // [L]
  int B;                     // block size (side - 1)
  int log2_rows;
  uint32_t primes[4];
  int ox, oy, oz;            // the anchor block's origin vertex

  // The group's global row; keeps the anchor block's origin for member().
  __device__ int32_t begin(int64_t m0, int l, int G, int L) {
    const int64_t ma = m0 + static_cast<int64_t>(G / 2) * L;
    const int bx = floor_div(__ldg(v0 + 3 * ma), B);
    const int by = floor_div(__ldg(v0 + 3 * ma + 1), B);
    const int bz = floor_div(__ldg(v0 + 3 * ma + 2), B);
    ox = bx * B, oy = by * B, oz = bz * B;
    const int64_t level = __ldg(level_ids + l);
    const uint32_t h = (static_cast<uint32_t>(bx) * primes[0]) ^
                       (static_cast<uint32_t>(by) * primes[1]) ^
                       (static_cast<uint32_t>(bz) * primes[2]) ^
                       (static_cast<uint32_t>(level) * primes[3]);
    const int64_t local = h & ((1u << log2_rows) - 1u);
    return static_cast<int32_t>((level << log2_rows) + local);
  }

  __device__ float axis(int64_t i, int origin) const {
    const float hi = static_cast<float>(B);
    const float q =
        __fadd_rn(static_cast<float>(__ldg(v0 + i) - origin), __ldg(w + i));
    return fminf(fmaxf(q, 0.0f), hi);
  }

  __device__ void position(int64_t m, float (&q)[3]) const {
    q[0] = axis(3 * m, ox);
    q[1] = axis(3 * m + 1, oy);
    q[2] = axis(3 * m + 2, oz);
  }

  __device__ Bracket member(int64_t m, int side) const {
    float q[3];
    position(m, q);
    return tent_bracket::bracket(q[0], q[1], q[2], side);
  }
};

template <int VEC, class Coords>
__global__ void __launch_bounds__(kThreads)
group_scatter_kernel(const float* __restrict__ g, Coords coords,
                     float* __restrict__ packed, int64_t M, int S, int F,
                     int lpf, int side, int64_t n_rows, bool round_bf16,
                     LevelGroups lg) {
  // Threads past M locate the last row (every thread reaches the barrier
  // in locate), then leave.
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const Member me = locate(m < M ? m : M - 1, S, lg);
  if (m >= M) return;
  const int L = lg.n_levels;

  // This member emits sums of its own and the later members' shares only:
  // where their cotangents are all 0 (most of a real step's samples carry
  // no weight), every sum rounds to 0 and there is nothing to add.
  bool live = false;
  for (int i = me.j; i < me.G && !live; ++i) {
    const float* gi = g + (me.m0 + static_cast<int64_t>(i) * L) * F;
    for (int f0 = 0; f0 < F; f0 += VEC) {
      float gv[VEC];
      load_vec<VEC>(gi + f0, gv);
#pragma unroll
      for (int c = 0; c < VEC; ++c) live = live || gv[c] != 0.0f;
    }
  }
  if (!live) return;

  const int32_t r = coords.begin(me.m0, me.l, me.G, L);
  // Out-of-range rows are dropped: the kernel never writes outside the
  // table (the encode's rows are always in range).
  if (r < 0 || r >= n_rows) return;
  const Bracket bj = coords.member(m, side);

  // Bit k = 4 dx + 2 dy + dz: an earlier member brackets that vertex and
  // emits it, with this member's share inside. At the coarse levels, where
  // groups are used, most members lie in their predecessor's cell and
  // leave here.
  unsigned owned = 0;
  for (int i = 0; i < me.j; ++i) {
    const Bracket bi =
        coords.member(me.m0 + static_cast<int64_t>(i) * L, side);
    const int ex = bj.ix - bi.ix, ey = bj.iy - bi.iy, ez = bj.iz - bi.iz;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int qx = ex + (k >> 2), qy = ey + ((k >> 1) & 1), qz = ez + (k & 1);
      if ((qx | qy | qz) >> 1 == 0) owned |= 1u << k;  // each q in {0, 1}
    }
  }
  if (owned == 0xffu) return;

  float* dst = packed + (static_cast<int64_t>(r) * lpf + bj.lane0) * F;
  for (int f0 = 0; f0 < F; f0 += VEC) {
    float acc[8][VEC];
    {
      float gv[VEC];
      load_vec<VEC>(g + m * F + f0, gv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          acc[k][c] = __fmul_rn(
              __fmul_rn(__fmul_rn(gv[c], bj.tx[dx]), bj.ty[dy]), bj.tz[dz]);
        }
      }
    }
    // The later members, in member order, add their share of each vertex
    // of this member's that they bracket too.
    for (int i = me.j + 1; i < me.G; ++i) {
      const int64_t mi = me.m0 + static_cast<int64_t>(i) * L;
      const Bracket bi = coords.member(mi, side);
      const int ex = bj.ix - bi.ix, ey = bj.iy - bi.iy, ez = bj.iz - bi.iz;
      if (ex < -1 || ex > 1 || ey < -1 || ey > 1 || ez < -1 || ez > 1) {
        continue;  // the two brackets share no vertex
      }
      float gv[VEC];
      load_vec<VEC>(g + mi * F + f0, gv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int qx = ex + (k >> 2), qy = ey + ((k >> 1) & 1),
                  qz = ez + (k & 1);
        if ((qx | qy | qz) >> 1 != 0) continue;
        const float wx = qx ? bi.tx[1] : bi.tx[0];
        const float wy = qy ? bi.ty[1] : bi.ty[0];
        const float wz = qz ? bi.tz[1] : bi.tz[0];
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          acc[k][c] = __fadd_rn(
              acc[k][c], __fmul_rn(__fmul_rn(__fmul_rn(gv[c], wx), wy), wz));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if ((owned >> k) & 1u) continue;
      const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      bool any = false;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        if (round_bf16) {
          acc[k][c] = __bfloat162float(__float2bfloat16_rn(acc[k][c]));
        }
        any = any || acc[k][c] != 0.0f;
      }
      if (any) {
        reduce_vec<VEC>(
            dst + (dx * bj.stride_x + dy * bj.stride_y + dz) * F + f0, acc[k]);
      }
    }
  }
}

// row and p of every (ray, sample, level) as AnchorCoords gives them to the
// merge: what ops/blockhash.py::_grouped_coords returns.
__global__ void __launch_bounds__(kThreads)
anchor_coords_kernel(AnchorCoords coords, int32_t* __restrict__ row,
                     float* __restrict__ p, int64_t M, int S, LevelGroups lg) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const Member me = locate(m < M ? m : M - 1, S, lg);
  if (m >= M) return;
  row[m] = coords.begin(me.m0, me.l, me.G, lg.n_levels);
  float q[3];
  coords.position(m, q);
  p[3 * m] = q[0], p[3 * m + 1] = q[1], p[3 * m + 2] = q[2];
}

inline unsigned int blocks_for(int64_t M) {
  return static_cast<unsigned int>((M + kThreads - 1) / kThreads);
}

template <class Coords>
int launch(const float* g, const Coords& coords, float* packed,
           int64_t n_rays, int S, int F, int lpf, int side, int64_t n_rows,
           bool round_bf16, const LevelGroups& lg, cudaStream_t st) {
  const int64_t M = n_rays * S * lg.n_levels;
  const unsigned int blocks = blocks_for(M);
  if (F % 4 == 0) {
    group_scatter_kernel<4, Coords><<<blocks, kThreads, 0, st>>>(
        g, coords, packed, M, S, F, lpf, side, n_rows, round_bf16, lg);
  } else if (F % 2 == 0) {
    group_scatter_kernel<2, Coords><<<blocks, kThreads, 0, st>>>(
        g, coords, packed, M, S, F, lpf, side, n_rows, round_bf16, lg);
  } else {
    group_scatter_kernel<1, Coords><<<blocks, kThreads, 0, st>>>(
        g, coords, packed, M, S, F, lpf, side, n_rows, round_bf16, lg);
  }
  return static_cast<int>(cudaGetLastError());
}

// groups: host array [L] of per-level group sizes, each dividing S.
bool level_groups(const int* groups, int S, int L, LevelGroups* lg) {
  if (L < 1 || L > kMaxLevels) return false;
  lg->n_levels = L;
  for (int l = 0; l < kMaxLevels; ++l) {
    lg->G[l] = l < L ? groups[l] : 1;
    if (lg->G[l] < 1 || S % lg->G[l] != 0) return false;
  }
  return true;
}

AnchorCoords anchor_coords(const void* v0, const void* w,
                           const void* level_ids, int side, int log2_rows,
                           const unsigned int* primes) {
  AnchorCoords c;
  c.v0 = static_cast<const int32_t*>(v0);
  c.w = static_cast<const float*>(w);
  c.level_ids = static_cast<const int64_t*>(level_ids);
  c.B = side - 1;
  c.log2_rows = log2_rows;
  for (int i = 0; i < 4; ++i) c.primes[i] = primes[i];
  c.ox = c.oy = c.oz = 0;
  return c;
}

}  // namespace

extern "C" {

// packed: zeroed f32 [n_rows, lpf, F]; g and packed 16-byte aligned;
// groups: host array [L]; round_bf16 != 0 rounds each merged entry to
// bfloat16 before the f32 sums.
int group_scatter(const void* g, const void* p, const void* row, void* packed,
                  long long n_rays, int S, int L, int F, int lpf, int side,
                  long long n_rows, const int* groups, int round_bf16,
                  void* stream) {
  LevelGroups lg;
  if (!level_groups(groups, S, L, &lg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GivenCoords c;
  c.row = static_cast<const int32_t*>(row);
  c.p = static_cast<const float*>(p);
  return launch(static_cast<const float*>(g), c, static_cast<float*>(packed),
                n_rays, S, F, lpf, side, n_rows, round_bf16 != 0, lg,
                static_cast<cudaStream_t>(stream));
}

// The same from the lattice coordinates: v0 int32 and w f32 [Rn, S, L, 3],
// level_ids int64 [L]; primes: host array of the hash's 4 uint32 primes;
// 1 <= log2_rows <= 31.
int group_scatter_anchored(const void* g, const void* v0, const void* w,
                           const void* level_ids, void* packed,
                           long long n_rays, int S, int L, int F, int lpf,
                           int side, long long n_rows, const int* groups,
                           int log2_rows, const unsigned int* primes,
                           int round_bf16, void* stream) {
  LevelGroups lg;
  if (!level_groups(groups, S, L, &lg) || log2_rows < 1 || log2_rows > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(static_cast<const float*>(g),
                anchor_coords(v0, w, level_ids, side, log2_rows, primes),
                static_cast<float*>(packed), n_rays, S, F, lpf, side, n_rows,
                round_bf16 != 0, lg, static_cast<cudaStream_t>(stream));
}

// row int32 [Rn, S, L] and p f32 [Rn, S, L, 3] as group_scatter_anchored
// computes them.
int group_anchor_coords(const void* v0, const void* w, const void* level_ids,
                        void* row, void* p, long long n_rays, int S, int L,
                        int side, const int* groups, int log2_rows,
                        const unsigned int* primes, void* stream) {
  LevelGroups lg;
  if (!level_groups(groups, S, L, &lg) || log2_rows < 1 || log2_rows > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t M = static_cast<int64_t>(n_rays) * S * L;
  anchor_coords_kernel<<<blocks_for(M), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      anchor_coords(v0, w, level_ids, side, log2_rows, primes),
      static_cast<int32_t*>(row), static_cast<float*>(p), M, S, lg);
  return static_cast<int>(cudaGetLastError());
}

const char* group_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
