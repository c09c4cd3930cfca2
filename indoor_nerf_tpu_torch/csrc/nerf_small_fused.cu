// NeRFSmall's query after the encode, in one launch: the sigma net, the
// colour net on [view features, geometry features], the normal net where
// the model has one, and the query's glue, for every row of one tile of
// samples. For row n of ray n / S (models/field.py::query_field):
//
//   h     = relu(feats[n] @ W0)                 I -> 64, no bias
//   s     = h @ W1                              64 -> 16: sigma, geo (15)
//   c     = relu([vf[n / S], geo] @ C0)         V + 15 -> 64, no bias
//   c     = relu(c @ C1)                        64 -> 64, no bias
//   rgb   = c @ C2                              64 -> 3, no bias
//   nrm   = relu(geo @ N0 + b0) @ N1 + b1       15 -> 32 -> 3
//   raw[n] = (rgb, keep[n] ? sigma : 0, nrm / max(|nrm|, 1e-12))
//
// in float32 FFMA throughout: every dot product is summed over k in
// ascending order with fmaf from 0, and a bias is added after its sum, as
// the eager chain (models/mlp.py::apply_nerf_small) adds it. No TF32 and
// no bf16: the configurations state float32 products without TF32.
//
// Replaces no TPU kernel: the JAX package leaves the MLP to XLA, which
// fuses it. Eager PyTorch does not: at 640,000 rays x 32 samples (20.48M
// rows, one 800x800 request) the chain took ~92 launches a tile, each
// GEMM, ReLU, concatenation and bias streaming its [N, 64] activation
// through device memory, ~49 ms of a 122 ms request.
//
// What bounds it on an H100: operations. At the flagship's widths a row
// takes 8,896 multiply-adds (sigma 2,048 + 1,024, colour 960 + 4,096 +
// 192 from the geometry features on, normal 480 + 96) and its ray 1,024
// (the view features' 16 x 64 part of the colour net's first layer,
// summed once a ray): at 32 samples a ray 8,928 a row, 366 GFLOP a
// request, 5.46 ms at the 67 TFLOP/s float32 FMA rate. Reading the
// features (128 B a row) and the view features and writing 28 B a row is
// ~3.2 GB, ~1 ms at 3.35 TB/s. The design keeps the FMA pipes fed from
// registers and shared memory and never sends an activation to device
// memory:
//
// - Persistent blocks, as many as fit on the card (at the serving widths
//   two an SM, 108 KB of shared memory each), each loading the packed weights (40 KB with the
//   normal net) into shared memory once, then walking tiles of kRows rows.
// - The 64-wide layers are register-blocked products on the tile: each
//   of the 128 threads holds 8 rows x 8 outputs, so two 16-byte loads of
//   4 activations and two of 4 weights feed 64 FFMAs. (4 rows x 8 outputs
//   at 256 threads took 4.5% longer, 8 x 8 at 256 rows a tile 2.6%, 4 x 8
//   at 64 rows with three blocks an SM 5%: PERF.md.) Activations live in
//   shared memory transposed ([k][row]); a layer reads its input into its
//   accumulators, the block synchronises, and the ReLU'd output is
//   written over the input.
// - The view part of the colour net's first layer is a function of the
//   ray: its V-term sums are taken once a ray of the tile (P), and each
//   row's 64 sums start from its ray's P and go on over the 15 geometry
//   features. The order is the same ascending order, so the result is
//   the same to the bit as summing all V + 15 terms a row, and the
//   broadcast [N, V] view copy and the [N, V + 15] concatenation are
//   never formed.
// - The next tile's features, view features and keep flags are loaded
//   into registers while this tile computes, and stored into shared
//   memory after it.
// - The output is written once, a row a thread.
//
// Widths are compile-time, one instantiation for each that the port's
// grid fields build through the parser: input 16 or 32 (levels x
// features a level), view features 0 (no --use_viewdirs), 16 (SH of
// degree 4) or 27 (positional encoding of 4 frequencies), with and
// without the normal net; hidden 64, geometry 15. models/mlp_fused.py
// sends a model of other widths down the eager chain.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() so the wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHid = 64;         // sigma net hidden
constexpr int kGeo = 15;         // geometry features
constexpr int kSig = 1 + kGeo;   // sigma net output: sigma, geo
constexpr int kCol = 64;         // colour net hidden
constexpr int kNrm = kHid / 2;   // normal net hidden

constexpr int kRows = 128;      // rows a tile
constexpr int kR = 8;           // rows a thread of a 64-wide layer
constexpr int kThreads = kRows * kHid / (kR * 8);  // 8 outputs a thread
constexpr int kLd = kRows + 4;  // a transposed activation's row stride
static_assert(kR % 4 == 0, "rows in float4s");
static_assert(kThreads == kRows, "a row a thread at the end of a tile");

// One instantiation's widths, its packed weights and its shared memory.
//
// The pack (floats), each [in][out] as y = x @ w; a 3-wide output is
// padded to 4 with zeros for 16-byte loads. models/mlp_fused.py makes the
// pack and checks these offsets against the library's.
//
// Shared memory (floats): the pack, the activation [64][kLd] (the
// features in rows 0..kIn-1), the sigma net's output [16][kLd] (row 0
// sigma), the tile's view features [kRows][kViews] (the rays' rows, at
// most one a tile row) and, with the normal net, its hidden layer
// [32][kLd].
template <int In, int Views, bool Normals>
struct Net {
  static constexpr int kIn = In;         // encode features
  static constexpr int kViews = Views;   // view features
  static constexpr bool kNormals = Normals;
  static constexpr int W0 = 0;                    // sigma_net.0.w      [I][64]
  static constexpr int W1 = W0 + kIn * kHid;      // sigma_net.1.w      [64][16]
  static constexpr int Wv = W1 + kHid * kSig;     // color_net.0.w[:V]  [V][64]
  static constexpr int Wg = Wv + kViews * kCol;   // color_net.0.w[V:]  [15][64]
  static constexpr int Wc1 = Wg + kGeo * kCol;    // color_net.1.w      [64][64]
  static constexpr int Wc2 = Wc1 + kCol * kCol;   // color_net.2.w      [64][4]
  static constexpr int N0w = Wc2 + kCol * 4;      // normal_net.0.w     [15][32]
  static constexpr int N0b = N0w + kGeo * kNrm;   // normal_net.0.b     [32]
  static constexpr int N1w = N0b + kNrm;          // normal_net.1.w     [32][4]
  static constexpr int N1b = N1w + kNrm * 4;      // normal_net.1.b     [4]
  static constexpr int pack = kNormals ? N1b + 4 : N0w;
  static constexpr int act = pack;
  static constexpr int sig = act + kHid * kLd;
  static constexpr int vfs = sig + kSig * kLd;
  static constexpr int nrm = vfs + kRows * kViews;
  static constexpr int floats = nrm + (kNormals ? kNrm * kLd : 0);
  static constexpr size_t bytes = sizeof(float) * floats;
  static constexpr int feat4 = kRows * kIn / 4 / kThreads;  // float4s a thread
  static_assert(kIn % 4 == 0 && kIn <= kHid, "features in float4s, in act");
  static_assert(feat4 * kThreads * 4 == kRows * kIn, "feature load");
  static_assert(pack % 4 == 0 && nrm % 4 == 0, "float4 offsets");
};

struct Tile {
  long long m0;     // first row
  int nv;           // rows in the tile
  long long ray0;   // ray of the first row
  int n_rays;       // rays the tile's rows belong to
};

__device__ __forceinline__ Tile tile_at(long long tile, long long n_rows,
                                        int samples) {
  Tile T;
  T.m0 = tile * kRows;
  T.nv = static_cast<int>(min(static_cast<long long>(kRows), n_rows - T.m0));
  T.ray0 = T.m0 / samples;
  T.n_rays = static_cast<int>((T.m0 + T.nv - 1) / samples - T.ray0 + 1);
  return T;
}

// A tile's inputs, in registers between its load and its store.
template <class N>
struct Staged {
  float4 feat[N::feat4];
  float view[N::kViews > 0 ? N::kViews : 1];  // the first kViews used
  uint8_t keep;  // row t's flag
};

template <class N>
__device__ __forceinline__ void load_tile(const Tile& T,
                                          const float4* __restrict__ feats,
                                          const float* __restrict__ vf,
                                          const uint8_t* __restrict__ keep,
                                          Staged<N>& s, int t) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u = 0; u < N::feat4; ++u) {
    const int q = t + u * kThreads;
    const int row = q / (N::kIn / 4);
    s.feat[u] = row < T.nv
        ? __ldg(feats + (T.m0 + row) * (N::kIn / 4) + q % (N::kIn / 4))
        : zero;
  }
  // The tile's rays' view features, contiguous from ray0: at most kRows
  // rays, so kViews coalesced floats a thread.
#pragma unroll
  for (int u = 0; u < N::kViews; ++u) {
    const int q = t + u * kThreads;
    s.view[u] = q < T.n_rays * N::kViews
        ? __ldg(vf + T.ray0 * N::kViews + q) : 0.f;
  }
  s.keep = (t < T.nv) ? __ldg(keep + T.m0 + t) : 0;
}

template <class N>
__device__ __forceinline__ void store_tile(const Staged<N>& s, float* act,
                                           float* vfs, int t) {
#pragma unroll
  for (int u = 0; u < N::feat4; ++u) {
    const int q = t + u * kThreads;
    const int row = q / (N::kIn / 4), k = 4 * (q % (N::kIn / 4));
    act[(k + 0) * kLd + row] = s.feat[u].x;
    act[(k + 1) * kLd + row] = s.feat[u].y;
    act[(k + 2) * kLd + row] = s.feat[u].z;
    act[(k + 3) * kLd + row] = s.feat[u].w;
  }
#pragma unroll
  for (int u = 0; u < N::kViews; ++u) vfs[t + u * kThreads] = s.view[u];
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// The thread's kR activations of row block r0 at input k.
__device__ __forceinline__ void ld_rows(float (&av)[kR], const float* in,
                                        int r0) {
#pragma unroll
  for (int g = 0; g < kR / 4; ++g) {
    const float4 a = ld4(in + r0 + 4 * g);
    av[4 * g] = a.x;
    av[4 * g + 1] = a.y;
    av[4 * g + 2] = a.z;
    av[4 * g + 3] = a.w;
  }
}

// acc[i][j] += sum_k in[k][r0 + i] * w[k][c(j)] over k ascending, for the
// thread's rows r0..r0+kR-1 and outputs c0..c0+3, 32+c0..32+c0+3 of a
// 64-wide layer.
template <int K>
__device__ __forceinline__ void mm_rows_x8(float (&acc)[kR][8],
                                           const float* __restrict__ in,
                                           const float* __restrict__ w,
                                           int r0, int c0) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[kR];
    ld_rows(av, in + k * kLd, r0);
    const float4 b0 = ld4(w + k * 64 + c0);
    const float4 b1 = ld4(w + k * 64 + 32 + c0);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float* r = acc[i];
      r[0] = fmaf(av[i], b0.x, r[0]);
      r[1] = fmaf(av[i], b0.y, r[1]);
      r[2] = fmaf(av[i], b0.z, r[2]);
      r[3] = fmaf(av[i], b0.w, r[3]);
      r[4] = fmaf(av[i], b1.x, r[4]);
      r[5] = fmaf(av[i], b1.y, r[5]);
      r[6] = fmaf(av[i], b1.z, r[6]);
      r[7] = fmaf(av[i], b1.w, r[7]);
    }
  }
}

__device__ __forceinline__ void zero_rows_x8(float (&acc)[kR][8]) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// out[c][r0 + i] = relu(acc[i][j]) for the thread's 8 outputs c.
__device__ __forceinline__ void store_relu_rows_x8(const float (&acc)[kR][8],
                                                   float* out, int r0,
                                                   int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = (j < 4 ? c0 : 32 + c0) + (j & 3);
#pragma unroll
    for (int g = 0; g < kR / 4; ++g)
      *reinterpret_cast<float4*>(out + c * kLd + r0 + 4 * g) = make_float4(
          fmaxf(acc[4 * g][j], 0.f), fmaxf(acc[4 * g + 1][j], 0.f),
          fmaxf(acc[4 * g + 2][j], 0.f), fmaxf(acc[4 * g + 3][j], 0.f));
  }
}

// out[c][r0 + i] = v[i][j] for outputs c = c0 + j, j < n.
template <int N>
__device__ __forceinline__ void store_rows(const float (&v)[kR][N],
                                           float* out, int r0, int c0) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int g = 0; g < kR / 4; ++g)
      *reinterpret_cast<float4*>(out + (c0 + j) * kLd + r0 + 4 * g) =
          make_float4(v[4 * g][j], v[4 * g + 1][j], v[4 * g + 2][j],
                      v[4 * g + 3][j]);
}

template <class N>
__global__ void __launch_bounds__(kThreads, 2)
nerf_small_fused_kernel(const float* __restrict__ feats,
                        const float* __restrict__ vf,
                        const uint8_t* __restrict__ keep,
                        const float* __restrict__ pack,
                        float* __restrict__ out, long long n_rows,
                        int samples, long long n_tiles) {
  constexpr int kOut = N::kNormals ? 7 : 4;  // channels a row
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const float* const w = smem;
  float* const act = smem + N::act;
  float* const sig = smem + N::sig;
  float* const vfs = smem + N::vfs;
  float* const nrm = smem + N::nrm;
  const float4* const feats4 = reinterpret_cast<const float4*>(feats);

  const int t = threadIdx.x;
  const int r0 = kR * (t >> 3);  // the thread's rows r0..r0+kR-1
  const int c0 = 4 * (t & 7);    // and outputs c0.., 32+c0.. of a layer

  for (int q = t; q < N::pack / 4; q += kThreads)
    smem4[q] = __ldg(reinterpret_cast<const float4*>(pack) + q);

  long long tile = blockIdx.x;
  Tile T = tile_at(tile, n_rows, samples);
  Staged<N> staged;
  load_tile<N>(T, feats4, vf, keep, staged, t);
  store_tile<N>(staged, act, vfs, t);
  bool kept = staged.keep;
  __syncthreads();

  for (;;) {
    const long long next = tile + gridDim.x;
    Tile U = T;
    if (next < n_tiles) {
      U = tile_at(next, n_rows, samples);
      load_tile<N>(U, feats4, vf, keep, staged, t);
    }
    float acc[kR][8];

    // Sigma net, layer 0: features (act rows 0..kIn-1) -> 64, ReLU.
    zero_rows_x8(acc);
    mm_rows_x8<N::kIn>(acc, act, w + N::W0, r0, c0);
    __syncthreads();
    store_relu_rows_x8(acc, act, r0, c0);
    __syncthreads();

    // Sigma net, layer 1: 64 -> sigma and geo (sig rows 0..15); this
    // thread's rows, outputs 2*(t&7) and the next.
    {
      const int c = 2 * (t & 7);
      float s[kR][2] = {};
#pragma unroll 8
      for (int k = 0; k < kHid; ++k) {
        float av[kR];
        ld_rows(av, act + k * kLd, r0);
        const float2 b =
            *reinterpret_cast<const float2*>(w + N::W1 + k * kSig + c);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          s[i][0] = fmaf(av[i], b.x, s[i][0]);
          s[i][1] = fmaf(av[i], b.y, s[i][1]);
        }
      }
      store_rows<2>(s, sig, r0, c);
    }
    __syncthreads();

    // The view part of the colour net's first layer, once a ray: P[j][c]
    // over the tile's rays j, into act (free now) as [n_rays][64].
    if constexpr (N::kViews > 0) {
      for (int idx = t; idx < T.n_rays * kCol; idx += kThreads) {
        const int j = idx / kCol, c = idx % kCol;
        float p = 0.f;
#pragma unroll
        for (int k = 0; k < N::kViews; ++k)
          p = fmaf(vfs[j * N::kViews + k], w[N::Wv + k * kCol + c], p);
        act[j * kCol + c] = p;
      }
    }
    // Normal net, layer 0: geo -> 32, bias, ReLU (nrm rows 0..31); this
    // thread's rows, outputs c0..c0+3.
    if constexpr (N::kNormals) {
      float n[kR][4] = {};
#pragma unroll
      for (int k = 0; k < kGeo; ++k) {
        float av[kR];
        ld_rows(av, sig + (1 + k) * kLd, r0);
        const float4 b = ld4(w + N::N0w + k * kNrm + c0);
#pragma unroll
        for (int i = 0; i < kR; ++i) fma4(n[i], av[i], b);
      }
      const float4 b = ld4(w + N::N0b + c0);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) n[i][j] = fmaxf(n[i][j] + bv[j], 0.f);
      store_rows<4>(n, nrm, r0, c0);
    }
    __syncthreads();

    // Colour net, layer 0: from the row's ray's P (0 without view
    // features), on over geo; ReLU.
    if constexpr (N::kViews > 0) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const long long ray = (T.m0 + r0 + i) / samples - T.ray0;
        const int j = static_cast<int>(
            min(ray, static_cast<long long>(T.n_rays - 1)));
        const float4 p0 = ld4(act + j * kCol + c0);
        const float4 p1 = ld4(act + j * kCol + 32 + c0);
        acc[i][0] = p0.x; acc[i][1] = p0.y; acc[i][2] = p0.z; acc[i][3] = p0.w;
        acc[i][4] = p1.x; acc[i][5] = p1.y; acc[i][6] = p1.z; acc[i][7] = p1.w;
      }
    } else {
      zero_rows_x8(acc);
    }
    mm_rows_x8<kGeo>(acc, sig + kLd, w + N::Wg, r0, c0);
    __syncthreads();
    store_relu_rows_x8(acc, act, r0, c0);
    __syncthreads();

    // Colour net, layer 1: 64 -> 64, ReLU.
    zero_rows_x8(acc);
    mm_rows_x8<kCol>(acc, act, w + N::Wc1, r0, c0);
    __syncthreads();
    store_relu_rows_x8(acc, act, r0, c0);
    __syncthreads();

    // One row a thread: rgb, sigma and the normal.
    {
      float rgb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int k = 0; k < kCol; ++k)
        fma4(rgb, act[k * kLd + t], ld4(w + N::Wc2 + 4 * k));
      const float sigma = kept ? sig[t] : 0.f;
      float* const o = out + (T.m0 + t) * kOut;
      if constexpr (!N::kNormals) {
        if (t < T.nv)
          *reinterpret_cast<float4*>(o) =
              make_float4(rgb[0], rgb[1], rgb[2], sigma);
      } else {
        float n[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int k = 0; k < kNrm; ++k)
          fma4(n, nrm[k * kLd + t], ld4(w + N::N1w + 4 * k));
        const float4 b = ld4(w + N::N1b);
        const float x = n[0] + b.x, y = n[1] + b.y, z = n[2] + b.z;
        const float d = fmaxf(sqrtf(fmaf(z, z, fmaf(y, y, x * x))), 1e-12f);
        if (t < T.nv) {
          o[0] = rgb[0];
          o[1] = rgb[1];
          o[2] = rgb[2];
          o[3] = sigma;
          o[4] = x / d;
          o[5] = y / d;
          o[6] = z / d;
        }
      }
    }
    __syncthreads();

    if (next >= n_tiles) break;
    store_tile<N>(staged, act, vfs, t);
    kept = staged.keep;
    T = U;
    tile = next;
    __syncthreads();
  }
}

// The kernel's shared memory allowed, and the blocks that fit on one SM of
// the current device.
template <class N>
cudaError_t blocks_per_sm(int* per_sm) {
  auto kernel = nerf_small_fused_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(N::bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, N::bytes);
  return err;
}

template <class N>
int launch(const float* feats, const float* vf, const uint8_t* keep,
           const float* pack, float* out, long long n_rows, int samples,
           cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = blocks_per_sm<N>(&per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  const long long grid = min(n_tiles, static_cast<long long>(sms) * per_sm);
  nerf_small_fused_kernel<N>
      <<<static_cast<unsigned>(grid), kThreads, N::bytes, stream>>>(
          feats, vf, keep, pack, out, n_rows, samples, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// op(Net<in, views, normals>{}) for the instantiated widths; kNoNet where
// there is none.
constexpr int kNoNet = -1000;

template <int Views, bool Normals, class Op>
int with_input(int in, Op&& op) {
  switch (in) {
    case 16: return op(Net<16, Views, Normals>{});
    case 32: return op(Net<32, Views, Normals>{});
  }
  return kNoNet;
}

template <bool Normals, class Op>
int with_views(int in, int views, Op&& op) {
  switch (views) {
    case 0: return with_input<0, Normals>(in, op);
    case 16: return with_input<16, Normals>(in, op);
    case 27: return with_input<27, Normals>(in, op);
  }
  return kNoNet;
}

template <class Op>
int with_net(int in, int views, int normals, Op&& op) {
  return normals ? with_views<true>(in, views, op)
                 : with_views<false>(in, views, op);
}

}  // namespace

extern "C" {

// The pack's offsets for input ``in``, ``views`` view features and the
// normal net, in the order of models/mlp_fused.py's pack_layout: W0, W1,
// Wv, Wg, C1, C2, N0w, N0b, N1w, N1b, then the pack's size. Returns how
// many there are, or 0 where no instantiation has these widths.
int nerf_small_fused_layout(int in, int views, int normals, int* values,
                            int n) {
  const int count = with_net(in, views, normals, [&](auto net) {
    using N = decltype(net);
    const int v[] = {N::W0, N::W1, N::Wv, N::Wg, N::Wc1, N::Wc2,
                     N::N0w, N::N0b, N::N1w, N::N1b, N::pack};
    const int c = static_cast<int>(sizeof(v) / sizeof(v[0]));
    for (int i = 0; i < n && i < c; ++i) values[i] = v[i];
    return c;
  });
  return count == kNoNet ? 0 : count;
}

// Blocks of the kernel resident on one SM of the current device, minus the
// CUDA error, or 0 where no instantiation has these widths.
int nerf_small_fused_blocks_per_sm(int in, int views, int normals) {
  const int r = with_net(in, views, normals, [](auto net) {
    int per_sm = 0;
    const cudaError_t err = blocks_per_sm<decltype(net)>(&per_sm);
    return err == cudaSuccess ? per_sm : -static_cast<int>(err);
  });
  return r == kNoNet ? 0 : r;
}

// raw [n_rows, 7 or 4] of feats [n_rows, in], vf [n_rows / samples, views]
// (no pointer read where views is 0), keep [n_rows] (bytes 0/1) and the
// pack; feats, the pack and out 16-byte aligned.
int nerf_small_fused(const void* feats, const void* vf, const void* keep,
                     const void* pack, void* out, long long n_rows,
                     int samples, int in, int views, int normals,
                     void* stream) {
  if (n_rows < 1 || samples < 1 || n_rows % samples != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(feats);
  const auto* v = static_cast<const float*>(vf);
  const auto* k = static_cast<const uint8_t*>(keep);
  const auto* p = static_cast<const float*>(pack);
  auto* o = static_cast<float*>(out);
  const int r = with_net(in, views, normals, [&](auto net) {
    return launch<decltype(net)>(f, v, k, p, o, n_rows, samples, s);
  });
  return r == kNoNet ? static_cast<int>(cudaErrorInvalidValue) : r;
}

const char* nerf_small_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
