// Pairwise squared L2 distances for Hopper (sm_90a).
//
// Replaces repro/kernels/pairwise_l2.py::_pairwise_l2_kernel (Pallas, TPU):
//     out[n, k] = max(||x_n||^2 - 2 x_n . c_k + ||c_k||^2, 0)
// for x (N, D), c (K, D), each fp32 or bf16 (converted to fp32 in shared
// memory); out (N, K) fp32. Norms are taken in the kernel, so the only
// device-memory traffic is the two operands and the output.
//
// What bounds it on an H100: at the serving path's shapes (D = 768; 512 x
// 512 for the radius calibration and 64 x 4096 for a deployment-size cache
// lookup: ~6 us of fp32 operations; 900 x 20 and 48 x 20 for the drift
// detector: below 1 us of bytes) every call is one wave of 64 x 64 output
// tiles or less, so one block's walk over its features is the time: per
// slice of 32, a barrier and 32 steps of FMAs on the SM's 8 warps, with the
// next slice's loads, which the double buffer overlaps only in part; then a
// fixed cost for the launch, the cluster barriers and the reduction. One
// block of 8 warps per SM is few to hide the shared loads' latency behind
// the FMAs; more warps per SM, or a larger output tile per thread, is the
// next step.
//
// Design:
//   - Split D over the S blocks of a thread-block cluster. Grid
//     (S * ceil(K / 64), ceil(N / 64)), clusters (S, 1, 1): the S consecutive
//     blocks along x share one 64 x 64 output tile, and rank s walks slices
//     [s * spr, (s + 1) * spr) of 32 features. kernels/pairwise_l2.py::plan
//     picks S <= 8 (and <= ceil(D / 32)) so that tiles x S is about one wave
//     of 132 SMs.
//   - Double-buffered slices, one barrier per slice: slice i + 1 is staged
//     into the other buffer while slice i is computed. fp32 rows go by
//     cp.async, 16-byte copies when the rows are 16-byte aligned (D % 4 == 0)
//     and 4-byte copies otherwise; bf16 rows (2-byte elements, which cp.async
//     cannot move alone) are loaded into registers before the compute of
//     slice i and stored, converted, after it. Rows are staged [row][feature]
//     with a pitch of 36 floats and read as float4 along the features.
//     Features past D and rows past N or K are staged as zeros.
//   - 256 threads, 16 x 16, each with 4 x 4 outputs (rows ty + 16 i,
//     columns tx + 16 j); a step of 4 features is 8 float4 shared loads
//     (broadcast or conflict-free) for 64 FMAs. fp32 FMAs on the CUDA
//     cores, no TF32, no tensor cores: the plain version's 1e-4 holds.
//   - Norms once: thread t < 64 takes x row t's partial norm and thread
//     64 + t c row t's, from the same staged floats, not in the 16 threads
//     that share a row.
//   - Every rank publishes its partial cross tile and norms in its staging
//     buffers (reused). After a cluster barrier, rank r reduces 64 / S rows
//     of the tile over the ranks through distributed shared memory, in rank
//     order 0, 1, ..., S-1, and writes max(x2 - 2 cross + c2, 0) for them:
//     the reduction and the stores are spread over the S SMs. A second
//     cluster barrier keeps every block alive until the others have read it.
//
// Exact zeros. The semantic cache serves an exact repeat at distance 0 only
// if x2 - 2 cross + c2 cancels. Within a rank, the cross term of (n, k) and
// the norms of x_n and c_k are each one chain acc = fmaf(a_f, b_f, acc) from
// 0 over the rank's features in the same order, read from the same staged
// floats (zeros past D add exactly 0). For identical rows the three chains
// are one float bit for bit; each of the three is then summed from 0 over
// the ranks in the same order, so x2 == cross == c2 == v; then v - 2v = -v
// exactly and -v + v = 0.
//
// Shared bytes and cluster size at the path's shapes: 37,376 bytes (static)
// per block at every shape; drift window 48 x 20: S = 8, 8 blocks; drift fit
// 900 x 20: S = 8, 120 blocks; calibrate 512 x 512 and match 64 x 4096:
// S = 2, 128 blocks.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (repro_torch/kernels/pairwise_l2.py), which plans the
// launch and checks operands.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;      // output rows and columns per block
constexpr int kSlice = 32;     // features staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPitch = 36;     // floats per staged row: 16-byte rows, no bank conflicts
constexpr int kRedPitch = 80;  // floats per row of a partial cross tile: no bank conflicts
constexpr int kPer = kTile * kSlice / kThreads;  // staged elements per thread
constexpr int kMaxCluster = 8;  // the portable cluster size

typedef float Slab[kTile][kPitch];

// Stage rows [r0, r0 + 64) x features [d0, d0 + 32) of a (rows, D) matrix
// into dst[row][feature], zeros outside the matrix: issue() starts the
// loads, finish() completes the stores (after the compute of the slice
// before).
template <typename T>
struct Stager;

template <>
struct Stager<float> {         // cp.async: issue() is all, finish() nothing
  bool vec;                    // rows 16-byte aligned: 16-byte copies
  __device__ void issue(const float* __restrict__ src, int rows, int D, int r0, int d0,
                        Slab& dst) {
    if (vec) {
      for (int e = threadIdx.x; e < kTile * kSlice / 4; e += kThreads) {
        const int r = e >> 3, f = (e & 7) * 4;
        const bool ok = r0 + r < rows && d0 + f < D;
        async_copy::copy16(&dst[r][f], ok ? src + (size_t)(r0 + r) * D + d0 + f : src, ok);
      }
    } else {
      for (int e = threadIdx.x; e < kTile * kSlice; e += kThreads) {
        const int r = e >> 5, f = e & 31;
        const bool ok = r0 + r < rows && d0 + f < D;
        async_copy::copy4(&dst[r][f], ok ? src + (size_t)(r0 + r) * D + d0 + f : src, ok);
      }
    }
  }
  __device__ void finish(Slab&) {}
};

template <>
struct Stager<__nv_bfloat16> {  // loads into registers, converted at finish()
  bool vec;                     // unused: bf16 always takes this path
  __nv_bfloat16 v[kPer];
  __device__ void issue(const __nv_bfloat16* __restrict__ src, int rows, int D, int r0,
                        int d0, Slab&) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = threadIdx.x + m * kThreads;
      const int r = e >> 5, f = e & 31;
      v[m] = (r0 + r < rows && d0 + f < D) ? src[(size_t)(r0 + r) * D + d0 + f]
                                           : __float2bfloat16(0.f);
    }
  }
  __device__ void finish(Slab& dst) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = threadIdx.x + m * kThreads;
      dst[e >> 5][e & 31] = __bfloat162float(v[m]);
    }
  }
};

// One step of 4 features into the thread's 4 x 4 outputs, in feature order
// x, y, z, w within each output's chain.
__device__ __forceinline__ void fma_step(float (&acc)[4][4], const float4 (&a)[4],
                                         const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
}

__device__ __forceinline__ float norm_step(const float* row, float acc) {
  const float4 v = *reinterpret_cast<const float4*>(row);
  acc = fmaf(v.x, v.x, acc);
  acc = fmaf(v.y, v.y, acc);
  acc = fmaf(v.z, v.z, acc);
  return fmaf(v.w, v.w, acc);
}

template <typename TX, typename TC>
__global__ void __launch_bounds__(kThreads)
pairwise_l2_kernel(const TX* __restrict__ x, const TC* __restrict__ c,
                   float* __restrict__ out, int N, int K, int D, int spr,
                   int x_vec, int c_vec) {
  __shared__ __align__(16) float stage[2][2][kTile][kPitch];  // [buffer][x | c]
  __shared__ float x2s[kTile], c2s[kTile];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // rows ty + 16 i, columns tx + 16 j
  const int k0 = (blockIdx.x / S) * kTile, n0 = blockIdx.y * kTile;
  const int s_lo = rank * spr;
  const int s_hi = min((D + kSlice - 1) / kSlice, s_lo + spr);

  float acc[4][4], nrm = 0.f;  // cross terms; norm of x row tid or c row tid - 64
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  Stager<TX> sx;
  Stager<TC> sc;
  sx.vec = x_vec;
  sc.vec = c_vec;
  if (s_lo < s_hi) {
    sx.issue(x, N, D, n0, s_lo * kSlice, stage[0][0]);
    sc.issue(c, K, D, k0, s_lo * kSlice, stage[0][1]);
    sx.finish(stage[0][0]);
    sc.finish(stage[0][1]);
    async_copy::commit();
  }
  for (int s = s_lo; s < s_hi; ++s) {
    const int buf = (s - s_lo) & 1;
    async_copy::wait_all();   // this thread's copies of slice s have landed
    __syncthreads();          // ... everyone's; and slice s - 1's buffer is free
    const bool more = s + 1 < s_hi;
    if (more) {
      sx.issue(x, N, D, n0, (s + 1) * kSlice, stage[buf ^ 1][0]);
      sc.issue(c, K, D, k0, (s + 1) * kSlice, stage[buf ^ 1][1]);
      async_copy::commit();
    }
    const Slab& xs = stage[buf][0];
    const Slab& cs = stage[buf][1];
#pragma unroll
    for (int f = 0; f < kSlice; f += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&xs[ty + 16 * i][f]);
        b[i] = *reinterpret_cast<const float4*>(&cs[tx + 16 * i][f]);
      }
      fma_step(acc, a, b);
      if (tid < 2 * kTile)    // warps 0-3: one row's norm each
        nrm = norm_step(tid < kTile ? &xs[tid][f] : &cs[tid - kTile][f], nrm);
    }
    if (more) {
      sx.finish(stage[buf ^ 1][0]);
      sc.finish(stage[buf ^ 1][1]);
    }
  }

  // Every rank publishes its partials in its staging buffers (reused).
  // Rank r then reduces rows [r * per, (r + 1) * per) of the tile over the
  // ranks and writes them: each of cross, x2 and c2 summed from 0 over
  // ranks 0, 1, ..., S-1 in that order.
  __syncthreads();            // every thread is done reading the slices
  float* red = &stage[0][0][0][0];
  float* red_nrm = red + kTile * kRedPitch;   // x norms, then c norms
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(ty + 16 * i) * kRedPitch + tx + 16 * j] = acc[i][j];
  if (tid < 2 * kTile) red_nrm[tid] = nrm;
  cluster.sync();             // every rank's partials are visible cluster-wide

  const float* part[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    part[r] = r < S ? cluster.map_shared_rank(red, r) : red;
  const int per = (kTile + S - 1) / S;
  const int row_lo = rank * per, rows = max(0, min(kTile, row_lo + per) - row_lo);
  if (tid < kTile + rows) {   // c2 of every column, x2 of this rank's rows
    const int at = tid < kTile ? kTile * kRedPitch + kTile + tid
                               : kTile * kRedPitch + row_lo + tid - kTile;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < S) v += part[r][at];
    if (tid < kTile) c2s[tid] = v;
    else x2s[row_lo + tid - kTile] = v;
  }
  __syncthreads();
  for (int e = tid; e < rows * kTile; e += kThreads) {
    const int row = row_lo + e / kTile, col = e % kTile;
    const int n = n0 + row, k = k0 + col;
    if (n >= N || k >= K) continue;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < S) v += part[r][row * kRedPitch + col];
    out[(size_t)n * K + k] = fmaxf(x2s[row] - 2.f * v + c2s[col], 0.f);
  }
  cluster.sync();             // no block exits while another may read it
}

template <typename TX, typename TC>
int launch(const void* x, const void* c, void* out, int N, int K, int D, int cluster,
           int spr, cudaStream_t stream) {
  const int x_vec = sizeof(TX) == 4 && D % 4 == 0 && async_copy::aligned16(x);
  const int c_vec = sizeof(TC) == 4 && D % 4 == 0 && async_copy::aligned16(c);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((K + kTile - 1) / kTile), (N + kTile - 1) / kTile);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pairwise_l2_kernel<TX, TC>, static_cast<const TX*>(x),
      static_cast<const TC*>(c), static_cast<float*>(out), N, K, D, spr, x_vec, c_vec);
  const cudaError_t last = cudaGetLastError();   // read, and so cleared: a refused
  return (int)(err != cudaSuccess ? err : last);  // launch does not resurface later
}

}  // namespace

// Returns the launch's error code (0 on success). The caller has checked
// shapes (N, K, D >= 1; ceil(N / 64) <= 65535), dtypes and contiguity, and
// planned the cluster size (1..8) and the slices of 32 features per rank.
extern "C" int pairwise_l2_launch(const void* x, int x_is_bf16, const void* c,
                                  int c_is_bf16, void* out, int N, int K, int D,
                                  int cluster, int spr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    if (c_is_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, c, out, N, K, D, cluster, spr, s);
    return launch<__nv_bfloat16, float>(x, c, out, N, K, D, cluster, spr, s);
  }
  if (c_is_bf16) return launch<float, __nv_bfloat16>(x, c, out, N, K, D, cluster, spr, s);
  return launch<float, float>(x, c, out, N, K, D, cluster, spr, s);
}

extern "C" const char* pairwise_l2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
