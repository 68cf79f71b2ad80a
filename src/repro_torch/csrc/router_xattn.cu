// Fused single-head cross-attention routing scores for Hopper (sm_90a).
//
// Replaces repro/kernels/router_xattn.py::_router_xattn_kernel (Pallas, TPU).
// Per query row b:
//     qp     = q[b] @ Wq                      (dq -> d)
//     logits = qp @ K~^T * scale              (scale = 1/sqrt(d), d unpadded)
//     alpha  = softmax over the K members
//     ctx    = alpha @ V~
//     out[b] = ctx @ Wo + bo                  ((K,) fp32)
// K~ = m_emb @ Wk and V~ = m_emb @ Wv are per-pool constants computed
// outside the kernel. q is fp32 or bf16; everything else fp32.
//
// What bounds it on an H100: at the serving path's shapes (B = 8 per serve,
// up to 64 per trace batch, 256 in the timing sweep; dq = 768, d = 20,
// K = 2) the work is 2*B*dq*d FMAs and ~62 KB of Wq plus B*dq of q: well
// under a microsecond of either bytes or operations. So the kernel is bound
// by latency: the length of the dependent chain each block walks, its
// barriers, and the launch itself.
//
// Design: split dq over the S blocks of a thread-block cluster.
//   - Grid (S * ceil(B / R)) blocks of 32 * R threads; the S consecutive
//     blocks of a cluster share a tile of R query rows (R = 4). Rank s owns
//     rows [s * slice, (s + 1) * slice) of Wq, slice a multiple of 32 chosen
//     by kernels/router_xattn.py::plan (96 rows at dq = 768, S = 8), and
//     walks them in chunks of at most `chunk` rows (256): the chunk of Wq
//     and the R rows' matching q slices by cp.async (bf16 q through
//     registers), and on rank 0 the epilogue operands, all in flight
//     before one wait and one barrier; then the partial qp (R x d).
//   - Each work item is one 32-row tile of Wq for one qp item (r, j): a
//     chain of at most 32 FMAs whose operands are independent shared loads,
//     so the loads issue ahead of the chain (3 tiles x R x d = 240 items on
//     128 threads at the path's shape). The tile sums are then added in tile
//     order: a blocked sum, which holds the 1e-5 against cuBLAS where one
//     running sum over dq = 768 products erred 1.46e-05. Tiles are aligned
//     to global 32-row boundaries, so the split does not change them.
//   - Ranks 1..S-1 store their partials into rank 0's shared memory
//     (distributed shared memory) and exit; rank 0 adds them in rank order
//     0, 1, ..., S-1 (deterministic). Only rank 0's shared memory is
//     accessed across blocks, and it exits last, after the cluster barrier
//     that the stores release and it waits on. The barrier's first phase is
//     arrived at on entry (relaxed) and waited on just before the first
//     remote store, so every block is known to run by then without a full
//     barrier; one full barrier, not two, is paid.
//   - Rank 0 alone runs the epilogue, one warp per row: lane l owns members
//     {l, l+32} for the logits and the output and latent columns {l, l+32}
//     for the context (d, K <= 64), and reads the vector it contracts (qp,
//     alpha, ctx) from shared memory, so those loads too issue ahead of the
//     FMA chains; the softmax's max and sum go by shuffle. K~ (transposed),
//     V~, Wo and bo are staged by rank 0 only.
//   All arithmetic is fp32 FMA on the CUDA cores (no tensor cores, no TF32).
//   Any dq >= 1 works: a rank whose slice lies past dq contributes 0.
//   Nothing is padded: rows past B compute on zeros and are not stored.
//
// Shared bytes and cluster size at the path's shapes (dq = 768, d = 20,
// K = 2): S = 8, R = 4, slice = chunk = 96 rows, 14,264 bytes per block;
// B = 8: 2 clusters, 16 blocks of 128 threads; B = 64: 128 blocks;
// B = 256: 512 blocks.
//
// The launch is lean on the host as well: the shared-memory cap is raised
// once per instance and device, not per call; the wrapper checks its six
// operands in one pass and enters no device context when q's device is
// current.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (repro_torch/kernels/router_xattn.py), which plans the
// launch and checks operands.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The cluster barrier in its two halves (every thread of every block).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// dst[0 .. count) = src[0 .. count) by cp.async: 16-byte copies where both
// ends are 16-byte aligned, 4-byte copies otherwise and for the tail.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int count) {
  int head = 0;
  if (async_copy::aligned16(src) && async_copy::aligned16(dst)) {
    head = count & ~3;
    for (int i = 4 * threadIdx.x; i < head; i += 4 * blockDim.x)
      async_copy::copy16(dst + i, src + i, true);
  }
  for (int i = head + threadIdx.x; i < count; i += blockDim.x)
    async_copy::copy4(dst + i, src + i, true);
}

// The R query rows' slice [c0, c0 + n) into q_s[r * qpitch + i], zeros for
// rows past B, without waiting on any load. fp32 by cp.async (4-byte
// copies: rows of any width); bf16 (2-byte elements, which cp.async cannot
// move alone) by loads into registers, all issued before the first value
// is converted and stored.
__device__ __forceinline__ void stage_q(const float* q, float* q_s, int R, int n, int qpitch,
                                        int row0, int B, int dq, int c0) {
  for (int e = threadIdx.x; e < R * n; e += blockDim.x) {
    const int r = e / n, i = e - r * n;
    const bool ok = row0 + r < B;
    async_copy::copy4(q_s + r * qpitch + i, ok ? q + (size_t)(row0 + r) * dq + c0 + i : q, ok);
  }
}

constexpr int kMaxQPerThread = 8;     // R * chunk / (32 * R) with chunk <= 256

__device__ __forceinline__ void stage_q(const __nv_bfloat16* q, float* q_s, int R, int n,
                                        int qpitch, int row0, int B, int dq, int c0) {
  __nv_bfloat16 v[kMaxQPerThread];
#pragma unroll
  for (int m = 0; m < kMaxQPerThread; ++m) {
    const int e = threadIdx.x + m * blockDim.x;
    const int r = e / n, i = e - r * n;
    v[m] = (e < R * n && row0 + r < B) ? q[(size_t)(row0 + r) * dq + c0 + i]
                                       : __float2bfloat16(0.f);
  }
#pragma unroll
  for (int m = 0; m < kMaxQPerThread; ++m) {
    const int e = threadIdx.x + m * blockDim.x;
    if (e < R * n) q_s[(e / n) * qpitch + e % n] = __bfloat162float(v[m]);
  }
}

template <typename T>
__global__ void router_xattn_kernel(const T* __restrict__ q,
                                    const float* __restrict__ wq,
                                    const float* __restrict__ kt,
                                    const float* __restrict__ vt,
                                    const float* __restrict__ wo,
                                    const float* __restrict__ bo,
                                    float* __restrict__ out,
                                    int B, int dq, int d, int K, float scale,
                                    int slice, int chunk) {
  extern __shared__ float4 smem4[];   // 16-byte aligned for cp.async
  const int R = blockDim.x >> 5;      // query rows per tile, one warp each
  const int qpitch = chunk + 1;       // rows r, r+1 of q_s on different banks
  const int tiles = chunk / 32;       // 32-row tiles of Wq per chunk
  float* wq_s = reinterpret_cast<float*>(smem4);  // chunk * d
  float* q_s = wq_s + chunk * d;                  // R * qpitch
  float* tile_s = q_s + R * qpitch;               // tiles * R * d tile sums
  float* part_s = tile_s + tiles * R * d;         // R * d partial qp
  float* ktT_s = part_s + R * d;                  // d * K  (K~ transposed)
  float* vt_s = ktT_s + d * K;                    // K * d
  float* wo_s = vt_s + K * d;                     // d * K
  float* bo_s = wo_s + d * K;                     // K
  float* vec_s = bo_s + K;                        // R * 64: alpha, then ctx
  float* recv_s = vec_s + R * 64;                 // (S - 1) * R * d: ranks' partials

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();           // this block runs: phase 1, waited for later
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / S) * R;
  const int tid = threadIdx.x;

  if (rank == 0) {                    // epilogue operands: in flight during the walk
    for (int i = tid; i < K * d; i += blockDim.x) {
      const int k = i / d, j = i - k * d;
      async_copy::copy4(ktT_s + j * K + k, kt + i, true);
      async_copy::copy4(vt_s + i, vt + i, true);
      async_copy::copy4(wo_s + i, wo + i, true);  // Wo is (d, K): K*d elements too
    }
    for (int i = tid; i < K; i += blockDim.x) async_copy::copy4(bo_s + i, bo + i, true);
  }
  for (int i = tid; i < R * d; i += blockDim.x) part_s[i] = 0.f;

  const int lo = rank * slice;
  const int hi = min(dq, lo + slice);
  for (int c0 = lo; c0 < hi; c0 += chunk) {
    const int n = min(chunk, hi - c0);
    const int nt = (n + 31) / 32;
    if (c0 != lo) __syncthreads();    // every thread is done with the last chunk
    copy_async(wq_s, wq + (size_t)c0 * d, n * d);
    stage_q(q, q_s, R, n, qpitch, row0, B, dq, c0);
    async_copy::wait_all();
    __syncthreads();
    // One 32-row tile of one qp item per work item: a chain of at most 32
    // FMAs whose operands are all independent loads.
    for (int it = tid; it < nt * R * d; it += blockDim.x) {
      const int t = it / (R * d), rj = it - t * R * d;
      const int r = rj / d, j = rj - r * d;
      const float* qr = q_s + r * qpitch + 32 * t;
      const float* w = wq_s + 32 * t * d + j;
      float p = 0.f;
      if (32 * t + 32 <= n) {
#pragma unroll
        for (int s = 0; s < 32; ++s) p = fmaf(qr[s], w[s * d], p);
      } else {
        for (int s = 0; s < n - 32 * t; ++s) p = fmaf(qr[s], w[s * d], p);
      }
      tile_s[it] = p;
    }
    __syncthreads();
    // The tile sums added in tile order: a blocked sum.
    for (int rj = tid; rj < R * d; rj += blockDim.x) {
      float acc = part_s[rj];
      for (int t = 0; t < nt; ++t) acc += tile_s[t * R * d + rj];
      part_s[rj] = acc;
    }
  }

  // Ranks 1..S-1 store their partials into rank 0's recv_s and leave; rank
  // 0 waits for them and adds them in rank order. Only rank 0's shared
  // memory is accessed across blocks, and rank 0 exits last. The relaxed
  // arrive at entry, waited for here, guarantees every block of the
  // cluster is running before the first remote store.
  async_copy::wait_all();             // the epilogue operands, if no chunk waited
  cluster_wait();
  if (rank != 0) {
    float* dst = cluster.map_shared_rank(recv_s, 0) + (rank - 1) * R * d;
    for (int it = tid; it < R * d; it += blockDim.x) dst[it] = part_s[it];
  }
  cluster_arrive_release();
  if (rank != 0) return;
  cluster_wait();                     // every rank's partial is in recv_s
  for (int it = tid; it < R * d; it += blockDim.x) {
    float v = part_s[it];
    for (int s = 1; s < S; ++s) v += recv_s[(s - 1) * R * d + it];
    part_s[it] = v;
  }
  __syncthreads();

  // Epilogue, one warp per row: lane l owns members {l, l+32} for the
  // logits and the output and latent columns {l, l+32} for the context;
  // each reads the vector it contracts from shared memory (broadcast).
  const int lane = tid & 31, w = tid >> 5;
  const int row = row0 + w;
  if (row >= B) return;               // no block-wide barrier below
  const float* qp = part_s + w * d;
  float* vec = vec_s + w * 64;

  float s0 = 0.f, s1 = 0.f;           // logits
#pragma unroll 16
  for (int j = 0; j < d; ++j) {
    const float qj = qp[j];
    if (lane < K) s0 = fmaf(qj, ktT_s[j * K + lane], s0);
    if (lane + 32 < K) s1 = fmaf(qj, ktT_s[j * K + lane + 32], s1);
  }
  const float l0 = lane < K ? s0 * scale : -INFINITY;
  const float l1 = lane + 32 < K ? s1 * scale : -INFINITY;
  float m = fmaxf(l0, l1);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  const float e0 = lane < K ? expf(l0 - m) : 0.f;
  const float e1 = lane + 32 < K ? expf(l1 - m) : 0.f;
  float sum = e0 + e1;
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  vec[lane] = e0 / sum;               // alpha
  vec[lane + 32] = e1 / sum;
  __syncwarp();

  float c0 = 0.f, c1 = 0.f;           // ctx = alpha @ V~
#pragma unroll 16
  for (int k = 0; k < K; ++k) {
    const float ak = vec[k];
    if (lane < d) c0 = fmaf(ak, vt_s[k * d + lane], c0);
    if (lane + 32 < d) c1 = fmaf(ak, vt_s[k * d + lane + 32], c1);
  }
  __syncwarp();                       // every lane has read alpha
  vec[lane] = c0;
  vec[lane + 32] = c1;
  __syncwarp();

  float o0 = 0.f, o1 = 0.f;           // out = ctx @ Wo + bo
#pragma unroll 16
  for (int j = 0; j < d; ++j) {
    const float cj = vec[j];
    if (lane < K) o0 = fmaf(cj, wo_s[j * K + lane], o0);
    if (lane + 32 < K) o1 = fmaf(cj, wo_s[j * K + lane + 32], o1);
  }
  float* orow = out + (size_t)row * K;
  if (lane < K) orow[lane] = o0 + bo_s[lane];
  if (lane + 32 < K) orow[lane + 32] = o1 + bo_s[lane + 32];
}

constexpr int kMaxDevices = 64;

// A launch's error code, with the thread's last-error state read and so
// cleared: a refused call must not show up again after the next good one.
int launch_error(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// Raise the instance's dynamic shared-memory cap to the card's per-block
// limit, once per device: the first launch there pays for the call, every
// later one only for cudaGetDevice. A plan above the limit is then refused
// by the launch itself. A failed raise is not remembered, so the next
// launch tries again and fails again.
template <typename T>
cudaError_t raise_smem_cap() {
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && raised[dev])) return err;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(router_xattn_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return err;
}

template <typename T>
int launch(const void* q, const void* wq, const void* kt, const void* vt,
           const void* wo, const void* bo, void* out, int B, int dq, int d, int K,
           float scale, int cluster, int rows, int slice, int chunk, int smem,
           cudaStream_t stream) {
  if (chunk < 32 || chunk % 32 != 0 || chunk > 32 * kMaxQPerThread || slice % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t raised = raise_smem_cap<T>();
  if (raised != cudaSuccess) return launch_error(raised);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((B + rows - 1) / rows));
  cfg.blockDim = dim3(32 * rows);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, router_xattn_kernel<T>, static_cast<const T*>(q),
      static_cast<const float*>(wq), static_cast<const float*>(kt),
      static_cast<const float*>(vt), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<float*>(out), B, dq, d, K, scale,
      slice, chunk);
  return launch_error(err);
}

}  // namespace

// Returns the launch's error code (0 on success). The caller has checked
// shapes (1 <= d, K <= 64; B, dq >= 1), dtypes and contiguity, and planned
// cluster (1..8), rows per tile, slice, chunk and shared bytes.
extern "C" int router_xattn_launch(const void* q, int q_is_bf16, const void* wq,
                                   const void* kt, const void* vt, const void* wo,
                                   const void* bo, void* out, int B, int dq, int d,
                                   int K, float scale, int cluster, int rows, int slice,
                                   int chunk, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_is_bf16)
    return launch<__nv_bfloat16>(q, wq, kt, vt, wo, bo, out, B, dq, d, K, scale, cluster,
                                 rows, slice, chunk, smem, s);
  return launch<float>(q, wq, kt, vt, wo, bo, out, B, dq, d, K, scale, cluster, rows,
                       slice, chunk, smem, s);
}

extern "C" const char* router_xattn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
