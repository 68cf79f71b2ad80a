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
// outside the kernel.
//
// Design (simple and right first): one warp per query row, WARPS rows per
// block. Wq is staged through shared memory in chunks of TQ rows (so any dq
// fits), K~ (transposed), V~, Wo and bo are staged once per block. Lane l
// owns latent columns {l, l+32} and member columns {l, l+32}, hence d <= 64
// and K <= 64; vectors cross lanes by __shfl_sync, never shared memory. The
// q row is read coalesced, one element per lane, and broadcast by shuffle.
// All arithmetic is fp32 FMA on the CUDA cores (no tensor cores); q may be
// fp32 or bf16. The ragged B edge is masked here: nothing is padded, where
// the TPU version padded d and K to 128 lanes and B to its 256-row tile.
//
// What bounds it: it must move the bytes of q (B x dq) plus about 62 KB of
// weights at d = 20, K = 2..11, and do 2*B*dq*d FMAs. At the engine's batch
// sizes (a few to a few hundred rows) that is well under a microsecond of
// either, so the kernel is launch-latency bound. The design does nothing
// about that yet: wgmma/TMA for large B and CUDA graphs around the scoring
// pass are later work.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (repro_torch/kernels/router_xattn.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;     // query rows per block
constexpr int kTQ = 256;      // rows of Wq staged per chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// One row of Wq into the lane's two qp partial sums: q element s of the
// warp's 32-element tile (held by lane s) times Wq row w[0..d).
__device__ __forceinline__ void fma_row(float qv, int s, const float* w, int lane, int d,
                                        float& p0, float& p1) {
  const float qi = __shfl_sync(kFull, qv, s);
  if (lane < d) p0 = fmaf(qi, w[lane], p0);
  if (lane + 32 < d) p1 = fmaf(qi, w[lane + 32], p1);
}

template <typename T>
__global__ void router_xattn_kernel(const T* __restrict__ q,
                                    const float* __restrict__ wq,
                                    const float* __restrict__ kt,
                                    const float* __restrict__ vt,
                                    const float* __restrict__ wo,
                                    const float* __restrict__ bo,
                                    float* __restrict__ out,
                                    int B, int dq, int d, int K, float scale) {
  extern __shared__ float smem[];
  float* wq_s = smem;                 // kTQ * d   (one chunk of Wq rows)
  float* ktT_s = wq_s + kTQ * d;      // d * K     (K~ transposed: [j*K + k])
  float* vt_s = ktT_s + d * K;        // K * d
  float* wo_s = vt_s + K * d;         // d * K
  float* bo_s = wo_s + d * K;         // K

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = blockIdx.x * kWarps + (tid >> 5);
  const bool live = row < B;          // uniform across a warp

  for (int i = tid; i < K * d; i += blockDim.x) {
    const int k = i / d, j = i - k * d;
    ktT_s[j * K + k] = kt[i];
    vt_s[i] = vt[i];
    wo_s[i] = wo[i];                  // Wo is (d, K): K*d elements too
  }
  for (int i = tid; i < K; i += blockDim.x) bo_s[i] = bo[i];

  // qp = q[row] @ Wq; lane holds qp[lane] in qp0 and qp[lane + 32] in qp1.
  const T* qrow = q + (size_t)(live ? row : 0) * dq;
  float qp0 = 0.f, qp1 = 0.f;
  for (int c0 = 0; c0 < dq; c0 += kTQ) {
    const int rows = min(kTQ, dq - c0);
    __syncthreads();                  // every warp is done with the last chunk
    for (int i = tid; i < rows * d; i += blockDim.x) wq_s[i] = wq[(size_t)c0 * d + i];
    __syncthreads();
    if (live) {
      for (int t = 0; t < rows; t += 32) {
        const float qv = (t + lane < rows) ? to_float(qrow[c0 + t + lane]) : 0.f;
        const int n = min(32, rows - t);
        // A partial sum per 32 rows, then one add: a two-level sum keeps the
        // rounding error near that of a blocked GEMM, where one running sum
        // over all dq rows doubles it at dq = 768.
        float p0 = 0.f, p1 = 0.f;
        const float* w = wq_s + t * d;
        if (n == 32) {                // full tile: unrolled, so the shuffles and
#pragma unroll                        // shared loads issue ahead of the FMA chain
          for (int s = 0; s < 32; ++s) fma_row(qv, s, w + s * d, lane, d, p0, p1);
        } else {
          for (int s = 0; s < n; ++s) fma_row(qv, s, w + s * d, lane, d, p0, p1);
        }
        qp0 += p0;
        qp1 += p1;
      }
    }
  }
  if (!live) return;                  // no block-wide barrier below

  // logits: lane owns members lane and lane + 32.
  float s0 = 0.f, s1 = 0.f;
  for (int j = 0; j < d; ++j) {
    const float qj = __shfl_sync(kFull, j < 32 ? qp0 : qp1, j & 31);
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
  const float a0 = e0 / sum, a1 = e1 / sum;

  // ctx = alpha @ V~: lane owns latent columns lane and lane + 32.
  float c0 = 0.f, c1 = 0.f;
  for (int k = 0; k < K; ++k) {
    const float ak = __shfl_sync(kFull, k < 32 ? a0 : a1, k & 31);
    if (lane < d) c0 = fmaf(ak, vt_s[k * d + lane], c0);
    if (lane + 32 < d) c1 = fmaf(ak, vt_s[k * d + lane + 32], c1);
  }

  // out = ctx @ Wo + bo: lane owns members lane and lane + 32.
  float o0 = 0.f, o1 = 0.f;
  for (int j = 0; j < d; ++j) {
    const float cj = __shfl_sync(kFull, j < 32 ? c0 : c1, j & 31);
    if (lane < K) o0 = fmaf(cj, wo_s[j * K + lane], o0);
    if (lane + 32 < K) o1 = fmaf(cj, wo_s[j * K + lane + 32], o1);
  }
  float* orow = out + (size_t)row * K;
  if (lane < K) orow[lane] = o0 + bo_s[lane];
  if (lane + 32 < K) orow[lane + 32] = o1 + bo_s[lane + 32];
}

template <typename T>
int launch(const void* q, const void* wq, const void* kt, const void* vt,
           const void* wo, const void* bo, void* out, int B, int dq, int d,
           int K, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kTQ * d + 3 * (size_t)K * d + K);
  cudaError_t err = cudaFuncSetAttribute(
      router_xattn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kWarps - 1) / kWarps);
  router_xattn_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(wq),
      static_cast<const float*>(kt), static_cast<const float*>(vt),
      static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(out), B, dq, d, K, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller has
// checked shapes (1 <= d, K <= 64; B, dq >= 1), dtypes and contiguity.
extern "C" int router_xattn_launch(const void* q, int q_is_bf16, const void* wq,
                                   const void* kt, const void* vt, const void* wo,
                                   const void* bo, void* out, int B, int dq, int d,
                                   int K, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_is_bf16)
    return launch<__nv_bfloat16>(q, wq, kt, vt, wo, bo, out, B, dq, d, K, scale, s);
  return launch<float>(q, wq, kt, vt, wo, bo, out, B, dq, d, K, scale, s);
}

extern "C" const char* router_xattn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
