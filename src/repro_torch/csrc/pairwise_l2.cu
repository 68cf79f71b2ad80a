// Pairwise squared L2 distances for Hopper (sm_90a).
//
// Replaces repro/kernels/pairwise_l2.py::_pairwise_l2_kernel (Pallas, TPU):
//     out[n, k] = max(||x_n||^2 - 2 x_n . c_k + ||c_k||^2, 0)
// for x (N, D), c (K, D), each fp32 or bf16 (converted to fp32 at load);
// out (N, K) fp32. Norms are taken in the kernel, so the only device-memory
// traffic is the two operands and the output.
//
// Design (simple and right first): one block of 256 threads per 64 x 64
// output tile, grid (ceil(K/64), ceil(N/64)). The block walks D in slices
// of 32: it stages the slice of its 64 x rows and its 64 c rows in shared
// memory, transposed ([d][row]) and padded to 65 columns, so the coalesced
// global loads store without bank conflicts. Thread (tx, ty) owns rows
// ty + 16 i and columns tx + 16 j (i, j < 4): 4 x 4 outputs, read from
// shared memory without conflicts. The cross term is a chain of fp32 FMAs
// on the CUDA cores: no TF32, no tensor cores, so it holds the plain
// version's 1e-4. The ragged N, K and D edges are masked here; nothing is
// padded, where the TPU version padded N and K to 256-row tiles.
//
// The squared norms come from the same shared slices, in the same order
// and with the same fmaf chain as the cross term. Identical rows of x and
// c therefore give x2 == cross == c2 bit for bit, and the epilogue
// x2 - 2 cross + c2 cancels to exactly 0.0: the semantic cache serves an
// exact repeat at distance 0. (Each of the 16 threads that share a row
// recomputes its norm: 8 FMAs beside the 16 of the cross term per step.)
//
// What bounds it: at the serving path's shapes (D = 768; 512 x 512 for the
// radius calibration, 64 x 4096 for a deployment-size cache lookup, 900 x
// 20 and 48 x 20 for the drift detector) the fp32 operations bound the
// large calls at about 6 us and the bytes the small ones below 1 us; in
// practice every call is bound by launch latency. The design does nothing
// about that yet: wgmma/TMA tiles (at a precision that keeps the tolerance)
// and CUDA graphs around the lookups are a later PR's work.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (repro_torch/kernels/pairwise_l2.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output rows and columns per block
constexpr int kSlice = 32;     // feature columns staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPitch = kTile + 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage rows [r0, r0 + 64) x columns [d0, d0 + 32) of a (rows, D) matrix into
// dst[d][row], zero outside the matrix. Consecutive threads read consecutive
// columns of one row (coalesced) and store to consecutive banks (pitch 65).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int rows, int D,
                                      int r0, int d0, float (*dst)[kPitch]) {
  for (int i = threadIdx.x; i < kTile * kSlice; i += kThreads) {
    const int r = i / kSlice, dd = i - r * kSlice;
    const int gr = r0 + r, gd = d0 + dd;
    dst[dd][r] = (gr < rows && gd < D) ? to_float(src[(size_t)gr * D + gd]) : 0.f;
  }
}

template <typename TX, typename TC>
__global__ void __launch_bounds__(kThreads)
pairwise_l2_kernel(const TX* __restrict__ x, const TC* __restrict__ c,
                   float* __restrict__ out, int N, int K, int D) {
  __shared__ float xs[kSlice][kPitch];
  __shared__ float cs[kSlice][kPitch];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.y * kTile, k0 = blockIdx.x * kTile;

  float acc[4][4], xn[4], cn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xn[i] = 0.f;
    cn[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int d0 = 0; d0 < D; d0 += kSlice) {
    stage(x, N, D, n0, d0, xs);
    stage(c, K, D, k0, d0, cs);
    __syncthreads();
    const int len = min(kSlice, D - d0);
    for (int dd = 0; dd < len; ++dd) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[dd][ty + 16 * i];
        b[i] = cs[dd][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xn[i] = fmaf(a[i], a[i], xn[i]);
        cn[i] = fmaf(b[i], b[i], cn[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();   // every thread is done with the slice before the next stage
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < K) out[(size_t)n * K + k] = fmaxf(xn[i] - 2.f * acc[i][j] + cn[j], 0.f);
    }
  }
}

template <typename TX, typename TC>
int launch(const void* x, const void* c, void* out, int N, int K, int D,
           cudaStream_t stream) {
  const dim3 grid((K + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  pairwise_l2_kernel<TX, TC><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TC*>(c), static_cast<float*>(out),
      N, K, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller has
// checked shapes (N, K >= 1, N / 64 < 65536), dtypes and contiguity.
extern "C" int pairwise_l2_launch(const void* x, int x_is_bf16, const void* c,
                                  int c_is_bf16, void* out, int N, int K, int D,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    if (c_is_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(x, c, out, N, K, D, s);
    return launch<__nv_bfloat16, float>(x, c, out, N, K, D, s);
  }
  if (c_is_bf16) return launch<float, __nv_bfloat16>(x, c, out, N, K, D, s);
  return launch<float, float>(x, c, out, N, K, D, s);
}

extern "C" const char* pairwise_l2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
