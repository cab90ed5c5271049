// Cholesky factor and triangular inverse of a batch of SPD f32 blocks.
//
// Replaces gsum_tpu/ops/pallas_chol.py::_make_kernel (reached through
// chol_inv_block): for each (nb, nb) SPD block A it writes the lower factor
// L (A = L L^T) and M = L^{-1}, both with explicit zeros above the diagonal.
// nb is a multiple of 32 and at most 512; the Python wrapper checks that.
//
// Design.  One thread block per matrix runs the column loop of
// chol_inv_block.cuh (shared with the fused blocked Cholesky, fused_chol.cu),
// which says how L and L^{-1} come out of one right-looking elimination.
// When both working matrices fit in shared memory (nb <= 160 on Hopper's
// 227 KB) they live there with a row stride of nb + 1, so the column reads of
// the pivot step do not conflict on a bank, and are copied out at the end.
// Larger blocks work in place in the outputs in global memory, which stay
// L2-resident at these sizes.  Accumulation is f32 throughout; no TF32 and
// no tensor cores.  A non-positive pivot puts NaN or 0 on the factor's
// diagonal, as the .cuh says.
//
// What bounds it: at the pipeline's headline size (16 blocks of 128) only 16
// thread blocks run on 132 SMs, and each walks nb columns in order, so the
// kernel is bound by the latency of that per-column chain (two barriers and a
// short parallel update per column), not by bytes or FLOPs.  Blocks from
// global memory (nb >= 192) are bound by L2 traffic instead.  Making it fast -
// several thread blocks per matrix, wgmma panels, or the fused whole-
// factorization kernel of gsum_tpu/ops/fusedchol.py - is later work.
//
// The host entry launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "chol_inv_block.cuh"

namespace {

constexpr int kThreads = 1024;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    chol_inv_block_kernel(const float* __restrict__ A, float* L, float* Minv,
                          int nb) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * nb * nb;
  const int ld = kStaged ? nb + 1 : nb;
  float* col = smem;
  float* W = kStaged ? smem + nb : L + off;
  float* M = kStaged ? smem + nb + nb * ld : Minv + off;

  // W = lower triangle of A, M = I; the strict upper triangles stay zero.
  for (int e = tid; e < nb * nb; e += blockDim.x) {
    const int i = e / nb;
    const int k = e - i * nb;
    W[i * ld + k] = k <= i ? A[off + e] : 0.f;
    M[i * ld + k] = k == i ? 1.f : 0.f;
  }
  __syncthreads();

  chol_inv_columns(W, ld, M, ld, col, nb);

  if (kStaged) {
    for (int e = tid; e < nb * nb; e += blockDim.x) {
      const int i = e / nb;
      const int k = e - i * nb;
      L[off + e] = W[i * ld + k];
      Minv[off + e] = M[i * ld + k];
    }
  }
}

}  // namespace

extern "C" int gsum_chol_inv_block_f32(const float* A, float* L, float* Minv,
                                       int batch, int nb, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t staged_bytes =
      (static_cast<size_t>(nb) + 2u * nb * (nb + 1u)) * sizeof(float);
  if (staged_bytes <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(chol_inv_block_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(staged_bytes));
    if (err != cudaSuccess) return err;
    chol_inv_block_kernel<true><<<batch, kThreads, staged_bytes, s>>>(
        A, L, Minv, nb);
  } else {
    chol_inv_block_kernel<false><<<batch, kThreads, nb * sizeof(float), s>>>(
        A, L, Minv, nb);
  }
  return cudaGetLastError();
}

extern "C" const char* gsum_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
