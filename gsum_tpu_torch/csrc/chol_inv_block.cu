// Cholesky factor and triangular inverse of a batch of SPD f32 blocks.
//
// Replaces gsum_tpu/ops/pallas_chol.py::_make_kernel (reached through
// chol_inv_block): for each (nb, nb) SPD block A it writes the lower factor
// L (A = L L^T) and M = L^{-1}, both with explicit zeros above the diagonal.
// nb is a multiple of 32 and at most 512; the Python wrapper checks that.
//
// What bounds it: at the pipeline's shape, (16, 128, 128), the work is
// 2 nb^3 / 3 flops and 2.5 MiB per launch, under a microsecond of the card's
// rates, so neither bytes nor FFMAs bound it: the chain of dependent steps
// of one factorization does, on 16 of the 132 SMs.  A loop over columns pays
// two block barriers and a shared-memory round trip for each of them.
//
// Design.  One thread block of 256 threads per matrix runs the panel-blocked
// routine of chol_inv_block.cuh (shared with the fused blocked Cholesky,
// fused_chol.cu): the serial column steps run inside 32-wide panels in one
// warp's registers, with shuffles and no block barrier, and the work across
// panels is 32 x 32 warp-tile products, two block barriers per panel.  When
// both working matrices fit in shared memory (nb <= 160 on Hopper's 227 KB)
// they live there with a row stride of nb + 1, so the products' loads do not
// conflict on a bank, and are copied out at the end.  Larger blocks work in
// place in the outputs in global memory (L2-resident at these sizes), and
// each panel of L and of the inverse rows is also staged in shared memory,
// from where the rank-32 updates read their operands.  Accumulation is f32
// FFMA throughout; no TF32 and no tensor cores, because the JAX kernel runs
// at Precision.HIGHEST.  A non-positive pivot puts NaN on the factor's
// diagonal, as the .cuh says.
//
// The host entry launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "chol_inv_block.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    chol_inv_block_kernel(const float* __restrict__ A, float* L, float* Minv,
                          int nb) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * nb * nb;
  const int ld = kStaged ? nb + 1 : nb;
  float* W = kStaged ? smem : L + off;
  float* M = kStaged ? smem + nb * ld : Minv + off;

  // W = lower triangle of A, M = I; the strict upper triangles stay zero.
  for (int e = tid; e < nb * nb; e += kThreads) {
    const int i = e / nb;
    const int k = e - i * nb;
    W[i * ld + k] = k <= i ? A[off + e] : 0.f;
    M[i * ld + k] = k == i ? 1.f : 0.f;
  }
  __syncthreads();

  if (kStaged) {
    chol_inv_panels(W, ld, M, ld, nb, nullptr, nullptr);
    for (int e = tid; e < nb * nb; e += kThreads) {
      const int i = e / nb;
      const int k = e - i * nb;
      L[off + e] = W[i * ld + k];
      Minv[off + e] = M[i * ld + k];
    }
  } else {
    chol_inv_panels(W, ld, M, ld, nb, smem, smem + nb * kPanelLd);
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
  const size_t staged_bytes = 2u * nb * (nb + 1u) * sizeof(float);
  const size_t panel_bytes =
      static_cast<size_t>(nb) * (kPanelLd + kPanel) * sizeof(float);
  if (staged_bytes <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(chol_inv_block_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(staged_bytes));
    if (err != cudaSuccess) return err;
    chol_inv_block_kernel<true><<<batch, kThreads, staged_bytes, s>>>(
        A, L, Minv, nb);
  } else {
    err = cudaFuncSetAttribute(chol_inv_block_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(panel_bytes));
    if (err != cudaSuccess) return err;
    chol_inv_block_kernel<false><<<batch, kThreads, panel_bytes, s>>>(
        A, L, Minv, nb);
  }
  return cudaGetLastError();
}

extern "C" const char* gsum_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
