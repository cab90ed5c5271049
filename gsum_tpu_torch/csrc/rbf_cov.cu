// Tiled RBF covariance build for a batch of point sets.
//
// Replaces gsum_tpu/ops/pallas_cov.py::_cov_kernel (reached through
// rbf_covariance_pallas, which vmaps _rbf_cov_pallas_single): for each
// (n, d) point set X it writes the (n, n) matrix
//   K[i][j] = amp * exp(-0.5 * sum_k (X[i][k]/ls - X[j][k]/ls)^2)
//             + noise * (i == j),
// from direct differences of the scaled coordinates (not the
// x^2 + y^2 - 2xy expansion of ops.batched.rbf_covariance), with the nugget
// added on the diagonal in the same pass.  Templated for float and double.
//
// Design.  One thread block of 32 x 8 threads per (32-row, 128-column) output
// tile and matrix: the grid is (column tiles, row tiles, batch), so the batch
// is taken directly where JAX vmaps.  The block stages its rows' and columns'
// coordinates, multiplied by 1/ls, in shared memory, eight dimensions at a
// time, and each thread keeps a 4 x 4 set of squared distances in registers:
// rows ty + 8u, columns tx + 32v, so a warp's stores cover 128 consecutive
// bytes of one row.  Rows and columns past n are masked, so any n runs here
// (the TPU kernel needs n to be a multiple of its tile).  exp is the
// accurate expf / exp, not __expf, and the library is built without
// -use_fast_math.
//
// What bounds it: the output.  At B=16, n=4096 the kernel writes 1 GiB and
// reads 0.5 MB, about 0.32 ms at 3.35 TB/s; the arithmetic (3d + 3 flops and
// one exp per element) is an order of magnitude below the card's rate.  The
// design does one coalesced pass over the output and nothing else, where the
// expansion form makes four to five.
//
// The host entries launch on the stream they are given, allocate nothing,
// and return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTm = 32;   // rows of a tile
constexpr int kTn = 128;  // columns of a tile
constexpr int kDc = 8;    // dimensions staged at a time
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__device__ __forceinline__ float exp_accurate(float x) { return expf(x); }
__device__ __forceinline__ double exp_accurate(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
    rbf_cov_kernel(const T* __restrict__ X, T* __restrict__ K, int n, int d,
                   T inv_ls, T amp, T noise) {
  __shared__ T xi[kDc][kTm];
  __shared__ T xj[kDc][kTn];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int i0 = blockIdx.y * kTm;
  const int j0 = blockIdx.x * kTn;
  const T* Xm = X + static_cast<size_t>(blockIdx.z) * n * d;
  T* Km = K + static_cast<size_t>(blockIdx.z) * n * n;

  T acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = T(0);

  for (int k0 = 0; k0 < d; k0 += kDc) {
    const int dc = min(kDc, d - k0);
    __syncthreads();  // the previous dimensions have been read
    for (int e = tid; e < kTm * kDc; e += kThreadsX * kThreadsY) {
      const int r = e / kDc;
      const int k = e - r * kDc;
      const int i = i0 + r;
      xi[k][r] = i < n && k < dc ? Xm[static_cast<size_t>(i) * d + k0 + k] * inv_ls
                                 : T(0);
    }
    for (int e = tid; e < kTn * kDc; e += kThreadsX * kThreadsY) {
      const int r = e / kDc;
      const int k = e - r * kDc;
      const int j = j0 + r;
      xj[k][r] = j < n && k < dc ? Xm[static_cast<size_t>(j) * d + k0 + k] * inv_ls
                                 : T(0);
    }
    __syncthreads();
    for (int k = 0; k < dc; ++k) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const T a = xi[k][ty + kThreadsY * u];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const T diff = a - xj[k][tx + kThreadsX * v];
          acc[u][v] += diff * diff;
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + kThreadsY * u;
    if (i >= n) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + kThreadsX * v;
      if (j < n) {
        T val = amp * exp_accurate(T(-0.5) * acc[u][v]);
        if (i == j) val += noise;
        Km[static_cast<size_t>(i) * n + j] = val;
      }
    }
  }
}

template <typename T>
int launch(const T* X, T* K, int batch, int n, int d, double inv_ls,
           double amp, double noise, void* stream) {
  const dim3 grid((n + kTn - 1) / kTn, (n + kTm - 1) / kTm, batch);
  const dim3 block(kThreadsX, kThreadsY);
  rbf_cov_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      X, K, n, d, static_cast<T>(inv_ls), static_cast<T>(amp),
      static_cast<T>(noise));
  return cudaGetLastError();
}

}  // namespace

extern "C" int gsum_rbf_cov_f32(const float* X, float* K, int batch, int n,
                                int d, double inv_ls, double amp, double noise,
                                void* stream) {
  return launch<float>(X, K, batch, n, d, inv_ls, amp, noise, stream);
}

extern "C" int gsum_rbf_cov_f64(const double* X, double* K, int batch, int n,
                                int d, double inv_ls, double amp, double noise,
                                void* stream) {
  return launch<double>(X, K, batch, n, d, inv_ls, amp, noise, stream);
}
