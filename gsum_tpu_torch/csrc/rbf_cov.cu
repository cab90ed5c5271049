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
// What bounds it: the output.  At B=16, n=4096, f32 the kernel writes 1 GiB
// and reads 0.5 MB, 0.32 ms at 3.35 TB/s; a plain fill of the same 1 GiB
// takes 0.34 ms on an H100 80GB HBM3.  The arithmetic (3d + 3 flops and one
// exp per element) is far below the card's rate, yet issuing it for every
// element took longer (0.42 ms) than the stores (0.34 ms) in the
// one-block-per-tile design this replaces.  So the design halves the
// instructions (0.15 ms) and keeps the stores flowing: it runs in 0.37 ms,
// about what its stores alone take (0.39 ms; the mirrored tiles' rows are
// 256-byte runs).  python -m gsum_tpu_torch.time_phases k2 times the kernel
// and those parts.
//
// - Symmetry.  Only the square kT x kT tiles (I, J) with I <= J are
//   computed; each is stored to (I, J) and its transpose to (J, I).  The
//   mirror is exact: (a - b)^2 rounds as (b - a)^2 does, with or without a
//   fused multiply-add, so K equals its transpose bit for bit, as the plain
//   form's does.  Each of the 256 threads holds a 4 x 4 sub-block made of
//   16-byte row pieces (one in f32, two in f64), and read by columns, of
//   16-byte pieces of the transpose, so both stores go out from registers
//   and every store instruction of a warp writes whole 32-byte sectors.
// - Persistent blocks.  As many blocks as the card holds at once walk one
//   list of (matrix, I, J) tiles, so a block computes its next tile while
//   the stores of the last one drain, and the batch is not a grid dimension
//   (any number of matrices).
// - Staging.  The rows of a tile are one contiguous slab of X, copied to
//   shared memory with coalesced loads and scaled by 1/ls on the way, with
//   no division per element; a d above kDs is staged kDs dimensions at a
//   time.
// - Stores.  Full tiles with 16-byte aligned rows (n % 4 == 0 in f32,
//   n % 2 == 0 in f64, K aligned) go out as float4 / double2 streaming
//   stores (__stcs); other n and the ragged last tiles take masked scalar
//   stores in the same kernel.  Tiles staged in shared memory and sent out
//   by bulk copies (cp.async.bulk) were slower: 0.42 ms in f32.
// - exp.  f32 computes exp(-s/2) as exp2f(s * (-log2(e)/2)): one multiply
//   and the hardware's exp2.  The scaled coordinates and their differences
//   are the plain form's, so against it only the rounding of the sum
//   (fused or not: (2d + 1) * 2^-24 of the exponent t = s/2 at most, with
//   the product) and the two exps (2 ulp each) differ, and since
//   t * exp(-t) <= 1/e:
//     |K - K_plain| <= amp * 2^-24 * ((2d + 1) / e + 8),
//   5.9e-7 * amp at d = 2.  f64 keeps exp.  The library is built without
//   -use_fast_math.
//
// The host entries launch on the stream they are given, allocate nothing,
// and return the first CUDA error of the launch (0 if none).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 64;          // side of a square tile
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 sub-block each
constexpr int kDs = 32;         // dimensions staged at a time

__device__ __forceinline__ float rbf(float s, float amp) {
  return amp * exp2f(s * -0.72134752044448170f);   // -log2(e) / 2
}
__device__ __forceinline__ double rbf(double s, double amp) {
  return amp * exp(-0.5 * s);
}

// 16 bytes of values v to 16-byte aligned p, past the caches' keep-alive
__device__ __forceinline__ void store16(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

// Row (or column) u = 0..3 of thread t's sub-block within a tile: W
// consecutive indices, 16-byte runs, 16 * W apart.  With W = 16 /
// sizeof(T), every 16-byte store of a warp lies beside its neighbour's.
template <int W>
__device__ __forceinline__ int at(int t, int u) {
  return W * t + u % W + u / W * 16 * W;
}

// Rows r0 .. r0 + kT - 1 of Xm that lie below n, dimensions k0 ..
// k0 + S - 1 (all d when S == d), times 1/ls, into xs with row stride S.
template <typename T>
__device__ __forceinline__ void stage(T* xs, const T* Xm, int r0, int n,
                                      int d, int k0, int S, T inv_ls) {
  const int rows = min(kT, n - r0);
  if (S == d) {   // every dimension: the rows are one contiguous slab
    const T* src = Xm + static_cast<size_t>(r0) * d;
    for (int e = threadIdx.x; e < rows * d; e += kThreads)
      xs[e] = src[e] * inv_ls;
  } else {        // kDs dimensions of each row (kDs is a power of two)
    for (int e = threadIdx.x; e < rows * kDs; e += kThreads) {
      const int r = e / kDs, k = k0 + e % kDs;
      if (k < d) xs[e] = Xm[static_cast<size_t>(r0 + r) * d + k] * inv_ls;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rbf_cov_kernel(const T* __restrict__ X, T* __restrict__ K, int batch,
                   int n, int d, T inv_ls, T amp, T noise, bool vec) {
  __shared__ T xs[2][kT * kDs];   // rows of tile row I, rows of tile column J
  constexpr int W = 16 / sizeof(T);   // values in 16 bytes: 4 f32, 2 f64
  // a warp's 32 threads lie 8 wide and 4 high: a row store covers 4 rows x
  // 128 bytes, a transposed store 8 rows x 64 bytes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = (warp & 1) * 8 + (lane & 7);     // sub-block column
  const int ty = (warp >> 1) * 4 + (lane >> 3);   // sub-block row
  const int S = d <= kDs ? d : kDs;               // row stride of xs
  const int nt = (n + kT - 1) / kT;
  const long long per = static_cast<long long>(nt) * (nt + 1) / 2;
  const long long tiles = per * batch;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long m = t / per;
    // the tiles I <= J of a matrix, folded: tile row q and tile row
    // nt - 1 - q hold nt + 1 tiles together
    const int r = static_cast<int>(t - m * per);
    const int q = r / (nt + 1), c = r - q * (nt + 1);
    const int I = c < nt - q ? q : nt - 1 - q;
    const int J = c < nt - q ? q + c : I + c - (nt - q);
    const int i0 = I * kT, j0 = J * kT;
    const T* Xm = X + m * n * d;
    T* Km = K + m * n * n;
    const T* xj = xs[I != J];

    T acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
    for (int k0 = 0; k0 < d; k0 += kDs) {
      __syncthreads();   // the slab before has been read
      stage(xs[0], Xm, i0, n, d, k0, S, inv_ls);
      if (I != J) stage(xs[1], Xm, j0, n, d, k0, S, inv_ls);
      __syncthreads();
      for (int k = 0; k < min(kDs, d - k0); ++k) {
        T a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u] = xs[0][at<W>(ty, u) * S + k];
          b[u] = xj[at<W>(tx, u) * S + k];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const T diff = a[u] - b[v];
            acc[u][v] += diff * diff;
          }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[u][v] = rbf(acc[u][v], amp);
        if (I == J && tx == ty && u == v) acc[u][v] += noise;
      }

    if (vec && i0 + kT <= n && j0 + kT <= n) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < 4; g += W)
          store16(Km + static_cast<size_t>(i0 + at<W>(ty, u)) * n + j0 +
                      at<W>(tx, g),
                  &acc[u][g]);
      if (I != J) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int g = 0; g < 4; g += W) {
            T col[W];
#pragma unroll
            for (int e = 0; e < W; ++e) col[e] = acc[g + e][v];
            store16(Km + static_cast<size_t>(j0 + at<W>(tx, v)) * n + i0 +
                        at<W>(ty, g),
                    col);
          }
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = i0 + at<W>(ty, u), j = j0 + at<W>(tx, v);
          if (i < n && j < n) {
            __stcs(Km + static_cast<size_t>(i) * n + j, acc[u][v]);
            if (I != J) __stcs(Km + static_cast<size_t>(j) * n + i, acc[u][v]);
          }
        }
    }
  }
}

template <typename T>
int launch(const T* X, T* K, int batch, int n, int d, double inv_ls,
           double amp, double noise, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rbf_cov_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long nt = (n + kT - 1) / kT;
  const long long tiles = nt * (nt + 1) / 2 * batch;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  const bool vec = n % (16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(K) % 16 == 0;
  rbf_cov_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      X, K, batch, n, d, static_cast<T>(inv_ls), static_cast<T>(amp),
      static_cast<T>(noise), vec);
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
