// The whole left-looking blocked Cholesky of a batch of SPD f32 matrices in
// one launch.
//
// Replaces gsum_tpu/ops/fusedchol.py::_make_fused_kernel (reached through
// fused_blocked_cholesky): for each (n, n) SPD matrix K it writes the lower
// factor L (K = L L^T) and the inverses minvs[k] = L_kk^{-1} of its (b, b)
// diagonal blocks.  The strict upper triangle of L outside the diagonal
// blocks is not written; inside them it is zero.  b is 32, 64, 128 or 256
// and divides n (the Python wrapper checks that); the kernel is compiled for
// each of those widths.
//
// Design.  The TPU kernel runs its grid steps in order, one column block per
// step.  Hopper runs blocks in parallel and in no order, so this is a
// persistent cooperative kernel: as many blocks as fit on the card at once
// (the occupancy query times the SM count), launched with
// cudaLaunchCooperativeKernel.  For each column block k (s = k b) three
// phases run, separated by grid-wide barriers:
//   (a) history: A_col = K[s:, s:s+b] - L[s:, :s] L[s:s+b, :s]^T, in strips
//       of R = 16384 / b rows by b columns that the blocks take round-robin
//       over (matrix, strip); the result goes into L's column block as
//       scratch;
//   (b) diagonal: one block per matrix turns the b x b tile of A_col into
//       L_kk and minvs[k] with the column loop of chol_inv_block.cuh (the one
//       the diagonal-block kernel runs), in shared memory.  For b <= 128 the
//       tile and its inverse are staged whole.  At b = 256 the two would take
//       512 KB, so the tile is split in 128 halves with the 2 x 2 formula of
//       gsum_tpu/ops/blockchol.py::_factor_diag_hier: two staged 128
//       factorizations and four 128^3 products in shared memory (199 KB).
//       Running the loop on the 256 tile from global memory, as
//       chol_inv_block.cu does for large blocks, took 1 ms a step;
//   (c) panel: each strip below the diagonal tile becomes A_col_strip
//       minvs[k]^T, written in place (a strip's rows are read whole before
//       the block writes them).
// Phases (a) and (c) are one shared-memory-tiled NT product: 1024 threads,
// each with a 4 x 4 register tile of the R x b output, operands staged
// through shared memory in depth-16 slices (transposed, so the inner loop
// reads two float4), the next slice prefetched into registers while the
// current one is multiplied.  Accumulation is f32 FFMA: no TF32 and no
// tensor cores, because the JAX kernel runs its products at
// Precision.HIGHEST.
//
// Memory ordering: L is written and read within the launch, by other blocks
// across a grid barrier.  Its loads are plain global loads (no
// const __restrict__, no __ldg), which the barrier's fences order; the
// non-coherent read-only path could return data from before another block's
// write.
//
// A non-positive pivot is not clamped and does not stop the kernel: it puts
// NaN or 0 on its own matrix's diagonal (see chol_inv_block.cuh), and the
// other matrices of the batch are unaffected.
//
// What bounds it: the work is about n^3/3 multiply-adds of history per
// matrix plus the panel products (434 GFLOP at B=16, n=4096, b=256) against
// 2 GiB of K and L, so the card's f32 FFMA rate bounds it (about 6.5 ms at
// 67 TFLOP/s).  This first version stays well above that: the register tile
// is small (shared-memory bandwidth per FFMA, and 1024 threads leave 64
// registers each), the diagonal phase runs on only B of the blocks while the
// others wait at the barrier, and the last column blocks have fewer strips
// than the card has SMs.  Making it fast (larger register tiles, split-k for
// the late steps, overlapping the diagonal with the next history) is later
// work; wgmma is no option at full f32.
//
// The host entry launches on the stream it is given, allocates nothing, and
// returns the launch's error or cudaGetLastError() after it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chol_inv_block.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kOut = 16;    // outputs per thread: a 4 x 4 register tile
constexpr int kKc = 16;     // depth of one shared-memory slice
constexpr int kPad = 4;     // row padding of the staged slices (keeps float4)
constexpr int kHalf = 128;  // the split diagonal's half tile
constexpr int kLdH = kHalf + 1;

// Rows of a strip task: R x b outputs, 16 per thread.
template <int kB>
constexpr int kStripRows = kThreads * kOut / kB;

// Shared memory of the strip product's two staged slices.
template <int kB>
constexpr size_t kProductBytes = kKc * (kStripRows<kB> + kPad + kB + kPad) * sizeof(float);

// Shared memory of the diagonal phase: the column scratch and two (b <= 128,
// staged) or three (b = 256, split) padded 128-wide working matrices.
template <int kB>
constexpr size_t kDiagonalBytes =
    kB <= kHalf ? (kB + 2 * kB * (kB + 1)) * sizeof(float)
                : (kHalf + 3 * kHalf * kLdH) * sizeof(float);

// Loads the (rows x kKc) slice at column p0 of a row-major matrix X into
// registers, one float4 per element e = threadIdx.x + u * kThreads of the
// slice (row e / 4, columns 4 (e % 4) ...); rows past nrows read as zero.
template <int kCount>
__device__ __forceinline__ void load_slice(
    const float* X, int ld, int nrows, int p0,
    float4 (&reg)[(kCount + kThreads - 1) / kThreads]) {
#pragma unroll
  for (int u = 0; u < (kCount + kThreads - 1) / kThreads; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int r = e >> 2;
    if (e < kCount) {
      reg[u] = r < nrows ? *reinterpret_cast<const float4*>(
                               X + static_cast<size_t>(r) * ld + p0 + 4 * (e & 3))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Stores the registers of load_slice transposed: S[p][r], row stride lds.
template <int kCount>
__device__ __forceinline__ void store_slice(
    float* S, int lds, const float4 (&reg)[(kCount + kThreads - 1) / kThreads]) {
#pragma unroll
  for (int u = 0; u < (kCount + kThreads - 1) / kThreads; ++u) {
    const int e = threadIdx.x + u * kThreads;
    if (e < kCount) {
      float* p = S + 4 * (e & 3) * lds + (e >> 2);
      p[0] = reg[u].x;
      p[lds] = reg[u].y;
      p[2 * lds] = reg[u].z;
      p[3 * lds] = reg[u].w;
    }
  }
}

// acc[i][j] = sum_p A[ty*4+i][p] B[tx*4+j][p] over p < inner, for the
// thread's (ty, tx) = (tid / (b/4), tid % (b/4)) of an R x b output strip.
// A has R rows (those past nrows read as zero), B has b rows, both row-major
// with strides lda and ldb; inner is a multiple of kKc.  Every load of A is
// complete when this returns, so the caller may overwrite A's rows.
template <int kB>
__device__ __forceinline__ void strip_product(const float* A, int lda,
                                              int nrows, const float* B,
                                              int ldb, int inner, float* smem,
                                              float (&acc)[4][4]) {
  constexpr int R = kStripRows<kB>;
  constexpr int lda_s = R + kPad;
  constexpr int ldb_s = kB + kPad;
  constexpr int count_a = R * (kKc / 4);
  constexpr int count_b = kB * (kKc / 4);
  float* As = smem;
  float* Bs = smem + kKc * lda_s;
  const int tx = threadIdx.x % (kB / 4);
  const int ty = threadIdx.x / (kB / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (inner == 0) return;

  float4 ra[(count_a + kThreads - 1) / kThreads];
  float4 rb[(count_b + kThreads - 1) / kThreads];
  load_slice<count_a>(A, lda, nrows, 0, ra);
  load_slice<count_b>(B, ldb, kB, 0, rb);
  for (int p0 = 0; p0 < inner; p0 += kKc) {
    __syncthreads();  // the previous slice has been read by every thread
    store_slice<count_a>(As, lda_s, ra);
    store_slice<count_b>(Bs, ldb_s, rb);
    __syncthreads();
    if (p0 + kKc < inner) {
      load_slice<count_a>(A, lda, nrows, p0 + kKc, ra);
      load_slice<count_b>(B, ldb, kB, p0 + kKc, rb);
    }
#pragma unroll
    for (int p = 0; p < kKc; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(As + p * lda_s + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(Bs + p * ldb_s + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
  }
  __syncthreads();  // every thread's loads of A are done before any store
}

// acc[u][v] = sum_p A[i][p] B(p, c) over p < kHalf for the thread's rows
// i = ty + 32u and columns c = tx + 32v of a 128 x 128 product of matrices in
// shared memory with row stride kLdH; B(p, c) is B[c][p] when kTransB, else
// B[p][c].  A's reads are warp broadcasts, B's hit 32 banks.
template <bool kTransB>
__device__ __forceinline__ void half_product(const float* A, const float* B,
                                             float (&acc)[4][4]) {
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 4
  for (int p = 0; p < kHalf; ++p) {
    float a[4], c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = A[(ty + 32 * u) * kLdH + p];
#pragma unroll
    for (int v = 0; v < 4; ++v)
      c[v] = kTransB ? B[(tx + 32 * v) * kLdH + p] : B[p * kLdH + tx + 32 * v];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], c[v], acc[u][v]);
  }
}

// Phase (b) for one matrix, b <= 128: the b x b tile T of L (row stride n)
// becomes L_kk and Mk (row stride b) its inverse, both staged in shared
// memory.
template <int kB>
__device__ void diagonal_staged(float* T, int n, float* Mk, float* smem) {
  constexpr int ld = kB + 1;
  float* col = smem;
  float* W = smem + kB;
  float* M = W + kB * ld;
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
    const int i = e / kB;
    const int c = e % kB;
    W[i * ld + c] = c <= i ? T[static_cast<size_t>(i) * n + c] : 0.f;
    M[i * ld + c] = c == i ? 1.f : 0.f;
  }
  __syncthreads();
  chol_inv_columns(W, ld, M, ld, col, kB);
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
    const int i = e / kB;
    const int c = e % kB;
    T[static_cast<size_t>(i) * n + c] = W[i * ld + c];
    Mk[e] = M[i * ld + c];
  }
  __syncthreads();  // smem is free for the next matrix
}

// Phase (b) for one matrix, b = 256, split in 128 halves (the 2 x 2 formula
// of gsum_tpu/ops/blockchol.py::_factor_diag_hier):
//   L11, M11 = chol_inv(T11);  L21 = T21 M11^T;
//   L22, M22 = chol_inv(T22 - L21 L21^T);  M21 = -(M22 L21) M11.
// The two factorizations run the staged column loop; the four products are
// 128 x 128 x 128 in shared memory.  S0, S1, S2 are padded 128 x 128
// matrices in shared memory.
__device__ void diagonal_split(float* T, int n, float* Mk, float* smem) {
  constexpr int h = kHalf;
  constexpr int b = 2 * kHalf;
  float* col = smem;
  float* S0 = smem + h;
  float* S1 = S0 + h * kLdH;
  float* S2 = S1 + h * kLdH;
  const int tid = threadIdx.x;
  const int tx = tid % 32;
  const int ty = tid / 32;
  float acc[4][4];
  auto t = [&](int i, int c) -> float& { return T[static_cast<size_t>(i) * n + c]; };

  // L11, M11
  for (int e = tid; e < h * h; e += kThreads) {
    const int i = e / h;
    const int c = e % h;
    S0[i * kLdH + c] = c <= i ? t(i, c) : 0.f;
    S1[i * kLdH + c] = c == i ? 1.f : 0.f;
    S2[i * kLdH + c] = t(h + i, c);  // T21
  }
  __syncthreads();
  chol_inv_columns(S0, kLdH, S1, kLdH, col, h);
  for (int e = tid; e < h * h; e += kThreads) {
    const int i = e / h;
    const int c = e % h;
    t(i, c) = S0[i * kLdH + c];
    t(i, h + c) = 0.f;
    Mk[i * b + c] = S1[i * kLdH + c];
    Mk[i * b + h + c] = 0.f;
  }

  // L21 = T21 M11^T, kept in S2 and written to L
  half_product<true>(S2, S1, acc);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = ty + 32 * u;
      const int c = tx + 32 * v;
      S2[i * kLdH + c] = acc[u][v];
      t(h + i, c) = acc[u][v];
    }
  __syncthreads();

  // S0 = lower(T22 - L21 L21^T), S1 = I; then L22, M22
  half_product<true>(S2, S2, acc);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = ty + 32 * u;
      const int c = tx + 32 * v;
      S0[i * kLdH + c] = c <= i ? t(h + i, h + c) - acc[u][v] : 0.f;
      S1[i * kLdH + c] = c == i ? 1.f : 0.f;
    }
  __syncthreads();
  chol_inv_columns(S0, kLdH, S1, kLdH, col, h);
  for (int e = tid; e < h * h; e += kThreads) {
    const int i = e / h;
    const int c = e % h;
    t(h + i, h + c) = S0[i * kLdH + c];
    Mk[(h + i) * b + h + c] = S1[i * kLdH + c];
  }

  // M21 = -(M22 L21) M11
  half_product<false>(S1, S2, acc);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = ty + 32 * u;
      const int c = tx + 32 * v;
      S0[i * kLdH + c] = acc[u][v];
      S1[i * kLdH + c] = Mk[i * b + c];  // M11, written above by this block
    }
  __syncthreads();
  half_product<false>(S0, S1, acc);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      Mk[(h + ty + 32 * u) * b + tx + 32 * v] = -acc[u][v];
  __syncthreads();  // smem is free for the next matrix
}

template <int kB>
__global__ void __launch_bounds__(kThreads, 1)
    fused_chol_kernel(const float* __restrict__ K, float* L, float* minvs,
                      int batch, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  constexpr int R = kStripRows<kB>;
  const int nb = n / kB;
  const size_t nn = static_cast<size_t>(n) * n;
  const int tx = threadIdx.x % (kB / 4);
  const int ty = threadIdx.x / (kB / 4);
  float acc[4][4];

  for (int k = 0; k < nb; ++k) {
    const int s = k * kB;

    // (a) history: rows s.. of column block k
    const int strips_a = (n - s + R - 1) / R;
    for (int t = blockIdx.x; t < batch * strips_a; t += gridDim.x) {
      const int m = t / strips_a;
      const int r0 = s + (t - m * strips_a) * R;
      float* Lm = L + m * nn;
      strip_product<kB>(Lm + static_cast<size_t>(r0) * n, n, n - r0,
                        Lm + static_cast<size_t>(s) * n, n, s, smem, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 4 * ty + i;
        if (r < n) {
          const size_t o = static_cast<size_t>(r) * n + s + 4 * tx;
          const float4 kv = *reinterpret_cast<const float4*>(K + m * nn + o);
          *reinterpret_cast<float4*>(Lm + o) =
              make_float4(kv.x - acc[i][0], kv.y - acc[i][1],
                          kv.z - acc[i][2], kv.w - acc[i][3]);
        }
      }
    }
    grid.sync();

    // (b) diagonal tile, one block per matrix
    for (int m = blockIdx.x; m < batch; m += gridDim.x) {
      float* T = L + m * nn + static_cast<size_t>(s) * n + s;
      float* Mk = minvs + (static_cast<size_t>(m) * nb + k) * kB * kB;
      if constexpr (kB <= kHalf)
        diagonal_staged<kB>(T, n, Mk, smem);
      else
        diagonal_split(T, n, Mk, smem);
    }
    grid.sync();

    // (c) panel: rows s+b.. of column block k times minvs[k]^T, in place
    if (s + kB < n) {
      const int strips_c = (n - s - kB + R - 1) / R;
      for (int t = blockIdx.x; t < batch * strips_c; t += gridDim.x) {
        const int m = t / strips_c;
        const int r0 = s + kB + (t - m * strips_c) * R;
        float* Lm = L + m * nn;
        strip_product<kB>(Lm + static_cast<size_t>(r0) * n + s, n, n - r0,
                          minvs + (static_cast<size_t>(m) * nb + k) * kB * kB,
                          kB, kB, smem, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + 4 * ty + i;
          if (r < n)
            *reinterpret_cast<float4*>(Lm + static_cast<size_t>(r) * n + s +
                                       4 * tx) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
      grid.sync();
    }
  }
}

template <int kB>
cudaError_t launch(const float* K, float* L, float* minvs, int batch, int n,
                   cudaStream_t stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = (kProductBytes<kB> > kDiagonalBytes<kB>)
                          ? kProductBytes<kB> : kDiagonalBytes<kB>;
  const void* fn = reinterpret_cast<const void*>(fused_chol_kernel<kB>);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&K, (void*)&L, (void*)&minvs, (void*)&batch,
                  (void*)&n};
  err = cudaLaunchCooperativeKernel(fn, dim3(per_sm * sms), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int gsum_fused_chol_f32(const float* K, float* L, float* minvs,
                                   int batch, int n, int b, void* stream) {
  if (n % b) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 32: return launch<32>(K, L, minvs, batch, n, s);
    case 64: return launch<64>(K, L, minvs, batch, n, s);
    case 128: return launch<128>(K, L, minvs, batch, n, s);
    case 256: return launch<256>(K, L, minvs, batch, n, s);
    default: return cudaErrorInvalidValue;
  }
}
