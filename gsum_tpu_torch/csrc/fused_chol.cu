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
// What bounds it: the function needs n^3/3 multiply-adds for the factor and
// b^3/3 per diagonal block for the inverses, 367.9 GFLOP at B=16, n=4096,
// b=256, against 1.1 GiB of K's and L's lower triangles: the card's f32
// FFMA rate bounds it (5.49 ms at 67 TFLOP/s).  The tensor cores would run
// these products only in TF32 or lower, and the JAX kernel runs them at
// Precision.HIGHEST, so every product here is f32 FFMA.
//
// Design.  The TPU kernel runs its grid steps in order, one column block per
// step.  Hopper runs blocks in parallel and in no order, so this is a
// persistent cooperative kernel: one block of 256 threads per SM (the
// occupancy query times the SM count), launched with
// cudaLaunchCooperativeKernel.  For each column block k (s = k b) three
// phases run, separated by grid-wide barriers:
//   (a) history: A_col = K[s:, s:s+b] - L[s:, :s] L[s:s+b, :s]^T, in strips
//       of R = 16384 / b rows by b columns that the blocks take round-robin
//       over (matrix, strip); the result goes into L's column block as
//       scratch.  In the strips that hold the diagonal tile, the warp tiles
//       that lie wholly above the diagonal are skipped: only the tile's
//       lower triangle is read;
//   (b) diagonal: one block per matrix turns the b x b tile of A_col into
//       L_kk and minvs[k] with the panel-blocked routine of
//       chol_inv_block.cuh (the one the diagonal-block kernel runs), in
//       shared memory.  For b <= 128 the tile and its inverse are staged
//       whole.  At b = 256 the two would take 512 KB, so the tile is split in
//       128 halves with the 2 x 2 formula of
//       gsum_tpu/ops/blockchol.py::_factor_diag_hier: two staged 128
//       factorizations and four 128^3 products in shared memory (198 KB);
//   (c) panel: each strip below the diagonal tile becomes A_col_strip
//       minvs[k]^T, written in place (a strip's rows are read whole before
//       the block writes them).  minvs[k] is lower triangular, so for each
//       warp tile of output columns the depth loop stops at the tile's last
//       column.
// Phases (a) and (c) are one SGEMM tile shaped for the FFMA units: each
// thread holds an 8 x 8 register tile of the R x b output (runs of 4 rows
// and columns half a strip apart, so a warp's float4 loads from shared
// memory do not conflict), so each depth step is four shared-memory float4
// loads for 64 FFMAs; 256 threads leave it up to 255 registers (ptxas
// reports at most a few bytes of spill; chip_smoke.py prints them).  Operands come in depth-16 slices, loaded from global memory as
// float4 (four lanes a row, 64 bytes) while the slice before is multiplied,
// held in registers, and stored transposed into the other of two
// shared-memory buffers; one block barrier per slice.  (4-byte cp.async
// copies, which transpose on the way in, were slower: their count per slice
// costs more than the registers.)
//
// Memory ordering: L is written and read within the launch, by other blocks
// across a grid barrier.  It is read by plain loads, which the barrier's
// fences order; nothing reads it through the non-coherent read-only path (no
// const __restrict__, no __ldg), which could return data from before another
// block's write.
//
// A non-positive pivot is not clamped and does not stop the kernel: it puts
// NaN on its own matrix's diagonal (see chol_inv_block.cuh), and the
// other matrices of the batch are unaffected.
//
// What still holds it back: the diagonal step runs on one block per matrix
// (16 of 132 at the headline) while the others wait at the grid barrier, and
// at the last column blocks there are fewer strips than blocks.
//
// The host entry launches on the stream it is given, allocates nothing, and
// returns the launch's error or cudaGetLastError() after it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chol_inv_block.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 8;      // rows of a thread's register tile
constexpr int kTN = 8;      // columns of a thread's register tile
constexpr int kKc = 16;     // depth of one shared-memory slice
constexpr int kPad = 4;     // row padding of the staged slices (keeps float4)
constexpr int kHalf = 128;  // the split diagonal's half tile
constexpr int kLdH = kHalf + 1;

// The strip product's thread layout for block width kB: R x kB outputs, a
// kTM x kTN tile per thread (ty, tx), ty < R / kTM, tx < kB / kTN.  A
// thread's rows are NR runs of 4, R / NR apart, and its columns NC runs of 4,
// kB / NC apart, so the float4 loads of 8 neighbouring lanes are 8
// neighbouring float4s.  A warp holds LY x LX threads; WX warps span a row
// of threads.
template <int kB>
struct Tile {
  static constexpr int R = kThreads * kTM * kTN / kB;
  static constexpr int NR = kTM / 4;  // runs of 4 rows
  static constexpr int NC = kTN / 4;  // runs of 4 columns
  static constexpr int TX = kB / kTN;
  static constexpr int LX = TX < 8 ? TX : 8;
  static constexpr int LY = 32 / LX;
  static constexpr int WX = TX / LX;
  // floats of one staged slice of A and B in shared memory
  static constexpr int kStage = kKc * (R + kPad + kB + kPad);
};

// Which warp tiles of a product to skip.
enum Skip {
  kDense,     // none
  kUpper,     // those wholly above the diagonal (row < column) of a tile
              // whose local rows start at row_off
  kLowerB,    // B is lower triangular: depth p > the warp's last column
};

// Shared memory of the strip product's two buffers of staged slices.
template <int kB>
constexpr size_t kProductBytes = 2 * Tile<kB>::kStage * sizeof(float);

// Shared memory of the diagonal phase: two (b <= 128, staged) or three
// (b = 256, split) padded working matrices.
template <int kB>
constexpr size_t kDiagonalBytes = kB <= kHalf
                                      ? 2 * kB * (kB + 1) * sizeof(float)
                                      : 3 * kHalf * kLdH * sizeof(float);

// A slice of kRows x kKc held in registers between its load from global
// memory and its store to shared memory: float4 u of the thread is element
// e = threadIdx.x + u kThreads of the slice, row e / (kKc / 4), columns
// 4 (e % (kKc / 4)) ... (four neighbouring lanes read a row's 64 bytes).
template <int kRows>
struct SliceRegs {
  static constexpr int kCount = kRows * kKc / 4;
  static constexpr int kN = (kCount + kThreads - 1) / kThreads;
  float4 v[kN];

  // Loads the slice at column p0 of the row-major matrix X; rows past nrows
  // read as zero.
  __device__ __forceinline__ void load(const float* X, int ld, int nrows,
                                       int p0) {
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e / (kKc / 4);
      if (kCount % kThreads == 0 || e < kCount)
        v[u] = r < nrows ? *reinterpret_cast<const float4*>(
                               X + static_cast<size_t>(r) * ld + p0 +
                               4 * (e % (kKc / 4)))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // Stores it transposed: S[p][r], row stride kRows + kPad.
  __device__ __forceinline__ void store(float* S) const {
    constexpr int lds = kRows + kPad;
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (kCount % kThreads == 0 || e < kCount) {
        float* p = S + 4 * (e % (kKc / 4)) * lds + e / (kKc / 4);
        p[0] = v[u].x;
        p[lds] = v[u].y;
        p[2 * lds] = v[u].z;
        p[3 * lds] = v[u].w;
      }
    }
  }
};

// acc[4 ri + i][4 ci + j] += sum over one slice of As[p][row] Bs[p][col], for
// the column runs ci >= kC0 (runs below kC0 are skipped).  As and Bs point
// at the thread's first row and column.
template <int kB, int kC0>
__device__ __forceinline__ void slice_fma(const float* As, const float* Bs,
                                          float (&acc)[kTM][kTN]) {
  using T = Tile<kB>;
  constexpr int lda_s = T::R + kPad;
  constexpr int ldb_s = kB + kPad;
#pragma unroll
  for (int p = 0; p < kKc; ++p) {
    float av[kTM], bv[kTN];
#pragma unroll
    for (int ri = 0; ri < T::NR; ++ri) {
      const float4 v = *reinterpret_cast<const float4*>(As + p * lda_s + ri * (T::R / T::NR));
      av[4 * ri] = v.x; av[4 * ri + 1] = v.y; av[4 * ri + 2] = v.z; av[4 * ri + 3] = v.w;
    }
#pragma unroll
    for (int ci = kC0; ci < T::NC; ++ci) {
      const float4 v = *reinterpret_cast<const float4*>(Bs + p * ldb_s + ci * (kB / T::NC));
      bv[4 * ci] = v.x; bv[4 * ci + 1] = v.y; bv[4 * ci + 2] = v.z; bv[4 * ci + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 4 * kC0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The same for the single pair of runs (ri, ci).
template <int kB>
__device__ __forceinline__ void slice_fma_run(const float* As, const float* Bs,
                                              int ri, int ci,
                                              float (&acc)[kTM][kTN]) {
  using T = Tile<kB>;
  constexpr int lda_s = T::R + kPad;
  constexpr int ldb_s = kB + kPad;
#pragma unroll
  for (int p = 0; p < kKc; ++p) {
    const float4 a = *reinterpret_cast<const float4*>(As + p * lda_s + ri * (T::R / T::NR));
    const float4 b = *reinterpret_cast<const float4*>(Bs + p * ldb_s + ci * (kB / T::NC));
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[4 * ri + i][4 * ci + j] = fmaf(av[i], bv[j], acc[4 * ri + i][4 * ci + j]);
  }
}

// acc[4 ri + i][4 ci + j] = sum_p A[row][p] B[col][p] over p < inner, for
// the thread's rows row = ri R/NR + 4 ty + i and columns
// col = ci b/NC + 4 tx + j of an R x b output strip.  A has R rows (those
// past nrows read as zero), B has b rows, both row-major with strides lda
// and ldb; inner is a multiple of kKc.  kSkip drops warp tiles as its enum
// says (their acc stays 0); the slices that need every run take the dense
// loop.  Every load of A is complete when this returns, so the caller may
// overwrite A's rows.
template <int kB, Skip kSkip>
__device__ __forceinline__ void strip_product(const float* A, int lda,
                                              int nrows, const float* B,
                                              int ldb, int inner, int row_off,
                                              float* smem,
                                              float (&acc)[kTM][kTN]) {
  using T = Tile<kB>;
  constexpr int R = T::R;
  constexpr int NR = T::NR;
  constexpr int NC = T::NC;
  constexpr int lda_s = R + kPad;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wy = warp / T::WX;
  const int wx = warp % T::WX;
  const int ty = wy * T::LY + lane / T::LX;
  const int tx = wx * T::LX + lane % T::LX;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  if (inner == 0) return;

  // kUpper: which of the warp's runs (local rows [ri R/NR + 4 LY wy, + 4 LY),
  // columns [ci b/NC + 4 LX wx, + 4 LX)) reach the diagonal or below.
  bool live[NR][NC];
  bool all_live = true;
#pragma unroll
  for (int ri = 0; ri < NR; ++ri)
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) {
      const int row_hi = row_off + ri * (R / NR) + 4 * T::LY * (wy + 1) - 1;
      const int col_lo = ci * (kB / NC) + 4 * T::LX * wx;
      live[ri][ci] = kSkip != kUpper || row_hi >= col_lo;
      all_live = all_live && live[ri][ci];
    }
  // kLowerB: the last column of the warp's first and last runs
  const int col_hi0 = 4 * T::LX * (wx + 1) - 1;
  const int col_hi1 = (NC - 1) * (kB / NC) + col_hi0;

  // Two buffers of shared memory; the next slice waits in registers, loaded
  // while the current one is multiplied, until its buffer is free.
  const int nslices = inner / kKc;
  SliceRegs<R> ra;
  SliceRegs<kB> rb;
  ra.load(A, lda, nrows, 0);
  rb.load(B, ldb, kB, 0);
  ra.store(smem);
  rb.store(smem + kKc * lda_s);
  if (nslices > 1) {
    ra.load(A, lda, nrows, kKc);
    rb.load(B, ldb, kB, kKc);
  }
  __syncthreads();
  for (int it = 0; it < nslices; ++it) {
    const int p0 = it * kKc;
    const float* As = smem + (it & 1) * T::kStage + 4 * ty;
    const float* Bs = smem + (it & 1) * T::kStage + kKc * lda_s + 4 * tx;
    if (kSkip == kLowerB) {
      if (p0 <= col_hi0)
        slice_fma<kB, 0>(As, Bs, acc);
      else if (NC == 2 && p0 <= col_hi1)
        slice_fma<kB, NC - 1>(As, Bs, acc);
    } else if (all_live) {
      slice_fma<kB, 0>(As, Bs, acc);
    } else {
#pragma unroll
      for (int ri = 0; ri < NR; ++ri)
#pragma unroll
        for (int ci = 0; ci < NC; ++ci)
          if (live[ri][ci]) slice_fma_run<kB>(As, Bs, ri, ci, acc);
    }
    // slice it + 1 into the other buffer (free since the last barrier), and
    // slice it + 2 into the registers it leaves
    if (it + 1 < nslices) {
      float* next = smem + ((it + 1) & 1) * T::kStage;
      ra.store(next);
      rb.store(next + kKc * lda_s);
      if (it + 2 < nslices) {
        ra.load(A, lda, nrows, (it + 2) * kKc);
        rb.load(B, ldb, kB, (it + 2) * kKc);
      }
    }
    __syncthreads();
  }
}

// The 128 x 128 products of the split diagonal: the threads form a
// kHalfGrid x kHalfGrid grid, and thread (ty, tx) computes rows
// i = ty + kHalfGrid u and columns c = tx + kHalfGrid v (u, v < kHalfTile).
constexpr int kHalfGrid = 16;
constexpr int kHalfTile = kHalf / kHalfGrid;
static_assert(kHalfGrid * kHalfGrid == kThreads, "one output tile a thread");

// acc[u][v] = sum_p A[i][p] B(p, c) over p < kHalf for the thread's rows
// and columns, matrices in shared memory with row stride kLdH; B(p, c) is
// B[c][p] when kTransB, else B[p][c].  A warp's loads of A are two
// broadcasts, its loads of B hit 16 or 32 banks.
template <bool kTransB>
__device__ __forceinline__ void half_product(const float* A, const float* B,
                                             float (&acc)[kHalfTile][kHalfTile]) {
  const int tx = threadIdx.x % kHalfGrid;
  const int ty = threadIdx.x / kHalfGrid;
#pragma unroll
  for (int u = 0; u < kHalfTile; ++u)
#pragma unroll
    for (int v = 0; v < kHalfTile; ++v) acc[u][v] = 0.f;
#pragma unroll 2
  for (int p = 0; p < kHalf; ++p) {
    float a[kHalfTile], c[kHalfTile];
#pragma unroll
    for (int u = 0; u < kHalfTile; ++u) a[u] = A[(ty + kHalfGrid * u) * kLdH + p];
#pragma unroll
    for (int v = 0; v < kHalfTile; ++v)
      c[v] = kTransB ? B[(tx + kHalfGrid * v) * kLdH + p]
                     : B[p * kLdH + tx + kHalfGrid * v];
#pragma unroll
    for (int u = 0; u < kHalfTile; ++u)
#pragma unroll
      for (int v = 0; v < kHalfTile; ++v) acc[u][v] = fmaf(a[u], c[v], acc[u][v]);
  }
}

// Phase (b) for one matrix, b <= 128: the b x b tile T of L (row stride n)
// becomes L_kk and Mk (row stride b) its inverse, both staged in shared
// memory.
template <int kB>
__device__ void diagonal_staged(float* T, int n, float* Mk, float* smem) {
  constexpr int ld = kB + 1;
  float* W = smem;
  float* M = W + kB * ld;
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
    const int i = e / kB;
    const int c = e % kB;
    W[i * ld + c] = c <= i ? T[static_cast<size_t>(i) * n + c] : 0.f;
    M[i * ld + c] = c == i ? 1.f : 0.f;
  }
  __syncthreads();
  chol_inv_panels(W, ld, M, ld, kB, nullptr, nullptr);
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
// The two factorizations run the staged panel routine; the four products
// are 128 x 128 x 128 in shared memory.  S0, S1, S2 are padded 128 x 128
// matrices in shared memory.
__device__ void diagonal_split(float* T, int n, float* Mk, float* smem) {
  constexpr int h = kHalf;
  constexpr int b = 2 * kHalf;
  float* S0 = smem;
  float* S1 = S0 + h * kLdH;
  float* S2 = S1 + h * kLdH;
  const int tid = threadIdx.x;
  const int tx = tid % kHalfGrid;
  const int ty = tid / kHalfGrid;
  float acc[kHalfTile][kHalfTile];
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
  chol_inv_panels(S0, kLdH, S1, kLdH, h, nullptr, nullptr);
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
  for (int u = 0; u < kHalfTile; ++u)
#pragma unroll
    for (int v = 0; v < kHalfTile; ++v) {
      const int i = ty + kHalfGrid * u;
      const int c = tx + kHalfGrid * v;
      S2[i * kLdH + c] = acc[u][v];
      t(h + i, c) = acc[u][v];
    }
  __syncthreads();

  // S0 = lower(T22 - L21 L21^T), S1 = I; then L22, M22
  half_product<true>(S2, S2, acc);
#pragma unroll
  for (int u = 0; u < kHalfTile; ++u)
#pragma unroll
    for (int v = 0; v < kHalfTile; ++v) {
      const int i = ty + kHalfGrid * u;
      const int c = tx + kHalfGrid * v;
      S0[i * kLdH + c] = c <= i ? t(h + i, h + c) - acc[u][v] : 0.f;
      S1[i * kLdH + c] = c == i ? 1.f : 0.f;
    }
  __syncthreads();
  chol_inv_panels(S0, kLdH, S1, kLdH, h, nullptr, nullptr);
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
  for (int u = 0; u < kHalfTile; ++u)
#pragma unroll
    for (int v = 0; v < kHalfTile; ++v) {
      const int i = ty + kHalfGrid * u;
      const int c = tx + kHalfGrid * v;
      S0[i * kLdH + c] = acc[u][v];
      S1[i * kLdH + c] = Mk[i * b + c];  // M11, written above by this block
    }
  __syncthreads();
  half_product<false>(S0, S1, acc);
#pragma unroll
  for (int u = 0; u < kHalfTile; ++u)
#pragma unroll
    for (int v = 0; v < kHalfTile; ++v)
      Mk[(h + ty + kHalfGrid * u) * b + tx + kHalfGrid * v] = -acc[u][v];
  __syncthreads();  // smem is free for the next matrix
}

// Writes the thread's kTM x kTN outputs of a strip at rows r0.. and columns
// s.. of L: L = K - acc (history, K != nullptr) or L = acc (panel).
template <int kB>
__device__ __forceinline__ void store_strip(float* Lm, const float* Km, int n,
                                            int r0, int s,
                                            const float (&acc)[kTM][kTN]) {
  using T = Tile<kB>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ty = (warp / T::WX) * T::LY + lane / T::LX;
  const int tx = (warp % T::WX) * T::LX + lane % T::LX;
#pragma unroll
  for (int ri = 0; ri < T::NR; ++ri)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ri * (T::R / T::NR) + 4 * ty + i;
      if (r >= n) continue;
#pragma unroll
      for (int ci = 0; ci < T::NC; ++ci) {
        const size_t o =
            static_cast<size_t>(r) * n + s + ci * (kB / T::NC) + 4 * tx;
        const float* a = acc[4 * ri + i] + 4 * ci;
        float4 v = make_float4(a[0], a[1], a[2], a[3]);
        if (Km) {
          const float4 kv = *reinterpret_cast<const float4*>(Km + o);
          v = make_float4(kv.x - v.x, kv.y - v.y, kv.z - v.z, kv.w - v.w);
        }
        *reinterpret_cast<float4*>(Lm + o) = v;
      }
    }
}

template <int kB>
__global__ void __launch_bounds__(kThreads, 1)
    fused_chol_kernel(const float* __restrict__ K, float* L, float* minvs,
                      int batch, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  constexpr int R = Tile<kB>::R;
  const int nb = n / kB;
  const size_t nn = static_cast<size_t>(n) * n;
  float acc[kTM][kTN];

  for (int k = 0; k < nb; ++k) {
    const int s = k * kB;

    // (a) history: rows s.. of column block k
    const int strips_a = (n - s + R - 1) / R;
    for (int t = blockIdx.x; t < batch * strips_a; t += gridDim.x) {
      const int m = t / strips_a;
      const int r0 = s + (t - m * strips_a) * R;
      float* Lm = L + m * nn;
      const float* A = Lm + static_cast<size_t>(r0) * n;
      const float* B = Lm + static_cast<size_t>(s) * n;
      if (r0 - s < kB)  // the strip holds (part of) the diagonal tile
        strip_product<kB, kUpper>(A, n, n - r0, B, n, s, r0 - s, smem, acc);
      else
        strip_product<kB, kDense>(A, n, n - r0, B, n, s, 0, smem, acc);
      store_strip<kB>(Lm, K + m * nn, n, r0, s, acc);
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
        strip_product<kB, kLowerB>(
            Lm + static_cast<size_t>(r0) * n + s, n, n - r0,
            minvs + (static_cast<size_t>(m) * nb + k) * kB * kB, kB, kB, 0,
            smem, acc);
        store_strip<kB>(Lm, nullptr, n, r0, s, acc);
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
