// The panel-blocked factor + inverse shared by the diagonal-block kernel
// (chol_inv_block.cu) and the fused blocked Cholesky (fused_chol.cu): one
// thread block turns an SPD block into its lower Cholesky factor L and
// M = L^{-1}.
//
// It computes what gsum_tpu/ops/pallas_chol.py::_make_kernel computes, with
// that kernel's two levels (pallas_chol.py:11-18): the serial work stays
// inside 32-wide panels, and everything across panels is a product.  For
// each panel p (columns j0 .. e = j0 + 32):
//   (A) one warp factors the panel's 32 x 32 diagonal tile and forms its
//       leaf inverse Md in registers; pivots and columns move by
//       __shfl_sync, so the 32 serial column steps have no block barrier and
//       no shared-memory round trip (panel_diagonal says how);
//   (B) the block forms, as 32 x 32 warp tiles, the panel below the tile,
//       L[e:, j0:e] = W[e:, j0:e] Md^T, and the panel's rows of the
//       inverse, M[j0:e, :j0] = Md B_p (B_p held in those rows of M);
//   (C) the block applies the rank-32 updates: the trailing lower triangle
//       W[e:, e:] -= L[e:, j0:e] L[e:, j0:e]^T, and the inverse rows below,
//       M[e:, :e] -= L[e:, j0:e] M[j0:e, :e].  (B) and (C) together are
//       blocked forward substitution for L M = I in outer-product order,
//       the glued rows M[q,:] = Mqq (I[q,:] - L[q,:j0] M[:j0,:]) of
//       pallas_chol.py:17-18.
// Look-ahead: in (C) warp 0 first updates the next panel's diagonal tile and
// then runs (A) on it while the other warps finish (C).  A panel costs two
// block barriers (after B and after C): 8 in all at nb = 128, against 256
// for a loop with a barrier pair per column.
//
// What bounds it: at nb = 128 the work is 2 nb^3 / 3 flops, a few
// microseconds of one SM's FFMA rate, so neither bytes nor flops do: the
// chain of dependent steps does.  On the H100 (time_phases.py) each (A) takes
// about 5.6 us, 32 steps of one warp whose shuffles and FFMAs issue in
// order; (B) takes about 1.6 us and (C), which holds the next (A), 7-8 us.
//
// A warp tile is 32 x 32 outputs over a depth of 32: lane (ly, lx) =
// (lane / 8, lane % 8) owns rows ly + 4a (a < 8) and columns lx + 8b
// (b < 4), so each depth step is 12 loads for 32 FFMAs.  With row strides
// congruent to 1 mod 32 (nb + 1, as the callers stage them) the loads of a
// step fall on distinct banks or are broadcasts.
//
// On entry W holds the block's lower triangle (its strict upper triangle is
// neither read nor written) and M the identity; on exit W holds L and M
// holds L^{-1}.  W and M may lie in shared or global memory, with row
// strides ldw and ldm.  When they lie in global memory the caller passes Ps
// (nb x kPanelLd floats) and Xs (32 x nb floats) in shared memory: each
// panel of L and each X_p = M[j0:e, :e] is written there too, and (C) reads
// its operands from them.  With Ps == nullptr, (C) reads W and M directly.
// Every thread of the block calls the routine; blockDim.x is a multiple of
// 32, at least 64, and the routine ends with a block barrier.
//
// A non-positive pivot is not clamped and does not stop the loop: it gives
// NaN (pivot * rsqrtf(pivot)), which propagates into the factor's diagonal,
// where the callers' success flag (all(isfinite(d) & (d > 0))) reads it.

#pragma once

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPanel = 32;
constexpr int kPanelLd = kPanel + 1;  // row stride of the staged panel Ps

// acc = sum_{u < 32} A(i, u) B(u, c) over one warp's 32 x 32 tile: A is
// row-major (A[i * lda + u]); B(u, c) is B[c * ldb + u] when kTransB, else
// B[u * ldb + c].
template <bool kTransB>
__device__ __forceinline__ void warp_tile_product(const float* A, int lda,
                                                  const float* B, int ldb,
                                                  float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int ly = lane >> 3;
  const int lx = lane & 7;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int u = 0; u < kPanel; ++u) {
    float av[8], bv[4];
#pragma unroll
    for (int a = 0; a < 8; ++a) av[a] = A[(ly + 4 * a) * lda + u];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bv[b] = kTransB ? B[(lx + 8 * b) * ldb + u] : B[u * ldb + lx + 8 * b];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// (A) for the panel at column j0, by the calling warp: the 32 x 32 tile of
// W becomes L's, and its leaf inverse Md goes into M's tile (and into Xs,
// row stride ldx).  Lane i holds row i of the tile in a[] and column i of
// the substitution's right-hand side in m[], both rotated: at step j,
// a[k] = W(i, j + k) and m[k] = rhs(j + k, i).  So every step runs the same
// code on fixed registers, and the loop over steps stays a loop: unrolled,
// the 32 steps would be several thousand instructions, more than the
// instruction cache holds.  Step j broadcasts L's column j once
// (__shfl_sync); the rank-1 update of the rows below and the forward
// substitution for L Md = I (in outer-product order) both use it.  Lanes
// that a step leaves alone get a multiplier of 0, not a branch; the
// entries of a[] above the diagonal take garbage and are never read.
__device__ __forceinline__ void panel_diagonal(float* W, int ldw, float* M,
                                               int ldm, int j0, float* Xs,
                                               int ldx) {
  const int lane = threadIdx.x & 31;
  float a[kPanel], m[kPanel];
  float* Wrow = W + (j0 + lane) * ldw + j0;
  float* Mcol = M + j0 * ldm + j0 + lane;
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
    a[k] = k <= lane ? Wrow[k] : 0.f;
    m[k] = k == lane ? 1.f : 0.f;
  }
#pragma unroll 1
  for (int j = 0; j < kPanel; ++j) {
    const float pivot = __shfl_sync(kFullMask, a[0], j);
    const float rd = rsqrtf(pivot);
    const float l = lane == j ? pivot * rd : a[0] * rd;  // L(i, j), i >= j
    const float lm = lane > j ? l : 0.f;
    const float mt = m[0] * rd;                          // Md(j, i)
    if (lane >= j) Wrow[j] = l;
    Mcol[j * ldm] = mt;
    if (Xs) Xs[j * ldx + j0 + lane] = mt;
#pragma unroll
    for (int k = 1; k < kPanel; ++k) {
      const float lk = __shfl_sync(kFullMask, lm, (j + k) & 31);  // L(j+k, j)
      a[k - 1] = fmaf(-lm, lk, a[k]);
      m[k - 1] = fmaf(-lk, mt, m[k]);
    }
  }
}

__device__ __forceinline__ void chol_inv_panels(float* W, int ldw, float* M,
                                                int ldm, int nb, float* Ps,
                                                float* Xs) {
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ly = lane >> 3;
  const int lx = lane & 7;
  // (C) reads the panel as P(r, t) = P[r * ldp + t] and X_p as
  // X(t, c) = X[t * ldx + c]
  const int ldp = Ps ? kPanelLd : ldw;
  const int ldx = Xs ? nb : ldm;
  float acc[8][4];

  if (warp == 0) panel_diagonal(W, ldw, M, ldm, 0, Xs, nb);
  __syncthreads();
  for (int j0 = 0;; j0 += kPanel) {
    const int e = j0 + kPanel;
    const int p = j0 / kPanel;
    const int nq = (nb - e) / kPanel;  // 32-row tiles below the panel
    const float* Md = M + j0 * ldm + j0;

    // (B): nq tiles of the panel below, then p tiles of X_p.  Each task
    // reads only the tile it overwrites (and Md), so a warp barrier
    // between its reads and its writes suffices.
    for (int t = warp; t < nq + p; t += nwarps) {
      if (t < nq) {
        const int r0 = e + kPanel * t;
        float* A = W + r0 * ldw + j0;
        warp_tile_product<true>(A, ldw, Md, ldm, acc);
        __syncwarp();
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = ly + 4 * a;
            const int c = lx + 8 * b;
            A[i * ldw + c] = acc[a][b];
            if (Ps) Ps[(r0 + i) * kPanelLd + c] = acc[a][b];
          }
      } else {
        const int c0 = kPanel * (t - nq);
        float* Bp = M + j0 * ldm + c0;
        warp_tile_product<false>(Md, ldm, Bp, ldm, acc);
        __syncwarp();
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = ly + 4 * a;
            const int c = lx + 8 * b;
            Bp[i * ldm + c] = acc[a][b];
            if (Xs) Xs[i * nb + c0 + c] = acc[a][b];
          }
      }
    }
    __syncthreads();
    if (nq == 0) break;

    // (C): nq (nq + 1) / 2 lower tiles of the trailing triangle, then
    // nq (p + 1) tiles of the inverse rows below.  Task 0, the next panel's
    // diagonal tile, is warp 0's, which then runs (A) on it; the other
    // warps share the rest.
    const float* P = Ps ? Ps : W + j0;
    const float* X = Xs ? Xs : M + j0 * ldm;
    const int ntri = nq * (nq + 1) / 2;
    const int ntasks = ntri + nq * (p + 1);
    const int step = warp == 0 ? ntasks : nwarps - 1;
    for (int t = warp; t < ntasks; t += step) {
      if (t < ntri) {
        int I = 0;
        while ((I + 1) * (I + 2) / 2 <= t) ++I;
        const int K = t - I * (I + 1) / 2;
        const int r0 = e + kPanel * I;
        const int c0 = e + kPanel * K;
        warp_tile_product<true>(P + r0 * ldp, ldp, P + c0 * ldp, ldp, acc);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = ly + 4 * a;
            const int c = lx + 8 * b;
            if (I > K || c <= i) W[(r0 + i) * ldw + c0 + c] -= acc[a][b];
          }
      } else {
        const int I = (t - ntri) / (p + 1);
        const int c0 = kPanel * ((t - ntri) % (p + 1));
        const int r0 = e + kPanel * I;
        warp_tile_product<false>(P + r0 * ldp, ldp, X + c0, ldx, acc);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            M[(r0 + ly + 4 * a) * ldm + c0 + lx + 8 * b] -= acc[a][b];
      }
    }
    if (warp == 0) {
      __syncwarp();
      panel_diagonal(W, ldw, M, ldm, e, Xs, nb);
    }
    __syncthreads();
  }
}
