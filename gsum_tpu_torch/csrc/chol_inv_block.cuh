// The column loop shared by the diagonal-block kernel (chol_inv_block.cu)
// and the fused blocked Cholesky (fused_chol.cu): one thread block turns an
// SPD block into its lower Cholesky factor L and M = L^{-1}.
//
// On entry W holds the block's lower triangle (the strict upper triangle is
// neither read nor written) and M the identity; on exit W holds L and M holds
// L^{-1}.  `col` is scratch for nb floats in shared memory.  W and M may live
// in shared or global memory, with row strides ldw and ldm.  Every thread of
// the block calls the routine; it needs blockDim.x >= nb.
//
// One loop over the columns j with two barriers per column.  Both outputs
// come out of the same right-looking elimination:
//   - L: the pivot is d = sqrt(W[j][j]); the column below it is divided by d
//     (and kept in `col`, so the update below reads it contiguously); the
//     trailing lower triangle takes the rank-1 update
//     W[i][k] -= L[i][j] L[k][j] for j < k <= i.
//   - M: row j is divided by d, which makes it final; the rows below take
//     M[i][c] -= L[i][j] M[j][c] for c <= j.  This is forward substitution
//     for L M = I in outer-product order, so no thread runs a long serial
//     dot product.
// In the update each thread owns one column c of the active rows (column c of
// W for c > j, of M for c <= j) and a share of the rows, so its multiplier
// stays in a register and consecutive threads touch consecutive addresses.
// Rows go in groups of kCholUnroll whose loads are issued before their
// stores: the compiler cannot prove that the rows do not alias, and without
// that the sweep would run one load-FMA-store latency at a time.
//
// A non-positive pivot is not clamped and does not stop the loop: sqrtf of a
// negative pivot gives NaN and a zero pivot gives 0, and both propagate into
// the factor's diagonal, where the callers' success flag
// (all(isfinite(d) & (d > 0))) reads them.

#pragma once

constexpr int kCholUnroll = 4;

__device__ __forceinline__ void chol_inv_columns(float* W, int ldw, float* M,
                                                 int ldm, float* col, int nb) {
  const int tid = threadIdx.x;
  for (int j = 0; j < nb; ++j) {
    // Every thread reads the pivot before the barrier; thread 0 stores it
    // after the barrier, so no thread reads a half-updated diagonal.
    const float d = sqrtf(W[j * ldw + j]);
    for (int i = j + 1 + tid; i < nb; i += blockDim.x) {
      const float v = W[i * ldw + j] / d;
      W[i * ldw + j] = v;
      col[i] = v;
    }
    for (int c = tid; c <= j; c += blockDim.x) M[j * ldm + c] /= d;
    __syncthreads();
    if (tid == 0) W[j * ldw + j] = d;
    // Thread (c, g) updates column c in rows j+1+g, j+1+g+G, ...; the L part
    // only on and below the diagonal (c <= i).  Threads beyond G * nb idle.
    const int G = blockDim.x / nb;
    const int c = tid % nb;
    const int g = tid / nb;
    if (g < G) {
      const bool mpart = c <= j;
      const float mult = mpart ? M[j * ldm + c] : col[c];
      float* base = mpart ? M : W;
      const int ld = mpart ? ldm : ldw;
      for (int i0 = j + 1 + g; i0 < nb; i0 += kCholUnroll * G) {
        float ci[kCholUnroll], v[kCholUnroll];
#pragma unroll
        for (int u = 0; u < kCholUnroll; ++u) {
          const int i = i0 + u * G;
          if (i < nb && (mpart || c <= i)) {
            ci[u] = col[i];
            v[u] = base[i * ld + c];
          }
        }
#pragma unroll
        for (int u = 0; u < kCholUnroll; ++u) {
          const int i = i0 + u * G;
          if (i < nb && (mpart || c <= i)) base[i * ld + c] = v[u] - ci[u] * mult;
        }
      }
    }
    __syncthreads();
  }
}
