// Regularized incomplete beta function I_x(a, b) and its inverse, one
// thread per element.
//
// Not the port of a Pallas kernel.  The JAX package takes betainc from
// jax.scipy.special, where XLA evaluates a continued fraction in one
// compiled while loop (jax._src.lax.special.regularized_incomplete_beta_impl),
// and writes betaincinv (gsum_tpu/stats/_special.py:33) as a fori_loop of 50
// bracketed Newton steps, each of which calls betainc.  In eager PyTorch every
// term of the continued fraction costs some twenty launches and a quantile
// 10^4 to 10^5 of them, so here each function is one kernel whose threads run
// the whole loop in registers, the card's counterpart of XLA's single loop.
//
// The arithmetic is that of the plain versions in
// gsum_tpu_torch/stats/_special.py, operation for operation:
// - betainc: XLA's edge values, the swap I_x(a, b) = 1 - I_{1-x}(b, a) where
//   x >= (a + 1) / (a + b + 2), the Lentz-Thompson-Barnett continued
//   fraction with the partial numerators of DLMF 8.17.22, tiny and threshold
//   eps / 2, at most 200 terms (float) or 600 (double), and the prefactor
//   exp(a log x + b log1p(-x) - log B(a, b)) / a.  A thread stops at its own
//   element's first converged term, as the plain version freezes each
//   element there.  (XLA runs every element until all have converged, so
//   its values move with their batch, by up to 2e-13 relative.)
// - betaincinv: the JAX package's initial guess and its bracketed Newton
//   step with a bisection fallback, 50 steps.  The step is a function of
//   (x, lo, hi) alone, so a thread stops when a step leaves all three
//   unchanged, with the 50th step's result.
// The library is built without -use_fast_math, so division and sqrt are
// IEEE-rounded and exp, log, log1p, pow and lgamma are the CUDA math
// library's, which PyTorch's own CUDA operators call too.  nvcc would fuse a
// product and a following sum into one fused multiply-add, which rounds once
// where the plain version's two operators round twice; every such product is
// written as mul() (__fmul_rn / __dmul_rn, never fused), so that on the card
// the kernel and the plain version round alike.
//
// What bounds it: operations.  Per term the continued fraction does about
// 20 floating-point operations, two of them divisions and one a reciprocal,
// in a dependent chain; the inputs are three numbers per element and the
// output one.  So a launch is bound by the terms its elements need, at the
// card's non-tensor-core rate, and a single element (a scalar quantile) by
// the chain's latency.  The design keeps every thread's loop in registers
// and reads and writes each element once; elements that converge in fewer
// terms leave their warp's other threads running (divergence), which the
// plain version's all-element loop has too.
//
// The host entries launch on the stream they are given, allocate nothing,
// and return the first CUDA error of the launch (0 if none).  `terms`, when
// not null, receives each element's count of continued-fraction terms
// (summed over the Newton steps for betaincinv), to bound the launch.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T> struct Limits;
template <> struct Limits<float> {
  static constexpr int kTerms = 200;
  static __device__ float eps() { return FLT_EPSILON; }
  static __device__ float tiny() { return FLT_MIN; }
};
template <> struct Limits<double> {
  static constexpr int kTerms = 600;
  static __device__ double eps() { return DBL_EPSILON; }
  static __device__ double tiny() { return DBL_MIN; }
};

__device__ inline float mul(float u, float v) { return __fmul_rn(u, v); }
__device__ inline double mul(double u, double v) { return __dmul_rn(u, v); }
__device__ inline float lgam(float v) { return lgammaf(v); }
__device__ inline double lgam(double v) { return lgamma(v); }
__device__ inline float lg(float v) { return logf(v); }
__device__ inline double lg(double v) { return log(v); }
__device__ inline float lg1p(float v) { return log1pf(v); }
__device__ inline double lg1p(double v) { return log1p(v); }
__device__ inline float ex(float v) { return expf(v); }
__device__ inline double ex(double v) { return exp(v); }
__device__ inline float pw(float u, float v) { return powf(u, v); }
__device__ inline double pw(double u, double v) { return pow(u, v); }
__device__ inline float sq(float v) { return sqrtf(v); }
__device__ inline double sq(double v) { return sqrt(v); }

// The continued fraction of I_x(a, b) without its prefactor; `terms` counts
// the terms taken.
template <typename T>
__device__ T continued_fraction(T a, T b, T x, int& terms) {
  const T small = Limits<T>::eps() / T(2);
  const T ab = a + b;
  T h = small, c = small, d = T(0);
  for (int n = 1; n < Limits<T>::kTerms; ++n) {
    T num;
    if (n == 1) {
      num = T(1);
    } else {
      const T m = static_cast<T>((n - 1) / 2);
      if (n % 2 == 0)
        num = m == T(0) ? -ab * x / (a + T(1))
                        : -(a + m) * (ab + m) * x /
                              ((a + T(2) * m) * (a + T(2) * m + T(1)));
      else
        num = m * (b - m) * x / ((a + T(2) * m - T(1)) * (a + T(2) * m));
    }
    c = T(1) + num / c;
    if (fabs(c) < small) c = small;
    d = T(1) + mul(num, d);
    if (fabs(d) < small) d = small;
    d = T(1) / d;
    const T delta = c * d;
    h = h * delta;
    ++terms;
    if (!(fabs(delta - T(1)) >= small)) break;
  }
  return h;
}

template <typename T>
__device__ T betainc_one(T a, T b, T x, int& terms) {
  const T inf = static_cast<T>(INFINITY);
  const bool a_is_zero = a == T(0) || b == inf;
  const bool b_is_zero = b == T(0) || a == inf;
  const bool x_is_zero = x == T(0), x_is_one = x == T(1);
  const bool is_nan = isnan(a) || isnan(b) || isnan(x);
  if (a < T(0) || b < T(0) || x < T(0) || x > T(1) ||
      (a_is_zero && b_is_zero) || is_nan)
    return static_cast<T>(NAN);
  if ((a_is_zero && !x_is_zero) || (b_is_zero && x_is_one)) return T(1);
  if ((b_is_zero && !x_is_one) || (a_is_zero && x_is_zero)) return T(0);

  const bool converges = x < (a + T(1)) / (a + b + T(2));
  if (!converges) {
    const T t = a;
    a = b;
    b = t;
    x = T(1) - x;
  }
  const T cf = continued_fraction(a, b, x, terms);
  const T lbeta_small_a = lgam(b) - lgam(a + b);
  const T lbeta = lgam(a) + lbeta_small_a;
  const T factor =
      a < Limits<T>::tiny() * T(2)
          ? ex(mul(lg1p(-x), b) - lbeta_small_a)
          : ex(mul(lg(x), a) + mul(lg1p(-x), b) - lbeta) / a;
  const T result = mul(cf, factor);
  return converges ? result : T(1) - result;
}

// A&S 26.2.23, the initial guess's normal quantile.
template <typename T>
__device__ T ndtri_approx(T p) {
  T pp = p < T(0.5) ? p : T(1) - p;
  // clamp, NaN passing through as torch.clamp passes it
  if (pp < static_cast<T>(1e-300)) pp = static_cast<T>(1e-300);
  if (pp > T(0.5)) pp = T(0.5);
  const T t = sq(T(-2) * lg(pp));
  const T x = (static_cast<T>(2.30753) + mul(t, static_cast<T>(0.27061))) /
                  (T(1) + mul(t, static_cast<T>(0.99229) +
                                     mul(t, static_cast<T>(0.04481)))) -
              t;
  return p < T(0.5) ? -x : x;
}

template <typename T>
__device__ T betaincinv_one(T a, T b, T p, int& terms) {
  const T a1 = a - T(1), b1 = b - T(1);
  const T y_p = -ndtri_approx(p);
  const T al = (mul(y_p, y_p) - T(3)) / T(6);
  const T h = T(2) / (T(1) / (T(2) * a - T(1)) + T(1) / (T(2) * b - T(1)));
  const T w = y_p * sq(al + h) / h -
              mul(T(1) / (T(2) * b - T(1)) - T(1) / (T(2) * a - T(1)),
                  al + static_cast<T>(5.0 / 6.0) - T(2) / (T(3) * h));
  const T x_big = a / (a + mul(b, ex(T(2) * w)));
  const T lna = lg(a / (a + b)), lnb = lg(b / (a + b));
  const T t_ = ex(a * lna) / a, u_ = ex(b * lnb) / b;
  const T w_ = t_ + u_;
  const T x_small = p < t_ / w_ ? pw(a * w_ * p, T(1) / a)
                                : T(1) - pw(b * w_ * (T(1) - p), T(1) / b);
  T x = (a >= T(1) && b >= T(1)) ? x_big : x_small;
  // clip, NaN passing through as jnp.clip / torch.clamp pass it
  if (x < Limits<T>::tiny()) x = Limits<T>::tiny();
  if (x > static_cast<T>(1.0 - 1e-15)) x = static_cast<T>(1.0 - 1e-15);

  const T afac = -lgam(a) - lgam(b) + lgam(a + b);
  T lo = T(0), hi = T(1);
  for (int step = 0; step < 50; ++step) {
    const T err = betainc_one(a, b, x, terms) - p;
    const T lo_n = err < T(0) ? (isnan(x) || isnan(lo) ? static_cast<T>(NAN)
                                                       : fmax(lo, x))
                              : lo;
    const T hi_n = err > T(0) ? (isnan(x) || isnan(hi) ? static_cast<T>(NAN)
                                                       : fmin(hi, x))
                              : hi;
    const T t = ex(mul(a1, lg(x)) + mul(b1, lg1p(-x)) + afac);
    const T newton = x - (t > T(0) ? err / t : T(0));
    const bool good = isfinite(newton) && newton > lo_n && newton < hi_n;
    const T x_n = good ? newton : T(0.5) * (lo_n + hi_n);
    const bool same = (x_n == x || (isnan(x_n) && isnan(x))) &&
                      (lo_n == lo || (isnan(lo_n) && isnan(lo))) &&
                      (hi_n == hi || (isnan(hi_n) && isnan(hi)));
    x = x_n;
    lo = lo_n;
    hi = hi_n;
    if (same) break;
  }
  if (p == T(0)) x = T(0);
  if (p == T(1)) x = T(1);
  if (p < T(0) || p > T(1)) x = static_cast<T>(NAN);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    betainc_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ x, T* __restrict__ out,
                   int* __restrict__ terms, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int k = 0;
    out[i] = betainc_one(a[i], b[i], x[i], k);
    if (terms) terms[i] = k;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    betaincinv_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ p, T* __restrict__ out,
                      int* __restrict__ terms, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int k = 0;
    out[i] = betaincinv_one(a[i], b[i], p[i], k);
    if (terms) terms[i] = k;
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 1048576 ? blocks : 1048576);
}

}  // namespace

extern "C" int gsum_betainc_f32(const float* a, const float* b,
                                const float* x, float* out, int* terms,
                                long long n, void* stream) {
  betainc_kernel<float><<<grid_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a, b, x, out,
                                                               terms, n);
  return cudaGetLastError();
}

extern "C" int gsum_betainc_f64(const double* a, const double* b,
                                const double* x, double* out, int* terms,
                                long long n, void* stream) {
  betainc_kernel<double><<<grid_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a, b, x, out,
                                                                terms, n);
  return cudaGetLastError();
}

extern "C" int gsum_betaincinv_f32(const float* a, const float* b,
                                   const float* p, float* out, int* terms,
                                   long long n, void* stream) {
  betaincinv_kernel<float><<<grid_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      a, b, p, out, terms, n);
  return cudaGetLastError();
}

extern "C" int gsum_betaincinv_f64(const double* a, const double* b,
                                   const double* p, double* out, int* terms,
                                   long long n, void* stream) {
  betaincinv_kernel<double><<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      a, b, p, out, terms, n);
  return cudaGetLastError();
}
