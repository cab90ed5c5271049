// Regularized incomplete beta function I_x(a, b) and its inverse, in two
// forms with the same arithmetic: one warp per element (small launches) and
// one thread per element (larger ones).
//
// Not the port of a Pallas kernel.  The JAX package takes betainc from
// jax.scipy.special, where XLA evaluates a continued fraction in one
// compiled while loop (jax._src.lax.special.regularized_incomplete_beta_impl),
// and writes betaincinv (gsum_tpu/stats/_special.py:33) as a fori_loop of 50
// bracketed Newton steps, each of which calls betainc.  In eager PyTorch every
// term of the continued fraction costs some twenty launches and a quantile
// 10^4 to 10^5 of them, so here each function is one kernel that runs the
// whole loop in registers, the card's counterpart of XLA's single loop.
//
// The arithmetic is that of the plain versions in
// gsum_tpu_torch/stats/_special.py, operation for operation, in both forms:
// - betainc: XLA's edge values, the swap I_x(a, b) = 1 - I_{1-x}(b, a) where
//   x >= (a + 1) / (a + b + 2), the Lentz-Thompson-Barnett continued
//   fraction with the partial numerators of DLMF 8.17.22, tiny and threshold
//   eps / 2, at most 200 terms (float) or 600 (double), stopped at each
//   element's own first converged term, and the prefactor
//   exp(a log x + b log1p(-x) - log B(a, b)) / a.  (XLA runs every element
//   until all have converged, so its values move with their batch, by up to
//   2e-13 relative.)
// - betaincinv: the JAX package's initial guess and its bracketed Newton
//   step with a bisection fallback, 50 steps.  The step is a function of
//   (x, lo, hi) alone, so an element stops when a step leaves all three
//   unchanged, with the 50th step's result.
// An element's value is thus the plain version's whatever the form and the
// size of its launch.  That matters most for betaincinv: where its 50
// Newton steps do not converge (a step at the root leaves the bracket and
// falls back to bisection: 60 of the first 8192 of the beta bands'
// arguments in time_incbeta, 452 of a QQ panel's 1024 t quantiles at
// 20485 degrees of freedom), where the iteration ends depends on every
// rounding of every betainc it takes.  A continued fraction evaluated in
// another order (the product of the recurrence's 2x2 matrices by a
// shuffle scan: 0.08 ms for helpers.hpd's one-element quantile on an H100)
// ends such elements up to 5e-10 from the plain version's, beyond its
// 1e-11 limit, so neither form reorders it.
//
// What bounds it.  The inputs are three numbers an element and the output
// one; the work is the continued fraction's terms, about 20 floating-point
// operations each, in one dependent chain per element (8.7 to 24 Newton
// steps of 13 to 100 terms each for a quantile), in which each term waits
// on two divisions (c = 1 + num / c, d = 1 / (1 + num d)) that run side by
// side.  So a launch is bound by that chain's latency unless it holds
// enough elements to fill the card:
// - The thread form (larger launches) gives each element a thread, in
//   blocks of 64 so that a (4096, 5) launch covers every SM.  Per term its
//   chain also waits on the partial numerator's division and on the stop
//   test's branch, and a warp runs as long as its slowest lane.
// - The warp form (small launches: helpers.hpd's 57 one-element quantiles,
//   an interval's two) gives each element a warp.  Its even lanes run the
//   c recurrence and its odd lanes the d one, so that the two divisions of
//   a term are one division of the warp; lane k forms the partial
//   numerator of term n0 + k, 32 at a time, so that they cost one
//   division's time; and the stop test comes after chunks of 8 terms,
//   whose numerators are shuffled from their lanes before the chunk, so
//   that the chain waits per term on one division alone (about 160 ns a
//   term on an H100 80GB HBM3 at 700 W).  The value after
//   the chunk's first converged term is kept (up to 7 terms run past it are
//   discarded).  lgamma(a), lgamma(b) and lgamma(a + b) are taken once per
//   element by three lanes at once; within a Newton step log x,
//   log1p(-x), log(1 - x) and log1p(-(1 - x)) by four lanes, and the
//   prefactor's exp beside the density's.  Blocks of 4 warps walk the
//   elements by warp (grid-stride), the grid sized from the SM count and
//   the blocks that fit on an SM.
// Both forms take each element's lgammas and the swap's threshold once,
// outside the Newton loop.  The wrapper (ops/incbeta.py) picks the form by
// the launch's size.
//
// The library is built without -use_fast_math, so division and sqrt are
// IEEE-rounded and exp, log, log1p, pow and lgamma are the CUDA math
// library's, which PyTorch's own CUDA operators call too.  nvcc would fuse a
// product and a following sum into one fused multiply-add, which rounds once
// where the plain version's two operators round twice; every such product is
// written as mul() (__fmul_rn / __dmul_rn, never fused), so that on the card
// the kernel and the plain version round alike.
//
// The host entries launch on the stream they are given, allocate nothing,
// and return the first CUDA error of the launch (0 if none).  `terms`, when
// not null, receives each element's count of continued-fraction terms up
// to its stop term (summed over the Newton steps for betaincinv), to bound
// the launch; `chunks`, the chunks of 8 terms that its warp ran (0 in the
// thread form).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreadBlock = 64;   // threads a block, one element each
constexpr int kWarpBlock = 128;    // threads a block, 4 warps, one element each
constexpr unsigned kFull = 0xffffffffu;

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

// The n-th partial numerator (n >= 1), as XLA writes it; ab = a + b.
template <typename T>
__device__ T numerator(int n, T a, T b, T x, T ab) {
  if (n == 1) return T(1);
  const T m = static_cast<T>((n - 1) / 2);
  if (n % 2 == 0)
    return m == T(0) ? -ab * x / (a + T(1))
                     : -(a + m) * (ab + m) * x /
                           ((a + T(2) * m) * (a + T(2) * m + T(1)));
  return m * (b - m) * x / ((a + T(2) * m - T(1)) * (a + T(2) * m));
}

// The state of the Lentz-Thompson-Barnett loop: the value h and the two
// ratios c and d.
template <typename T> struct Lentz { T h, c, d; };

template <typename T>
__device__ Lentz<T> lentz_start() {
  const T small = Limits<T>::eps() / T(2);
  return {small, small, T(0)};
}

// One term of the loop with partial numerator `num`; returns delta, whose
// |delta - 1| < eps / 2 stops the fraction.
template <typename T>
__device__ T lentz_step(T num, Lentz<T>& s) {
  const T small = Limits<T>::eps() / T(2);
  s.c = T(1) + num / s.c;
  if (fabs(s.c) < small) s.c = small;
  T d = T(1) + mul(num, s.d);
  if (fabs(d) < small) d = small;
  s.d = T(1) / d;
  const T delta = mul(s.c, s.d);
  s.h = mul(s.h, delta);
  return delta;
}

template <typename T>
__device__ bool converged(T delta) {
  // NaN counts as converged, as in XLA
  return !(fabs(delta - T(1)) >= Limits<T>::eps() / T(2));
}

// The continued fraction of I_x(a, b) without its prefactor, by one
// thread: a term at a time up to the first converged one or the cap.
// `terms` counts the terms taken.
template <typename T>
__device__ T cf_thread(T a, T b, T x, int& terms) {
  const T ab = a + b;
  Lentz<T> s = lentz_start<T>();
  for (int n = 1; n < Limits<T>::kTerms; ++n) {
    const T delta = lentz_step(numerator(n, a, b, x, ab), s);
    ++terms;
    if (converged(delta)) break;
  }
  return s.h;
}

// The same by a warp (a, b and x the same on every lane), with the same
// value.  Per term the loop waits on two divisions, c = 1 + num / c and
// d = 1 / (1 + num d), which the warp runs as one: the even lanes hold c
// and divide num by it, the odd lanes hold d and divide 1 by 1 + num d.
// Lane k forms the partial numerators of terms n0 + k (32 at a time); a
// chunk of kChunk terms runs the two recurrences without a test, its
// numerators shuffled from their lanes beforehand, and then the products
// delta = c d (c and d swapped between a lane and its partner), the value
// h and the stop test, which keeps the value after the chunk's first
// converged term (or the cap, kTerms - 1) and discards the terms after it.
// `terms` counts the terms up to the stop term, `chunks` the chunks run.
constexpr int kChunk = 8;

template <typename T>
__device__ T cf_warp(T a, T b, T x, int lane, int& terms, int& chunks) {
  constexpr int kCap = Limits<T>::kTerms - 1;   // the last term taken
  const T small = Limits<T>::eps() / T(2);
  const T ab = a + b;
  const bool odd = lane & 1;
  T cd = odd ? T(0) : small;   // c on the even lanes, d on the odd ones
  T h = small;
  for (int n0 = 1;; n0 += 32) {
    const T mine = numerator(n0 + lane, a, b, x, ab);
#pragma unroll 1
    for (int k0 = 0; k0 < 32; k0 += kChunk) {
      T num[kChunk], seen[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        num[k] = __shfl_sync(kFull, mine, k0 + k);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        T e = T(1) + mul(num[k], cd);            // the odd lanes' 1 + num d
        if (fabs(e) < small) e = small;
        const T q = (odd ? T(1) : num[k]) / (odd ? e : cd);
        T c = T(1) + q;                          // the even lanes' new c
        if (fabs(c) < small) c = small;
        cd = odd ? q : c;
        seen[k] = cd;
      }
      ++chunks;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const T delta = mul(seen[k], __shfl_xor_sync(kFull, seen[k], 1));
        h = mul(h, delta);
        if (converged(delta) || n0 + k0 + k == kCap) {
          terms += k + 1;
          return h;
        }
      }
      terms += kChunk;
    }
  }
}

// lgamma(a), lgamma(b) and lgamma(a + b) of one element.
template <typename T> struct Lgammas { T a, b, ab; };

template <typename T>
__device__ Lgammas<T> lgammas_thread(T a, T b) {
  return {lgam(a), lgam(b), lgam(a + b)};
}

// The same by three lanes at once, on every lane.
template <typename T>
__device__ Lgammas<T> lgammas_warp(T a, T b, int lane) {
  const T v = lgam(lane == 0 ? a : lane == 1 ? b : a + b);
  return {__shfl_sync(kFull, v, 0), __shfl_sync(kFull, v, 1),
          __shfl_sync(kFull, v, 2)};
}

// XLA's edge values of betainc; true where one applies, with it in *out.
template <typename T>
__device__ bool edge(T a, T b, T x, T* out) {
  const T inf = static_cast<T>(INFINITY);
  const bool a_is_zero = a == T(0) || b == inf;
  const bool b_is_zero = b == T(0) || a == inf;
  const bool x_is_zero = x == T(0), x_is_one = x == T(1);
  const bool is_nan = isnan(a) || isnan(b) || isnan(x);
  if (a < T(0) || b < T(0) || x < T(0) || x > T(1) ||
      (a_is_zero && b_is_zero) || is_nan) {
    *out = static_cast<T>(NAN);
    return true;
  }
  if ((a_is_zero && !x_is_zero) || (b_is_zero && x_is_one)) {
    *out = T(1);
    return true;
  }
  if ((b_is_zero && !x_is_one) || (a_is_zero && x_is_zero)) {
    *out = T(0);
    return true;
  }
  return false;
}

// The logs of x and 1 - x that betainc's prefactor and the Newton step's
// density take: log x and log1p(-x); log(1 - x) and log1p(-(1 - x)), the
// prefactor's after the swap.
template <typename T> struct Logs { T lx, l1x, lxs, l1xs; };

// Where the swap is not taken the prefactor reuses log x and log1p(-x);
// without `newton`, log x and log1p(-x) are left out where it is.
template <typename T>
__device__ Logs<T> logs_thread(T x, bool swap, bool newton) {
  if (!swap) {
    const T l = lg(x), l1 = lg1p(-x);
    return {l, l1, l, l1};
  }
  const T xs = T(1) - x;
  return {newton ? lg(x) : T(0), newton ? lg1p(-x) : T(0), lg(xs),
          lg1p(-xs)};
}

// All four by four lanes at once, on every lane.
template <typename T>
__device__ Logs<T> logs_warp(T x, int lane) {
  const T arg = lane < 2 ? x : T(1) - x;
  const T v = lane & 1 ? lg1p(-arg) : lg(arg);
  return {__shfl_sync(kFull, v, 0), __shfl_sync(kFull, v, 1),
          __shfl_sync(kFull, v, 2), __shfl_sync(kFull, v, 3)};
}

// The exponent of betainc's prefactor after the swap (a, b, x already
// swapped; l = log x, l1 = log1p(-x) of that x), and whether a is so small
// that a Γ(a) = Γ(a + 1) is used.
template <typename T>
__device__ T prefactor_arg(T a, T b, T l, T l1, const Lgammas<T>& g,
                           bool swap, bool* small_a) {
  // log B(a, b) in the plain version's order, for each side of the swap
  const T lbeta_small_a = swap ? g.a - g.ab : g.b - g.ab;
  const T lbeta = (swap ? g.b : g.a) + lbeta_small_a;
  *small_a = a < Limits<T>::tiny() * T(2);
  return *small_a ? mul(l1, b) - lbeta_small_a
                  : mul(l, a) + mul(l1, b) - lbeta;
}

// The inputs of one betainc after the swap, taken where x is not below
// the threshold (a + 1) / (a + b + 2), which depends on a and b alone.
template <typename T> struct Swapped { T a, b, x; bool swap; };

template <typename T>
__device__ T swap_point(T a, T b) { return (a + T(1)) / (a + b + T(2)); }

template <typename T>
__device__ Swapped<T> swapped(T a, T b, T x, T thr) {
  return x < thr ? Swapped<T>{a, b, x, false}
                 : Swapped<T>{b, a, T(1) - x, true};
}

template <typename T>
__device__ T betainc_thread(T a, T b, T x, T thr, const Lgammas<T>& g,
                            const Logs<T>& lo, int& terms) {
  T out;
  if (edge(a, b, x, &out)) return out;
  const Swapped<T> s = swapped(a, b, x, thr);
  const T cf = cf_thread(s.a, s.b, s.x, terms);
  bool small_a;
  const T arg = prefactor_arg(s.a, s.b, s.swap ? lo.lxs : lo.lx,
                              s.swap ? lo.l1xs : lo.l1x, g, s.swap, &small_a);
  const T factor = small_a ? ex(arg) : ex(arg) / s.a;
  const T result = mul(cf, factor);
  return s.swap ? T(1) - result : result;
}

// betainc by the warp; with `density` not null, the exp of the Newton
// step's density exponent `d_arg` is taken beside the prefactor's.
template <typename T>
__device__ T betainc_warp(T a, T b, T x, T thr, const Lgammas<T>& g,
                          const Logs<T>& lo, int lane, int& terms, int& chunks,
                          T d_arg, T* density) {
  T out;
  if (edge(a, b, x, &out)) {
    if (density) *density = ex(d_arg);
    return out;
  }
  const Swapped<T> s = swapped(a, b, x, thr);
  bool small_a;
  const T arg = prefactor_arg(s.a, s.b, s.swap ? lo.lxs : lo.lx,
                              s.swap ? lo.l1xs : lo.l1x, g, s.swap, &small_a);
  const T e = ex(lane == 1 ? d_arg : arg);
  const T e0 = __shfl_sync(kFull, e, 0);
  if (density) *density = __shfl_sync(kFull, e, 1);
  const T factor = small_a ? e0 : e0 / s.a;
  const T cf = cf_warp(s.a, s.b, s.x, lane, terms, chunks);
  const T result = mul(cf, factor);
  return s.swap ? T(1) - result : result;
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

// The JAX package's initial guess of betaincinv.
template <typename T>
__device__ T start(T a, T b, T p) {
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
  return x;
}

// One bracketed Newton step's new (x, lo, hi) from err = betainc - p and
// the density t; returns whether the step left all three unchanged.
template <typename T>
__device__ bool newton(T err, T t, T& x, T& lo, T& hi) {
  const T lo_n = err < T(0) ? (isnan(x) || isnan(lo) ? static_cast<T>(NAN)
                                                     : fmax(lo, x))
                            : lo;
  const T hi_n = err > T(0) ? (isnan(x) || isnan(hi) ? static_cast<T>(NAN)
                                                     : fmin(hi, x))
                            : hi;
  const T step = x - (t > T(0) ? err / t : T(0));
  const bool good = isfinite(step) && step > lo_n && step < hi_n;
  const T x_n = good ? step : T(0.5) * (lo_n + hi_n);
  const bool same = (x_n == x || (isnan(x_n) && isnan(x))) &&
                    (lo_n == lo || (isnan(lo_n) && isnan(lo))) &&
                    (hi_n == hi || (isnan(hi_n) && isnan(hi)));
  x = x_n;
  lo = lo_n;
  hi = hi_n;
  return same;
}

template <typename T>
__device__ T domain(T x, T p) {
  if (p == T(0)) x = T(0);
  if (p == T(1)) x = T(1);
  if (p < T(0) || p > T(1)) x = static_cast<T>(NAN);
  return x;
}

// The density's exponent (a - 1) log x + (b - 1) log1p(-x) - log B(a, b).
template <typename T>
__device__ T density_arg(T a, T b, const Logs<T>& lo, T afac) {
  return mul(a - T(1), lo.lx) + mul(b - T(1), lo.l1x) + afac;
}

template <typename T>
__device__ T betaincinv_thread(T a, T b, T p, int& terms) {
  const Lgammas<T> g = lgammas_thread(a, b);
  const T afac = -g.a - g.b + g.ab, thr = swap_point(a, b);
  T x = start(a, b, p), lo = T(0), hi = T(1);
  for (int step = 0; step < 50; ++step) {
    const Logs<T> l = logs_thread(x, !(x < thr), true);
    const T err = betainc_thread(a, b, x, thr, g, l, terms) - p;
    if (newton(err, ex(density_arg(a, b, l, afac)), x, lo, hi)) break;
  }
  return domain(x, p);
}

template <typename T>
__device__ T betaincinv_warp(T a, T b, T p, int lane, int& terms,
                             int& chunks) {
  const Lgammas<T> g = lgammas_warp(a, b, lane);
  const T afac = -g.a - g.b + g.ab, thr = swap_point(a, b);
  T x = start(a, b, p), lo = T(0), hi = T(1);
  for (int step = 0; step < 50; ++step) {
    const Logs<T> l = logs_warp(x, lane);
    T t;
    const T err = betainc_warp(a, b, x, thr, g, l, lane, terms, chunks,
                               density_arg(a, b, l, afac), &t) - p;
    if (newton(err, t, x, lo, hi)) break;
  }
  return domain(x, p);
}

template <typename T, bool kInverse>
__global__ void __launch_bounds__(kThreadBlock)
    thread_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ u, T* __restrict__ out,
                  int* __restrict__ terms, int* __restrict__ chunks,
                  long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int k = 0;
    T r;
    if (kInverse) {
      r = betaincinv_thread(a[i], b[i], u[i], k);
    } else {
      const T x = u[i], thr = swap_point(a[i], b[i]);
      const Logs<T> l = logs_thread(x, !(x < thr), false);
      r = betainc_thread(a[i], b[i], x, thr, lgammas_thread(a[i], b[i]), l,
                         k);
    }
    out[i] = r;
    if (terms) terms[i] = k;
    if (chunks) chunks[i] = 0;
  }
}

template <typename T, bool kInverse>
__global__ void __launch_bounds__(kWarpBlock)
    warp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ u, T* __restrict__ out,
                int* __restrict__ terms, int* __restrict__ chunks,
                long long n) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * blockDim.x / 32;
  for (long long i = (blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x) / 32;
       i < n; i += warps) {
    int k = 0, c = 0;
    T r;
    if (kInverse) {
      r = betaincinv_warp(a[i], b[i], u[i], lane, k, c);
    } else {
      r = betainc_warp(a[i], b[i], u[i], swap_point(a[i], b[i]),
                       lgammas_warp(a[i], b[i], lane), logs_warp(u[i], lane),
                       lane, k, c, T(0), static_cast<T*>(nullptr));
    }
    if (lane == 0) {
      out[i] = r;
      if (terms) terms[i] = k;
      if (chunks) chunks[i] = c;
    }
  }
}

// Blocks for `items` of `per_block` each: enough to cover them, at most as
// many as fit on the card at once (its SMs times the blocks an SM holds).
// `fits` caches the latter by device.
int grid_for(const void* kernel, int threads, long long items, int per_block,
             int (&fits)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int most = dev < 64 ? fits[dev] : 0;
  if (!most) {
    int sms = 0, resident = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads,
                                                  0);
    most = sms * (resident > 0 ? resident : 1);
    if (dev < 64) fits[dev] = most;
  }
  const long long need = (items + per_block - 1) / per_block;
  return static_cast<int>(need < most ? need : most);
}

template <typename T, bool kInverse>
int launch(const T* a, const T* b, const T* u, T* out, int* terms,
           int* chunks, long long n, int warp, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  static int fits_warp[64], fits_thread[64];
  if (warp) {
    const void* k = reinterpret_cast<const void*>(&warp_kernel<T, kInverse>);
    warp_kernel<T, kInverse><<<grid_for(k, kWarpBlock, n, kWarpBlock / 32,
                                        fits_warp),
                               kWarpBlock, 0, s>>>(a, b, u, out, terms,
                                                   chunks, n);
  } else {
    const void* k =
        reinterpret_cast<const void*>(&thread_kernel<T, kInverse>);
    thread_kernel<T, kInverse><<<grid_for(k, kThreadBlock, n, kThreadBlock,
                                          fits_thread),
                                 kThreadBlock, 0, s>>>(a, b, u, out, terms,
                                                       chunks, n);
  }
  return cudaGetLastError();
}

}  // namespace

// `warp`: 1 one warp per element, 0 one thread per element.
extern "C" int gsum_betainc_f32(const float* a, const float* b,
                                const float* x, float* out, int* terms,
                                int* chunks, long long n, int warp,
                                void* stream) {
  return launch<float, false>(a, b, x, out, terms, chunks, n, warp, stream);
}

extern "C" int gsum_betainc_f64(const double* a, const double* b,
                                const double* x, double* out, int* terms,
                                int* chunks, long long n, int warp,
                                void* stream) {
  return launch<double, false>(a, b, x, out, terms, chunks, n, warp, stream);
}

extern "C" int gsum_betaincinv_f32(const float* a, const float* b,
                                   const float* p, float* out, int* terms,
                                   int* chunks, long long n, int warp,
                                   void* stream) {
  return launch<float, true>(a, b, p, out, terms, chunks, n, warp, stream);
}

extern "C" int gsum_betaincinv_f64(const double* a, const double* b,
                                   const double* p, double* out, int* terms,
                                   int* chunks, long long n, int warp,
                                   void* stream) {
  return launch<double, true>(a, b, p, out, terms, chunks, n, warp, stream);
}
