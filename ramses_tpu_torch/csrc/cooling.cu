// The per-cell cooling solve (K6), hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the CUDA form of the device-side
// lax.while_loop of ramses_tpu/hydro/cooling.py::solve_cooling (the
// reference's hydro/cooling_module.f90:478-664).  There every cell marches
// in its own pseudo-time, for up to 500 iterations, and the loop runs while
// any cell is active; a finished cell's state is frozen.  So one thread per
// cell that loops until its own cell is done (or 500 iterations) computes,
// cell by cell, what the JAX loop computes, in one launch and with no host
// fetch of the loop condition.  The arithmetic is solve_cooling's, in its
// order: the i_nH, w1, w2 set-up; the body's rate (five cubic Hermite
// interpolations in log T2 over four table points each), wcool, tau_new and
// time updates; the final interpolation onto time_max.  The file is built
// with -fmad=false (kernels.py, EXTRA_FLAGS) so that nothing is contracted
// that the plain version rounds twice, and no fast math.  10^x is pow(10, x),
// the call torch.pow(10.0, x) makes: on an H100 the two agree bit for bit
// in f32 (exp10 differs from it in the last bit at a third of the inputs,
// and one such bit flips the march's decisions at cells near the
// equilibrium of cooling and heating).
//
// What bounds it on an H100: arithmetic.  A cell moves nH and T2 in and T2
// out (12 B in f32; zsolar and boost are numbers read at stride 0 unless
// self-shielding makes boost per cell), but each iteration evaluates five
// 10^x and a log10 among ~270 elementwise operations; the bound is those
// operations times this run's iteration counts (chip_smoke.py counts them
// per phase) over the card's rate for the type.  The ten tables ([10, 161, 101], 650 KB in f32,
// 1.3 MB in f64) are too large for shared memory together but stay
// resident in the 50 MB L2; they are read through the read-only path
// (__ldg).  Neighbouring cells of a smooth state read neighbouring table
// entries, so a warp's gathers touch few lines.
//
// What the design does about it: nothing beyond one thread a cell, 256 a
// block, the state read once and written once.  A warp runs until its
// slowest cell is done (divergence); cells of one warp are neighbours in
// space and usually need similar iteration counts.  Fusing cooling_step's
// conversions (u -> nH, T2 and back) into this kernel is later work
// (ROADMAP).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ramses_cooling {

constexpr int kThreads = 256;
constexpr int kNbinN = 161;
constexpr int kNbinT = 101;
constexpr int kTab = kNbinN * kNbinT;
constexpr int kMaxIter = 500;
constexpr double kVarmax = 4.0;

__device__ __forceinline__ float p10(float x) { return powf(10.0f, x); }
__device__ __forceinline__ double p10(double x) { return pow(10.0, x); }
__device__ __forceinline__ float lg10(float x) { return log10f(x); }
__device__ __forceinline__ double lg10(double x) { return log10(x); }
__device__ __forceinline__ float sqrtt(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrtt(double x) { return sqrt(x); }

// jnp.maximum / jnp.minimum: NaN if either operand is NaN
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
template <typename T>
__device__ __forceinline__ T nclip(T x, T lo, T hi) {
  return nmin(nmax(x, lo), hi);
}

struct Consts {
  double log_nH0, log_nH1, dlog_nH, log_T20, dlog_T2, h, h2, h3, precoeff,
      log_T2max;
};

template <typename T>
__device__ __forceinline__ void interp(const T* __restrict__ tab,
                                       const T* __restrict__ tab_p, int k00,
                                       int k10, T w1, T w2, T yy, T h, T h2,
                                       T h3, T& val, T& dlog) {
  const T fa = __ldg(tab + k00) * w1 + __ldg(tab + k10) * w2;
  const T fb = __ldg(tab + k00 + 1) * w1 + __ldg(tab + k10 + 1) * w2;
  const T fpa = __ldg(tab_p + k00) * w1 + __ldg(tab_p + k10) * w2;
  const T fpb = __ldg(tab_p + k00 + 1) * w1 + __ldg(tab_p + k10 + 1) * w2;
  const T alpha = fpa;
  const T beta = T(3.0) * (fb - fa) / h2 - (T(2.0) * fpa + fpb) / h;
  const T gamma = (fpa + fpb) / h2 - T(2.0) * (fb - fa) / h3;
  const T y2 = yy * yy;
  val = p10(fa + alpha * yy + beta * y2 + gamma * (y2 * yy));
  dlog = alpha + T(2.0) * beta * yy + T(3.0) * gamma * y2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cooling_kernel(const T* __restrict__ nH, const T* __restrict__ T2,
               const T* __restrict__ zs, int zs_stride,
               const T* __restrict__ bs, int bs_stride,
               const T* __restrict__ dt_s, const T* __restrict__ tabs,
               const T* __restrict__ log_nH, const T* __restrict__ log_T2,
               T* __restrict__ out, int* __restrict__ iters, long long n,
               Consts c) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const T nh = nH[i];
  const T zsolar = zs[i * zs_stride];
  const T boost = bs[i * bs_stride];
  const T lnh0 = T(c.log_nH0), dlnh = T(c.dlog_nH);
  const T lt0 = T(c.log_T20), dlt = T(c.dlog_T2);
  const T h = T(c.h), h2 = T(c.h2), h3 = T(c.h3);
  const T t2max = T(c.log_T2max);

  const T facH = nclip(lg10(nh / boost), lnh0, T(c.log_nH1));
  int inh = (int)((facH - lnh0) * dlnh);
  inh = inh < 0 ? 0 : (inh > kNbinN - 2 ? kNbinN - 2 : inh);
  const T w1 = (__ldg(log_nH + inh + 1) - facH) * dlnh;
  const T w2 = (facH - __ldg(log_nH + inh)) * dlnh;
  const T time_max = dt_s[0] * T(c.precoeff) * nh;
  const T wmax = T(1.0) / time_max;

  T tau = T2[i], tau_old = tau, time = T(0), time_old = T(0);
  int it = 0;
  bool active = true;
  while (active && it < kMaxIter) {
    // rate(tau)
    const T facT = lg10(tau);
    const bool in_table = facT <= t2max;
    int it2 = (int)((facT - lt0) * dlt);
    it2 = it2 < 0 ? 0 : (it2 > kNbinT - 2 ? kNbinT - 2 : it2);
    const T yy = facT - __ldg(log_T2 + it2);
    const int k00 = inh * kNbinT + it2;
    const int k10 = k00 + kNbinT;
    T cool, cool_d, heat, heat_d, ccom, ccom_d, hcom, hcom_d, met, met_d;
    interp(tabs + 0 * kTab, tabs + 5 * kTab, k00, k10, w1, w2, yy, h, h2, h3,
           cool, cool_d);
    interp(tabs + 1 * kTab, tabs + 6 * kTab, k00, k10, w1, w2, yy, h, h2, h3,
           heat, heat_d);
    interp(tabs + 2 * kTab, tabs + 7 * kTab, k00, k10, w1, w2, yy, h, h2, h3,
           ccom, ccom_d);
    interp(tabs + 3 * kTab, tabs + 8 * kTab, k00, k10, w1, w2, yy, h, h2, h3,
           hcom, hcom_d);
    interp(tabs + 4 * kTab, tabs + 9 * kTab, k00, k10, w1, w2, yy, h, h2, h3,
           met, met_d);
    T lam = cool + zsolar * met - heat + (ccom - hcom) / nh;
    T lam_p = (cool * cool_d + zsolar * met * met_d - heat * heat_d +
               (ccom * ccom_d - hcom * hcom_d) / nh) / tau;
    if (!in_table) {
      // free-free tail above the table (the reference's else branch)
      const T lam_hi = T(1.42e-27) * sqrtt(tau) * T(1.1);
      lam = lam_hi;
      lam_p = lam_hi / (T(2.0) * tau);
    }
    // the body
    const T wcool = nmax(nmax(fabs(lam) / tau * T(kVarmax), wmax),
                         -lam_p * T(kVarmax));
    const T tau_new = tau * (T(1.0) + lam_p / wcool - lam / tau / wcool) /
                      (T(1.0) + lam_p / wcool);
    tau_old = tau;
    tau = tau_new;
    time_old = time;
    time = time + T(1.0) / wcool;
    active = time < time_max;
    ++it;
  }
  // interpolate onto the exact end time (the reference's :622-625)
  const T denom = (time == time_old) ? T(1.0) : time - time_old;
  const T frac = nclip((time_max - time_old) / denom, T(0.0), T(1.0));
  out[i] = tau * frac + tau_old * (T(1.0) - frac);
  if (iters != nullptr) iters[i] = it;
}

template <typename T>
int launch(const T* nH, const T* T2, const T* zs, int zs_stride, const T* bs,
           int bs_stride, const T* dt_s, const T* tabs, const T* log_nH,
           const T* log_T2, T* out, int* iters, long long n, Consts c,
           cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cooling_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      nH, T2, zs, zs_stride, bs, bs_stride, dt_s, tabs, log_nH, log_T2, out,
      iters, n, c);
  return (int)cudaGetLastError();
}

}  // namespace ramses_cooling

#define RAMSES_COOLING_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const T* nH, const T* T2, const T* zs, int zs_stride, \
                      const T* bs, int bs_stride, const T* dt_s,            \
                      const T* tabs, const T* log_nH, const T* log_T2,      \
                      T* out, int* iters, long long n, double log_nH0,      \
                      double log_nH1, double dlog_nH, double log_T20,       \
                      double dlog_T2, double h, double h2, double h3,       \
                      double precoeff, double log_T2max, void* stream) {    \
    ramses_cooling::Consts c{log_nH0, log_nH1,  dlog_nH, log_T20,            \
                             dlog_T2, h,        h2,      h3,                 \
                             precoeff, log_T2max};                           \
    return ramses_cooling::launch<T>(nH, T2, zs, zs_stride, bs, bs_stride,   \
                                     dt_s, tabs, log_nH, log_T2, out, iters, \
                                     n, c, (cudaStream_t)stream);            \
  }

RAMSES_COOLING_ENTRY(ramses_cooling_f32, float)
RAMSES_COOLING_ENTRY(ramses_cooling_f64, double)
