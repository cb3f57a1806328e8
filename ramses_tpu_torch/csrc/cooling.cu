// The per-cell cooling solve (K6), hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the CUDA form of the device-side
// lax.while_loop of ramses_tpu/hydro/cooling.py::solve_cooling (the
// reference's hydro/cooling_module.f90:478-664), and of the conversions
// around it in cooling_step (the vectorised cooling_fine pass).  In the
// solve every cell marches in its own pseudo-time, for up to 500
// iterations, and the loop runs while any cell is active; a finished cell's
// state is frozen.  So one thread per cell that loops until its own cell is
// done (or 500 iterations) computes, cell by cell, what the JAX loop
// computes, in one launch and with no host fetch of the loop condition.
// The arithmetic is solve_cooling's, in its order: the i_nH, w1, w2 set-up;
// the body's rate (five cubic Hermite interpolations in log T2 over four
// table points each), wcool, tau_new and time updates; the final
// interpolation onto time_max.  The file is built with -fmad=false
// (kernels.py, EXTRA_FLAGS) so that nothing is contracted that the plain
// version rounds twice, and no fast math.  10^x is pow(10, x), the call
// torch.pow(10.0, x) makes: on an H100 the two agree bit for bit in f32
// (exp10 differs from it in the last bit at a third of the inputs, and one
// such bit flips the march's decisions at cells near the equilibrium of
// cooling and heating).
//
// Two entries:
//  * the march (ramses_cooling_f32/_f64): nH, T2, zsolar, boost in, T2
//    out, as solve_cooling takes them;
//  * the fused pass (ramses_cooling_step_f32/_f64): the conservative state
//    u itself, read through a variable stride and a cell stride (so that a
//    hierarchy level's rows, u[l].T, go in without a copy).  One thread a
//    cell does all of cooling_step's work in its order: the smallr clamp,
//    ekin, eother, eint, T2 and nH; the temperature floor subtracted (a
//    per-cell tensor the caller computes, nullable) and the T2_MIN and
//    T2max clips; the self-shielding boost; the march; the floor added
//    back and the T2max clip; the new E = eint_new + ekin + eother,
//    the only value it writes.  The unit scales come from a device tensor
//    where the caller has one (a cosmological epoch), so nothing is
//    fetched.  It rounds as PyTorch's CUDA kernels do: a division by a
//    Python number is a multiplication by the number's reciprocal in the
//    state's type, a division by a tensor a division.  cooling_step sends
//    only the ISM module, whose solve has no kernel, to the torch passes
//    (hydro/cooling.py, fused_supports).
//
// What bounds it on an H100: arithmetic.  A cell moves nH and T2 in and T2
// out (12 B in f32), or its state in and E out in the fused pass, but each
// iteration evaluates five 10^x and a log10 among ~270 elementwise
// operations; the bound is those operations times this run's iteration
// counts (chip_smoke.py counts them per phase) over the card's rate for the
// type.  The tables (each of the ten [161, 101], 650 KB in f32) are too
// large for shared memory but stay resident in the 50 MB L2, read through
// the read-only path (__ldg).  They are interleaved (CoolingTables.
// interleaved): for every (i_nH, i_T2) the five table pairs' values at i_T2
// and i_T2 + 1, 20 values, so that a cell-iteration reads its two rows
// i_nH and i_nH + 1 with 16-byte loads (10 in f32, 20 in f64) where it made
// 40 scalar gathers.
//
// What the design does beyond that: one thread a cell, 256 a block, the
// state read once and E written once.  A warp runs until its slowest cell
// is done (divergence); cells of one warp are neighbours in space and
// usually need similar iteration counts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ramses_cooling {

constexpr int kThreads = 256;
constexpr int kNbinN = 161;
constexpr int kNbinT = 101;
constexpr int kRow = 20;             // interleaved values an (i_nH, i_T2)
constexpr int kMaxIter = 500;
constexpr double kVarmax = 4.0;

__device__ __forceinline__ float p10(float x) { return powf(10.0f, x); }
__device__ __forceinline__ double p10(double x) { return pow(10.0, x); }
__device__ __forceinline__ float lg10(float x) { return log10f(x); }
__device__ __forceinline__ double lg10(double x) { return log10(x); }
__device__ __forceinline__ float sqrtt(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrtt(double x) { return sqrt(x); }
__device__ __forceinline__ float expt(float x) { return expf(x); }
__device__ __forceinline__ double expt(double x) { return exp(x); }

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

// one table pair's values at (row, i_T2) and (row, i_T2 + 1): tab[i_T2],
// tab[i_T2 + 1], tab_p[i_T2], tab_p[i_T2 + 1]
template <typename T>
struct Quad {
  T a, b, c, d;
};
__device__ __forceinline__ Quad<float> load_quad(const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Quad<double> load_quad(const double* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  const double2 w = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {v.x, v.y, w.x, w.y};
}

// the cubic Hermite in log T2 at the interpolated nH of one table pair,
// from its values on rows i_nH (q0) and i_nH + 1 (q1)
template <typename T>
__device__ __forceinline__ void interp(const Quad<T>& q0, const Quad<T>& q1,
                                       T w1, T w2, T yy, T h, T h2, T h3,
                                       T& val, T& dlog) {
  const T fa = q0.a * w1 + q1.a * w2;
  const T fb = q0.b * w1 + q1.b * w2;
  const T fpa = q0.c * w1 + q1.c * w2;
  const T fpb = q0.d * w1 + q1.d * w2;
  const T alpha = fpa;
  const T beta = T(3.0) * (fb - fa) / h2 - (T(2.0) * fpa + fpb) / h;
  const T gamma = (fpa + fpb) / h2 - T(2.0) * (fb - fa) / h3;
  const T y2 = yy * yy;
  val = p10(fa + alpha * yy + beta * y2 + gamma * (y2 * yy));
  dlog = alpha + T(2.0) * beta * yy + T(3.0) * gamma * y2;
}

// One cell's march (solve_cooling): T2 after dt_s seconds at fixed nH;
// `it` gets its iteration count.  `inter` the interleaved tables
// [NBIN_N, NBIN_T - 1, 20].
template <typename T>
__device__ __forceinline__ T march(T nh, T T2, T zsolar, T boost, T dt_s,
                                   const T* __restrict__ inter,
                                   const T* __restrict__ log_nH,
                                   const T* __restrict__ log_T2,
                                   const Consts& c, int& it) {
  const T lnh0 = T(c.log_nH0), dlnh = T(c.dlog_nH);
  const T lt0 = T(c.log_T20), dlt = T(c.dlog_T2);
  const T h = T(c.h), h2 = T(c.h2), h3 = T(c.h3);
  const T t2max = T(c.log_T2max);

  const T facH = nclip(lg10(nh / boost), lnh0, T(c.log_nH1));
  int inh = (int)((facH - lnh0) * dlnh);
  inh = inh < 0 ? 0 : (inh > kNbinN - 2 ? kNbinN - 2 : inh);
  const T w1 = (__ldg(log_nH + inh + 1) - facH) * dlnh;
  const T w2 = (facH - __ldg(log_nH + inh)) * dlnh;
  const T time_max = dt_s * T(c.precoeff) * nh;
  const T wmax = T(1.0) / time_max;
  const T* row = inter + (long long)inh * (kNbinT - 1) * kRow;

  T tau = T2, tau_old = tau, time = T(0), time_old = T(0);
  it = 0;
  bool active = true;
  while (active && it < kMaxIter) {
    // rate(tau)
    const T facT = lg10(tau);
    const bool in_table = facT <= t2max;
    int it2 = (int)((facT - lt0) * dlt);
    it2 = it2 < 0 ? 0 : (it2 > kNbinT - 2 ? kNbinT - 2 : it2);
    const T yy = facT - __ldg(log_T2 + it2);
    const T* r0 = row + it2 * kRow;
    const T* r1 = r0 + (kNbinT - 1) * kRow;
    T v[5], dv[5];
#pragma unroll
    for (int t = 0; t < 5; ++t)
      interp(load_quad(r0 + 4 * t), load_quad(r1 + 4 * t), w1, w2, yy, h,
             h2, h3, v[t], dv[t]);
    const T cool = v[0], heat = v[1], ccom = v[2], hcom = v[3], met = v[4];
    T lam = cool + zsolar * met - heat + (ccom - hcom) / nh;
    T lam_p = (cool * dv[0] + zsolar * met * dv[4] - heat * dv[1] +
               (ccom * dv[2] - hcom * dv[3]) / nh) / tau;
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
  return tau * frac + tau_old * (T(1.0) - frac);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cooling_kernel(const T* __restrict__ nH, const T* __restrict__ T2,
               const T* __restrict__ zs, int zs_stride,
               const T* __restrict__ bs, int bs_stride,
               const T* __restrict__ dt_s, const T* __restrict__ inter,
               const T* __restrict__ log_nH, const T* __restrict__ log_T2,
               T* __restrict__ out, int* __restrict__ iters, long long n,
               Consts c) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int it;
  out[i] = march(nH[i], T2[i], zs[i * zs_stride], bs[i * bs_stride], dt_s[0],
                 inter, log_nH, log_T2, c, it);
  if (iters != nullptr) iters[i] = it;
}

// cooling_step's pass on one cell of the state (hydro/cooling.py)
struct StepArgs {
  long long vs, cs;        // u's variable and cell strides, in elements
  long long es;            // the E row's cell stride
  int ndim, nener;
  int has_T2max, self_shielding;
  double smallr, gm1;      // cfg.smallr, cfg.gamma - 1
  double s_T2, s_nH, s_t;  // the spec's unit scales (without `scales`)
  double dt;               // dt, where it is a number
  double z_ave, T2min, T2max;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
step_kernel(const T* u, T* e_row, const T* __restrict__ t2_floor,
            const T* __restrict__ scales, const T* __restrict__ dtp,
            const T* __restrict__ inter, const T* __restrict__ log_nH,
            const T* __restrict__ log_T2, long long n, StepArgs a,
            Consts c) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // u and e_row may alias (the E row of u, in place), so neither is
  // __restrict__: a thread reads its cell's E before it writes it, and no
  // other thread touches that element
  const T* ui = u + i * a.cs;
  const T rho = nmax(ui[0], T(a.smallr));
  T ekin = T(0);
  for (int d = 0; d < a.ndim; ++d) {
    const T m = ui[(1 + d) * a.vs];
    const T half = T(0.5) * (m * m);
    ekin = d == 0 ? half : ekin + half;
  }
  ekin = ekin / rho;
  T eother = T(0);
  for (int k = 0; k < a.nener; ++k)
    eother = eother + ui[(a.ndim + 2 + k) * a.vs];
  const T eint = ui[(a.ndim + 1) * a.vs] - ekin - eother;
  const T s_T2 = scales != nullptr ? scales[0] : T(a.s_T2);
  const T s_nH = scales != nullptr ? scales[1] : T(a.s_nH);
  const T T2 = T(a.gm1) * eint / rho * s_T2;
  const T nh = rho * s_nH;
  const T fl = t2_floor != nullptr ? t2_floor[i] : T(0);
  T T2x = nmax(t2_floor != nullptr ? T2 - fl : T2, T(a.T2min));
  if (a.has_T2max) T2x = nmin(T2x, T(a.T2max));
  const T boost = a.self_shielding
                      ? nmax(expt(-nh * (T(1) / T(0.01))), T(1e-20))
                      : T(1);
  // dt * s_t: in the state's type where either is a tensor, else the
  // Python product
  T dt_s;
  if (dtp != nullptr || scales != nullptr)
    dt_s = (dtp != nullptr ? dtp[0] : T(a.dt)) *
           (scales != nullptr ? scales[2] : T(a.s_t));
  else
    dt_s = T(a.dt * a.s_t);
  int it;
  T T2o = march(nh, T2x, T(a.z_ave), boost, dt_s, inter, log_nH, log_T2, c,
                it);
  if (t2_floor != nullptr) T2o = T2o + fl;
  if (a.has_T2max) T2o = nmin(T2o, T(a.T2max));
  const T q = scales != nullptr ? T2o / s_T2 : T2o * (T(1) / s_T2);
  const T eint_new = q * rho * (T(1) / T(a.gm1));
  e_row[i * a.es] = eint_new + ekin + eother;
}

template <typename T>
int launch(const T* nH, const T* T2, const T* zs, int zs_stride, const T* bs,
           int bs_stride, const T* dt_s, const T* inter, const T* log_nH,
           const T* log_T2, T* out, int* iters, long long n, Consts c,
           cudaStream_t s) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks), block(kThreads);
  cooling_kernel<T><<<grid, block, 0, s>>>(nH, T2, zs, zs_stride, bs,
                                           bs_stride, dt_s, inter, log_nH,
                                           log_T2, out, iters, n, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_step(const T* u, T* e_row, const T* t2_floor, const T* scales,
                const T* dtp, const T* inter, const T* log_nH, const T* log_T2,
                long long n, StepArgs a, Consts c, cudaStream_t s) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks), block(kThreads);
  step_kernel<T><<<grid, block, 0, s>>>(u, e_row, t2_floor, scales, dtp,
                                        inter, log_nH, log_T2, n, a, c);
  return (int)cudaGetLastError();
}

}  // namespace ramses_cooling

#define RAMSES_COOLING_CONSTS                                                \
  double log_nH0, double log_nH1, double dlog_nH, double log_T20,            \
      double dlog_T2, double h, double h2, double h3, double precoeff,       \
      double log_T2max
#define RAMSES_COOLING_MAKE_CONSTS                                           \
  ramses_cooling::Consts c{log_nH0, log_nH1, dlog_nH, log_T20, dlog_T2,      \
                           h,       h2,      h3,      precoeff, log_T2max}

// the march: nH, T2, zsolar and boost (each per cell, or a number at
// stride 0), dt_s one value, the interleaved tables; T2 out (and each
// cell's iterations where `iters` is given)
#define RAMSES_COOLING_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const T* nH, const T* T2, const T* zs, int zs_stride, \
                      const T* bs, int bs_stride, const T* dt_s,            \
                      const T* inter, const T* log_nH, const T* log_T2,     \
                      T* out, int* iters, long long n,                      \
                      RAMSES_COOLING_CONSTS, void* stream) {                \
    RAMSES_COOLING_MAKE_CONSTS;                                              \
    return ramses_cooling::launch<T>(nH, T2, zs, zs_stride, bs, bs_stride,   \
                                     dt_s, inter, log_nH, log_T2, out,       \
                                     iters, n, c, (cudaStream_t)stream);     \
  }

// the fused pass: u[v * vs + i * cs] in, E written at e_row[i * es];
// t2_floor (one value a cell, contiguous), scales [scale_T2, scale_nH,
// scale_t] and dt (one value) nullable
#define RAMSES_COOLING_STEP_ENTRY(NAME, T)                                   \
  extern "C" int NAME(                                                       \
      const T* u, T* e_row, const T* t2_floor, const T* scales,              \
      const T* dtp, const T* inter, const T* log_nH, const T* log_T2,        \
      long long n, long long vs,                                             \
      long long cs, long long es, int ndim, int nener, int has_T2max,        \
      int self_shielding, double smallr, double gm1, double s_T2,            \
      double s_nH, double s_t, double dt, double z_ave, double T2min,        \
      double T2max, RAMSES_COOLING_CONSTS, void* stream) {                   \
    RAMSES_COOLING_MAKE_CONSTS;                                              \
    ramses_cooling::StepArgs a{vs,     cs,    es,    ndim,   nener,          \
                               has_T2max, self_shielding, smallr, gm1,      \
                               s_T2,   s_nH,  s_t,   dt,     z_ave,          \
                               T2min,  T2max};                               \
    return ramses_cooling::launch_step<T>(u, e_row, t2_floor, scales, dtp,   \
                                          inter, log_nH, log_T2, n, a, c,    \
                                          (cudaStream_t)stream);             \
  }

RAMSES_COOLING_ENTRY(ramses_cooling_f32, float)
RAMSES_COOLING_ENTRY(ramses_cooling_f64, double)
RAMSES_COOLING_STEP_ENTRY(ramses_cooling_step_f32, float)
RAMSES_COOLING_STEP_ENTRY(ramses_cooling_step_f64, double)
