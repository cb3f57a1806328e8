// The RT photochemistry and photoheating of one substep (K9), hand-written
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the CUDA form of the programs XLA fuses
// from ramses_tpu/rt/chem.py::chem_step (the gray single-group H system)
// and ::chem_step_3ion (the multigroup HII/HeII/HeIII ladder), the
// reference's rt/rt_cooling_module.f90.  One thread a cell: the rate fits
// at the cell's temperature, 5 fixed-point iterations of the implicit
// absorption and ionization update from the fixed initial fractions, the
// clips at 1e-10 and 1 - 1e-10, the HeII+HeIII renormalisation, the final
// absorption and the photoheating / recombination cooling of T, in the
// plain version's order of operations (ramses_tpu_torch/rt/chem.py).  The
// constants the plain version forms from Python numbers (dt*c_red*sigma,
// c_red*sigmaN, max(e_photon - E_ion, 0), 1.5 kB) come in as arguments, so
// they are the same doubles.  Built with -fmad=false (kernels.py,
// EXTRA_FLAGS): nothing is contracted that the plain version rounds twice;
// pow, exp and sqrt are the calls torch's CUDA elementwise kernels make.
//
// The photon densities are read and written in place with a cell stride
// and a group stride: the uniform grid's [ng, 1+nd, *sp] state (cell
// stride 1, group stride (1+nd)*ncell) and a level's rows [ncell_pad,
// ng*(1+nd)] (cell stride ng*(1+nd), group stride 1+nd).  The fractions and
// T go to new buffers.  The group table (sigmaN[3], c_red*sigmaN[3] and the
// heat per absorption max(e - E_ion, 0)[3] of up to kMaxGroups groups, and
// the UV background) is a by-value kernel parameter.
//
// What bounds it on an H100: arithmetic, narrowly.  A cell moves ~56 B in
// the gray case (N in and out, x, T, nH in; x, T out); the rate fits are
// five pow and exp calls and a sqrt (~20-40 f64 operations each in
// libdevice) and the iterations ~20 operations each, so about 300 f64
// operations a cell: ~9 ns of the card's 33.5 TFLOP/s a thousand cells
// against ~17 ns of its 3.35 TB/s.  chip_smoke.py computes both bounds
// from the run's inputs.
//
// What the design does about it: one thread a cell, 256 a block, every
// array read once and written once; each rate fit is evaluated once a
// cell, not once an iteration (the plain version evaluates the same pure
// function of T each time).  Nothing else.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ramses_rt_chem {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 8;        // chem.MAX_GROUPS
constexpr double kXmax = 1.0 - 1e-10;

struct Table {
  double sig[kMaxGroups][3];         // sigmaN
  double csig[kMaxGroups][3];        // c_red * sigmaN
  double emax[kMaxGroups][3];        // max(e_photon - E_ION[sp], 0)
  double uvg[3], uvh[3];             // UV background: gamma, heat
};

// torch.clamp / jnp.maximum: NaN if either operand is NaN
__device__ __forceinline__ double nmax(double a, double b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ double nmin(double a, double b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ double clip(double x, double lo, double hi) {
  return nmin(nmax(x, lo), hi);
}

// the rate fits of chem.py, term for term
__device__ __forceinline__ double alpha_B(double T) {
  const double lam = 315614.0 / nmax(T, 1.0);
  return 2.753e-14 * pow(lam, 1.5) / pow(1.0 + pow(lam / 2.74, 0.407), 2.242);
}
__device__ __forceinline__ double alpha_A(double T) {
  const double lam = 315614.0 / nmax(T, 1.0);
  return 1.269e-13 * pow(lam, 1.503) / pow(1.0 + pow(lam / 0.522, 0.47), 1.923);
}
__device__ __forceinline__ double beta_ci_fit(double T, double a, double e) {
  T = nmax(T, 1.0);
  return a * sqrt(T) * exp(e / T) / (1.0 + sqrt(T / 1e5));
}
__device__ __forceinline__ double cool_rec_B(double T) {
  const double lam = 315614.0 / nmax(T, 1.0);
  return 3.435e-30 * T * pow(lam, 1.97) / pow(1.0 + pow(lam / 2.25, 0.376), 3.72);
}
__device__ __forceinline__ double alpha_B_HeII(double T) {
  const double lam = 570670.0 / nmax(T, 1.0);
  return 1.26e-14 * pow(lam, 0.75);
}
__device__ __forceinline__ double alpha_B_HeIII(double T) {
  const double lam = 1263030.0 / nmax(T, 1.0);
  return 2.0 * 2.753e-14 * pow(lam, 1.5) / pow(1.0 + pow(lam / 2.74, 0.407), 2.242);
}

template <bool HEAT>
__global__ void __launch_bounds__(kThreads)
    gray_kernel(double* __restrict__ N, long long nst,
                const double* __restrict__ x_in,
                const double* __restrict__ T_in,
                const double* __restrict__ nH_in, double* __restrict__ x_out,
                double* __restrict__ T_out, long long n, double dt,
                double dtcs, double csig, double e_heat, double c15kB,
                int otsa, int niter, int has_uv, double uvg, double uvh) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double nH = nH_in[i], T = T_in[i], Nin = N[i * nst];
  const double x0 = clip(x_in[i], 1e-10, kXmax);
  const double alpha = otsa ? alpha_B(T) : alpha_A(T);
  const double bci = beta_ci_fit(T, 5.85e-11, -157809.1);
  double x = x0;
  for (int it = 0; it < niter; ++it) {
    const double nHI = nH * (1.0 - x);
    const double Nn = Nin / (1.0 + dtcs * nHI);
    double gamma = csig * Nn;
    if (has_uv) gamma = gamma + uvg;
    const double ne = nH * x;
    const double cre = gamma + bci * ne;
    const double dst = alpha * ne;
    x = clip((x0 + dt * cre) / (1.0 + dt * (cre + dst)), 1e-10, kXmax);
  }
  const double nHI = nH * (1.0 - x);
  const double Nout = Nin / (1.0 + dtcs * nHI);
  double Tn = T;
  if (HEAT) {
    const double absorbed = nmax(Nin - Nout, 0.0);
    const double ne = nH * x;
    double heat = absorbed / dt * e_heat;
    if (has_uv) heat = heat + uvh * nHI;
    const double cool = cool_rec_B(T) * ne * nH * x;
    const double ntot = nH * (1.0 + x);
    const double dT = dt * (heat - cool) / (c15kB * nmax(ntot, 1e-30));
    Tn = nmax(T + dT, 1.0);
  }
  N[i * nst] = Nout;
  x_out[i] = x;
  T_out[i] = Tn;
}

template <bool HEAT>
__global__ void __launch_bounds__(kThreads)
    ion3_kernel(double* __restrict__ N, long long cst, long long gst, int ng,
                const double* __restrict__ x_in,
                const double* __restrict__ xhe2_in,
                const double* __restrict__ xhe3_in, long long hst,
                const double* __restrict__ T_in,
                const double* __restrict__ nH_in,
                const double* __restrict__ nHe_in, double* __restrict__ x_out,
                double* __restrict__ xhe2_out, double* __restrict__ xhe3_out,
                double* __restrict__ T_out, long long n, double dt, double dtc,
                double c15kB, Table tab, int otsa, int niter, int has_uv) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double nH = nH_in[i], nHe = nHe_in[i], T = T_in[i];
  double Nin[kMaxGroups];
  for (int g = 0; g < ng; ++g) Nin[g] = N[i * cst + g * gst];
  const double xH0 = clip(x_in[i], 1e-10, kXmax);
  const double xHe20 = clip(xhe2_in[i * hst], 1e-10, kXmax);
  const double xHe30 = clip(xhe3_in[i * hst], 1e-10, kXmax);
  double xH = xH0, xHe2 = xHe20, xHe3 = xHe30;
  const double aH = otsa ? alpha_B(T) : alpha_A(T);
  const double aHe2 = alpha_B_HeII(T);
  const double aHe3 = alpha_B_HeIII(T);
  const double bH = beta_ci_fit(T, 5.85e-11, -157809.1);
  const double b1 = beta_ci_fit(T, 2.38e-11, -285335.4);
  const double b2 = beta_ci_fit(T, 5.68e-12, -631515.0);
  for (int it = 0; it < niter; ++it) {
    const double nHI = nH * (1.0 - xH);
    const double nHeI = nHe * clip(1.0 - xHe2 - xHe3, 1e-10, 1.0);
    const double nHeII = nHe * xHe2;
    const double ne = nH * xH + nHe * (xHe2 + 2.0 * xHe3);
    double Gam[3] = {0.0, 0.0, 0.0};
    for (int g = 0; g < ng; ++g) {
      const double tau = tab.sig[g][0] * nHI + tab.sig[g][1] * nHeI
                         + tab.sig[g][2] * nHeII;
      const double Np = Nin[g] / (1.0 + dtc * tau);
      for (int sp = 0; sp < 3; ++sp) Gam[sp] = Gam[sp] + tab.csig[g][sp] * Np;
    }
    if (has_uv)
      for (int sp = 0; sp < 3; ++sp) Gam[sp] = Gam[sp] + tab.uvg[sp];
    const double creH = Gam[0] + bH * ne;
    xH = clip((xH0 + dt * creH) / (1.0 + dt * (creH + aH * ne)), 1e-10,
              kXmax);
    const double cre1 = Gam[1] + b1 * ne;
    const double cre2 = Gam[2] + b2 * ne;
    const double xHeI = clip(1.0 - xHe2 - xHe3, 1e-10, 1.0);
    const double h2 = clip((xHe20 + dt * (cre1 * xHeI + aHe3 * ne * xHe3))
                           / (1.0 + dt * (cre2 + aHe2 * ne)), 1e-10, 1.0);
    const double h3 = clip((xHe30 + dt * cre2 * h2) / (1.0 + dt * aHe3 * ne),
                           1e-10, 1.0);
    const double s = h2 + h3;
    const bool over = s > kXmax;
    xHe2 = over ? h2 / s * kXmax : h2;
    xHe3 = over ? h3 / s * kXmax : h3;
  }
  const double nHI = nH * (1.0 - xH);
  const double nHeI = nHe * clip(1.0 - xHe2 - xHe3, 1e-10, 1.0);
  const double nHeII = nHe * xHe2;
  const double ne = nH * xH + nHe * (xHe2 + 2.0 * xHe3);
  double heat = 0.0;
  for (int g = 0; g < ng; ++g) {
    const double t0 = tab.sig[g][0] * nHI, t1 = tab.sig[g][1] * nHeI,
                 t2 = tab.sig[g][2] * nHeII;
    const double tau = t0 + t1 + t2;
    const double Np = Nin[g] / (1.0 + dtc * tau);
    N[i * cst + g * gst] = Np;
    if (HEAT) {
      const double absorbed = nmax(Nin[g] - Np, 0.0) / dt;
      const double tmax = nmax(tau, 1e-300);
      heat = heat + absorbed * (t0 / tmax) * tab.emax[g][0];
      heat = heat + absorbed * (t1 / tmax) * tab.emax[g][1];
      heat = heat + absorbed * (t2 / tmax) * tab.emax[g][2];
    }
  }
  double Tn = T;
  if (HEAT) {
    if (has_uv)
      heat = heat + (tab.uvh[0] * nHI + tab.uvh[1] * nHeI
                     + tab.uvh[2] * nHeII);
    const double cool = cool_rec_B(T) * ne * nH * xH
                        + 1.55e-26 * pow(T, 0.3647) * ne * nHeII;
    const double ntot = nH * (1.0 + xH) + nHe * (1.0 + xHe2 + 2.0 * xHe3);
    const double dT = dt * (heat - cool) / (c15kB * nmax(ntot, 1e-30));
    Tn = nmax(T + dT, 1.0);
  }
  x_out[i] = xH;
  xhe2_out[i] = xHe2;
  xhe3_out[i] = xHe3;
  T_out[i] = Tn;
}

}  // namespace ramses_rt_chem

using namespace ramses_rt_chem;

// The gray chemistry substep of n cells; N read and written at stride nst.
extern "C" int ramses_rt_chem_gray(double* N, long long nst, const double* x,
                                   const double* T, const double* nH,
                                   double* x_out, double* T_out, long long n,
                                   double dt, double dtcs, double csig,
                                   double e_heat, double c15kB, int otsa,
                                   int niter, int heating, int has_uv,
                                   double uvg, double uvh, void* stream) {
  if (n <= 0) return 0;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  dim3 block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (heating)
    gray_kernel<true><<<grid, block, 0, s>>>(N, nst, x, T, nH, x_out, T_out, n, dt, dtcs, csig, e_heat, c15kB, otsa, niter, has_uv, uvg, uvh);
  else
    gray_kernel<false><<<grid, block, 0, s>>>(N, nst, x, T, nH, x_out, T_out, n, dt, dtcs, csig, e_heat, c15kB, otsa, niter, has_uv, uvg, uvh);
  return (int)cudaGetLastError();
}

// The 3-ion chemistry substep of n cells and ng groups; N read and written
// at cell stride cst and group stride gst, xHe2/xHe3 read at stride hst;
// tab (host memory) holds 9 doubles a group (sigmaN[3], c_red*sigmaN[3],
// max(e - E_ion, 0)[3]) then the UV gamma[3] and heat[3].
extern "C" int ramses_rt_chem_3ion(double* N, long long cst, long long gst,
                                   int ng, const double* x,
                                   const double* xhe2, const double* xhe3,
                                   long long hst, const double* T,
                                   const double* nH, const double* nHe,
                                   double* x_out, double* xhe2_out,
                                   double* xhe3_out, double* T_out,
                                   long long n, double dt, double dtc,
                                   double c15kB, const double* tab, int otsa,
                                   int niter, int heating, int has_uv,
                                   void* stream) {
  if (n <= 0) return 0;
  if (ng < 1 || ng > kMaxGroups) return cudaErrorInvalidValue;
  Table t;
  for (int g = 0; g < kMaxGroups; ++g)
    for (int sp = 0; sp < 3; ++sp) {
      t.sig[g][sp] = g < ng ? tab[9 * g + sp] : 0.0;
      t.csig[g][sp] = g < ng ? tab[9 * g + 3 + sp] : 0.0;
      t.emax[g][sp] = g < ng ? tab[9 * g + 6 + sp] : 0.0;
    }
  for (int sp = 0; sp < 3; ++sp) {
    t.uvg[sp] = tab[9 * ng + sp];
    t.uvh[sp] = tab[9 * ng + 3 + sp];
  }
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  dim3 block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (heating)
    ion3_kernel<true><<<grid, block, 0, s>>>(N, cst, gst, ng, x, xhe2, xhe3, hst, T, nH, nHe, x_out, xhe2_out, xhe3_out, T_out, n, dt, dtc, c15kB, t, otsa, niter, has_uv);
  else
    ion3_kernel<false><<<grid, block, 0, s>>>(N, cst, gst, ng, x, xhe2, xhe3, hst, T, nH, nHe, x_out, xhe2_out, xhe3_out, T_out, n, dt, dtc, c15kB, t, otsa, niter, has_uv);
  return (int)cudaGetLastError();
}
