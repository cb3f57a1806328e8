// One M1 photon-transport substep (K8), hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the CUDA form of the programs XLA fuses
// from ramses_tpu/rt/m1.py::transport_step (the uniform grid and complete
// AMR levels) and ramses_tpu/rt/amr.py::_glf_block (partial AMR levels):
// a first-order GLF update of each photon group's density N and flux F
// with the M1 closure (rt/rt_flux_module.f90 cmp_eddington), the floor
// N >= SMALL_NP and the limiter |F| <= c_red N.  The JAX package runs the
// update as rolls of padded arrays; here one thread computes one cell of
// one group from its own state and its 2*nd face neighbours, in the plain
// version's order of operations: the physical flux F[d], c²·P[d][j] of the
// cell and of its two neighbours along each axis, the two GLF faces, dN and
// dF accumulated axis by axis, the floor and the limiter.  The file is built
// with -fmad=false (kernels.py, EXTRA_FLAGS): it uses +, -, *, / and sqrt
// only, all correctly rounded in double, so without contraction it rounds
// where the plain version (ramses_tpu_torch/rt/m1.py) does.
//
// Two entries:
//  * dense: U [ng, 1+nd, *sp] (group-major N, F_x..F_z blocks), C order,
//    1D/2D/3D; the periodic ring wraps, an outflow face copies its edge
//    cell (m1._pad).  With sources, a thread adds dt*src (and, with beams,
//    dt*src_F) to its own cell and to each neighbour it reads, as the JAX
//    package adds them before padding.  Groups are the grid's y axis: one
//    launch a substep for every group.
//  * block: the gathered oct stencils [ng*(1+nd), 6^nd, noct] of a partial
//    level (amr/kernels._gather_uloc, ghosts interpolated from the coarser
//    level); the update of the interior [2:4]^nd cells of each oct, written
//    oct-major straight into the level's rows [ncell_pad, ng*(1+nd)].  The
//    plain version rolls inside the 6-wide block; an interior cell reads its
//    ±1 neighbours, indices 1..4, so no kept cell reads a wrapped value.
//
// What bounds it on an H100: memory.  A cell reads its own (1+nd) values
// and writes (1+nd) values per group (f64: 64 B in 3D, plus 8 B of source
// where there is one); the neighbours' values come from L1/L2.  The work is
// ~(1+2nd) closures of ~30 flops each, a sqrt and two divisions, about 0.6
// kflop a cell in 3D: at f64's 33.5 TFLOP/s that is below the bytes' time at
// 3.35 TB/s only while a cell moves more than ~60 B, so the kernel sits
// near the ridge; chip_smoke.py computes both bounds from the run's inputs.
//
// What the design does about it: nothing beyond one thread a cell, 256 a
// block, consecutive threads on consecutive cells (coalesced along the
// fastest axis); each neighbour's closure is recomputed and no shared
// memory is used.  Staging a tile with its halo in shared memory and
// sharing each face between its two cells is later work (ROADMAP §B).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ramses_rt_m1 {

constexpr int kThreads = 256;
constexpr double kSmall = 1e-30;   // m1.SMALL_NP

// torch.clamp / jnp.maximum: NaN if either operand is NaN
__device__ __forceinline__ double nmax(double a, double b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ double nmin(double a, double b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

// the physical flux along axis d of one cell's (N, F): F[d], c²·P[d][j]
// (m1._phys_flux / m1.eddington)
template <int ND>
__device__ __forceinline__ void phys_flux(const double* v, int d,
                                          double c_red, double c2,
                                          double* out) {
  const double N = v[0];
  const double Ns = nmax(N, kSmall);
  double fsum = 0.0;
#pragma unroll
  for (int e = 0; e < ND; ++e) fsum = fsum + v[1 + e] * v[1 + e];
  const double cN = c_red * Ns;
  double f2 = fsum / (cN * cN);
  f2 = nmin(nmax(f2, 0.0), 1.0);
  const double chi =
      (3.0 + 4.0 * f2) / (5.0 + 2.0 * sqrt(nmax(4.0 - 3.0 * f2, 0.0)));
  const double iterm = 0.5 * (1.0 - chi);
  const double oterm = 0.5 * (3.0 * chi - 1.0);
  const double inv = 1.0 / nmax(fsum, kSmall);
  out[0] = v[1 + d];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const double nn = v[1 + d] * v[1 + j] * inv;
    out[1 + j] = c2 * (N * (oterm * nn + (j == d ? iterm : 0.0)));
  }
}

// one axis' GLF contribution dtdx*(face_lo - face_hi) added into acc
template <int ND>
__device__ __forceinline__ void glf_axis(const double* vm, const double* vc,
                                         const double* vp, int d,
                                         double dtdx, double c_red,
                                         double c2, double* acc) {
  double fm[1 + ND], fc[1 + ND], fp[1 + ND];
  phys_flux<ND>(vm, d, c_red, c2, fm);
  phys_flux<ND>(vc, d, c_red, c2, fc);
  phys_flux<ND>(vp, d, c_red, c2, fp);
  const double half_c = 0.5 * c_red;
#pragma unroll
  for (int k = 0; k < 1 + ND; ++k) {
    const double lo = 0.5 * (fm[k] + fc[k]) - half_c * (vc[k] - vm[k]);
    const double hi = 0.5 * (fc[k] + fp[k]) - half_c * (vp[k] - vc[k]);
    acc[k] = acc[k] + dtdx * (lo - hi);
  }
}

// the floor and the limiter |F| <= c_red N on the updated cell
template <int ND>
__device__ __forceinline__ void finish(const double* vc, const double* acc,
                                       double c_red, double* res) {
  const double N = nmax(vc[0] + acc[0], kSmall);
  double F[ND];
  double fsum = 0.0;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    F[j] = vc[1 + j] + acc[1 + j];
    fsum = fsum + F[j] * F[j];
  }
  const double fmag = sqrt(fsum);
  const double cap = c_red * N;
  const double scale = fmag > cap ? cap / nmax(fmag, kSmall) : 1.0;
  res[0] = N;
#pragma unroll
  for (int j = 0; j < ND; ++j) res[1 + j] = F[j] * scale;
}

// one cell of group g with its sources added
template <int ND>
__device__ __forceinline__ void load_dense(const double* __restrict__ U,
                                           const double* __restrict__ src,
                                           const double* __restrict__ srcF,
                                           int g, long long cell,
                                           long long ncell, double dt,
                                           double* v) {
  const double* u = U + (long long)g * (1 + ND) * ncell + cell;
  v[0] = u[0];
  if (src) v[0] = v[0] + dt * src[(long long)g * ncell + cell];
#pragma unroll
  for (int e = 0; e < ND; ++e) {
    v[1 + e] = u[(long long)(1 + e) * ncell];
    if (srcF) v[1 + e] = v[1 + e] + dt * srcF[((long long)g * ND + e) * ncell
                                              + cell];
  }
}

template <int ND>
__global__ void __launch_bounds__(kThreads)
    dense_kernel(const double* __restrict__ U, const double* __restrict__ src,
                 const double* __restrict__ srcF, double* __restrict__ out,
                 int nx, int ny, int nz, int periodic, double dt, double dtdx,
                 double c_red, double c2) {
  const long long ncell = (long long)nx * ny * nz;
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= ncell) return;
  const int g = blockIdx.y;
  const int n[3] = {nx, ny, nz};
  const long long stride[3] = {(long long)ny * nz, (long long)nz, 1};
  const int coord[3] = {(int)(cell / stride[0]), (int)((cell / nz) % ny),
                        (int)(cell % nz)};
  double vc[1 + ND], acc[1 + ND];
  load_dense<ND>(U, src, srcF, g, cell, ncell, dt, vc);
#pragma unroll
  for (int k = 0; k < 1 + ND; ++k) acc[k] = 0.0;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    int lo = coord[d] - 1, hi = coord[d] + 1;
    if (periodic) {
      lo = lo < 0 ? n[d] - 1 : lo;
      hi = hi >= n[d] ? 0 : hi;
    } else {
      lo = lo < 0 ? 0 : lo;
      hi = hi >= n[d] ? n[d] - 1 : hi;
    }
    double vm[1 + ND], vp[1 + ND];
    load_dense<ND>(U, src, srcF, g, cell + (lo - coord[d]) * stride[d],
                   ncell, dt, vm);
    load_dense<ND>(U, src, srcF, g, cell + (hi - coord[d]) * stride[d],
                   ncell, dt, vp);
    glf_axis<ND>(vm, vc, vp, d, dtdx, c_red, c2, acc);
  }
  double res[1 + ND];
  finish<ND>(vc, acc, c_red, res);
  double* o = out + (long long)g * (1 + ND) * ncell + cell;
#pragma unroll
  for (int k = 0; k < 1 + ND; ++k) o[(long long)k * ncell] = res[k];
}

template <int ND>
__global__ void __launch_bounds__(kThreads)
    block_kernel(const double* __restrict__ blk, double* __restrict__ rows,
                 int ng, long long noct, double dtdx, double c_red,
                 double c2) {
  constexpr int kCells = 1 << ND;                       // interior cells
  constexpr int kSide = ND == 1 ? 6 : (ND == 2 ? 36 : 216);   // 6^ND
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= noct * kCells) return;
  const int g = blockIdx.y;
  const long long o = t % noct;
  const int cell = (int)(t / noct);
  int s = 0, step[3];
#pragma unroll
  for (int d = 0; d < ND; ++d) s = s * 6 + 2 + ((cell >> (ND - 1 - d)) & 1);
#pragma unroll
  for (int d = ND - 1, st = 1; d >= 0; --d, st *= 6) step[d] = st;
  const double* b = blk + (long long)g * (1 + ND) * kSide * noct + o;
  double vc[1 + ND], acc[1 + ND];
#pragma unroll
  for (int k = 0; k < 1 + ND; ++k) {
    vc[k] = b[((long long)k * kSide + s) * noct];
    acc[k] = 0.0;
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    double vm[1 + ND], vp[1 + ND];
#pragma unroll
    for (int k = 0; k < 1 + ND; ++k) {
      vm[k] = b[((long long)k * kSide + s - step[d]) * noct];
      vp[k] = b[((long long)k * kSide + s + step[d]) * noct];
    }
    glf_axis<ND>(vm, vc, vp, d, dtdx, c_red, c2, acc);
  }
  double res[1 + ND];
  finish<ND>(vc, acc, c_red, res);
  double* r = rows + (o * kCells + cell) * (long long)ng * (1 + ND)
              + g * (1 + ND);
#pragma unroll
  for (int k = 0; k < 1 + ND; ++k) r[k] = res[k];
}

}  // namespace ramses_rt_m1

using namespace ramses_rt_m1;

// One dense substep of every group: U, src (nullable), src_F (nullable) and
// out as laid out above; sp = (nx, ny, nz) with 1 for the dims past nd.
extern "C" int ramses_rt_m1_dense(const double* U, const double* src,
                                  const double* srcF, double* out, int ng,
                                  int nd, int nx, int ny, int nz,
                                  int periodic, double dt, double dtdx,
                                  double c_red, double c2, void* stream) {
  const long long ncell = (long long)nx * ny * nz;
  if (ncell <= 0 || ng <= 0) return 0;
  if (ng > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)((ncell + kThreads - 1) / kThreads), ng);
  dim3 block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nd) {
    case 1:
      dense_kernel<1><<<grid, block, 0, s>>>(U, src, srcF, out, nx, ny, nz, periodic, dt, dtdx, c_red, c2);
      break;
    case 2:
      dense_kernel<2><<<grid, block, 0, s>>>(U, src, srcF, out, nx, ny, nz, periodic, dt, dtdx, c_red, c2);
      break;
    case 3:
      dense_kernel<3><<<grid, block, 0, s>>>(U, src, srcF, out, nx, ny, nz, periodic, dt, dtdx, c_red, c2);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One block substep of a partial level: blk [ng*(1+nd), 6^nd, noct] in,
// the interior cells of each oct written over rows[:noct*2^nd].
extern "C" int ramses_rt_m1_block(const double* blk, double* rows, int ng,
                                  int nd, long long noct, double dtdx,
                                  double c_red, double c2, void* stream) {
  const long long n = noct << nd;
  if (n <= 0 || ng <= 0) return 0;
  if (ng > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), ng);
  dim3 block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nd) {
    case 1:
      block_kernel<1><<<grid, block, 0, s>>>(blk, rows, ng, noct, dtdx, c_red, c2);
      break;
    case 2:
      block_kernel<2><<<grid, block, 0, s>>>(blk, rows, ng, noct, dtdx, c_red, c2);
      break;
    case 3:
      block_kernel<3><<<grid, block, 0, s>>>(blk, rows, ng, noct, dtdx, c_red, c2);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
