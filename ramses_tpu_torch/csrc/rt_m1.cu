// One M1 photon-transport substep (K8), hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the CUDA form of the programs XLA fuses
// from ramses_tpu/rt/m1.py::transport_step (the uniform grid and complete
// AMR levels) and ramses_tpu/rt/amr.py::_glf_block (partial AMR levels):
// a first-order GLF update of each photon group's density N and flux F
// with the M1 closure (rt/rt_flux_module.f90 cmp_eddington), the floor
// N >= SMALL_NP and the limiter |F| <= c_red N.  The JAX package runs the
// update as rolls of padded arrays.  Here a cell's closure (iterm, oterm
// and 1/|F|², the doubles m1.eddington forms, which do not depend on the
// axis) is computed once into shared memory, and each axis' physical flux
// F[d], c²·P[d][j] of a cell and of its two neighbours is then built from
// those records with multiplies and adds only.  The order of operations is
// the plain version's: the faces lo and hi of glf_axis, dN and dF
// accumulated over the axes 0..nd-1, then the floor and the limiter.  The
// file is built with -fmad=false (kernels.py, EXTRA_FLAGS): it uses +, -,
// *, / and sqrt only, all correctly rounded in double, so without
// contraction it rounds where the plain version (ramses_tpu_torch/rt/
// m1.py) does.
//
// Two entries:
//  * dense: U [ng, 1+nd, *sp] (group-major N, F_x..F_z blocks), C order,
//    1D/2D/3D; the periodic ring wraps, an outflow face copies its edge
//    cell (m1._pad).  A block owns a tile of the two fastest axes with a
//    one-cell ring (32 along z × 8 along y in 3D and 2D, a segment of 256
//    in 1D).  In 3D it marches a chunk of planes along x (as many chunks
//    as leave every block resident at once, from the card's SMs and the
//    blocks an SM holds, asked once per device), one barrier a plane: three planes of records stay in shared memory, and while plane
//    x is updated the block computes the records of plane x+2 from its
//    raw values (N, F, and with sources src and src_F) and copies plane
//    x+3's into the other raw buffer with cp.async.  A record is N and F
//    with dt·src and dt·src_F added (one add each, as the JAX package adds
//    them before padding), then the closure's three doubles: one closure a
//    cell and launch, 340/256 with the ring.  Each thread carries its
//    cell's x face and x flux from one plane to the next, so a face along
//    x is computed once; the faces along y and z, by both their cells.
//    Groups are the grid's z axis: one launch a substep for every group.
//  * block: the gathered oct stencils [ng*(1+nd), 6^nd, noct] of a partial
//    level (amr/kernels._gather_uloc, ghosts interpolated from the coarser
//    level); the update of the interior [2:4]^nd cells of each oct, written
//    oct-major into the level's rows [ncell_pad, ng*(1+nd)].  A block takes
//    256/2^nd octs and, group by group, computes the closures of the cells
//    the interior reads (the 2^nd interior cells and their face neighbours:
//    32 an oct in 3D, 12 in 2D, 4 in 1D) once each into shared memory, then
//    the interior, whose rows it writes through shared memory so that a
//    warp's stores are contiguous.  The plain version rolls inside the
//    6-wide block; an interior cell reads its ±1 neighbours, indices 1..4,
//    so no kept cell reads a wrapped value.
//
// What bounds it on an H100: the issue of its instructions, near the
// ridge of memory and the f64 pipe.  A cell reads its own (1+nd) values
// and writes (1+nd) values per group (f64: 64 B in 3D, plus 8 B of source
// where there is one).  The work is one closure (a sqrt and three
// divisions) and, per axis, the fluxes and faces from the records, ~0.4
// kflop a cell in 3D, each an instruction without contraction, beside the
// shared-memory loads and the address arithmetic; chip_smoke.py computes
// the bytes' and the operations' bounds from the run's inputs, and
// tools/sass_count.py counts the instructions.  The staged planes read
// each value once from device memory (the ring's values twice, from
// neighbouring tiles); a plane's loads stay in flight behind the previous
// plane's arithmetic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef RAMSES_HOST_STUBS
// 8-byte asynchronous copies into shared memory (LDGSTS), their group and
// the wait for all of them.  A host build supplies plain copies.
__device__ __forceinline__ void cp_async_f64(double* smem,
                                             const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

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

// A record: N, F[0..ND), then the closure's iterm, oterm and 1/|F|².
template <int ND>
struct Rec {
  static constexpr int R = 4 + ND;
  static constexpr int IT = ND + 1, OT = ND + 2, INV = ND + 3;
};

// the M1 closure of one cell's (N, F) (m1.eddington), into r[IT..INV]
template <int ND>
__device__ __forceinline__ void closure(double* r, double c_red) {
  const double N = r[0];
  const double Ns = nmax(N, kSmall);
  double fsum = 0.0;
#pragma unroll
  for (int e = 0; e < ND; ++e) fsum = fsum + r[1 + e] * r[1 + e];
  const double cN = c_red * Ns;
  double f2 = fsum / (cN * cN);
  f2 = nmin(nmax(f2, 0.0), 1.0);
  const double chi =
      (3.0 + 4.0 * f2) / (5.0 + 2.0 * sqrt(nmax(4.0 - 3.0 * f2, 0.0)));
  r[Rec<ND>::IT] = 0.5 * (1.0 - chi);
  r[Rec<ND>::OT] = 0.5 * (3.0 * chi - 1.0);
  r[Rec<ND>::INV] = 1.0 / nmax(fsum, kSmall);
}

// a record from shared memory, its fields `stride` doubles apart
template <int ND>
__device__ __forceinline__ void load_rec(const double* p, int stride,
                                         double* r) {
#pragma unroll
  for (int f = 0; f < Rec<ND>::R; ++f) r[f] = p[f * stride];
}

// the physical flux along axis d of a record: F[d], c²·P[d][j]
// (m1._phys_flux), multiplies and adds only
template <int ND>
__device__ __forceinline__ void rec_flux(const double* r, int d, double c2,
                                         double* out) {
  out[0] = r[1 + d];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const double nn = r[1 + d] * r[1 + j] * r[Rec<ND>::INV];
    out[1 + j] = c2 * (r[0] * (r[Rec<ND>::OT] * nn +
                               (j == d ? r[Rec<ND>::IT] : 0.0)));
  }
}

// the GLF face between a cell and its upper neighbour along an axis, from
// their records and their physical fluxes along it
template <int ND>
__device__ __forceinline__ void face(const double* fl, const double* fr,
                                     const double* rl, const double* rr,
                                     double half_c, double* out) {
#pragma unroll
  for (int k = 0; k <= ND; ++k)
    out[k] = 0.5 * (fl[k] + fr[k]) - half_c * (rr[k] - rl[k]);
}

// one axis' GLF contribution dtdx*(face_lo - face_hi) added into acc
template <int ND>
__device__ __forceinline__ void glf_axis(const double* rm, const double* rc,
                                         const double* rp, int d,
                                         double dtdx, double half_c,
                                         double c2, double* acc) {
  double fm[1 + ND], fc[1 + ND], fp[1 + ND], lo[1 + ND], hi[1 + ND];
  rec_flux<ND>(rm, d, c2, fm);
  rec_flux<ND>(rc, d, c2, fc);
  rec_flux<ND>(rp, d, c2, fp);
  face<ND>(fm, fc, rm, rc, half_c, lo);
  face<ND>(fc, fp, rc, rp, half_c, hi);
#pragma unroll
  for (int k = 0; k < 1 + ND; ++k) acc[k] = acc[k] + dtdx * (lo[k] - hi[k]);
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

// ---------------------------------------------------------------------
// the dense entry
// ---------------------------------------------------------------------

// The kernel's axes (X, Y, Z), Z fastest: (x, y, z) in 3D, (1, x, y) in
// 2D, (1, 1, x) in 1D.  A tile is TY × TZ cells of a plane with a ring of
// one cell along every spatial axis of the plane.
template <int ND>
struct DenseTile {
  static constexpr int TZ = ND == 1 ? kThreads : 32;
  static constexpr int TY = kThreads / TZ;
  static constexpr int RY = ND >= 2 ? 1 : 0;
  static constexpr int PZ = TZ + 2;
  static constexpr int PY = TY + 2 * RY;
  static constexpr int PC = PZ * PY;              // cells of a staged plane
  static constexpr int NPLANE = ND == 3 ? 3 : 1;  // planes of records kept
  static constexpr int NRAW = ND == 3 ? 2 : 1;    // raw planes in flight
  static constexpr int NQ = 2 + 2 * ND;           // raw values a cell, most
  // the dynamic shared memory with nq raw values a cell
  static constexpr int smem_bytes(int nq) {
    return (NPLANE * Rec<ND>::R + NRAW * nq) * PC * 8;
  }
};

struct Geom {
  int X, Y, Z;           // the kernel's axes
  long long ncell;
  int periodic;
  int cx;                // planes a block marches along X (3D)
  int tiles_z;           // tiles along Z
  int nq;                // raw values staged a cell: N, F, src, src_F
  double dt, dtdx, c_red, half_c, c2;
};

// a staged coordinate on an axis of n cells: the periodic ring wraps, an
// outflow ring copies its edge cell; ring cells past a ragged tile's far
// edge feed no kept cell and read the last cell
__device__ __forceinline__ int ghost(int c, int n, int periodic) {
  if (c < 0) return periodic ? n - 1 : 0;
  if (c >= n) return (periodic && c == n) ? 0 : n - 1;
  return c;
}

template <int ND>
__global__ void __launch_bounds__(kThreads)
    dense_kernel(const double* __restrict__ U, const double* __restrict__ src,
                 const double* __restrict__ srcF, double* __restrict__ out,
                 Geom g) {
  using T = DenseTile<ND>;
  constexpr int R = Rec<ND>::R, PC = T::PC;
  extern __shared__ __align__(16) double smem[];
  double* rec = smem;                          // [NPLANE][R][PC]
  double* raw = smem + T::NPLANE * R * PC;     // [NRAW][nq][PC]
  const int tid = threadIdx.x;
  const int grp = blockIdx.z;
  const int z0 = (int)(blockIdx.x % g.tiles_z) * T::TZ;
  const int y0 = (int)(blockIdx.x / g.tiles_z) * T::TY;
  const int x0 = (int)blockIdx.y * g.cx;
  const int x1 = min(x0 + g.cx, g.X);
  const long long ncell = g.ncell;
  const long long base = (long long)grp * (1 + ND) * ncell;
  const int qs = 1 + ND;                         // src's raw row
  const int qf = qs + (src != nullptr ? 1 : 0);  // src_F's first raw row
  const int ty = tid / T::TZ, tz = tid - ty * T::TZ;
  const bool mine = y0 + ty < g.Y && z0 + tz < g.Z;   // a kept cell
  const int ic = (ty + T::RY) * T::PZ + tz + 1;       // its staged index
  // staged planes alternate between the raw buffers, records rotate over
  // the slots: plane p in buffer (p - x0 + 1) % 2 and slot (p - x0 + 1) % 3
  auto buf = [&](int p) { return raw + ((p - x0 + 1) & 1) * g.nq * PC; };
  auto slot = [&](int p) { return rec + ((p - x0 + 1) % 3) * R * PC; };

  // plane x's raw values, tile and ring, into r (one commit group)
  // the in-plane offsets of this thread's staged cells (at most two: a
  // plane holds fewer than 2 × 256), the same for every plane
  constexpr int NS = (PC + kThreads - 1) / kThreads;
  static_assert(NS <= 2, "a staged plane holds at most two cells a thread");
  long long yz[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int i = tid + j * kThreads, ry = i / T::PZ, rz = i - ry * T::PZ;
    yz[j] = (long long)ghost(y0 - T::RY + ry, g.Y, g.periodic) * g.Z +
            ghost(z0 - 1 + rz, g.Z, g.periodic);
  }
  auto stage = [&](int x, double* r) {
    const long long plane = (long long)ghost(x, g.X, g.periodic) * g.Y * g.Z;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int i = tid + j * kThreads;
      if (i >= PC) break;
      const long long cell = plane + yz[j];
#pragma unroll
      for (int k = 0; k <= ND; ++k)
        cp_async_f64(r + k * PC + i, U + base + k * ncell + cell);
      if (src != nullptr)
        cp_async_f64(r + qs * PC + i, src + grp * ncell + cell);
      if (srcF != nullptr) {
#pragma unroll
        for (int e = 0; e < ND; ++e)
          cp_async_f64(r + (qf + e) * PC + i,
                       srcF + ((long long)grp * ND + e) * ncell + cell);
      }
    }
    cp_async_commit();
  };
  // a staged plane's records, from its raw values r into slot s
  auto records = [&](const double* r, double* s) {
    for (int i = tid; i < PC; i += kThreads) {
      double v[R];
      v[0] = r[i];
      if (src != nullptr) v[0] = v[0] + g.dt * r[qs * PC + i];
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        v[1 + e] = r[(1 + e) * PC + i];
        if (srcF != nullptr) v[1 + e] = v[1 + e] + g.dt * r[(qf + e) * PC + i];
      }
      closure<ND>(v, g.c_red);
#pragma unroll
      for (int f = 0; f < R; ++f) s[f * PC + i] = v[f];
    }
  };
  // the kept cell of plane x: the axes of the plane from the records of
  // slot sc, and in 3D the x axis from the face carried from plane x-1
  // (lo, with the cell's own x flux fcx) and plane x+1's records (sp);
  // returns the new state's values
  double lo[1 + ND], fcx[1 + ND];
  auto update = [&](int x, const double* sc, const double* sp) {
    double rc[R], acc[1 + ND];
    load_rec<ND>(sc + ic, PC, rc);
#pragma unroll
    for (int k = 0; k <= ND; ++k) acc[k] = 0.0;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int axis = d + 3 - ND;               // 0: X, 1: Y, 2: Z
      if (axis == 0) {
        double rp[R], fp[1 + ND], hi[1 + ND];
        load_rec<ND>(sp + ic, PC, rp);
        rec_flux<ND>(rp, 0, g.c2, fp);
        face<ND>(fcx, fp, rc, rp, g.half_c, hi);
#pragma unroll
        for (int k = 0; k <= ND; ++k) {
          acc[k] = acc[k] + g.dtdx * (lo[k] - hi[k]);
          lo[k] = hi[k];
          fcx[k] = fp[k];
        }
      } else {
        const int step = axis == 1 ? T::PZ : 1;
        double rm[R], rp[R];
        load_rec<ND>(sc + ic - step, PC, rm);
        load_rec<ND>(sc + ic + step, PC, rp);
        glf_axis<ND>(rm, rc, rp, d, g.dtdx, g.half_c, g.c2, acc);
      }
    }
    double res[1 + ND];
    finish<ND>(rc, acc, g.c_red, res);
    const long long cell = ((long long)x * g.Y + y0 + ty) * g.Z + z0 + tz;
#pragma unroll
    for (int k = 0; k <= ND; ++k) out[base + k * ncell + cell] = res[k];
  };

  if constexpr (ND == 3) {
    stage(x0 - 1, buf(x0 - 1));
    stage(x0, buf(x0));
    cp_async_wait<1>();
    __syncthreads();
    records(buf(x0 - 1), slot(x0 - 1));
    cp_async_wait<0>();
    __syncthreads();             // plane x0 staged, buffer of x0-1 free
    stage(x0 + 1, buf(x0 + 1));
    records(buf(x0), slot(x0));
    __syncthreads();             // records x0-1, x0 ready, buffer free
    if (x0 + 2 <= x1) stage(x0 + 2, buf(x0 + 2));
    if (mine) {
      // the x face below plane x0, carried into the march
      double rm[R], rc[R], fm[1 + ND];
      load_rec<ND>(slot(x0 - 1) + ic, PC, rm);
      load_rec<ND>(slot(x0) + ic, PC, rc);
      rec_flux<ND>(rm, 0, g.c2, fm);
      rec_flux<ND>(rc, 0, g.c2, fcx);
      face<ND>(fm, fcx, rm, rc, g.half_c, lo);
    }
    if (x0 + 2 <= x1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();             // plane x0+1 staged
    records(buf(x0 + 1), slot(x0 + 1));
#pragma unroll 1
    for (int x = x0; x < x1; ++x) {
      cp_async_wait<0>();
      __syncthreads();           // records x+1 ready, plane x+2 staged,
                                 // plane x-1's slot and x+1's buffer free
      if (x + 3 <= x1) stage(x + 3, buf(x + 3));
      if (x + 2 <= x1) records(buf(x + 2), slot(x + 2));
      if (mine) update(x, slot(x), slot(x + 1));
    }
  } else {
    stage(0, raw);
    cp_async_wait<0>();
    __syncthreads();
    records(raw, rec);
    __syncthreads();
    if (mine) update(0, rec, rec);
  }
}

// ---------------------------------------------------------------------
// the block entry
// ---------------------------------------------------------------------

template <int ND>
struct OctTile {
  static constexpr int kCells = 1 << ND;          // interior cells an oct
  static constexpr int OB = kThreads / kCells;    // octs a block
  static constexpr int NC = kCells * (1 + ND);    // cells with a closure
  static constexpr int SIDE = ND == 1 ? 6 : (ND == 2 ? 36 : 216);  // 6^ND
  static constexpr int OUT = kCells * (1 + ND) + 1;  // an oct's rows, padded
  static constexpr int SMEM = (Rec<ND>::R * NC * OB + OB * OUT) * 8;
};

// Needed cells of an oct, in slot order: the 2^ND interior cells (bits of
// the index, axis 0 first, each coordinate 2 + bit), then per axis d and
// side (coordinate 1, then 4) the 2^(ND-1) cells whose other coordinates
// are interior (their bits in axis order).  The stencil index of slot j:
template <int ND>
__device__ __forceinline__ int needed_cell(int j) {
  constexpr int kCells = 1 << ND, half = kCells / 2;
  int c[3];
  if (j < kCells) {
#pragma unroll
    for (int d = 0; d < ND; ++d) c[d] = 2 + ((j >> (ND - 1 - d)) & 1);
  } else {
    const int k = j - kCells;
    const int d = k / (2 * half), side = (k / half) & 1, b = k % half;
    int bit = ND - 2;
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      if (e == d) {
        c[e] = side ? 4 : 1;
      } else {
        c[e] = 2 + ((b >> bit) & 1);
        --bit;
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int d = 0; d < ND; ++d) s = s * 6 + c[d];
  return s;
}

// the slot of interior cell `cell`'s neighbour along axis d (side 0: -1,
// side 1: +1)
template <int ND>
__device__ __forceinline__ int neighbour_slot(int cell, int d, int side) {
  constexpr int kCells = 1 << ND;
  const int bd = (cell >> (ND - 1 - d)) & 1;
  if (bd != side) return cell ^ (1 << (ND - 1 - d));
  int b = 0;
#pragma unroll
  for (int e = 0; e < ND; ++e)
    if (e != d) b = (b << 1) | ((cell >> (ND - 1 - e)) & 1);
  return kCells + (2 * d + side) * (kCells / 2) + b;
}

template <int ND>
__global__ void __launch_bounds__(kThreads)
    block_kernel(const double* __restrict__ blk, double* __restrict__ rows,
                 int ng, long long noct, double dtdx, double c_red,
                 double half_c, double c2) {
  using T = OctTile<ND>;
  constexpr int R = Rec<ND>::R, NC = T::NC, OB = T::OB;
  constexpr int kCells = T::kCells;
  extern __shared__ __align__(16) double smem[];
  double* rec = smem;                  // [R][NC][OB]
  double* stg = smem + R * NC * OB;    // [OB][OUT]
  const int tid = threadIdx.x;
  const long long o0 = (long long)blockIdx.x * OB;
  const long long left = noct - o0;
  const int nob = left < OB ? (int)left : OB;     // this block's octs
  const long long ncols = (long long)ng * (1 + ND);
#pragma unroll 1
  for (int g = 0; g < ng; ++g) {
    const double* b = blk + (long long)g * (1 + ND) * T::SIDE * noct + o0;
    for (int i = tid; i < NC * OB; i += kThreads) {
      const int j = i / OB, o = i - j * OB;
      if (o >= nob) continue;
      const int s = needed_cell<ND>(j);
      double v[R];
#pragma unroll
      for (int k = 0; k <= ND; ++k)
        v[k] = b[((long long)k * T::SIDE + s) * noct + o];
      closure<ND>(v, c_red);
#pragma unroll
      for (int f = 0; f < R; ++f) rec[(f * NC + j) * OB + o] = v[f];
    }
    __syncthreads();
    {
      const int cell = tid / OB, o = tid - cell * OB;
      if (o < nob) {
        double rc[R], acc[1 + ND];
        load_rec<ND>(rec + cell * OB + o, NC * OB, rc);
#pragma unroll
        for (int k = 0; k <= ND; ++k) acc[k] = 0.0;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          double rm[R], rp[R];
          load_rec<ND>(rec + neighbour_slot<ND>(cell, d, 0) * OB + o,
                       NC * OB, rm);
          load_rec<ND>(rec + neighbour_slot<ND>(cell, d, 1) * OB + o,
                       NC * OB, rp);
          glf_axis<ND>(rm, rc, rp, d, dtdx, half_c, c2, acc);
        }
        double res[1 + ND];
        finish<ND>(rc, acc, c_red, res);
#pragma unroll
        for (int k = 0; k <= ND; ++k)
          stg[o * T::OUT + cell * (1 + ND) + k] = res[k];
      }
    }
    __syncthreads();
    // rows o0*2^ND.. (oct-major), this group's 1+ND columns
    for (int i = tid; i < nob * kCells * (1 + ND); i += kThreads) {
      const int r = i / (1 + ND), k = i - r * (1 + ND);
      const int o = r / kCells, cell = r - o * kCells;
      rows[(o0 * kCells + r) * ncols + g * (1 + ND) + k] =
          stg[o * T::OUT + cell * (1 + ND) + k];
    }
    __syncthreads();
  }
}

// cudaFuncSetAttribute once per kernel and device: the dynamic shared
// memory above 48 KB.  Sets *dev; returns its error.
template <class K>
int prepare(K kernel, int bytes, unsigned long long* done, int* dev) {
  int err = (int)cudaGetDevice(dev);
  if (err) return err;
  const unsigned long long bit = 1ull << (*dev & 63);
  if (*done & bit) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err) *done |= bit;
  return err;
}

// The 3D dense blocks the card holds at once with `smem` bytes each (its
// SMs times the blocks an SM holds), asked once per device and record
// width and kept in *resident; after prepare, so that the occupancy query
// sees the raised shared-memory limit.  Returns its error.
int resident_blocks(int dev, int smem, int* resident) {
  if (*resident > 0) return 0;
  int sms = 0, per_sm = 0;
  int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dense_kernel<3>, kThreads, smem);
  if (!err) *resident = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <int ND>
int launch_dense(const double* U, const double* src, const double* srcF,
                 double* out, int ng, int nx, int ny, int nz, int periodic,
                 double dt, double dtdx, double c_red, double c2,
                 cudaStream_t s) {
  using T = DenseTile<ND>;
  static unsigned long long done = 0;
  // resident blocks per device (64 at most) and record width
  static int resident[64][T::NQ + 1];
  Geom g;
  g.X = ND == 3 ? nx : 1;
  g.Y = ND == 3 ? ny : (ND == 2 ? nx : 1);
  g.Z = ND == 3 ? nz : (ND == 2 ? ny : nx);
  g.ncell = (long long)nx * ny * nz;
  g.periodic = periodic;
  g.tiles_z = (g.Z + T::TZ - 1) / T::TZ;
  const long long tiles_y = (g.Y + T::TY - 1) / T::TY;
  const long long tiles = (long long)g.tiles_z * tiles_y;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  g.nq = 1 + ND + (src != nullptr ? 1 : 0) + (srcF != nullptr ? ND : 0);
  const int smem = T::smem_bytes(g.nq);
  int dev = 0;
  int err = prepare(dense_kernel<ND>, T::smem_bytes(T::NQ), &done, &dev);
  if (err) return err;
  // the planes a 3D block marches: as many chunks along x as leave every
  // block resident at once, so that the launch fills the card
  int cx = 1;
  if (ND == 3) {
    int& res = resident[dev & 63][g.nq];
    err = resident_blocks(dev, smem, &res);
    if (err) return err;
    long long nchunk = res / (tiles * ng);
    nchunk = nchunk < 1 ? 1 : (nchunk > g.X ? g.X : nchunk);
    cx = (int)((g.X + nchunk - 1) / nchunk);
  }
  g.cx = cx;
  g.dt = dt;
  g.dtdx = dtdx;
  g.c_red = c_red;
  g.half_c = 0.5 * c_red;
  g.c2 = c2;
  const int nchunk = (g.X + cx - 1) / cx;
  if (nchunk > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)nchunk, (unsigned)ng);
  dim3 block(kThreads);
  dense_kernel<ND><<<grid, block, smem, s>>>(U, src, srcF, out, g);
  return (int)cudaGetLastError();
}

template <int ND>
int launch_block(const double* blk, double* rows, int ng, long long noct,
                 double dtdx, double c_red, double c2, cudaStream_t s) {
  using T = OctTile<ND>;
  static unsigned long long done = 0;
  const long long nblk = (noct + T::OB - 1) / T::OB;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int dev = 0;
  int err = prepare(block_kernel<ND>, T::SMEM, &done, &dev);
  if (err) return err;
  dim3 grid((unsigned)nblk);
  dim3 block(kThreads);
  const int smem = T::SMEM;
  block_kernel<ND><<<grid, block, smem, s>>>(blk, rows, ng, noct, dtdx,
                                             c_red, 0.5 * c_red, c2);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  switch (nd) {
    case 1:
      return launch_dense<1>(U, src, srcF, out, ng, nx, ny, nz, periodic, dt,
                             dtdx, c_red, c2, s);
    case 2:
      return launch_dense<2>(U, src, srcF, out, ng, nx, ny, nz, periodic, dt,
                             dtdx, c_red, c2, s);
    case 3:
      return launch_dense<3>(U, src, srcF, out, ng, nx, ny, nz, periodic, dt,
                             dtdx, c_red, c2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// One block substep of a partial level: blk [ng*(1+nd), 6^nd, noct] in,
// the interior cells of each oct written over rows[:noct*2^nd].
extern "C" int ramses_rt_m1_block(const double* blk, double* rows, int ng,
                                  int nd, long long noct, double dtdx,
                                  double c_red, double c2, void* stream) {
  if (noct <= 0 || ng <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nd) {
    case 1:
      return launch_block<1>(blk, rows, ng, noct, dtdx, c_red, c2, s);
    case 2:
      return launch_block<2>(blk, rows, ng, noct, dtdx, c_red, c2, s);
    case 3:
      return launch_block<3>(blk, rows, ng, noct, dtdx, c_red, c2, s);
    default:
      return cudaErrorInvalidValue;
  }
}
