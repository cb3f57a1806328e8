// MUSCL-Hancock sweeps of the partial AMR levels, hand-written for Hopper
// (sm_90a): K3 on blocked Morton tiles and K2 on per-oct 6^3 stencils.
//
// Replaces the TPU kernels ramses_tpu/hydro/pallas_oct.py::tile_sweep (body
// _make_tile_kernel) and ::oct_sweep (body _make_kernel).  Both run K1's
// MUSCL body (muscl_common.cuh) on a gathered batch of blocks whose last
// axis runs over the batch (tiles or octs):
//   K3: ut [5, td, td, td, N], ok [td, td, td, N], td = c + 4, c = 2^(shift+1)
//       -> du [5, c, c, c, N] and corrp [5, 3, c/2+1, c, c, N]: the
//       dt/dx-scaled face fluxes at positions 2 + 2k along each direction
//       (the octs' faces), transverse interior, other axes in increasing
//       order;
//   K2: uloc [5, 6, 6, 6, N], ok [6, 6, 6, N] -> du [5, 2, 2, 2, N] and
//       corr [5, 3, 2, N]: the low (index 2) and high (index 4) face fluxes
//       summed over the 2x2 transverse interior, times dt/dx.
// With want_flux (phi != NULL) each also writes the dt/dx-scaled mass
// fluxes of the MC-tracer capture: K3 all c+1 cell-face planes along each
// direction, phip [3, c+1, c, c, N] (pallas_oct.py:345-350); K2 each
// interior cell's (low, high) faces, phi [3, 2, 2, 2, 2, N] (d, side, cell;
// pallas_oct.py:164-170).
// A face next to a refined cell carries no flux: keep = (1-ok_i)(1-ok_{i-1}).
// Only what the outputs consume is computed; the TPU kernels' roll
// wrap-around junk in the halo is not reproduced.
//
// Layout: the batch axis stays minor, as the JAX package's gathers and tests
// have it.  Consecutive threads take consecutive batch entries at the same
// cell (threadIdx.x walks N), so each warp's load or store of one variable
// is one contiguous line, and the gather that builds the batch writes this
// layout directly: no transpose before or after the launch.
//
// The roofline on an H100 is bytes: per tile at shift 2 (td 12, c 8) the
// sweep must read 6 td^3 floats (state and mask, 41.5 KB) and write
// 5 c^3 + 15 (c/2+1) c^2 floats (29.4 KB), 21 ns of device memory time per
// tile at 3.35 TB/s (the mass-flux planes add 3 (c+1) c^2 floats, 2.6 KB;
// K2's add 48 an oct), against ~6 ns for the ~0.8 k f32 operations per
// interior cell at 67 TFLOP/s.  At the main path's few hundred tiles that
// is microseconds of work.
//
// This simple design does not reach it: one thread per (interior cell,
// batch entry), neighbours' primitives and slopes recomputed in registers
// as K1 does (about 7x the arithmetic), so instructions and latency set its
// time, at a small share of the byte bound (PERF.md).  K2's
// per-oct sums need the four cells of a face: each thread parks its face
// flux in shared memory and, after one barrier, the oct's eight threads add
// them in a fixed order, so the sums are the same from run to run.

#include "muscl_common.cuh"

namespace {

constexpr int MAX_TX = 32;  // batch entries per block (threadIdx.x)

// make_cell's loader on a gathered block: batch entry b of a td^3 block.
struct BlockLoad {
  const float* __restrict__ u;
  const Consts* k;
  int64_t vs;  // one variable's stride, td^3 * n
  int td, n, b;
  __device__ __forceinline__ void operator()(int x, int y, int z, float q[5],
                                             float* ir) const {
    const int64_t o = (int64_t)((x * td + y) * td + z) * n + b;
    cons_to_prim(__ldg(u + o), __ldg(u + vs + o), __ldg(u + 2 * vs + o),
                 __ldg(u + 3 * vs + o), __ldg(u + 4 * vs + o), *k, q, ir);
  }
};

// C interior cells per side; PLANES: K3's face planes, else K2's per-oct
// sums (C == 2, blockDim.y == 8: all of an oct's cells in one block).
// phi == nullptr: no mass-flux output (uniform over the launch).
template <int C, bool PLANES, int RS>
__global__ void __launch_bounds__(256)
sweep_kernel(const float* __restrict__ u, const float* __restrict__ ok,
             const float* __restrict__ dt_ptr, float* __restrict__ du,
             float* __restrict__ out, float* __restrict__ phi, int n,
             Consts k) {
  constexpr int TD = C + 4;
  constexpr int NC = C * C * C;
  constexpr int NP = C / 2 + 1;  // face planes per direction
  __shared__ float part[PLANES ? 1 : 3 * 2 * 5 * 4 * MAX_TX];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int cell = blockIdx.y * blockDim.y + threadIdx.y;
  const int ic[3] = {cell / (C * C), (cell / C) % C, cell % C};
  const float dt = __ldg(dt_ptr);
  const float dtdx2 = 0.5f * dt / k.dx;
  const float scale = dt / k.dx;
  if (b < n && cell < NC) {
    const int64_t nslot = (int64_t)TD * TD * TD;
    const BlockLoad load{u, &k, nslot * n, TD, n, b};
    auto ok_at = [&](int x, int y, int z) {
      return __ldg(ok + (int64_t)((x * TD + y) * TD + z) * n + b);
    };
    const int x = ic[0] + 2, y = ic[1] + 2, z = ic[2] + 2;
    Cell cc;
    make_cell(load, k, x, y, z, cc);
    const float okc = ok_at(x, y, z);
    float dsum[5];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int e0 = d == 0, e1 = d == 1, e2 = d == 2;
      float ql[5], qr[5], flo[5], fhi[5];
      {  // low face: left = high face of cell - e_d, right = low face of cell
        Cell cn;
        make_cell(load, k, x - e0, y - e1, z - e2, cn);
        face_state(cn, k, d, 0.5f, dtdx2, ql);
      }
      face_state(cc, k, d, -0.5f, dtdx2, qr);
      solve<RS>(ql, qr, d, k, flo);
      {  // high face: left = high face of cell, right = low face of cell + e_d
        Cell cn;
        make_cell(load, k, x + e0, y + e1, z + e2, cn);
        face_state(cn, k, d, -0.5f, dtdx2, qr);
      }
      face_state(cc, k, d, 0.5f, dtdx2, ql);
      solve<RS>(ql, qr, d, k, fhi);
      const float keep_lo = (1.0f - okc) * (1.0f - ok_at(x - e0, y - e1, z - e2));
      const float keep_hi = (1.0f - ok_at(x + e0, y + e1, z + e2)) * (1.0f - okc);
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        flo[v] = flo[v] * keep_lo;
        fhi[v] = fhi[v] * keep_hi;
        const float contrib = (flo[v] - fhi[v]) * scale;
        dsum[v] = (d == 0) ? contrib : dsum[v] + contrib;
      }
      const int p = ic[d];                         // interior coordinate on d
      const int t1 = ic[d == 0 ? 1 : 0], t2 = ic[d == 2 ? 1 : 2];
      if (phi != nullptr) {
        if constexpr (PLANES) {
          // plane j is the low face of interior cell j; plane C the high
          // face of the last cell
          const int64_t base = (int64_t)d * (C + 1);
          phi[(((base + p) * C + t1) * C + t2) * n + b] = flo[0] * scale;
          if (p == C - 1)
            phi[(((base + C) * C + t1) * C + t2) * n + b] = fhi[0] * scale;
        } else {
          phi[((int64_t)(d * 2) * NC + cell) * n + b] = flo[0] * scale;
          phi[((int64_t)(d * 2 + 1) * NC + cell) * n + b] = fhi[0] * scale;
        }
      }
      if constexpr (PLANES) {
        // plane kp sits at face 2 + 2 kp: the low face of interior cell
        // 2 kp, and the last plane the high face of the last cell
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          const int64_t base = (int64_t)(v * 3 + d) * NP;
          if ((p & 1) == 0)
            out[(((base + p / 2) * C + t1) * C + t2) * n + b] = flo[v] * scale;
          if (p == C - 1)
            out[(((base + C / 2) * C + t1) * C + t2) * n + b] = fhi[v] * scale;
        }
      } else {
        // side 0: face 2 (low face of interior cell 0); side 1: face 4
        // (high face of interior cell 1)
#pragma unroll
        for (int v = 0; v < 5; ++v)
          part[(((d * 2 + p) * 5 + v) * 4 + t1 * 2 + t2) * MAX_TX + threadIdx.x] =
              p ? fhi[v] : flo[v];
      }
    }
#pragma unroll
    for (int v = 0; v < 5; ++v)
      du[((((int64_t)v * C + ic[0]) * C + ic[1]) * C + ic[2]) * n + b] = dsum[v];
  }
  if constexpr (!PLANES) {
    __syncthreads();
    if (b < n) {
      // j = (v * 3 + d) * 2 + side is also corr's flat [5, 3, 2] index
      for (int j = threadIdx.y; j < 30; j += blockDim.y) {
        const int side = j & 1, d = (j >> 1) % 3, v = j / 6;
        const float* f = part + ((d * 2 + side) * 5 + v) * 4 * MAX_TX + threadIdx.x;
        const float s = ((f[0] + f[MAX_TX]) + f[2 * MAX_TX]) + f[3 * MAX_TX];
        out[(int64_t)j * n + b] = s * scale;
      }
    }
  }
}

template <int C, bool PLANES>
int launch(const float* u, const float* ok, const float* dt, float* du,
           float* out, float* phi, int n, int riemann, const Consts& k,
           cudaStream_t s) {
  const int tx = n >= 32 ? 32 : (n >= 16 ? 16 : 8);
  const int ty = PLANES ? 128 / tx : C * C * C;
  dim3 block(tx, ty, 1);
  dim3 grid((n + tx - 1) / tx, (C * C * C + ty - 1) / ty, 1);
  if (riemann == 0)
    sweep_kernel<C, PLANES, 0><<<grid, block, 0, s>>>(u, ok, dt, du, out, phi,
                                                      n, k);
  else
    sweep_kernel<C, PLANES, 1><<<grid, block, 0, s>>>(u, ok, dt, du, out, phi,
                                                      n, k);
  return (int)cudaGetLastError();
}

Consts make_consts(float slope_factor, float gamma, float gm1, float entho,
                   float smallr, float smallc2, float smallp, float smalle,
                   float dx) {
  Consts k;
  k.gamma = gamma; k.gm1 = gm1; k.entho = entho; k.smallr = smallr;
  k.smallc2 = smallc2; k.smallp = smallp; k.smalle = smalle;
  k.slope = slope_factor; k.dx = dx; k.fac = 0.0f;
  return k;
}

}  // namespace

// All arrays f32, contiguous, on the device; ok is the 0/1 refined mask;
// dt one f32 on the device.  riemann: 0 llf, 1 hllc.  phi is the mass-flux
// output or NULL.  Each launches on `stream` without synchronising and
// returns cudaGetLastError().

// K3: ut [5, td, td, td, n] -> du [5, c, c, c, n], corrp [5, 3, c/2+1, c, c, n]
// (and phip [3, c+1, c, c, n]) with c = 2^(shift+1), td = c + 4, shift in
// 0..3.
extern "C" int ramses_tile_sweep(
    const float* ut, const float* ok, const float* dt, float* du, float* corrp,
    float* phip, int shift, int n, int riemann, float slope_factor,
    float gamma, float gm1, float entho, float smallr, float smallc2,
    float smallp, float smalle, float dx, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(slope_factor, gamma, gm1, entho, smallr,
                               smallc2, smallp, smalle, dx);
  cudaStream_t s = (cudaStream_t)stream;
  switch (shift) {
    case 0:
      return launch<2, true>(ut, ok, dt, du, corrp, phip, n, riemann, k, s);
    case 1:
      return launch<4, true>(ut, ok, dt, du, corrp, phip, n, riemann, k, s);
    case 2:
      return launch<8, true>(ut, ok, dt, du, corrp, phip, n, riemann, k, s);
    case 3:
      return launch<16, true>(ut, ok, dt, du, corrp, phip, n, riemann, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2: uloc [5, 6, 6, 6, n] -> du [5, 2, 2, 2, n], corr [5, 3, 2, n]
// (and phi [3, 2, 2, 2, 2, n]).
extern "C" int ramses_oct_sweep(
    const float* uloc, const float* ok, const float* dt, float* du,
    float* corr, float* phi, int n, int riemann, float slope_factor,
    float gamma, float gm1, float entho, float smallr, float smallc2,
    float smallp, float smalle, float dx, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(slope_factor, gamma, gm1, entho, smallr,
                               smallc2, smallp, smalle, dx);
  return launch<2, false>(uloc, ok, dt, du, corr, phi, n, riemann, k,
                          (cudaStream_t)stream);
}
