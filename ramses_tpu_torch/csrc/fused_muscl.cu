// Fused 3D unsplit MUSCL-Hancock step, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel ramses_tpu/hydro/pallas_muscl.py::fused_step_padded
// (body _make_kernel; helpers _slopes, _llf_flux, _hllc_flux): ctoprim ->
// TVD slopes -> trace3d predictor -> LLF/HLLC face fluxes -> conservative
// update, with an optional refined-cell mask and the Courant min of the
// updated state (the next step's dt) from the same launch.  It computes what
// the TPU kernel computes, in the same f32 arithmetic order; it is not a
// block-by-block copy of it.
//
// What bounds it on an H100 at 256^3 (5 f32 variables): it must read the
// state once and write the update once, 5 * (256^3 + 256^3) * 4 B = 0.67 GB,
// i.e. 0.20 ms at 3.35 TB/s.  The arithmetic the algorithm needs, counted
// op by op on the plain version (chip_smoke.py), is about 0.79 k f32
// operations per cell (one ctoprim, 15 slopes, the predictor, three face
// solves with each face shared by two cells, the update and the Courant
// term; compares and selects count): 13.2 G ops, i.e. 0.20 ms at
// 67 TFLOP/s.  The two bounds nearly coincide; bytes bind by a hair.
//
// What this simple design does about it: one thread per output cell, z (the
// contiguous axis) along threadIdx.x so that neighbouring threads read
// neighbouring addresses, every intermediate in registers, and neighbours'
// primitives and slopes recomputed rather than staged.  Device memory then
// sees one read of the state (the stencil's re-reads hit L1/L2) and one write
// of the update, as the TPU kernel was built for; the price is about 7x
// recomputed arithmetic, so this version is bound by instructions, not by
// bytes (about 30x the bound, PERF.md).  Shared-memory tiling, so that each
// cell's primitives and slopes are computed once per block, and
// cp.async/TMA staging are later work.
//
// Ghost cells are not materialized: each axis maps an out-of-range index
// itself (0 periodic wrap, 1 reflect with the normal momentum negated,
// 2 outflow clamp), which composes over axes exactly like the dim-by-dim
// ghost padding of grid/boundary.pad.  Offsets are 64-bit: a 512^3 state
// is 2.7 GB, past 2^31 bytes, and at 1024^3 the element offsets of the
// last variables pass 2^31 too.
//
// The Courant min: blocks run concurrently, so each block reduces its cells'
// dx/ws, multiplies by fac (folded on the host as at pallas_muscl.py:312-315)
// and does one atomicMin on the bit pattern of the non-negative float into a
// scalar the wrapper initialises to +inf.  A min does not depend on order,
// so the result is deterministic.  A NaN maps to the key -1 and wins, so
// dt_next is NaN when the state is, as jnp.min would give.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TZ = 32;  // threads along z (contiguous)
constexpr int TY = 4;   // threads along y

struct Consts {
  float gamma, gm1, entho, smallr, smallc2, smallp, smalle, slope;
  float dx, fac;
};

struct Geom {
  int n[3];
  int bc[3][2];
  int64_t plane;  // nx * ny * nz
};

// Map a possibly ghost index along one axis into [0, n); flips *sgn for a
// reflecting face.  Valid for i in [-2, n + 1] and n >= 2.
__device__ __forceinline__ int map_index(int i, int n, int lo, int hi,
                                         float* sgn) {
  if (i < 0) {
    if (lo == 0) return i + n;
    if (lo == 1) { *sgn = -*sgn; return -1 - i; }
    return 0;
  }
  if (i >= n) {
    if (hi == 0) return i - n;
    if (hi == 1) { *sgn = -*sgn; return 2 * n - 1 - i; }
    return n - 1;
  }
  return i;
}

__device__ __forceinline__ int64_t cell_offset(const Geom& g, int x, int y,
                                               int z, float s[3]) {
  s[0] = s[1] = s[2] = 1.0f;
  int mx = map_index(x, g.n[0], g.bc[0][0], g.bc[0][1], &s[0]);
  int my = map_index(y, g.n[1], g.bc[1][0], g.bc[1][1], &s[1]);
  int mz = map_index(z, g.n[2], g.bc[2][0], g.bc[2][1], &s[2]);
  return ((int64_t)mx * g.n[1] + my) * g.n[2] + mz;
}

// Primitive state (r, vx, vy, vz, p) of a (possibly ghost) cell, and 1/r.
__device__ __forceinline__ void load_prim(const float* __restrict__ u,
                                          const Geom& g, const Consts& k,
                                          int x, int y, int z, float q[5],
                                          float* ir_out) {
  float s[3];
  int64_t o = cell_offset(g, x, y, z, s);
  float r = fmaxf(__ldg(u + o), k.smallr);
  float ir = 1.0f / r;
  float v0 = __ldg(u + g.plane + o) * ir;
  float v1 = __ldg(u + 2 * g.plane + o) * ir;
  float v2 = __ldg(u + 3 * g.plane + o) * ir;
  float ek = 0.5f * (v0 * v0 + v1 * v1 + v2 * v2);
  float eint = fmaxf(__ldg(u + 4 * g.plane + o) * ir - ek, k.smalle);
  q[0] = r;
  q[1] = v0 * s[0];
  q[2] = v1 * s[1];
  q[3] = v2 * s[2];
  q[4] = k.gm1 * r * eint;
  *ir_out = ir;
}

// _slopes: TVD slope from (left, centre, right); sign(0) = 0 as jnp.sign.
__device__ __forceinline__ float slope(float ql, float q, float qr, float f) {
  float dl = q - ql;
  float dr = qr - q;
  float dcen = 0.5f * (dl + dr);
  float slop = f * fminf(fabsf(dl), fabsf(dr));
  float dlim = (dl * dr <= 0.0f) ? 0.0f : slop;
  float sgn = (dcen > 0.0f) ? 1.0f : ((dcen < 0.0f) ? -1.0f : 0.0f);
  return sgn * fminf(dlim, fabsf(dcen));
}

// One cell's primitives, slopes in the three directions and the trace3d
// source terms: everything its face states need.
struct Cell {
  float q[5];
  float dq[3][5];
  float sr0, sp0, sv0[3];
};

__device__ __forceinline__ void make_cell(const float* __restrict__ u,
                                          const Geom& g, const Consts& k,
                                          int x, int y, int z, Cell& c) {
  float ir, irn;
  load_prim(u, g, k, x, y, z, c.q, &ir);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float qm1[5], qp1[5];
    int e0 = d == 0, e1 = d == 1, e2 = d == 2;
    load_prim(u, g, k, x - e0, y - e1, z - e2, qm1, &irn);
    load_prim(u, g, k, x + e0, y + e1, z + e2, qp1, &irn);
#pragma unroll
    for (int v = 0; v < 5; ++v) c.dq[d][v] = slope(qm1[v], c.q[v], qp1[v], k.slope);
  }
  float divv = c.dq[0][1] + c.dq[1][2] + c.dq[2][3];
#define ADV(comp) (c.q[1] * c.dq[0][comp] + c.q[2] * c.dq[1][comp] + \
                   c.q[3] * c.dq[2][comp])
  c.sr0 = -ADV(0) - divv * c.q[0];
  c.sp0 = -ADV(4) - divv * k.gamma * c.q[4];
#pragma unroll
  for (int j = 0; j < 3; ++j) c.sv0[j] = -ADV(1 + j) - c.dq[j][4] * ir;
#undef ADV
}

// Face state of cell c in direction d: sgn=+1 its high face, -1 its low face.
__device__ __forceinline__ void face_state(const Cell& c, const Consts& k,
                                           int d, float half, float dtdx2,
                                           float f[5]) {
  float rho = c.q[0] + half * c.dq[d][0] + c.sr0 * dtdx2;
  f[0] = (rho < k.smallr) ? c.q[0] : rho;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    f[1 + j] = c.q[1 + j] + half * c.dq[d][1 + j] + c.sv0[j] * dtdx2;
  f[4] = c.q[4] + half * c.dq[d][4] + c.sp0 * dtdx2;
}

// Floors of riemann.py _prims as the TPU kernel applies them (:278-281):
// the pressure floor uses the unfloored density.
__device__ __forceinline__ void floor_face(float f[5], const Consts& k) {
  float r = f[0];
  f[0] = fmaxf(r, k.smallr);
  f[4] = fmaxf(f[4], r * k.smallp);
}

// _llf_flux: state-layout LLF flux (mass, mom_x, mom_y, mom_z, energy).
__device__ __forceinline__ void llf_flux(const float ql[5], const float qr[5],
                                         int d, const Consts& k, float out[5]) {
  float ul = ql[1 + d], ur = qr[1 + d];
  float cl = sqrtf(fmaxf(k.gamma * ql[4] / ql[0], k.smallc2));
  float cr = sqrtf(fmaxf(k.gamma * qr[4] / qr[0], k.smallc2));
  float cmax = fmaxf(fabsf(ul) + cl, fabsf(ur) + cr);
  float uc[2][5], fx[2][5];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float* q = s ? qr : ql;
    float un = s ? ur : ul;
    float r = q[0], p = q[4];
    float ek = 0.5f * r * (q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    float et = p * k.entho + ek;
    uc[s][0] = r;
    uc[s][1] = r * q[1];
    uc[s][2] = r * q[2];
    uc[s][3] = r * q[3];
    uc[s][4] = et;
    float run = r * un;
    fx[s][0] = run;
#pragma unroll
    for (int c = 0; c < 3; ++c) fx[s][1 + c] = run * q[1 + c];
    fx[s][1 + d] = fx[s][1 + d] + p;
    fx[s][4] = un * (et + p);
  }
#pragma unroll
  for (int v = 0; v < 5; ++v)
    out[v] = 0.5f * (fx[0][v] + fx[1][v] - cmax * (uc[1][v] - uc[0][v]));
}

// _hllc_flux: HLLC with Toro sampling.  Every branch is computed and then
// selected, so a division in a branch not taken cannot reach the result.
__device__ __forceinline__ void hllc_flux(const float ql[5], const float qr[5],
                                          int d, const Consts& k, float out[5]) {
  float rl = ql[0], pl = ql[4], rr = qr[0], pr = qr[4];
  float ul = ql[1 + d], ur = qr[1 + d];
  float ekl = 0.5f * rl * (ql[1] * ql[1] + ql[2] * ql[2] + ql[3] * ql[3]);
  float ekr = 0.5f * rr * (qr[1] * qr[1] + qr[2] * qr[2] + qr[3] * qr[3]);
  float etotl = pl * k.entho + ekl;
  float etotr = pr * k.entho + ekr;
  float cfastl = sqrtf(fmaxf(k.gamma * pl / rl, k.smallc2));
  float cfastr = sqrtf(fmaxf(k.gamma * pr / rr, k.smallc2));
  float SL = fminf(ul, ur) - fmaxf(cfastl, cfastr);
  float SR = fmaxf(ul, ur) + fmaxf(cfastl, cfastr);
  float rcl = rl * (ul - SL);
  float rcr = rr * (SR - ur);
  float ustar = (rcr * ur + rcl * ul + (pl - pr)) / (rcr + rcl);
  float pstar = (rcr * pl + rcl * pr + rcl * rcr * (ul - ur)) / (rcr + rcl);
  float rstarl = rl * (SL - ul) / (SL - ustar);
  float etotstarl = ((SL - ul) * etotl - pl * ul + pstar * ustar) / (SL - ustar);
  float rstarr = rr * (SR - ur) / (SR - ustar);
  float etotstarr = ((SR - ur) * etotr - pr * ur + pstar * ustar) / (SR - ustar);
  bool sl_pos = SL > 0.0f, us_pos = ustar > 0.0f, sr_pos = SR > 0.0f;
#define SEL(a_l, a_sl, a_sr, a_r) \
  (sl_pos ? (a_l) : (us_pos ? (a_sl) : (sr_pos ? (a_sr) : (a_r))))
  float ro = SEL(rl, rstarl, rstarr, rr);
  float uo = SEL(ul, ustar, ustar, ur);
  float po = SEL(pl, pstar, pstar, pr);
  float etoto = SEL(etotl, etotstarl, etotstarr, etotr);
#undef SEL
  float fmass = ro * uo;
  out[0] = fmass;
  out[4] = (etoto + po) * uo;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[1 + c] = (c == d) ? fmass * uo + po
                          : fmass * (us_pos ? ql[1 + c] : qr[1 + c]);
}

template <int RS>
__device__ __forceinline__ void solve(float ql[5], float qr[5], int d,
                                      const Consts& k, float out[5]) {
  floor_face(ql, k);
  floor_face(qr, k);
  if (RS == 0) llf_flux(ql, qr, d, k, out);
  else hllc_flux(ql, qr, d, k, out);
}

__device__ __forceinline__ float load_ok(const float* __restrict__ ok,
                                         const Geom& g, int x, int y, int z) {
  float s[3];
  return __ldg(ok + cell_offset(g, x, y, z, s));
}

// ok == nullptr: no mask; crt_bits == nullptr: no Courant min.  Both are
// uniform over the launch, so their branches cost no divergence.
template <int RS>
__global__ void __launch_bounds__(TZ * TY)
fused_muscl_kernel(const float* __restrict__ u, const float* __restrict__ ok,
                   const float* __restrict__ dt_ptr, float* __restrict__ un,
                   int* __restrict__ crt_bits, Geom g, Consts k) {
  const int z = blockIdx.x * TZ + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const int x = blockIdx.z;
  const bool inside = z < g.n[2] && y < g.n[1];
  const bool masked = ok != nullptr;
  const bool courant = crt_bits != nullptr;
  int key = 0x7fffffff;  // above every non-negative float's bits
  if (inside) {
    const float dt = __ldg(dt_ptr);
    const float dtdx2 = 0.5f * dt / k.dx;
    const float scale = dt / k.dx;
    Cell cc;
    make_cell(u, g, k, x, y, z, cc);
    float okc = 0.0f;
    if (masked) okc = load_ok(ok, g, x, y, z);
    float du[5];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int e0 = d == 0, e1 = d == 1, e2 = d == 2;
      float ql[5], qr[5], flo[5], fhi[5];
      {  // low face: left = high face of cell - e_d, right = low face of cell
        Cell cn;
        make_cell(u, g, k, x - e0, y - e1, z - e2, cn);
        face_state(cn, k, d, 0.5f, dtdx2, ql);
      }
      face_state(cc, k, d, -0.5f, dtdx2, qr);
      solve<RS>(ql, qr, d, k, flo);
      {  // high face: left = high face of cell, right = low face of cell + e_d
        Cell cn;
        make_cell(u, g, k, x + e0, y + e1, z + e2, cn);
        face_state(cn, k, d, -0.5f, dtdx2, qr);
      }
      face_state(cc, k, d, 0.5f, dtdx2, ql);
      solve<RS>(ql, qr, d, k, fhi);
      if (masked) {  // face kept iff neither adjacent cell is refined
        float keep_lo = (1.0f - okc) * (1.0f - load_ok(ok, g, x - e0, y - e1, z - e2));
        float keep_hi = (1.0f - load_ok(ok, g, x + e0, y + e1, z + e2)) * (1.0f - okc);
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          flo[v] = flo[v] * keep_lo;
          fhi[v] = fhi[v] * keep_hi;
        }
      }
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        float contrib = (flo[v] - fhi[v]) * scale;
        du[v] = (d == 0) ? contrib : du[v] + contrib;
      }
    }
    const int64_t o = ((int64_t)x * g.n[1] + y) * g.n[2] + z;
    float w[5];
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      w[v] = __ldg(u + v * g.plane + o) + du[v];
      un[v * g.plane + o] = w[v];
    }
    if (courant) {  // cmpdt of the updated state (pallas_muscl.py:303-315)
      float r2 = fmaxf(w[0], k.smallr);
      float ir2 = 1.0f / r2;
      float v0 = w[1] * ir2, v1 = w[2] * ir2, v2 = w[3] * ir2;
      float ek2 = 0.5f * r2 * (v0 * v0 + v1 * v1 + v2 * v2);
      float p2 = fmaxf(k.gm1 * (w[4] - ek2), r2 * k.smallp);
      float c2 = sqrtf(k.gamma * p2 * ir2);
      float ws = 3.0f * c2 + fabsf(v0) + fabsf(v1) + fabsf(v2);
      float val = k.dx / ws;
      key = (val != val) ? -1 : __float_as_int(val);
    }
  }
  if (courant) {
    __shared__ int warp_min[TZ * TY / 32];
    const int tid = threadIdx.y * TZ + threadIdx.x;
    key = __reduce_min_sync(0xffffffffu, key);
    if ((tid & 31) == 0) warp_min[tid >> 5] = key;
    __syncthreads();
    if (tid == 0) {
      int m = warp_min[0];
#pragma unroll
      for (int i = 1; i < TZ * TY / 32; ++i) m = min(m, warp_min[i]);
      if (m != 0x7fffffff) {
        float local = __int_as_float(m) * k.fac;
        atomicMin(crt_bits, (local != local) ? -1 : __float_as_int(local));
      }
    }
  }
}

}  // namespace

// u, un: [5, nx, ny, nz] f32 contiguous; ok: [nx, ny, nz] f32 0/1 or NULL;
// dt: one f32 on the device; crt: one f32 on the device, holding +inf on
// entry, or NULL when the Courant min is not wanted.  bc: per axis (low,
// high) kind, 0 periodic, 1 reflecting, 2 outflow.  riemann: 0 llf, 1 hllc.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int ramses_fused_muscl(
    const float* u, const float* ok, const float* dt, float* un, float* crt,
    int nx, int ny, int nz, int bx0, int bx1, int by0, int by1, int bz0,
    int bz1, int riemann, float slope_factor, float gamma, float gm1,
    float entho, float smallr, float smallc2, float smallp, float smalle,
    float dx, float fac, void* stream) {
  if (nx > 65535) return (int)cudaErrorInvalidValue;
  Geom g;
  g.n[0] = nx; g.n[1] = ny; g.n[2] = nz;
  g.bc[0][0] = bx0; g.bc[0][1] = bx1;
  g.bc[1][0] = by0; g.bc[1][1] = by1;
  g.bc[2][0] = bz0; g.bc[2][1] = bz1;
  g.plane = (int64_t)nx * ny * nz;
  Consts k;
  k.gamma = gamma; k.gm1 = gm1; k.entho = entho; k.smallr = smallr;
  k.smallc2 = smallc2; k.smallp = smallp; k.smalle = smalle;
  k.slope = slope_factor; k.dx = dx; k.fac = fac;
  cudaStream_t s = (cudaStream_t)stream;
  int* crt_bits = reinterpret_cast<int*>(crt);
  dim3 block(TZ, TY, 1);
  dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, nx);
  if (riemann == 0)
    fused_muscl_kernel<0><<<grid, block, 0, s>>>(u, ok, dt, un, crt_bits, g, k);
  else
    fused_muscl_kernel<1><<<grid, block, 0, s>>>(u, ok, dt, un, crt_bits, g, k);
  return (int)cudaGetLastError();
}
