// Fused 3D unsplit MUSCL-Hancock step, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel ramses_tpu/hydro/pallas_muscl.py::fused_step_padded
// (body _make_kernel; helpers _slopes, _llf_flux, _hllc_flux): ctoprim ->
// TVD slopes -> trace3d predictor -> LLF/HLLC face fluxes -> conservative
// update, with an optional refined-cell mask, the Courant min of the
// updated state (the next step's dt) from the same launch and, on request,
// the dt/dx-scaled mass flux through each cell's low and high faces (the
// MC-tracer capture, want_flux; pallas_muscl.py:289-291).  It computes what
// the TPU kernel computes, in the same f32 arithmetic order; it is not a
// block-by-block copy of it.  The body's device functions (ctoprim, slopes,
// predictor, face states, floors, LLF/HLLC) are in muscl_common.cuh, shared
// with the AMR sweeps of oct_muscl.cu.
//
// What bounds it on an H100 at 256^3 (5 f32 variables): it must read the
// state once and write the update once, 5 * (256^3 + 256^3) * 4 B = 0.67 GB,
// i.e. 0.20 ms at 3.35 TB/s.  The arithmetic the algorithm needs, counted
// op by op on the plain version (chip_smoke.py), is about 0.79 k f32
// operations per cell (one ctoprim, 15 slopes, the predictor, three face
// solves with each face shared by two cells, the update and the Courant
// term; compares and selects count): 13.2 G ops, i.e. 0.20 ms at
// 67 TFLOP/s.  The two bounds nearly coincide; bytes bind by a hair.  The
// face mass fluxes add 6 f32 written per cell (with the mask, 17 f32 a
// cell moved instead of 11), and no arithmetic: each thread already holds
// its two masked mass fluxes per direction.
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
// Two entries, one kernel.  ramses_fused_muscl takes the unpadded state and
// does not materialize ghost cells: each axis maps an out-of-range index
// itself (0 periodic wrap, 1 reflect with the normal momentum negated,
// 2 outflow clamp), which composes over axes exactly like the dim-by-dim
// ghost padding of grid/boundary.pad.  ramses_fused_muscl_padded takes the
// TPU kernel's own contract, a state (and mask) with 2 ghost cells on every
// side, read as given: a shard of a slab-sharded sweep gets its ghosts from
// its neighbours (ramses_tpu_torch/parallel).  The entries differ only in
// cell_offset, at run time, so the per-cell arithmetic is one instruction
// stream and a shard's step is bitwise that of the whole box.  Offsets are
// 64-bit: a 512^3 state is 2.7 GB, past 2^31 bytes, and at 1024^3 the
// element offsets of the last variables pass 2^31 too.
//
// The Courant min: blocks run concurrently, so each block reduces its cells'
// dx/ws, multiplies by fac (folded on the host as at pallas_muscl.py:312-315)
// and does one atomicMin on the bit pattern of the non-negative float into a
// scalar the wrapper initialises to +inf.  A min does not depend on order,
// so the result is deterministic.  A NaN maps to the key -1 and wins, so
// dt_next is NaN when the state is, as jnp.min would give.

#include "muscl_common.cuh"

namespace {

constexpr int TZ = 32;  // threads along z (contiguous)
constexpr int TY = 4;   // threads along y

// n: the updated cells per axis; plane: nx * ny * nz, the output's variable
// stride.  pad 0: the input is the unpadded grid (in_* as the output's) and
// ghosts are mapped through bc; pad 2: the input carries pad ghost cells on
// every side ([5, nx+4, ny+4, nz+4]) and is read as given.
struct Geom {
  int n[3];
  int bc[3][2];
  int pad;
  int64_t plane;
  int64_t in_sy, in_sx, in_plane;  // input strides of y, x and a variable
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

// Input offset of cell (x, y, z) of the updated box, ghosts included, and
// the sign each velocity takes there.  The two entries differ only here, at
// run time: the signs stay values the compiler cannot fold, so both compile
// to one instruction stream and round alike (a shard's padded step is
// bitwise the unpadded step of the whole box).
__device__ __forceinline__ int64_t cell_offset(const Geom& g, int x, int y,
                                               int z, float s[3]) {
  s[0] = s[1] = s[2] = 1.0f;
  int mx, my, mz;
  if (g.pad) {
    mx = x + g.pad;
    my = y + g.pad;
    mz = z + g.pad;
  } else {
    mx = map_index(x, g.n[0], g.bc[0][0], g.bc[0][1], &s[0]);
    my = map_index(y, g.n[1], g.bc[1][0], g.bc[1][1], &s[1]);
    mz = map_index(z, g.n[2], g.bc[2][0], g.bc[2][1], &s[2]);
  }
  return (int64_t)mx * g.in_sx + (int64_t)my * g.in_sy + mz;
}

// Primitive state (r, vx, vy, vz, p) of a (possibly ghost) cell, and 1/r.
__device__ __forceinline__ void load_prim(const float* __restrict__ u,
                                          const Geom& g, const Consts& k,
                                          int x, int y, int z, float q[5],
                                          float* ir_out) {
  float s[3];
  int64_t o = cell_offset(g, x, y, z, s);
  cons_to_prim(__ldg(u + o), __ldg(u + g.in_plane + o),
               __ldg(u + 2 * g.in_plane + o), __ldg(u + 3 * g.in_plane + o),
               __ldg(u + 4 * g.in_plane + o), k, q, ir_out);
  q[1] *= s[0];
  q[2] *= s[1];
  q[3] *= s[2];
}

// make_cell's loader on the unpadded grid: ghosts mapped per axis.
struct GridLoad {
  const float* __restrict__ u;
  const Geom* g;
  const Consts* k;
  __device__ __forceinline__ void operator()(int x, int y, int z, float q[5],
                                             float* ir) const {
    load_prim(u, *g, *k, x, y, z, q, ir);
  }
};

__device__ __forceinline__ float load_ok(const float* __restrict__ ok,
                                         const Geom& g, int x, int y, int z) {
  float s[3];
  return __ldg(ok + cell_offset(g, x, y, z, s));
}

// ok == nullptr: no mask; crt_bits == nullptr: no Courant min; phi ==
// nullptr: no face mass fluxes.  All three are uniform over the launch, so
// their branches cost no divergence.
template <int RS>
__global__ void __launch_bounds__(TZ * TY)
fused_muscl_kernel(const float* __restrict__ u, const float* __restrict__ ok,
                   const float* __restrict__ dt_ptr, float* __restrict__ un,
                   int* __restrict__ crt_bits, float* __restrict__ phi,
                   Geom g, Consts k) {
  const int z = blockIdx.x * TZ + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const int x = blockIdx.z;
  const bool inside = z < g.n[2] && y < g.n[1];
  const bool masked = ok != nullptr;
  const bool courant = crt_bits != nullptr;
  const int64_t o = ((int64_t)x * g.n[1] + y) * g.n[2] + z;
  int key = 0x7fffffff;  // above every non-negative float's bits
  if (inside) {
    const float dt = __ldg(dt_ptr);
    const float dtdx2 = 0.5f * dt / k.dx;
    const float scale = dt / k.dx;
    const GridLoad load{u, &g, &k};
    Cell cc;
    make_cell(load, k, x, y, z, cc);
    float okc = 0.0f;
    if (masked) okc = load_ok(ok, g, x, y, z);
    float du[5];
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
      if (masked) {  // face kept iff neither adjacent cell is refined
        float keep_lo = (1.0f - okc) * (1.0f - load_ok(ok, g, x - e0, y - e1, z - e2));
        float keep_hi = (1.0f - load_ok(ok, g, x + e0, y + e1, z + e2)) * (1.0f - okc);
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          flo[v] = flo[v] * keep_lo;
          fhi[v] = fhi[v] * keep_hi;
        }
      }
      if (phi != nullptr) {  // the (low, high) face mass flux, x dt/dx
        phi[(2 * d) * g.plane + o] = flo[0] * scale;
        phi[(2 * d + 1) * g.plane + o] = fhi[0] * scale;
      }
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        float contrib = (flo[v] - fhi[v]) * scale;
        du[v] = (d == 0) ? contrib : du[v] + contrib;
      }
    }
    float w[5];
    float sc[3];
    const int64_t oi = cell_offset(g, x, y, z, sc);
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      w[v] = __ldg(u + v * g.in_plane + oi) + du[v];
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

namespace {

int launch(const float* u, const float* ok, const float* dt, float* un,
           float* crt, float* phi, Geom g, int riemann, float slope_factor,
           float gamma, float gm1, float entho, float smallr, float smallc2,
           float smallp, float smalle, float dx, float fac, void* stream) {
  const int nx = g.n[0], ny = g.n[1], nz = g.n[2];
  if (nx > 65535 || nx < 1 || ny < 1 || nz < 1)
    return (int)cudaErrorInvalidValue;
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
    fused_muscl_kernel<0><<<grid, block, 0, s>>>(u, ok, dt, un, crt_bits,
                                                   phi, g, k);
  else
    fused_muscl_kernel<1><<<grid, block, 0, s>>>(u, ok, dt, un, crt_bits,
                                                   phi, g, k);
  return (int)cudaGetLastError();
}

}  // namespace

// u, un: [5, nx, ny, nz] f32 contiguous; ok: [nx, ny, nz] f32 0/1 or NULL;
// dt: one f32 on the device; crt: one f32 on the device, holding +inf on
// entry, or NULL when the Courant min is not wanted; phi: [3, 2, nx, ny, nz]
// f32 for the face mass fluxes, or NULL.  bc: per axis (low, high) kind,
// 0 periodic, 1 reflecting, 2 outflow.  riemann: 0 llf, 1 hllc.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int ramses_fused_muscl(
    const float* u, const float* ok, const float* dt, float* un, float* crt,
    float* phi, int nx, int ny, int nz, int bx0, int bx1, int by0, int by1,
    int bz0, int bz1, int riemann, float slope_factor, float gamma, float gm1,
    float entho, float smallr, float smallc2, float smallp, float smalle,
    float dx, float fac, void* stream) {
  Geom g;
  g.n[0] = nx; g.n[1] = ny; g.n[2] = nz;
  g.bc[0][0] = bx0; g.bc[0][1] = bx1;
  g.bc[1][0] = by0; g.bc[1][1] = by1;
  g.bc[2][0] = bz0; g.bc[2][1] = bz1;
  g.pad = 0;
  g.in_sy = nz;
  g.in_sx = (int64_t)ny * nz;
  g.in_plane = (int64_t)nx * ny * nz;
  return launch(u, ok, dt, un, crt, phi, g, riemann, slope_factor, gamma,
                gm1, entho, smallr, smallc2, smallp, smalle, dx, fac, stream);
}

// The ghost-padded entry (pallas_muscl.py fused_step_padded's contract,
// with the same ghost depth on all three axes): u_pad [5, nx+4, ny+4, nz+4]
// f32 contiguous, read as given (a shard's ghosts come from its
// neighbours); ok_pad: [nx+4, ny+4, nz+4] f32 0/1 or NULL, read as given;
// un [5, nx, ny, nz], crt and phi as above.
extern "C" int ramses_fused_muscl_padded(
    const float* u_pad, const float* ok_pad, const float* dt, float* un,
    float* crt, float* phi, int nx, int ny, int nz, int riemann,
    float slope_factor, float gamma, float gm1, float entho, float smallr,
    float smallc2, float smallp, float smalle, float dx, float fac,
    void* stream) {
  Geom g;
  g.n[0] = nx; g.n[1] = ny; g.n[2] = nz;
  for (int d = 0; d < 3; ++d) g.bc[d][0] = g.bc[d][1] = 0;
  g.pad = 2;
  g.in_sy = (int64_t)nz + 4;
  g.in_sx = ((int64_t)ny + 4) * g.in_sy;
  g.in_plane = ((int64_t)nx + 4) * g.in_sx;
  return launch(u_pad, ok_pad, dt, un, crt, phi, g, riemann, slope_factor,
                gamma, gm1, entho, smallr, smallc2, smallp, smalle, dx, fac,
                stream);
}
