// Fused 3D unsplit MUSCL-Hancock step (K1), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel ramses_tpu/hydro/pallas_muscl.py::fused_step_padded
// (body _make_kernel, :208-330; helpers _slopes, _llf_flux, _hllc_flux):
// ctoprim -> TVD slopes -> trace3d predictor -> LLF/HLLC face fluxes ->
// conservative update, with an optional refined-cell mask, the Courant min
// of the updated state (the next step's dt) from the same launch and, on
// request, the dt/dx-scaled mass flux through each cell's low and high faces
// (the MC-tracer capture, want_flux; pallas_muscl.py:289-291).  It computes
// what the TPU kernel computes, in the same f32 arithmetic order; the body's
// device functions (ctoprim, slopes, predictor, face states, floors,
// LLF/HLLC) are those of muscl_common.cuh, shared with oct_muscl.cu.
//
// What bounds it on an H100 at 256^3 (5 f32 variables): it must read the
// state once and write the update once, 5 * (256^3 + 256^3) * 4 B = 0.67 GB,
// 0.2003 ms at 3.35 TB/s (with the mask 11 f32 a cell, with the face mass
// fluxes 6 more).  The arithmetic the algorithm needs, counted op by op on
// the plain version (chip_smoke.py phase 5), is about 0.79 k f32 operations
// a cell (one ctoprim, 15 slopes, the predictor, three face solves with each
// face shared by two cells, the update and the Courant term): 13.2 G ops,
// about 0.20 ms at 67 TFLOP/s.  The two bounds nearly coincide.
//
// The staged design: each primitive, slope, face state and face flux is
// computed once per cell, as the TPU kernel does over its VMEM block, not
// once per output cell that reads it.  A block of TZ x TY = 32 x 8 threads
// (z, the contiguous axis, along threadIdx.x) owns a column tile of the box
// and marches along x over a chunk of CX = 16 planes (the last chunk is
// ragged; a call of 1-2 planes runs one short chunk).  Staging: cp.async
// brings the conserved state (and the mask) of one plane of the tile with a
// 2-cell ring in y and z, 36 x 12 cells, into one of 2 raw shared-memory
// planes, two planes ahead of its use.  The unpadded entry maps ghost
// indices here (periodic wrap, reflect, outflow clamp); the padded entry
// reads its ghosts as given.  Then, at Cell plane c, three passes between
// three barriers:
//   1. ctoprim of plane c + 2 (once per staged cell, into a ring of 4
//      primitive planes; a reflected momentum takes its sign here, and
//      x * -1 is exact) and, in the same pass, one Cell (slopes in 3
//      directions, trace sources) per cell of plane c's tile and of its
//      1-cell ring in y and z (the corners are not needed): 432 + 80 + 256
//      items, three for each of the 256 threads, the third its own cell.
//      y and z face states go to shared memory, the tile's x face states
//      stay in the owning thread's registers.
//   2. one Riemann solve per y face and per z face of the tile, the flux
//      written over the face's left state, and one per x face in
//      registers: each thread keeps its column's high x face state and x
//      flux from the plane before.
//   3. the update of plane c - 1 (its high x face is now solved), the mask
//      product once per face, phi, and the Courant key.
// The block's Courant min is one warp reduction, one block reduction and one
// atomicMin on the float's bits (the wrapper initialises the scalar to +inf;
// a min is exact in any order; a NaN maps to -1 and wins, as jnp.min gives).
// Shared memory: 2 raw + 4 primitive planes of 6 floats a cell and the y/z
// face states, 84,288 B a block (dynamic; the attribute is set once per
// template instantiation and device).  At 122 registers a thread, 2 blocks
// of 256 threads are resident an SM (ptxas, chip_smoke.py phases 2, 5).
//
// The bitwise rule.  The padded entry's result is bitwise the unpadded
// entry's, and a shard's step bitwise that of the whole box, although a cell
// can be a ring cell in one cut and a tile cell in another, or a chunk's
// warm-up plane in one call and a steady plane in another.  So every stage
// is one loop body with one call site of its device function (loops are
// `#pragma unroll 1`), run alike for tile and ring cells, warm-up and
// steady planes; what differs between them is run-time data (which stores
// are kept, the reflect signs, the entry's offsets).  nvcc's FMA
// contraction, which parts K1 from its plain version, then rounds a cell
// the same way whichever block computes it.  Offsets are 64-bit: a 512^3
// state is 2.7 GB, past 2^31 bytes.

#include "muscl_common.cuh"

#ifndef RAMSES_HOST_STUBS
// 4-byte asynchronous copies into shared memory (LDGSTS), their groups and
// the wait for all but N of them.  A host build supplies plain copies.
__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif

namespace {

constexpr int TZ = 32;                 // tile columns along z (threadIdx.x)
constexpr int TY = 8;                  // tile rows along y (threadIdx.y)
constexpr int NT = TZ * TY;            // threads a block
constexpr int CX = 16;                 // x planes a block marches over
constexpr int PZ = TZ + 4;             // a staged plane: tile + 2-cell ring
constexpr int PY = TY + 4;
constexpr int PC = PZ * PY;            // cells of a staged plane
constexpr int NV = 6;                  // 5 variables and the mask a cell
constexpr int NRING = 2 * TZ + 2 * TY; // ring cells whose Cell a plane needs
constexpr int NFY = (TY + 1) * TZ;     // y faces of a tile plane
constexpr int NFZ = TY * (TZ + 1);     // z faces of a tile plane
static_assert(PC <= 2 * NT && PC + NRING == 2 * NT,
              "a thread stages two cells of a plane; its own Cell is its "
              "third item of the ctoprim/Cell pass");
// shared memory layout, in floats (each array variable-major)
constexpr int RAW_OFF = 0;                       // 2 staged planes
constexpr int PRIM_OFF = RAW_OFF + 2 * NV * PC;  // 4 primitive planes
constexpr int LY_OFF = PRIM_OFF + 4 * NV * PC;   // y face: left, then flux
constexpr int RY_OFF = LY_OFF + 5 * NFY;         // y face: right state
constexpr int LZ_OFF = RY_OFF + 5 * NFY;         // z face: left, then flux
constexpr int RZ_OFF = LZ_OFF + 5 * NFZ;         // z face: right state
constexpr int SMEM_FLOATS = RZ_OFF + 5 * NFZ;
constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float);

// n: the updated cells per axis; plane: nx * ny * nz, the output's variable
// stride.  pad 0: the input is the unpadded grid and ghosts are mapped
// through bc; pad 2: the input carries pad ghost cells on every side
// ([5, nx+4, ny+4, nz+4]) and is read as given.
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

// Input index along axis d of ghost-extended coordinate i, and the sign a
// velocity along d takes there.  Coordinates of a ragged tile past the
// ring (outside [-2, n + 1]) are clamped into it: they feed no output.
__device__ __forceinline__ int stage_index(const Geom& g, int d, int i,
                                           float* sgn) {
  i = min(max(i, -2), g.n[d] + 1);
  if (g.pad) return i + g.pad;
  return map_index(i, g.n[d], g.bc[d][0], g.bc[d][1], sgn);
}

// Start the copy of x plane gx of the tile and its ring into raw, as one
// cp.async group: thread tid copies staged cells tid and tid + NT, whose
// y/z input offsets it holds in yz0, yz1.
__device__ __forceinline__ void stage_plane(float* raw,
                                            const float* __restrict__ u,
                                            const float* __restrict__ ok,
                                            const Geom& g, int gx, int tid,
                                            int64_t yz0, int64_t yz1) {
  float sx = 1.0f;
  const int64_t ox = (int64_t)stage_index(g, 0, gx, &sx) * g.in_sx;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = tid + r * NT;
    if (i < PC) {
      const int64_t o = ox + (r ? yz1 : yz0);
#pragma unroll
      for (int v = 0; v < 5; ++v)
        cp_async_f32(raw + v * PC + i, u + v * g.in_plane + o);
      if (ok != nullptr) cp_async_f32(raw + 5 * PC + i, ok + o);
    }
  }
  cp_async_commit();
}

// make_cell's loader on the primitive planes (x - 1, x, x + 1) in shared
// memory, around staged cell s; 1/r is recomputed from r, bitwise ctoprim's.
struct PlaneLoad {
  const float* m;
  const float* c;
  const float* p;
  int s;
  __device__ __forceinline__ void operator()(int x, int y, int z, float q[5],
                                             float* ir) const {
    const float* b = x < 0 ? m : (x > 0 ? p : c);
    const int i = s + y * PZ + z;
#pragma unroll
    for (int v = 0; v < 5; ++v) q[v] = b[v * PC + i];
    *ir = 1.0f / q[0];
  }
};

__device__ __forceinline__ void load5(const float* a, int stride, int i,
                                      float q[5]) {
#pragma unroll
  for (int v = 0; v < 5; ++v) q[v] = a[v * stride + i];
}

__device__ __forceinline__ void store5(float* a, int stride, int i,
                                       const float q[5]) {
#pragma unroll
  for (int v = 0; v < 5; ++v) a[v * stride + i] = q[v];
}

// ok == nullptr: no mask; crt_bits == nullptr: no Courant min; phi ==
// nullptr: no face mass fluxes.  All three are uniform over the launch, so
// their branches cost no divergence.  No thread leaves before the last
// barrier.
template <int RS>
__global__ void __launch_bounds__(NT, 2)
fused_muscl_kernel(const float* __restrict__ u, const float* __restrict__ ok,
                   const float* __restrict__ dt_ptr, float* __restrict__ un,
                   int* __restrict__ crt_bits, float* __restrict__ phi,
                   Geom g, Consts k) {
  extern __shared__ __align__(16) float smem[];
  float* const raw = smem + RAW_OFF;
  float* const prim = smem + PRIM_OFF;
  float* const ly = smem + LY_OFF;
  float* const ry = smem + RY_OFF;
  float* const lz = smem + LZ_OFF;
  float* const rz = smem + RZ_OFF;
  const int tid = threadIdx.y * TZ + threadIdx.x;
  const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY;
  const int x0 = blockIdx.z * CX;
  const int x1 = min(x0 + CX, g.n[0]);
  const int y = y0 + threadIdx.y, z = z0 + threadIdx.x;
  const bool col_ok = y < g.n[1] && z < g.n[2];
  const bool masked = ok != nullptr;
  const int64_t nyz = (int64_t)g.n[1] * g.n[2];
  const float dt = __ldg(dt_ptr);
  const float dtdx2 = 0.5f * dt / k.dx;
  const float scale = dt / k.dx;

  // this thread's two staged cells: y/z input offsets and velocity signs
  int64_t yz0 = 0, yz1 = 0;
  float sy0 = 1.0f, sz0 = 1.0f, sy1 = 1.0f, sz1 = 1.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = min(tid + r * NT, PC - 1);
    float sy = 1.0f, sz = 1.0f;
    const int my = stage_index(g, 1, y0 - 2 + i / PZ, &sy);
    const int mz = stage_index(g, 2, z0 - 2 + i % PZ, &sz);
    const int64_t o = (int64_t)my * g.in_sy + mz;
    if (r) { yz1 = o; sy1 = sy; sz1 = sz; } else { yz0 = o; sy0 = sy; sz0 = sz; }
  }
  const int own = (threadIdx.y + 2) * PZ + threadIdx.x + 2;  // staged index

  // carried along x: the column's high x face state of the plane before,
  // the masked flux through its low x face, and its y and z flux terms
  float xhi_prev[5], fx_lo[5], cy_prev[5], cz_prev[5], xlo[5], xhi[5];
#pragma unroll
  for (int v = 0; v < 5; ++v)
    xhi_prev[v] = fx_lo[v] = cy_prev[v] = cz_prev[v] = xlo[v] = xhi[v] = 0.0f;
  int key = 0x7fffffff;  // above every non-negative float's bits

  // plane x0 - 2 + m goes to raw slot m & 1 and primitive slot m & 3
  stage_plane(raw, u, ok, g, x0 - 2, tid, yz0, yz1);
  stage_plane(raw + NV * PC, u, ok, g, x0 - 1, tid, yz0, yz1);
#pragma unroll 1
  for (int c = x0 - 4, m = 0; c <= x1; ++c, ++m) {
    // plane c + 2's copy is complete, and the last plane's reads are done
    cp_async_wait<1>();
    __syncthreads();
    const float* rw = raw + (m & 1) * NV * PC;
    float* pn = prim + (m & 3) * NV * PC;                // plane c + 2
    const float* pp = prim + ((m + 3) & 3) * NV * PC;    // plane c + 1
    const float* pc = prim + ((m + 2) & 3) * NV * PC;    // plane c
    const float* pm = prim + ((m + 1) & 3) * NV * PC;    // plane c - 1

    // ---- ctoprim of plane c + 2 and the Cells of plane c, one pass ----
    // Items [0, PC) are the staged cells (thread t: t and t + NT, the two
    // it holds offsets for), then NRING ring cells, then the tile's cells:
    // thread t's third item is its own cell.  A chunk's edge planes need
    // only the tile's x face states.
    const bool prim_on = c + 2 <= x1 + 1;
    const bool cell_on = c >= x0 - 1;
    const bool edge = c == x0 - 1 || c == x1;
    float sx = 1.0f;
    stage_index(g, 0, c + 2, &sx);
#pragma unroll 1
    for (int r = 0, it = tid; r < 3; ++r, it += NT) {
      if (it < PC) {
        if (prim_on) {
          float q[5], ir;
          cons_to_prim(rw[it], rw[PC + it] * sx,
                       rw[2 * PC + it] * (r ? sy1 : sy0),
                       rw[3 * PC + it] * (r ? sz1 : sz0), rw[4 * PC + it], k,
                       q, &ir);
          store5(pn, PC, it, q);
          if (masked) pn[5 * PC + it] = rw[5 * PC + it];
        }
        continue;
      }
      const int j = it - PC;
      if (!cell_on || (edge && j < NRING)) continue;
      int cy, cz;
      if (j >= NRING) {
        cy = (j - NRING) / TZ; cz = (j - NRING) % TZ;
      } else if (j < 2 * TZ) {
        cy = j < TZ ? -1 : TY; cz = j % TZ;
      } else {
        cz = j < 2 * TZ + TY ? -1 : TZ; cy = (j - 2 * TZ) % TY;
      }
      const PlaneLoad load{pm, pc, pp, (cy + 2) * PZ + cz + 2};
      Cell cell;
      make_cell(load, k, 0, 0, 0, cell);
      float f[5];
      const bool in_z = cz >= 0 && cz < TZ, in_y = cy >= 0 && cy < TY;
      face_state(cell, k, 1, 0.5f, dtdx2, f);   // left of y face cy + 1
      if (in_z && cy < TY) store5(ly, NFY, (cy + 1) * TZ + cz, f);
      face_state(cell, k, 1, -0.5f, dtdx2, f);  // right of y face cy
      if (in_z && cy >= 0) store5(ry, NFY, cy * TZ + cz, f);
      face_state(cell, k, 2, 0.5f, dtdx2, f);   // left of z face cz + 1
      if (in_y && cz < TZ) store5(lz, NFZ, cy * (TZ + 1) + cz + 1, f);
      face_state(cell, k, 2, -0.5f, dtdx2, f);  // right of z face cz
      if (in_y && cz >= 0) store5(rz, NFZ, cy * (TZ + 1) + cz, f);
      float lo[5], hi[5];
      face_state(cell, k, 0, -0.5f, dtdx2, lo);
      face_state(cell, k, 0, 0.5f, dtdx2, hi);
      if (j >= NRING) {
#pragma unroll
        for (int v = 0; v < 5; ++v) { xlo[v] = lo[v]; xhi[v] = hi[v]; }
      }
    }
    __syncthreads();
    // ---- the raw slot is free: start plane c + 4 ----
    if (c + 4 <= x1 + 1)
      stage_plane(raw + (m & 1) * NV * PC, u, ok, g, c + 4, tid, yz0, yz1);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform

    // ---- one solve per y, z and x face of plane c ----
    float fx[5];
    if (c >= x0) {
      if (c < x1) {
        // y faces, then z faces (NFY is a whole number of warps)
#pragma unroll 1
        for (int it = tid; it < NFY + NFZ; it += NT) {
          float ql[5], qr[5], f[5];
          if (it < NFY) {
            const int s = (it / TZ + 2) * PZ + it % TZ + 2;  // the right cell
            load5(ly, NFY, it, ql);
            load5(ry, NFY, it, qr);
            solve<RS>(ql, qr, 1, k, f);
            if (masked) {  // face kept iff neither adjacent cell is refined
              const float keep = (1.0f - pc[5 * PC + s]) *
                                 (1.0f - pc[5 * PC + s - PZ]);
#pragma unroll
              for (int v = 0; v < 5; ++v) f[v] = f[v] * keep;
            }
            store5(ly, NFY, it, f);
          } else {
            const int e = it - NFY;
            const int s = (e / (TZ + 1) + 2) * PZ + e % (TZ + 1) + 2;
            load5(lz, NFZ, e, ql);
            load5(rz, NFZ, e, qr);
            solve<RS>(ql, qr, 2, k, f);
            if (masked) {
              const float keep = (1.0f - pc[5 * PC + s]) *
                                 (1.0f - pc[5 * PC + s - 1]);
#pragma unroll
              for (int v = 0; v < 5; ++v) f[v] = f[v] * keep;
            }
            store5(lz, NFZ, e, f);
          }
        }
      }
      solve<RS>(xhi_prev, xlo, 0, k, fx);
      if (masked) {
        const float keep = (1.0f - pc[5 * PC + own]) * (1.0f - pm[5 * PC + own]);
#pragma unroll
        for (int v = 0; v < 5; ++v) fx[v] = fx[v] * keep;
      }
    }
    __syncthreads();

    // ---- the update of plane c - 1, plane c's y/z terms ----
    if (c >= x0) {
      const int64_t o = ((int64_t)c * g.n[1] + y) * g.n[2] + z;  // plane c
      if (col_ok && phi != nullptr) {  // the (low, high) face mass flux x dt/dx
        if (c < x1) phi[o] = fx[0] * scale;
        if (c > x0) phi[g.plane + o - nyz] = fx[0] * scale;
      }
      if (col_ok && c > x0) {
        const int64_t oi = (int64_t)(c - 1 + g.pad) * g.in_sx +
                           (int64_t)(y + g.pad) * g.in_sy + (z + g.pad);
        float w[5];
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          float du = (fx_lo[v] - fx[v]) * scale;
          du = du + cy_prev[v];
          du = du + cz_prev[v];
          w[v] = __ldg(u + v * g.in_plane + oi) + du;
          un[v * g.plane + o - nyz] = w[v];
        }
        if (crt_bits != nullptr) {  // cmpdt of the updated state
          float r2 = fmaxf(w[0], k.smallr);
          float ir2 = 1.0f / r2;
          float v0 = w[1] * ir2, v1 = w[2] * ir2, v2 = w[3] * ir2;
          float ek2 = 0.5f * r2 * (v0 * v0 + v1 * v1 + v2 * v2);
          float p2 = fmaxf(k.gm1 * (w[4] - ek2), r2 * k.smallp);
          float c2 = sqrtf(k.gamma * p2 * ir2);
          float ws = 3.0f * c2 + fabsf(v0) + fabsf(v1) + fabsf(v2);
          float val = k.dx / ws;
          key = min(key, (val != val) ? -1 : __float_as_int(val));
        }
      }
      if (c < x1) {
        const int ty = threadIdx.y, tz = threadIdx.x;
        float lo[5], hi[5];
        load5(ly, NFY, ty * TZ + tz, lo);
        load5(ly, NFY, (ty + 1) * TZ + tz, hi);
#pragma unroll
        for (int v = 0; v < 5; ++v) cy_prev[v] = (lo[v] - hi[v]) * scale;
        if (col_ok && phi != nullptr) {
          phi[2 * g.plane + o] = lo[0] * scale;
          phi[3 * g.plane + o] = hi[0] * scale;
        }
        load5(lz, NFZ, ty * (TZ + 1) + tz, lo);
        load5(lz, NFZ, ty * (TZ + 1) + tz + 1, hi);
#pragma unroll
        for (int v = 0; v < 5; ++v) cz_prev[v] = (lo[v] - hi[v]) * scale;
        if (col_ok && phi != nullptr) {
          phi[4 * g.plane + o] = lo[0] * scale;
          phi[5 * g.plane + o] = hi[0] * scale;
        }
      }
#pragma unroll
      for (int v = 0; v < 5; ++v) fx_lo[v] = fx[v];
    }
#pragma unroll
    for (int v = 0; v < 5; ++v) xhi_prev[v] = xhi[v];
  }

  if (crt_bits != nullptr) {
    __shared__ int warp_min[NT / 32];
    key = __reduce_min_sync(0xffffffffu, key);
    if ((tid & 31) == 0) warp_min[tid >> 5] = key;
    __syncthreads();
    if (tid == 0) {
      int mn = warp_min[0];
#pragma unroll
      for (int i = 1; i < NT / 32; ++i) mn = min(mn, warp_min[i]);
      if (mn != 0x7fffffff) {
        float local = __int_as_float(mn) * k.fac;
        atomicMin(crt_bits, (local != local) ? -1 : __float_as_int(local));
      }
    }
  }
}

// cudaFuncSetAttribute once per instantiation and device: the dynamic
// shared memory above 48 KB.  Returns its error.
template <int RS>
int prepare() {
  static unsigned long long done = 0;  // one bit a device
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return 0;
  err = (int)cudaFuncSetAttribute(fused_muscl_kernel<RS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM_BYTES);
  if (!err) done |= bit;
  return err;
}

int launch(const float* u, const float* ok, const float* dt, float* un,
           float* crt, float* phi, Geom g, int riemann, float slope_factor,
           float gamma, float gm1, float entho, float smallr, float smallc2,
           float smallp, float smalle, float dx, float fac, void* stream) {
  const int nx = g.n[0], ny = g.n[1], nz = g.n[2];
  if (nx > 65535 || nx < 1 || ny < 1 || nz < 1 || (ny + TY - 1) / TY > 65535)
    return (int)cudaErrorInvalidValue;
  g.plane = (int64_t)nx * ny * nz;
  Consts k;
  k.gamma = gamma; k.gm1 = gm1; k.entho = entho; k.smallr = smallr;
  k.smallc2 = smallc2; k.smallp = smallp; k.smalle = smalle;
  k.slope = slope_factor; k.dx = dx; k.fac = fac;
  cudaStream_t s = (cudaStream_t)stream;
  int* crt_bits = reinterpret_cast<int*>(crt);
  dim3 block(TZ, TY, 1);
  dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + CX - 1) / CX);
  const int err = riemann == 0 ? prepare<0>() : prepare<1>();
  if (err) return err;
  if (riemann == 0)
    fused_muscl_kernel<0><<<grid, block, SMEM_BYTES, s>>>(u, ok, dt, un,
                                                          crt_bits, phi, g, k);
  else
    fused_muscl_kernel<1><<<grid, block, SMEM_BYTES, s>>>(u, ok, dt, un,
                                                          crt_bits, phi, g, k);
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

// The launch's resources on the current device, for riemann 0 (llf) or 1
// (hllc): out[0] resident blocks an SM, out[1] dynamic shared memory a
// block (bytes), out[2] registers a thread, out[3] local memory a thread
// (bytes; spills).  Returns the first CUDA error.
extern "C" int ramses_fused_muscl_info(int riemann, int* out) {
  int err = riemann == 0 ? prepare<0>() : prepare<1>();
  if (err) return err;
  cudaFuncAttributes a;
  err = riemann == 0
            ? (int)cudaFuncGetAttributes(&a, fused_muscl_kernel<0>)
            : (int)cudaFuncGetAttributes(&a, fused_muscl_kernel<1>);
  if (err) return err;
  int nblk = 0;
  err = riemann == 0
            ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &nblk, fused_muscl_kernel<0>, NT, SMEM_BYTES)
            : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &nblk, fused_muscl_kernel<1>, NT, SMEM_BYTES);
  out[0] = nblk;
  out[1] = SMEM_BYTES;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  return err;
}
