// MUSCL-Hancock sweeps of the partial AMR levels, hand-written for Hopper
// (sm_90a): K3 on blocked Morton tiles and K2 on per-oct 6^3 stencils.
//
// Replaces the TPU kernels ramses_tpu/hydro/pallas_oct.py::tile_sweep (body
// _make_tile_kernel) and ::oct_sweep (body _make_kernel).  Both run K1's
// MUSCL body (muscl_common.cuh) on a gathered batch of blocks:
//   K3: ut [5, N, td, td, td], ok [N, td, td, td], td = c + 4,
//       c = 2^(shift+1) -> du [5, N, c, c, c] and corrp [5, 3, N, c/2+1, c,
//       c]: the dt/dx-scaled face fluxes at positions 2 + 2k along each
//       direction (the octs' faces), transverse interior, other axes in
//       increasing order;
//   K2: uloc [5, 6, 6, 6, N], ok [6, 6, 6, N] -> du [5, 2, 2, 2, N] and
//       corr [5, 3, 2, N]: the low (index 2) and high (index 4) face fluxes
//       times dt/dx, summed over the 2x2 transverse interior in the order
//       ((f00 + f01) + f10) + f11.
// With want_flux (phi != NULL) each also writes the dt/dx-scaled mass
// fluxes of the MC-tracer capture: K3 all c+1 cell-face planes along each
// direction, phip [3, N, c+1, c, c] (pallas_oct.py:345-350); K2 each
// interior cell's (low, high) faces, phi [3, 2, 2, 2, 2, N] (d, side, cell;
// pallas_oct.py:164-170).
// A face next to a refined cell carries no flux: keep = (1-ok_i)(1-ok_{i-1}).
// Only what the outputs consume is computed; the TPU kernels' roll
// wrap-around junk in the halo is not reproduced.
//
// K3's layout is the JAX package's with the batch axis moved from last to
// just before the cell axes, so that one tile's variable is a contiguous
// td^3 run (6.9 KB at shift 2) that a block reads with 16-byte loads; the
// port's gather (amr/kernels.py) writes it directly.  K2 keeps the batch
// axis minor: a block's consecutive octs at one cell are consecutive floats.
//
// The roofline on an H100 is bytes: per tile at shift 2 (td 12, c 8) the
// sweep must read the cells its outputs read (1,376 cells' state and 896
// cells' mask of td^3 = 1,728: 31.1 KB) and write 5 c^3 + 15 (c/2+1) c^2
// floats (29.4 KB), 18 ns of device memory time per tile at 3.35 TB/s (the
// mass-flux planes add 3 (c+1) c^2 floats, 2.6 KB);
// K2's inputs are 1,296 floats an oct, of which its outputs read 432 (80
// cells' state, 32 cells' mask, OCT_CELLS), and it writes 70 (48 more with
// the mass fluxes), 0.6 ns an oct; against ~6 ns for the ~0.8 k f32
// operations per interior cell at 67 TFLOP/s.  At the main path's ~64 tiles or ~2 k octs
// that is a microsecond or a few of work, so what sets the time is how much
// independent work is in flight and how long each chain is.
//
// Both run the same four stages through shared memory, separated by
// barriers, on the same stage bodies below:
//   1. the conserved state and mask of every staged cell (K2: every cell
//      an output reads), loaded once, and its primitives written to shared
//      memory;
//   2. the slopes and trace sources of every cell a face reads, once each;
//   3. every face, one direction at a time: its two face states from shared
//      memory, one Riemann solve, the keep mask; the flux is parked in
//      shared memory and the face outputs written;
//   4. each interior cell's du from its six parked fluxes, in K1's order
//      (K2 also its 30 per-oct sums from the parked fluxes).
// A block's staged arrays hold nb <= sb batch entries side by side (entry o
// of element e at [e * sb + o]):
//   K3: one block takes one x-chunk of one tile (chunk cx of its c interior
//       planes, with 2-plane halos), sb = 1; a tile's cuts recompute only
//       the halo planes and the x-faces between chunks.  The launch picks cx
//       from the occupancy query and the SM count (ramses_tile_sweep's chunk
//       0, tile_chunk), so that a small batch still puts blocks on every SM.
//   K2: one block takes sb consecutive octs (c = cx = 2, the whole 6^3
//       stencil), each thread an (element, oct) pair with the oct minor, so
//       at 8 octs a warp's loads and stores cover whole 32-byte sectors; the
//       three directions' faces start on different threads, so they share
//       one pass.  The launch picks sb the same way (ramses_oct_sweep's
//       chunk 0, oct_chunk).  tools/k2_stages.py times the stages.
// Same bits whatever the chunk or sb, and K2 bitwise K3 at shift 0 on the
// same octs: every stage is one `#pragma unroll 1` loop (one per direction
// in stage 3) whose body is the only code that computes its value, so a
// value is computed by the same instructions on the same inputs; K3's cell
// lane within a 16-byte load does not depend on the chunk (td^2 is a
// multiple of 4), and K2 stages its loads raw and converts them in one
// loop.  K2's per-oct sums add the rounded products flux * dt/dx
// (__fmul_rn: no contraction), which are K3's corrp values.

#include "muscl_common.cuh"

namespace {

constexpr int TILE_THREADS = 256;
constexpr int CELL_F = 20;  // a slope cell's staged floats: dq[3][5], sr0,
                            // sp0, sv0[3]
constexpr int SMEM_LIMIT = 232448;  // an H100 block's dynamic shared memory

// Floats of shared memory one staged block uses at tile side c and chunk
// cx, a batch entry: primitives and mask of the (cx+4) td^2 staged cells,
// the slope box, and the parked fluxes of the three directions.
__host__ __device__ constexpr int tile_nq(int c, int cx) {
  return (cx + 4) * (c + 4) * (c + 4);
}
__host__ __device__ constexpr int tile_ncell(int c, int cx) {
  return (cx + 2) * (c + 2) * (c + 2);
}
__host__ __device__ constexpr int tile_nface(int c, int cx, int d) {
  return d == 0 ? (cx + 1) * c * c : cx * (c + 1) * c;
}
__host__ __device__ constexpr int tile_smem_floats(int c, int cx) {
  return 6 * tile_nq(c, cx) + CELL_F * tile_ncell(c, cx)
         + 5 * (tile_nface(c, cx, 0) + 2 * tile_nface(c, cx, 1));
}

// K2: an oct is a shift-0 tile taken whole (c = cx = 2); the most octs a
// block's shared memory holds.
constexpr int OCT_FLOATS = tile_smem_floats(2, 2);
constexpr int OCT_MAX = SMEM_LIMIT / (4 * OCT_FLOATS);

// The cells of an oct's 6^3 stencil that its outputs read.  With a the
// distance of a coordinate from the centre planes {2, 3} (0, 1 or 2): the
// cells with a_x + a_y + a_z <= 2, first the 32 with a sum of at most 1
// (the cells beside a face, whose slopes and mask the faces read), then
// the 48 that only those slopes read.  No output reads the other 136, so
// K2 loads 80 cells' state and 32 cells' mask an oct.
constexpr int OCT_NLOAD = 80, OCT_NMASK = 32;
constexpr int OCT_UNROLL = 4;  // stage 1: a thread's cells loaded together
struct OctCells {
  unsigned char at[OCT_NLOAD];  // staged index (x * 6 + y) * 6 + z
};
__host__ __device__ constexpr int band(int x) {
  return x < 2 ? 2 - x : (x > 3 ? x - 3 : 0);
}
__host__ __device__ constexpr OctCells oct_cells() {
  OctCells c{};
  int m = 0;
  for (int pass = 0; pass < 2; ++pass)
    for (int i = 0; i < 216; ++i) {
      const int a = band(i / 36) + band(i / 6 % 6) + band(i % 6);
      if (pass == 0 ? a <= 1 : a == 2) c.at[m++] = (unsigned char)i;
    }
  return c;
}
__constant__ OctCells OCT_CELLS = oct_cells();

// x / d for 0 <= x < 2^31 / d by one multiply-high (m = ceil(2^31 / d)):
// a block's items decoded into (element, entry) without an integer
// division each.
struct DivBy {
  unsigned m;
  __device__ __forceinline__ explicit DivBy(int d)
      : m((0x80000000u + d - 1) / d) {}
  __device__ __forceinline__ int operator()(int x) const {
    return (int)__umulhi((unsigned)x << 1, m);
  }
};
// K3's batch of one entry a block
struct DivByOne {
  __device__ __forceinline__ int operator()(int x) const { return x; }
};

__device__ __forceinline__ float lane4(const float4& a, int j) {
  return j == 0 ? a.x : (j == 1 ? a.y : (j == 2 ? a.z : a.w));
}

// make_cell's loader on the staged primitives of batch entry o (1/r from
// r: cons_to_prim's own division, so the same bits).
struct SmemLoad {
  const float* q;
  int nq, td, sb, o;
  __device__ __forceinline__ void operator()(int x, int y, int z, float qv[5],
                                             float* ir) const {
    const int i = (x * td + y) * td + z;
#pragma unroll
    for (int v = 0; v < 5; ++v) qv[v] = q[(v * nq + i) * sb + o];
    *ir = 1.0f / qv[0];
  }
};

// Stage 2's body: slopes and trace sources of the slope-box cell (xs, ys,
// zs) (staged coordinates less 1) of batch entry o, stored at box slot i.
template <int TD>
__device__ __forceinline__ void slope_cell(const float* q, float* cel, int nq,
                                           int ncell, int sb, int o, int xs,
                                           int ys, int zs, int i,
                                           const Consts& k) {
  const SmemLoad load{q, nq, TD, sb, o};
  Cell c;
  make_cell(load, k, xs + 1, ys + 1, zs + 1, c);
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int v = 0; v < 5; ++v)
      cel[((d * 5 + v) * ncell + i) * sb + o] = c.dq[d][v];
  cel[(15 * ncell + i) * sb + o] = c.sr0;
  cel[(16 * ncell + i) * sb + o] = c.sp0;
#pragma unroll
  for (int j = 0; j < 3; ++j) cel[((17 + j) * ncell + i) * sb + o] = c.sv0[j];
}

// Stage 3 for direction D: every face along D that the chunk's cells touch,
// for the nb batch entries, items `first`, `first` + TILE_THREADS, ...
// (entry minor).  Face index p in 0..C along D (the low face of interior
// cell p; C the high face of the last), transverse interior (t1, t2) in
// increasing axis order; for D = 0, p runs over x0..x0+cx, for D = 1, 2 t1
// is x in x0..x0+cx-1.  Each flux is parked in f and handed to the writer.
// div divides by nb.
template <int C, int RS, int D, class W, class Div>
__device__ __forceinline__ void tile_faces(
    const float* q, const float* okm, const float* cel, float* f, int nq,
    int ncell, int x0, int cx, int sb, int nb, const Div& div, int first,
    float dtdx2, float scale, const W& w, const Consts& k) {
  constexpr int TD = C + 4, S = C + 2;
  const int count = tile_nface(C, cx, D);
#pragma unroll 1
  for (int it = first; it < nb * count; it += TILE_THREADS) {
    const int i = div(it), o = it - i * nb;
    int p, t1, t2;
    if (D == 0) {
      p = x0 + i / (C * C);
      t1 = (i / C) % C;
      t2 = i % C;
    } else {
      t1 = x0 + i / ((C + 1) * C);
      p = (i / C) % (C + 1);
      t2 = i % C;
    }
    // the right cell in td coordinates; the left one is it - e_D
    const int X = (D == 0 ? p : t1) + 2;
    const int Y = (D == 1 ? p : (D == 0 ? t1 : t2)) + 2;
    const int Z = (D == 2 ? p : t2) + 2;
    float ql[5], qr[5], fl[5];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int xs = X - x0 - (D == 0 && side == 0);
      const int ys = Y - (D == 1 && side == 0);
      const int zs = Z - (D == 2 && side == 0);
      const int qi = (xs * TD + ys) * TD + zs;
      const int ci = ((xs - 1) * S + (ys - 1)) * S + (zs - 1);
      Cell c;
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        c.q[v] = q[(v * nq + qi) * sb + o];
        c.dq[D][v] = cel[((D * 5 + v) * ncell + ci) * sb + o];
      }
      c.sr0 = cel[(15 * ncell + ci) * sb + o];
      c.sp0 = cel[(16 * ncell + ci) * sb + o];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        c.sv0[j] = cel[((17 + j) * ncell + ci) * sb + o];
      // left cell: its high face; right cell: its low face
      face_state(c, k, D, side == 0 ? 0.5f : -0.5f, dtdx2,
                 side == 0 ? ql : qr);
    }
    solve<RS>(ql, qr, D, k, fl);
    const int qr_i = ((X - x0) * TD + Y) * TD + Z;
    const int ql_i = qr_i - (D == 0 ? TD * TD : (D == 1 ? TD : 1));
    const float keep =
        (1.0f - okm[qr_i * sb + o]) * (1.0f - okm[ql_i * sb + o]);
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      fl[v] = fl[v] * keep;
      f[(v * count + i) * sb + o] = fl[v];
    }
    w.template face<D>(o, p, t1, t2, fl, scale);
  }
}

// Stage 4's body: du of interior cell (xl, y, z) of the chunk (xl from the
// chunk's first plane) of batch entry o: (low - high) flux of each
// direction, in K1's order.
template <int C>
__device__ __forceinline__ void cell_du(const float* f0, const float* f1,
                                        const float* f2, int cx, int sb,
                                        int o, int xl, int y, int z,
                                        float scale, float dsum[5]) {
  const int lo[3] = {(xl * C + y) * C + z, (xl * (C + 1) + y) * C + z,
                     (xl * (C + 1) + z) * C + y};
  const int step[3] = {C * C, C, C};
  const float* fd[3] = {f0, f1, f2};
  const int nf[3] = {tile_nface(C, cx, 0), tile_nface(C, cx, 1),
                     tile_nface(C, cx, 1)};
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const int e = v * nf[d] + lo[d];
      const float contrib =
          (fd[d][e * sb + o] - fd[d][(e + step[d]) * sb + o]) * scale;
      dsum[v] = (d == 0) ? contrib : dsum[v] + contrib;
    }
}

// K3's face outputs: corrp at the octs' faces, phip at every face.
template <int C>
struct TileOut {
  float* corrp;
  float* phip;
  int n, b, x0, cx;
  template <int D>
  __device__ __forceinline__ void face(int, int p, int t1, int t2,
                                       const float fl[5], float scale) const {
    constexpr int NP = C / 2 + 1;
    if (D == 0 && p >= x0 + cx && p != C) return;  // the next chunk's face
    const int64_t pl = (int64_t)t1 * C + t2;
    if (phip != nullptr)
      phip[((int64_t)(D * n + b) * (C + 1) + p) * C * C + pl] = fl[0] * scale;
    if ((p & 1) == 0) {
#pragma unroll
      for (int v = 0; v < 5; ++v)
        corrp[((int64_t)((v * 3 + D) * n + b) * NP + p / 2) * C * C + pl] =
            fl[v] * scale;
    }
  }
};

// K2's face outputs: the mass flux into phi [3, 2, 2, 2, 2, n], as the low
// face (side 0) of the interior cell at p along D and the high face (side
// 1) of the one at p - 1.
struct OctOut {
  float* phi;
  int n, b0;
  template <int D>
  __device__ __forceinline__ void face(int o, int p, int t1, int t2,
                                       const float fl[5], float scale) const {
    if (phi == nullptr) return;
    const float m = fl[0] * scale;
    // the cell at coordinate 0 along D, and the cell stride along D
    const int base =
        D == 0 ? t1 * 2 + t2 : (D == 1 ? t1 * 4 + t2 : (t1 * 2 + t2) * 2);
    const int st = D == 0 ? 4 : (D == 1 ? 2 : 1);
    const int64_t b = (int64_t)b0 + o;
    if (p < 2) phi[(int64_t)(D * 16 + base + p * st) * n + b] = m;
    if (p > 0) phi[(int64_t)(D * 16 + 8 + base + (p - 1) * st) * n + b] = m;
  }
};

// K2's per-oct sum j = (v * 3 + d) * 2 + side (corr's flat [5, 3, 2] index)
// of batch entry o: the four parked fluxes of face p = 2 side along d, each
// times dt/dx and rounded (K3's corrp values), added in a fixed order.
__device__ __forceinline__ float oct_corr(const float* f0, const float* f1,
                                          const float* f2, int sb, int o,
                                          int j, float scale) {
  constexpr int NF = tile_nface(2, 2, 0);
  const int side = j & 1, d = (j >> 1) % 3, v = j / 6, p = 2 * side;
  const float* f = d == 0 ? f0 : (d == 1 ? f1 : f2);
  float a[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int t1 = t >> 1, t2 = t & 1;
    const int i = d == 0 ? (p * 2 + t1) * 2 + t2 : (t1 * 3 + p) * 2 + t2;
    a[t] = __fmul_rn(f[(v * NF + i) * sb + o], scale);
  }
  return ((a[0] + a[1]) + a[2]) + a[3];
}

// ---- K3 --------------------------------------------------------------------

template <int C, int RS>
__global__ void __launch_bounds__(TILE_THREADS)
tile_sweep_kernel(const float* __restrict__ u, const float* __restrict__ ok,
                  const float* __restrict__ dt_ptr, float* __restrict__ du,
                  float* __restrict__ corrp, float* __restrict__ phip, int n,
                  int cx, Consts k) {
  constexpr int TD = C + 4, TD2 = TD * TD, TD3 = TD2 * TD, S = C + 2;
  extern __shared__ __align__(16) float smem[];
  const int nchunk = C / cx;
  const int b = blockIdx.x / nchunk;
  const int x0 = (blockIdx.x - b * nchunk) * cx;  // the chunk's first plane
  const int nq = tile_nq(C, cx), ncell = tile_ncell(C, cx);
  float* q = smem;                   // [5][nq] primitives
  float* okm = q + 5 * nq;           // [nq] refined mask
  float* cel = okm + nq;             // [CELL_F][ncell] slopes, sources
  float* f0 = cel + CELL_F * ncell;  // [5][nface] parked fluxes a direction
  float* f1 = f0 + 5 * tile_nface(C, cx, 0);
  float* f2 = f1 + 5 * tile_nface(C, cx, 1);
  const float dt = __ldg(dt_ptr);
  const float dtdx2 = 0.5f * dt / k.dx;
  const float scale = dt / k.dx;

  // 1. primitives and mask of the staged planes x0 .. x0+cx+3
  {
    const int64_t base = (int64_t)b * TD3 + (int64_t)x0 * TD2;
    const int64_t vs = (int64_t)n * TD3;
#pragma unroll 1
    for (int i = threadIdx.x; i < nq / 4; i += TILE_THREADS) {
      float4 w[5];
#pragma unroll
      for (int v = 0; v < 5; ++v)
        w[v] = __ldg(reinterpret_cast<const float4*>(u + v * vs + base) + i);
      const float4 m = __ldg(reinterpret_cast<const float4*>(ok + base) + i);
      float pr[5][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float qq[5], ir;
        cons_to_prim(lane4(w[0], j), lane4(w[1], j), lane4(w[2], j),
                     lane4(w[3], j), lane4(w[4], j), k, qq, &ir);
#pragma unroll
        for (int v = 0; v < 5; ++v) pr[v][j] = qq[v];
      }
#pragma unroll
      for (int v = 0; v < 5; ++v)
        reinterpret_cast<float4*>(q + v * nq)[i] =
            float4{pr[v][0], pr[v][1], pr[v][2], pr[v][3]};
      reinterpret_cast<float4*>(okm)[i] = m;
    }
  }
  __syncthreads();

  // 2. slopes and trace sources of the box (cx+2) x (c+2)^2 around the
  // chunk's cells, less the cells on two or more of its faces (no face
  // reads them)
#pragma unroll 1
  for (int i = threadIdx.x; i < ncell; i += TILE_THREADS) {
    const int xs = i / (S * S), ys = (i / S) % S, zs = i % S;
    const int edge = (xs == 0 || xs == cx + 1) + (ys == 0 || ys == S - 1)
                     + (zs == 0 || zs == S - 1);
    if (edge >= 2) continue;
    slope_cell<TD>(q, cel, nq, ncell, 1, 0, xs, ys, zs, i, k);
  }
  __syncthreads();

  // 3. the faces, one direction at a time
  const TileOut<C> w{corrp, phip, n, b, x0, cx};
  tile_faces<C, RS, 0>(q, okm, cel, f0, nq, ncell, x0, cx, 1, 1, DivByOne{},
                       threadIdx.x, dtdx2, scale, w, k);
  tile_faces<C, RS, 1>(q, okm, cel, f1, nq, ncell, x0, cx, 1, 1, DivByOne{},
                       threadIdx.x, dtdx2, scale, w, k);
  tile_faces<C, RS, 2>(q, okm, cel, f2, nq, ncell, x0, cx, 1, 1, DivByOne{},
                       threadIdx.x, dtdx2, scale, w, k);
  __syncthreads();

  // 4. du of the chunk's cells
#pragma unroll 1
  for (int i = threadIdx.x; i < cx * C * C; i += TILE_THREADS) {
    const int xl = i / (C * C), y = (i / C) % C, z = i % C;
    float dsum[5];
    cell_du<C>(f0, f1, f2, cx, 1, 0, xl, y, z, scale, dsum);
    const int64_t cell = ((int64_t)(x0 + xl) * C + y) * C + z;
#pragma unroll
    for (int v = 0; v < 5; ++v)
      du[((int64_t)v * n + b) * C * C * C + cell] = dsum[v];
  }
}

// ---- K2 --------------------------------------------------------------------

template <int RS>
__global__ void __launch_bounds__(TILE_THREADS)
oct_sweep_kernel(const float* __restrict__ u, const float* __restrict__ ok,
                 const float* __restrict__ dt_ptr, float* __restrict__ du,
                 float* __restrict__ corr, float* __restrict__ phi, int n,
                 int sb, Consts k) {
  constexpr int C = 2, TD = C + 4, NQ = tile_nq(C, C);
  constexpr int NCELL = tile_ncell(C, C), NF = tile_nface(C, C, 0);
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * sb;
  const int nb = min(sb, n - b0);    // the block's octs
  const DivBy div(nb);
  float* q = smem;                   // [5][NQ][sb] primitives
  float* okm = q + 5 * NQ * sb;      // [NQ][sb] refined mask
  float* cel = okm + NQ * sb;        // [CELL_F][NCELL][sb] slopes, sources
  float* f0 = cel + CELL_F * NCELL * sb;  // [5][NF][sb] parked fluxes
  float* f1 = f0 + 5 * NF * sb;
  float* f2 = f1 + 5 * NF * sb;
  const float dt = __ldg(dt_ptr);
  const float dtdx2 = 0.5f * dt / k.dx;
  const float scale = dt / k.dx;
  const int t = threadIdx.x;

  // 1. the octs' cells that an output reads (OCT_CELLS): OCT_UNROLL items'
  // state and mask loaded a thread, staged raw, then their primitives
  // written in place by the same thread
  {
    const int total = nb * OCT_NLOAD;
    const int64_t vs = (int64_t)NQ * n;
#pragma unroll 1
    for (int j = t; j < total; j += OCT_UNROLL * TILE_THREADS) {
      float w[OCT_UNROLL][6];
#pragma unroll
      for (int s = 0; s < OCT_UNROLL; ++s) {
        const int it = j + s * TILE_THREADS;
        if (it < total) {
          const int c = div(it);
          const int64_t g =
              (int64_t)OCT_CELLS.at[c] * n + b0 + (it - c * nb);
#pragma unroll
          for (int v = 0; v < 5; ++v) w[s][v] = __ldg(u + v * vs + g);
          if (c < OCT_NMASK) w[s][5] = __ldg(ok + g);
        }
      }
#pragma unroll
      for (int s = 0; s < OCT_UNROLL; ++s) {
        const int it = j + s * TILE_THREADS;
        if (it < total) {
          const int c = div(it);
          const int e = OCT_CELLS.at[c] * sb + (it - c * nb);
#pragma unroll
          for (int v = 0; v < 5; ++v) q[v * NQ * sb + e] = w[s][v];
          if (c < OCT_NMASK) okm[e] = w[s][5];
        }
      }
#pragma unroll 1
      for (int s = 0; s < OCT_UNROLL; ++s) {
        const int it = j + s * TILE_THREADS;
        if (it >= total) break;
        const int c = div(it);
        const int e = OCT_CELLS.at[c] * sb + (it - c * nb);
        float qq[5], ir;
        cons_to_prim(q[e], q[NQ * sb + e], q[2 * NQ * sb + e],
                     q[3 * NQ * sb + e], q[4 * NQ * sb + e], k, qq, &ir);
#pragma unroll
        for (int v = 0; v < 5; ++v) q[v * NQ * sb + e] = qq[v];
      }
    }
  }
  __syncthreads();

  // 2. slopes of the 32 cells beside a face (the 4^3 box less its edges)
#pragma unroll 1
  for (int it = t; it < nb * OCT_NMASK; it += TILE_THREADS) {
    const int j = div(it), o = it - j * nb;
    const int i = OCT_CELLS.at[j];
    const int xs = i / 36 - 1, ys = i / 6 % 6 - 1, zs = i % 6 - 1;
    slope_cell<TD>(q, cel, NQ, NCELL, sb, o, xs, ys, zs,
                   (xs * 4 + ys) * 4 + zs, k);
  }
  __syncthreads();

  // 3. the faces: each direction's items start where the previous
  // direction's end, so the three share the block's threads
  const OctOut w{phi, n, b0};
  const int nd = nb * NF;
  tile_faces<C, RS, 0>(q, okm, cel, f0, NQ, NCELL, 0, C, sb, nb, div, t,
                       dtdx2, scale, w, k);
  tile_faces<C, RS, 1>(q, okm, cel, f1, NQ, NCELL, 0, C, sb, nb, div,
                       (t + TILE_THREADS - nd % TILE_THREADS) % TILE_THREADS,
                       dtdx2, scale, w, k);
  tile_faces<C, RS, 2>(q, okm, cel, f2, NQ, NCELL, 0, C, sb, nb, div,
                       (t + TILE_THREADS - (2 * nd) % TILE_THREADS)
                           % TILE_THREADS,
                       dtdx2, scale, w, k);
  __syncthreads();

  // 4. du of the octs' cells from the low threads, the per-oct sums from
  // the high ones
#pragma unroll 1
  for (int it = t; it < nb * 8; it += TILE_THREADS) {
    const int cell = div(it), o = it - cell * nb;
    float dsum[5];
    cell_du<C>(f0, f1, f2, C, sb, o, cell >> 2, (cell >> 1) & 1, cell & 1,
               scale, dsum);
#pragma unroll
    for (int v = 0; v < 5; ++v)
      du[(int64_t)(v * 8 + cell) * n + b0 + o] = dsum[v];
  }
#pragma unroll 1
  for (int it = TILE_THREADS - 1 - t; it < nb * 30; it += TILE_THREADS) {
    const int j = div(it), o = it - j * nb;
    corr[(int64_t)j * n + b0 + o] = oct_corr(f0, f1, f2, sb, o, j, scale);
  }
}

// ---- host side -------------------------------------------------------------

// cudaFuncSetAttribute once per kernel and device: `bytes` of dynamic
// shared memory.  Returns its error.
template <class F>
int prepare(F kernel, int bytes, unsigned long long* done) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const unsigned long long bit = 1ull << (dev & 63);  // one bit a device
  if (*done & bit) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err) *done |= bit;
  return err;
}

// The shared memory of K3's largest chunk that fits.
template <int C, int RS>
int tile_prepare() {
  static unsigned long long done = 0;
  int most = 0;
  for (int cx = 1; cx <= C; cx *= 2) {
    const int bytes = 4 * tile_smem_floats(C, cx);
    if (bytes <= SMEM_LIMIT && bytes > most) most = bytes;
  }
  return prepare(tile_sweep_kernel<C, RS>, most, &done);
}

template <int RS>
int oct_prepare() {
  static unsigned long long done = 0;
  return prepare(oct_sweep_kernel<RS>, 4 * OCT_FLOATS * OCT_MAX, &done);
}

int sm_count(int* nsm) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (*nsm < 1) *nsm = 1;
  return err;
}

int64_t passes(int64_t items) {
  return (items + TILE_THREADS - 1) / TILE_THREADS;
}

// The chunk of x planes a K3 block takes for n tiles.  A block's time is
// set by its depth: the passes of its 256 threads over each stage, each
// pass one long dependent chain, about the same at 1 and 2 planes a chunk
// and deeper beyond.  The launch's time is the waves of resident blocks
// (the occupancy query) times that depth; the chunk with the fewest
// wave-passes wins, the longer on a tie (level 9 of the main path, 64
// tiles at shift 2: 2 planes; level 8, 32 tiles: 2).
template <int C, int RS>
int tile_chunk(int n, int* chunk) {
  int nsm = 0;
  int err = sm_count(&nsm);
  if (err) return err;
  *chunk = 0;
  int64_t best = 0;
  for (int cx = C; cx >= 1; cx /= 2) {
    const int smem = 4 * tile_smem_floats(C, cx);
    if (smem > SMEM_LIMIT) continue;
    int bps = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &bps, tile_sweep_kernel<C, RS>, TILE_THREADS, smem);
    if (err) return err;
    if (bps < 1) bps = 1;
    const int64_t depth = passes(tile_nq(C, cx) / 4)
                          + passes(tile_ncell(C, cx))
                          + passes(tile_nface(C, cx, 0))
                          + 2 * passes(tile_nface(C, cx, 1))
                          + passes(cx * C * C);
    const int64_t resident = (int64_t)bps * nsm;
    const int64_t waves = ((int64_t)n * (C / cx) + resident - 1) / resident;
    if (*chunk == 0 || waves * depth < best) {
      best = waves * depth;
      *chunk = cx;
    }
  }
  return *chunk ? 0 : (int)cudaErrorInvalidValue;
}

// The octs a K2 block takes for n octs, by tile_chunk's rule: the depth of
// sb octs is the passes of stage 1 (OCT_UNROLL cells a thread), stage 2 (32
// cells an oct), stage 3 (36 faces an oct, the directions sharing the
// threads) and stage 4 (8 cells and 30 sums an oct); the most octs on a
// tie.  A stage-1 pass is a round trip to device memory and counts twice,
// times the 32-byte sectors a warp's loads touch for each one they use:
// 8 / gcd(sb, 8), as the batch axis is minor.  Fitted to an H100's times
// (every count at N 512, 1024 and 2048): 8 octs a block, the fastest or
// tied at all three.  The resident blocks an SM of each count are queried
// once a device and kept: the launches are on host-bound paths.
template <int RS>
int oct_chunk(int n, int* chunk) {
  static int resident_sm[64][OCT_MAX + 1];  // 0 until queried
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  int* bpsb = resident_sm[dev & 63];
  if (bpsb[1] == 0) {
    for (int sb = OCT_MAX; sb >= 1; --sb) {
      int bps = 0;
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &bps, oct_sweep_kernel<RS>, TILE_THREADS, 4 * OCT_FLOATS * sb);
      if (err) return err;
      bpsb[sb] = bps < 1 ? 1 : bps;
    }
  }
  int nsm = 0;
  err = sm_count(&nsm);
  if (err) return err;
  *chunk = 0;
  int64_t best = 0;
  for (int sb = OCT_MAX; sb >= 1; --sb) {
    const int bps = bpsb[sb];
    const int64_t sectors =
        sb % 8 == 0 ? 1 : (sb % 4 == 0 ? 2 : (sb % 2 == 0 ? 4 : 8));
    const int64_t depth =
        2 * sectors * passes((int64_t)sb * OCT_NLOAD / OCT_UNROLL)
        + passes(sb * OCT_NMASK) + passes(sb * 36) + passes(sb * 38);
    const int64_t resident = (int64_t)bps * nsm;
    const int64_t blocks = ((int64_t)n + sb - 1) / sb;
    const int64_t cost = (blocks + resident - 1) / resident * depth;
    if (*chunk == 0 || cost < best) {
      best = cost;
      *chunk = sb;
    }
  }
  return 0;
}

// info: out[0] the chunk, out[1] resident blocks an SM, out[2] dynamic
// shared memory a block, out[3] registers, out[4] local bytes, out[5]
// threads; out[6] is the caller's.
template <class F>
int launch_attrs(F kernel, int chunk, int smem, int* info) {
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, kernel);
  if (err) return err;
  int nblk = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nblk, kernel, TILE_THREADS, smem);
  info[0] = chunk;
  info[1] = nblk;
  info[2] = smem;
  info[3] = a.numRegs;
  info[4] = (int)a.localSizeBytes;
  info[5] = TILE_THREADS;
  return err;
}

template <int C, int RS>
int tile_launch(const float* u, const float* ok, const float* dt, float* du,
                float* corrp, float* phip, int n, int chunk, const Consts& k,
                cudaStream_t s, int* info) {
  int err = tile_prepare<C, RS>();
  if (err) return err;
  if (chunk == 0) err = tile_chunk<C, RS>(n, &chunk);
  if (err) return err;
  if (chunk < 1 || chunk > C || (C % chunk) != 0
      || 4 * tile_smem_floats(C, chunk) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int smem = 4 * tile_smem_floats(C, chunk);
  if (info != nullptr) {
    info[6] = 0;
    for (int cx = 1; cx <= C; cx *= 2)
      if (4 * tile_smem_floats(C, cx) <= SMEM_LIMIT) info[6] |= cx;
    return launch_attrs(tile_sweep_kernel<C, RS>, chunk, smem, info);
  }
  if ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(ok)) & 15)
    return (int)cudaErrorInvalidValue;  // 16-byte loads
  const int64_t nblocks = (int64_t)n * (C / chunk);
  if (nblocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)nblocks, 1, 1);
  dim3 block(TILE_THREADS, 1, 1);
  tile_sweep_kernel<C, RS><<<grid, block, smem, s>>>(u, ok, dt, du, corrp,
                                                     phip, n, chunk, k);
  return (int)cudaGetLastError();
}

template <int C>
int tile_by_solver(int riemann, const float* u, const float* ok,
                   const float* dt, float* du, float* corrp, float* phip,
                   int n, int chunk, const Consts& k, cudaStream_t s,
                   int* info) {
  return riemann == 0
             ? tile_launch<C, 0>(u, ok, dt, du, corrp, phip, n, chunk, k, s,
                                 info)
             : tile_launch<C, 1>(u, ok, dt, du, corrp, phip, n, chunk, k, s,
                                 info);
}

int tile_dispatch(int shift, int riemann, const float* u, const float* ok,
                  const float* dt, float* du, float* corrp, float* phip,
                  int n, int chunk, const Consts& k, cudaStream_t s,
                  int* info) {
  switch (shift) {
    case 0: return tile_by_solver<2>(riemann, u, ok, dt, du, corrp, phip, n,
                                     chunk, k, s, info);
    case 1: return tile_by_solver<4>(riemann, u, ok, dt, du, corrp, phip, n,
                                     chunk, k, s, info);
    case 2: return tile_by_solver<8>(riemann, u, ok, dt, du, corrp, phip, n,
                                     chunk, k, s, info);
    case 3: return tile_by_solver<16>(riemann, u, ok, dt, du, corrp, phip, n,
                                      chunk, k, s, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int RS>
int oct_launch(const float* u, const float* ok, const float* dt, float* du,
               float* corr, float* phi, int n, int chunk, const Consts& k,
               cudaStream_t s, int* info) {
  int err = oct_prepare<RS>();
  if (err) return err;
  if (chunk == 0) err = oct_chunk<RS>(n, &chunk);
  if (err) return err;
  if (chunk < 1 || chunk > OCT_MAX) return (int)cudaErrorInvalidValue;
  const int smem = 4 * OCT_FLOATS * chunk;
  if (info != nullptr) {
    info[6] = (1 << OCT_MAX) - 1;  // bit sb - 1: sb octs fit
    return launch_attrs(oct_sweep_kernel<RS>, chunk, smem, info);
  }
  dim3 grid((unsigned)((n + chunk - 1) / chunk), 1, 1);
  dim3 block(TILE_THREADS, 1, 1);
  oct_sweep_kernel<RS><<<grid, block, smem, s>>>(u, ok, dt, du, corr, phi, n,
                                                 chunk, k);
  return (int)cudaGetLastError();
}

int oct_dispatch(int riemann, const float* u, const float* ok,
                 const float* dt, float* du, float* corr, float* phi, int n,
                 int chunk, const Consts& k, cudaStream_t s, int* info) {
  return riemann == 0
             ? oct_launch<0>(u, ok, dt, du, corr, phi, n, chunk, k, s, info)
             : oct_launch<1>(u, ok, dt, du, corr, phi, n, chunk, k, s, info);
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

// The constants of an info call (the launch does not depend on them).
Consts info_consts() {
  return make_consts(1.0f, 1.4f, 0.4f, 2.5f, 1e-10f, 1e-20f, 1e-10f, 1e-10f,
                     1.0f);
}

}  // namespace

// All arrays f32, contiguous, on the device; ok is the 0/1 refined mask;
// dt one f32 on the device.  riemann: 0 llf, 1 hllc.  phi is the mass-flux
// output or NULL.  Each launches on `stream` without synchronising and
// returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.

// K3: ut [5, n, td, td, td], ok [n, td, td, td] (both 16-byte aligned) ->
// du [5, n, c, c, c], corrp [5, 3, n, c/2+1, c, c] (and phip [3, n, c+1, c,
// c]) with c = 2^(shift+1), td = c + 4, shift in 0..3.  chunk: the x planes
// of a tile a block updates (a power of 2 up to c), or 0 to choose them
// from n and the card; the result does not depend on it.
extern "C" int ramses_tile_sweep(
    const float* ut, const float* ok, const float* dt, float* du, float* corrp,
    float* phip, int shift, int n, int riemann, int chunk, float slope_factor,
    float gamma, float gm1, float entho, float smallr, float smallc2,
    float smallp, float smalle, float dx, void* stream) {
  if (n <= 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(slope_factor, gamma, gm1, entho, smallr,
                               smallc2, smallp, smalle, dx);
  return tile_dispatch(shift, riemann, ut, ok, dt, du, corrp, phip, n, chunk,
                       k, (cudaStream_t)stream, nullptr);
}

// K3's launch for (shift, n tiles, riemann, chunk) on the current device:
// out[0] the chunk (chosen when chunk is 0), out[1] resident blocks an SM,
// out[2] dynamic shared memory a block (bytes), out[3] registers a thread,
// out[4] local memory a thread (bytes; spills), out[5] threads a block,
// out[6] the chunks that fit a block's shared memory (the sum of their
// sizes, each a power of 2).  Launches nothing; returns the first CUDA
// error.
extern "C" int ramses_tile_sweep_info(int shift, int n, int riemann, int chunk,
                                      int* out) {
  if (n <= 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  return tile_dispatch(shift, riemann, nullptr, nullptr, nullptr, nullptr,
                       nullptr, nullptr, n, chunk, info_consts(), nullptr,
                       out);
}

// K2: uloc [5, 6, 6, 6, n] -> du [5, 2, 2, 2, n], corr [5, 3, 2, n] (and
// phi [3, 2, 2, 2, 2, n]).  chunk: the octs a block takes (1 up to what a
// block's shared memory holds), or 0 to choose them from n and the card;
// the result does not depend on it.
extern "C" int ramses_oct_sweep(
    const float* uloc, const float* ok, const float* dt, float* du,
    float* corr, float* phi, int n, int riemann, int chunk,
    float slope_factor, float gamma, float gm1, float entho, float smallr,
    float smallc2, float smallp, float smalle, float dx, void* stream) {
  if (n <= 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(slope_factor, gamma, gm1, entho, smallr,
                               smallc2, smallp, smalle, dx);
  return oct_dispatch(riemann, uloc, ok, dt, du, corr, phi, n, chunk, k,
                      (cudaStream_t)stream, nullptr);
}

// K2's launch for (n octs, riemann, chunk) on the current device: out[0]
// the octs a block takes (chosen when chunk is 0), out[1..5] as K3's,
// out[6] the octs a block can take (bit sb - 1 set when sb octs fit a
// block's shared memory).  Launches nothing; returns the first CUDA error.
extern "C" int ramses_oct_sweep_info(int n, int riemann, int chunk,
                                     int* out) {
  if (n <= 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  return oct_dispatch(riemann, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, n, chunk, info_consts(), nullptr, out);
}
