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
//       summed over the 2x2 transverse interior, times dt/dx.
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
// axis minor: its threads take consecutive octs at one cell.
//
// The roofline on an H100 is bytes: per tile at shift 2 (td 12, c 8) the
// sweep must read 6 td^3 floats (state and mask, 41.5 KB) and write
// 5 c^3 + 15 (c/2+1) c^2 floats (29.4 KB), 21 ns of device memory time per
// tile at 3.35 TB/s (the mass-flux planes add 3 (c+1) c^2 floats, 2.6 KB;
// K2's add 48 an oct), against ~6 ns for the ~0.8 k f32 operations per
// interior cell at 67 TFLOP/s.  At the main path's ~64 tiles that is a
// microsecond or two of work, so what sets the time is how much
// independent work is in flight and how long each chain is.
//
// K3: one block takes one x-chunk of one tile (chunk cx of its c interior
// planes, with 2-plane halos), in stages separated by barriers:
//   1. each thread loads 4 staged cells' state and mask with 16-byte loads
//      and writes their primitives to shared memory (every staged cell
//      once);
//   2. the slopes and trace sources of every cell a face reads (the
//      (cx+2) x (c+2)^2 box less its edges), once each;
//   3. every face the chunk's cells touch, one direction at a time: its
//      two face states from shared memory, one Riemann solve, the keep
//      mask; it writes corrp/phip and parks the flux in shared memory;
//   4. each interior cell's du from its six parked fluxes, in K1's order.
// A tile's cuts recompute only the halo planes and the x-faces between
// chunks.  The launch picks cx from the occupancy query and the SM count
// (ramses_tile_sweep's chunk 0, tile_chunk), so that a small batch still
// puts blocks on every SM.  Same bits whatever the chunk: every stage is one
// `#pragma unroll 1` loop (one per direction in stage 3) whose body is the
// only code that computes its value, and a cell's lane within a 16-byte
// load does not depend on the chunk (td^2 is a multiple of 4), so a value
// recomputed by two blocks is computed by the same instructions on the
// same inputs.
//
// K2: one thread per (interior cell, batch entry), neighbours' primitives
// and slopes recomputed in registers (about 7x the arithmetic), so
// instructions and latency set its time; the per-oct sums need the four
// cells of a face: each thread parks its face flux in shared memory and,
// after one barrier, the oct's eight threads add them in a fixed order, so
// the sums are the same from run to run.

#include "muscl_common.cuh"

namespace {

constexpr int MAX_TX = 32;  // batch entries per K2 block (threadIdx.x)

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

// K2: per-oct sums (blockDim.y == 8: all of an oct's cells in one block).
// phi == nullptr: no mass-flux output (uniform over the launch).
template <int RS>
__global__ void __launch_bounds__(256)
oct_sweep_kernel(const float* __restrict__ u, const float* __restrict__ ok,
                 const float* __restrict__ dt_ptr, float* __restrict__ du,
                 float* __restrict__ out, float* __restrict__ phi, int n,
                 Consts k) {
  constexpr int C = 2;
  constexpr int TD = C + 4;
  constexpr int NC = C * C * C;
  __shared__ float part[3 * 2 * 5 * 4 * MAX_TX];
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
        phi[((int64_t)(d * 2) * NC + cell) * n + b] = flo[0] * scale;
        phi[((int64_t)(d * 2 + 1) * NC + cell) * n + b] = fhi[0] * scale;
      }
      // side 0: face 2 (low face of interior cell 0); side 1: face 4
      // (high face of interior cell 1)
#pragma unroll
      for (int v = 0; v < 5; ++v)
        part[(((d * 2 + p) * 5 + v) * 4 + t1 * 2 + t2) * MAX_TX + threadIdx.x] =
            p ? fhi[v] : flo[v];
    }
#pragma unroll
    for (int v = 0; v < 5; ++v)
      du[((((int64_t)v * C + ic[0]) * C + ic[1]) * C + ic[2]) * n + b] = dsum[v];
  }
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

// ---- K3 --------------------------------------------------------------------

constexpr int TILE_THREADS = 256;
constexpr int CELL_F = 20;  // a slope cell's staged floats: dq[3][5], sr0,
                            // sp0, sv0[3]
constexpr int SMEM_LIMIT = 232448;  // an H100 block's dynamic shared memory

// Floats of shared memory one K3 block uses at tile side c and chunk cx:
// primitives and mask of the (cx+4) td^2 staged cells, the slope box, and
// the parked fluxes of the three directions.
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

__device__ __forceinline__ float lane4(const float4& a, int j) {
  return j == 0 ? a.x : (j == 1 ? a.y : (j == 2 ? a.z : a.w));
}

// make_cell's loader on the staged primitives (1/r from r: cons_to_prim's
// own division, so the same bits).
struct SmemLoad {
  const float* q;
  int nq, td;
  __device__ __forceinline__ void operator()(int x, int y, int z, float qv[5],
                                             float* ir) const {
    const int i = (x * td + y) * td + z;
#pragma unroll
    for (int v = 0; v < 5; ++v) qv[v] = q[v * nq + i];
    *ir = 1.0f / qv[0];
  }
};

// Stage 3 for direction D: every face along D that the chunk's cells touch.
// Face index p in 0..C along D (the low face of interior cell p; C the high
// face of the last), transverse interior (t1, t2) in increasing axis order;
// for D = 0, p runs over x0..x0+cx and the chunk owns the outputs of
// p < x0 + cx (and of p = C), for D = 1, 2 t1 is x in x0..x0+cx-1.
template <int C, int RS, int D>
__device__ __forceinline__ void tile_faces(
    const float* q, const float* okm, const float* cel, float* f, int nq,
    int ncell, int x0, int cx, int b, int n, float dtdx2, float scale,
    float* __restrict__ corrp, float* __restrict__ phip, const Consts& k) {
  constexpr int TD = C + 4, S = C + 2, NP = C / 2 + 1;
  const int count = tile_nface(C, cx, D);
#pragma unroll 1
  for (int i = threadIdx.x; i < count; i += TILE_THREADS) {
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
        c.q[v] = q[v * nq + qi];
        c.dq[D][v] = cel[(D * 5 + v) * ncell + ci];
      }
      c.sr0 = cel[15 * ncell + ci];
      c.sp0 = cel[16 * ncell + ci];
#pragma unroll
      for (int j = 0; j < 3; ++j) c.sv0[j] = cel[(17 + j) * ncell + ci];
      // left cell: its high face; right cell: its low face
      face_state(c, k, D, side == 0 ? 0.5f : -0.5f, dtdx2,
                 side == 0 ? ql : qr);
    }
    solve<RS>(ql, qr, D, k, fl);
    const int qr_i = ((X - x0) * TD + Y) * TD + Z;
    const int ql_i = qr_i - (D == 0 ? TD * TD : (D == 1 ? TD : 1));
    const float keep = (1.0f - okm[qr_i]) * (1.0f - okm[ql_i]);
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      fl[v] = fl[v] * keep;
      f[v * count + i] = fl[v];
    }
    if (D == 0 && p >= x0 + cx && p != C) continue;  // the next chunk's face
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
}

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
  {
    const SmemLoad load{q, nq, TD};
#pragma unroll 1
    for (int i = threadIdx.x; i < ncell; i += TILE_THREADS) {
      const int xs = i / (S * S), ys = (i / S) % S, zs = i % S;
      const int edge = (xs == 0 || xs == cx + 1) + (ys == 0 || ys == S - 1)
                       + (zs == 0 || zs == S - 1);
      if (edge >= 2) continue;
      Cell c;
      make_cell(load, k, xs + 1, ys + 1, zs + 1, c);
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int v = 0; v < 5; ++v) cel[(d * 5 + v) * ncell + i] = c.dq[d][v];
      cel[15 * ncell + i] = c.sr0;
      cel[16 * ncell + i] = c.sp0;
#pragma unroll
      for (int j = 0; j < 3; ++j) cel[(17 + j) * ncell + i] = c.sv0[j];
    }
  }
  __syncthreads();

  // 3. the faces, one direction at a time
  tile_faces<C, RS, 0>(q, okm, cel, f0, nq, ncell, x0, cx, b, n, dtdx2, scale,
                       corrp, phip, k);
  tile_faces<C, RS, 1>(q, okm, cel, f1, nq, ncell, x0, cx, b, n, dtdx2, scale,
                       corrp, phip, k);
  tile_faces<C, RS, 2>(q, okm, cel, f2, nq, ncell, x0, cx, b, n, dtdx2, scale,
                       corrp, phip, k);
  __syncthreads();

  // 4. du of the chunk's cells: (low - high) flux of each direction, in
  // K1's order
  {
    const int nx = tile_nface(C, cx, 0), ny = tile_nface(C, cx, 1);
#pragma unroll 1
    for (int i = threadIdx.x; i < cx * C * C; i += TILE_THREADS) {
      const int xl = i / (C * C), y = (i / C) % C, z = i % C;
      const int lo[3] = {(xl * C + y) * C + z, (xl * (C + 1) + y) * C + z,
                         (xl * (C + 1) + z) * C + y};
      const int step[3] = {C * C, C, C};
      const float* fd[3] = {f0, f1, f2};
      const int nf[3] = {nx, ny, ny};
      float dsum[5];
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          const float* fv = fd[d] + v * nf[d] + lo[d];
          const float contrib = (fv[0] - fv[step[d]]) * scale;
          dsum[v] = (d == 0) ? contrib : dsum[v] + contrib;
        }
      const int64_t cell = ((int64_t)(x0 + xl) * C + y) * C + z;
#pragma unroll
      for (int v = 0; v < 5; ++v)
        du[((int64_t)v * n + b) * C * C * C + cell] = dsum[v];
    }
  }
}

// ---- host side -------------------------------------------------------------

// cudaFuncSetAttribute once per instantiation and device: the shared memory
// of the largest chunk that fits.  Returns its error.
template <int C, int RS>
int tile_prepare() {
  static unsigned long long done = 0;  // one bit a device
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return 0;
  int most = 0;
  for (int cx = 1; cx <= C; cx *= 2) {
    const int bytes = 4 * tile_smem_floats(C, cx);
    if (bytes <= SMEM_LIMIT && bytes > most) most = bytes;
  }
  err = (int)cudaFuncSetAttribute(tile_sweep_kernel<C, RS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  most);
  if (!err) done |= bit;
  return err;
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
  int dev = 0, nsm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  if (nsm < 1) nsm = 1;
  auto passes = [](int64_t items) {
    return (items + TILE_THREADS - 1) / TILE_THREADS;
  };
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
    cudaFuncAttributes a;
    err = (int)cudaFuncGetAttributes(&a, tile_sweep_kernel<C, RS>);
    if (err) return err;
    int nblk = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nblk, tile_sweep_kernel<C, RS>, TILE_THREADS, smem);
    info[0] = chunk;
    info[1] = nblk;
    info[2] = smem;
    info[3] = a.numRegs;
    info[4] = (int)a.localSizeBytes;
    info[5] = TILE_THREADS;
    info[6] = 0;
    for (int cx = 1; cx <= C; cx *= 2)
      if (4 * tile_smem_floats(C, cx) <= SMEM_LIMIT) info[6] |= cx;
    return err;
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

int oct_launch(const float* u, const float* ok, const float* dt, float* du,
               float* out, float* phi, int n, int riemann, const Consts& k,
               cudaStream_t s) {
  constexpr int C = 2;
  const int tx = n >= 32 ? 32 : (n >= 16 ? 16 : 8);
  const int ty = C * C * C;
  dim3 block(tx, ty, 1);
  dim3 grid((n + tx - 1) / tx, 1, 1);
  if (riemann == 0)
    oct_sweep_kernel<0><<<grid, block, 0, s>>>(u, ok, dt, du, out, phi, n, k);
  else
    oct_sweep_kernel<1><<<grid, block, 0, s>>>(u, ok, dt, du, out, phi, n, k);
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
  const Consts k = make_consts(1.0f, 1.4f, 0.4f, 2.5f, 1e-10f, 1e-20f,
                               1e-10f, 1e-10f, 1.0f);
  return tile_dispatch(shift, riemann, nullptr, nullptr, nullptr, nullptr,
                       nullptr, nullptr, n, chunk, k, nullptr, out);
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
  return oct_launch(uloc, ok, dt, du, corr, phi, n, riemann, k,
                    (cudaStream_t)stream);
}
