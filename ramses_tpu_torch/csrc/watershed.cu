// The clump finder's watershed labelling (K10), hand-written for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package compiles the labelling into XLA
// programs, ramses_tpu/pm/clumps.py::steepest_parent (26 rolls and selects
// over the 3^ndim neighbourhood), ::_pointer_jump (parent <- parent[parent]
// in a device-side lax.while_loop) and ::watershed (the threshold mask).
// In eager PyTorch the ascent is some 80 launches and the pointer jump needs
// a host sync an iteration to test its fixed point; here it is one call of
// two launches:
//
//   parents  one block a tile of the grid (16 x 16 x 4 cells in 3D,
//            32 x 32 in 2D, 1,024 in 1D, the last axis fastest), loaded once
//            with its one-cell periodic ring into shared memory; each cell
//            above the threshold takes its steepest-ascent parent, the
//            neighbour with the largest (rho, flat index) over the periodic
//            3^ndim neighbourhood, itself included (a neighbour at offset o
//            is the cell (i + o) mod n on each axis, as jnp.roll wraps);
//            then it follows its links while they stay in the tile, and
//            stores, as 32-bit scratch, the root it reached or the first
//            cell outside the tile;
//   labels   four cells a thread: a cell whose chain left its tile follows
//            the scratch pointers, each hop a tile or more, to a root (the
//            four chases in lockstep); every label is written here,
//            coalesced.
//
// The parent relation is a forest under the strict total order of
// (rho, flat index): every link climbs, so the chain from a cell ends at the
// one root that pointer jumping reaches, and a chain from a cell above the
// threshold never leaves the cells above it (so the labels pass never reads
// rho, and the parents of the cells below are never needed).  The labels are
// integers, so they equal the plain version's (watershed_ref in
// ramses_tpu_torch/pm/clumps.py) bit for bit; the comparisons are the plain
// version's, in float64 (the deposit's type).
//
// The parents are taken axis by axis.  steepest_parent visits the
// neighbours in one order, but its take (rho greater, or equal with a
// larger flat index) is a strict total order on the values it can take: a
// NaN neighbour never compares true, and from a cell above the threshold
// only a neighbour at least as dense can win.  So the ring holds every value
// not above the threshold as -inf (NaN included), and the largest of the
// 3^ndim is the largest of the x-triples' largest, then of y-triples of
// those, then of z-triples: 2 * ndim comparisons a cell of rows and planes
// that its neighbours share, instead of 26.  A triple is scanned in the
// order of its cells' flat indices (-1, 0, +1 along the axis, or the turn
// of it that the periodic wrap makes at the axis's first and last cell), a
// candidate taking the lead when it is >= the lead: so the flat indices are
// never compared, and a candidate carries only its offsets.  A thread takes
// a column of 4 cells along the tile's slowest axis (an eighth of y in 2D,
// every 256th cell in 1D), the last three planes (rows in 2D) of the window
// in registers, and steps through its ring places and rows without a
// division; a ring load adds two entries of the block's tables of wrapped
// ring rows and columns.
//
// Scratch, one entry a cell: -1 below the threshold; -2 - r where the cell's
// root r is known; else a cell further up its chain.  The labels pass writes
// -2 - r into the entry of each cell it chased.  That is race-free: a cell's
// label is decided by its own thread from the value it read of its own
// entry, and every value an entry holds, first or written later, leads to
// the cell's own root (a pointer up its chain, or the encoded root itself;
// a 32- or 64-bit aligned store is seen whole).  No entry of a cell below
// the threshold is ever on a chain.
//
// What bounds it on an H100: bytes, as a function.  It reads rho once and
// writes each label once: 16 B a cell.  This design moves about 24: rho
// (its ring comes again from the neighbouring tiles, mostly through L2), the
// scratch written and read (4 B each while the grid has fewer than 2^31
// cells; the wide instantiation above that, 8 B) and the labels.  Indices
// are 32-bit there.  The parents pass is bound by issue (PERF.md counts its
// SASS), the labels pass by its chases: one dependent load a tile crossed
// instead of one a link, short on a noisy deposit, a peak's radius over the
// tile's edge on a smooth field or a plateau.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ramses_ws {

constexpr int kThreads = 256;

// a block's tile: X cells on the fastest axis, then Y, then Z (axes the
// grid lacks are 1 and carry no ring); 1,024 cells, 4 a thread: a column
// of 4 along the tile's slowest axis (z in 3D, an eighth of y in 2D) or,
// in 1D, every 256th cell
template <int NDIM>
struct Tile {
  static constexpr int X = NDIM == 3 ? 16 : (NDIM == 2 ? 32 : 1024);
  static constexpr int Y = NDIM == 3 ? 16 : (NDIM == 2 ? 32 : 1);
  static constexpr int Z = NDIM == 3 ? 4 : 1;
  static constexpr int RY = NDIM >= 2, RZ = NDIM >= 3;   // ring widths
  static constexpr int HX = X + 2, HY = Y + 2 * RY, HZ = Z + 2 * RZ;
  static constexpr int CELLS = X * Y * Z, HALO = HX * HY * HZ;
  static constexpr int ROWS = HY * HZ;    // ring rows: X x-triples each
  static constexpr int SEG = CELLS / kThreads;
  static_assert(NDIM != 3 || X * Y == kThreads, "a thread a 3D column");
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// shared memory, in doubles: the ring, which the links and parents
// replace once the x-triples are taken (2D, 3D), and the x-triples (their
// values and offsets; in 1D, the links and parents)
template <int NDIM, class Idx>
struct Smem {
  using T = Tile<NDIM>;
  static constexpr int LINKS = T::CELLS * (int)(sizeof(Idx) + sizeof(short));
  static constexpr int R0 = (NDIM >= 2 ? cmax(8 * T::HALO, LINKS)
                                        : 8 * T::HALO) / 8;
  static constexpr int R1 = ((NDIM >= 2 ? 9 * T::ROWS * T::X : LINKS) + 7)
                            / 8;
};

struct Grid {
  long long nx, ny, nz;    // cells a dim, the fastest axis first
  long long tx, ty;        // tiles along x and y
};

// where the wrapped coordinates of the offsets -1, 0, +1 of a cell at g
// on an axis of n cells start their increasing order: 0 inside (-1, 0, +1),
// 1 at 0 (0, +1 and -1, which wraps to n - 1), 2 at n - 1 (+1, which wraps
// to 0, -1, 0)
template <class Idx>
__device__ __forceinline__ int turn(Idx g, Idx n) {
  return g == 0 ? 1 : (g == n - 1 ? 2 : 0);
}

// a coordinate -1 .. n (a ring's) wrapped onto 0 .. n - 1
template <class Idx>
__device__ __forceinline__ Idx wrap(Idx x, Idx n) {
  return x < 0 ? n - 1 : (x >= n ? x - n : x);
}

// the largest of three candidates (values v, offsets c), visited in
// increasing order of their flat indices (from `turn`): an equal value
// later in that order wins, as in steepest_parent's take
__device__ __forceinline__ void scan3(double v0, double v1, double v2,
                                      int c0, int c1, int c2, double* best,
                                      int* best_c) {
  double b = v0;
  int bc = c0;
  if (v1 >= b) b = v1, bc = c1;
  if (v2 >= b) b = v2, bc = c2;
  *best = b;
  *best_c = bc;
}

__device__ __forceinline__ void best3(int turn, double v0, double v1,
                                      double v2, int c0, int c1, int c2,
                                      double* best, int* best_c) {
  if (turn == 1)
    scan3(v1, v2, v0, c1, c2, c0, best, best_c);
  else if (turn == 2)
    scan3(v2, v0, v1, c2, c0, c1, best, best_c);
  else
    scan3(v0, v1, v2, c0, c1, c2, best, best_c);
}

template <class Idx>
__device__ __forceinline__ Idx pick(int k, Idx a, Idx b, Idx c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

template <int NDIM, class Idx>
__global__ void __launch_bounds__(kThreads)
    parents_kernel(const double* __restrict__ rho, Grid g, double threshold,
                   Idx* __restrict__ scratch) {
  using T = Tile<NDIM>;
  using S = Smem<NDIM, Idx>;
  __shared__ double smem[S::R0 + S::R1];
  double* s_rho = smem;
  double* a_r = smem + S::R0;                       // x-triples (2D, 3D)
  unsigned char* a_c = (unsigned char*)(a_r + T::ROWS * T::X);
  Idx* s_parent = (Idx*)(NDIM >= 2 ? smem : smem + S::R0);
  short* s_link = (short*)(s_parent + T::CELLS);   // in-tile parent, or -1
  const Idx nx = (Idx)g.nx, ny = (Idx)g.ny, nz = (Idx)g.nz;
  const Idx b = (Idx)blockIdx.x, bxy = b / (Idx)g.tx;
  const Idx ox = (b - bxy * (Idx)g.tx) * T::X;
  const Idx oy = (bxy % (Idx)g.ty) * T::Y, oz = (bxy / (Idx)g.ty) * T::Z;
  const int t = threadIdx.x;

  // the tile and the ring its cells read (-1 .. n on each axis, wrapped),
  // each value not above the threshold as -inf: first the flat index of
  // each ring row's start and each ring column (-1 where the grid's cells
  // never read it), then each thread's ring places t, t + 256, .. stepped
  // without a division (every load issued before the first is used)
  {
    Idx* s_row = (Idx*)(smem + S::R0);     // the x-triples' room, for now
    Idx* s_col = s_row + T::ROWS;
    for (int i = t; i < T::ROWS + T::HX; i += kThreads) {
      if (i < T::ROWS) {
        const Idx y = oy + i % T::HY - T::RY, z = oz + i / T::HY - T::RZ;
        s_row[i] = y > ny || z > nz ? (Idx)-1
                                    : (wrap(z, nz) * ny + wrap(y, ny)) * nx;
      } else {
        const Idx x = ox + (i - T::ROWS) - 1;
        s_col[i - T::ROWS] = x > nx ? (Idx)-1 : wrap(x, nx);
      }
    }
    __syncthreads();
    constexpr int PER = (T::HALO + kThreads - 1) / kThreads;
    constexpr int DX = kThreads % T::HX, DR = kThreads / T::HX;
    int hx = t % T::HX, row = t / T::HX;
    double r[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const bool in = t + k * kThreads < T::HALO;
      const Idx rb = in ? s_row[row] : (Idx)-1, xc = in ? s_col[hx] : (Idx)-1;
      r[k] = rb >= 0 && xc >= 0 ? __ldg(rho + (rb + xc)) : -INFINITY;
      hx += DX;
      const int cx = hx >= T::HX;
      hx -= cx ? T::HX : 0;
      row += DR + cx;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int h = t + k * kThreads;
      if (h < T::HALO) s_rho[h] = r[k] > threshold ? r[k] : -INFINITY;
    }
  }
  __syncthreads();

  // this thread's cells (k = 0 .. SEG - 1): their place in the tile
  auto cell = [&](int k, int* lx, int* ly, int* lz) {
    if (NDIM == 3) {
      *lx = t % T::X; *ly = t / T::X; *lz = k;
    } else if (NDIM == 2) {
      *lx = t % T::X; *ly = t / T::X * T::SEG + k; *lz = 0;
    } else {
      *lx = t + k * kThreads; *ly = 0; *lz = 0;
    }
  };
  // which of them lie in the grid and are above the threshold
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < T::SEG; ++k) {
    int lx, ly, lz;
    cell(k, &lx, &ly, &lz);
    if (ox + lx >= nx || oy + ly >= ny || oz + lz >= nz) continue;
    const int hc = ((lz + T::RZ) * T::HY + ly + T::RY) * T::HX + lx + 1;
    if (s_rho[hc] > -INFINITY) {
      live |= 1u << k;
    } else {
      scratch[((oz + lz) * ny + oy + ly) * nx + ox + lx] = -1;
    }
  }

  // the x-triples of the ring's rows (2D, 3D): a thread keeps one column x
  // (X divides the block) and steps through the rows
  int lx0, ly0, lz0;
  cell(0, &lx0, &ly0, &lz0);
  const Idx gx = ox + lx0;
  const int turn_x = turn<Idx>(gx, nx);
  if (NDIM >= 2) {
    constexpr int PA = (T::ROWS * T::X + kThreads - 1) / kThreads;
    constexpr int DR = kThreads / T::X;
    const int row0 = t / T::X;
    int hy = row0 % T::HY, hz = row0 / T::HY;
#pragma unroll
    for (int k = 0; k < PA; ++k) {
      const int row = row0 + k * DR;
      if (row < T::ROWS && gx < nx && oy + hy - T::RY <= ny &&
          oz + hz - T::RZ <= nz) {
        const int h = row * T::HX + lx0;
        double best;
        int bc;
        best3(turn_x, s_rho[h], s_rho[h + 1], s_rho[h + 2], 0, 1, 2, &best,
              &bc);
        a_r[row * T::X + lx0] = best;
        a_c[row * T::X + lx0] = (unsigned char)bc;
      }
      hy += DR % T::HY;
      const int cy = hy >= T::HY;
      hy -= cy ? T::HY : 0;
      hz += DR / T::HY + cy;
    }
    __syncthreads();   // the ring is not read again: the links take it
  }

  // the parent of each live cell: its offsets (a * 9 + b * 3 + c, each
  // 0 .. 2 for -1 .. +1), its flat index, its place in the tile
  const Idx gy = oy + ly0;
  const Idx xs[3] = {wrap<Idx>(gx - 1, nx), gx, wrap<Idx>(gx + 1, nx)};
  const Idx ys[3] = {wrap<Idx>(gy - 1, ny), gy, wrap<Idx>(gy + 1, ny)};
  double pr[3] = {0.0, 0.0, 0.0};
  int pc[3] = {0, 0, 0};
  const int steps = NDIM == 1 ? T::SEG : T::SEG + 2;
#pragma unroll
  for (int s = 0; s < steps; ++s) {
    int k, a, bb, c;
    double best;
    if (NDIM == 1) {
      // the x-triple of cell s, straight from the ring
      k = s;
      if (!((live >> k) & 1)) continue;
      const int lx = t + k * kThreads;
      best3(turn<Idx>(ox + lx, nx), s_rho[lx], s_rho[lx + 1], s_rho[lx + 2],
            0, 1, 2, &best, &c);
      a = bb = 1;
    } else {
      // the next plane (3D: a y-triple of x-triples) or row (2D: an
      // x-triple) of the window
      pr[0] = pr[1]; pc[0] = pc[1];
      pr[1] = pr[2]; pc[1] = pc[2];
      if (NDIM == 3) {
        const int e = (s * T::HY + ly0) * T::X + lx0;
        best3(turn<Idx>(gy, ny), a_r[e], a_r[e + T::X], a_r[e + 2 * T::X],
              a_c[e], 3 + a_c[e + T::X], 6 + a_c[e + 2 * T::X], &pr[2],
              &pc[2]);
      } else {
        const int e = (ly0 + s) * T::X + lx0;
        pr[2] = a_r[e];
        pc[2] = a_c[e];
      }
      if (s < 2) continue;
      k = s - 2;                          // the cell the window now holds
      if (!((live >> k) & 1)) continue;
      // its z-triple of planes (3D) or y-triple of rows (2D)
      int code;
      if (NDIM == 3) {
        best3(turn<Idx>(oz + k, nz), pr[0], pr[1], pr[2], pc[0], 9 + pc[1],
              18 + pc[2], &best, &code);
        a = code / 9;
        bb = code / 3 % 3;
      } else {
        best3(turn<Idx>(gy + k, ny), pr[0], pr[1], pr[2], pc[0], 3 + pc[1],
              6 + pc[2], &best, &code);
        a = 1;
        bb = code / 3;
      }
      c = code % 3;
    }
    int lx, ly, lz;
    cell(k, &lx, &ly, &lz);
    const Idx px = NDIM == 1 ? wrap<Idx>(ox + lx + c - 1, nx)
                             : pick(c, xs[0], xs[1], xs[2]);
    const Idx py = NDIM == 3 ? pick(bb, ys[0], ys[1], ys[2])
                 : NDIM == 2 ? wrap<Idx>(oy + ly + bb - 1, ny) : (Idx)0;
    const Idx pz = NDIM == 3 ? wrap<Idx>(oz + lz + a - 1, nz) : (Idx)0;
    // a wrapped neighbour may lie in the tile
    const bool in = px >= ox && px < ox + T::X && py >= oy &&
                    py < oy + T::Y && pz >= oz && pz < oz + T::Z;
    const int l = (lz * T::Y + ly) * T::X + lx;
    s_link[l] = in ? (short)(((pz - oz) * T::Y + (py - oy)) * T::X +
                             (px - ox))
                   : (short)-1;
    s_parent[l] = (pz * ny + py) * nx + px;
  }
  __syncthreads();

  // each live cell follows its links inside the tile
#pragma unroll 1
  for (int k = 0; k < T::SEG; ++k) {
    if (!((live >> k) & 1)) continue;
    int lx, ly, lz;
    cell(k, &lx, &ly, &lz);
    const Idx c = ((oz + lz) * ny + oy + ly) * nx + ox + lx;
    int q = (lz * T::Y + ly) * T::X + lx;
    for (;;) {
      const int p = s_link[q];
      if (p == q) {                     // a root: the label is known
        scratch[c] = -2 - s_parent[q];
        break;
      }
      if (p < 0) {                      // the chain leaves the tile
        scratch[c] = s_parent[q];
        break;
      }
      q = p;
    }
  }
}

// cells a thread of the labels kernel takes, their chases in lockstep
constexpr int kLabelCells = 4;

template <class Idx>
__global__ void __launch_bounds__(kThreads)
    labels_kernel(Idx ncell, Idx* scratch, int64_t* __restrict__ labels) {
  const Idx i0 = (Idx)blockIdx.x * (kThreads * kLabelCells) + threadIdx.x;
  Idx p[kLabelCells], w[kLabelCells];
  unsigned chase = 0;          // the cells whose chain left their tile
#pragma unroll
  for (int k = 0; k < kLabelCells; ++k) {
    const Idx i = i0 + k * kThreads;
    p[k] = i < ncell ? scratch[i] : -1;
    w[k] = p[k];
    if (p[k] >= 0) chase |= 1u << k;
  }
  const unsigned chased = chase;
  // each pointer followed to an encoded root, every chase a step a round
  while (chase) {
#pragma unroll
    for (int k = 0; k < kLabelCells; ++k) {
      if (!((chase >> k) & 1)) continue;
      w[k] = scratch[p[k]];
      if (w[k] < 0)
        chase &= ~(1u << k);
      else
        p[k] = w[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kLabelCells; ++k) {
    const Idx i = i0 + k * kThreads;
    if (i >= ncell) continue;
    labels[i] = w[k] == -1 ? -1 : -2 - w[k];
    if ((chased >> k) & 1)
      scratch[i] = w[k];       // the root, for the chases that pass here
  }
}

__global__ void watershed_empty_kernel() {}

template <int NDIM, class Idx>
int launch(const double* rho, long long nx, long long ny, long long nz,
           double threshold, Idx* scratch, int64_t* labels,
           cudaStream_t s) {
  using T = Tile<NDIM>;
  const long long ncell = nx * ny * nz;
  const Grid g = {nx, ny, nz, (nx + T::X - 1) / T::X, (ny + T::Y - 1) / T::Y};
  const long long tiles = g.tx * g.ty * ((nz + T::Z - 1) / T::Z);
  {
    const dim3 grid((unsigned)tiles), block(kThreads);
    parents_kernel<NDIM, Idx><<<grid, block, 0, s>>>(rho, g, threshold,
                                                      scratch);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  {
    const long long per = kThreads * kLabelCells;
    const dim3 grid((unsigned)((ncell + per - 1) / per)), block(kThreads);
    labels_kernel<Idx><<<grid, block, 0, s>>>((Idx)ncell, scratch, labels);
  }
  return (int)cudaGetLastError();
}

// the axes fastest first, checked as the entries take them
inline bool axes(long long n0, long long n1, long long n2, int ndim,
                 long long* n) {
  if (ndim < 1 || ndim > 3 || n0 < 1 || n1 < 1 || n2 < 1) return false;
  if ((ndim < 3 && n2 != 1) || (ndim < 2 && n1 != 1)) return false;
  const long long d[3] = {n0, n1, n2};
  for (int e = 0; e < 3; ++e) n[e] = e < ndim ? d[ndim - 1 - e] : 1;
  return true;
}

template <class Idx>
int watershed(const double* rho, long long n0, long long n1, long long n2,
              int ndim, double threshold, Idx* scratch, int64_t* labels,
              void* stream) {
  long long n[3];
  if (!axes(n0, n1, n2, ndim, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 1)
    return launch<1, Idx>(rho, n[0], n[1], n[2], threshold, scratch, labels,
                          s);
  if (ndim == 2)
    return launch<2, Idx>(rho, n[0], n[1], n[2], threshold, scratch, labels,
                          s);
  return launch<3, Idx>(rho, n[0], n[1], n[2], threshold, scratch, labels,
                        s);
}

}  // namespace ramses_ws

// rho [n0, n1, n2] contiguous float64, with the trailing dims past ndim 1
// and fewer than 2^31 cells; scratch: n0*n1*n2 int32; labels [n0, n1, n2]
// int64 out.  Returns the launches' cudaError_t.
extern "C" int ramses_watershed(const double* rho, long long n0,
                                long long n1, long long n2, int ndim,
                                double threshold, int32_t* scratch,
                                int64_t* labels, void* stream) {
  if (n0 * n1 * n2 >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  return ramses_ws::watershed<int32_t>(rho, n0, n1, n2, ndim, threshold,
                                       scratch, labels, stream);
}

// ramses_watershed's 64-bit instantiation, for any number of cells: scratch
// n0*n1*n2 int64, indices in 64 bits
extern "C" int ramses_watershed_wide(const double* rho, long long n0,
                                     long long n1, long long n2, int ndim,
                                     double threshold, long long* scratch,
                                     int64_t* labels, void* stream) {
  return ramses_ws::watershed<long long>(rho, n0, n1, n2, ndim, threshold,
                                         scratch, labels, stream);
}

// an empty kernel on `blocks` blocks of K10's width: the device time of a
// launch that does nothing, the floor under K10's small shapes
extern "C" int ramses_watershed_empty(long long blocks, void* stream) {
  using namespace ramses_ws;
  const dim3 grid((unsigned)blocks), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  watershed_empty_kernel<<<grid, block, 0, s>>>();
  return (int)cudaGetLastError();
}
