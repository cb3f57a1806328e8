// The regrid's migration maps (K7), hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package derives these maps inside one
// XLA program a level, ramses_tpu/amr/device_regrid.py::_migrate_level_jit
// (its lines up to `nb`).  The same work in eager PyTorch is some 100-150
// small launches a level in 3D (six neighbours, each a ladder of masks and
// a search), on a regrid that is already launch- and host-bound; here it is
// one launch.  One thread an oct of the new level, from the sorted Morton
// keys of the new level, the old level and the new coarser level (each
// padded with the int64 max, which stays sorted and never equals a real
// key):
//
//   pos, kept  the new key's lower bound in the old keys, clipped to the
//              array, and whether it is there (a real oct only);
//   f_cell     the father cell: the oct `key >> ndim` searched in the
//              coarse keys, times 2^ndim, plus the child slot (the key's
//              low ndim bits reversed);
//   nb         for each axis and sign the father's face neighbour: decode,
//              step one cell, map through the boundaries (periodic wrap,
//              reflecting mirror, any other kind clamped, on the lvl-1
//              cell counts `dims`, which carry non-cubic roots), encode,
//              search; the father cell itself where the neighbour is
//              missing or crossed a reflecting face.
//
// The arithmetic is regrid_maps_ref's (ramses_tpu_torch/amr/
// device_regrid.py): the same 64-bit mask ladders and a lower-bound binary
// search.  The outputs are integers, so the two agree bit for bit.
//
// What bounds it on an H100: bytes.  An oct reads its key (8 B) and writes
// pos, f_cell and 2*ndim neighbours (8 B each) and kept (1 B): 73 B in 3D;
// each of its 1 + 1 + 2*ndim searches reads ~log2(n) keys, which stay in L2
// (8 B a key: a 262,144-oct level is 2 MB).  At the main path's levels (a
// few thousand octs) the launch itself is the cost.  The design does
// nothing beyond one thread an oct, 256 a block, the keys read through the
// read-only path (__ldg) and no shared-memory staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace ramses_regrid {

constexpr int kThreads = 256;

struct Geometry {
  int lo[3], hi[3];        // boundary kinds: 0 periodic, 1 reflecting
  long long dims[3];       // cells a dim at lvl-1
};

template <int NDIM>
__device__ __forceinline__ uint64_t spread(uint64_t x) {
  if (NDIM == 2) {
    x &= 0xFFFFFFFFull;
    x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
    x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
    x = (x | (x << 2)) & 0x3333333333333333ull;
    x = (x | (x << 1)) & 0x5555555555555555ull;
  } else {
    x &= 0x1FFFFFull;
    x = (x | (x << 32)) & 0x1F00000000FFFFull;
    x = (x | (x << 16)) & 0x1F0000FF0000FFull;
    x = (x | (x << 8)) & 0x100F00F00F00F00Full;
    x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
    x = (x | (x << 2)) & 0x1249249249249249ull;
  }
  return x;
}

template <int NDIM>
__device__ __forceinline__ uint64_t compact(uint64_t x) {
  if (NDIM == 2) {
    x &= 0x5555555555555555ull;
    x = (x | (x >> 1)) & 0x3333333333333333ull;
    x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0Full;
    x = (x | (x >> 4)) & 0x00FF00FF00FF00FFull;
    x = (x | (x >> 8)) & 0x0000FFFF0000FFFFull;
    x = (x | (x >> 16)) & 0xFFFFFFFFull;
  } else {
    x &= 0x1249249249249249ull;
    x = (x | (x >> 2)) & 0x10C30C30C30C30C3ull;
    x = (x | (x >> 4)) & 0x100F00F00F00F00Full;
    x = (x | (x >> 8)) & 0x1F0000FF0000FFull;
    x = (x | (x >> 16)) & 0x1F00000000FFFFull;
    x = (x | (x >> 32)) & 0x1FFFFFull;
  }
  return x;
}

template <int NDIM>
__device__ __forceinline__ int64_t encode(const int64_t* c) {
  if (NDIM == 1) return c[0];
  uint64_t k = 0;
#pragma unroll
  for (int d = 0; d < NDIM; d++) k |= spread<NDIM>((uint64_t)c[d]) << d;
  return (int64_t)k;
}

template <int NDIM>
__device__ __forceinline__ void decode(int64_t key, int64_t* c) {
  if (NDIM == 1) {
    c[0] = key;
    return;
  }
#pragma unroll
  for (int d = 0; d < NDIM; d++)
    c[d] = (int64_t)compact<NDIM>((uint64_t)key >> d);
}

template <int NDIM>
__device__ __forceinline__ int64_t bitrev_low(int64_t key) {
  int64_t off = 0;
#pragma unroll
  for (int d = 0; d < NDIM; d++) off = off * 2 + ((key >> d) & 1);
  return off;
}

// lower bound of v in keys[0, m), clipped to m - 1 (m >= 1)
__device__ __forceinline__ int64_t find(const int64_t* __restrict__ keys,
                                        int64_t m, int64_t v, bool* hit) {
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  int64_t pos = lo < m ? lo : m - 1;
  *hit = __ldg(keys + pos) == v;
  return pos;
}

// tree.map_coords of one coordinate; returns whether it crossed a
// reflecting face
__device__ __forceinline__ bool map_coord(int64_t* x, int lo, int hi,
                                          int64_t n) {
  int64_t v = *x;
  if (lo == 0 && hi == 0) {
    v %= n;
    *x = v < 0 ? v + n : v;
    return false;
  }
  const bool below = v < 0, above = v >= n;
  bool refl = false;
  if (lo == 1) {
    if (below) v = -1 - v;
    refl |= below;
  } else if (lo != 0 && below) {
    v = 0;
  }
  if (hi == 1) {
    if (above) v = 2 * n - 1 - v;
    refl |= above;
  } else if (hi != 0 && above) {
    v = n - 1;
  }
  *x = v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
  return refl;
}

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
    regrid_maps_kernel(const int64_t* __restrict__ new_keys, int64_t n,
                       const int64_t* __restrict__ old_keys, int64_t n_old,
                       const int64_t* __restrict__ coarse_keys, int64_t n_c,
                       Geometry g, int64_t* __restrict__ pos,
                       bool* __restrict__ kept, int64_t* __restrict__ f_cell,
                       int64_t* __restrict__ nb) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  constexpr int64_t ttd = 1 << NDIM;
  const int64_t key = __ldg(new_keys + i);
  const bool valid = key < INT64_MAX;
  bool hit;
  const int64_t p = find(old_keys, n_old, key, &hit);
  pos[i] = p;
  kept[i] = hit && valid;
  const int64_t f_pos = find(coarse_keys, n_c, key >> NDIM, &hit);
  const int64_t fc = f_pos * ttd + bitrev_low<NDIM>(key);
  f_cell[i] = fc;
  int64_t og[NDIM];
  decode<NDIM>(key, og);
#pragma unroll
  for (int d = 0; d < NDIM; d++) {
#pragma unroll
    for (int s = 0; s < 2; s++) {
      int64_t c[NDIM];
      bool refl = false;
#pragma unroll
      for (int e = 0; e < NDIM; e++) {
        // the step wraps as the plain version's and JAX's int64 adds do:
        // a 1D pad row decodes to INT64_MAX (signed overflow is undefined)
        c[e] = e == d ? (int64_t)((uint64_t)og[e] + (uint64_t)(2 * s - 1))
                      : og[e];
        refl |= map_coord(&c[e], g.lo[e], g.hi[e], g.dims[e]);
      }
      const int64_t nkey = encode<NDIM>(c);
      bool found;
      const int64_t n_pos = find(coarse_keys, n_c, nkey >> NDIM, &found);
      nb[(i * NDIM + d) * 2 + s] =
          (!found || refl) ? fc : n_pos * ttd + bitrev_low<NDIM>(nkey);
    }
  }
}

template <int NDIM>
cudaError_t launch(const int64_t* new_keys, int64_t n,
                   const int64_t* old_keys, int64_t n_old,
                   const int64_t* coarse_keys, int64_t n_c, const Geometry& g,
                   int64_t* pos, bool* kept, int64_t* f_cell, int64_t* nb,
                   cudaStream_t s) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads)), block(kThreads);
  regrid_maps_kernel<NDIM><<<grid, block, 0, s>>>(
      new_keys, n, old_keys, n_old, coarse_keys, n_c, g, pos, kept, f_cell,
      nb);
  return cudaGetLastError();
}

}  // namespace ramses_regrid

// new_keys [n], old_keys [n_old], coarse_keys [n_c]: sorted int64, padded
// with INT64_MAX (n_old, n_c >= 1); lo*/hi*: boundary kinds of each axis;
// d*: lvl-1 cells a dim (axes past ndim are ignored); outputs pos [n]
// int64, kept [n] bool, f_cell [n] int64, nb [n, ndim, 2] int64.
// Returns the launch's cudaError_t.
extern "C" int ramses_regrid_maps(
    const int64_t* new_keys, long long n, const int64_t* old_keys,
    long long n_old, const int64_t* coarse_keys, long long n_c, int ndim,
    int lo0, int hi0, int lo1, int hi1, int lo2, int hi2, long long d0,
    long long d1, long long d2, int64_t* pos, bool* kept, int64_t* f_cell,
    int64_t* nb, void* stream) {
  using namespace ramses_regrid;
  if (n <= 0) return 0;
  if (n_old < 1 || n_c < 1 || ndim < 1 || ndim > 3)
    return (int)cudaErrorInvalidValue;
  const Geometry g = {{lo0, lo1, lo2}, {hi0, hi1, hi2}, {d0, d1, d2}};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (ndim == 1)
    err = launch<1>(new_keys, n, old_keys, n_old, coarse_keys, n_c, g, pos,
                    kept, f_cell, nb, s);
  else if (ndim == 2)
    err = launch<2>(new_keys, n, old_keys, n_old, coarse_keys, n_c, g, pos,
                    kept, f_cell, nb, s);
  else
    err = launch<3>(new_keys, n, old_keys, n_old, coarse_keys, n_c, g, pos,
                    kept, f_cell, nb, s);
  return (int)err;
}
