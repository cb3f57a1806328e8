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
// device_regrid.py): the same 64-bit mask ladders and a clipped lower
// bound.  The outputs are integers, so the two agree bit for bit.
//
// What bounds it on an H100: latency and L2 transactions.  An oct moves
// 73 B in 3D (its key in; pos, f_cell and 2*ndim neighbours of 8 B and kept
// out), but its binary searches read ~log2(m) dependent keys each, and
// those of a neighbour land on scattered 32-byte sectors: 2 + 2*ndim
// searches one after another would be ~90 dependent L2 loads a thread at
// config 2's levels and ~150 at 262,144 octs.  The design:
//
//   fewer      2 + ndim searches: of a father cell's two neighbours on an
//              axis, one lies in the father's own oct (cells 2m and 2m + 1
//              share one), so its oct is the father's and needs no search;
//              only the one across the oct's face does;
//   lockstep   a thread's searches advance together, one round at a time: a
//              branchless lower bound whose rounds depend on the array's
//              length only (ceil(log2 m), the same for every thread), so
//              the dependent chain is one search deep and the loads of a
//              round are in flight together;
//   staged     where the old and coarse keys fit (kStagedKeys together,
//              config 2's levels), each block copies them whole into
//              shared memory with 16-byte cp.async (8-byte where an array
//              is not 16-byte aligned) and searches there; above that it
//              reads them through L1, which holds the upper levels of every
//              search (staging each array's search-tree top instead, every
//              2^k-th key gathered by each block, took longer than it saved
//              at 262,144 octs on an H100: PERF.md).  The branch depends on
//              n_old and n_c only;
//   stepped    a neighbour inside the box is the key with one axis's
//              dilated bits incremented or decremented (four 64-bit
//              operations); only an oct at a face takes the decode / map /
//              encode ladder of the plain version.  A warp that holds a
//              sentinel pad (or a step out of a box of odd cell count)
//              forms all 2*ndim neighbours so and searches them all, in
//              lockstep as well (a choice the whole warp makes);
//   blocks     of 128 threads, each oct's neighbour row in 16-byte
//              stores: a block waits at no barrier after the searches, and
//              fewer searches wait on the slowest (a block of 256 that
//              staged its rows through shared memory for coalesced stores
//              took longer on an H100, PERF.md).
//
// The lower bound of v in keys[0, m), clipped to m - 1: candidates
// [base, base + len) start as [0, m); a round reads keys[base + h - 1],
// h = len / 2, moves base up by h where that key is below v, and leaves
// len - h candidates.  It never reads keys[m - 1], which so stands for +inf,
// and ends with base = min(lower bound, m - 1), the plain version's
// clipped position; the hit test then reads keys[base].

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RAMSES_HOST_STUBS
// 16- and 8-byte asynchronous copies into shared memory (LDGSTS), their
// group and the wait for all of them.  A host build supplies plain copies.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
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

namespace ramses_regrid {

constexpr int kThreads = 128;
// old + coarse keys staged whole at most (96 KB of dynamic shared memory)
constexpr int kStagedKeys = 12288;

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

// the key bits of axis d: spread's last mask, shifted
template <int NDIM>
__device__ __forceinline__ uint64_t axis_mask(int d) {
  if (NDIM == 1) return ~0ull;
  return (NDIM == 2 ? 0x5555555555555555ull : 0x1249249249249249ull) << d;
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
__device__ __forceinline__ int bitrev_low(int64_t key) {
  int off = 0;
#pragma unroll
  for (int d = 0; d < NDIM; d++) off = off * 2 + (int)((key >> d) & 1);
  return off;
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

// copy m keys into shared memory (dst 16-byte aligned): 16-byte cp.async
// where src is 16-byte aligned, else 8-byte; the caller commits and waits
__device__ __forceinline__ void stage_keys(int64_t* dst, const int64_t* src,
                                           int m) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; 2 * i + 1 < m; i += kThreads)
      cp_async_16(dst + 2 * i, src + 2 * i);
    if ((m & 1) && threadIdx.x == 0) cp_async_8(dst + m - 1, src + m - 1);
  } else {
    for (int i = threadIdx.x; i < m; i += kThreads)
      cp_async_8(dst + i, src + i);
  }
}

// one round of NS searches on one array of `len` (> 1) candidates, in
// shared memory (`s`, the array staged whole) or through L1 from `keys`
template <bool STAGED, int NS>
__device__ __forceinline__ void round_of(const int64_t* s,
                                         const int64_t* __restrict__ keys,
                                         int len, const int64_t* v,
                                         int* base) {
  const int h = len >> 1;
  int64_t key[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j)
    key[j] = STAGED ? s[base[j] + h - 1] : __ldg(keys + base[j] + h - 1);
#pragma unroll
  for (int j = 0; j < NS; ++j) base[j] += key[j] < v[j] ? h : 0;
}

// the clipped lower bounds of vo in the old keys (*bo) and of the NS
// values vc in the coarse keys (bc, found), every search in lockstep
template <bool STAGED, int NS>
__device__ __forceinline__ void search(const int64_t* so, const int64_t* sc,
                                       const int64_t* __restrict__ old_keys,
                                       int n_old,
                                       const int64_t* __restrict__ coarse_keys,
                                       int n_c, int64_t vo, const int64_t* vc,
                                       int* bo, int* bc, bool* found) {
  *bo = 0;
#pragma unroll
  for (int j = 0; j < NS; ++j) bc[j] = 0;
  for (int lo = n_old, lc = n_c; lo > 1 || lc > 1;) {
    if (lo > 1) {
      round_of<STAGED, 1>(so, old_keys, lo, &vo, bo);
      lo -= lo >> 1;
    }
    if (lc > 1) {
      round_of<STAGED, NS>(sc, coarse_keys, lc, vc, bc);
      lc -= lc >> 1;
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
    found[j] = (STAGED ? sc[bc[j]] : __ldg(coarse_keys + bc[j])) == vc[j];
}

// neighbour s (0: -1, 1: +1) of the cell og along axis d, as the plain
// version forms it: its key; *refl whether it crossed a reflecting face
template <int NDIM>
__device__ __forceinline__ int64_t step_key(int64_t key, const int64_t* og,
                                            int d, int s, bool inside,
                                            const Geometry& g, bool* refl) {
  *refl = false;
  if (inside && (s ? og[d] + 1 < g.dims[d] : og[d] > 0)) {
    // in the box: map_coords leaves every axis as it is, and only axis
    // d's dilated bits change
    const uint64_t m = axis_mask<NDIM>(d), u = (uint64_t)key;
    const uint64_t x = s ? ((u | ~m) + 1) & m : ((u & m) - 1) & m;
    return (int64_t)((u & ~m) | x);
  }
  int64_t c[NDIM];
  bool rf = false;
#pragma unroll
  for (int e = 0; e < NDIM; e++) {
    // the step wraps as the plain version's and JAX's int64 adds do: a 1D
    // pad row decodes to INT64_MAX (signed overflow is undefined)
    c[e] = e == d ? (int64_t)((uint64_t)og[e] + (uint64_t)(2 * s - 1))
                  : og[e];
    rf |= map_coord(&c[e], g.lo[e], g.hi[e], g.dims[e]);
  }
  *refl = rf;
  return encode<NDIM>(c);
}

template <int NDIM, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    regrid_maps_kernel(const int64_t* __restrict__ new_keys, long long n,
                       const int64_t* __restrict__ old_keys, int n_old,
                       const int64_t* __restrict__ coarse_keys, int n_c,
                       Geometry g, int64_t* __restrict__ pos,
                       bool* __restrict__ kept, int64_t* __restrict__ f_cell,
                       int64_t* __restrict__ nb) {
  extern __shared__ __align__(16) int64_t smem[];
  constexpr int NB = 2 * NDIM;            // neighbours an oct
  constexpr int NC = 1 + NDIM;            // the father, a crossing each axis
  constexpr int ttd = 1 << NDIM;
  int64_t* so = smem;
  int64_t* sc = so + (n_old + 1) / 2 * 2;
  if (STAGED) {
    stage_keys(so, old_keys, n_old);
    stage_keys(sc, coarse_keys, n_c);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;

  // the values searched: the key in the old keys; the father's oct and,
  // on each axis, the neighbour's oct across the father's oct face (the
  // neighbour on the other side lies in the father's oct: of cells 2m and
  // 2m + 1, the step from 2m to 2m + 1 stays, the one to 2m - 1 crosses)
  const int64_t key = live ? __ldg(new_keys + i) : INT64_MAX;
  int64_t og[NDIM];
  decode<NDIM>(key, og);
  bool inside = true, simple;
#pragma unroll
  for (int e = 0; e < NDIM; e++) inside &= og[e] >= 0 && og[e] < g.dims[e];
  simple = inside;             // and every staying step in the box
#pragma unroll
  for (int d = 0; d < NDIM; d++)
    simple &= og[d] & 1 ? og[d] > 0 : og[d] + 1 < g.dims[d];
  int bo;
  int64_t fc, out[NB];
  if (!__any_sync(0xffffffffu, !simple)) {
    int64_t vc[NC];
    int slot[NC], stay_slot[NDIM], bc[NC];
    bool refl[NC], found[NC];
    vc[0] = key >> NDIM;
    slot[0] = bitrev_low<NDIM>(key);
    refl[0] = false;
#pragma unroll
    for (int d = 0; d < NDIM; d++) {
      const int cross = (int)(og[d] & 1);   // +1 crosses from an odd cell
      bool rf;
      const int64_t ck = step_key<NDIM>(key, og, d, cross, inside, g, &rf);
      vc[1 + d] = ck >> NDIM;
      slot[1 + d] = bitrev_low<NDIM>(ck);
      refl[1 + d] = rf;
      stay_slot[d] = bitrev_low<NDIM>(
          step_key<NDIM>(key, og, d, 1 - cross, inside, g, &rf));
    }
    search<STAGED, NC>(so, sc, old_keys, n_old, coarse_keys, n_c, key, vc,
                       &bo, bc, found);
    fc = (int64_t)bc[0] * ttd + slot[0];
#pragma unroll
    for (int d = 0; d < NDIM; d++) {
      const int cross = (int)(og[d] & 1);
      const int64_t across = (!found[1 + d] || refl[1 + d])
                                 ? fc : (int64_t)bc[1 + d] * ttd + slot[1 + d];
      const int64_t stay = found[0] ? (int64_t)bc[0] * ttd + stay_slot[d]
                                    : fc;
      out[2 * d] = cross ? stay : across;
      out[2 * d + 1] = cross ? across : stay;
    }
  } else {
    // a warp with a sentinel pad, or a staying step out of the box: every
    // neighbour as the plain version forms it, all searched in lockstep
    constexpr int NW = 1 + NB;
    int64_t vc[NW];
    int slot[NW], bc[NW];
    bool refl[NW], found[NW];
    vc[0] = key >> NDIM;
    slot[0] = bitrev_low<NDIM>(key);
    refl[0] = false;
#pragma unroll
    for (int j = 0; j < NB; j++) {
      bool rf;
      const int64_t nk = step_key<NDIM>(key, og, j / 2, j % 2, inside, g, &rf);
      vc[1 + j] = nk >> NDIM;
      slot[1 + j] = bitrev_low<NDIM>(nk);
      refl[1 + j] = rf;
    }
    search<STAGED, NW>(so, sc, old_keys, n_old, coarse_keys, n_c, key, vc,
                       &bo, bc, found);
    fc = (int64_t)bc[0] * ttd + slot[0];
#pragma unroll
    for (int j = 0; j < NB; j++)
      out[j] = (!found[1 + j] || refl[1 + j])
                   ? fc : (int64_t)bc[1 + j] * ttd + slot[1 + j];
  }
  if (live) {
    const int64_t at_o = STAGED ? so[bo] : __ldg(old_keys + bo);
    pos[i] = bo;
    kept[i] = at_o == key && key < INT64_MAX;
    f_cell[i] = fc;
  }
  if (live) {                // the row of nb, in 16-byte stores
#pragma unroll
    for (int j = 0; j < NB / 2; ++j)
      reinterpret_cast<longlong2*>(nb + i * NB)[j] =
          make_longlong2(out[2 * j], out[2 * j + 1]);
  }
}

__global__ void regrid_empty_kernel() {}

// whether n_old + n_c keys are staged whole (else read through L1)
inline bool staged(long long n_old, long long n_c) {
  return n_old + n_c + 1 <= kStagedKeys;
}

// cudaFuncSetAttribute once per kernel and device: the dynamic shared
// memory above 48 KB.  Returns its error.
template <class K>
int prepare(K kernel, int bytes, unsigned long long* done) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err) *done |= bit;
  return err;
}

template <int NDIM>
int launch(const int64_t* new_keys, long long n, const int64_t* old_keys,
           int n_old, const int64_t* coarse_keys, int n_c, const Geometry& g,
           int64_t* pos, bool* kept, int64_t* f_cell, int64_t* nb,
           cudaStream_t s) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads)), block(kThreads);
  if (staged(n_old, n_c)) {
    static unsigned long long done = 0;
    int err = prepare(regrid_maps_kernel<NDIM, true>,
                      kStagedKeys * (int)sizeof(int64_t), &done);
    if (err) return err;
    const size_t smem = ((size_t)(n_old + 1) / 2 * 2 + n_c) * sizeof(int64_t);
    regrid_maps_kernel<NDIM, true><<<grid, block, smem, s>>>(
        new_keys, n, old_keys, n_old, coarse_keys, n_c, g, pos, kept, f_cell,
        nb);
  } else {
    regrid_maps_kernel<NDIM, false><<<grid, block, 0, s>>>(
        new_keys, n, old_keys, n_old, coarse_keys, n_c, g, pos, kept, f_cell,
        nb);
  }
  return (int)cudaGetLastError();
}

}  // namespace ramses_regrid

// new_keys [n], old_keys [n_old], coarse_keys [n_c]: sorted int64, padded
// with INT64_MAX (1 <= n_old, n_c < 2^31); lo*/hi*: boundary kinds of each
// axis; d*: lvl-1 cells a dim (axes past ndim are ignored); outputs pos [n]
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
  if (n_old < 1 || n_c < 1 || n_old > INT32_MAX - 1 || n_c > INT32_MAX - 1
      || ndim < 1 || ndim > 3)
    return (int)cudaErrorInvalidValue;
  const Geometry g = {{lo0, lo1, lo2}, {hi0, hi1, hi2}, {d0, d1, d2}};
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 1)
    return launch<1>(new_keys, n, old_keys, (int)n_old, coarse_keys,
                     (int)n_c, g, pos, kept, f_cell, nb, s);
  if (ndim == 2)
    return launch<2>(new_keys, n, old_keys, (int)n_old, coarse_keys,
                     (int)n_c, g, pos, kept, f_cell, nb, s);
  return launch<3>(new_keys, n, old_keys, (int)n_old, coarse_keys, (int)n_c,
                   g, pos, kept, f_cell, nb, s);
}

// 1 where a call with these key counts stages the old and coarse keys
// whole in shared memory, 0 where it reads them through L1
extern "C" int ramses_regrid_maps_staged(long long n_old, long long n_c) {
  return ramses_regrid::staged(n_old, n_c) ? 1 : 0;
}

// an empty kernel on `blocks` blocks of K7's width: the device time of a
// launch that does nothing, the floor under K7's small shapes
extern "C" int ramses_regrid_empty(long long blocks, void* stream) {
  using namespace ramses_regrid;
  const dim3 grid((unsigned)blocks), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  regrid_empty_kernel<<<grid, block, 0, s>>>();
  return (int)cudaGetLastError();
}
