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
//   parents  one thread a cell: the cell's steepest-ascent parent, the
//            neighbour with the largest (rho, flat index) over the periodic
//            3^ndim neighbourhood, itself included (a neighbour at offset o
//            is the cell (i + o) mod n on each axis, as jnp.roll wraps);
//   labels   one thread a cell: -1 where rho > threshold fails, else the
//            root its parents lead to, followed link by link.
//
// The parent relation is a forest under the strict total order of
// (rho, flat index): every link climbs, so the chain from a cell ends at the
// one root that pointer jumping reaches, and a chain from a cell above the
// threshold never leaves the cells above it.  The labels are integers, so
// they equal the plain version's (watershed_ref in ramses_tpu_torch/pm/
// clumps.py) bit for bit; the comparisons are the plain version's, in
// float64 (the deposit's type).
//
// What bounds it on an H100: bytes.  The function reads rho once and writes
// each label once: 16 B a cell in float64.  The parents' 26 neighbour reads
// a cell come from L1 and L2 (neighbouring threads read neighbouring
// cells), and the parent array is scratch (8 B a cell written and read
// again).  The chase's cost grows with the length of the uphill chains:
// short on a noisy deposit, up to a peak's radius in cells on a smooth
// field, each link a dependent load.  The design does nothing beyond one
// thread a cell, 256 a block, rho through the read-only path (__ldg).

#include <cuda_runtime.h>
#include <stdint.h>

namespace ramses_ws {

constexpr int kThreads = 256;

struct Dims {
  long long n[3];          // cells a dim (trailing dims 1)
};

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
    parents_kernel(const double* __restrict__ rho, Dims g, long long ncell,
                   int64_t* __restrict__ parent) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= ncell) return;
  long long c[3];
  long long rem = i;
#pragma unroll
  for (int d = NDIM - 1; d >= 0; d--) {     // C order: the last axis fastest
    c[d] = rem % g.n[d];
    rem /= g.n[d];
  }
  double best = __ldg(rho + i);
  long long best_i = i;
  constexpr int kNb = NDIM == 1 ? 3 : (NDIM == 2 ? 9 : 27);
  // the offsets of itertools.product((-1, 0, 1), repeat=NDIM), the last
  // axis fastest; the order does not change a maximum under a total order
#pragma unroll
  for (int k = 0; k < kNb; k++) {
    long long j = 0;
    bool self = true;
    int kk = k;
    int off[3];
#pragma unroll
    for (int d = NDIM - 1; d >= 0; d--) {
      off[d] = kk % 3 - 1;
      kk /= 3;
      self &= off[d] == 0;
    }
    if (self) continue;
#pragma unroll
    for (int d = 0; d < NDIM; d++) {
      long long x = c[d] + off[d];
      x = x < 0 ? x + g.n[d] : (x >= g.n[d] ? x - g.n[d] : x);
      j = j * g.n[d] + x;
    }
    const double r = __ldg(rho + j);
    if (r > best || (r == best && j > best_i)) {
      best = r;
      best_i = j;
    }
  }
  parent[i] = best_i;
}

__global__ void __launch_bounds__(kThreads)
    labels_kernel(const double* __restrict__ rho, long long ncell,
                  double threshold, const int64_t* __restrict__ parent,
                  int64_t* __restrict__ labels) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= ncell) return;
  if (!(__ldg(rho + i) > threshold)) {
    labels[i] = -1;
    return;
  }
  int64_t p = parent[i];
  for (;;) {
    const int64_t q = parent[p];
    if (q == p) break;
    p = q;
  }
  labels[i] = p;
}

template <int NDIM>
cudaError_t launch(const double* rho, const Dims& g, long long ncell,
                   double threshold, int64_t* parent, int64_t* labels,
                   cudaStream_t s) {
  const dim3 grid((unsigned)((ncell + kThreads - 1) / kThreads)),
      block(kThreads);
  parents_kernel<NDIM><<<grid, block, 0, s>>>(rho, g, ncell, parent);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  labels_kernel<<<grid, block, 0, s>>>(rho, ncell, threshold, parent,
                                       labels);
  return cudaGetLastError();
}

}  // namespace ramses_ws

// rho [n0, n1, n2] contiguous float64, with the trailing dims past ndim 1;
// parent: scratch of n0*n1*n2 int64; labels [n0, n1, n2] int64 out.
// Returns the launches' cudaError_t.
extern "C" int ramses_watershed(const double* rho, long long n0,
                                long long n1, long long n2, int ndim,
                                double threshold, int64_t* parent,
                                int64_t* labels, void* stream) {
  using namespace ramses_ws;
  if (ndim < 1 || ndim > 3 || n0 < 1 || n1 < 1 || n2 < 1)
    return (int)cudaErrorInvalidValue;
  if ((ndim < 3 && n2 != 1) || (ndim < 2 && n1 != 1))
    return (int)cudaErrorInvalidValue;
  const Dims g = {{n0, n1, n2}};
  const long long ncell = n0 * n1 * n2;
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 1)
    return (int)launch<1>(rho, g, ncell, threshold, parent, labels, s);
  if (ndim == 2)
    return (int)launch<2>(rho, g, ncell, threshold, parent, labels, s);
  return (int)launch<3>(rho, g, ncell, threshold, parent, labels, s);
}

