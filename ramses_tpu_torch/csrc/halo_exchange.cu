// Ring halo exchange between the shards of a mesh (K5), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ramses_tpu/parallel/dma_halo.py::_dma_exchange
// (body _exchange_kernel): every device sends each of its NGHOST-deep
// boundary slabs to a ring neighbour with one async remote copy, all copies
// in flight together, then waits on the receive semaphores.  The contract
// is lax.ppermute's: device dst receives src's operand, bitwise.
//
// Here every shard of the mesh lives on one card, so one launch does the
// data movement of all shards: the host builds a table of copy entries,
// one per (shard, slab), each a 2-level strided copy of `nrows` rows of
// `row_bytes` bytes (row strides `src_stride`, `dst_stride`).  Any slab of
// a contiguous [nvar, X, Y, Z] block cut along one axis is such a copy
// (axis 1: nvar rows of ng*Y*Z values; axis 2: nvar*X rows of ng*Z; axis 3:
// nvar*X*Y rows of ng), so no slab is made contiguous before it goes out,
// and the destination may be a fresh ghost tensor or the ghost region of a
// larger block.  The table travels by value as the kernel's parameter
// (kMaxEntries * 48 B + 8 B < 4 KB), so an exchange adds no host-to-device
// copy and no synchronisation.
//
// Ordering.  The TPU kernel's neighbour barrier and its DMA semaphores
// become stream order: the caller launches this kernel on a side stream
// that waits on an event recorded after the senders' data was written, and
// the consumers wait on an event recorded after it.  A single launch that
// covers every shard needs no barrier inside the kernel.  A version across
// cards would write into its peers' memory (peer access over NVLink) and
// would need a flag or an event per peer instead (ROADMAP A8).
//
// What bounds it on an H100: it is pure data movement, so bytes: each slab
// read once and written once at 3.35 TB/s.  The uniform 256^3 path on 8
// shards moves 16 slabs of [5, 2, 260, 260] f32 a step (43.3 MB, so 86.5 MB
// of traffic, 0.026 ms); the AMR complete level 7 on 8 shards moves 2.6-3.2
// MB per cut axis, about 1-2 us, where the launch's own latency sets the
// time.
//
// What this simple design does about it: blocks walk the entries in order,
// and within an entry the whole grid strides over its vector units.  Each
// entry copies in the widest unit (16, 8, 4, 2 or 1 bytes) that divides
// both addresses, the row length and both row strides, so the big slabs
// move as 16-byte loads and stores and the 8-byte rows of an f32 slab cut
// along the last axis as 8-byte ones.  A unit's row and column come from one
// 64-bit division; staging through shared memory or TMA bulk copies is
// later work, if the times ask for it.

#include <cuda_runtime.h>
#include <stdint.h>

// The table's types have external linkage: the extern "C" launcher takes
// a Table, and a type of an unnamed namespace would make nvcc's front end
// give the launcher internal linkage (no symbol in the library).
namespace ramses_halo {

constexpr int kMaxEntries = 80;
constexpr int kThreads = 256;

struct Entry {
  const char* src;
  char* dst;
  long long nrows;
  long long row_bytes;
  long long src_stride;  // bytes from one row's start to the next
  long long dst_stride;
};

struct Table {
  Entry e[kMaxEntries];
  int n;
};

static_assert(sizeof(Entry) == 48, "Entry must match the ctypes layout");
static_assert(sizeof(Table) <= 4096, "the table rides as a kernel parameter");

}  // namespace ramses_halo

namespace {

using ramses_halo::Entry;
using ramses_halo::Table;
using ramses_halo::kMaxEntries;
using ramses_halo::kThreads;

template <class V>
__device__ __forceinline__ void copy_entry(const Entry& e, long long first,
                                           long long step) {
  const long long per_row = e.row_bytes / (long long)sizeof(V);
  const long long total = e.nrows * per_row;
  for (long long i = first; i < total; i += step) {
    const long long r = i / per_row;
    const long long c = i - r * per_row;
    const V* s = reinterpret_cast<const V*>(e.src + r * e.src_stride) + c;
    V* d = reinterpret_cast<V*>(e.dst + r * e.dst_stride) + c;
    *d = *s;
  }
}

__global__ void __launch_bounds__(kThreads)
halo_exchange_kernel(const Table t) {
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (int k = 0; k < t.n; ++k) {
    const Entry& e = t.e[k];
    const unsigned long long a =
        (unsigned long long)(uintptr_t)e.src |
        (unsigned long long)(uintptr_t)e.dst |
        (unsigned long long)e.row_bytes |
        (unsigned long long)e.src_stride | (unsigned long long)e.dst_stride;
    if ((a & 15) == 0)
      copy_entry<uint4>(e, first, step);
    else if ((a & 7) == 0)
      copy_entry<uint2>(e, first, step);
    else if ((a & 3) == 0)
      copy_entry<unsigned int>(e, first, step);
    else if ((a & 1) == 0)
      copy_entry<unsigned short>(e, first, step);
    else
      copy_entry<unsigned char>(e, first, step);
  }
}

}  // namespace

// The number of copy entries one launch takes.
extern "C" int ramses_halo_max_entries() { return kMaxEntries; }

// table: host memory, table->n entries (0..kMaxEntries); the entries'
// source and destination ranges must not overlap.  Launches `nblocks`
// blocks on `stream` without synchronising; returns cudaGetLastError().
extern "C" int ramses_halo_exchange(const Table* table, int nblocks,
                                    void* stream) {
  if (table->n < 0 || table->n > kMaxEntries || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  if (table->n == 0) return 0;
  dim3 grid(nblocks, 1, 1);
  dim3 block(kThreads, 1, 1);
  cudaStream_t s = (cudaStream_t)stream;
  halo_exchange_kernel<<<grid, block, 0, s>>>(*table);
  return (int)cudaGetLastError();
}
