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
// one per (shard, slab), each a 2-level strided copy of rows of contiguous
// bytes (row strides `src_stride`, `dst_stride`).  Any slab of a contiguous
// [nvar, X, Y, Z] block cut along one axis is such a copy (axis 1: nvar
// rows of ng*Y*Z values; axis 2: nvar*X rows of ng*Z; axis 3: nvar*X*Y rows
// of ng), so no slab is made contiguous before it goes out, and the
// destination may be a fresh ghost tensor or the ghost region of a larger
// block.  The table travels by value as the kernel's parameter
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
// of traffic, 0.026 ms).  The AMR complete level 7 on 8 shards moves 2.6-3.6
// MB per cut axis, ~1 us at the byte bound: about what the card must have
// in flight to reach its bandwidth at all, so the time is set by how many
// loads are in flight at once.  The z exchange's rows are 8 bytes every 256
// bytes, so each row read costs a 32-byte sector (the sectors read put the
// least time at ~5 us there; the byte bound counts the 8 bytes).
//
// What the design does about it: every entry's loads are in flight
// together.  The host gives each entry its own range of blocks, sized from
// its own units (first_block, a prefix over the entries), and sizes the
// grid from the total; a block finds its entry by a binary search over the
// prefix.  Each entry copies in the widest unit (16, 8, 4, 2 or 1 bytes)
// that divides both addresses, the row length and both row strides, chosen
// by the host.  A block covers kThreads * kUnroll consecutive units of its
// entry: each thread issues kUnroll independent loads (units kThreads
// apart) before it stores any, and the lanes of a warp take consecutive
// units, so for rows of one unit (the 8-byte rows of an f32 slab cut along
// the last axis) they take consecutive rows and a packed destination is
// written as one line, and for wide rows consecutive units of a row.  A
// unit's row and column come from one 32-bit division, none for rows of
// one unit.

#include <cuda_runtime.h>
#include <stdint.h>

// The table's types have external linkage: the extern "C" launcher takes
// a Table, and a type of an unnamed namespace would make nvcc's front end
// give the launcher internal linkage (no symbol in the library).
namespace ramses_halo {

constexpr int kMaxEntries = 80;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                      // loads in flight a thread
constexpr int kBlockUnits = kThreads * kUnroll;

struct Entry {
  const char* src;
  char* dst;
  long long src_stride;  // bytes from one row's start to the next
  long long dst_stride;
  int units;             // rows * per_row, below 2^31
  int per_row;           // units a row
  int first_block;       // the entry's first block in the launch
  int lg_unit;           // log2 of the unit's bytes, 0..4
};

struct Table {
  Entry e[kMaxEntries];
  int n;
  int nblocks;  // the launch's blocks: the last entry's end
};

static_assert(sizeof(Entry) == 48, "Entry must match the ctypes layout");
static_assert(sizeof(Table) <= 4096, "the table rides as a kernel parameter");

}  // namespace ramses_halo

namespace {

using ramses_halo::Entry;
using ramses_halo::Table;
using ramses_halo::kBlockUnits;
using ramses_halo::kMaxEntries;
using ramses_halo::kThreads;
using ramses_halo::kUnroll;

// Units first, first + kThreads, ... (kUnroll of them) of entry e: every
// load issued before the first store.
template <class V>
__device__ __forceinline__ void copy_units(const Entry& e, unsigned first) {
  const unsigned units = (unsigned)e.units;
  const unsigned per_row = (unsigned)e.per_row;
  V v[kUnroll];
  V* d[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const unsigned i = first + (unsigned)(j * kThreads);
    d[j] = nullptr;
    if (i < units) {
      const unsigned r = per_row == 1 ? i : i / per_row;
      const unsigned c = i - r * per_row;
      v[j] = *(reinterpret_cast<const V*>(e.src + (long long)r * e.src_stride)
               + c);
      d[j] = reinterpret_cast<V*>(e.dst + (long long)r * e.dst_stride) + c;
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j)
    if (d[j] != nullptr) *d[j] = v[j];
}

__global__ void __launch_bounds__(kThreads)
halo_exchange_kernel(const Table t) {
  // the entry whose block range holds this block
  const int b = (int)blockIdx.x;
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.e[mid].first_block <= b) lo = mid;
    else hi = mid - 1;
  }
  const Entry& e = t.e[lo];
  const unsigned first =
      (unsigned)(b - e.first_block) * (unsigned)kBlockUnits + threadIdx.x;
  switch (e.lg_unit) {
    case 4: copy_units<uint4>(e, first); break;
    case 3: copy_units<uint2>(e, first); break;
    case 2: copy_units<unsigned int>(e, first); break;
    case 1: copy_units<unsigned short>(e, first); break;
    default: copy_units<unsigned char>(e, first); break;
  }
}

}  // namespace

// The number of copy entries one launch takes, and the units a block
// copies (the host's plan sizes each entry's block range from it).
extern "C" int ramses_halo_max_entries() { return kMaxEntries; }
extern "C" int ramses_halo_block_units() { return kBlockUnits; }

// table: host memory, table->n entries (0..kMaxEntries) planned by the
// host; the entries' source and destination ranges must not overlap.
// Launches table->nblocks blocks on `stream` without synchronising;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a table whose
// block ranges do not start at 0 and increase.
extern "C" int ramses_halo_exchange(const Table* table, void* stream) {
  const int n = table->n;
  if (n < 0 || n > kMaxEntries) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (table->e[0].first_block != 0) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n; ++k) {
    const Entry& e = table->e[k];
    const int end = k + 1 < n ? table->e[k + 1].first_block : table->nblocks;
    const long long need = ((long long)e.units + kBlockUnits - 1) / kBlockUnits;
    if (e.units < 1 || e.per_row < 1 || e.lg_unit < 0 || e.lg_unit > 4
        || end - e.first_block != need)
      return (int)cudaErrorInvalidValue;
  }
  dim3 grid(table->nblocks, 1, 1);
  dim3 block(kThreads, 1, 1);
  cudaStream_t s = (cudaStream_t)stream;
  halo_exchange_kernel<<<grid, block, 0, s>>>(*table);
  return (int)cudaGetLastError();
}
