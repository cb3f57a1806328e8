// Native host kernels of the tree passes: Morton keys and batched ordered
// lookups, the two host passes that run over every oct of a level at each
// regrid (amr/keys.py encode, amr/tree.py Octree.lookup_keys).
//
// The port's own copy of the JAX package's ramses_native.cpp, cut to the
// entries the port binds (ramses_tpu_torch/native/__init__.py).  The
// arithmetic is the numpy paths' bit for bit: the same spread-mask ladders
// and a lower-bound binary search.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- Morton
static inline uint64_t spread2(uint64_t x) {
    x &= 0xFFFFFFFFull;
    x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
    x = (x | (x << 8))  & 0x00FF00FF00FF00FFull;
    x = (x | (x << 4))  & 0x0F0F0F0F0F0F0F0Full;
    x = (x | (x << 2))  & 0x3333333333333333ull;
    x = (x | (x << 1))  & 0x5555555555555555ull;
    return x;
}

static inline uint64_t spread3(uint64_t x) {
    x &= 0x1FFFFFull;
    x = (x | (x << 32)) & 0x1F00000000FFFFull;
    x = (x | (x << 16)) & 0x1F0000FF0000FFull;
    x = (x | (x << 8))  & 0x100F00F00F00F00Full;
    x = (x | (x << 4))  & 0x10C30C30C30C30C3ull;
    x = (x | (x << 2))  & 0x1249249249249249ull;
    return x;
}

// og: [n, ndim] int64 row-major coords; out: [n] int64 keys
void morton_encode(const int64_t* og, int64_t n, int ndim, int64_t* out) {
    if (ndim == 1) {
        memcpy(out, og, sizeof(int64_t) * (size_t)n);
    } else if (ndim == 2) {
        for (int64_t i = 0; i < n; i++)
            out[i] = (int64_t)(spread2((uint64_t)og[2 * i])
                               | (spread2((uint64_t)og[2 * i + 1]) << 1));
    } else {
        for (int64_t i = 0; i < n; i++)
            out[i] = (int64_t)(spread3((uint64_t)og[3 * i])
                               | (spread3((uint64_t)og[3 * i + 1]) << 1)
                               | (spread3((uint64_t)og[3 * i + 2]) << 2));
    }
}

// ------------------------------------------------------------- searching
// lookup: position where sorted[pos] == q, else -1
void lookup_i64(const int64_t* sorted, int64_t m, const int64_t* q,
                int64_t n, int64_t* out) {
    for (int64_t i = 0; i < n; i++) {
        int64_t lo = 0, hi = m;
        int64_t v = q[i];
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (sorted[mid] < v) lo = mid + 1;
            else hi = mid;
        }
        out[i] = (lo < m && sorted[lo] == v) ? lo : -1;
    }
}

}  // extern "C"
