"""Ring halo exchange between the shards of a mesh (PyTorch): K5.

Port of ``ramses_tpu/parallel/dma_halo.py``.  Every slab-sharded sweep
moves ``NGHOST``-deep boundary slabs between ring neighbours.  The JAX
package spells that ``lax.ppermute`` (portable, blocking) or, on a TPU, a
Pallas kernel of async remote copies (``_dma_exchange``).  Here a mesh is
an ordered list of shards whose tensors all live on one device
(:class:`ramses_tpu_torch.parallel.mesh.ShardMesh`), and the exchange
functions take per-shard lists of tensors and ppermute-style ``(src,
dst)`` pairs: shard ``dst`` receives shard ``src``'s slab.

Two backends with that one contract, bitwise equal (pure data movement):

* ``ppermute``: the plain formulation, one ``clone()`` (or ``copy_``) per
  slab into the destination shard's list;
* ``dma``: every slab of every shard in ONE launch of the hand-written
  kernel ``csrc/halo_exchange.cu`` (:func:`halo_exchange`), its copy table
  passed by value.  On a CPU tensor :func:`halo_exchange` runs the
  kernel's plain version, :func:`halo_exchange_ref`, which walks the same
  table with strided views.

``&AMR_PARAMS halo_backend`` picks one (:func:`resolve_backend`): ``auto``
is ``dma`` on a CUDA device and ``ppermute`` on the CPU; an explicit
``dma`` on the CPU warns once and runs ``ppermute`` (as the JAX package
does without a TPU), unless :data:`FORCE_INTERPRET` is set (the tests), in
which case the kernel's plain version runs.  The callers overlap the
``dma`` exchange with the interior update by running it on a side stream
(:func:`start_exchange`).
"""

from __future__ import annotations

import ctypes
import os
import warnings
from typing import List, Sequence

import torch

# Test hook: run the ``dma`` backend (K5's plain version) on CPU tensors
# too.  Module attribute so tests can monkeypatch it; also settable from
# the environment, as in the JAX package.
FORCE_INTERPRET = bool(os.environ.get("RAMSES_DMA_HALO_INTERPRET"))

# Traffic of the exchanges since the last reset: bytes summed over every
# shard's slabs (one direction), and the number of slabs sent by one
# shard.  ``overlap_frac`` is the share of a shard's cells the last split
# sweep updated while its exchange was in flight.
TRAFFIC = {"bytes": 0, "exchanges": 0, "overlap_frac": 0.0}

# K5 launches since the count was last reset (the main path's proof that it
# ran through the kernel); the plain version does not count.
launches = 0

_warned: set = set()
_side_streams: dict = {}


def traffic_snapshot() -> dict:
    return {"halo_bytes": int(TRAFFIC["bytes"]),
            "halo_exchanges": int(TRAFFIC["exchanges"]),
            "halo_overlap_frac": float(TRAFFIC["overlap_frac"])}


def reset_traffic():
    TRAFFIC.update(bytes=0, exchanges=0, overlap_frac=0.0)


def _count(sends):
    for per_shard in sends:
        TRAFFIC["bytes"] += sum(s.numel() * s.element_size()
                                for s in per_shard)
        TRAFFIC["exchanges"] += 1


def resolve_backend(requested, device) -> str:
    """Map the ``&AMR_PARAMS halo_backend`` knob to a concrete backend for
    shards on ``device``: ``auto`` → ``dma`` on CUDA, ``ppermute`` on the
    CPU; an explicit ``dma`` runs K5 on CUDA (or raises there if it cannot)
    and, on the CPU, warns once and runs ``ppermute`` unless
    :data:`FORCE_INTERPRET` asks for K5's plain version.  Any other value
    than ``auto``, ``dma`` or ``ppermute`` raises ``ValueError``, so that a
    misspelt namelist never puts the plain version on the card."""
    req = str(requested or "auto").lower()
    if req not in ("auto", "dma", "ppermute"):
        raise ValueError(f"unknown halo_backend {requested!r}: expected "
                         "'auto', 'dma' or 'ppermute'")
    cuda = torch.device(device).type == "cuda"
    if req == "auto":
        return "dma" if cuda else "ppermute"
    if req == "dma":
        if cuda or FORCE_INTERPRET:
            return "dma"
        if "dma" not in _warned:
            _warned.add("dma")
            warnings.warn("halo_backend='dma' requested but no CUDA device "
                          "holds the shards: falling back to ppermute")
        return "ppermute"
    return "ppermute"


# ---------------------------------------------------------------------------
# the copy table
# ---------------------------------------------------------------------------

def copy_layout(src: torch.Tensor, dst: torch.Tensor):
    """``(nrows, row, src_stride, dst_stride)`` in elements: ``src`` and
    ``dst`` (same shape and dtype) as ``nrows`` rows of ``row`` contiguous
    elements.  The row is the innermost run that is contiguous in both;
    the dims outside it must collapse to one row stride in each.  Raises
    ``ValueError`` for any other layout (K5 takes 2-level strided copies
    only)."""
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"halo copy: {tuple(src.shape)} {src.dtype} into "
                         f"{tuple(dst.shape)} {dst.dtype}")
    dims = [(n, ss, ds) for n, ss, ds in zip(src.shape, src.stride(),
                                             dst.stride()) if n != 1]
    row, k = 1, len(dims)
    while k and dims[k - 1][1] == row and dims[k - 1][2] == row:
        row *= dims[k - 1][0]
        k -= 1
    if k == 0:
        return 1, row, row, row
    outer = dims[:k]
    for (_, ss, ds), (n1, ss1, ds1) in zip(outer, outer[1:]):
        if ss != ss1 * n1 or ds != ds1 * n1:
            raise ValueError("halo copy: not a 2-level strided slab "
                             f"(shape {tuple(src.shape)}, strides "
                             f"{src.stride()} -> {dst.stride()})")
    nrows = 1
    for n, _, _ in outer:
        nrows *= n
    return nrows, row, outer[-1][1], outer[-1][2]


class _Entry(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("nrows", ctypes.c_longlong), ("row_bytes", ctypes.c_longlong),
                ("src_stride", ctypes.c_longlong),
                ("dst_stride", ctypes.c_longlong)]


MAX_ENTRIES = 80                   # csrc/halo_exchange.cu kMaxEntries


class _Table(ctypes.Structure):
    _fields_ = [("e", _Entry * MAX_ENTRIES), ("n", ctypes.c_int)]


def halo_exchange_ref(pairs):
    """K5's plain version: each ``(src, dst)`` pair copied as the kernel's
    table describes it (:func:`copy_layout`), through strided views."""
    for src, dst in pairs:
        nrows, row, ss, ds = copy_layout(src, dst)
        if nrows * row == 0:
            continue
        d = dst.as_strided((nrows, row), (ds, 1), dst.storage_offset())
        d.copy_(src.as_strided((nrows, row), (ss, 1), src.storage_offset()))


def _library():
    from ramses_tpu_torch import kernels
    return bind(kernels.load("halo_exchange"))


def bind(lib):
    """Declare the C entry points' signatures on a loaded build of
    ``csrc/halo_exchange.cu`` (the tests also load a host build of it)."""
    fn = lib.ramses_halo_exchange
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Table), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ramses_halo_max_entries.restype = ctypes.c_int
    return lib


def call(lib, pairs, stream=None) -> int:
    """The C entry of ``lib`` (a build of ``csrc/halo_exchange.cu`` with
    :func:`bind` applied) over the ``(src, dst)`` pairs, at most
    :data:`MAX_ENTRIES` a launch; returns the number of launches.  Raises on
    an error it returns, and when the build's table size differs."""
    if lib.ramses_halo_max_entries() != MAX_ENTRIES:
        raise RuntimeError("halo_exchange build disagrees on the table size")
    rows = []
    for src, dst in pairs:
        nrows, row, ss, ds = copy_layout(src, dst)
        if nrows * row:
            es = src.element_size()
            rows.append((src.data_ptr(), dst.data_ptr(), nrows, row * es,
                         ss * es if nrows > 1 else row * es,
                         ds * es if nrows > 1 else row * es))
    n = 0
    for i in range(0, len(rows), MAX_ENTRIES):
        chunk = rows[i:i + MAX_ENTRIES]
        table = _Table()
        table.n = len(chunk)
        for j, r in enumerate(chunk):
            table.e[j] = _Entry(*r)
        nbytes = sum(r[2] * r[3] for r in chunk)
        # enough 256-thread blocks for one 16-byte unit each of the largest
        # entry, at most 16 a streaming multiprocessor of an H100
        units = max(r[2] * r[3] for r in chunk) // 16
        nblocks = int(min(max(1, -(-units // 256)), 132 * 16))
        err = lib.ramses_halo_exchange(ctypes.byref(table), nblocks, stream)
        if err:
            raise RuntimeError(f"halo_exchange kernel launch failed "
                               f"(cudaError {err}, {nbytes} bytes)")
        n += 1
    return n


def halo_exchange(pairs):
    """Copy every ``(src, dst)`` pair of tensors: K5 for CUDA tensors, one
    launch for up to :data:`MAX_ENTRIES` pairs on the current stream
    (counted in :data:`launches`); :func:`halo_exchange_ref` for CPU
    tensors.  Every tensor must be on one device; a CUDA tensor launches
    the kernel or raises."""
    global launches
    pairs = list(pairs)
    devs = {t.device for p in pairs for t in p}
    if not devs:
        return
    if len(devs) > 1:
        raise NotImplementedError(
            f"halo exchange across devices {sorted(map(str, devs))}: a ring "
            "over several cards is ROADMAP A8")
    dev = next(iter(devs))
    if dev.type == "cpu":
        halo_exchange_ref(pairs)
        return
    if dev.type != "cuda":
        raise ValueError(f"halo_exchange: tensors on {dev}")
    lib = _library()
    with torch.cuda.device(dev):
        launches += call(lib, pairs,
                         torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# public exchange API (ppermute semantics over per-shard lists)
# ---------------------------------------------------------------------------

def exchange_slabs(sends: Sequence[Sequence[torch.Tensor]],
                   perms: Sequence,
                   backend: str = "ppermute") -> List[List[torch.Tensor]]:
    """``[ppermute(sends[i], perms[i]) for i]`` over per-shard lists:
    ``sends[i][s]`` is shard ``s``'s i-th slab; returns ``recv[i][d]``,
    the slab shard ``d`` receives (a fresh contiguous tensor; None where no
    pair sends to ``d``).  On the ``dma`` backend every slab of every shard
    rides ONE K5 launch."""
    _count(sends)
    recv, pairs = [], []
    for i, perm in enumerate(perms):
        if len({d for _, d in perm}) != len(perm):
            raise ValueError(f"halo perm {perm} sends two slabs to one shard")
        r = [None] * len(sends[i])
        for s, d in perm:
            src = sends[i][s]
            if backend != "dma":
                r[d] = src.clone(memory_format=torch.contiguous_format)
                continue
            r[d] = torch.empty_like(src, memory_format=torch.contiguous_format)
            pairs.append((src, r[d]))
        recv.append(r)
    halo_exchange(pairs)
    return recv


def permute(xs: Sequence[torch.Tensor], perm, backend: str = "ppermute"):
    """``lax.ppermute`` of one slab per shard (the single-direction form)."""
    return exchange_slabs([xs], [perm], backend)[0]


def exchange_pair(lo_sends, hi_sends, fwd, bwd, backend: str = "ppermute"):
    """The halo pair: ``(ppermute(lo_sends, fwd), ppermute(hi_sends,
    bwd))``: each shard's high interior slab becomes its +1 neighbour's low
    ghost and vice versa; both directions share one K5 launch."""
    lo, hi = exchange_slabs([lo_sends, hi_sends], [fwd, bwd], backend)
    return lo, hi


def _side_stream(dev: torch.device):
    key = torch.device(dev.type, dev.index if dev.index is not None
                       else torch.cuda.current_device())
    s = _side_streams.get(key)
    if s is None:
        s = _side_streams[key] = torch.cuda.Stream(key)
    return s


def start_exchange(sends, perms, backend: str):
    """:func:`exchange_slabs` started so that the caller can work while it
    runs.  On CUDA with the ``dma`` backend, K5 runs on a side stream that
    first waits for the current stream (the senders' data is written), and
    ``finish()`` makes the current stream wait for K5 before the ghosts are
    read; both streams' uses are recorded on the tensors, so the caching
    allocator cannot hand a ghost or a source buffer to other work before
    then.  Elsewhere the exchange runs at once and ``finish`` does
    nothing.  Returns ``(recv, finish)``."""
    dev = sends[0][0].device
    if dev.type != "cuda" or backend != "dma":
        recv = exchange_slabs(sends, perms, backend)
        return recv, lambda: None
    cur = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        recv = exchange_slabs(sends, perms, backend)
    for per_shard in sends:
        for t in per_shard:
            t.record_stream(side)
    for per_shard in recv:
        for t in per_shard:
            if t is not None:
                t.record_stream(cur)

    def finish():
        cur.wait_stream(side)
    return recv, finish
