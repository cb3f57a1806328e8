"""Fortran sequential-unformatted record I/O.

Every ``write(ilun) data`` of the reference produces
``<int32 nbytes> <payload> <int32 nbytes>``; the whole snapshot format
(``amr/output_amr.f90:268-316``, ``hydro/output_hydro.f90:54-65``) is a
concatenation of such records.  This module is the byte-level substrate for
:mod:`ramses_tpu_torch.io.snapshot` and the restart reader: the port's own
copy of ``ramses_tpu/io/fortran.py``.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

_MARK = struct.Struct("<i")


def write_record(f: BinaryIO, *arrays) -> None:
    """Write one record whose payload is the given arrays concatenated.

    Mixed payloads (e.g. ``write(ilun) noutput, iout, ifout``) pass several
    scalars/arrays; each is converted with its own dtype preserved.
    """
    parts = []
    for a in arrays:
        if isinstance(a, bytes):
            parts.append(a)
        else:
            parts.append(np.ascontiguousarray(a).tobytes())
    payload = b"".join(parts)
    f.write(_MARK.pack(len(payload)))
    f.write(payload)
    f.write(_MARK.pack(len(payload)))


def write_ints(f: BinaryIO, *vals, dtype=np.int32) -> None:
    write_record(f, np.asarray(vals, dtype=dtype))


def write_reals(f: BinaryIO, *vals) -> None:
    write_record(f, np.asarray(vals, dtype=np.float64))


def write_str(f: BinaryIO, s: str, width: int) -> None:
    """character(len=width) record, blank-padded (Fortran semantics)."""
    write_record(f, s.encode("ascii")[:width].ljust(width))


def read_record(f: BinaryIO) -> bytes:
    head = f.read(4)
    if len(head) < 4:
        raise EOFError("end of Fortran record stream")
    (n,) = _MARK.unpack(head)
    payload = f.read(n)
    (tail,) = _MARK.unpack(f.read(4))
    if tail != n:
        raise IOError(f"record marker mismatch: {n} != {tail}")
    return payload


def read_array(f: BinaryIO, dtype) -> np.ndarray:
    return np.frombuffer(read_record(f), dtype=dtype)


def read_ints(f: BinaryIO, dtype=np.int32) -> np.ndarray:
    return read_array(f, dtype)


def read_int(f: BinaryIO) -> int:
    return int(read_array(f, np.int32)[0])


def read_reals(f: BinaryIO) -> np.ndarray:
    return read_array(f, np.float64)


def read_str(f: BinaryIO) -> str:
    return read_record(f).decode("ascii").rstrip()


def skip_record(f: BinaryIO) -> int:
    """Skip one record without decoding; returns payload byte count."""
    (n,) = _MARK.unpack(f.read(4))
    f.seek(n + 4, 1)
    return n
