"""Asynchronous (background-thread) snapshot writing.

The port's own copy of ``ramses_tpu/io/async_writer.py``.

The reference dedicates MPI ranks to I/O so compute ranks hand off
their dump and keep stepping.  The single-process equivalent: the
host-side snapshot assembly happens synchronously (it reads live
device state), then the byte-level file writing — the slow, purely
host-bound part — runs on a daemon worker thread while the simulation
continues.  One worker serializes writes (the reference throttles
concurrent writers the same way, &OUTPUT_PARAMS IOGROUPSIZE).

Usage::

    dumper = AsyncDumper()
    dumper.submit(snap, iout, base_dir)       # returns immediately
    ...
    dumper.wait()                             # barrier (end of run)

Failures are captured and re-raised on :meth:`wait` (or logged on the
next submit) instead of killing the compute thread.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional


class AsyncDumper:
    """One background writer thread draining a dump queue."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run,
                                            daemon=True,
                                            name="ramses-io-writer")
            self._thread.start()
            # interpreter exit must not kill a half-written snapshot:
            # drain the queue before teardown even when the caller
            # forgot wait() (the reference's pario ranks block in
            # MPI_FINALIZE the same way)
            import atexit
            atexit.register(self._drain_at_exit)

    def _drain_at_exit(self):
        try:
            self._q.join()
        except Exception:
            pass

    def _run(self):
        from ramses_tpu_torch.io import snapshot as snapmod
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            snap, iout, base_dir, kwargs = item
            try:
                snapmod.dump_all(snap, iout, base_dir, **kwargs)
            except BaseException as e:       # noqa: BLE001 — report later
                with self._lock:
                    self._errors.append(e)
            finally:
                self._q.task_done()

    def submit(self, snap, iout: int, base_dir: str, **kwargs):
        """Queue one snapshot for background writing.  ``snap`` must be
        fully host-resident (``snapshot_from_*`` already fetched
        everything), so the live simulation state can keep mutating."""
        self._raise_pending()
        self._ensure_thread()
        self._q.put((snap, iout, base_dir, kwargs))

    @property
    def pending(self) -> int:
        return self._q.unfinished_tasks

    def _raise_pending(self):
        with self._lock:
            if self._errors:
                e = self._errors[0]
                self._errors.clear()
                raise RuntimeError("async snapshot write failed") from e

    def wait(self):
        """Block until every queued dump is on disk; re-raise the first
        captured writer error."""
        self._q.join()
        self._raise_pending()

    def drain(self) -> List[BaseException]:
        """Block until every queued dump is on disk and RETURN (not
        raise) the captured writer errors — the stop-path variant for
        OpsGuard's SIGTERM/walltime handling, where an I/O failure must
        be reported in the run footer but must not pre-empt the clean
        shutdown itself."""
        try:
            self._q.join()
        except Exception:
            pass
        with self._lock:
            errs = list(self._errors)
            self._errors.clear()
        return errs

    def close(self):
        self.wait()
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=30)
