"""Atomic validated checkpoints: manifest + staged rename + scanning.

The port's own copy of ``ramses_tpu/resilience/checkpoint.py`` (pure
Python).  The reference restarts from whatever ``output_NNNNN/`` it finds
(``nrestart>0``); a job killed mid-dump leaves a directory that parses
until a reader hits the truncation.  Here every dump is staged into
``output_NNNNN.tmp/``, every file is fsynced and hashed into a
``manifest.json``, and only then does one ``os.replace`` make the
checkpoint visible — readers either see a complete validated directory
or nothing.  ``validate_checkpoint`` re-checks the manifest against
the bytes on disk, so auto-resume (``resolve_restart_dir``) can skip
bit-rotted or truncated checkpoints with a logged reason instead of
crashing into them.

The port writes no elastic sharded checkpoints (``&OUTPUT_PARAMS pario``
is refused by name, ROADMAP A7), so the writer of their global manifest
and the shard quarantine are not carried over.  A ``pario_NNNNN/``
written by the JAX package still validates here through its ``shards``
table (:func:`validate_shard`), so the scanner ranks it as the JAX
package does; restoring one is refused by name.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

MANIFEST_NAME = "manifest.json"
MANIFEST_SCHEMA = 1


def _fsync_path(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def write_manifest(stage_dir: str, meta: Optional[Dict[str, Any]] = None
                   ) -> str:
    """Hash + size every file under ``stage_dir`` (recursively) into
    ``manifest.json``, fsync it and the directory.  Returns the
    manifest path."""
    files: Dict[str, Dict[str, Any]] = {}
    for root, _dirs, names in os.walk(stage_dir):
        for name in sorted(names):
            if name == MANIFEST_NAME:
                continue
            p = os.path.join(root, name)
            rel = os.path.relpath(p, stage_dir)
            files[rel] = {"size": os.path.getsize(p), "sha256": _sha256(p)}
            _fsync_path(p)
    mpath = os.path.join(stage_dir, MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump({"schema": MANIFEST_SCHEMA,
                   "meta": dict(meta or {}),
                   "files": files}, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(stage_dir)
    return mpath


def finalize_checkpoint(stage_dir: str, final_dir: str,
                        meta: Optional[Dict[str, Any]] = None) -> str:
    """Manifest the staged directory and atomically rename it into
    place.  A pre-existing ``final_dir`` is REMOVED first (replaced,
    never merged — the stale same-iout mixing hazard), and the parent
    directory is fsynced so the rename survives a crash."""
    write_manifest(stage_dir, meta)
    if os.path.isdir(final_dir):
        shutil.rmtree(final_dir)
    os.replace(stage_dir, final_dir)
    parent = os.path.dirname(os.path.abspath(final_dir))
    try:
        _fsync_path(parent)
    except OSError:
        pass                      # e.g. parent on a non-fsyncable mount
    return final_dir


def validate_checkpoint(outdir: str,
                        verify_hash: bool = True) -> Tuple[bool, str]:
    """(ok, reason): does ``outdir`` hold a complete checkpoint whose
    bytes match its manifest?  ``verify_hash=False`` checks existence
    and sizes only (cheap scan mode)."""
    mpath = os.path.join(outdir, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        return False, "no manifest.json (pre-atomic or partial dump)"
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return False, f"unreadable manifest: {e}"
    if man.get("schema") != MANIFEST_SCHEMA:
        return False, f"unknown manifest schema {man.get('schema')!r}"
    files = man.get("files")
    if not isinstance(files, dict):
        return False, "manifest has no file table"
    for rel, ent in files.items():
        p = os.path.join(outdir, rel)
        if not os.path.isfile(p):
            return False, f"missing file {rel}"
        if os.path.getsize(p) != int(ent.get("size", -1)):
            return False, f"size mismatch on {rel}"
        if verify_hash and _sha256(p) != ent.get("sha256"):
            return False, f"checksum mismatch on {rel}"
    shards = man.get("shards")
    if isinstance(shards, dict):
        for name, ent in shards.items():
            ok, reason = validate_shard(outdir, name, ent,
                                        verify_hash=verify_hash)
            if not ok:
                return False, reason
    return True, "ok"


def validate_shard(outdir: str, name: str, ent: Dict[str, Any],
                   verify_hash: bool = True) -> Tuple[bool, str]:
    """(ok, reason) for one shard of an elastic checkpoint: the shard
    dir exists, its manifest is byte-identical to what the global
    commit sealed (always hash-checked — the manifest is tiny), and
    the shard's own file table validates (sizes always; payload hashes
    when ``verify_hash``)."""
    sdir = os.path.join(outdir, name)
    if not os.path.isdir(sdir):
        return False, f"missing shard {name}"
    smpath = os.path.join(sdir, MANIFEST_NAME)
    if not os.path.isfile(smpath):
        return False, f"shard {name} has no manifest"
    if os.path.getsize(smpath) != int(ent.get("manifest_size", -1)) \
            or _sha256(smpath) != ent.get("manifest_sha256"):
        return False, f"shard {name} manifest mismatch"
    ok, reason = validate_checkpoint(sdir, verify_hash=verify_hash)
    if not ok:
        return False, f"shard {name}: {reason}"
    return True, "ok"


def read_manifest_meta(outdir: str) -> Dict[str, Any]:
    """The manifest's ``meta`` block ({} when absent/unreadable)."""
    try:
        with open(os.path.join(outdir, MANIFEST_NAME)) as f:
            return dict(json.load(f).get("meta") or {})
    except (OSError, json.JSONDecodeError):
        return {}


CHECKPOINT_PREFIXES = ("output_", "pario_")


def scan_checkpoints(base_dir: str, log: Optional[Callable] = None,
                     prefix=CHECKPOINT_PREFIXES
                     ) -> List[Tuple[str, Dict[str, Any]]]:
    """Manifest-valid checkpoints under ``base_dir``, newest first by
    (nstep, t, iout) — so an emergency dump (high iout, current step)
    correctly outranks an older scheduled output.  Invalid candidates
    are skipped with a logged reason.  ``prefix`` may be one prefix or
    a tuple; the default covers both snapshot (``output_``) and elastic
    pario (``pario_``) checkpoints — a staged ``pario_NNNNN.tmp``
    fails the all-digits suffix check, so a dump killed mid-commit is
    never a candidate."""
    prefixes = (prefix,) if isinstance(prefix, str) else tuple(prefix)
    try:
        names = sorted(os.listdir(base_dir))
    except OSError:
        return []
    found = []
    for name in names:
        if not any(name.startswith(p) and name[len(p):].isdigit()
                   for p in prefixes):
            continue
        outdir = os.path.join(base_dir, name)
        if not os.path.isdir(outdir):
            continue
        ok, reason = validate_checkpoint(outdir)
        if not ok:
            if log is not None:
                log(f"resilience: skipping {name}: {reason}")
            continue
        meta = read_manifest_meta(outdir)
        found.append((outdir, meta))
    found.sort(key=lambda e: (int(e[1].get("nstep", 0)),
                              float(e[1].get("t", 0.0)),
                              int(e[1].get("iout", 0))),
               reverse=True)
    return found


def latest_valid_checkpoint(base_dir: str,
                            log: Optional[Callable] = print
                            ) -> Optional[str]:
    """Newest manifest-valid ``output_NNNNN``/``pario_NNNNN`` under
    ``base_dir`` (by stored nstep/t, not by directory number), or
    None."""
    found = scan_checkpoints(base_dir, log=log)
    return found[0][0] if found else None


def rotate_checkpoints(base_dir: str, keep: int,
                       protect: Optional[str] = None):
    """Remove the oldest manifest-valid checkpoints beyond ``keep``.
    Only validated checkpoints are rotation candidates — pre-atomic
    output dirs (science products without manifests) are never
    touched.  ``protect`` is exempt regardless of age."""
    if keep <= 0:
        return
    found = scan_checkpoints(base_dir, log=None)
    prot = os.path.abspath(protect) if protect else None
    for outdir, _meta in found[keep:]:
        if prot and os.path.abspath(outdir) == prot:
            continue
        shutil.rmtree(outdir, ignore_errors=True)


def scrub_checkpoints(base_dir: str,
                      log: Optional[Callable] = print
                      ) -> List[Tuple[str, str]]:
    """Quarantine invalid checkpoints under ``base_dir`` by renaming
    them to ``<name>.corrupt`` — used by the run service before a
    resume so a checkpoint that rotted between beats cannot wedge the
    auto-resume scan loop.  Only directories that CARRY a manifest and
    fail validation are touched; pre-atomic science outputs (no
    manifest) are never candidates.  Returns ``[(path, reason), ...]``
    for everything moved."""
    try:
        names = sorted(os.listdir(base_dir))
    except OSError:
        return []
    moved = []
    for name in names:
        if not any(name.startswith(p) and name[len(p):].isdigit()
                   for p in CHECKPOINT_PREFIXES):
            continue
        outdir = os.path.join(base_dir, name)
        if not os.path.isdir(outdir) or not os.path.isfile(
                os.path.join(outdir, MANIFEST_NAME)):
            continue
        ok, reason = validate_checkpoint(outdir)
        if ok:
            continue
        dst = outdir + ".corrupt"
        if os.path.isdir(dst):
            shutil.rmtree(dst, ignore_errors=True)
        os.replace(outdir, dst)
        if log is not None:
            log(f"resilience: scrub quarantined {name}: {reason}")
        moved.append((dst, reason))
    return moved


def resolve_restart_dir(params, base_dir: Optional[str] = None,
                        log: Optional[Callable] = print
                        ) -> Optional[str]:
    """The checkpoint directory a run should restore from, or None for
    a fresh start.

    ``nrestart > 0``: the explicit ``output_NNNNN`` (missing → error;
    a manifest that fails validation → error — restarting from known
    corruption must be loud; a pre-manifest directory passes with a
    warning for backward compatibility).  ``nrestart == -1`` or
    ``auto_resume=.true.``: newest manifest-valid checkpoint, or None
    when there is none yet (first launch of a supervised run)."""
    run = getattr(params, "run", None)
    nrestart = int(getattr(run, "nrestart", 0))
    auto = bool(getattr(run, "auto_resume", False)) or nrestart == -1
    base = base_dir if base_dir is not None else str(
        getattr(getattr(params, "output", None), "output_dir", "."))
    if nrestart > 0:
        outdir = os.path.join(base, f"output_{nrestart:05d}")
        if not os.path.isdir(outdir):
            raise FileNotFoundError(
                f"nrestart={nrestart}: {outdir} does not exist")
        if os.path.isfile(os.path.join(outdir, MANIFEST_NAME)):
            ok, reason = validate_checkpoint(outdir)
            if not ok:
                raise RuntimeError(
                    f"nrestart={nrestart}: {outdir} fails validation "
                    f"({reason}); use nrestart=-1 to auto-select the "
                    "newest valid checkpoint instead")
        elif log is not None:
            log(f"resilience: {outdir} has no manifest (pre-atomic "
                "dump); restoring without validation")
        return outdir
    if auto:
        out = latest_valid_checkpoint(base, log=log)
        if out is not None and log is not None:
            log(f"resilience: auto-resume from {out}")
        return out
    return None
