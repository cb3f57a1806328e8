"""Fortran-namelist parser.

The port's own copy of ``ramses_tpu/nml.py`` (pure Python; the port
imports nothing of the JAX package).

Runtime configuration in the reference is a Fortran namelist file passed as
the first CLI argument (``amr/read_params.f90:51-70``).  This module parses
that format so every production/test ``.nml`` in the reference's
``namelist/`` and ``tests/`` trees drives this framework unchanged.

Supported syntax (everything the reference's 24 production namelists use):
  * ``&GROUP ... /`` blocks, case-insensitive group & key names
  * scalars: int, float (``1d-3``/``1e-3``/``.5``), ``.true.``/``.false.``,
    quoted strings ('...' or "...")
  * comma-separated value lists, Fortran repeat counts (``10*1``, ``3*1,2``)
  * indexed assignment ``key(3)=...`` (1-based, as in Fortran)
  * ``!`` comments
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple, Union

Scalar = Union[int, float, bool, str]

_GROUP_RE = re.compile(r"&(\w+)")
_KEY_RE = re.compile(r"^\s*(\w+)\s*(?:\(\s*(\d+)\s*\))?\s*=\s*(.*)$", re.S)
_TRUE = (".true.", "t", ".t.")
_FALSE = (".false.", "f", ".f.")


def _strip_comment(line: str) -> str:
    """Remove a trailing ``!`` comment, respecting quoted strings."""
    out = []
    quote = None
    for ch in line:
        if quote:
            out.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            out.append(ch)
        elif ch == "!":
            break
        else:
            out.append(ch)
    return "".join(out)


def _parse_scalar(tok: str) -> Scalar:
    tok = tok.strip()
    if not tok:
        return ""
    if (tok[0] == "'" and tok[-1] == "'") or (tok[0] == '"' and tok[-1] == '"'):
        return tok[1:-1]
    low = tok.lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        # Fortran doubles use d/D as the exponent marker.
        return float(low.replace("d", "e"))
    except ValueError:
        return tok  # bare string (RAMSES allows unquoted strings rarely)


def _split_values(rhs: str) -> List[str]:
    """Split a namelist RHS on commas, respecting quotes."""
    toks, cur, quote = [], [], None
    for ch in rhs:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch == ",":
            toks.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    last = "".join(cur).strip()
    if last:
        toks.append(last)
    return [t for t in toks if t != ""]


def _parse_values(rhs: str) -> List[Scalar]:
    vals: List[Scalar] = []
    for tok in _split_values(rhs):
        m = re.match(r"^(\d+)\*(.+)$", tok)
        if m and "'" not in tok and '"' not in tok:
            vals.extend([_parse_scalar(m.group(2))] * int(m.group(1)))
        else:
            vals.append(_parse_scalar(tok))
    return vals


def parse_nml(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse namelist text into ``{group: {key: scalar | list | {index: v}}}``.

    Indexed assignments are returned as ``{1-based-index: value-list}`` dicts
    so the consumer can densify with its own defaults.
    """
    groups: Dict[str, Dict[str, Any]] = {}
    current: Dict[str, Any] | None = None
    pending_key: Tuple[str, int | None] | None = None

    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if current is None:
            m = _GROUP_RE.match(line)
            if m:
                name = m.group(1).lower()
                current = groups.setdefault(name, {})
                line = line[m.end():].strip()
                if not line:
                    continue
            else:
                continue  # prose outside groups (e.g. header comments)
        # inside a group
        while line:
            if line.startswith("/") or line.lower().startswith("&end"):
                current = None
                pending_key = None
                break
            m = _KEY_RE.match(line)
            if m:
                key = m.group(1).lower()
                idx = int(m.group(2)) if m.group(2) else None
                rhs = m.group(3).strip()
                # a terminating '/' may share the line
                end = False
                if rhs.endswith("/"):
                    rhs, end = rhs[:-1].rstrip(), True
                vals = _parse_values(rhs)
                _store(current, key, idx, vals)
                pending_key = (key, idx)
                if end:
                    current = None
                    pending_key = None
                break
            # continuation line: extra values for the previous key
            if pending_key is not None:
                end = False
                if line.endswith("/"):
                    line, end = line[:-1].rstrip(), True
                if line:
                    key, idx = pending_key
                    _store(current, key, idx, _parse_values(line), extend=True)
                if end:
                    current = None
                    pending_key = None
            break
    return groups


def _store(group: Dict[str, Any], key: str, idx: int | None,
           vals: List[Scalar], extend: bool = False) -> None:
    if idx is not None:
        slot = group.setdefault(key, {})
        if not isinstance(slot, dict):
            slot = {1: slot if isinstance(slot, list) else [slot]}
            group[key] = slot
        if extend and idx in slot:
            slot[idx] = slot[idx] + vals
        else:
            slot[idx] = vals
        return
    if extend and key in group:
        prev = group[key] if isinstance(group[key], list) else [group[key]]
        group[key] = prev + vals
        return
    group[key] = vals[0] if len(vals) == 1 else vals


def load_nml(path: str) -> Dict[str, Dict[str, Any]]:
    with open(path) as f:
        return parse_nml(f.read())


def densify(value: Any, n: int, default: Scalar) -> List[Scalar]:
    """Expand a parsed namelist value into a length-``n`` list.

    Handles scalars, short lists (padded with ``default``), and
    ``{1-based-index: [values]}`` dicts from indexed assignment.
    """
    out: List[Scalar] = [default] * n
    if value is None:
        return out
    if isinstance(value, dict):
        for idx, vals in value.items():
            vlist = vals if isinstance(vals, list) else [vals]
            for j, v in enumerate(vlist):
                if 0 <= idx - 1 + j < n:
                    out[idx - 1 + j] = v
        return out
    if not isinstance(value, list):
        value = [value]
    for j, v in enumerate(value[:n]):
        out[j] = v
    return out
