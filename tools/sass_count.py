"""Count the instructions of the port's kernels by pipe, from their SASS.

    python tools/sass_count.py [NAME ...] [--save DIR]     # on the card
    python tools/sass_count.py --sass FILE [FILE ...]      # a saved dump

With names (default ``rt_chem cooling rt_m1``), builds each
``csrc/<name>.cu`` as ``kernels.py`` does, disassembles the library with
``cuobjdump -sass`` (the CUDA toolkit's, next to ``nvcc``) and, with
``--save``, writes the dump to ``DIR/sass_<name>.txt``.  With ``--sass`` it
reads such dumps.  For every kernel entry it prints the static count of the
instructions that issue to each pipe:

* ``f64``: DADD, DMUL, DFMA, DSETP, DSET, DMNMX and the conversions with an
  F64 operand type (F2F, F2I, I2F);
* ``f32``: FADD, FMUL, FFMA, FSETP, FSET, FMNMX, FSEL, FCHK, FRND, FSWZADD
  and the other F2F, F2I, I2F;
* ``mufu``: the special-function unit (MUFU.*);
* ``other``: integer, logic, moves, branches, memory.

and the same counts for every loop (the instructions from a backward
branch's target to the branch; the innermost listed first), so that a
cell's instruction count is the straight-line part plus each loop's body
times its trip count.  The counts are static: a branch that skips
instructions (the rare slow paths of libdevice's pow, exp and division)
is counted as if taken.  With ``--json`` the counts come out as one JSON
object.

    python tools/sass_count.py --sass FILE --walk KERNEL [--take A,..]
        [--fall A,..] [--trips A=N,..] [--cells N]

counts one thread's path through a kernel instead (:func:`walk`: calls
followed, loops run their trip counts, the branches named taken or not,
the others around a slow-path call taken and the rest not), and the least
time ``N`` such paths take on each pipe of an H100 SXM at 1.98 GHz (f64
64, f32 128, the special-function unit 16 instructions an SM a clock, and
the issue of 128 an SM a clock).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

F64_OPS = {"DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX"}
F32_OPS = {"FADD", "FMUL", "FFMA", "FSETP", "FSET", "FMNMX", "FSEL", "FCHK",
           "FRND", "FSWZADD"}
CONVERSIONS = {"F2F", "F2I", "I2F"}
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)"
                  r"([^;]*);")
FUNC = re.compile(r"Function : (\S+)")


def pipe(op: str) -> str:
    """The pipe an opcode (with its modifiers, e.g. ``F2F.F64.F32``)
    issues to."""
    base = op.split(".")[0]
    if base in F64_OPS:
        return "f64"
    if base in F32_OPS:
        return "f32"
    if base in CONVERSIONS:
        return "f64" if "F64" in op else "f32"
    if base == "MUFU":
        return "mufu"
    return "other"


def parse(text: str) -> dict:
    """``{kernel: [(address, opcode, operands), ...]}`` of a cuobjdump
    -sass listing."""
    out, cur = {}, None
    for line in text.splitlines():
        m = FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = LINE.search(line)
        if m and cur is not None:
            guard = (m.group(2) or "").strip()
            cur.append((int(m.group(1), 16), m.group(3),
                        f"{guard} {m.group(4).strip()}".strip()))
    return out


def counts(instrs) -> dict:
    c = {"f64": 0, "f32": 0, "mufu": 0, "other": 0}
    for _, op, _ in instrs:
        c[pipe(op)] += 1
    c["total"] = len(instrs)
    return c


def loops(instrs) -> list:
    """Every backward branch's body: (start, end, counts), innermost
    first."""
    out = []
    for addr, op, args in instrs:
        if op.split(".")[0] != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)\s*$", args)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target <= addr:
            body = [i for i in instrs if target <= i[0] <= addr]
            out.append((target, addr, counts(body)))
    return sorted(out, key=lambda x: x[1] - x[0])


def _target(args: str):
    m = re.search(r"0x([0-9a-f]+)\s*$", args)
    return int(m.group(1), 16) if m else None


def _conditional(args: str) -> bool:
    """A guard (``@P0``) or a predicate operand (``BRA P1, 0x..``)."""
    return args.startswith("@") or bool(re.match(r"!?U?P[0-6],", args))


def walk(instrs, take=(), fall=(), trips=None, limit=10 ** 6):
    """One thread's path through a kernel, counted by pipe: calls are
    followed to their RET; an unconditional branch is taken; a conditional
    branch at an address of ``take`` is taken and at one of ``fall`` falls
    through; a conditional branch back to a lower address (a loop) is
    taken ``trips[addr] - 1`` times in a row, then falls through; any other
    conditional branch is taken where that skips a CALL (a slow path:
    libdevice's division and square root call theirs behind such a
    branch) and falls through elsewhere; a guarded EXIT (the range check)
    falls through.  Returns the counts and the decisions taken."""
    at = {a: k for k, (a, _, _) in enumerate(instrs)}
    trips = dict(trips or {})
    seen = {}
    c = {"f64": 0, "f32": 0, "mufu": 0, "other": 0, "total": 0}
    stack, k, steps, path = [], 0, 0, []
    while k < len(instrs):
        steps += 1
        if steps > limit:
            raise RuntimeError("walk: no end within the step limit")
        a, op, args = instrs[k]
        c[pipe(op)] += 1
        c["total"] += 1
        base = op.split(".")[0]
        if base == "EXIT" and not args.startswith("@"):
            break
        if base == "RET":
            k = stack.pop()
            continue
        if base == "CALL":
            stack.append(k + 1)
            k = at[_target(args)]
            continue
        if base == "BRA":
            t = _target(args)
            if not _conditional(args):
                if t == a:               # the trailing self-loop
                    break
                k = at[t]
                continue
            if a in take:
                go = True
            elif a in fall:
                go = False
            elif t <= a:
                n = seen.get(a, 0) + 1
                go = n < trips.get(a, 1)
                seen[a] = n if go else 0
            else:
                go = any(op2.startswith("CALL")
                         for a2, op2, _ in instrs[k + 1:at[t]])
            path.append((hex(a), go))
            if go:
                k = at[t]
                continue
        k += 1
    return c, path


def demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    proc = subprocess.run([tool], input="\n".join(names), text=True,
                          capture_output=True)
    return dict(zip(names, proc.stdout.splitlines()))


def report(text: str, label: str) -> dict:
    funcs = parse(text)
    names = demangle(list(funcs))
    res = {}
    for f, instrs in funcs.items():
        res[names[f]] = {"static": counts(instrs), "loops": [
            {"from": hex(a), "to": hex(b), **c} for a, b, c in loops(instrs)]}
    for name, r in res.items():
        s = r["static"]
        print(f"{label}: {name}\n  static: f64 {s['f64']}, f32 {s['f32']}, "
              f"mufu {s['mufu']}, other {s['other']}, total {s['total']}")
        for lp in r["loops"]:
            print(f"  loop {lp['from']}-{lp['to']}: f64 {lp['f64']}, f32 "
                  f"{lp['f32']}, mufu {lp['mufu']}, other {lp['other']}, "
                  f"total {lp['total']}")
    return res


# one H100 SXM at its 1.98 GHz boost: thread-instructions a second that
# each pipe (and the four schedulers of an SM together) can take
RATES = {"f64": 64 * 132 * 1.98e9, "f32": 128 * 132 * 1.98e9,
         "mufu": 16 * 132 * 1.98e9, "total": 128 * 132 * 1.98e9}


def _addrs(text):
    return {int(x, 16) for x in text.split(",") if x}


def walk_report(text: str, kernel: str, take, fall, trips, cells: float):
    """The walk of the one kernel whose demangled name starts with
    ``kernel``, and the least ms of ``cells`` such paths on each pipe
    (``total``: the instruction issue)."""
    funcs = parse(text)
    names = demangle(list(funcs))
    hit = [f for f in funcs if names[f].startswith(kernel)]
    if len(hit) != 1:
        raise SystemExit(f"{kernel!r} names {len(hit)} kernels")
    c, path = walk(funcs[hit[0]], take, fall, trips)
    ms = {k: 1e3 * cells * c[k] / RATES[k] for k in RATES}
    print(f"{names[hit[0]]}\n  one path: f64 {c['f64']}, f32 {c['f32']}, "
          f"mufu {c['mufu']}, other {c['other']}, total {c['total']}; "
          f"branches taken at {[a for a, go in path if go]}")
    print(f"  {cells:g} paths: least ms by pipe: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms.items()))
    return c, ms


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "cuobjdump")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--sass", nargs="*", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--walk", help="a kernel's demangled name's start: "
                    "count one thread's path through it (with --sass)")
    ap.add_argument("--take", default="", help="conditional branches to "
                    "take, hex addresses, comma-separated")
    ap.add_argument("--fall", default="", help="conditional branches to "
                    "fall through")
    ap.add_argument("--trips", default="", help="loop back-edges and "
                    "their trip counts, ADDR=N comma-separated")
    ap.add_argument("--cells", type=float, default=1.0,
                    help="paths (threads) for the least-time bounds")
    a = ap.parse_args()
    out = {}
    if a.walk:
        trips = {int(k, 16): int(v) for k, v in
                 (t.split("=") for t in a.trips.split(",") if t)}
        c, ms = walk_report(open(a.sass[0]).read(), a.walk, _addrs(a.take),
                            _addrs(a.fall), trips, a.cells)
        if a.json:
            print(json.dumps({"counts": c, "ms": ms}))
        return 0
    if a.sass is not None:
        for path in a.sass:
            out[os.path.basename(path)] = report(open(path).read(), path)
    else:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from ramses_tpu_torch import kernels
        names = a.names or ["rt_chem", "cooling", "rt_m1"]
        logs = kernels.build(names)
        for name in names:
            for line in logs.get(name, "").splitlines():
                if ("Used" in line or "spill" in line
                        or "Compiling entry" in line):
                    print(f"{name}: {line.strip()}")
        for name in names:
            text = subprocess.run(
                [cuobjdump(), "-sass", str(kernels.library_path(name))],
                capture_output=True, text=True, check=True).stdout
            if a.save:
                os.makedirs(a.save, exist_ok=True)
                with open(os.path.join(a.save, f"sass_{name}.txt"), "w") as f:
                    f.write(text)
            out[name] = report(text, name)
    if a.json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
