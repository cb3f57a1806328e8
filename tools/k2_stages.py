#!/usr/bin/env python3
"""Where K2's time goes on the card: the oct sweep cut after each stage.

    python3 tools/k2_stages.py [--n 512,1024,2048] [--octs 2,4,6,8,12,16]

Builds ``ramses_tpu_torch/csrc/oct_muscl.cu`` four times with ``nvcc``
into ``ramses_tpu_torch/_build/k2_stages/``: whole, and with K2's kernel
(``oct_sweep_kernel``) returning after the barrier that ends its stage 1,
2 or 3.  Each is timed (device ms a launch, ``chip_smoke._device_ms``) on
random octs (sedov-like state, 15 % refined) at each N and each count of
octs a block, beside the count the launch chooses; a stage's time is the
difference of two cuts.  K3 at shift 0 on the same octs laid out
tile-major is timed at chunks of 1 and 2 planes beside them.  Needs one
CUDA device; prints the card's name and power limit, then one line an N.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CUTS = ("s1", "s2", "s3")          # return after stage 1, 2, 3


def _variants(src: str) -> dict:
    """The source whole and cut after each of K2's three barriers.  The
    kernel's body must hold exactly three, each followed by the comment
    that opens the next stage (``// 2.``, ``// 3.``, ``// 4.``); a kernel
    laid out otherwise raises rather than cut elsewhere."""
    k2 = src.index("oct_sweep_kernel(const float*")
    end = src.index("// ---- host side")
    body = src[k2:end]
    marks = [m.end() for m in re.finditer(r"__syncthreads\(\);", body)]
    if len(marks) != len(CUTS):
        raise RuntimeError(f"oct_sweep_kernel has {len(marks)} barriers, "
                           f"not {len(CUTS)}: the stage cuts need updating")
    for i, pos in enumerate(marks):
        if not body[pos:].lstrip().startswith(f"// {i + 2}."):
            raise RuntimeError(f"oct_sweep_kernel's barrier {i + 1} is not "
                               f"followed by stage {i + 2}'s comment")
    out = {"whole": src}
    for name, pos in zip(CUTS, marks):
        at = k2 + pos
        out[name] = src[:at] + "\n  if (k.fac == 0.0f) return;\n" + src[at:]
    return out


def _build(out_dir: str, name: str, text: str) -> str:
    from ramses_tpu_torch import kernels
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, f"lib{name}.so")
    r = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I",
                        str(kernels.CSRC), "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on the {name} cut:\n{r.stdout}"
                           f"{r.stderr}")
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", default="512,1024,2048")
    ap.add_argument("--octs", default="2,4,6,8,12,16")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k2_stages: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ramses_tpu_torch import kernels
    from ramses_tpu_torch.hydro import oct_muscl as om
    from ramses_tpu_torch.hydro.core import HydroStatic

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = os.path.join(str(kernels.BUILD_DIR), "k2_stages")
    os.makedirs(out_dir, exist_ok=True)
    src = (kernels.CSRC / "oct_muscl.cu").read_text()
    with cf.ThreadPoolExecutor(len(CUTS) + 1) as ex:
        jobs = {name: ex.submit(_build, out_dir, name, text)
                for name, text in _variants(src).items()}
        libs = {name: om.bind(ctypes.CDLL(j.result()))
                for name, j in jobs.items()}
    cfg = HydroStatic(ndim=3, riemann="llf", slope_type=1)
    dt = torch.tensor(1e-4, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for n in (int(x) for x in args.n.split(",")):
        u = torch.from_numpy(cs._random_state((6, 6, 6, n), cfg.gamma,
                                              n)).cuda()
        ok = torch.from_numpy((np.random.default_rng(n).random(
            (6, 6, 6, n)) < 0.15).astype(np.float32)).cuda()
        info = om.launch_info(None, n, "llf", lib=libs["whole"])
        parts = [f"N {n}: the launch takes {info['chunk']} octs a block "
                 f"({info['registers']} registers)"]
        for b in (int(x) for x in args.octs.split(",")):
            ms = []
            for name, lib in libs.items():
                def run(lib=lib, b=b):
                    return om.call(lib, u, ok, dt, cfg, 1 / 64, None, False,
                                   stream, chunk=b)
                ms.append(f"{name} {cs._device_ms(run, 'sweep_kernel'):.4f}")
            bps = om.launch_info(None, n, "llf", b,
                                 lib=libs["whole"])["blocks_per_sm"]
            parts.append(f"{b} octs ({bps}/SM): " + " ".join(ms))
        ut, okt = u.movedim(-1, 1).contiguous(), ok.movedim(-1, 0).contiguous()
        for cx in (1, 2):
            def run(cx=cx):
                return om.call(libs["whole"], ut, okt, dt, cfg, 1 / 64, 0,
                               False, stream, chunk=cx)
            parts.append(f"K3 at shift 0, chunk {cx}: "
                         f"{cs._device_ms(run, 'sweep_kernel'):.4f}")
        print("; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
