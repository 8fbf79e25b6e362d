#!/usr/bin/env python3
"""Compare the SASS of the stripe template's instantiations between two
checkouts of swtpu_torch, on a machine with the CUDA toolkit.

    python3 scripts/torch_sass_diff.py OLD_CHECKOUT [NEW_CHECKOUT]

Compiles each source of ``swtpu_torch/csrc`` that instantiates the stripe
template (``stripe_fill.cu``, ``stripe_block.cu``, ``pairs_fill.cu``,
``window_fill.cu``, ``sanitize_fill.cu``) and that the old checkout has, in both checkouts, to
cubins for sm_90a with the port's flags, disassembles them with
``cuobjdump -sass`` and, for every instantiation of ``stripe_kernel`` the
old checkout has, prints its instruction count and the number of SASS
lines that differ from the new checkout's instantiation of the same flags
(the new template's added flags off). Exits 1 when any differ.
NEW_CHECKOUT defaults to this script's checkout.
"""

from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
SOURCES = ("stripe_fill.cu", "stripe_block.cu", "pairs_fill.cu",
           "window_fill.cu", "sanitize_fill.cu")
NAME = re.compile(r"Function : (\S*stripe_kernelI((?:Lb\dE)+)E\S*)")


def sass(checkout: Path, src: str, tmp: str, nvcc: str) -> dict:
    """{template flags: SASS lines} of one source of one checkout."""
    cubin = os.path.join(tmp, f"{abs(hash(str(checkout)))}_{src}.cubin")
    subprocess.run([nvcc, *FLAGS, "-cubin", "-o", cubin,
                    str(checkout / "swtpu_torch" / "csrc" / src)], check=True)
    text = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           cubin], check=True, capture_output=True,
                          text=True).stdout
    out, key = {}, None
    for ln in text.splitlines():
        got = NAME.search(ln)
        if got:
            key = tuple(int(f) for f in re.findall(r"Lb(\d)E", got.group(2)))
            out[key] = []
        elif "Function :" in ln:
            key = None
        elif key is not None and ln.strip():
            out[key].append(ln.strip())
    return out


def main() -> int:
    old = Path(sys.argv[1]).resolve()
    new = (Path(sys.argv[2]) if len(sys.argv) > 2
           else Path(__file__).resolve().parent.parent).resolve()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            if not (old / "swtpu_torch" / "csrc" / src).exists():
                continue
            was, now = sass(old, src, tmp, nvcc), sass(new, src, tmp, nvcc)
            for flags, lines in sorted(was.items()):
                twin = flags + (0,) * (max(map(len, now)) - len(flags))
                got = now.get(twin)
                if got is None:
                    print(f"{src} {flags}: missing in the new checkout")
                    differ += 1
                    continue
                n = sum(1 for d in difflib.unified_diff(lines, got,
                                                        lineterm="", n=0)
                        if d[:1] in "+-" and d[:3] not in ("+++", "---"))
                instr = sum(1 for x in lines if x.startswith("/*") and ";"
                            in x)
                print(f"{src} stripe_kernel{list(flags)}: {instr} "
                      f"instructions, {n} SASS lines differ")
                differ += n > 0
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
