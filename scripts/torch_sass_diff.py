#!/usr/bin/env python3
"""Compare the SASS of the stripe template's instantiations between two
checkouts of swtpu_torch, on a machine with the CUDA toolkit.

    python3 scripts/torch_sass_diff.py OLD_CHECKOUT [NEW_CHECKOUT]

Compiles each kernel source of ``swtpu_torch/csrc`` (the stripe
template's ``stripe_fill.cu``, ``stripe_block.cu``, ``pairs_fill.cu``,
``window_fill.cu``, ``sanitize_fill.cu``, and ``window_warp.cu``,
``stripe_rb.cu``, ``stripe_rb_p.cu``, ``stripe_rb_block.cu``,
``stripe_rb_band.cu``, ``stripe_rb_debug.cu``, ``stripe_rb_pairs.cu``,
``stripe_rb_pairs_band.cu``, ``stripe_rb_window.cu``,
``stripe_rb_packed.cu``, ``stripe_rb_packed_debug.cu``, ``walk_p.cu``,
``pack_rows.cu``) in
both checkouts, where each has
it, to cubins for sm_90a with the port's flags and disassembles them with
``cuobjdump -sass``. For every kernel the old checkout has, it prints its
instruction count and the number of SASS lines that differ (in their
words: cuobjdump's padding follows the widest line of a cubin) from the new
checkout's kernel of the same name (for an instantiation of
``stripe_kernel``, ``stripe_rb_kernel`` or ``window_warp_kernel``, of the
same template arguments, the new template's added arguments 0 or false;
the walks and the pack kernel by their function's name); then every
kernel of the new checkout that the old lacks, as new. Exits 1 when any
earlier kernel differs or is missing. NEW_CHECKOUT defaults to this
script's checkout.
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
           "window_fill.cu", "sanitize_fill.cu", "window_warp.cu",
           "stripe_rb.cu", "stripe_rb_p.cu", "stripe_rb_block.cu",
           "stripe_rb_band.cu", "stripe_rb_debug.cu", "stripe_rb_pairs.cu",
           "stripe_rb_pairs_band.cu", "stripe_rb_window.cu",
           "stripe_rb_packed.cu", "stripe_rb_packed_debug.cu", "walk_p.cu",
           "pack_rows.cu")
FUNC = re.compile(r"Function : (\S+)")
# a template's name and its integer and bool arguments (the mangled name
# around them holds a hash of the source's path)
NAME = re.compile(r"(stripe_kernel|stripe_rb_kernel|window_warp_kernel)"
                  r"I((?:L[bi]\d+E)+)E")
ARG = re.compile(r"L[bi](\d+)E")
# a kernel that is no template, in the source's anonymous namespace
PLAIN = re.compile(r"\d+(walk_p_kernel|walk_p_tiled_kernel|"
                   r"pack_rows_kernel)E")


def sass(checkout: Path, src: str, tmp: str, nvcc: str) -> dict:
    """{key: SASS lines} of one source of one checkout: an instantiation
    of a template keyed by (its name, its arguments), any other kernel by
    its mangled name."""
    cubin = os.path.join(tmp, f"{abs(hash(str(checkout)))}_{src}.cubin")
    subprocess.run([nvcc, *FLAGS, "-cubin", "-o", cubin,
                    str(checkout / "swtpu_torch" / "csrc" / src)], check=True)
    text = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           cubin], check=True, capture_output=True,
                          text=True).stdout
    out, key = {}, None
    for ln in text.splitlines():
        got = FUNC.search(ln)
        if got:
            tmpl = NAME.search(got.group(1))
            plain = PLAIN.search(got.group(1))
            key = ((tmpl.group(1), tuple(int(v) for v in
                                         ARG.findall(tmpl.group(2))))
                   if tmpl else (plain.group(1), ()) if plain
                   else got.group(1))
            out[key] = []
        elif key is not None and ln.strip():
            # cuobjdump pads an instruction to the widest of its cubin:
            # compare the words alone
            out[key].append(" ".join(ln.split()))
    return out


def instructions(lines: list) -> int:
    return sum(1 for x in lines if x.startswith("/*") and ";" in x)


def main() -> int:
    old = Path(sys.argv[1]).resolve()
    new = (Path(sys.argv[2]) if len(sys.argv) > 2
           else Path(__file__).resolve().parent.parent).resolve()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            now = sass(new, src, tmp, nvcc)
            was = (sass(old, src, tmp, nvcc)
                   if (old / "swtpu_torch" / "csrc" / src).exists() else {})
            width = {}
            for key in now:
                if isinstance(key, tuple):
                    width[key[0]] = max(width.get(key[0], 0), len(key[1]))
            matched = set()
            for key, lines in sorted(was.items(), key=str):
                twin = key
                if isinstance(key, tuple):
                    name, args = key
                    twin = (name, args + (0,) * (width.get(name, 0)
                                                 - len(args)))
                label = (f"{key[0]}{list(key[1])}"
                         if isinstance(key, tuple) else key)
                got = now.get(twin)
                if got is None:
                    print(f"{src} {label}: missing in the new checkout")
                    differ += 1
                    continue
                matched.add(twin)
                n = sum(1 for d in difflib.unified_diff(lines, got,
                                                        lineterm="", n=0)
                        if d[:1] in "+-" and d[:3] not in ("+++", "---"))
                print(f"{src} {label}: {instructions(lines)} "
                      f"instructions, {n} SASS lines differ")
                differ += n > 0
            for key in sorted(set(now) - matched, key=str):
                label = (f"{key[0]}{list(key[1])}"
                         if isinstance(key, tuple) else key)
                print(f"{src} {label}: new, {instructions(now[key])} "
                      "instructions")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
