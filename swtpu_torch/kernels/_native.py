"""Build and bind the native host library of ``swtpu_torch/csrc``.

``csrc/swtpu_native.cpp`` (the host tiers: the serial fill, the walk of P
and the striped SIMD scorers) is compiled with ``g++`` for the host CPU,
with the JAX package's ``csrc/Makefile`` flags (``-O3 -march=native -fPIC
-std=c++17``, and ``-fopenmp`` where a probe shows an OpenMP runtime), into
a shared library with a plain C interface, loaded with ctypes at first use
and once per process. The compiler is ``$CXX``, else ``g++`` on PATH; where
``$CXX`` fails the OpenMP probe and ``g++`` passes it, ``g++`` builds, so
that the batch scorers run on every core (a ``$CXX`` wrapper may lack the
OpenMP runtime's spec file that the system compiler has). Where no compiler
passes the probe the library builds without OpenMP and a RuntimeWarning
says so. The library lands in ``swtpu_torch/build/``, named by a hash of
the source, the compiler, the flags and the host's CPU (its model name and
flags line in ``/proc/cpuinfo``): a ``-march=native`` library built on one
host is never loaded on another, and an edited source is rebuilt. Nothing
is compiled at import time, and a failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "swtpu_native.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")

_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_long, _int, _ptr = ctypes.c_long, ctypes.c_int, ctypes.c_void_p
_i32ref = ctypes.POINTER(ctypes.c_int32)
# the scoring model every fill takes: affine, match, mismatch, gap_open,
# gap_extend, sub, nsym
_MODEL = [_int] * 5 + [_ptr, _int]
# name -> (restype, argtypes)
SIGNATURES = {
    # P, n1, m1, max_pos, path, cap
    "sw_traceback": (_long, [_i8p, _long, _long, _long, _i64p, _long]),
    # a, b, m, n, the model, H, P, out_maxpos
    "sw_fill": (ctypes.c_int32, [_i8p, _i8p, _long, _long, *_MODEL, _i32p,
                                 _i8p, ctypes.POINTER(_long)]),
    # a, b, m, n, the model
    "sw_score_simd": (ctypes.c_int32, [_i8p, _i8p, _long, _long, *_MODEL]),
    # ... then out_i, out_j, out_last
    "sw_score_simd_pos": (ctypes.c_int32, [_i8p, _i8p, _long, _long, *_MODEL,
                                           _i32ref, _i32ref, _i32ref]),
    # a_batch, b_batch, B, m, n, the model, scores, out_i, out_j
    "sw_score_simd_batch": (None, [_i8p, _i8p, _long, _long, _long, *_MODEL,
                                   _i32p, _i32p, _i32p]),
    # the threads of an OpenMP region (1 without OpenMP)
    "sw_omp_max_threads": (_int, []),
    # window, reads, B, m, n, the model, scores, out_i, out_j
    "sw_score_simd_batch1": (None, [_i8p, _i8p, _long, _long, _long, *_MODEL,
                                    _i32p, _i32p, _i32p]),
}


@dataclasses.dataclass
class BuildInfo:
    """What the first ``library()`` call of this process did."""
    path: Optional[Path] = None
    seconds: float = 0.0        # 0 when an existing library was loaded
    cxx: str = ""               # the compiler it was built with
    flags: tuple = ()           # the flags it was built with
    openmp_log: str = ""        # what each failed OpenMP probe printed


BUILD = BuildInfo()
_lib: Optional[ctypes.CDLL] = None


def compilers() -> list:
    """The C++ compilers to build with, in order of preference: $CXX, then
    g++ on PATH (each once, by resolved path); RuntimeError when there is
    none."""
    out = []
    for c in (os.environ.get("CXX"), "g++"):
        path = c and shutil.which(c)
        if path and os.path.realpath(path) not in map(os.path.realpath, out):
            out.append(path)
    if not out:
        raise RuntimeError("cannot build the swtpu_torch host library: no "
                           "C++ compiler ($CXX or g++ on PATH)")
    return out


def choose_compiler() -> tuple:
    """(compiler, flags): the first of ``compilers()`` whose ``-fopenmp``
    probe passes, with ``-fopenmp``; where none passes, the first without
    it, and a RuntimeWarning names each probe's failure."""
    cands = compilers()
    logs = []
    for cxx in cands:
        log = _openmp(cxx)
        if log is None:
            return cxx, CXX_FLAGS + ("-fopenmp",)
        logs.append(f"{cxx}: {log}")
    BUILD.openmp_log = "\n".join(logs)
    warnings.warn("swtpu_torch host library: no compiler builds with "
                  "-fopenmp, so the batch and window scorers run on one "
                  "core:\n" + BUILD.openmp_log, RuntimeWarning, stacklevel=3)
    return cands[0], CXX_FLAGS


def cpu_model() -> str:
    """The host CPU's model name (``/proc/cpuinfo``); where the host
    reports none (or 'unknown'), its vendor, family and model numbers and
    whether it has AVX2 and AVX-512BW; else the platform's string."""
    info = dict(_cpuinfo())
    name = info.get("model name", "")
    if name and name != "unknown":
        return name
    if "vendor_id" in info:
        isa = [x for x in ("avx2", "avx512bw")
               if x in info.get("flags", "").split()]
        return (f"{info['vendor_id']} family {info.get('cpu family')} "
                f"model {info.get('model')} ({', '.join(isa) or 'no AVX2'})")
    return platform.processor() or platform.machine()


def _cpuinfo() -> list:
    """(key, value) of the first processor's block of /proc/cpuinfo."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return []
    out = []
    for line in text.split("\n\n")[0].splitlines():
        key, _, value = line.partition(":")
        out.append((key.strip(), value.strip()))
    return out


def _openmp(cxx: str) -> Optional[str]:
    """Does ``cxx -fopenmp`` build a program here? csrc/Makefile's probe:
    a program on stdin, linked to /dev/null. None when it does, else what
    the probe printed."""
    proc = subprocess.run([cxx, "-fopenmp", "-x", "c++", "-", "-o",
                           os.devnull], input="int main(){return 0;}\n",
                          capture_output=True, text=True, timeout=120)
    if proc.returncode == 0:
        return None
    return (proc.stdout + proc.stderr).strip()[-1000:] or \
        f"exit code {proc.returncode}"


def _digest(flags: tuple, cxx: str = "") -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(os.path.realpath(cxx).encode() if cxx else b"")
    h.update(SOURCE.read_bytes())
    for key, value in _cpuinfo():
        if key in ("model name", "flags"):
            h.update(f"{key}:{value}".encode())
    h.update(platform.machine().encode())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The host library, built from the repository's source on first use.
    Raises RuntimeError when no compiler is found or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    cxx, flags = choose_compiler()
    path = BUILD_DIR / f"libswtpu_native_{_digest(flags, cxx)}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build in a temporary directory and rename, so a concurrent
        # process never loads a half-written library
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, "lib.so")
            proc = subprocess.run([cxx, *flags, "-shared", "-o", out,
                                   str(SOURCE)],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ build of {SOURCE.name} failed "
                                   f"({proc.returncode}):\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(out, path)
        BUILD.seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    BUILD.path, BUILD.cxx, BUILD.flags = path, cxx, flags
    _lib = lib
    return lib
