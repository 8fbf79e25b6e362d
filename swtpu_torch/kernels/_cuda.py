"""Build and bind the CUDA kernels of ``swtpu_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` process
per source, all started together, and linked into one shared library with
a plain C interface, loaded with ctypes at first use and once per process.
The library lands in ``swtpu_torch/build/``, named by a hash of the
sources, headers and flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing is compiled at import time, and a failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / f for f in (
    "stripe_fill.cu", "stripe_block.cu", "walk_p.cu", "pairs_fill.cu",
    "window_fill.cu", "sanitize_fill.cu", "window_warp.cu",
    "stripe_rb.cu", "stripe_rb_p.cu", "stripe_rb_block.cu",
    "stripe_rb_band.cu", "stripe_rb_debug.cu", "stripe_rb_pairs.cu",
    "stripe_rb_pairs_band.cu", "stripe_rb_window.cu", "stripe_rb_packed.cu",
    "stripe_rb_packed_debug.cu"))
HEADERS = tuple(_PKG / "csrc" / f for f in ("stripe_kernel.cuh",
                                            "sw_cell.cuh", "stripe_rb.cuh"))
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the CUDA toolkit's default install prefix, tried after CUDA_HOME,
# CUDA_PATH and PATH
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_ptr = ctypes.c_void_p
_int = ctypes.c_int
# a, b, m, n, match, mismatch, gap, T, sync, bnd, best, right
_LINEAR = [_ptr, _ptr] + [_int] * 6 + [_ptr] * 4
# a, b, m, n, match, mismatch, gap_open, gap_extend, T, sync, bnd, bnd_f,
# best, right
_AFFINE = [_ptr, _ptr] + [_int] * 7 + [_ptr] * 5
# a, b, m, n, sub, A, affine, gap, gap_open, gap_extend, T, sync, bnd,
# bnd_f, best, right
_SUB = [_ptr, _ptr, _int, _int, _ptr] + [_int] * 6 + [_ptr] * 5
ARGTYPES = {}
for _mode, _args in (("linear", _LINEAR), ("affine", _AFFINE),
                     ("sub", _SUB)):
    # each score entry then takes the band and the stream; its fill_p twin
    # takes P before them
    ARGTYPES[f"sw_stripe_score_{_mode}"] = _args + [_int, _ptr]
    ARGTYPES[f"sw_stripe_fill_p_{_mode}"] = _args + [_ptr, _int, _ptr]
# K5: the model, T, local, then the boundaries, the scratch and outputs
# a, b, m, n, match, mismatch, gap, T, local, top, left, sync, bnd, best,
# right, bottom, stream
ARGTYPES["sw_stripe_block_linear"] = [_ptr, _ptr] + [_int] * 7 + [_ptr] * 8
# a, b, m, n, match, mismatch, gap_open, gap_extend, T, local, top, left,
# top_f, left_e, sync, bnd, bnd_f, best, right, right_e, bottom, bottom_f,
# stream
ARGTYPES["sw_stripe_block_affine"] = [_ptr, _ptr] + [_int] * 8 + [_ptr] * 13
# a, b, m, n, sub, A, affine, gap, gap_open, gap_extend, T, local, then as
# the affine entry from top on
ARGTYPES["sw_stripe_block_sub"] = ([_ptr, _ptr, _int, _int, _ptr]
                                   + [_int] * 7 + [_ptr] * 13)
# P, pitch, wn, wm, moves, count, stream: the earlier walk and the
# tile-staged one
ARGTYPES["sw_walk_p"] = [_ptr] + [_int] * 3 + [_ptr] * 3
ARGTYPES["sw_walk_p_tiled"] = ARGTYPES["sw_walk_p"]
# K8: a, b, B, m, n, the model, T, sync, bnd, [bnd_f], best, right, band,
# stream
ARGTYPES["sw_pairs_score_linear"] = ([_ptr, _ptr] + [_int] * 7 + [_ptr] * 4
                                     + [_int, _ptr])
ARGTYPES["sw_pairs_score_affine"] = ([_ptr, _ptr] + [_int] * 8 + [_ptr] * 5
                                     + [_int, _ptr])
# a, b, B, m, n, sub, A, affine, gap, gap_open, gap_extend, T, sync, bnd,
# bnd_f, best, right, band, stream
ARGTYPES["sw_pairs_score_sub"] = ([_ptr, _ptr] + [_int] * 3 + [_ptr]
                                  + [_int] * 6 + [_ptr] * 5 + [_int, _ptr])
# K7: a, b, B, m, n, the model, T, sync, bnd, [bnd_f], row_best, right,
# stream
ARGTYPES["sw_packed_score_linear"] = [_ptr, _ptr] + [_int] * 7 + [_ptr] * 5
ARGTYPES["sw_packed_score_affine"] = [_ptr, _ptr] + [_int] * 8 + [_ptr] * 6
ARGTYPES["sw_packed_score_sub"] = ([_ptr, _ptr] + [_int] * 3 + [_ptr]
                                   + [_int] * 6 + [_ptr] * 6)
# K6: window, reads, B, W, rlen, then as K7 from the model on
for _mode in ("linear", "affine", "sub"):
    ARGTYPES[f"sw_window_score_{_mode}"] = ARGTYPES[f"sw_packed_score_{_mode}"]
# K9: the arguments of the K1-K3 score entry without the band (of the K7
# entry), then h, seen, skew, stream
for _mode, _args in (("linear", _LINEAR), ("affine", _AFFINE),
                     ("sub", _SUB)):
    ARGTYPES[f"sw_sanitize_stripe_{_mode}"] = _args + [_ptr, _ptr, _int, _ptr]
    ARGTYPES[f"sw_sanitize_packed_{_mode}"] = (
        ARGTYPES[f"sw_packed_score_{_mode}"][:-1] + [_ptr, _ptr, _int, _ptr])
# K6 warp per read: window, reads, B, W, rlen, the model, out, stream
ARGTYPES["sw_window_warp_linear"] = [_ptr, _ptr] + [_int] * 6 + [_ptr] * 2
ARGTYPES["sw_window_warp_affine"] = [_ptr, _ptr] + [_int] * 7 + [_ptr] * 2
ARGTYPES["sw_window_warp_sub"] = ([_ptr, _ptr] + [_int] * 3 + [_ptr]
                                  + [_int] * 5 + [_ptr] * 2)
# K1 register-blocked: a, b, m, n, match, mismatch, gap, T, R, C, sync,
# bnd, best, right, stream
ARGTYPES["sw_stripe_rb_linear"] = [_ptr, _ptr] + [_int] * 8 + [_ptr] * 5
# K2: a, b, m, n, match, mismatch, gap_open, gap_extend, T, R, C, sync,
# bnd, bnd_f, best, right, stream
ARGTYPES["sw_stripe_rb_affine"] = [_ptr, _ptr] + [_int] * 9 + [_ptr] * 6
# K3: a, b, m, n, sub, A, affine, gap, gap_open, gap_extend, T, R, C, sync,
# bnd, bnd_f, best, right, stream
ARGTYPES["sw_stripe_rb_sub"] = ([_ptr, _ptr, _int, _int, _ptr] + [_int] * 8
                                + [_ptr] * 6)
# K4 register-blocked: the K1-K3 entry's arguments up to right, then P,
# pitch, stream
for _mode in ("linear", "affine", "sub"):
    ARGTYPES[f"sw_stripe_rb_fill_p_{_mode}"] = (
        ARGTYPES[f"sw_stripe_rb_{_mode}"][:-1] + [_ptr, _int, _ptr])
# K4b register-blocked (the band form): the K1-K3 and K4 entries'
# arguments up to the stream, then the band and the stream
for _mode in ("linear", "affine", "sub"):
    ARGTYPES[f"sw_stripe_rb_band_{_mode}"] = (
        ARGTYPES[f"sw_stripe_rb_{_mode}"][:-1] + [_int, _ptr])
    ARGTYPES[f"sw_stripe_rb_fill_p_band_{_mode}"] = (
        ARGTYPES[f"sw_stripe_rb_fill_p_{_mode}"][:-1] + [_int, _ptr])
# K9 register-blocked (the capture form): the K1-K3 entry's arguments up
# to right, then h, seen, skew, stream
for _mode in ("linear", "affine", "sub"):
    ARGTYPES[f"sw_sanitize_rb_{_mode}"] = (
        ARGTYPES[f"sw_stripe_rb_{_mode}"][:-1] + [_ptr, _ptr, _int, _ptr])
# K8 register-blocked (the batch form): a, b, B, m, n, the model, T, R, C,
# sync, bnd, [bnd_f], best, stream
ARGTYPES["sw_pairs_rb_linear"] = [_ptr, _ptr] + [_int] * 9 + [_ptr] * 4
ARGTYPES["sw_pairs_rb_affine"] = [_ptr, _ptr] + [_int] * 10 + [_ptr] * 5
ARGTYPES["sw_pairs_rb_sub"] = ([_ptr, _ptr] + [_int] * 3 + [_ptr]
                               + [_int] * 8 + [_ptr] * 5)
for _mode in ("linear", "affine", "sub"):
    # K8[band] register-blocked (the batch form with the band): the K8
    # entry's arguments up to the stream, then the band and the stream
    ARGTYPES[f"sw_pairs_rb_band_{_mode}"] = (
        ARGTYPES[f"sw_pairs_rb_{_mode}"][:-1] + [_int, _ptr])
    # K6 register-blocked (the batch form with one shared window): window,
    # reads, B, W, rlen, then as the K8 entry from the model on
    ARGTYPES[f"sw_window_rb_{_mode}"] = ARGTYPES[f"sw_pairs_rb_{_mode}"]
    # K7 register-blocked (the packed form): the K8 entry's arguments, with
    # row_best for best
    ARGTYPES[f"sw_packed_rb_{_mode}"] = ARGTYPES[f"sw_pairs_rb_{_mode}"]
    # the packed K9 register-blocked (its capture): the K7 entry's
    # arguments up to row_best, then h, seen, skew, stream
    ARGTYPES[f"sw_sanitize_packed_rb_{_mode}"] = (
        ARGTYPES[f"sw_pairs_rb_{_mode}"][:-1] + [_ptr, _ptr, _int, _ptr])
# K5 register-blocked: the template's K5 entry's arguments with R, C after
# T: a, b, m, n, the model, T, R, C, local, then as the template's
ARGTYPES["sw_stripe_rb_block_linear"] = [_ptr, _ptr] + [_int] * 9 + [_ptr] * 8
ARGTYPES["sw_stripe_rb_block_affine"] = ([_ptr, _ptr] + [_int] * 10
                                         + [_ptr] * 13)
ARGTYPES["sw_stripe_rb_block_sub"] = ([_ptr, _ptr, _int, _int, _ptr]
                                      + [_int] * 9 + [_ptr] * 13)


@dataclasses.dataclass
class BuildInfo:
    """What the first ``library()`` call of this process did."""
    path: Optional[Path] = None
    seconds: float = 0.0        # 0 when an existing library was loaded
    log: str = ""               # nvcc's output (ptxas register counts)


BUILD = BuildInfo()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """The nvcc to build with, or RuntimeError naming where it looked."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    cands = [str(Path(h) / "bin" / "nvcc") for h in homes if h]
    cands.append(shutil.which("nvcc"))
    cands.append(str(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc"))
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build the swtpu_torch CUDA kernels: nvcc not found "
        "(looked in $CUDA_HOME/bin, $CUDA_PATH/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: str) -> str:
    """Compile every source to an object in ``out_dir`` at once, link them
    into ``out_dir/lib.so``; return nvcc's output. Raises on a failure."""
    procs = []
    for src in SOURCES:
        obj = os.path.join(out_dir, src.stem + ".o")
        procs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj}: nvcc failed ({proc.returncode})")
    if failed:
        raise RuntimeError("\n".join(failed + log))
    lib = os.path.join(out_dir, "lib.so")
    proc = subprocess.run([nvcc, "-shared", "-o", lib,
                           *(obj for obj, _ in procs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return "".join(log)


def library() -> ctypes.CDLL:
    """The kernel library, built from the repository's sources on first
    use. Raises RuntimeError when nvcc is missing or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    path = BUILD_DIR / f"libswtpu_torch_{_digest()}.so"
    if not path.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build in a temporary directory and rename, so a concurrent
        # process never loads a half-written library
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            log = _compile(nvcc, tmp)
            os.replace(os.path.join(tmp, "lib.so"), path)
        BUILD.seconds = time.perf_counter() - t0
        BUILD.log = log
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sw_error_string.argtypes = [ctypes.c_int]
    lib.sw_error_string.restype = ctypes.c_char_p
    lib.sw_stripe_rb_smem.argtypes = [ctypes.c_int] * 7
    lib.sw_stripe_rb_smem.restype = ctypes.c_longlong
    BUILD.path = path
    _lib = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise when a C entry returned a CUDA error from its launch."""
    if err != 0:
        msg = library().sw_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")
