"""swtpu_torch stands apart from JAX and never quietly leaves the card."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import swtpu_torch
from swtpu_torch.kernels import _cuda

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax_and_no_swtpu():
    code = (
        "import sys\n"
        "import swtpu_torch, swtpu_torch.__main__, swtpu_torch.convert\n"
        "import swtpu_torch.kernels.stripe_fill, swtpu_torch.dispatch.plan\n"
        "import swtpu_torch.dist.batch, swtpu_torch.kernels.pairs_fill\n"
        "import swtpu_torch.dist.database, swtpu_torch.dist.mapping\n"
        "import swtpu_torch.kernels.window_fill, swtpu_torch.core.seqfile\n"
        "import swtpu_torch.instrument.metrics\n"
        "import swtpu_torch.instrument.printers\n"
        "import swtpu_torch.instrument.sanitize\n"
        "import swtpu_torch.kernels.debug_fill\n"
        "import swtpu_torch.dist.mesh, swtpu_torch.dist.pipeline\n"
        "import swtpu_torch.dist.checkpoint, swtpu_torch.dist.dryrun\n"
        "import swtpu_torch.runtime_native, swtpu_torch.kernels._native\n"
        "import swtpu_torch.dispatch.autotune\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'swtpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_importing_the_host_tiers_builds_nothing():
    code = (
        "import swtpu_torch, swtpu_torch.runtime_native as rn\n"
        "import swtpu_torch.dispatch.autotune, swtpu_torch.dispatch.plan\n"
        "from swtpu_torch.kernels import _native, _cuda\n"
        "assert _native._lib is None and _native.BUILD.path is None\n"
        "assert _cuda._lib is None\n"
        "assert rn._simd_probe['ok'] is None\n"
        "print('nothing built')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "nothing built"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


@pytest.mark.parametrize("call", [swtpu_torch.align, swtpu_torch.score,
                                  swtpu_torch.sanitize])
def test_cuda_request_without_a_card_raises(no_card, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call("ACGTACGT", "ACGTTT", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call("ACGTACGT", "ACGTTT")          # 'cuda' is the default


@pytest.mark.parametrize("plan", [None, "host", "stripe"])
@pytest.mark.parametrize("m, n", [(1, 1), (8, 6), (64, 64), (300, 200)])
def test_cuda_request_raises_for_every_pair_size(no_card, plan, m, n):
    """Pairs small enough for the host tiers raise too: the device is
    resolved before any tier is chosen."""
    a, b = np.zeros(m, np.int8), np.ones(n, np.int8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        swtpu_torch.align(a, b, plan=plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        swtpu_torch.score(a, b, plan=plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        swtpu_torch.batch_score(a[None], b[None], plan="host-simd")


@pytest.mark.parametrize("call", [
    swtpu_torch.batch_score, swtpu_torch.batch_align,
    swtpu_torch.score_many, swtpu_torch.align_many])
def test_batch_request_without_a_card_raises(no_card, call):
    aa = np.zeros((2, 8), np.int8)
    bb = np.ones((2, 6), np.int8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(aa, bb)                        # 'cuda' is the default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(aa, bb, device="cuda")


@pytest.mark.parametrize("kw, err, match", [
    # the mesh is ported: what is not a Mesh is refused
    (dict(mesh=object()), TypeError, "must be a swtpu_torch"),
], ids=["mesh"])
def test_unported_batch_routes_raise(kw, err, match):
    aa = np.zeros((2, 8), np.int8)
    for call in (swtpu_torch.batch_score, swtpu_torch.score_many):
        with pytest.raises(err, match=match):
            call(aa, aa, device="cpu", **kw)
    with pytest.raises(err, match=match):
        swtpu_torch.search(aa, aa[0], device="cpu", **kw)
    if "mesh" in kw:
        with pytest.raises(err, match=match):
            swtpu_torch.map_reads(aa[0], [aa[0]], device="cpu", **kw)
        for call in (swtpu_torch.align, swtpu_torch.score):
            with pytest.raises(err, match=match):
                call("ACGT", "ACGT", device="cpu", **kw)


def test_unknown_device_or_plan_raises():
    with pytest.raises(ValueError):
        swtpu_torch.align("ACGT", "ACGT", device="meta")
    with pytest.raises(ValueError, match="unknown plan"):
        swtpu_torch.align("ACGT", "ACGT", plan="bogus", device="cpu")
    # 'pipeline' with no mesh and no process group runs the single-card
    # plans, as the JAX package does on one device
    r = swtpu_torch.align("ACGTACGT", "ACGTTT", plan="pipeline",
                          device="cpu")
    assert r.plan == "scan"
    assert (r.max_score, r.max_i, r.max_j) == (
        swtpu_torch.align("ACGTACGT", "ACGTTT", device="cpu").max_score,
        *divmod(r.max_pos, 9))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.library()
    assert not (tmp_path / "build").exists()
