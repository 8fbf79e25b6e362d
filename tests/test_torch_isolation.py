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
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'swtpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


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


@pytest.mark.parametrize("kw", [dict(plan="host-simd"), dict(mesh=object())],
                         ids=["host_simd", "mesh"])
def test_unported_batch_routes_raise(kw):
    aa = np.zeros((2, 8), np.int8)
    for call in (swtpu_torch.batch_score, swtpu_torch.score_many):
        with pytest.raises(ValueError, match="not ported"):
            call(aa, aa, device="cpu", **kw)
    with pytest.raises(ValueError, match="not ported"):
        swtpu_torch.search(aa, aa[0], device="cpu", **kw)
    if "mesh" in kw:
        with pytest.raises(ValueError, match="not ported"):
            swtpu_torch.map_reads(aa[0], [aa[0]], device="cpu", **kw)


def test_unknown_device_or_plan_raises():
    with pytest.raises(ValueError):
        swtpu_torch.align("ACGT", "ACGT", device="meta")
    with pytest.raises(ValueError, match="unknown plan"):
        swtpu_torch.align("ACGT", "ACGT", plan="pipeline", device="cpu")


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
