"""The port's examples (``examples/torch_*.py``) and mapping benchmark
(``scripts/torch_map_warm.py``) against their JAX twins, on the CPU.

Each example's ``main()`` runs at a tiny size with ``--device cpu`` and
must print the same hits, scores, alignment strings and SAM records as its
JAX twin on the same seed (its timed lines aside). The protein twin has
no size variables, so it runs from its own source with its two sizes cut
to the port's. Tolerance: exact equality of every answer line.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _load(rel: str, name: str = None):
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(name or path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stable(text: str) -> list:
    """An example's output without its timed lines."""
    return [ln for ln in text.splitlines()
            if not ln.startswith(("searched ", "(first call"))
            and " cold " not in ln]


def _run(capsys, main, *args) -> list:
    capsys.readouterr()
    rc = main(*args)
    assert rc in (0, None)
    return _stable(capsys.readouterr().out)


@pytest.mark.parametrize("B, size", [(8, 64), (5, 40)])
def test_batch_pairs_matches_jax(capsys, monkeypatch, B, size):
    ours = _run(capsys, _load("examples/torch_batch_pairs.py").main,
                [str(B), str(size), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["batch_pairs.py", str(B), str(size)])
    theirs = _run(capsys, _load("examples/batch_pairs.py", "j_bp").main)
    assert len(ours) == 5 and ours == theirs
    assert ours[0].startswith("  pair   3:")


def test_read_mapping_matches_jax(capsys, monkeypatch):
    monkeypatch.setenv("SWTPU_DEMO_REF", "9600")
    monkeypatch.setenv("SWTPU_DEMO_READS", "10")
    ours = _run(capsys, _load("examples/torch_read_mapping.py").main,
                ["--device", "cpu"])
    theirs = _run(capsys, _load("examples/read_mapping.py", "j_rm").main)
    # three hits (score line and two strings), the SAM text, the map line
    assert ours == theirs
    assert sum(": score " in ln for ln in ours) == 3
    assert sum("\t" in ln and ln.startswith("read") for ln in ours) == 3
    assert any(ln.startswith("@SQ\tSN:chr_demo\tLN:9600") for ln in ours)
    assert ours[-1].startswith("paired-end map_reads: 4 records")


def _jax_protein_main(db_len: int, n_queries: int):
    """The JAX twin's own source with its database and query counts cut."""
    src = (REPO / "examples/protein_search.py").read_text()
    assert src.count("100_000") == 1 and src.count("range(200)") == 1
    src = src.replace("100_000", str(db_len)).replace(
        "range(200)", f"range({n_queries})")
    ns = {"__file__": str(REPO / "examples/protein_search.py"),
          "__name__": "j_ps"}
    exec(compile(src, "examples/protein_search.py", "exec"), ns)
    return ns["main"]


@pytest.mark.parametrize("db_len, n_queries", [(3000, 20), (1500, 6)])
def test_protein_search_matches_jax(capsys, monkeypatch, db_len, n_queries):
    monkeypatch.setenv("SWTPU_DEMO_DB", str(db_len))
    monkeypatch.setenv("SWTPU_DEMO_QUERIES", str(n_queries))
    ours = _run(capsys, _load("examples/torch_protein_search.py").main,
                ["--device", "cpu"])
    theirs = _run(capsys, _jax_protein_main(db_len, n_queries))
    assert ours == theirs
    assert ours[0].startswith("best hit: query")
    assert ours[-1] == "traceback re-score: OK"


def test_protein_search_defaults_are_the_twins():
    src = (REPO / "examples/torch_protein_search.py").read_text()
    assert '"SWTPU_DEMO_DB", 100_000' in src
    assert '"SWTPU_DEMO_QUERIES", 200' in src


@pytest.mark.parametrize("rel", ["examples/torch_batch_pairs.py",
                                 "examples/torch_read_mapping.py",
                                 "examples/torch_protein_search.py",
                                 "scripts/torch_map_warm.py"])
def test_device_defaults_to_cuda(rel):
    """``--device`` defaults to the card, which raises where there is
    none; it never carries on on the CPU unasked."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = _load(rel)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["8", "64"] if "batch" in rel else [])


def _jax_workload():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        return importlib.import_module("tpu_round4").synth_mapping_workload
    finally:
        sys.path.remove(str(REPO / "scripts"))


@pytest.mark.parametrize("L, B, qlen", [(5000, 6, 100), (20000, 30, 80)])
def test_map_workload_is_the_jax_one(L, B, qlen):
    ours = _load("scripts/torch_map_warm.py").synth_mapping_workload(L, B,
                                                                     qlen)
    theirs = _jax_workload()(L, B, qlen)
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert len(ours[1]) == len(theirs[1]) == B
    for x, y in zip(ours[1], theirs[1]):
        np.testing.assert_array_equal(x, y)


def test_map_warm_writes_its_line(tmp_path, capsys, monkeypatch):
    from swtpu.dist.mapping import map_reads as j_map_reads
    mod = _load("scripts/torch_map_warm.py")
    monkeypatch.setattr(mod, "L", 5000)
    monkeypatch.setattr(mod, "B", 6)
    out = tmp_path / "map.json"
    got = mod.main(["--device", "cpu", "--out", str(out)])
    line = capsys.readouterr().out.strip()
    assert json.loads(line) == got == json.loads(out.read_text())
    assert got["device"] == "cpu" and got["B"] == 6 and got["L"] == 5000
    ref, reads = mod.synth_mapping_workload(5000, 6, 100)
    want = sum(1 for r in j_map_reads(ref, reads).records
               if not r.is_unmapped)
    assert got["mapped"] == want
    assert got["cold_s"] > 0 and got["warm_s"] > 0
    assert not (REPO / "bench_results" / "map_torch_warm.json").exists()
