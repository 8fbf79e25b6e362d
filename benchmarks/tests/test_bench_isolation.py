"""What a run loads: neither JAX nor the JAX package, by whole top-level
names; and the reference loads nothing of the program."""

import ast
import subprocess
import sys

from small import ROOT

RUNNER = """
import sys
sys.path.insert(0, {root!r})
import benchmarks.run, benchmarks.control
from benchmarks.harness import bench, trace, traffic, roofline
import swtpu_torch
for m in {metrics!r}:
    bench.reader(m)
for k in {kinds!r}:
    traffic.kind(k)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_runner_loads_no_jax():
    metrics = sorted(p.stem for p in (ROOT / "benchmarks" / "metrics")
                     .glob("*.py"))
    kinds = sorted(p.stem for p in (ROOT / "benchmarks" / "kinds")
                   .glob("*.py"))
    names = top_level(RUNNER.format(root=str(ROOT), metrics=metrics,
                                    kinds=kinds))
    assert "swtpu_torch" in names and "benchmarks" in names
    assert not names & {"jax", "jaxlib", "flax", "swtpu"}


def test_reference_loads_nothing_of_the_program():
    names = top_level(f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
                      "import benchmarks.reference.sw, "
                      "benchmarks.reference.alignment\n"
                      "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert not names & {"swtpu_torch", "swtpu", "jax", "jaxlib", "flax"}


def test_reference_sources_import_nothing_of_the_program():
    for path in (ROOT / "benchmarks" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in {"swtpu_torch", "swtpu", "jax"}, (
                    path.name, m)
