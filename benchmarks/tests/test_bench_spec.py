"""BENCHMARK.json against the rules its format keeps: names, units, keys,
and every file the runner looks for by name."""

import json
import re

from small import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    assert 1 <= len(s["paths"]) <= 16
    for p in s["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(s["command"]) <= 32
    assert all(line_ok(w) for w in s["command"])
    files = [w for w in s["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in s["paths"])
                         for f in files)


def test_names_and_units_use_allowed_characters():
    s = spec()
    names = ([c["name"] for c in s["configs"]]
             + [w["name"] for w in s["workloads"]]
             + [m["name"] for m in s["end_to_end"] + s["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in s["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in s["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_entries_have_just_their_keys():
    s = spec()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["why"]) and line_ok(c["source"])
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line_ok(w["why"])
    fours = sum(w["chips"] == 4 for w in s["workloads"])
    assert fours <= max(1, len(s["workloads"]) // 4)
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert line_ok(m["layer"])


def test_every_named_file_is_there():
    s = spec()
    files = set()
    for c in s["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] not in files
        files.add(c["file"])
        with open(ROOT / c["file"]) as f:
            assert set(json.load(f)["reduced"]) == set(c["reduced"])
    for w in s["workloads"]:
        mix = ROOT / "benchmarks" / "traffic" / f"{w['traffic']}.json"
        with open(mix) as f:
            kind = json.load(f)["kind"]
        assert (ROOT / "benchmarks" / "kinds" / f"{kind}.py").is_file()
    for c in s["configs"]:
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["precision"] in ("int32", "int16")
    metrics = ROOT / "benchmarks" / "metrics"
    for m in s["end_to_end"] + s["per_layer"]:
        base = m["name"].split(".")[0]
        assert (metrics / f"{m['name']}.py").is_file() \
            or (metrics / f"{base}.py").is_file()


def test_every_cell_reports_what_it_must():
    s = spec()
    cells = {w["name"] for w in s["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in s["workloads"]}
    assert len(pairs) == len(s["workloads"])
    assert {w["config"] for w in s["workloads"]} == {c["name"]
                                                     for c in s["configs"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for c in cells:
        assert sum(c in ws for n, ws in e2e.items() if n != "setup_s") >= 1
        assert any(c in m.get("workloads", cells) for m in s["per_layer"])
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in e2e[m["moves"]], (m["name"], c)
