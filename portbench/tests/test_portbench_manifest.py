"""BENCHMARK.json keeps to the contract's form, and every file it names,
or that the harness finds by a name in it, is there."""

import ast
import json
import re

import pytest

from benchcopy import REPO, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_form():
    m = manifest()
    assert set(m) == KEYS
    assert len(json.dumps(m)) <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) for p in m["paths"])
    assert all(".." not in p.split("/") and not p.startswith("/") for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(one_line(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits into 43200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    m = manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in m[kind]}) == len(m[kind])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
    cfgs = {c["name"] for c in m["configs"]}
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert one_line(w["why"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in m["workloads"]} == cfgs
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert x["moves"] in e2e and one_line(x["layer"]) and x["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(x.get("workloads", cells)) <= cells
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    share = [x for x in m["per_layer"] if x["name"].endswith("_roofline") or "mfu" in x["name"]]
    assert all(x["unit"] == "%" for x in share)


def test_every_named_file_is_found():
    m = manifest()
    pkg = REPO / "portbench"
    for c in m["configs"]:
        path = REPO / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert (pkg / "systems" / f"{cfg['system']}.py").is_file()
        assert (pkg / "references" / f"{cfg['reference']}.py").is_file()
        assert "assumed" in cfg
    assert len({c["file"] for c in m["configs"]}) == len(m["configs"])
    for w in m["workloads"]:
        assert (pkg / "traffic" / f"{w['traffic']}.json").is_file()
        wl = json.loads((pkg / "workloads" / f"{w['name']}.json").read_text())
        assert {"solution_gap", "cycles_gap"} <= set(wl["limits"]) <= \
            {"solution_gap", "cycles_gap", "residual_gap"}
        assert ("residual_gap" in wl["limits"]) == ("residual_cycles" in wl)
    for x in m["end_to_end"] + m["per_layer"]:
        assert (pkg / "metrics" / f"{x['name']}.py").is_file()
    for word in m["command"][1:]:
        assert (REPO / word).is_file() and any(word.startswith(p + "/") for p in m["paths"])


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix() for p in
                                        (REPO / "portbench").rglob("*.py")))
def test_no_file_imports_jax(path):
    """No file of the benchmark names JAX or the JAX package in an import
    (the port's own name starts with the JAX package's: compared whole)."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in {"jax", "jaxlib", "flax", "exastencils_tpu"}, n
