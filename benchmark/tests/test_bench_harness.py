"""The harness on the CPU: what it imports, that every name in
BENCHMARK.json resolves to its file, the contract's limits on names, units
and entries, what each per-layer metric's cells report, the result line's
keys on a dry path, and that a run without a CUDA device fails instead of
running on the CPU."""

import ast
import json
import re

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILES = sorted(p for p in harness.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".", 1)[0] not in harness.FORBIDDEN_MODULES, (path, name)


@pytest.mark.parametrize("path", sorted(harness.HERE.glob("reference/*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    text = path.read_text()
    assert "symmetry_ode_discovery_tpu" not in text


def test_names_resolve():
    for c in SPEC["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert harness.read_json(harness.ROOT / c["file"])["name"] == c["name"]
    for w in SPEC["workloads"]:
        cell = harness.cell(w["name"])
        assert cell["driver"].is_file()
        assert cell["limits"]
    for m in SPEC["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_contract_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, required in keys.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
        for e in SPEC[section]:
            assert required <= set(e) <= required | {"workloads"}, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text_key in ("why", "layer", "source"):
                if text_key in e:
                    assert 1 <= len(e[text_key]) <= 200 and "\n" not in e[text_key]
    for e in SPEC["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_each_cell_reports_what_its_metrics_move():
    e2e = SPEC["end_to_end"]
    for w in SPEC["workloads"]:
        cell = harness.cell(w["name"])
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported
    for m in SPEC["per_layer"]:
        moved = next(e for e in e2e if e["name"] == m["moves"])
        for cell in m.get("workloads", []):
            assert harness.applies(moved, cell, e2e)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert "device" in layers


def test_run_without_a_card_fails(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", tiny.SWEEP, "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys_on_a_dry_path(trace):
    checks = {"pen_gap": {"value": 1e-7, "limit": 1e-3}}
    line = harness.result_line(
        harness.checks_ok(checks), 4, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
        {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1},
        checks, {"device_ops": [], "idle_gaps": []} if trace else None)
    out = json.loads(line)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(out)[:-1] == want and list(out)[-1] == "checks"
    assert out["correct"] is True
    bad = dict(checks, change_gap={"value": float("nan"), "limit": 1.0})
    assert harness.checks_ok(bad) is False


def test_forbidden_modules_are_found(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert "flax" in harness.forbidden_loaded()
    monkeypatch.delitem(sys.modules, "flax.linen")
    assert harness.forbidden_loaded() == []


def test_checks_take_exactly_the_limits_named():
    limits = {"a_gap": 1e-3, "b_gap": 1e-2}
    got = harness.checks({"a_gap": 1e-4, "b_gap": 2e-2}, limits)
    assert got == {"a_gap": {"value": 1e-4, "limit": 1e-3}, "b_gap": {"value": 2e-2, "limit": 1e-2}}
    assert harness.checks_ok(got) is False
    with pytest.raises(KeyError):
        harness.checks({"a_gap": 1e-4}, limits)
    with pytest.raises(KeyError):
        harness.checks({"a_gap": 1e-4, "b_gap": 0.0, "c_gap": 0.0}, limits)
