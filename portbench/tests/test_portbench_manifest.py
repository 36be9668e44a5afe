"""The manifest and the files it names: characters, keys, resolution."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for w in bench["command"]:
        assert not w.startswith("/") and ".." not in w
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        allowed = {"name", "unit", "better", "source"} | (
            {"bound"} if m in bench["end_to_end"] else {"layer", "moves"})
        assert set(m) - {"workloads"} == allowed
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_metrics_sources_bounds_and_moves(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= moved
    for cell in cells:
        e, layer = harness.cell_metrics(bench, cell)
        assert {x["name"] for x in e} - {"setup_s"}, cell
        assert layer, cell


def test_every_cell_resolves_to_config_driver_and_readers(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        wl = harness.load_json("workloads", f"{w['name']}.json")
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        cfg = configs[w["config"]]
        assert cfg["file"] == f"portbench/configs/{w['config']}.json"
        data = harness.load_json("configs", f"{w['config']}.json")
        assert data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]
        assert hasattr(harness.load_module("traffic", w["traffic"]),
                       "TRAFFIC")
        _e, layer = harness.cell_metrics(bench, w["name"])
        for m in layer:
            assert callable(harness.load_module("metrics", m["name"]).read)


def test_a_new_cell_is_files_only(tmp_path, bench):
    """A throwaway cell: a workload file of an existing configuration and
    traffic, found by its name alone, removed afterwards."""
    name = "cornell_box.render_probe"
    path = harness.HERE / "workloads" / f"{name}.json"
    src = harness.load_json("workloads", "cornell_box.render.json")
    path.write_text(json.dumps(dict(src, params=dict(
        src["params"], max_iters=8))))
    try:
        from portbench.run import Context, make_traffic
        ctx = Context(name, 5, device="cpu")
        assert ctx.params["max_iters"] == 8
        assert type(make_traffic(ctx)).__name__ == "Render"
        cells = {w["name"] for w in bench["workloads"]} | {name}
        assert name in cells
    finally:
        path.unlink()
    assert not path.exists()


def test_config_files_are_each_ones_own(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(bench["paths"][0] + "/")
