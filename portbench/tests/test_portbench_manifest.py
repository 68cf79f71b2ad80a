"""BENCHMARK.json and the cell files it names: they parse, their names and
units keep to the allowed characters, and every reference between them
resolves."""
import json
import re

import pytest

from portbench.common import HERE, ROOT, cell_spec, load_reader, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATHISH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return manifest()


def test_manifest_keys_and_size(bench):
    assert set(bench) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert bench["paths"] == ["portbench"]
    assert all(PATHISH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])


def test_every_name_and_unit(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(metric_names) == len(set(metric_names))


def test_references_resolve(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in cells.values()}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for name in cells:
        reported = [m for m in e2e.values() if name in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(name in m.get("workloads", cells) for m in bench["per_layer"])


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    n = 24
    total = (2 + 14 * n) * (bench["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


CELL_FILES = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))
READERS = sorted(p.stem for p in (HERE / "metrics").glob("*.py"))


@pytest.mark.parametrize("cell", CELL_FILES)
def test_cell_files(cell):
    """Every cell file, listed in BENCHMARK.json or kept for a later one."""
    spec = cell_spec(cell)
    listed = {x["name"]: x for x in manifest()["workloads"]}
    if cell in listed:
        w = listed[cell]
        assert w["chips"] == 1
        conf = {c["name"]: c for c in manifest()["configs"]}[w["config"]]
        assert (ROOT / conf["file"]).is_file()
        assert json.loads((ROOT / conf["file"]).read_text())["name"] == w["config"]
    assert spec["config"]["name"] and spec["traffic"]["kind"]
    assert spec["kind"] in ("serving", "training")
    assert set(spec["limits"]) == (
        {"token_gap", "logit_gap", "route_s_gap", "route_c_gap", "route_choice_misses"}
        if spec["kind"] == "serving" else {"loss_gap", "grad_gap", "update_gap", "grad_diff_median"})
    if spec["kind"] == "serving":
        assert (HERE / "routers" / f"{spec['router']}.npz").is_file()


def test_every_listed_metric_has_a_reader(bench):
    assert {m["name"] for m in bench["per_layer"]} <= set(READERS)


@pytest.mark.parametrize("metric", READERS)
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(load_reader(metric))
    assert load_reader(metric)({"trace": None, "spans": [], "requests": [],
                                "window_end_s": 1.0, "members": {"x": {}},
                                "peak_window_bytes": 0, "router": None}) is None


def test_paths_hold_only_the_benchmark(bench):
    for p in bench["paths"]:
        assert (ROOT / p).is_dir()
    assert HERE.name == "portbench"
