"""BENCHMARK.json against the benchmark's contract, and against the files
the harness finds by name."""
import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion",
               "experts_per_tok", "d_model", "width")

MAN = harness.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len({n for _, n in names if _ in ("end_to_end", "per_layer")}) == \
        len(MAN["end_to_end"]) + len(MAN["per_layer"])
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in MAN[group]}) == len(MAN[group])


def test_entries_have_only_the_contract_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")), key
            assert not any(w in key for w in WIDTH_WORDS), key
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200


def test_cells_agree_with_their_files():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = set()
    for w in MAN["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (cell["config"]["name"], cell["traffic"]["entry"]) == \
            (w["config"], cell["traffic"]["entry"])
        assert (cell["chips"], cell["why"], cell["traffic"]) == \
            (w["chips"], w["why"], harness.load_json(
                harness.BENCH / "traffic" / f"{w['traffic']}.json"))
        assert configs[w["config"]]["file"] == f"benchmark/configs/{w['config']}.json"
        assert configs[w["config"]]["reduced"] == cell["config"]["reduced"]
        assert (harness.BENCH / "drivers" / f"{cell['traffic']['entry']}.py").exists()
        used.add(w["config"])
        trainer = cell["config"].get("trainer", {}).get("training", {})
        if cell["traffic"]["entry"] != "sync_predictor":
            assert trainer["base_batch_size"] == cell["traffic"]["batch"]
    assert used == set(configs)
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(MAN["workloads"])


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in MAN["end_to_end"])
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(MAN, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = harness.cell_metrics(MAN, w["name"], True)
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_roofline_and_mfu_names():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_check_fits_the_budget_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_every_cell_has_limits_for_its_check():
    for w in MAN["workloads"]:
        limits = harness.load_cell(w["name"])["limits"]
        assert limits and all(isinstance(v, float) and v > 0 for v in limits.values())
