"""A configuration, a cell, a traffic mix or a metric is added by adding
files and manifest entries only: the harness finds each by its name."""
import json
import shutil

import pytest

from benchmark import harness


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of BENCHMARK.json and benchmark/'s data files, the harness
    pointed at it."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    for sub in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(harness.BENCH / sub, bench / sub)
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", bench)
    return root


def _add(path, obj):
    path.write_text(json.dumps(obj))


def test_new_cell_config_traffic_and_metric_by_files_only(tree):
    before = {p: p.read_bytes() for p in (tree / "benchmark").rglob("*") if p.is_file()}
    bench = tree / "benchmark"
    config = json.loads((bench / "configs" / "synchformer_vitb.json").read_text())
    config["name"] = "synchformer_vitb_s13"
    _add(bench / "configs" / "synchformer_vitb_s13.json", config)
    _add(bench / "traffic" / "closed_b4.json",
         {"entry": "sync_predictor", "clients": 1, "batch": 4, "pool": 2,
          "fields": ["patches"], "trace_units": 2})
    _add(bench / "workloads" / "sync_offline_b4.json",
         {"config": "synchformer_vitb_s13", "traffic": "closed_b4", "chips": 1,
          "why": "a smaller batch", "limits": {"logit_gap": 0.5}})
    (bench / "metrics" / "copy_ms.offline.py").write_text(
        "def read(ctx):\n    return ctx.per_unit(ctx.span_ms('copy'))\n")
    man = json.loads((tree / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "sync_offline_b4", "config": "synchformer_vitb_s13",
                             "traffic": "closed_b4", "chips": 1, "why": "a smaller batch"})
    man["per_layer"].append({"name": "copy_ms.offline", "unit": "ms/batch", "better": "lower",
                             "source": "program_span", "layer": "host dispatch",
                             "moves": "clips_per_s", "workloads": ["sync_offline_b4"]})
    for m in man["end_to_end"]:
        if m["name"] == "clips_per_s":
            m["workloads"].append("sync_offline_b4")
    (tree / "BENCHMARK.json").write_text(json.dumps(man))

    cell = harness.load_cell("sync_offline_b4")
    assert cell["traffic"]["batch"] == 4 and cell["config"]["name"] == "synchformer_vitb_s13"
    assert harness.driver_class(cell["traffic"]["entry"]).__module__ == \
        "benchmark.drivers.sync_predictor"
    per_layer = [m["name"] for m in harness.cell_metrics(harness.manifest(), "sync_offline_b4",
                                                           True)]
    assert per_layer == ["copy_ms.offline"]
    e2e = [m["name"] for m in harness.cell_metrics(harness.manifest(), "sync_offline_b4", False)]
    assert e2e == ["clips_per_s", "setup_s"]

    class Ctx:
        units = 2

        def per_unit(self, v):
            return v / self.units

        def span_ms(self, name):
            return 30.0 if name == "copy" else None

    assert harness.reader("copy_ms.offline")(Ctx()) == 15.0
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed


def test_a_metric_without_workloads_follows_the_metric_it_moves(tree):
    man = harness.manifest()
    man["per_layer"].append({"name": "x_ms.train", "unit": "ms/step", "better": "lower",
                             "source": "program_span", "layer": "optimizer",
                             "moves": "step_ms"})
    names = {w["name"]: [m["name"] for m in harness.cell_metrics(man, w["name"], True)]
             for w in man["workloads"]}
    assert "x_ms.train" in names["stage1_avclip_b2"]
    assert "x_ms.train" not in names["sync_offline_b8"]
