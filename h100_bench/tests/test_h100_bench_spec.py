"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of every file a cell names."""
import json
import re
from pathlib import Path

import pytest

from h100_bench import harness

ROOT = Path(harness.ROOT)
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    for path in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", path) and (ROOT / path).is_dir()
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word and 1 <= len(word) <= 200


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))
    for cell in SPEC["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    for config in SPEC["configs"]:
        assert all(NAME.match(k) for k in config["reduced"]) and len(config["reduced"]) <= 16


def test_metrics_cover_every_cell():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and SPEC["end_to_end"][-1]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
    for cell in SPEC["workloads"]:
        own = {m["name"] for m in harness.metrics_of(SPEC, cell["name"], "end_to_end")}
        assert "setup_s" in own and len(own) >= 2
        layers = harness.metrics_of(SPEC, cell["name"], "per_layer")
        assert layers and all(m["moves"] in own for m in layers)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_harness_finds_each_file_by_name(cell):
    config = harness.load_config(cell["config"])
    entry = harness.find(SPEC["configs"], cell["config"], "config")
    assert (ROOT / entry["file"]).resolve() == harness.BENCH / "configs" / f"{cell['config']}.json"
    assert config["name"] == cell["config"] and config["reduced"] == entry["reduced"]
    traffic = harness.load_traffic(cell["traffic"])
    assert hasattr(harness.load_driver(traffic["driver"]), "Driver")
    limits = harness.load_limits(cell["name"])
    assert limits and all(row["limit"] >= 0 for row in limits.values())
    for m in harness.metrics_of(SPEC, cell["name"], "per_layer"):
        assert callable(harness.load_metric(m["name"]).read)


def test_every_file_is_named_by_the_spec():
    configs = {c["name"] for c in SPEC["configs"]}
    traffic = {c["traffic"] for c in SPEC["workloads"]}
    metrics = {m["name"] for m in SPEC["per_layer"]}
    assert {p.stem for p in (harness.BENCH / "configs").glob("*.json")} == configs
    assert {p.stem for p in (harness.BENCH / "traffic").glob("*.json")} == traffic
    assert {p.name[:-3] for p in (harness.BENCH / "metrics").glob("*.py")} == metrics
    assert {p.stem for p in (harness.BENCH / "limits").glob("*.json")} == \
        {c["name"] for c in SPEC["workloads"]}
    json.dumps(SPEC)
