"""BENCHMARK.json against the contract's rules on names, units and the
files the harness finds by name."""
import json
import os
import re

import pytest

from conftest import BENCH, ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    B = json.load(_fh)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"]: m for m in B["end_to_end"]}


def test_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert B["paths"] == ["orc_bench"] and len(B["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in B["workloads"]]:
        assert NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in B["configs"]]
                 + [w["why"] for w in B["workloads"]]
                 + [m["layer"] for m in B["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text
        assert "\t" not in text


@pytest.mark.parametrize("cell", B["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_and_reports(cell):
    cfg = next(c for c in B["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, cfg["file"])) as fh:
        conf = json.load(fh)
    assert conf["reduced"] == cfg["reduced"] == []
    for part in (("traffic", cell["traffic"] + ".json"),
                 ("limits", cell["name"] + ".json")):
        assert os.path.isfile(os.path.join(BENCH, *part))
    e2e = [m["name"] for m in B["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in B["per_layer"]
             if cell["name"] in m.get("workloads", [cell["name"]])]
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    assert cell["chips"] == 1


def test_every_config_has_a_cell():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
