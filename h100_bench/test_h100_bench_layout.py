"""Every configuration, mix, driver, metric reader and limit file is found
by its name in BENCHMARK.json, and the file keeps to the contract's
shape."""

import json
import re

from h100_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    return harness.load_benchmark()


def test_files_found_by_name():
    b = _bench()
    for c in b["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert harness.load_config(c["name"])["name"] == c["name"]
    for w in b["workloads"]:
        mix = harness.load_mix(w["traffic"])
        assert hasattr(harness.driver(mix["driver"]), "run")
        assert harness.load_limits(w["name"])
    for m in b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_contract_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            cells = e2e[m["moves"]].get("workloads")
            assert cells is None or w in cells
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        reported = [m for m in b["end_to_end"]
                    if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(reported) >= 2
    assert len(json.dumps(b)) < 64 * 1024
