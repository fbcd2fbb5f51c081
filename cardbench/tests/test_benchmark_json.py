"""BENCHMARK.json keeps to its contract, and every name it holds finds
its file."""
import json
import re

from bench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_units(bench_json):
    b = bench_json
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "cardbench/run.py"]
    assert b["paths"] == ["cardbench"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["why"])
        assert c["file"] == f"cardbench/configs/{c['name']}.json"
        conf = json.loads((cells.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["source"].startswith(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        assert w["config"] in {c["name"] for c in b["configs"]}
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= set(names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        # every cell that reports it reports the metric it moves
        moved = e2e[m["moves"]].get("workloads", names)
        assert set(m.get("workloads", names)) <= set(moved), m["name"]
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_cell_finds_its_files(bench_json):
    for w in bench_json["workloads"]:
        cell = cells.load(w["name"], bench_json)
        assert cell.conf["name"] == w["config"]
        assert cell.mix["traffic"] == w["traffic"]
        assert {m.name for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert all(callable(m.read) for m in cell.end_to_end
                   + cell.per_layer)
        for key in ("prompt", "output", "arrivals", "handler", "warmup",
                    "trace", "check", "why", "base_seed"):
            assert key in cell.mix, (w["name"], key)
        assert _one_line(cell.mix["why"])


def test_configuration_files_hold_the_run():
    from bench import harness
    for f in sorted((cells.HERE / "configs").glob("*.json")):
        conf = json.loads(f.read_text())
        cfg = harness.port_config(conf)
        assert cfg.n_layers == conf["num_hidden_layers"]
        assert cfg.d_model == conf["hidden_size"]
        assert cfg.n_heads * cfg.head_dim == conf["hidden_size"]
        assert cfg.dtype == "bfloat16"
        assert (cells.HERE / "reference" / f"{conf['reference']}.py").exists()
