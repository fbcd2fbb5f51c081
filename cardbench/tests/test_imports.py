"""Nothing the benchmark runs loads JAX or the JAX package ``repro``, and
the reference loads nothing of the program either; top-level module names
are compared whole (``repro_torch`` is not ``repro``)."""
import importlib.util
import json
import subprocess
import sys
import types

import pytest
import torch

from bench import cells, check, harness

LOADED = "import json, sys; print(json.dumps(sorted({m.split('.')[0] " \
    "for m in sys.modules})))"


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = "
         f"[{str(cells.HERE)!r}, {str(cells.ROOT / 'src')!r}]\n"
         f"{code}\n{LOADED}"],
        capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    metrics = [p.stem for p in (cells.HERE / "metrics").glob("*.py")]
    top = _loaded(
        "import bench.harness, bench.check, bench.trace, bench.cells\n"
        "import repro_torch.launch.serve, repro_torch.kernels.build\n"
        "from bench import cells\n"
        f"[cells.reader(m) for m in {metrics!r}]\n"
        "import runpy; runpy.run_path("
        f"{str(cells.HERE / 'run.py')!r}, run_name='not_main')")
    assert "repro_torch" in top and "bench" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    top = _loaded(
        "import importlib.util as u\n"
        f"s = u.spec_from_file_location('r', "
        f"{str(cells.HERE / 'reference' / 'decoder.py')!r})\n"
        "m = u.module_from_spec(s); s.loader.exec_module(m)")
    assert "torch" in top
    bad = top & (set(harness.FORBIDDEN) | {"repro_torch", "bench"})
    assert not bad, bad


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torchish", sys)
    monkeypatch.setitem(sys.modules, "jaxtools.x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "repro"]


@pytest.mark.parametrize("load_jax", [False, True])
def test_a_run_that_loads_jax_during_the_check_prints_no_result(
        load_jax, tiny_cell, monkeypatch, capsys):
    """``run.py`` drives a CPU run of a tiny cell (its look for a card
    answered yes); the check, run after the window, loads a stub module
    named ``jax``: the run then exits with 3 and prints no result."""
    torch.set_num_threads(2)
    spec = importlib.util.spec_from_file_location("cardbench_run_main",
                                                  cells.HERE / "run.py")
    run_py = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_py)
    cell = tiny_cell("dense", "rag")
    cell.end_to_end = [cells.Metric(n, u, cells.reader(n)) for n, u in
                       (("setup_s", "s"), ("output_tok_s", "tokens/s"))]
    monkeypatch.setattr(cells, "load", lambda name: cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    run_cell, checks = harness.run_cell, check.checks
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: run_cell(
        *a, **k, device="cpu", impl="torch"))

    def checks_loading_jax(run, device, log):
        if load_jax:
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return checks(run, "cpu", log)
    monkeypatch.setattr(check, "checks", checks_loading_jax)
    rc = run_py.main(["--workload", "tiny", "--seed", str(2 ** 31 + 9),
                      "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    if load_jax:
        assert rc == 3 and out.strip() == ""
        assert "forbidden modules: jax" in err
    else:
        assert rc == 0
        res = json.loads(out.strip().splitlines()[-1])
        assert res["correct"] and list(res)[-1] == "checks"
