"""The port's example entry points (``examples/*_torch.py``) on the CPU at
the reference examples' settings, each in a subprocess with a timeout:
their printed lines show the offload decisions, the N-queens count at
every clone count, and the elastic server finishing every request."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(name, *args, timeout=600):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *args], env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def test_quickstart():
    """Only what the modeled gaps decide: the first encounter of each
    method offloads over WiFi (environment only), and the heavy method,
    about 30x faster on a clone than on the modeled phone, stays
    offloaded.  The light method's later placements weigh a few
    milliseconds of network against microseconds of host time, so they
    are printed, not checked."""
    out = _run("quickstart_torch.py")
    assert re.search(r"heavy_compute run 0: offloaded=1 venue=main", out)
    assert len(re.findall(r"heavy_compute run \d: offloaded=1", out)) == 3
    assert re.search(r"light_compute run 0: offloaded=1 venue=main", out)
    assert len(re.findall(r"light_compute run \d: offloaded=[01]", out)) == 3
    decisions = re.search(r"^decisions: \{'local': (\d+), 'remote': (\d+)",
                          out, re.M)
    assert sum(map(int, decisions.groups())) == 6
    assert re.search(r"^after 3G switch: light_compute offloaded=", out,
                     re.M)


def test_offload_nqueens():
    out = _run("offload_nqueens_torch.py")
    assert re.search(r"^phone: .* solutions=92$", out, re.M)
    for k in (1, 2, 4, 8):
        assert re.search(rf"^cloud k={k}: .* solutions=92 ", out, re.M), k
    assert "speedup vs phone with 8 clones" in out


def test_elastic_serving():
    out = _run("elastic_serving_torch.py")
    assert len(re.findall(r"^batch \d: prefill@\w+", out, re.M)) == 3
    assert "burst: prefill@main x4" in out
    assert "stats: {'requests': 20, 'batches': 4" in out
    assert re.search(r"^served=16 shed=0 ", out, re.M)
    assert "secondaries now running: 0" in out


@pytest.mark.parametrize("name", ["quickstart_torch.py",
                                  "offload_nqueens_torch.py",
                                  "elastic_serving_torch.py"])
def test_examples_raise_without_gpu(name):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_elastic_serving_shared_prefix_reaches_paged_prefill(monkeypatch):
    """With a one-block shared system prompt (the trace phase 30 of
    chip_smoke.py serves) the prefix cache hits and the suffixes run the
    chunked paged prefill (folded into the decode scan, ``mixed_loop``),
    which the example's random prompts never reach."""
    import contextlib
    import importlib.util
    import io

    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model
    spec = importlib.util.spec_from_file_location(
        "elastic_serving_torch",
        ROOT / "examples" / "elastic_serving_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []
    mixed = model.mixed_loop

    def counted(*a, **kw):
        calls.append(1)
        return mixed(*a, **kw)

    monkeypatch.setattr(model, "mixed_loop", counted)
    cfg = reduced_config(get_config("qwen2.5-3b"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            plain = mod.run(cfg, "cpu")
            assert not calls
            report = mod.run(cfg, "cpu", prefix_len=8)
    finally:
        torch.set_num_threads(n)
    assert len(plain.completions) == len(report.completions) == 16
    assert plain.prefix_hit_rate == 0 < report.prefix_hit_rate and calls
