"""On a card: each cell of BENCHMARK.json runs once, briefly, through
``run.py`` and prints a correct result line.  Skips without a card."""
import json
import subprocess
import sys

import pytest

from bench import cells


@pytest.mark.cuda
def test_each_cell_runs_correct(bench_json):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w in bench_json["workloads"]:
        out = subprocess.run(
            [sys.executable, str(cells.HERE / "run.py"), "--workload",
             w["name"], "--seed", str(2 ** 31 + 5), "--seconds", "4",
             "--trace", "0"], capture_output=True, text=True, timeout=900,
            cwd=cells.ROOT)
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res
        assert list(res)[-1] == "checks"
        assert {"setup_s"} <= set(res["metrics"])


def test_without_a_card_the_run_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(cells.HERE / "run.py"), "--workload",
         "qwen2.5-3b.conv", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cells.ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
