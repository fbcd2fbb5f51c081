"""The check's control at a size the CPU holds: the reference computed in
float8 (the precision below the configuration's bfloat16), put in the
program's place, reads a widest logit gap above the limit on every seed,
where the program itself reads one under it."""
import time

import pytest
import torch

from bench import check, harness

SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


@pytest.fixture(scope="module")
def runs():
    from conftest import tiny_conf, tiny_mix
    from bench import cells
    torch.set_num_threads(2)
    cell = cells.Cell("tiny.dense.rag", 1, tiny_conf("dense"),
                      tiny_mix("rag"), [], [])
    return [harness.run_cell(cell, s, 1.0, False,
                             t_start=time.perf_counter(), device="cpu",
                             impl="torch", log=lambda m: None)
            for s in SEEDS]


def test_program_passes_and_control_fails(runs):
    for run in runs:
        limit = run.cell.mix["check"]["logit_gap"]
        rids = check.sample(run, run.cell.mix["check"]["requests"])
        assert sum(len(run.completions[r].tokens) for r in rids) >= 48
        prog = max(check.gaps(run, rids, "cpu"))
        ctl = max(check.gaps(run, rids, "cpu", control=True))
        assert prog <= limit < ctl, (run.seed, prog, ctl)
        assert check.passed(check.checks(run, "cpu", log=lambda m: None))


def test_fp8_rounding_is_coarse():
    from bench.check import reference
    ref = reference({"reference": "decoder"})
    x = torch.linspace(-3, 3, 1001)[None]
    err = (ref._fp8(x, -1) - x).abs().max() / 3
    assert 1 / 64 <= err <= 1 / 8       # 3 mantissa bits, not bf16's 7
