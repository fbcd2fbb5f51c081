"""A run whose timed path is broken underneath comes out not correct:
the rest of a run (warm-up, window, check) as ``run.py`` drives it, on the
CPU at a tiny size, with one fault planted in the port's decode."""
import time

import pytest
import torch

from bench import check, harness
from repro_torch.models import model

SEED = 2 ** 31 + 77


def _alter_tokens(orig):
    def loop(cfg, *a, **k):
        out = orig(cfg, *a, **k)
        return ((out[0] + 1) % cfg.vocab_size,) + tuple(out[1:])
    return loop


def _drop_half(orig):
    def loop(cfg, params, cache, tokens, pos, steps_left, *a, **k):
        half = steps_left.clone()
        live = torch.nonzero(half > 0)[:, 0]
        half[live[1::2]] = 0                # every other live row left out
        return orig(cfg, params, cache, tokens, pos, half, *a, **k)
    return loop


def _state_unchanged(orig):
    def loop(cfg, params, cache, *a, **k):
        leaves = [(leaf, leaf.clone())
                  for leaf, _ in model.cache_leaves(cfg, cache)]
        out = orig(cfg, params, cache, *a, **k)
        for leaf, old in leaves:
            leaf.copy_(old)
        return out
    return loop


@pytest.mark.parametrize("fault", [_alter_tokens, _drop_half,
                                   _state_unchanged])
def test_fault_makes_the_run_incorrect(fault, tiny_cell, monkeypatch):
    torch.set_num_threads(2)
    cell = tiny_cell("dense", "rag")
    cell.mix["arrivals"]["rate"] = 24.0

    def plant(handler):
        monkeypatch.setattr(model, "decode_loop", fault(model.decode_loop))
    run = harness.run_cell(cell, SEED, 1.0, False,
                           t_start=time.perf_counter(), device="cpu",
                           impl="torch", before_window=plant,
                           log=lambda m: None)
    res = check.checks(run, "cpu", log=lambda m: None)
    assert not check.passed(res), res


def test_same_run_without_a_fault_is_correct(tiny_cell):
    torch.set_num_threads(2)
    cell = tiny_cell("dense", "rag")
    cell.mix["arrivals"]["rate"] = 24.0
    run = harness.run_cell(cell, SEED, 1.0, False,
                           t_start=time.perf_counter(), device="cpu",
                           impl="torch", log=lambda m: None)
    assert check.passed(check.checks(run, "cpu", log=lambda m: None))
