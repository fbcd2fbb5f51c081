"""Tests of the benchmark harness, on the CPU at tiny sizes (those marked
``cuda`` run the benchmark on a card and skip without one):

    PYTHONPATH=src python3 -m pytest -q cardbench/tests
"""
import copy
import json
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

from bench import cells  # noqa: E402


def _json(path):
    return json.loads((HERE / path).read_text())


def tiny_conf(kind: str = "dense") -> dict:
    """The dense configuration file cut to a few layers and widths, for
    the CPU."""
    conf = _json("configs/qwen2.5-3b.json")
    conf.update(num_hidden_layers=2, hidden_size=64,
                num_attention_heads=4, num_key_value_heads=2,
                head_dim=16, intermediate_size=128, vocab_size=512)
    return conf


def tiny_mix(kind: str) -> dict:
    """A traffic mix cut to tiny prompts and a short window: ``rag``,
    distinct prompts under Poisson arrivals (the conv file's mix), or
    ``agent``, bursts of requests on shared block-aligned prefixes (no
    cell has that mix yet; the generator and the handler serve it)."""
    mix = _json("traffic/qwen2.5-3b.conv.json")
    if kind == "agent":
        mix.update(traffic="agent",
                   prompt={"kind": "shared_prefix", "prefixes": 2,
                           "prefix_tokens": 24, "suffix_tokens": 8},
                   arrivals={"kind": "bursts", "burst": 4, "rate": 5.0})
        mix["handler"].update(max_batch=16, block_size=8, capacity=48,
                              num_blocks=200, prefill_chunk=8,
                              prefix_cache=True)
        mix["warmup"] = {"join_rows": [1, 2], "suffix_rows": [4, 8],
                         "decode_tokens": 12, "suffix_gap_s": 0.02}
    else:
        mix.update(prompt={"kind": "distinct", "tokens": 32},
                   arrivals={"kind": "poisson", "rate": 16.0})
        mix["handler"].update(max_batch=8, block_size=8, capacity=48)
        mix["warmup"] = {"join_rows": [1, 2]}
    mix["output"] = {"median": 12, "sigma": 0.3, "min": 8, "max": 16}
    mix["trace"] = {"start_frac": 0.3, "seconds": 0.3}
    mix["check"] = {"requests": 6, "logit_gap": 0.05}
    return mix


@pytest.fixture
def tiny_cell():
    def make(model: str = "dense", traffic: str = "rag"):
        return cells.Cell(f"tiny.{model}.{traffic}", 1, tiny_conf(model),
                          tiny_mix(traffic), [], [])
    return make


@pytest.fixture
def bench_json():
    return copy.deepcopy(json.loads((HERE.parent / "BENCHMARK.json")
                                    .read_text()))
