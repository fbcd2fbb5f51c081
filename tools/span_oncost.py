#!/usr/bin/env python3
"""The cost of the program's ranges with a profiler session open and with
none: median wall ms of fixed engine steps of qwen2.5-3b (a join of 8
rows x 1504 tokens, a decode step of 128 slots near 1510 tokens and one
of 256 slots near 1100) through ``LMBackend.paged_fns`` of the checkout
at the path given, each with the profiler off and on (CPU + CUDA).  Run
it on two checkouts in one call to compare them on one card:

    python3 tools/span_oncost.py <checkout>

Prints one line ``ONCOST <checkout name> {case: {off_ms, on_ms}}``.
Needs a card.
"""
import json
import pathlib
import statistics
import sys
import time

tree = pathlib.Path(sys.argv[1]).resolve()
sys.path.insert(0, str(tree / "src"))
sys.path.insert(0, str(tree / "cardbench"))
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench import counts, harness, weights  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.serve import LMBackend  # noqa: E402

dev = torch.device("cuda")
conf = json.loads((tree / "cardbench/configs/qwen2.5-3b.json").read_text())
cfg = harness.port_config(conf)
shape = counts.Shape.of(conf)
params = weights.make(shape, cfg.tie_embeddings, cfg.qkv_bias, 11, dev)
build.build_all()
BS, CAP = 16, 1568
b = LMBackend(cfg, capacity=CAP, params=params, device=dev, impl="cuda")
g = torch.Generator(device="cpu").manual_seed(3)


def i32(x):
    return torch.as_tensor(x, dtype=torch.int32).to(dev)


def decode_case(slots, ctx):
    nb = -(-CAP // BS)
    pool = b.init_paged_pool(slots, slots * nb + 1, BS)
    _, dw = b.paged_fns(BS, 1)
    tables = i32(1 + torch.arange(slots * nb).reshape(slots, nb))
    pos = i32(ctx + torch.randint(0, 16, (slots,), generator=g))
    tok = i32(torch.randint(0, shape.vocab, (slots, 1), generator=g))
    left = i32(torch.ones(slots))
    return lambda: dw(params, pool, tok, pos, left, tables)


def join_case(rows, plen):
    nb = -(-plen // BS)
    pool = b.init_paged_pool(rows, rows * nb + 1, BS)
    pi, _ = b.paged_fns(BS, 1)
    toks = i32(torch.randint(0, shape.vocab, (rows, plen), generator=g))
    blk = i32(1 + torch.arange(rows * nb).reshape(rows, nb))
    slots = i32(torch.arange(rows))
    return lambda: pi(params, toks, pool, blk, slots)


def timed(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


res = {}
for name, fn, reps in (("join8x1504", join_case(8, 1504), 10),
                       ("decode128@1510", decode_case(128, 1504), 30),
                       ("decode256@1100", decode_case(256, 1088), 30)):
    timed(fn, 3)
    off = timed(fn, reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        timed(fn, 2)
        on = timed(fn, reps)
    res[name] = {"off_ms": off, "on_ms": on}
    del fn
    torch.cuda.empty_cache()
print("ONCOST", tree.name, json.dumps(res), flush=True)
