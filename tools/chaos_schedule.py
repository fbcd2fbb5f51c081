#!/usr/bin/env python3
"""The fault schedule of ``chip_smoke.py`` phase 16, worked out on the CPU.

    PYTHONPATH=src python3 tools/chaos_schedule.py [--arch smollm-360m]

With a fixed-time executor (0.05 s per closure) the virtual timeline of
a ``ClientHandler`` run does not depend on the model's arithmetic, only
on the trace, the fleet and the KV bytes per token (the migration and
hedge transfer delays).  So a shape-only backend, which counts tokens
instead of running the model but bills the full-width configuration's
KV bytes, schedules exactly as the card does.  For phase 4's fleet (8
slots per engine, faults on the lowest-cid busy secondary), the chaos
fleet of ``chip_smoke.CHAOS`` and the chaos fleet over the default wifi
link, it prints what each of phase 16's fault runs recovers: faults
fired, slots migrated, requests restored, hedges fired and won.  Uses
no GPU and times nothing.
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.clones import CloneState  # noqa: E402
from repro_torch.core.faults import CloneFault  # noqa: E402
from repro_torch.launch.serve import ClientHandler, LMBackend  # noqa: E402


class ShapeBackend:
    """The paged serving protocol with no model: every prefill emits
    token 0 and decode counts up; the pools are empty.  ``cfg`` sets the
    KV bytes per token (``cache_mem_bytes``, shapes only)."""

    supports_chunked = True
    params = None
    device = torch.device("cpu")

    def __init__(self, cfg, capacity):
        self.cfg, self.capacity = cfg, capacity

    cache_mem_bytes = LMBackend.cache_mem_bytes

    @staticmethod
    def tensor(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32)

    def init_paged_pool(self, max_slots, num_blocks, block_size):
        return {}

    def paged_fns(self, block_size, window=1):
        def prefill_into(params, toks, pool, blk_ids, slots):
            return torch.zeros(toks.shape[0], dtype=torch.int32), pool

        def decode_window(params, pool, tok, pos, steps_left, tables):
            cur = tok[:, 0].clone()
            out = torch.zeros((cur.numel(), window), dtype=torch.int32)
            for t in range(window):
                cur = torch.where(t < steps_left, cur + 1, cur)
                out[:, t] = cur
            return out, pool
        return prefill_into, decode_window

    def prefill_window_fn(self, block_size, num_steps, chunk=0):
        def prefill_window(params, pool, toks, pos0, n_tok, tables):
            return torch.zeros(toks.shape[0], dtype=torch.int32), pool
        return prefill_window

    def mixed_fn(self, block_size, chunk, num_steps):
        _, decode_window = self.paged_fns(block_size, num_steps)

        def mixed(params, pool, tok, pos, steps_left, tables, stoks, spos,
                  sn, stabs):
            out, pool = decode_window(params, pool, tok, pos, steps_left,
                                      tables)
            return out, torch.zeros(stoks.shape[0], dtype=torch.int32), pool
        return mixed

    def copy_fn(self):
        return lambda pool, src, dst: pool

    def migrate_fn(self, compress=False):
        return lambda dst, src, sids, dids: dst


def run(backend, fleet, faults, hedge, cid):
    """One phase-16 run on ``fleet`` (handler options); returns its
    report."""
    h = ClientHandler(
        backend, prompt_pad=chip_smoke.PROMPT_PAD, decode_window=4,
        executor=lambda c, f, a: (f(*a), 0.05), hedge_factor=hedge,
        faults=[CloneFault(**dict(f, cid=cid)) for f in faults] or None,
        **fleet)
    h.pool.provision(h.clone_type, 1, state=CloneState.RUNNING)
    return h.run(chip_smoke.trace(backend.cfg.vocab_size))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    args = ap.parse_args(argv)
    backend = ShapeBackend(get_config(args.arch), chip_smoke.CAPACITY)
    fleets = {
        "phase 4's (8 slots, faults unpinned)": (
            dict(chip_smoke.CHAOS, max_batch=chip_smoke.MAX_BATCH), None),
        "chip_smoke.CHAOS": (chip_smoke.CHAOS, chip_smoke.CHAOS_CID),
        "CHAOS over wifi-local": (dict(chip_smoke.CHAOS, link="wifi-local"),
                                  chip_smoke.CHAOS_CID),
    }
    for name, (fleet, cid) in fleets.items():
        span = run(backend, fleet, [], 0.0, cid).makespan_s
        print(f"{args.arch}, fleet {name}: faultless makespan {span:.4f} s "
              "(virtual)")
        for kind, faults, hedge in chip_smoke.chaos_faults(span):
            faults = [{k: v for k, v in f.items() if k != "cid"}
                      for f in faults]
            rep = run(backend, fleet, faults, hedge, cid)
            print(f"  {kind:15s} faults {rep.faults_injected}, migrated "
                  f"{rep.recoveries_migrated}, restored "
                  f"{rep.recoveries_restored}, hedges {rep.hedges_fired} "
                  f"fired / {rep.hedge_wins} won, served "
                  f"{len(rep.completions)}")


if __name__ == "__main__":
    main()
