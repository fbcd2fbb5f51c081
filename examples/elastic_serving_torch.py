"""Serve an LM on the PyTorch port with ThinkAir placement, escalation and
clone elasticity.

    PYTHONPATH=src python examples/elastic_serving_torch.py [--device cpu]
(reduced qwen2.5-3b, as the reference's example; runs on the card unless
--device names another device)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np                                        # noqa: E402

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import Policy, poisson_arrivals       # noqa: E402
from repro_torch.launch.serve import (ClientHandler, LMBackend,  # noqa: E402
                                      Request, ServingEngine)
from repro_torch.models.context import resolve_device       # noqa: E402


def run(cfg, device=None, prefix_len: int = 0):
    """The example's body on ``cfg``: three batches placed by the policy, a
    burst split over 4 clones, then the event-driven Client Handler under
    Poisson load.  ``prefix_len`` > 0 starts every Poisson prompt with one
    shared system prompt of that many tokens (``poisson_arrivals``): the
    prefix cache then hits and each suffix goes through the chunked paged
    prefill; the reference's example, like ``main()``, has none.  Returns
    the handler's report."""
    dev = resolve_device(device)
    eng = ServingEngine(cfg, policy=Policy.EXEC_TIME, capacity=128,
                        device=dev)
    rng = np.random.default_rng(0)

    print("== normal traffic: policy decides placement per batch ==")
    for b in range(3):
        reqs = [Request(b * 4 + i, rng.integers(0, cfg.vocab_size, 12,
                                                dtype=np.int32), 6)
                for i in range(4)]
        comps = eng.serve_batch(reqs)
        print(f"batch {b}: prefill@{comps[0].prefill_venue:8s} "
              f"decode@{comps[0].decode_venue:8s} "
              f"latency={comps[0].latency_s:.3f}s")

    print("\n== burst: split prefill across 4 clones (paper §7.4) ==")
    reqs = [Request(100 + i, rng.integers(0, cfg.vocab_size, 12,
                                          dtype=np.int32), 4)
            for i in range(8)]
    comps = eng.serve_batch(reqs, n_clones=4, force="remote")
    print(f"burst: prefill@{comps[0].prefill_venue} "
          f"latency={comps[0].latency_s:.3f}s")

    print("\nstats:", eng.stats)
    print("pool:", eng.ec.pool.stats)

    print("\n== event-driven Client Handler: continuous batching under "
          "Poisson load (paper §5.2-5.3) ==")
    backend = LMBackend(cfg, capacity=64, params=eng.params, device=dev)
    handler = ClientHandler(backend, max_batch=4, max_secondaries=4,
                            prompt_pad=12)
    reqs = poisson_arrivals(8.0, 16, prompt_len=12, vocab=cfg.vocab_size,
                            max_new_tokens=6, prefix_len=prefix_len)
    report = handler.run(reqs, drain_idle_s=35.0)
    print(report.summary())
    print("pool:", report.pool_stats)
    print("secondaries now running:",
          len(handler.pool.running_secondaries()), "(paused after idle TTL)")
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    run(reduced_config(get_config("qwen2.5-3b")), args.device)


if __name__ == "__main__":
    main()
