"""One run of one cell: set-up, warm-up, the measured window, the check.

The window drives the port's ``repro_torch.launch.serve.ClientHandler.run``
over a paged KV pool on an ``LMBackend``, on the wall-paced timeline of
:class:`bench.executor.WallExecutor`.  Nothing modelled is left on that
timeline: the clone link is NVLink (1 us), the primary clone is running
before the window and no secondary exists, there is no gateway and no
fault.  What modelled time remains (``extra_delay`` of each dispatch) is
summed and printed beside the window's wall time.

Arrivals are an open loop from ``bench.traffic``: each request is due at
its time whatever the system does, and is timed from then.  Requests are
offered for ``seconds``; the handler then drains those in flight, and the
window runs from the first due time to the last completion.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench import counts, traffic, weights
from bench.cells import Cell
from bench.executor import WallExecutor
from bench.trace import Trace, Tracer

# Top-level modules no part of a run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a run leaves for the metric readers and the check."""

    cell: Cell
    shape: counts.Shape
    seed: int
    setup_s: float
    window_s: float
    arrivals: List[traffic.Arrival]
    due: Dict[int, float]               # rid -> due time on the timeline
    completions: Dict[int, object]      # rid -> ServeCompletion
    slot_admit: Dict[int, float]        # rid -> time a slot took it
    steps: list                         # executor Steps of the window
    hit_tokens: int
    prompt_tokens: int
    memory_peak_bytes: int
    trace: Optional[Trace] = None
    decode_work: Optional[counts.Launches] = None
    prefill_work: Optional[counts.Launches] = None
    params: Optional[Dict] = None       # the weights, for the check


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def port_config(conf: dict):
    """The port's ``ModelConfig`` with every number of the configuration
    file: the file is the configuration as it is run."""
    from repro_torch.configs import get_config
    base = get_config(conf["port_config"])
    return dataclasses.replace(
        base, n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"], head_dim=conf["head_dim"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        rope_theta=float(conf["rope_theta"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]),
        qkv_bias=bool(conf["attention_bias"]),
        n_experts=conf.get("num_experts", 0),
        top_k=conf.get("num_experts_per_tok", 0), dtype=conf["dtype"],
        window=None)


def _histogram(steps) -> Dict[str, str]:
    """Steps by kind and rows: how many, and their median charge (ms)."""
    by: Dict[str, List[float]] = {}
    for s in steps:
        by.setdefault(f"{s.kind}:{s.rows}", []).append(s.charge_s)
    return {k: f"{len(v)} x {1e3 * float(np.median(v)):.1f}"
            for k, v in sorted(by.items())}


def _same_steps(steps, labels: List[Optional[str]]) -> None:
    """The executor's steps against the handler's own dispatches: one
    step a dispatch, and a decode window in each step that the handler
    labelled ``"step"`` (a step with no decode it labels ``"prefill"``)."""
    decodes = sum(s.decodes for s in steps)
    if len(steps) != len(labels) or labels.count("step") != decodes:
        raise counts.StepDrift(
            f"the executor saw {len(steps)} steps, {decodes} with a decode "
            f"window; the handler dispatched {len(labels)}, "
            f"{labels.count('step')} labelled 'step'")


def _requests(arrivals, base: float):
    from repro_torch.core.scheduler import ServeRequest
    return [ServeRequest(a.rid, a.prompt, a.max_new_tokens,
                         arrival_t=base + a.due_s) for a in arrivals]


def _run_requests(handler, arrivals, base: float):
    reqs = _requests(arrivals, base)
    report = handler.run(reqs)
    done = {c.rid: c for c in report.completions}
    return reqs, done


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", impl: str = "cuda",
             before_window: Optional[Callable] = None,
             log: Callable[[str], None] = print) -> Run:
    """Set up, warm up and serve one window of ``cell``.  The handler and
    its pools are freed before this returns; the weights are kept for the
    check, in ``Run.params``."""
    shape = counts.Shape.of(cell.conf)
    cfg = port_config(cell.conf)
    dev = torch.device(device)
    params = weights.make(shape, cfg.tie_embeddings, cfg.qkv_bias, seed,
                          dev)
    from repro_torch.models import model
    weights.check_layout(params, model.init_abstract(cfg))
    if impl == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    run = _serve(cell, cfg, shape, params, seed, seconds, trace, t_start,
                 dev, impl, before_window, log)
    # the handler, its pools and the closures around it form cycles that
    # only the collector frees: free them before anything else runs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return run


def _serve(cell, cfg, shape, params, seed, seconds, trace, t_start, dev,
           impl, before_window, log) -> Run:
    from repro_torch.launch.serve import ClientHandler, LMBackend

    mix = cell.mix
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    h = mix["handler"]
    backend = LMBackend(cfg, capacity=int(h["capacity"]), params=params,
                        device=dev, impl=impl)
    ex = WallExecutor(sync)
    handler = ClientHandler(
        backend, link="nvlink", max_batch=int(h["max_batch"]),
        queue_depth=1 << 30, max_secondaries=0, provision_paused=False,
        kv="paged", block_size=int(h["block_size"]),
        num_blocks=h.get("num_blocks"), prefix_cache=bool(h["prefix_cache"]),
        decode_window=int(h["decode_window"]),
        prefill_chunk=h.get("prefill_chunk"),
        prompt_pad=traffic.prompt_tokens(mix["prompt"]), executor=ex)
    # spans from the harness's side: the time a slot takes each request,
    # and the modelled seconds each dispatch still carries
    slot_admit: Dict[int, float] = {}
    admit = handler._admit

    def timed_admit(engine, req):
        slot_admit.setdefault(req.rid, handler.clock.now())
        return admit(engine, req)
    handler._admit = timed_admit
    modelled: List[float] = []
    labels: List[Optional[str]] = []
    submit = handler.dispatcher.submit

    def noted_submit(*a, **k):
        task = submit(*a, **k)
        modelled.append(task.extra_delay)
        labels.append(k.get("label"))
        return task
    handler.dispatcher.submit = noted_submit

    # warm-up: every shape of the window, then nothing of it is kept
    wu = traffic.warmup(mix, shape.vocab)
    _, w_done = _run_requests(handler, wu, handler.clock.now())
    if len(w_done) != len(wu):
        raise RuntimeError(f"warm-up served {len(w_done)} of {len(wu)}")
    log(f"warm-up: {len(wu)} requests, {len(ex.steps)} steps, "
        f"{sum(s.charge_s for s in ex.steps):.3f} s on the timeline")
    slot_admit.clear()
    modelled.clear()
    labels.clear()
    hit0, prompt0 = handler.prefix_hit_tokens, handler.prompt_tokens
    arrivals = traffic.generate(mix, shape.vocab, seed, seconds)
    if before_window is not None:
        before_window(handler)
    gc.collect()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    decode_work, prefill_work = counts.Launches(), counts.Launches()
    tracer = None
    if trace:
        tw = mix["trace"]
        chunk = int(handler.prefill_chunk)
        max_slots = int(h["max_batch"])
        bs = int(h["block_size"])

        def counter(free, args):
            counts.step_work(free, args, max_slots, bs, chunk, shape,
                             decode_work, prefill_work)
        # the stretch is placed on the serving timeline
        tracer = Tracer(ex, float(tw["start_frac"]) * seconds,
                        float(tw["seconds"]), counter, handler.clock.now)
    base = handler.clock.now()
    setup_s = time.perf_counter() - t_start
    ex.start()
    if tracer is not None:
        tracer.arm()
    w0 = time.perf_counter()
    reqs, done = _run_requests(handler, arrivals, base)
    wall = time.perf_counter() - w0
    if tracer is not None:
        tracer.stop()
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    _same_steps(ex.steps, labels)
    due = {r.rid: r.arrival_t for r in reqs}
    first_due = min(due.values())
    last_done = max((c.done_t for c in done.values()), default=first_due)
    window_s = last_done - first_due
    log(f"window: {len(done)} of {len(reqs)} requests finished, "
        f"{window_s:.4f} s from the first due time to the last completion "
        f"on the timeline, {wall:.4f} s of wall time; modelled seconds on "
        f"the timeline: {sum(modelled):.6f} over {len(modelled)} dispatches;"
        f" preemptions {handler.preemptions}; steps by kind and rows "
        f"{_histogram(ex.steps)}")
    return Run(cell, shape, seed, setup_s, window_s, arrivals, due, done,
               dict(slot_admit), list(ex.steps),
               handler.prefix_hit_tokens - hit0,
               handler.prompt_tokens - prompt0, peak,
               tracer.trace if tracer is not None else None,
               decode_work if trace else None,
               prefill_work if trace else None, params)
