"""The serving path's own stamps and host ranges, on the CPU.

A tiny paged ``ClientHandler`` (reduced qwen2.5-3b, float32, the plain
path) serves under a scripted executor of fixed charges: a step that
carries any prefill costs ``JOIN_S`` on the timeline, a decode-only step
``DECODE_S``, and the link adds nothing, so every stamp can be worked out
from the executor's own record of the steps it ran.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.scheduler import ServeRequest
from repro_torch.core.trace import span
from repro_torch.launch import serve

JOIN_S, DECODE_S = 0.2, 0.05
CAP = 32
EPS = 1e-9

STEP_RANGES = ["serve.step.join", "serve.step.decode", "serve.step.mixed",
               "serve.step.suffix"]
MODEL_RANGES = ["model.embed", "model.unembed", "model.layer",
                "model.attn.qkv", "model.attn.kv", "model.attn.core",
                "model.attn.out", "model.mlp"]
RANGES = ["serve.admit", "serve.schedule", "serve.harvest"] + STEP_RANGES \
    + MODEL_RANGES


@pytest.fixture(scope="module")
def backend():
    torch.set_num_threads(1)
    cfg = reduced_config(get_config("qwen2.5-3b"))
    return serve.LMBackend(cfg, capacity=CAP, device="cpu", impl="torch")


@dataclasses.dataclass
class Step:
    submitted: float        # the handler's clock when the step went out
    charge: float
    prefill: bool           # the step carried a join or suffix rows

    @property
    def done(self) -> float:
        return self.submitted + self.charge


class Script:
    """``executor(clone, fn, args)`` charging fixed seconds by what the
    step closure carries, and recording every step it runs."""

    def __init__(self):
        self.clock = None
        self.steps = []

    def __call__(self, clone, fn, args):
        code = getattr(fn, "__code__", None)
        cells = getattr(fn, "__closure__", None) or ()
        free = dict(zip(code.co_freevars, (c.cell_contents for c in cells))
                    ) if code is not None else {}
        carried = any(free.get(k) is not None
                      for k in ("join_batch", "mixed_batch", "sfx_batch"))
        charge = JOIN_S if carried else DECODE_S
        self.steps.append(Step(self.clock(), charge, carried))
        return fn(*args), charge

    def submitted_at(self, t: float) -> Step:
        return next(s for s in self.steps if abs(s.submitted - t) < EPS)


def _handler(backend, **kw):
    script = Script()
    opts = dict(max_secondaries=0, max_batch=4, prompt_pad=8, block_size=4,
                decode_window=1, prefix_cache=False, link="nvlink")
    opts.update(kw)
    h = serve.ClientHandler(backend, executor=script, **opts)
    h._net_s = lambda nbytes: 0.0   # the timeline is the charges alone
    script.clock = h.clock.now
    return h, script


def _requests(times, new=5, plen=8, seed=0, prefix=None):
    rng = np.random.default_rng(seed)
    out = []
    for rid, t in enumerate(times):
        p = rng.integers(1, 200, plen).astype(np.int32)
        if prefix is not None:
            p[:len(prefix)] = prefix
        out.append(ServeRequest(rid, p, new, arrival_t=t))
    return out


def _serve(backend, reqs, **kw):
    h, script = _handler(backend, **kw)
    rep = h.run(reqs)
    return {c.rid: c for c in rep.completions}, script, h


def _stalls_from_record(c, steps) -> float:
    """Seconds of the prefill-carrying steps ``c`` decoded through: the
    steps in which it received a token other than its first."""
    return sum(s.charge for s in steps if s.prefill and any(
        s.submitted < t <= s.done + EPS for t in c.token_ts[1:]))


def _plain_tokens(backend, prompt, n, pad):
    """Greedy tokens of one request on the plain contiguous path."""
    toks = torch.zeros((1, pad), dtype=torch.int32)
    toks[0, :len(prompt)] = torch.as_tensor(prompt[:pad])
    tok, cache = backend.prefill(backend.params, toks)
    out = [int(tok[0])]
    for i in range(n - 1):
        tok, cache = backend.decode(backend.params, cache, tok[:, None],
                                    pad + i)
        out.append(int(tok[0]))
    return out


PAIRS = [0.0, 0.05, 0.3, 0.35, 0.6, 0.65, 0.9, 0.95]
SCENARIOS = {
    # cold joins arriving while other rows decode, one token a step
    "joins": dict(times=[0.0, 0.1, 0.12, 0.45, 0.5, 0.9], new=5, plen=8,
                  kw=dict()),
    # a pool too small for every slot: preemption, and suffix restores
    # fused into the decode window (mixed dispatch)
    "tight_pool": dict(times=PAIRS, new=10, plen=12,
                       kw=dict(prompt_pad=12, num_blocks=16,
                               prefill_chunk=4)),
    # the same at four tokens a step, stamped within each step
    "window4": dict(times=PAIRS, new=10, plen=12,
                    kw=dict(prompt_pad=12, num_blocks=14, decode_window=4,
                            prefill_chunk=4)),
}


def _scenario(backend, name):
    sc = SCENARIOS[name]
    reqs = _requests(sc["times"], sc["new"], sc["plen"])
    done, script, h = _serve(backend, reqs, **sc["kw"])
    assert len(done) == len(reqs)
    return reqs, done, script, h


def test_request_arriving_mid_step_waits_for_the_next_step(backend):
    """B arrives while A's join runs: a slot takes it at once, its join
    waits for the next step, and its first token comes when that step is
    done."""
    reqs = _requests([0.0, 0.1])
    done, script, _ = _serve(backend, reqs)
    a, b = done[0], done[1]
    assert script.steps[0].submitted == 0.0 and script.steps[0].prefill
    assert a.slot_t == a.prefill_t == 0.0
    assert b.slot_t == pytest.approx(0.1, abs=EPS)          # its due time
    nxt = next(s for s in script.steps if s.submitted > b.slot_t)
    assert nxt.submitted == pytest.approx(JOIN_S, abs=EPS) and nxt.prefill
    assert b.prefill_t == pytest.approx(nxt.submitted, abs=EPS)
    assert b.first_token_t == pytest.approx(nxt.done, abs=EPS)
    # A decoded through B's join: one stall of a whole join step
    assert a.stall_s == pytest.approx(JOIN_S, abs=EPS)


def test_preempted_request_keeps_its_first_stamps(backend):
    """A preempted request comes back with its first ``slot_t`` and
    ``prefill_t``; its ``stall_s`` carries over and only grows."""
    sc = SCENARIOS["tight_pool"]
    reqs = _requests(sc["times"], sc["new"], sc["plen"])
    h, script = _handler(backend, **sc["kw"])
    seen = {}
    preempt = h._preempt_slot

    def noted(engine, victim, counts):
        r = engine.slots[victim].req
        first = seen.setdefault(r.rid, (r.slot_t, r.prefill_t, r.stall_s))
        seen[r.rid] = first[:2] + (r.stall_s,)
        return preempt(engine, victim, counts)
    h._preempt_slot = noted
    done = {c.rid: c for c in h.run(reqs).completions}
    assert len(done) == len(reqs) and h.preemptions > 0 and seen
    for rid, (slot_t, prefill_t, stall_s) in seen.items():
        c = done[rid]
        assert reqs[rid].preemptions > 0
        assert (c.slot_t, c.prefill_t) == (slot_t, prefill_t)
        assert c.slot_t < c.prefill_t < c.first_token_t
        assert c.stall_s >= stall_s
    # one victim had stalled before its eviction and stalled again after
    assert any(0 < st < done[r].stall_s for r, (_, _, st) in seen.items())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_stall_is_the_prefill_steps_decoded_through(backend, name):
    """``stall_s`` equals the charges of the prefill-carrying steps in
    which the request decoded, counted from the executor's record."""
    _, done, script, _ = _scenario(backend, name)
    for c in done.values():
        assert c.stall_s == pytest.approx(
            _stalls_from_record(c, script.steps), abs=1e-9), c.rid
    assert sum(c.stall_s > 0 for c in done.values()) >= 2


def test_ttft_identity_and_tokens_unchanged(backend):
    """TTFT = slot wait + wait for the step + the request's own prefill
    step, each part stamped, the last one that step's charge; the served
    tokens are the plain path's greedy tokens."""
    reqs, done, script, _ = _scenario(backend, "joins")
    for r in reqs:
        c = done[r.rid]
        assert c.arrival_t <= c.slot_t <= c.prefill_t < c.first_token_t
        parts = ((c.slot_t - c.arrival_t) + (c.prefill_t - c.slot_t)
                 + (c.first_token_t - c.prefill_t))
        assert parts == pytest.approx(c.ttft_s, abs=1e-12)
        own = script.submitted_at(c.prefill_t)
        assert own.prefill
        assert c.first_token_t == pytest.approx(own.done, abs=EPS)
        assert c.tokens == _plain_tokens(backend, r.prompt,
                                         r.max_new_tokens, 8)
    assert any(c.prefill_t > c.slot_t for c in done.values())


def test_cohort_mode_stamps_slot_and_prefill(backend):
    """In the contiguous cohort mode a request takes its slot when its
    cohort starts, and that cohort's prefill dispatch stamps it."""
    reqs = _requests([0.0, 0.01, 0.3])
    done, script, _ = _serve(backend, reqs, kv="contiguous")
    for r in reqs:
        c = done[r.rid]
        assert c.slot_t is not None and c.slot_t >= c.arrival_t
        own = script.submitted_at(c.prefill_t)
        assert c.first_token_t == pytest.approx(own.done, abs=EPS)
        assert c.stall_s == 0.0
        assert c.tokens == _plain_tokens(backend, r.prompt,
                                         r.max_new_tokens, 8)


def test_span_is_the_shared_null_context_without_a_session():
    off = span("serve.step.decode")
    assert isinstance(off, contextlib.nullcontext)
    assert span("model.mlp") is off
    with profile(activities=[ProfilerActivity.CPU]):
        on = span("model.mlp")
        assert on is not off
        with on:
            torch.ones(2).sum()
    assert span("model.mlp") is off


def _events(prof):
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]


def _inside(ev, outer):
    return any(a <= ev[1] and ev[2] <= b for _, a, b in outer)


def test_profiled_window_holds_every_range_nested(backend):
    """One served window under the profiler holds every range: the
    handler's, each step kind, and the model's; each model range lies in
    a step range, each holds aten ops, every matrix product of a step lies
    in a model range, and no step runs inside the scheduling range.  The
    tokens equal those served with no session open."""
    prefix = np.arange(1, 9, dtype=np.int32)      # two whole blocks
    # A joins cold; B hits A's blocks while A decodes (a mixed step); C
    # hits them with no row decoding (a suffix step), then decodes alone
    times = [0.0, 0.3, 5.0]
    kw = dict(prompt_pad=12, prefix_cache=True, prefill_chunk=4)
    plain, _, _ = _serve(backend, _requests(times, plen=12, prefix=prefix),
                         **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        done, script, h = _serve(backend,
                                 _requests(times, plen=12, prefix=prefix),
                                 **kw)
    assert h.prefix_hit_tokens > 0
    assert {r: c.tokens for r, c in done.items()} == \
        {r: c.tokens for r, c in plain.items()}
    ev = _events(prof)
    names = {n for n, _, _ in ev}
    assert set(RANGES) <= names, sorted(set(RANGES) - names)
    steps = [e for e in ev if e[0] in STEP_RANGES]
    assert len(steps) == len(script.steps)
    model_ev = [e for e in ev if e[0] in MODEL_RANGES]
    assert all(_inside(e, steps) for e in model_ev)
    aten = [e for e in ev if e[0].startswith("aten::")]
    for name in MODEL_RANGES:
        ranges = [e for e in model_ev if e[0] == name]
        assert any(_inside(a, ranges) for a in aten), name
    mm = [e for e in aten if e[0] in ("aten::matmul", "aten::mm")
          and _inside(e, steps)]
    assert mm and all(_inside(e, model_ev) for e in mm)
    sched = [e for e in ev if e[0] == "serve.schedule"]
    assert not any(_inside(e, sched) for e in steps)
