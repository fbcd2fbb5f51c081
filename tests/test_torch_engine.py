"""The port's batch ``ServingEngine`` and the handler's step-cost telemetry
against the reference, on the CPU (float32, reduced configs).

``ServingEngine`` serves the same requests on shared weights
(``weights.from_jax`` of the reference backend's params) with the placement
forced local, remote, and remote over two clones (split prefill, caches
merged on each leaf's batch axis): tokens, ``stats`` and the prefill and
decode venue names equal the reference engine's, for reduced smollm-360m and
reduced rwkv6-7b (recurrent state leaves) alike; a working set past the
clone heap escalates the same number of times to the same venue.  The
``ClientHandler`` closures carry the reference's step-cost attributes
(``seq_steps``, ``step_scale``, ``prefill_tokens``) dispatch by dispatch,
and ``ServeReport.per_clone`` equals the reference handler's.
"""
import numpy as np
import pytest
import torch

import test_torch_serve as tsv
import test_torch_spec as ts
from repro.core.scheduler import ServeRequest as JRequest
from repro.launch import serve as jserve
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.policy import Policy
from repro_torch.core.scheduler import ServeRequest
from repro_torch.launch import serve as tserve

CAP = tsv.CAP


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager torch on the CPU pays more for its thread pool than for a
    reduced model's small ops; one thread keeps the runs short."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(cls, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, 256, n, dtype=np.int32), new)
            for i, (n, new) in enumerate([(5, 4), (8, 3), (6, 4)])]


def _engines(arch, impl):
    b = tsv._backends(arch)
    jeng = jserve.ServingEngine(b["jb"].cfg, capacity=CAP, backend=b["jb"])
    backend = tserve.LMBackend(b["tcfg"], capacity=CAP, params=b["tp"],
                               device="cpu", impl=impl)
    teng = tserve.ServingEngine(b["tcfg"], capacity=CAP, backend=backend)
    return jeng, teng


def _serve(eng, reqs, **kw):
    return [(c.rid, [int(t) for t in c.tokens], c.prefill_venue,
             c.decode_venue, c.escalations)
            for c in eng.serve_batch(reqs, **kw)]


@pytest.mark.parametrize("arch,impl,force,n_clones", [
    ("smollm-360m", "cuda", "local", 1),
    ("smollm-360m", "cuda", "remote", 1),
    ("smollm-360m", "torch", "remote", 2),
    ("smollm-360m", "cuda", "remote", 2),
    ("rwkv6-7b", "cuda", "remote", 2),
])
def test_serving_engine_matches_reference(arch, impl, force, n_clones):
    jeng, teng = _engines(arch, impl)
    want = _serve(jeng, _requests(jserve.Request), force=force,
                  n_clones=n_clones)
    got = _serve(teng, _requests(tserve.Request), force=force,
                 n_clones=n_clones)
    assert got == want
    assert teng.stats == jeng.stats
    venue = {"local": "phone", "remote": "main"}[force]
    assert got[0][2] == (f"main x{n_clones}" if n_clones > 1 else venue)
    assert got[0][3] == venue and len(got[0][1]) == 4


def test_serving_engine_escalation_matches_reference(monkeypatch):
    """A KV working set past the clone types' 100 MiB heap climbs the
    ladder to its top (main -> x8large: 4 escalations) in both engines."""
    jeng, teng = _engines("smollm-360m", "cuda")
    big = lambda batch: 168 * 10 ** 6              # noqa: E731
    monkeypatch.setattr(jeng.backend, "cache_mem_bytes", big)
    monkeypatch.setattr(teng.backend, "cache_mem_bytes", big)
    want = _serve(jeng, _requests(jserve.Request), force="remote")
    got = _serve(teng, _requests(tserve.Request), force="remote")
    assert got == want and teng.stats == jeng.stats
    assert got[0][2] == "x8large" and got[0][4] == 4
    assert teng.ec.decisions == jeng.ec.decisions


def test_serving_engine_stats_and_placements():
    """offloaded counts the prefill and every decode step; local and
    offloaded runs give the same tokens; the unforced EXEC_TIME engine
    sends the first encounter remote over wifi-local."""
    b = tsv._backends("smollm-360m")
    backend = tserve.LMBackend(b["tcfg"], capacity=CAP, params=b["tp"],
                               device="cpu")
    eng = tserve.ServingEngine(b["tcfg"], capacity=CAP, backend=backend)
    assert eng.ec.phone.device == torch.device("cpu")
    reqs = [tserve.Request(0, np.arange(6, dtype=np.int32), 3)]
    a = eng.serve_batch(reqs, force="remote")
    assert eng.stats["offloaded"] == 4
    b_ = eng.serve_batch(reqs, force="local")
    assert eng.stats["offloaded"] == 4 and a[0].tokens == b_[0].tokens
    c = eng.serve_batch(reqs)
    assert c[0].tokens == a[0].tokens and c[0].latency_s > 0
    assert eng.ec.decisions["remote"] >= 1


def test_serving_engine_and_cli_need_a_card_unless_asked(capsys):
    cfg = reduced_config(get_config("smollm-360m"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.ServingEngine(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--requests", "1"])
    eng = tserve.ServingEngine(cfg, capacity=CAP, device="cpu",
                               policy=Policy.NONE)
    assert eng.backend.device == torch.device("cpu")
    tserve.main(["--requests", "2", "--new-tokens", "2", "--batch", "2",
                 "--device", "cpu", "--policy", "none"])
    out = capsys.readouterr().out
    assert "venue=phone" in out and "'requests': 2" in out


# --------------------------------------------------------------------------- #
# step-cost attributes and per-clone telemetry (ClientHandler)
# --------------------------------------------------------------------------- #
COST = ("seq_steps", "step_scale", "prefill_tokens")


def _handler_run(kind, trace, draft=None, **kw):
    """Serve ``trace`` on reduced smollm-360m, recording the step-cost
    attributes of every closure the fixed-time executor is handed."""
    s = ts._setup()
    if kind == "jax":
        backend = ts._jax_backend(draft or "oracle")
        cls, req = jserve.ClientHandler, JRequest
    else:
        dkw = ({} if draft is None
               else dict(draft=s["tdcfg"], draft_params=s["tdp"]))
        backend = tserve.LMBackend(s["tcfg"], capacity=32, params=s["tp"],
                                   device="cpu", impl="cuda", **dkw)
        cls, req = tserve.ClientHandler, ServeRequest
    costs = []

    def executor(c, f, a):
        costs.append(tuple(getattr(f, k, None) for k in COST))
        return f(*a), 0.05

    rep = cls(backend, executor=executor, **kw).run(
        [req(i, p, n, arrival_t=t) for i, p, n, t in trace])
    return {c.rid: [int(x) for x in c.tokens] for c in rep.completions}, \
        rep, costs


HANDLER_CASES = {
    # mixed dispatch: joins, copy-on-write, suffix chunks in the window
    "mixed": (dict(max_batch=4, prompt_pad=12, block_size=4,
                   max_secondaries=0, decode_window=4, prefill_chunk=4),
              None, lambda: tsv._trace(1, restore_pairs=True)),
    # speculative rounds with the reduced draft at an explicit draft cost
    "spec": (dict(max_batch=4, prompt_pad=12, block_size=4,
                  max_secondaries=2, decode_window=1, prefill_chunk=4,
                  speculative=True, spec_k=3, draft_cost=0.25),
             "real", lambda: ts._trace(shared=True)),
    # disaggregated prefill on a partner clone, handoffs on one link
    "disagg": (dict(max_batch=4, prompt_pad=12, block_size=4,
                    max_secondaries=4, decode_window=4, prefill_chunk=4,
                    fleet=["basic", "large"], clone_type="basic",
                    disagg=True, disagg_min_prompt=1,
                    disagg_prefill_type="large", disagg_link="wifi-local"),
               None, lambda: ts._trace(shared=True)),
}


@pytest.mark.parametrize("name", sorted(HANDLER_CASES))
def test_step_costs_and_per_clone_match_reference(name):
    kw, draft, trace_fn = HANDLER_CASES[name]
    want, jrep, jcosts = _handler_run("jax", trace_fn(), draft, **kw)
    got, trep, tcosts = _handler_run("torch", trace_fn(), draft, **kw)
    assert got == want
    assert tcosts == jcosts and any(c[0] for c in tcosts)
    assert trep.per_clone == jrep.per_clone and trep.per_clone
    if name == "spec":
        assert any(c[1] == 0.25 for c in tcosts)      # the draft closures
    if name == "disagg":
        assert trep.disagg_handoffs >= 1
        assert any(v["kv_transfer_bytes"] > 0
                   for v in trep.per_clone.values())
