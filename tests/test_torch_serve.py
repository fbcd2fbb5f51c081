"""Port ClientHandler vs reference ClientHandler on shared weights (CPU).

Both handlers serve the same seeded traces (prefix-sharing requests, so
prefix hits, copy-on-write, chunked suffix prefill and mixed dispatch all
run) under the same fixed-time executor; per-request tokens must be
identical.  The port runs float32 on the CPU through both of its paths:
``impl="torch"`` (plain gathered attention) and ``impl="cuda"`` (the
kernel wrappers, which run their plain versions on CPU tensors).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core.scheduler import ServeRequest as JRequest
from repro.launch import serve as jserve
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.faults import CloneFault
from repro_torch.core.gateway import StreamingGateway
from repro_torch.core.scheduler import ServeRequest
from repro_torch.launch import serve as tserve
from repro_torch.models import weights

CAP = 32
_BACKENDS = {}


def _fixed(c, f, a):
    return f(*a), 0.05


def _backends(arch="smollm-360m"):
    """(reference backend, port params) of reduced ``arch`` on the
    reference's PRNGKey(0) weights, built once per worker."""
    if arch not in _BACKENDS:
        cfg = reduced_config(get_config(arch))
        jb = jserve.LMBackend(cfg, capacity=CAP)
        tcfg = t_reduced_config(t_get_config(arch))
        tp = weights.from_jax(jax.tree.map(np.asarray, jb.params), tcfg)
        _BACKENDS[arch] = dict(jb=jb, tcfg=tcfg, tp=tp)
    return _BACKENDS[arch]


def _trace(seed, n=8, tail=4, new=6, gap=0.08, restore_pairs=False):
    """Shared-prefix requests: an 8-token prefix, then tails whose first
    token diverges (full-block hits) or whose first two tokens agree with
    another request's (copy-on-write of the divergent block)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, 8, dtype=np.int32)
    out = []
    for i in range(n):
        t = rng.integers(0, 256, tail, dtype=np.int32)
        t[0] = i // 2 if restore_pairs else i
        out.append((i, np.concatenate([prefix, t]), new, gap * i))
    return out


def _run(kind, trace, impl="torch", arch="smollm-360m", **kw):
    b = _backends(arch)
    if kind == "jax":
        backend = b["jb"]
        reqs = [JRequest(i, p, n, arrival_t=t) for i, p, n, t in trace]
        cls = jserve.ClientHandler
    else:
        backend = tserve.LMBackend(b["tcfg"], capacity=CAP, params=b["tp"],
                                   device="cpu", impl=impl)
        reqs = [ServeRequest(i, p, n, arrival_t=t) for i, p, n, t in trace]
        cls = tserve.ClientHandler
    kw.setdefault("executor", _fixed)
    h = cls(backend, max_secondaries=0, **kw)
    rep = h.run(reqs)
    return ({c.rid: [int(x) for x in c.tokens] for c in rep.completions},
            rep)


SCENARIOS = {
    # block 4, chunk 4, mixed: hits, CoW, chunked suffix + mixed dispatch
    "chunk4_mixed": dict(max_batch=4, prompt_pad=12, block_size=4,
                         decode_window=4, prefill_chunk=4),
    # the handler's defaults: block 8, chunk 8, mixed dispatch on
    "defaults": dict(max_batch=4, prompt_pad=16, decode_window=2),
    # split dispatch (suffix prefill separate from the decode window)
    "chunk4_split": dict(max_batch=4, prompt_pad=12, block_size=4,
                         decode_window=3, prefill_chunk=4,
                         mixed_dispatch=False),
    # stepwise suffix prefill
    "stepwise": dict(max_batch=4, prompt_pad=12, block_size=4,
                     decode_window=4, prefill_chunk=0),
    # tight pool: preemption and prefix-accelerated restore
    "tight_pool": dict(max_batch=4, prompt_pad=12, block_size=4,
                       num_blocks=9, decode_window=4, prefill_chunk=4),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_handler_tokens_match_reference(name):
    """Per-request tokens identical to the reference handler, and the
    prefix-cache economics (hits, CoW, preemptions) identical too."""
    kw = SCENARIOS[name]
    new = 10 if name == "tight_pool" else 6
    trace = _trace(1, new=new, restore_pairs=name != "tight_pool")
    want, jrep = _run("jax", trace, **kw)
    got, trep = _run("torch", trace, **kw)
    assert len(want) == 8 and got == want
    assert trep.prefix_hit_rate == jrep.prefix_hit_rate > 0
    assert trep.preemptions == jrep.preemptions
    assert trep.restored_tokens == jrep.restored_tokens
    if name == "tight_pool":
        assert trep.preemptions > 0 and trep.restored_tokens > 0


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_port_handler_qwen_tokens_match_reference(impl):
    """Reduced qwen2.5-3b (GQA group 8, QKV bias, tied embedding) through
    the paged handler at its defaults (block 8, chunk 8, mixed dispatch):
    the chunked prefill runs C * g = 64 query rows per kv-head; per-request
    tokens identical to the reference handler's, through the plain path
    and the kernel wrappers."""
    tcfg = _backends("qwen2.5-3b")["tcfg"]
    assert (tcfg.n_heads // tcfg.n_kv_heads, tcfg.qkv_bias,
            tcfg.tie_embeddings) == (8, True, True)
    kw = dict(max_batch=4, prompt_pad=16, decode_window=2)
    trace = _trace(4, restore_pairs=True)
    want, jrep = _run("jax", trace, arch="qwen2.5-3b", **kw)
    got, trep = _run("torch", trace, impl=impl, arch="qwen2.5-3b", **kw)
    assert len(want) == 8 and got == want
    assert trep.prefix_hit_rate == jrep.prefix_hit_rate > 0


def test_port_handler_kernel_wrappers_match_plain_path():
    """impl="cuda" routes attention through the kernel wrappers (plain
    versions on CPU tensors); its tokens equal the plain path's."""
    trace = _trace(2, restore_pairs=True)
    kw = SCENARIOS["chunk4_mixed"]
    a, _ = _run("torch", trace, impl="torch", **kw)
    b, _ = _run("torch", trace, impl="cuda", **kw)
    assert a == b and len(a) == 8


def test_step_fn_is_idempotent():
    """Every dispatched step closure, run twice on its inputs, leaves the
    same pool and returns the same tokens — the in-place pool update is
    safe under executors that re-run closures (Venue re-times them)."""
    checked = []

    def twice(c, f, a):
        out1 = f(*a)
        snap = [t.clone() for t in _pool_leaves(a[1])]
        toks1 = [None if x is None else x.clone() for x in out1[:3]]
        out2 = f(*a)
        for s, t in zip(snap, _pool_leaves(a[1])):
            assert torch.equal(s, t)
        for x, y in zip(toks1, out2[:3]):
            assert (x is None and y is None) or torch.equal(x, y)
        checked.append(1)
        return out2, 0.05

    trace = _trace(3, restore_pairs=True)
    got, _ = _run("torch", trace, executor=twice,
                  **SCENARIOS["chunk4_mixed"])
    want, _ = _run("torch", trace, **SCENARIOS["chunk4_mixed"])
    assert got == want
    assert len(checked) >= 3


def _pool_leaves(pool):
    return [node[k] for grp in ("stack", "rest") for node in pool[grp].values()
            for k in ("k", "v")]


@pytest.mark.parametrize("kw", [
    dict(hedge_factor=2.0),
    dict(faults=[CloneFault(at=1.0)]),
    dict(faults=[CloneFault(at=1.0)], hedge_factor=2.0,
         gateway=StreamingGateway()),
])
def test_faults_and_hedging_require_paged_kv(kw):
    """The reference's ``test_faults_require_paged_kv`` on the LM backend:
    the cohort mode keeps no per-slot restore state, so faults and hedges
    raise there; the paged mode takes them, and the gateway, as the
    reference does."""
    b = _backends()
    backend = tserve.LMBackend(b["tcfg"], capacity=CAP, params=b["tp"],
                               device="cpu")
    with pytest.raises(ValueError, match="kv='paged'"):
        tserve.ClientHandler(backend, executor=_fixed, kv="contiguous",
                             **kw)
    h = tserve.ClientHandler(backend, executor=_fixed, **kw)
    assert (h.injector is not None) == ("faults" in kw)
    assert h.hedge_factor == kw.get("hedge_factor", 0.0)
    assert h.gateway is kw.get("gateway")


def test_handler_validation_errors():
    b = _backends()
    backend = tserve.LMBackend(b["tcfg"], capacity=CAP, params=b["tp"],
                               device="cpu")
    with pytest.raises(ValueError, match="decode_window"):
        tserve.ClientHandler(backend, decode_window=0)
    with pytest.raises(ValueError, match="mixed_dispatch requires"):
        tserve.ClientHandler(backend, prefill_chunk=0, mixed_dispatch=True)
    with pytest.raises(ValueError, match="kv must be"):
        tserve.ClientHandler(backend, kv="ring")
    with pytest.raises(ValueError, match="contiguous cohort path"):
        tserve.ClientHandler(backend, kv="contiguous", decode_window=2)


def test_lm_backend_rejects_windowed_and_recurrent_configs():
    """A vision-frontend model (paligemma) binds like the reference's, its
    frontend projection among the parameters; the RG-LRU hybrid with its
    sliding window (recurrentgemma, tests/test_torch_rglru.py) and RWKV-6
    (tests/test_torch_rwkv6.py) are served through kv='contiguous' only."""
    cfg = t_reduced_config(t_get_config("paligemma-3b"))
    backend = tserve.LMBackend(cfg, capacity=CAP, device="cpu")
    assert "proj" in backend.params["frontend"]
    cfg = t_reduced_config(t_get_config("recurrentgemma-2b"))
    backend = tserve.LMBackend(cfg, capacity=CAP, device="cpu")
    with pytest.raises(NotImplementedError, match="full attention"):
        tserve.ClientHandler(backend, executor=_fixed)


def test_pow2_bucket_and_kv_pool_bookkeeping():
    assert [tserve.pow2_bucket(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    with pytest.raises(ValueError):
        tserve.pow2_bucket(0)
    b = _backends()
    backend = tserve.LMBackend(b["tcfg"], capacity=16, params=b["tp"],
                               device="cpu")
    kv = tserve.KVBlockPool(backend, max_slots=2, block_size=4)
    prompt = np.arange(12, dtype=np.int32)
    slot, new_ids, cached, cow = kv.alloc_slot(prompt)
    assert cached == 0 and cow is None and len(new_ids) == 3
    other = prompt.copy()
    other[10:] = 99
    slot2, new2, cached2, cow2 = kv.alloc_slot(other)
    # two full blocks shared, the third matched partway: copy-on-write
    assert cached2 == 10 and cow2[0] == kv.tables[slot, 2]
    assert len(new2) == 0
    assert kv.ref[kv.tables[slot, 0]] == 2
    kv.free_slot(slot)
    kv.free_slot(slot2)
    assert kv.used_blocks() == 0
    assert kv.available_blocks() == kv.num_blocks - 1
