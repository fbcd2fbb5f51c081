"""Disaggregated prefill and the int8 KV handoff in the port vs the
reference (CPU, float32 pools unless named).

The int8 pair: payload equal, scales within 1e-6 relative, on (blocks,
bs, heads, D) leaves, leaves of ndim < 3 (per-block scales) and all-zero
blocks, float32 and bfloat16.  ``LMBackend.migrate_fn`` against the
reference's on the same pools and ids (0 -> 0 pads included): equal
uncompressed, within 1e-6 compressed (the reference's slot-id arguments
address recurrent-state rows the port's paged pool never holds).  The handler with ``disagg=True``
against the reference handler on shared weights: token streams and the
counters ``disagg_handoffs`` / ``disagg_colocated`` / ``disagg_fallbacks``
/ ``kv_transfer_bytes`` equal, uncompressed streams equal to the
co-located ones, and every pool's blocks conserved after the drain under
ledger, affinity and random routing.  A torch fake backend mirrors the
reference's fake-backend scenarios.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_spec as ts
from repro.core.scheduler import ServeRequest as JRequest
from repro.distributed import compression as jcomp
from repro.launch import serve as jserve
from repro_torch.core.scheduler import ServeRequest
from repro_torch.distributed import compression as tcomp
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm


def _pair(rng, shape, dtype, zero_first=False):
    """One numpy draw as (torch, jax) tensors of ``dtype`` (bf16 rounded
    once, in torch, and handed to jax as its float32 values)."""
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    if zero_first:
        x[0] = 0.0
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8, 2, 16), (3, 6, 4), (5, 12), (6,)])
def test_int8_kv_pair_matches_reference(shape, dtype):
    t, j = _pair(np.random.default_rng(len(shape)), shape, dtype,
                 zero_first=True)
    q, sc = ops.quantize_kv_blocks(t)
    jq, jsc = jcomp.quantize_kv_blocks(j)
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    assert tuple(sc.shape) == tuple(jsc.shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-6,
                               atol=0)
    assert not q[0].any()                 # an all-zero block stays zero
    deq = ops.dequantize_kv_blocks(q, sc, dtype=t.dtype)
    jdeq = jcomp.dequantize_kv_blocks(jq, jsc, dtype=j.dtype)
    assert deq.dtype == t.dtype
    np.testing.assert_allclose(deq.float().numpy(),
                               np.asarray(jdeq.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-6)
    assert not deq[0].any()
    if len(shape) > 1:
        assert int(q.abs().max()) == 127     # the full symmetric range


def test_int8_tensor_pair_matches_reference():
    t, j = _pair(np.random.default_rng(3), (5, 7), "float32")
    q, sc = tcomp.quantize_int8(t)
    jq, jsc = jcomp.quantize_int8(j)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(sc), float(jsc), rtol=1e-6)
    np.testing.assert_allclose(tcomp.dequantize_int8(q, sc).numpy(),
                               np.asarray(jcomp.dequantize_int8(jq, jsc)),
                               rtol=1e-6)
    assert tcomp.kv_quant_axes(4) == jcomp.kv_quant_axes(4) == (1, 3)
    assert tcomp.kv_quant_axes(2) == jcomp.kv_quant_axes(2) == (1,)


@pytest.mark.parametrize("compress", [False, True])
def test_migrate_fn_matches_reference(compress):
    """Blocks 3, 5, 6 of one pool into blocks 7, 2, 4 of another, with
    two 0 -> 0 pads, on reduced smollm-360m pools."""
    s = ts._setup()
    jb = ts._jax_backend("oracle")
    tb = tserve.LMBackend(s["tcfg"], capacity=32, params=s["tp"],
                          device="cpu")
    rng = np.random.default_rng(4)
    pools = []
    for _ in range(2):
        t = tm.init_paged_cache(s["tcfg"], 2, 9, 4)
        for leaf in tm._tree_leaves(t):
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(tuple(leaf.shape)).astype(np.float32)))
        pools.append(t)
    jpools = [jax.tree.map(lambda x: jnp.asarray(x.numpy()), p)
              for p in pools]
    ids = ([3, 5, 6, 0, 0], [7, 2, 4, 0, 0], [1, 0], [0, 2])
    want = jb.migrate_fn(compress)(jpools[0], jpools[1],
                                   *(jnp.asarray(x, jnp.int32) for x in ids))
    got = tb.migrate_fn(compress)(pools[0], pools[1],
                                  *(tb.tensor(x) for x in ids[:2]))
    assert got is pools[0]                      # written in place
    for g, w in zip(tm._tree_leaves(got), jax.tree.leaves(want)):
        if compress:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------- #
# handler level, real reduced model
# --------------------------------------------------------------------------- #
def _reqs(kind, trace):
    cls = JRequest if kind == "jax" else ServeRequest
    return [cls(i, p, n, arrival_t=t) for i, p, n, t in trace]


def _serve(kind, trace, impl="torch", **kw):
    s = ts._setup()
    if kind == "jax":
        backend, cls = ts._jax_backend("oracle"), jserve.ClientHandler
        if kw.get("disagg"):
            kw["disagg_link"] = "ici"
    else:
        backend = tserve.LMBackend(s["tcfg"], capacity=32, params=s["tp"],
                                   device="cpu", impl=impl)
        cls = tserve.ClientHandler
    h = cls(backend, block_size=4, executor=ts._fixed, **kw)
    rep = h.run(_reqs(kind, trace))
    return {c.rid: [int(x) for x in c.tokens] for c in rep.completions}, \
        rep, h


COUNTERS = ("disagg_handoffs", "disagg_colocated", "disagg_fallbacks",
            "kv_transfer_bytes")
DISAGG = dict(fleet=["basic", "large"], clone_type="basic", disagg=True,
              disagg_min_prompt=1, disagg_prefill_type="large")


def _lm_trace():
    """The reference's disagg trace: 4 prompts sharing an 8-token prefix,
    diverging at the block boundary, 6 new tokens each."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 256, 8, dtype=np.int32)
    out = []
    for i in range(4):
        tail = rng.integers(0, 256, 4, dtype=np.int32)
        tail[0] = i
        out.append((i, np.concatenate([prefix, tail]), 6, 0.05 * i))
    return out


@pytest.mark.parametrize("compress,impl,chunk", [
    (False, "torch", 8), (False, "cuda", 8), (True, "cuda", 8),
    (False, "cuda", 0)])
def test_disagg_handler_matches_reference(compress, impl, chunk):
    """Handoffs through the partner's chunked (or, at chunk 0, stepwise)
    paged prefill: streams and counters equal the reference handler's;
    uncompressed streams equal the co-located ones."""
    kw = dict(max_batch=4, prompt_pad=12, max_secondaries=4,
              decode_window=4, prefill_chunk=chunk, **DISAGG,
              disagg_compress=compress)
    trace = _lm_trace()
    want, jrep, _ = _serve("jax", trace, **kw)
    got, trep, _ = _serve("torch", trace, impl=impl, **kw)
    assert got == want and len(got) == 4
    for key in COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.disagg_handoffs >= 1 and trep.kv_transfer_s > 0
    if not compress:
        colocated, _, _ = _serve(
            "torch", trace, impl=impl, max_batch=4, prompt_pad=12,
            max_secondaries=4, decode_window=4, prefill_chunk=chunk)
        assert got == colocated


def _assert_blocks_conserved(kv):
    """After the drain: no live refcount, free and cached-free partition
    blocks 1..N-1, no duplicate on the free list."""
    assert not np.asarray(kv.ref).any()
    free, cached = set(kv._free_blocks), set(kv._cached_free)
    assert len(kv._free_blocks) == len(free)
    assert not free & cached
    assert free | cached == set(range(1, kv.num_blocks))


def _affinity_trace(seed):
    """The reference's affinity trace: 2 prompt families x 3 requests."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 256, 8, dtype=np.int32) for _ in range(2)]
    out = []
    for i in range(6):
        tail = rng.integers(0, 256, 4, dtype=np.int32)
        tail[0] = i
        out.append((i, np.concatenate([prefixes[i % 2], tail]), 6,
                    float(rng.uniform(0.0, 0.6))))
    return out


@pytest.mark.parametrize("routing,disagg,compress", [
    ("ledger", False, False), ("affinity", True, False),
    ("random", True, False), ("affinity", True, True),
    ("random", False, False)])
def test_routing_matches_reference_and_conserves_blocks(routing, disagg,
                                                        compress):
    kw = dict(max_batch=2, prompt_pad=12, max_secondaries=4,
              decode_window=4, clone_type="basic", use_primary=False,
              routing=routing)
    if disagg:
        kw.update(DISAGG, disagg_compress=compress)
    else:
        kw["fleet"] = ["basic", "large"]
    trace = _affinity_trace(3)
    want, jrep, _ = _serve("jax", trace, **kw)
    got, trep, h = _serve("torch", trace, impl="cuda", **kw)
    assert got == want and len(got) == 6
    for key in COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.prefix_hit_rate == jrep.prefix_hit_rate
    for kv in list(h._kv_pools.values()) + list(h._prefill_pools.values()):
        _assert_blocks_conserved(kv)
    if disagg:
        assert trep.disagg_handoffs >= 1 and trep.disagg_fallbacks == 0


# --------------------------------------------------------------------------- #
# handler level, fake backend (the reference's DisaggFakeBackend scenarios)
# --------------------------------------------------------------------------- #
class DisaggFakeBackend(ts.FakeBackend):
    """Every prefill (local, chunked or on the partner) emits first token
    0 and decode counts up, so streams do not depend on where a prefill
    ran; the block bookkeeping and the token carry are under test."""

    supports_chunked = True

    def mixed_fn(self, block_size, chunk, num_steps):
        _, decode_window = self.paged_fns(block_size, num_steps)

        def mixed(params, pool, tok, pos, steps_left, tables, stoks, spos,
                  sn, stabs):
            out, pool = decode_window(params, pool, tok, pos, steps_left,
                                      tables)
            return out, torch.zeros(stoks.shape[0], dtype=torch.int32), pool

        return mixed

    def migrate_fn(self, compress=False):
        return lambda dst, src, sids, dids: dst


@pytest.mark.parametrize("backend,kw,match", [
    (DisaggFakeBackend(), dict(kv="contiguous", disagg=True), "kv='paged'"),
    (ts.FakeBackend(), dict(disagg=True), "chunked"),
    (DisaggFakeBackend(), dict(disagg=True, disagg_link="carrier-pigeon"),
     "disagg_link"),
    (DisaggFakeBackend(), dict(routing="bogus"), "routing"),
    (DisaggFakeBackend(), dict(kv="contiguous", routing="affinity"),
     "kv='paged'"),
    (DisaggFakeBackend(), dict(disagg=True, disagg_prefill_type="huge"),
     "disagg_prefill_type"),
])
def test_disagg_validation_errors(backend, kw, match):
    with pytest.raises(ValueError, match=match):
        tserve.ClientHandler(backend, executor=ts._fixed, prompt_pad=4, **kw)


def _fake_run(**kw):
    h = tserve.ClientHandler(
        DisaggFakeBackend(), executor=ts._fixed, prompt_pad=8, max_batch=2,
        max_secondaries=4, block_size=4, prefill_chunk=4, use_primary=False,
        **{"fleet": ["basic", "large"], "clone_type": "basic", **kw})
    rep = h.run([ServeRequest(i, np.full(8, i + 1, np.int32), 4,
                              arrival_t=0.05 * i) for i in range(6)])
    return rep, {c.rid: [int(x) for x in c.tokens] for c in rep.completions}


def test_fake_disagg_handoffs_and_transfer_accounting():
    rep0, t0 = _fake_run()
    assert len(t0) == 6 and rep0.disagg_handoffs == 0
    assert rep0.kv_transfer_bytes == 0
    rep1, t1 = _fake_run(**DISAGG)
    assert t1 == t0
    assert rep1.disagg_handoffs == 6 and rep1.disagg_colocated == 0
    assert rep1.disagg_fallbacks == 0 and rep1.kv_transfer_s > 0
    rep2, t2 = _fake_run(**DISAGG, disagg_compress=True)
    assert t2 == t0 and rep2.disagg_handoffs == 6
    assert 0 < rep2.kv_transfer_bytes < 0.5 * rep1.kv_transfer_bytes
    # a threshold above the padded prompt keeps every candidate local
    rep3, t3 = _fake_run(**dict(DISAGG, disagg_min_prompt=100))
    assert t3 == t0
    assert rep3.disagg_handoffs == 0 and rep3.disagg_colocated == 6
    assert rep3.kv_transfer_bytes == 0


def test_fake_disagg_no_partner_serves_colocated():
    """A fleet whose partner tier cannot be acquired (the pool is full)
    serves every request co-located, counted as a fallback."""
    from repro_torch.core.clock import VirtualClock
    from repro_torch.core.clones import ClonePool
    h = tserve.ClientHandler(
        DisaggFakeBackend(), executor=ts._fixed, prompt_pad=8, max_batch=8,
        block_size=4, prefill_chunk=4, max_secondaries=0,
        pool=ClonePool(clock=VirtualClock(), max_clones=1),
        **dict(DISAGG, fleet=["main", "large"], clone_type="main"))
    rep = h.run([ServeRequest(i, np.full(8, i + 1, np.int32), 4,
                              arrival_t=0.05 * i) for i in range(4)])
    assert len(rep.completions) == 4
    assert rep.disagg_handoffs == 0 and rep.disagg_fallbacks >= 1
