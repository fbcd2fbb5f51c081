"""Whole-model bfloat16 prefill logits of the port vs the reference run
eagerly (CPU).

Weights from the reference's ``model.init(cfg, PRNGKey(0))`` carried by
``weights.from_jax``; 16 prompts of 16 tokens from ``default_rng(1)``.
The reference runs under ``jax.disable_jit()``, so every op rounds to
bfloat16 by itself, as the port's do (jit fusion leaves intermediate
roundings out, and that alone is most of the jitted gap:
``tools/bf16_gap_probe.py`` prints both columns).  Tolerance 1e-5 on the
float32 logits of the last position.  The attention models are held at
one layer: from the second layer on the last position reads first-layer
attention outputs that differ by one bf16 ulp in a few elements (the
float32 score sums and ``exp`` of the two libraries differ in the last
bit and flip a rounding; ROADMAP Queue 3 item 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import model as jm
from repro.models.context import RunContext as JContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.models import model as tm
from repro_torch.models import weights
from repro_torch.models.context import RunContext

TOL = 1e-5


@pytest.mark.parametrize("arch,layers", [("rwkv6-7b", 8),
                                         ("smollm-360m", 1)])
def test_bf16_prefill_logits_match_eager_reference(arch, layers):
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              n_layers=layers, dtype="bfloat16")
    tcfg = dataclasses.replace(t_reduced_config(t_get_config(arch)),
                               n_layers=layers, dtype="bfloat16")
    jp = jm.init(cfg, jax.random.PRNGKey(0))
    tp = weights.from_jax(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp), tcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (16, 16),
                                             dtype=np.int32)
    with jax.disable_jit():
        want, _ = jm.forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                             JContext(), "prefill", cache_capacity=16)
    got, _ = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        RunContext(torch.device("cpu"), "torch"), "prefill",
                        cache_capacity=16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=0)


def test_bf16_oracle_speculation_accepts_everything_in_both_handlers():
    """ROADMAP Queue 3 item 8 on the CPU: reduced smollm-360m in bfloat16
    drafting for itself (the oracle draft), through both handlers on the
    reference's weights.  The reference accepts every proposal, and so
    does the port on its kernel path (the wrappers' plain versions on
    CPU tensors): each speculative stream equals its plain one.  (The
    streams of the two packages differ in bfloat16, Queue 3 item 1.)  On
    the card the draft decodes through paged_decode and the verify runs
    paged_prefill, whose bfloat16 roundings differ."""
    import test_torch_spec as ts
    from repro.core.scheduler import ServeRequest as JRequest
    from repro.launch import serve as jserve
    from repro_torch.core.scheduler import ServeRequest
    from repro_torch.launch import serve as tserve

    cfg = dataclasses.replace(reduced_config(get_config("smollm-360m")),
                              dtype="bfloat16")
    tcfg = dataclasses.replace(t_reduced_config(t_get_config("smollm-360m")),
                               dtype="bfloat16")
    jb = jserve.LMBackend(cfg, capacity=32, draft="oracle")
    tp = weights.from_jax(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jb.params),
        tcfg)
    trace = ts._trace(n=8)

    def serve(impl, speculative):
        if impl is None:
            backend, cls, req = jb, jserve.ClientHandler, JRequest
        else:
            backend = tserve.LMBackend(tcfg, capacity=32, params=tp,
                                       device="cpu", impl=impl,
                                       draft="oracle")
            cls, req = tserve.ClientHandler, ServeRequest
        h = cls(backend, max_batch=4, block_size=4, max_secondaries=2,
                decode_window=1, prompt_pad=8, prefill_chunk=4,
                speculative=speculative, spec_k=3, executor=ts._fixed)
        rep = h.run([req(i, p, n, arrival_t=t) for i, p, n, t in trace])
        return {c.rid: [int(x) for x in c.tokens]
                for c in rep.completions}, rep

    for impl in (None, "cuda"):
        plain, _ = serve(impl, False)
        spec, rep = serve(impl, True)
        assert spec == plain and len(spec) == 8, impl
        assert rep.spec_rounds > 0 and rep.acceptance_rate == 1.0, impl
