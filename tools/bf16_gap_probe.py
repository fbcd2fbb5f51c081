#!/usr/bin/env python3
"""Whole-model bfloat16 gap between the port and the JAX reference (CPU).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/bf16_gap_probe.py

For smollm-360m (1, 2, 4 and 8 layers), rwkv6-7b (8) and
recurrentgemma-2b (3 and 9) under ``reduced_config``, in bfloat16 and in
float32: weights from the reference's ``model.init(cfg, PRNGKey(0))``
carried over by ``weights.from_jax``, 16 prompts of 16 tokens from
``default_rng(1)``; the
reference's prefill (``impl="xla"``) against the port's (``impl="torch"``),
once jitted and once under ``jax.disable_jit()`` (every op rounded by
itself, as the port rounds; jit fusion leaves intermediate bf16 roundings
out).  Prints, per model, dtype and reference mode, the largest logit
difference and how many of the 16 rows take another greedy token.  About
two minutes in all.
"""
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.context import RunContext as JContext  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced_config  # noqa
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.models.context import RunContext  # noqa: E402

MODELS = {"smollm-360m": (1, 2, 4, 8), "rwkv6-7b": (8,),
          "recurrentgemma-2b": (3, 9)}
ROWS, TOKENS = 16, 16


def gap(arch, layers, dtype, eager):
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              n_layers=layers, dtype=dtype)
    tcfg = dataclasses.replace(t_reduced_config(t_get_config(arch)),
                               n_layers=layers, dtype=dtype)
    jp = jm.init(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    tp = weights.from_jax(tree, tcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (ROWS, TOKENS), dtype=np.int32)
    with jax.disable_jit(eager):
        jl, _ = jm.forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                           JContext(), "prefill", cache_capacity=TOKENS)
    tl, _ = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                       RunContext(torch.device("cpu"), "torch"), "prefill",
                       cache_capacity=TOKENS)
    want = np.asarray(jnp.asarray(jl, jnp.float32))
    got = tl.float().numpy()
    last = (slice(None), -1) if want.ndim == 3 else (slice(None),)
    diff = float(np.abs(got - want).max())
    tokens = int((got[last].argmax(-1) != want[last].argmax(-1)).sum())
    return diff, tokens


def main():
    for arch, depths in MODELS.items():
        for layers, dtype in ((n, t) for n in depths
                              for t in ("bfloat16", "float32")):
            for eager in (False, True):
                diff, tokens = gap(arch, layers, dtype, eager)
                print(f"{arch:18s} {layers} layers {dtype:8s} reference "
                      f"{'eager ' if eager else 'jitted'} max |dlogit| "
                      f"{diff:.3g}, greedy token differs in {tokens}/{ROWS} "
                      "rows", flush=True)


if __name__ == "__main__":
    main()
