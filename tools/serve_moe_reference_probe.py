#!/usr/bin/env python3
"""The reference's serve-profile MoE on a split batch (CPU, JAX).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/serve_moe_reference_probe.py

Runs the reference's prefill step for reduced olmoe-1b-7b (8 experts,
top-2, capacity factor E/k: no drops) on 4 host devices, once without a
mesh and then on the meshes 2 x 2 and 1 x 4 (``AxisType.Auto`` axes) with
``sharding_profile="serve"``, and prints the largest difference of the
sharded logits from the unsharded ones, relative to the largest logit.
The serve body (``_dispatch_contract_sharded``) sums the partial
up-projections over ``data``; with the batch split over ``data`` those
partials belong to different tokens.  The port's counterpart is held to
its mesh-free path in ``tests/test_torch_distributed.py``.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import sys  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.distributed import sharding as shd  # noqa: E402
from repro.launch import steps as S  # noqa: E402
from repro.models import model  # noqa: E402


def main() -> None:
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg = reduced_config(get_config("olmoe-1b-7b"))
    capf = cfg.n_experts / cfg.top_k
    params = model.init(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (8, 16))
    batch = {"tokens": jnp.asarray(toks.astype(np.int32))}
    want, _ = jax.jit(S.build_prefill_step(
        cfg, S.make_context(None, moe_capacity_factor=capf)))(params, batch)
    for shape in ((2, 2), (1, 4)):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto))
        ctx = S.make_context(mesh, moe_capacity_factor=capf,
                             sharding_profile="serve")
        step = jax.jit(S.build_prefill_step(cfg, ctx), in_shardings=(
            S.param_shardings(cfg, mesh, "serve"),
            shd.input_shardings(batch, mesh, 8)))
        got, _ = step(params, batch)
        err = float(jnp.abs(got - want).max() / jnp.abs(want).max())
        print(f"mesh {shape[0]}x{shape[1]}: serve-profile prefill logits, "
              f"relative max difference from the mesh-free step {err:.3e}")


if __name__ == "__main__":
    main()
