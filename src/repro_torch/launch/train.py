"""Training entry point with ThinkAir fleet integration.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        [--full] --steps 50 --batch 8 --seq 64 [--device cpu]

Runs on the card unless ``--device`` names another device.  Fleet
features, as in the reference (``src/repro/launch/train.py``):
 - checkpoint/restart (atomic, async, step-versioned);
 - elastic resizes through the ThinkAir clone pool between steps
   (provisioning charged like the paper's VM resumes);
 - fault injection -> restore-from-checkpoint restart path;
 - on a mesh (``FleetTrainer(mesh=...)``) the sharded step, or, with
   ``grad_compression`` and a data axis wider than 1, manual data
   parallelism with an int8 + error-feedback gradient mean
   (:func:`build_compressed_train_step`).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.clones import ClonePool
from repro_torch.core.faults import FaultPlan
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as S
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig


_METRICS = ("aux", "grad_norm", "loss", "lr", "total")


def build_compressed_train_step(cfg, opt_cfg: OptConfig, ctx):
    """Manual data parallelism on ``ctx.mesh``: per-rank gradients of each
    rank's rows of the batch (split over ``data``), their int8 +
    error-feedback mean over ``data`` (``compression.tree_compressed_pmean``),
    the AdamW update on every rank, and the metrics averaged over
    ``data``.  State ``{"params", "opt", "ef"}`` is replicated; the body
    runs on local tensors under one ``local_map``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = ctx.mesh
    local_ctx = dataclasses.replace(ctx, mesh=None)
    n_data = shd.axis_size(mesh, "data")
    rep = S.replicated(mesh)
    rows = tuple(Shard(0) if n == "data" else Replicate()
                 for n in mesh.mesh_dim_names)

    def grads_of(params, batch):
        live = model.tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            total, metrics = model.forward(cfg, live, batch, local_ctx,
                                           "train")
            grads = torch.autograd.grad(total, model._tree_leaves(live),
                                        materialize_grads=True)
        return total.detach(), metrics, model.tree_unflatten(params, grads)

    def step_fn(state: Dict, batch: Dict):
        tree = {"params": state["params"], "opt": state["opt"],
                "ef": state["ef"]}
        leaves = model._tree_leaves(tree)
        names = sorted(batch)
        n_state = len(leaves)

        def body(*args):
            st = model.tree_unflatten(tree, args[:n_state])
            local_batch = dict(zip(names, args[n_state:]))
            total, metrics, grads = grads_of(st["params"], local_batch)
            grads, ef = compression.tree_compressed_pmean(
                grads, st["ef"], "data", mesh=mesh)
            new_p, new_o, om = adamw.update(opt_cfg, grads, st["opt"],
                                            st["params"])
            metrics = {**{k: v.detach() for k, v in metrics.items()}, **om,
                       "total": total}
            means = [shd._all_reduce(metrics[k].float(), mesh, "data")
                     / n_data for k in _METRICS]
            out = model._tree_leaves({"params": new_p, "opt": new_o,
                                      "ef": ef})
            return tuple(out) + tuple(means)

        fn = shd.local_map(
            body, mesh=mesh,
            in_placements=tuple(rep for _ in leaves)
            + tuple(rows for _ in names),
            out_placements=tuple(rep for _ in leaves)
            + tuple(rep for _ in _METRICS))
        outs = fn(*leaves, *(batch[n] for n in names))
        new = model.tree_unflatten(tree, outs[:n_state])
        return new, dict(zip(_METRICS, outs[n_state:]))

    return step_fn


@dataclasses.dataclass
class TrainReport:
    steps_done: int = 0
    restarts: int = 0
    resizes: int = 0
    provision_seconds: float = 0.0
    losses: list = dataclasses.field(default_factory=list)


class FleetTrainer:
    """Elastic, fault-tolerant training loop driven by the ThinkAir pool
    (GPU clone types), on ``device`` (the card unless another is
    named)."""

    def __init__(self, cfg, *, steps_total: int, data_cfg: DataConfig,
                 opt_cfg: OptConfig = OptConfig(), ckpt_dir: str = None,
                 ckpt_every: int = 20, fault_plan: Optional[FaultPlan] = None,
                 grad_compression: bool = False, mesh=None, device=None,
                 elastic_schedule: Optional[dict] = None):
        self.cfg = cfg
        self.steps_total = steps_total
        self.opt_cfg = opt_cfg
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.pipe = Pipeline(cfg, data_cfg)
        self.faults = fault_plan or FaultPlan()
        self.pool = ClonePool(link_name="nvlink", gpu=True)
        self.elastic_schedule = elastic_schedule or {}
        self.report = TrainReport()
        self.mesh = mesh
        self.ctx = S.make_context(device, mesh=mesh)
        self.device = self.ctx.device
        # the reference compresses only where there is a data axis to
        # reduce over; otherwise it trains uncompressed
        self._compressed = bool(grad_compression and mesh is not None
                                and shd.mesh_shape(mesh).get("data", 1) > 1)
        if self._compressed:
            self.step_fn = build_compressed_train_step(cfg, opt_cfg,
                                                       self.ctx)
        else:
            self.step_fn = S.build_train_step(cfg, opt_cfg, self.ctx)

    def init_state(self, seed: int = 0) -> Dict:
        """Parameters drawn from ``seed`` (every rank draws the same and
        keeps its shard), zero moments, and on the compressed path zero
        error-feedback residuals."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = model.init(self.cfg, gen, self.device)
        if self.mesh is not None:
            params = shd.distribute_tree(params, self._param_placements(),
                                         self.mesh)
        state = {"params": params, "opt": adamw.init(params)}
        if self._compressed:
            state["ef"] = compression.init_error_feedback(params)
        return state

    def _param_placements(self):
        if self._compressed:
            return model.tree_map(lambda _: S.replicated(self.mesh),
                                  model.param_specs(self.cfg))
        return S.param_shardings(self.cfg, self.mesh,
                                 self.ctx.sharding_profile)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch for ``step`` on the trainer's device (on a
        mesh: each rank's rows, split as ``sharding.input_shardings``)."""
        batch = {k: v.to(self.device)
                 for k, v in self.pipe.batch(step).items()}
        if self.mesh is None:
            return batch
        specs = shd.input_shardings(batch, self.mesh,
                                    self.pipe.dcfg.global_batch)
        if self._compressed:
            specs = {k: ("data",) if s else () for k, s in specs.items()}
        return {k: shd.distribute(v, shd.placements(specs[k], self.mesh),
                                  self.mesh) for k, v in batch.items()}

    def _save(self, i: int, state: Dict) -> None:
        """Checkpoint the whole state (gathered on a mesh; rank 0
        writes)."""
        if self.mesh is None:
            ckpt.save(self.ckpt_dir, i, state)
            return
        import torch.distributed as dist
        whole = model.tree_map(lambda t: t.full_tensor(), state)
        if dist.get_rank() == 0:
            ckpt.save(self.ckpt_dir, i, whole)
        dist.barrier()

    def _restore(self, state: Dict):
        if self.mesh is None:
            return ckpt.restore(self.ckpt_dir, state)
        like = model.tree_map(lambda t: t.full_tensor(), state)
        step, whole = ckpt.restore(self.ckpt_dir, like)
        return step, model.tree_map(
            lambda w, t: shd.distribute(w, t.placements, self.mesh), whole,
            state)

    def run(self, state: Optional[Dict] = None) -> Dict:
        start = 0
        if state is None:
            state = self.init_state()
            if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) is not None:
                start, state = self._restore(state)
                self.report.restarts += 1
        i = start
        while i < self.steps_total:
            if i in self.elastic_schedule:
                # elastic resize: provision clones; cost accounted like the
                # paper's VM resume/boot
                n = self.elastic_schedule[i]
                _, cost = self.pool.acquire("main", n=n)
                self.report.provision_seconds += cost
                self.report.resizes += 1
            batch = self.batch(i)
            if self.faults.check():
                # node failure mid-step: restart from latest checkpoint
                self.report.restarts += 1
                if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) \
                        is not None:
                    i, state = self._restore(state)
                continue
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            self.report.losses.append(loss)
            i += 1
            self.report.steps_done += 1
            if self.ckpt_dir and i % self.ckpt_every == 0:
                self._save(i, state)
        if self.ckpt_dir:
            self._save(i, state)
        return state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain path on the host)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    trainer = FleetTrainer(
        cfg, steps_total=args.steps,
        data_cfg=DataConfig(args.batch, args.seq),
        ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"arch={cfg.name} params={model.n_params(cfg):,} "
          f"device={trainer.device}")
    t0 = time.time()
    state = trainer.init_state()
    for i in range(args.steps):
        state, metrics = trainer.step_fn(state, trainer.batch(i))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.time() - t0:.1f}s)")
    print("done")


if __name__ == "__main__":
    main()
