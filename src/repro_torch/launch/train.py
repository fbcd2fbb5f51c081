"""Training entry point with ThinkAir fleet integration, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        [--full] --steps 50 --batch 8 --seq 64 [--device cpu]

Runs on the card unless ``--device`` names another device.  Fleet
features, as in the reference (``src/repro/launch/train.py``):
 - checkpoint/restart (atomic, async, step-versioned);
 - elastic resizes through the ThinkAir clone pool between steps
   (provisioning charged like the paper's VM resumes);
 - fault injection -> restore-from-checkpoint restart path.
The reference's manual-collective data-parallel step with int8 +
error-feedback gradient compression needs a data axis: it waits for the
port's mesh (ROADMAP Queue 1 item 10).
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
from repro_torch.launch import steps as S
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig


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
                 grad_compression: bool = False, device=None,
                 elastic_schedule: Optional[dict] = None):
        if grad_compression:
            raise NotImplementedError(
                "gradient compression all-reduces over a data axis: it waits "
                "for the port's mesh (ROADMAP Queue 1 item 10)")
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
        self.ctx = S.make_context(device)
        self.device = self.ctx.device
        self.step_fn = S.build_train_step(cfg, opt_cfg, self.ctx)

    def init_state(self, seed: int = 0) -> Dict:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = model.init(self.cfg, gen, self.device)
        return {"params": params, "opt": adamw.init(params)}

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch for ``step`` on the trainer's device."""
        return {k: v.to(self.device) for k, v in self.pipe.batch(step).items()}

    def run(self, state: Optional[Dict] = None) -> Dict:
        start = 0
        if state is None:
            state = self.init_state()
            if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) is not None:
                start, state = ckpt.restore(self.ckpt_dir, state)
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
                    i, state = ckpt.restore(self.ckpt_dir, state)
                continue
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            self.report.losses.append(loss)
            i += 1
            self.report.steps_done += 1
            if self.ckpt_dir and i % self.ckpt_every == 0:
                ckpt.save(self.ckpt_dir, i, state)
        if self.ckpt_dir:
            ckpt.save(self.ckpt_dir, i, state)
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
