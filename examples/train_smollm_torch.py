"""End-to-end example on the PyTorch port: train a SmolLM-style model for a
few hundred steps with checkpoint/restart and fault tolerance.

    PYTHONPATH=src python examples/train_smollm_torch.py --steps 300
(defaults to a quick 60-step run of a thin 8-layer variant on the card;
--full-width trains smollm-360m itself; --device cpu runs on the host)
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.checkpoint import checkpoint as ckpt      # noqa: E402
from repro_torch.configs import get_config                # noqa: E402
from repro_torch.core import FaultPlan                    # noqa: E402
from repro_torch.data.pipeline import DataConfig          # noqa: E402
from repro_torch.launch.train import FleetTrainer         # noqa: E402
from repro_torch.models import model                      # noqa: E402
from repro_torch.optim.adamw import OptConfig             # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-width", action="store_true",
                    help="smollm-360m itself; default is a thin 8-layer "
                         "variant of the same architecture")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "thinkair_smollm_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    cfg = get_config("smollm-360m")
    if not args.full_width:
        cfg = dataclasses.replace(cfg, n_layers=8, d_model=192, n_heads=3,
                                  n_kv_heads=1, head_dim=64, d_ff=512,
                                  vocab_size=8192, dtype="float32")
    print(f"arch={cfg.name} params={model.n_params(cfg):,}")

    trainer = FleetTrainer(
        cfg, steps_total=args.steps,
        data_cfg=DataConfig(args.batch, args.seq),
        opt_cfg=OptConfig(peak_lr=1e-3, warmup_steps=20,
                          decay_steps=args.steps),
        ckpt_dir=args.ckpt_dir, ckpt_every=20,
        fault_plan=FaultPlan(fail_every=75),   # inject a failure mid-run
        device=args.device,
    )
    t0 = time.time()
    state = trainer.init_state()
    i = 0
    while i < args.steps:
        batch = trainer.batch(i)
        if trainer.faults.check():
            print(f"step {i}: INJECTED NODE FAILURE -> restart from ckpt")
            if ckpt.latest_step(args.ckpt_dir) is not None:
                i, state = ckpt.restore(args.ckpt_dir, state)
            trainer.report.restarts += 1
            continue
        state, m = trainer.step_fn(state, batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} ({time.time() - t0:.0f}s)")
        if i % 20 == 0 and i > 0:
            ckpt.save(args.ckpt_dir, i, state)
        i += 1
    print(f"done: {args.steps} steps, restarts={trainer.report.restarts}, "
          f"{time.time() - t0:.0f}s on {trainer.device}")


if __name__ == "__main__":
    main()
