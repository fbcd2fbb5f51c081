"""Deterministic synthetic data pipeline.

Each batch is drawn from a ``torch.Generator`` seeded from ``(seed,
step)`` alone: a restart or an elastic resize regenerates batch ``k``
from the step number, with no iterator state to checkpoint.  Keys, shapes
and dtypes are the reference's (``src/repro/data/pipeline.py``); the
values are not, since ``jax.random`` and torch draw differently (ROADMAP
Queue 3): parity tests feed one numpy batch to both packages.  Batches
are made on the host; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 1234


class Pipeline:
    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg

    def _generator(self, step: int) -> torch.Generator:
        """A host generator keyed by (seed, step).  The CPU generator keeps
        32 bits of its seed, so the pair is hashed to 32 bits first."""
        key = np.random.SeedSequence([self.dcfg.seed, step])
        return torch.Generator().manual_seed(int(key.generate_state(1)[0]))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The full global batch for one step: text ``tokens`` and their
        next tokens ``targets`` (int32); audio ``frames`` (float32),
        ``targets`` and a HuBERT-style ``loss_mask`` of about 8% ones;
        vision ``n_patches`` ``patches`` (float32) ahead of ``seq_len -
        n_patches`` text tokens and their targets."""
        cfg, d = self.cfg, self.dcfg
        gen = self._generator(step)
        b, s, v = d.global_batch, d.seq_len, cfg.vocab_size

        def tokens(n):
            return torch.randint(0, v, (b, n), generator=gen,
                                 dtype=torch.int32)

        if cfg.frontend == "audio":
            frames = torch.randn((b, s, cfg.d_model), generator=gen)
            targets = tokens(s)
            mask = torch.rand((b, s), generator=gen) < 0.08
            return {"frames": frames, "targets": targets,
                    "loss_mask": mask.float()}
        if cfg.frontend == "vision":
            p = cfg.n_patches
            patches = torch.randn((b, p, cfg.d_model), generator=gen)
            toks = tokens(s - p + 1)
            return {"patches": patches, "tokens": toks[:, :-1],
                    "targets": toks[:, 1:]}
        toks = tokens(s + 1)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def abstract_batch(self) -> Dict[str, torch.Tensor]:
        """Meta tensors with :meth:`batch`'s keys, shapes and dtypes."""
        cfg, d = self.cfg, self.dcfg
        b, s = d.global_batch, d.seq_len

        def meta(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if cfg.frontend == "audio":
            return {"frames": meta(b, s, cfg.d_model, dtype=torch.float32),
                    "targets": meta(b, s),
                    "loss_mask": meta(b, s, dtype=torch.float32)}
        if cfg.frontend == "vision":
            p = cfg.n_patches
            return {"patches": meta(b, p, cfg.d_model, dtype=torch.float32),
                    "tokens": meta(b, s - p), "targets": meta(b, s - p)}
        return {"tokens": meta(b, s), "targets": meta(b, s)}
