"""RunContext: everything the model needs to know about the runtime substrate."""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

IMPLS = ("torch", "cuda")
REMATS = ("none", "dots", "full")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no GPU and no explicit device this raises — the port
    never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class RunContext:
    """Static execution context threaded through model apply functions.

    ``impl="cuda"`` routes attention through the hand-written kernels
    (``kernels/ops.py``: on CUDA tensors they launch, on CPU tensors they
    run their plain versions); ``impl="torch"`` is the plain gathered
    attention of ``layers.attention_xla`` — the end-to-end oracle.
    ``paged_fused`` picks the GQA-fused decode grid (one CTA per (slot,
    kv-head)) over the per-query-head grid kept as the A/B baseline.
    ``moe_capacity_factor`` sizes each expert's buffer in
    ``models/moe.py`` (serving passes ``n_experts / top_k``: no token is
    dropped; training keeps 1.25).  Training reads the rest: ``remat``
    recomputes each layer group in the backward pass (``"full"``), keeps
    its matmul outputs (``"dots"``) or stores everything (``"none"``);
    ``loss_chunk`` evaluates the cross-entropy that many positions at a
    time (0: at once); ``microbatches`` splits a train step's batch for
    gradient accumulation.  There is no mesh: the port runs on one device.
    """

    device: torch.device
    impl: str
    paged_fused: bool = True
    moe_capacity_factor: float = 1.25
    remat: str = "full"
    loss_chunk: int = 0
    microbatches: int = 1

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}: {self.impl!r}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}: "
                             f"{self.remat!r}")

    @classmethod
    def on(cls, device: Optional[Union[str, torch.device]] = None,
           impl: Optional[str] = None,
           moe_capacity_factor: float = 1.25) -> "RunContext":
        """Context for ``device`` (see :func:`resolve_device`); the kernels
        are the default on a card, the plain path everywhere else."""
        dev = resolve_device(device)
        if impl is None:
            impl = "cuda" if dev.type == "cuda" else "torch"
        return cls(dev, impl, moe_capacity_factor=moe_capacity_factor)
