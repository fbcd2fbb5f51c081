"""RunContext: everything the model needs to know about the runtime substrate."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

IMPLS = ("torch", "cuda")
REMATS = ("none", "dots", "full")
PROFILES = ("tp", "zero-sp", "serve", "legacy")


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
    gradient accumulation.

    ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``, or None for
    one device) runs the model sharded: parameters, optimizer state, caches
    and inputs are DTensors placed by ``distributed/sharding.py``
    (``sharding_profile``: ``"tp"`` Megatron tensor parallelism over
    ``model_axis`` plus FSDP over ``data``; ``"zero-sp"`` weights FSDP
    only and the sequence over the model axis; ``"serve"`` weights
    resident, no FSDP; ``"legacy"`` as ``"tp"`` without KV-cache sequence
    sharding).  The batch shards over ``dp_axes``.  A mesh runs the plain
    path: ``impl="cuda"`` with a mesh raises.  The reference's
    ``seq_shard_attn`` (read nowhere there) and ``scan_unroll`` (eager
    layer loops already dispatch every layer) have no counterpart.
    """

    device: torch.device
    impl: str
    paged_fused: bool = True
    moe_capacity_factor: float = 1.25
    remat: str = "full"
    loss_chunk: int = 0
    microbatches: int = 1
    mesh: Optional[Any] = None
    dp_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    sharding_profile: str = "tp"

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}: {self.impl!r}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}: "
                             f"{self.remat!r}")
        if self.sharding_profile not in PROFILES:
            raise ValueError(f"sharding_profile must be one of {PROFILES}: "
                             f"{self.sharding_profile!r}")
        if self.mesh is not None and self.impl != "torch":
            raise ValueError("a mesh runs the plain path (impl='torch'); "
                             "the hand-written kernels take one device")

    @property
    def zero_sp(self) -> bool:
        return self.sharding_profile == "zero-sp"

    @property
    def fsdp_weights(self) -> bool:
        # serving keeps its weights resident: no per-layer FSDP gathers
        return self.sharding_profile != "serve"

    @property
    def model_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(
            self.model_axis))

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        names = self.mesh.mesh_dim_names
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.size(names.index(a))
        return n

    def dp_spec(self):
        """Spec entry of the batch dim (``sharding.spec_for``'s form)."""
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

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
