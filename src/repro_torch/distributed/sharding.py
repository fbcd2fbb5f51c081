"""Logical-axis -> mesh-axis sharding rules, DTensor placements, and the
collectives the sharded model bodies run.

Divisibility-aware: a logical dim whose size does not divide its preferred
mesh axis falls back to replication (e.g. Mixtral's 8 experts on a 16-wide
model axis -> expert dim replicated, d_ff takes the model axis instead via
the "mlp" rule).  A mesh axis is used at most once per tensor.

A spec is a tuple with one entry per tensor dim (trailing ``None``s
dropped): ``None``, a mesh-axis name, or a tuple of names, the form of the
reference's ``PartitionSpec``.  :func:`placements` turns it into DTensor
placements: each mesh dim named on tensor dim ``d`` becomes ``Shard(d)``,
every other one ``Replicate()``; a dim named with two axes (``("pod",
"data")`` on the batch) shards over both in mesh order, which is the
reference's major-to-minor order.

The model's sharded bodies run under :func:`local_map` on local tensors;
they reach across ranks only through the autograd-aware collectives at the
end of this module (Megatron's f / g pair and gathers), each over named
mesh axes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

# logical axis -> preferred mesh axis / tuple of axes (None = replicated)
DEFAULT_RULES: Dict[str, object] = {
    # data-parallel dims
    "batch": ("pod", "data"),
    # tensor-parallel dims
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "lru": "model",
    "rank": "model",
    # KV-cache sequence dim: takes the model axis when kv_heads can't
    "kv_seq": "model",
    # FSDP dim
    "embed": "data",
    "lru_in": "data",
    # replicated
    "head_dim": None,
    "conv": None,
    "layers": None,
    "embed_out": None,
    "experts_r": None,
}

# allocation priority: earlier entries claim mesh axes first (a tensor's
# dims are assigned in this order, then the spec is emitted in dim order)
_PRIORITY = ["batch", "vocab", "heads", "kv_heads", "mlp", "experts", "lru",
             "rank", "kv_seq", "embed", "lru_in"]

# ZeRO-SP profile: weights FSDP-only (gathered per layer), the model axis
# carries the sequence
ZERO_SP_RULES: Dict[str, object] = dict(
    DEFAULT_RULES,
    heads=None, kv_heads=None, mlp=None, lru=None, rank=None,
)

# serve profile: params resident (model-axis TP dims only, no FSDP dim)
SERVE_RULES: Dict[str, object] = dict(
    DEFAULT_RULES, embed=None, lru_in=None,
)

# baseline without kv-cache sequence sharding
LEGACY_RULES: Dict[str, object] = dict(DEFAULT_RULES, kv_seq=None)


def rules_for(profile: str) -> Dict[str, object]:
    if profile == "zero-sp":
        return ZERO_SP_RULES
    if profile == "serve":
        return SERVE_RULES
    if profile == "legacy":
        return LEGACY_RULES
    return DEFAULT_RULES


class AbstractMesh:
    """Axis names and sizes with no devices and no process group: enough
    for :func:`spec_for` (``shape``: name -> size, in mesh order)."""

    def __init__(self, axis_sizes: Sequence[int],
                 axis_names: Sequence[str]):
        self.shape = dict(zip(tuple(axis_names), tuple(axis_sizes)))


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(axis_sizes, axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """name -> size, in mesh order, of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# batch dims shard over the pure-DP axes (pod + data)
def batch_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
             rules: Dict[str, object] = None) -> tuple:
    """Spec of one tensor from its logical axes."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_shape(mesh)
    used = set()
    out = [None] * len(axes)
    order = sorted(range(len(axes)),
                   key=lambda i: _PRIORITY.index(axes[i])
                   if axes[i] in _PRIORITY else len(_PRIORITY))
    for i in order:
        size, logical = shape[i], axes[i]
        pref = rules.get(logical) if logical is not None else None
        if pref is None:
            continue
        cand = tuple(a for a in (pref if isinstance(pref, tuple) else (pref,))
                     if a in sizes and a not in used)
        total = math.prod(sizes[a] for a in cand)
        if not cand or size % total != 0:
            continue
        out[i] = cand if len(cand) > 1 else cand[0]
        used.update(cand)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def tree_map_axes(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over a nested dict whose axes tree holds a tuple
    of logical axis names at every leaf (``models.model.tree_map``'s
    job; this module sits below ``models`` and cannot import it)."""
    if isinstance(tree, dict):
        return {k: tree_map_axes(fn, v, axes_tree[k])
                for k, v in tree.items()}
    return fn(tree, axes_tree)


def tree_specs(abstract_tree, axes_tree, mesh, rules=None):
    """Spec tree matching an abstract (meta tensor) tree."""
    return tree_map_axes(lambda leaf, axes: spec_for(leaf.shape, axes, mesh,
                                                     rules),
                         abstract_tree, axes_tree)


def batch_spec(ndim: int, mesh) -> tuple:
    """Inputs: leading batch dim over (pod, data)."""
    dp = batch_axes(mesh)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    return (dp,) + (None,) * (ndim - 1)


def input_shardings(batch_tree, mesh, global_batch: int):
    """Spec of every leaf of an input batch: the leading batch dim over
    (pod, data) when it divides (:func:`batch_spec`: an entry per dim),
    else replicated, ``()`` (long_500k's batch 1)."""
    dp_size = math.prod(mesh_shape(mesh)[a] for a in batch_axes(mesh))

    def f(leaf):
        if leaf.ndim >= 1 and leaf.shape[0] == global_batch \
                and global_batch % dp_size == 0:
            return batch_spec(leaf.ndim, mesh)
        return ()

    if isinstance(batch_tree, dict):
        return {k: input_shardings(v, mesh, global_batch)
                for k, v in batch_tree.items()}
    return f(batch_tree)


# --------------------------------------------------------------------------- #
# DTensor placements
# --------------------------------------------------------------------------- #
def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh`` (one per mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_shape(mesh):
        dim = None
        for d, entry in enumerate(spec):
            if entry == name or (isinstance(entry, tuple) and name in entry):
                dim = d
        out.append(Shard(dim) if dim is not None else Replicate())
    return tuple(out)


def tree_placements(abstract_tree, axes_tree, mesh, rules=None):
    """Placements tree (the port's ``tree_shardings``)."""
    return tree_map_axes(
        lambda leaf, axes: placements(spec_for(leaf.shape, axes, mesh,
                                               rules), mesh),
        abstract_tree, axes_tree)


def local_shape(shape: Sequence[int], plc: Sequence, mesh) -> tuple:
    """Shape of this rank's shard (sharding is always even here)."""
    out = list(shape)
    for size, p in zip(mesh.shape, plc):
        if p.is_shard():
            out[p.dim] //= size
    return tuple(out)


def shard_local(t: torch.Tensor, plc: Sequence, mesh) -> torch.Tensor:
    """This rank's chunk of a global tensor every rank holds whole: a
    narrow per sharded mesh dim, in mesh order; nothing is sent."""
    out = t
    for i, p in enumerate(plc):
        if p.is_shard():
            n = mesh.size(i)
            r = mesh.get_local_rank(i)
            step = out.shape[p.dim] // n
            out = out.narrow(p.dim, r * step, step)
    if out.numel() != t.numel():
        out = out.contiguous().clone()
    return out


def distribute(t: torch.Tensor, plc: Sequence, mesh):
    """A DTensor from a global tensor every rank holds whole (the same
    values on every rank: the same seed, the same pipeline step)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(shard_local(t, plc, mesh), mesh, tuple(plc),
                              run_check=False)


def distribute_tree(tree, placements_tree, mesh):
    """:func:`distribute` over a nested dict (the port's counterpart of
    ``jax.device_put`` with a ``tree_shardings`` tree)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, placements_tree[k], mesh)
                for k, v in tree.items()}
    return distribute(tree, placements_tree, mesh)


def local_map(body, *, mesh, in_placements, out_placements,
              in_grad_placements=None):
    """``torch.distributed.tensor.experimental.local_map`` with inputs
    redistributed to ``in_placements`` (the reference's
    ``shard_map_compat``: each DTensor argument enters ``body`` as its
    local shard; plain arguments, with placements ``None``, pass as they
    are).  ``in_grad_placements`` names each input's gradient placements:
    ``Partial`` where the body leaves rank-partial sums; ``None`` keeps the
    input's own."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map as _lm

    def one(p):                    # one tensor's placements, as a list
        return None if p is None else list(p)

    if in_grad_placements is not None:
        in_grad_placements = tuple(
            one(p if g is None else g)
            for p, g in zip(in_placements, in_grad_placements))
    if isinstance(out_placements[0], Placement):
        out = one(out_placements)              # a single output
    else:
        out = tuple(one(p) for p in out_placements)
    return _lm(body, out_placements=out,
               in_placements=tuple(one(p) for p in in_placements),
               in_grad_placements=in_grad_placements, device_mesh=mesh,
               redistribute_inputs=True)


# --------------------------------------------------------------------------- #
# Collectives on local tensors (inside local_map bodies)
# --------------------------------------------------------------------------- #
def _groups(mesh, axes):
    """(group_name, size) per named axis of size > 1."""
    names = mesh.mesh_dim_names
    out = []
    for a in ((axes,) if isinstance(axes, str) else axes):
        i = names.index(a)
        if mesh.size(i) > 1:
            out.append((mesh.get_group(i).group_name, mesh.size(i)))
    return out


def axis_index(mesh, axes) -> int:
    """This rank's index along one axis or along several taken together
    (major to minor), the reference's ``lax.axis_index``."""
    names = mesh.mesh_dim_names
    idx = 0
    for a in ((axes,) if isinstance(axes, str) else axes):
        i = names.index(a)
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def axis_size(mesh, axes) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a))
                     for a in ((axes,) if isinstance(axes, str) else axes))


def _all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum"):
    fc = torch.ops._c10d_functional
    for name, _ in _groups(mesh, axes):
        t = fc.wait_tensor(fc.all_reduce(t.contiguous(), op, name))
    return t


def _all_gather(t: torch.Tensor, mesh, axes, dim: int):
    """Gather shards along ``dim`` over ``axes`` (minor axis first, so
    the result is in the mesh's major-to-minor order)."""
    fc = torch.ops._c10d_functional
    groups = _groups(mesh, axes)
    for name, n in reversed(groups):
        x = t.movedim(dim, 0).contiguous()
        x = fc.wait_tensor(fc.all_gather_into_tensor(x, n, name))
        t = x.movedim(0, dim)
    return t


def _reduce_scatter(t: torch.Tensor, mesh, axes, dim: int):
    """Sum over ``axes``, keep this rank's chunk along ``dim``."""
    fc = torch.ops._c10d_functional
    for name, n in _groups(mesh, axes):
        x = t.movedim(dim, 0).contiguous()
        x = fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", n, name))
        t = x.movedim(0, dim)
    return t


def _local_chunk(t: torch.Tensor, mesh, axes, dim: int):
    n = axis_size(mesh, axes)
    step = t.shape[dim] // n
    return t.narrow(dim, axis_index(mesh, axes) * step, step)


class _Reduce(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward.  The output
    feeds computation replicated over ``axes``, so each rank's incoming
    gradient is already the whole one."""

    @staticmethod
    def forward(ctx, t, mesh, axes, op):
        return _all_reduce(t, mesh, axes, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Copy(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward.  Marks where a
    tensor replicated over ``axes`` enters computation sharded over them:
    each rank's gradient is a partial sum."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward.  Backward keeps this rank's chunk
    of the gradient (``partial=False``: the gathered tensor feeds
    computation replicated over ``axes``) or reduce-scatters it
    (``partial=True``: each rank used the whole tensor for its own
    shard of the work)."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim, partial):
        ctx.mesh, ctx.axes, ctx.dim, ctx.partial = mesh, axes, dim, partial
        return _all_gather(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim)
        else:
            g = _local_chunk(g, ctx.mesh, ctx.axes, ctx.dim)
        return g, None, None, None, None


def reduce_from(t: torch.Tensor, mesh, axes, op: str = "sum"):
    """g: sum (or max, with no gradient) over ``axes``; identity backward."""
    if not _groups(mesh, axes):
        return t
    if op == "max":
        return _all_reduce(t.detach(), mesh, axes, "max")
    return _Reduce.apply(t, mesh, axes, op)


def copy_to(t: torch.Tensor, mesh, axes):
    """f: identity; the gradient is summed over ``axes``."""
    if not _groups(mesh, axes) or not t.requires_grad:
        return t
    return _Copy.apply(t, mesh, axes)


def gather_from(t: torch.Tensor, mesh, axes, dim: int,
                partial: bool = False):
    """All-gather along ``dim`` over ``axes`` (see :class:`_Gather`)."""
    if not _groups(mesh, axes):
        return t
    return _Gather.apply(t, mesh, axes, dim, partial)


def split_to(t: torch.Tensor, mesh, axes, dim: int):
    """This rank's chunk along ``dim`` of a tensor replicated over
    ``axes`` (a view: the gradient lands in the chunk, zeros elsewhere;
    pair with :func:`copy_to` when other ranks use the other chunks)."""
    if not _groups(mesh, axes):
        return t
    return _local_chunk(t, mesh, axes, dim)
