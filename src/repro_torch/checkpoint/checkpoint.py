"""Step-versioned checkpointing: atomic npz + JSON manifest, async option.

The reference's file format (``src/repro/checkpoint/checkpoint.py``), so
either package restores what the other wrote: ``ckpt_{step:08d}.npz``
holds ``leaf_{i}`` for the tree's leaves in sorted key order (the
reference's flatten order), ``ckpt_{step:08d}.json`` the step, the leaf
names (``['params']['embed']`` ...), their count and their dtypes.
bfloat16 leaves are stored as 2-byte raw values (``|V2``, as numpy stores
the reference's extension dtype) and named ``"bfloat16"`` in the
manifest.  Each file is written to a temporary name and renamed, so a
crash mid-save leaves the newest complete checkpoint intact.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import tree_unflatten

_BF16_RAW = np.dtype("V2")     # how numpy stores the reference's bf16


def _flatten(tree, prefix=""):
    """[(name, leaf)] in sorted key order, names as ``jax.tree_util.keystr``
    writes dict paths."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{prefix}['{k}']")]
    return [(prefix, tree)]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return (t.contiguous().view(torch.int16).numpy()
                    .view(_BF16_RAW), "bfloat16")
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    host = [_to_host(leaf) for _, leaf in flat]
    arrays = {f"leaf_{i}": arr for i, (arr, _) in enumerate(host)}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    manifest = {"step": step, "names": [name for name, _ in flat],
                "n_leaves": len(flat), "dtypes": [dt for _, dt in host]}
    mpath = os.path.join(directory, f"ckpt_{step:08d}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    _prune(directory, keep)
    return path


def save_async(directory: str, step: int, tree,
               keep: int = 3) -> threading.Thread:
    """Copy to host memory now, write to disk on a thread."""
    host = tree_unflatten(tree, [leaf.detach().to("cpu", copy=True)
                                 if isinstance(leaf, torch.Tensor)
                                 else np.asarray(leaf)
                                 for _, leaf in _flatten(tree)])
    t = threading.Thread(target=save, args=(directory, step, host, keep),
                         daemon=True)
    t.start()
    return t


def _steps(directory: str) -> list:
    return sorted(int(f[5:13]) for f in os.listdir(directory)
                  if f.startswith("ckpt_") and f.endswith(".npz")
                  and not f.endswith(".tmp.npz"))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, example_tree, step: Optional[int] = None
            ) -> Tuple[int, object]:
    """Restore into the structure of ``example_tree`` (leaf count and
    shapes validated).  Each leaf keeps the stored dtype; a tensor leaf of
    the example comes back as a tensor on that leaf's device."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    mpath = os.path.join(directory, f"ckpt_{step:08d}.json")
    dtypes = None
    if os.path.exists(mpath):
        with open(mpath) as f:
            dtypes = json.load(f).get("dtypes")
    flat = _flatten(example_tree)
    restored = []
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        if len(data.files) != len(flat):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, the "
                             f"tree {len(flat)}")
        for i, (name, ref) in enumerate(flat):
            arr = data[f"leaf_{i}"]
            if tuple(ref.shape) != arr.shape:
                raise ValueError(f"leaf {i} {name}: checkpoint shape "
                                 f"{arr.shape} != {tuple(ref.shape)}")
            bf16 = bool(dtypes) and dtypes[i] == "bfloat16"
            if isinstance(ref, torch.Tensor):
                t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
                if bf16:
                    t = t.view(torch.bfloat16)
                restored.append(t.to(ref.device))
            else:
                restored.append(arr)
    return step, tree_unflatten(example_tree, restored)


def _prune(directory: str, keep: int) -> None:
    for s in _steps(directory)[:-keep]:
        for ext in (".npz", ".json"):
            try:
                os.remove(os.path.join(directory, f"ckpt_{s:08d}{ext}"))
            except OSError:
                pass
