"""The port's mesh on the CPU: 4-rank gloo worlds against the port's own
single-device step and against the reference's sharded step.

One battery runs once per session (under xdist too: the first worker runs
it, the others read its JSON): two worlds of four rank processes of this
file (``python test_torch_distributed.py rank R ...``, one torch thread
each, a FileStore per world) split the cases between them and run each on
the meshes 2x2 and 1x4, while one JAX process per reference case
(``python test_torch_distributed.py jax ...``) runs the reference's
sharded train step on the same mesh shapes (4 host devices, Auto axes),
the first also its ``compressed_psum`` under ``shard_map``.  Weights and
batches are numpy, drawn per parameter path from one seed, so both
packages start from the same numbers.
"""
from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(HERE), "..", "src")
MESHES = ((2, 2), (1, 4))
# (name, arch, n_experts override)
CASES = (("smollm-360m", "smollm-360m", None),
         ("qwen2.5-3b", "qwen2.5-3b", None),
         ("olmoe-1b-7b", "olmoe-1b-7b", None),
         ("olmoe-e6", "olmoe-1b-7b", 6),
         ("rwkv6-7b", "rwkv6-7b", None),
         ("recurrentgemma-2b", "recurrentgemma-2b", None),
         ("hubert-xlarge", "hubert-xlarge", None),
         ("paligemma-3b", "paligemma-3b", None))
# the train cases of each of two 4-rank worlds run side by side; the
# first world also runs every other case
PARTS = (CASES[:4], CASES[4:])
REF_CASES = ("smollm-360m", "olmoe-1b-7b")
# zero-sp train gradients; prefill + decode on both meshes
ZERO_SP = (("smollm-360m", "1x4"), ("qwen2.5-3b", "2x2"))
DECODE = ("smollm-360m", "qwen2.5-3b", "olmoe-1b-7b", "rwkv6-7b",
          "recurrentgemma-2b")
B, S = 8, 16
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)


def _cfg(arch: str, n_experts, configs):
    import dataclasses
    cfg = configs.reduced_config(configs.get_config(arch))
    if n_experts:
        cfg = dataclasses.replace(cfg, n_experts=n_experts)
    return cfg


def _np_leaves(shapes: dict, inits: dict) -> dict:
    """path -> float32 array: normal / sqrt(fan_in) drawn per path (a
    generator seeded from the path), zeros or ones."""
    out = {}
    for path, shape in shapes.items():
        init, fan = inits[path]
        if init == "zeros":
            out[path] = np.zeros(shape, np.float32)
        elif init == "ones":
            out[path] = np.ones(shape, np.float32)
        else:
            rng = np.random.default_rng(zlib.crc32(path.encode()))
            out[path] = (rng.standard_normal(shape) / np.sqrt(max(fan, 1))
                         ).astype(np.float32)
    return out


def _np_batch(cfg) -> dict:
    """The pipeline's keys and shapes for (B, S), drawn with numpy."""
    rng = np.random.default_rng(3)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int32),
                "loss_mask": (rng.random((B, S)) < 0.3).astype(np.float32)}
    if cfg.frontend == "vision":
        p = cfg.n_patches
        toks = rng.integers(0, cfg.vocab_size, (B, S - p + 1)
                            ).astype(np.int32)
        return {"patches": rng.standard_normal((B, p, cfg.d_model))
                .astype(np.float32),
                "tokens": toks[:, :-1], "targets": toks[:, 1:]}
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


# --------------------------------------------------------------------------- #
# Rank process (torch only)
# --------------------------------------------------------------------------- #
def _rank_main(rank: int, world: int, store: str, out: str,
               part: int) -> None:
    import copy
    import logging

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    sys.path.insert(0, SRC)
    from repro_torch import configs
    from repro_torch.distributed import compression
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S_
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import FleetTrainer
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import model
    from repro_torch.models.spec import spec_leaves
    from repro_torch.optim import adamw

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=__import__("datetime").timedelta(
                                seconds=300))
    from torch.distributed.tensor import Replicate, Shard
    cpu = torch.device("cpu")
    opt_cfg = adamw.OptConfig(**OPT)
    res = {"cases": {}}

    def params_of(cfg):
        leaves = spec_leaves(model.param_specs(cfg))
        arrs = _np_leaves({p: s.shape for p, s in leaves},
                          {p: (s.init, s.fan_in if s.fan_in is not None
                               else (s.shape[0] if s.shape else 1))
                           for p, s in leaves})
        out = model.tree_map(lambda _: None, model.param_specs(cfg))
        for p, s in leaves:
            node = out
            *head, last = p.split("/")
            for k in head:
                node = node[k]
            node[last] = torch.from_numpy(arrs[p]).to(s.dtype)
        return out

    # the gradients each train step hands to AdamW, as the step made them
    stepped = {}
    update = adamw.update

    def spy_update(opt_cfg, grads, opt, params):
        stepped["grads"] = [g.full_tensor() if hasattr(g, "full_tensor")
                            else g.clone() for g in model._tree_leaves(grads)]
        return update(opt_cfg, grads, opt, params)
    adamw.update = spy_update

    def grads_of(cfg, ctx, params, batch):
        live = model.tree_map(lambda p: p.detach().requires_grad_(), params)
        total, _ = model.forward(cfg, live, batch, ctx, "train")
        gs = torch.autograd.grad(total, model._tree_leaves(live),
                                 materialize_grads=True)
        return [g.full_tensor() if hasattr(g, "full_tensor") else g
                for g in gs]

    def shard_batch(batch, mesh):
        specs = shd.input_shardings(batch, mesh, B)
        return {k: shd.distribute(v, shd.placements(specs[k], mesh), mesh)
                for k, v in batch.items()}

    meshes = {f"{d}x{m}": make_mesh((d, m), device_type="cpu")
              for d, m in MESHES}
    for name, arch, ne in PARTS[part]:
        cfg = _cfg(arch, ne, configs)
        capf = cfg.n_experts / cfg.top_k if cfg.is_moe else 1.25
        params = params_of(cfg)
        batch = {k: torch.from_numpy(v) for k, v in _np_batch(cfg).items()}
        ctx0 = S_.make_context(cpu, moe_capacity_factor=capf)
        st0 = {"params": copy.deepcopy(params),
               "opt": adamw.init(params)}
        _, m0 = S_.build_train_step(cfg, opt_cfg, ctx0)(st0, batch)
        g0 = stepped["grads"]
        for mname, mesh in meshes.items():
            if ne and mname != "1x4":
                continue          # the d_ff-parallel body needs E % 4 != 0
            t0 = time.time()
            ctx = S_.make_context(mesh=mesh, moe_capacity_factor=capf)
            pp = shd.distribute_tree(copy.deepcopy(params),
                                     S_.param_shardings(cfg, mesh), mesh)
            bd = shard_batch(batch, mesh)
            _, m1 = S_.build_train_step(cfg, opt_cfg, ctx)(
                {"params": pp, "opt": adamw.init(pp)}, bd)
            g1 = stepped["grads"]
            leaf_err = max(float((a - b).abs().max())
                           / max(float(b.abs().max()), 1e-30)
                           for a, b in zip(g1, g0))
            res["cases"][f"{name}@{mname}"] = {
                "loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
                "loss0": float(m0["loss"]),
                "grad_norm0": float(m0["grad_norm"]),
                "leaf_err": leaf_err, "seconds": time.time() - t0}

    if part:
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        dist.barrier()
        dist.destroy_process_group()
        return

    # gradient accumulation on a mesh: each rank's rows, split in two
    cfg = _cfg("smollm-360m", None, configs)
    params = params_of(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _np_batch(cfg).items()}
    st0 = {"params": copy.deepcopy(params), "opt": adamw.init(params)}
    _, m0 = S_.build_train_step(cfg, opt_cfg, S_.make_context(
        cpu, microbatches=2))(st0, batch)
    mesh = meshes["2x2"]
    pp = shd.distribute_tree(copy.deepcopy(params),
                             S_.param_shardings(cfg, mesh), mesh)
    _, m1 = S_.build_train_step(cfg, opt_cfg, S_.make_context(
        mesh=mesh, microbatches=2))({"params": pp, "opt": adamw.init(pp)},
                                    shard_batch(batch, mesh))
    res["microbatches"] = {k: [float(m1[k]), float(m0[k])]
                           for k in ("loss", "grad_norm")}

    # zero-sp: the sequence over the model axis, weights FSDP only
    res["zero_sp"] = {}
    for name, mname in ZERO_SP:
        cfg = _cfg(name, None, configs)
        params = params_of(cfg)
        batch = {k: torch.from_numpy(v) for k, v in _np_batch(cfg).items()}
        g0 = grads_of(cfg, S_.make_context(cpu), params, batch)
        mesh = meshes[mname]
        ctx = S_.make_context(mesh=mesh, sharding_profile="zero-sp")
        pp = shd.distribute_tree(copy.deepcopy(params),
                                 S_.param_shardings(cfg, mesh, "zero-sp"),
                                 mesh)
        g1 = grads_of(cfg, ctx, pp, shard_batch(batch, mesh))
        res["zero_sp"][f"{name}@{mname}"] = max(
            float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(g1, g0))

    # prefill + decode steps on the mesh against the mesh-free path
    res["decode"] = {}
    for name in DECODE:
        cfg = _cfg(name, None, configs)
        params = params_of(cfg)
        toks = torch.from_numpy(_np_batch(cfg)["tokens"])
        cap = S + 4
        # no expert drops: the mesh's capacity is per data shard
        kw = ({"moe_capacity_factor": cfg.n_experts / cfg.top_k}
              if cfg.is_moe else {})
        ctx0 = S_.make_context(cpu, **kw)
        with torch.no_grad():
            lw, cw = model.forward(cfg, params, {"tokens": toks}, ctx0,
                                   "prefill", cache_capacity=cap)
            want = [lw]
            nxt = lw.argmax(-1, keepdim=True).to(torch.int32)
            for t in range(2):
                lw, cw = model.decode_step(cfg, params, cw, nxt, S + t, ctx0)
                want.append(lw)
                nxt = lw.argmax(-1, keepdim=True).to(torch.int32)
            for mname, mesh in meshes.items():
                ctx = S_.make_context(mesh=mesh, **kw)
                pp = shd.distribute_tree(copy.deepcopy(params),
                                         S_.param_shardings(cfg, mesh), mesh)
                lg, cg = model.forward(cfg, pp, shard_batch(
                    {"tokens": toks}, mesh), ctx, "prefill",
                    cache_capacity=cap)
                got = [lg.full_tensor()]
                nxt = got[0].argmax(-1, keepdim=True).to(torch.int32)
                for t in range(2):
                    nd = shd.distribute(nxt, (Shard(0), Replicate()), mesh)
                    lg, cg = model.decode_step(cfg, pp, cg, nd, S + t, ctx)
                    got.append(lg.full_tensor())
                    nxt = got[-1].argmax(-1, keepdim=True).to(torch.int32)
                cache_err = max(
                    float((a.full_tensor() - b).abs().max())
                    / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(model._tree_leaves(cg),
                                    model._tree_leaves(cw)))
                res["decode"][f"{name}@{mname}"] = {
                    "logits": max(float((a - b).abs().max() / b.abs().max())
                                  for a, b in zip(got, want)),
                    "cache": cache_err}

    # bf16 decode attention against a sequence-split cache (1x4: two KV
    # heads do not divide four model ranks) against the mesh-free core
    import dataclasses
    from repro_torch.models import blocks
    from repro_torch.models.layers import attention_xla
    cfg = dataclasses.replace(_cfg("smollm-360m", None, configs),
                              dtype="bfloat16")
    mesh = meshes["1x4"]
    plan = blocks.MeshPlan(mesh, "model", ("data",), False, False, "kvseq",
                           1, False)
    rng = np.random.default_rng(7)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cap, pos = 256, 200

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    q, k, v = bf(4, 1, hq, hd) * 2, bf(4, 1, hkv, hd), bf(4, 1, hkv, hd)
    ck, cv = bf(4, cap, hkv, hd) * 2, bf(4, cap, hkv, hd)
    wk, wv = ck.clone(), cv.clone()
    wk[:, pos], wv[:, pos] = k[:, 0], v[:, 0]
    want = attention_xla(q, wk, wv, causal=True, q_offset=pos).float()
    lo = shd.axis_index(mesh, "model") * (cap // 4)
    local = {"k": ck[:, lo:lo + cap // 4].clone(),
             "v": cv[:, lo:lo + cap // 4].clone()}
    got = blocks._decode_sharded(q, k, v, cfg, local, pos, plan).float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
        got.abs(), want.abs()).clamp(min=1e-30))) - 7)
    res["kvseq_bf16"] = {"ulps": float(((got - want).abs() / ulp).max()),
                         "share": float((got != want).float().mean())}

    # vocab-sharded cross-entropy: values and gradients
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(4, 8, 256, generator=gen) * 3
    targets = torch.randint(0, 256, (4, 8), generator=gen)
    wts = torch.rand(4, 8, generator=gen)
    lg = logits.clone().requires_grad_()
    want = model._ce(lg, targets)
    gwant, = torch.autograd.grad((want * wts).sum(), [lg])
    want = want.detach()
    res["ce"] = {}
    for mname, mesh in meshes.items():
        ctx = S_.make_context(mesh=mesh)
        plc = (Shard(0), Shard(2))
        ld = shd.distribute(logits, plc, mesh).requires_grad_()
        td = shd.distribute(targets, (Shard(0), Replicate()), mesh)
        wd = shd.distribute(wts, (Shard(0), Replicate()), mesh)
        got = model._ce_vocab_sharded(ld, td, ctx)
        gg, = torch.autograd.grad((got * wd).sum(), [ld])
        res["ce"][mname] = {
            "value": float((got.full_tensor() - want).abs().max()
                           / want.abs().max()),
            "grad": float((gg.full_tensor() - gwant).abs().max()
                          / gwant.abs().max())}

    # serving profile: prefill logits through the MoE's sliced contraction
    cfg = _cfg("olmoe-1b-7b", None, configs)
    capf = cfg.n_experts / cfg.top_k
    params = params_of(cfg)
    batch = {"tokens": torch.from_numpy(_np_batch(cfg)["tokens"])}
    ctx0 = S_.make_context(cpu, moe_capacity_factor=capf)
    res["serve"] = {}
    with torch.no_grad():
        want, _ = model.forward(cfg, params, batch, ctx0, "prefill")
        for mname, mesh in meshes.items():
            ctx = S_.make_context(mesh=mesh, moe_capacity_factor=capf,
                                  sharding_profile="serve")
            pp = shd.distribute_tree(
                copy.deepcopy(params),
                S_.param_shardings(cfg, mesh, "serve"), mesh)
            got, _ = model.forward(cfg, pp, shard_batch(batch, mesh), ctx,
                                   "prefill")
            res["serve"][mname] = float((got.full_tensor() - want).abs()
                                        .max() / want.abs().max())

    # compressed_psum over the 2 data ranks of 2x2
    mesh = meshes["2x2"]
    d = shd.axis_index(mesh, "data")
    rng = np.random.default_rng(100 + d)
    g = torch.from_numpy(rng.standard_normal((6, 10)).astype(np.float32))
    r = torch.from_numpy((rng.standard_normal((6, 10)) * 1e-2)
                         .astype(np.float32))
    mean, resid = compression.compressed_psum(g, r, "data", mesh=mesh)
    gathered = [torch.zeros_like(resid) for _ in range(world)]
    dist.all_gather(gathered, resid)
    res["psum"] = {"mean": mean.tolist(),
                   "resid": [t.tolist() for t in gathered]}

    # FleetTrainer with compression on 2x2: data 2 -> compressed
    cfg = _cfg("smollm-360m", None, configs)
    tr = FleetTrainer(cfg, steps_total=2, data_cfg=DataConfig(B, S, seed=3),
                      opt_cfg=opt_cfg, grad_compression=True, mesh=mesh)
    state = tr.run()
    ef = max(float(t.to_local().abs().max())
             for t in model._tree_leaves(state["ef"]))
    res["fleet"] = {"compressed": tr._compressed, "losses": tr.report.losses,
                    "ef_max": ef}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# Reference process (JAX only)
# --------------------------------------------------------------------------- #
def _jax_main(out: str, name: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, SRC)
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P
    jax.config.update("jax_default_matmul_precision", "highest")
    from repro import configs
    from repro.distributed import compression
    from repro.distributed import sharding as shd
    from repro.launch import steps as S_
    from repro.models import model
    from repro.models.spec import ParamSpec
    from repro.optim import adamw

    res = {"cases": {}}
    opt_cfg = adamw.OptConfig(**OPT)
    cfg = configs.reduced_config(configs.get_config(name))
    capf = cfg.n_experts / cfg.top_k if cfg.is_moe else 1.25
    specs = model.param_specs(cfg)
    flat = {}

    def walk(t, pre=""):
        if isinstance(t, ParamSpec):
            flat[pre] = t
            return
        for k in sorted(t):
            walk(t[k], f"{pre}/{k}" if pre else k)
    walk(specs)
    arrs = _np_leaves({p: s.shape for p, s in flat.items()},
                      {p: (s.init, s.fan_in if s.fan_in is not None
                           else (s.shape[0] if s.shape else 1))
                       for p, s in flat.items()})

    def build(t, pre=""):
        if isinstance(t, ParamSpec):
            return jnp.asarray(arrs[pre], t.dtype)
        return {k: build(v, f"{pre}/{k}" if pre else k)
                for k, v in t.items()}
    params = build(specs)
    batch = {k: jnp.asarray(v) for k, v in _np_batch(cfg).items()}
    for d, m in MESHES:
        mesh = jax.make_mesh((d, m), ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto))
        ctx = S_.make_context(mesh, moe_capacity_factor=capf)
        step = jax.jit(S_.build_train_step(cfg, opt_cfg, ctx),
                       in_shardings=(S_.state_shardings(cfg, mesh),
                                     shd.input_shardings(batch, mesh, B)))
        state = {"params": params, "opt": adamw.init(params)}
        _, met = step(state, batch)
        res["cases"][f"{name}@{d}x{m}"] = {
            "loss": float(met["loss"]),
            "grad_norm": float(met["grad_norm"])}
    if name != REF_CASES[0]:
        with open(out, "w") as f:
            json.dump(res, f)
        return
    # compressed_psum over data (2 ranks) of a 2x2 mesh
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    gs, rs = [], []
    for d in range(2):
        rng = np.random.default_rng(100 + d)
        gs.append(rng.standard_normal((6, 10)).astype(np.float32))
        rs.append((rng.standard_normal((6, 10)) * 1e-2).astype(np.float32))
    g = jnp.asarray(np.concatenate(gs))
    r = jnp.asarray(np.concatenate(rs))
    fn = shd.shard_map_compat(
        lambda gg, rr: compression.compressed_psum(gg, rr, "data"),
        mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")))
    mean, resid = fn(g, r)
    res["psum"] = {"mean": np.asarray(mean)[:6].tolist(),
                   "resid": np.asarray(resid).reshape(2, 6, 10).tolist()}
    with open(out, "w") as f:
        json.dump(res, f)


# --------------------------------------------------------------------------- #
# Session fixture: run both once, share the JSON
# --------------------------------------------------------------------------- #
def _run_battery(tmp) -> dict:
    """Two 4-rank worlds (one per part of the cases) and one reference
    process per reference case, all at once; their JSON merged."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    out_t = [os.path.join(tmp, f"torch{i}.json") for i in range(len(PARTS))]
    out_j = [os.path.join(tmp, f"jax{i}.json")
             for i in range(len(REF_CASES))]

    def start(*args):
        return subprocess.Popen([sys.executable, HERE, *map(str, args)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    procs = [start("jax", out, name) for out, name in zip(out_j, REF_CASES)]
    procs += [start("rank", r, 4, os.path.join(tmp, f"store{i}"), out, i)
              for i, out in enumerate(out_t) for r in range(4)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    merged = {}
    for key, outs in (("torch", out_t), ("jax", out_j)):
        merged[key] = {"cases": {}}
        for out in outs:
            with open(out) as f:
                res = json.load(f)
            merged[key]["cases"].update(res.pop("cases"))
            merged[key].update(res)
    return merged


@pytest.fixture(scope="session")
def battery(tmp_path_factory):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _run_battery(str(tmp_path_factory.mktemp("mesh")))
    root = tmp_path_factory.getbasetemp().parent
    path = root / "torch_mesh_battery.json"
    with open(str(path) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.is_file():
            return json.loads(path.read_text())
        tmp = root / "torch_mesh_battery"
        tmp.mkdir(exist_ok=True)
        data = _run_battery(str(tmp))
        path.write_text(json.dumps(data))
        return data


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


_TRAIN = [(name, f"{d}x{m}") for name, _, ne in CASES for d, m in MESHES
          if not ne or (d, m) == (1, 4)]


@pytest.mark.parametrize("name,mesh", _TRAIN)
def test_sharded_train_step_matches_single_device(battery, name, mesh):
    """Loss and grad norm within 1e-5 relative of the port's one-device
    step; every gradient leaf within 2e-5 of its largest entry."""
    r = battery["torch"]["cases"][f"{name}@{mesh}"]
    assert _rel(r["loss"], r["loss0"]) < 1e-5, r
    assert _rel(r["grad_norm"], r["grad_norm0"]) < 1e-5, r
    assert r["leaf_err"] < 2e-5, r


@pytest.mark.parametrize("name", REF_CASES)
@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_sharded_train_step_matches_reference_sharded(battery, name, mesh):
    """The port's sharded step against the reference's sharded step on the
    same mesh shape (Auto axes), within 1e-5 relative."""
    key = f"{name}@{mesh}"
    t, j = battery["torch"]["cases"][key], battery["jax"]["cases"][key]
    assert _rel(t["loss"], j["loss"]) < 1e-5, (t, j)
    assert _rel(t["grad_norm"], j["grad_norm"]) < 1e-5, (t, j)


def test_microbatches_on_a_mesh(battery):
    """Gradient accumulation over each rank's rows (2 microbatches on
    2x2) against the one-device step's 2 microbatches."""
    for k, (got, want) in battery["torch"]["microbatches"].items():
        assert _rel(got, want) < 1e-5, (k, got, want)


@pytest.mark.parametrize("name,mesh", ZERO_SP)
def test_zero_sp_gradients_match_single_device(battery, name, mesh):
    """The zero-sp profile (rows over the model axis, weights FSDP only):
    every gradient leaf within 2e-5 of its largest entry."""
    assert battery["torch"]["zero_sp"][f"{name}@{mesh}"] < 2e-5


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("name", DECODE)
def test_prefill_and_decode_match_mesh_free(battery, name, mesh):
    """A prefill and two decode steps on the mesh (KV heads split on 2x2,
    the cache's sequence split with the partial softmaxes combined on
    1x4; RWKV state split over heads): logits and every cache leaf within
    1e-5 of the largest."""
    r = battery["torch"]["decode"][f"{name}@{mesh}"]
    assert r["logits"] < 1e-5 and r["cache"] < 1e-5, r


def test_kvseq_decode_bf16_matches_mesh_free(battery):
    """bf16 decode against a cache split by sequence over 4 model ranks:
    the probabilities are normalised and rounded to bf16 before the PV
    product, as on one device, so every output is within one bf16 ulp of
    the mesh-free attention and at most 1% of them differ."""
    r = battery["torch"]["kvseq_bf16"]
    assert r["ulps"] <= 1 and r["share"] <= 0.01, r


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_vocab_sharded_cross_entropy(battery, mesh):
    """Per-token losses and their gradients against the unsharded loss,
    within 1e-6 of the largest."""
    r = battery["torch"]["ce"][mesh]
    assert r["value"] < 1e-6 and r["grad"] < 1e-6, r


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_serve_profile_moe_matches_mesh_free(battery, mesh):
    """olmoe prefill logits on the serve profile (resident expert weights,
    the d_model-sliced contraction) against the mesh-free path."""
    assert battery["torch"]["serve"][mesh] < 1e-5


def test_compressed_psum_matches_reference(battery):
    t, j = battery["torch"]["psum"], battery["jax"]["psum"]
    np.testing.assert_allclose(t["mean"], j["mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(t["resid"])[[0, 2]], j["resid"],
                               rtol=0, atol=1e-6)


def test_fleet_trainer_compresses_on_a_data_axis(battery):
    r = battery["torch"]["fleet"]
    assert r["compressed"] and len(r["losses"]) == 2
    assert all(np.isfinite(r["losses"])) and r["ef_max"] > 0


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5], int(sys.argv[6]))
    else:
        _jax_main(sys.argv[2], sys.argv[3])
