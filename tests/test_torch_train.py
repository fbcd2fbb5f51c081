"""Training slice of the port vs the reference (CPU, float32).

Weights: the reference's ``model.init(cfg, PRNGKey(0))`` through
``weights.from_jax``; batches: one numpy draw handed to both packages (the
port's synthetic pipeline draws other values than ``jax.random``, ROADMAP
Queue 3).  The port trains on ``impl="torch"`` (``steps.make_context``),
the reference on its XLA path (``RunContext()``), both at capacity factor
1.25 with full recomputation.

Tolerances, set from the float32 sums running in another order:
  * train loss, aux and total: LOSS_TOL (1e-5) absolute;
  * gradients, per leaf: max |port - reference| <= GRAD_RTOL (2e-5) times
    the leaf's largest reference entry, plus GRAD_ATOL (1e-7) for leaves
    whose gradient is all zero (measured: at most 6.8e-6 of the leaf's
    largest entry, rwkv6-7b; 2e-6 for every other architecture);
  * AdamW on identical gradients: UPDATE_TOL (1e-6) absolute on the new
    parameters and moments.
Parameters after a step of two different gradient computations are never
compared: AdamW's first step divides each gradient by its own magnitude,
so a rounding-level gradient can move its parameter by 2 * lr either way.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config, list_archs, reduced_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import Pipeline as JPipeline
from repro.launch import steps as JS
from repro.models import layers as jlayers
from repro.models import model as jm
from repro.models.context import RunContext as JContext
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.faults import FaultPlan
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.distributed.compression import (dequantize_int8,
                                                 init_error_feedback,
                                                 quantize_int8)
from repro_torch.launch import steps as S
from repro_torch.launch.train import FleetTrainer, main
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tm
from repro_torch.models import weights
from repro_torch.models.context import RunContext
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig

LOSS_TOL = 1e-5
GRAD_RTOL = 2e-5
GRAD_ATOL = 1e-7
UPDATE_TOL = 1e-6
B, SEQ = 2, 16
CPU = torch.device("cpu")
_REF = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager torch on the CPU pays more for its thread pool than for these
    small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_batch(cfg, b=B, s=SEQ, seed=0):
    """One numpy batch in the reference pipeline's layout: audio frames
    with a random 0/1 loss mask, vision patches ahead of s - n_patches
    text tokens, text tokens; targets drawn independently."""
    rng = np.random.default_rng(seed)
    ids = lambda n: rng.integers(0, cfg.vocab_size, (b, n),   # noqa: E731
                                 dtype=np.int32)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
                    (b, s, cfg.d_model)).astype(np.float32),
                "targets": ids(s),
                "loss_mask": (rng.random((b, s)) < 0.5).astype(np.float32)}
    if cfg.frontend == "vision":
        p = cfg.n_patches
        return {"patches": rng.standard_normal(
                    (b, p, cfg.d_model)).astype(np.float32),
                "tokens": ids(s - p), "targets": ids(s - p)}
    return {"tokens": ids(s), "targets": ids(s)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v).copy())
            for k, v in batch.items()}


def _setup(arch):
    """Reference config, port config, shared weights and one batch."""
    if arch not in _REF:
        cfg = reduced_config(get_config(arch))
        tcfg = t_reduced_config(t_get_config(arch))
        jp = jm.init(cfg, jax.random.PRNGKey(0))
        tp = weights.from_jax(jax.tree.map(np.asarray, jp), tcfg)
        _REF[arch] = dict(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp,
                          batch=np_batch(cfg))
    return _REF[arch]


def _reference_grads(arch):
    """The reference's (total, metrics, grads) on the shared batch."""
    s = _setup(arch)
    if "jgrads" not in s:
        cfg = s["cfg"]
        f = jax.jit(jax.value_and_grad(
            lambda p, b: jm.forward(cfg, p, b, JContext(), "train"),
            has_aux=True))
        (total, metrics), grads = f(s["jp"], _j(s["batch"]))
        s["jgrads"] = (total, metrics, grads)
    return s["jgrads"]


def _port_grads(tcfg, params, batch, ctx):
    """The port's (total, metrics, grads as leaves in sorted key order)."""
    live = tm.tree_map(lambda p: p.detach().requires_grad_(), params)
    total, metrics = tm.forward(tcfg, live, batch, ctx, "train")
    grads = torch.autograd.grad(total, tm._tree_leaves(live),
                                materialize_grads=True)
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _assert_grads_close(got, want, what):
    want = [np.asarray(w, np.float32) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.float().numpy()
        assert g.shape == w.shape, (what, i)
        err = float(np.max(np.abs(g - w)))
        bound = GRAD_RTOL * float(np.max(np.abs(w))) + GRAD_ATOL
        assert err <= bound, f"{what} leaf {i}: {err:.3e} > {bound:.3e}"


# --------------------------------------------------------------------------- #
# train forward and gradients, all ten architectures
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list_archs())
def test_train_forward_matches_reference(arch):
    s = _setup(arch)
    jtotal, jmet, _ = _reference_grads(arch)
    total, met = tm.forward(s["tcfg"], s["tp"], _t(s["batch"]),
                            S.make_context("cpu"), "train")
    assert total.shape == () and np.isfinite(float(total))
    assert abs(float(total) - float(jtotal)) <= LOSS_TOL
    for k in ("loss", "aux"):
        assert abs(float(met[k]) - float(jmet[k])) <= LOSS_TOL, k
    if s["cfg"].is_moe:
        assert float(met["aux"]) > 0


@pytest.mark.parametrize("arch", list_archs())
def test_train_gradients_match_reference(arch):
    s = _setup(arch)
    _, _, jgrads = _reference_grads(arch)
    _, _, grads = _port_grads(s["tcfg"], s["tp"], _t(s["batch"]),
                              S.make_context("cpu"))
    _assert_grads_close(grads, jgrads, arch)


def test_frontend_projection_loads_from_reference():
    for arch in ("hubert-xlarge", "paligemma-3b"):
        s = _setup(arch)
        d = s["tcfg"].d_model
        assert tuple(s["tp"]["frontend"]["proj"].shape) == (d, d)
        np.testing.assert_array_equal(s["tp"]["frontend"]["proj"].numpy(),
                                      np.asarray(s["jp"]["frontend"]["proj"]))


# --------------------------------------------------------------------------- #
# the train step and AdamW
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b"])
def test_train_step_matches_reference(arch):
    """One ``build_train_step``: metrics and step count as the reference's,
    the first moment (a multiple of the clipped gradient) per leaf within
    the gradient tolerance."""
    s = _setup(arch)
    jstep = jax.jit(JS.build_train_step(s["cfg"], jadamw.OptConfig(),
                                        JContext()))
    jstate, jm_ = jstep({"params": s["jp"], "opt": jadamw.init(s["jp"])},
                        _j(s["batch"]))
    step = S.build_train_step(s["tcfg"], OptConfig(), S.make_context("cpu"))
    state, m = step({"params": s["tp"], "opt": adamw.init(s["tp"])},
                    _t(s["batch"]))
    for k in ("loss", "aux", "total"):
        assert abs(float(m[k]) - float(jm_[k])) <= LOSS_TOL, k
    assert float(m["lr"]) == pytest.approx(float(jm_["lr"]), rel=1e-7)
    assert float(m["grad_norm"]) == pytest.approx(float(jm_["grad_norm"]),
                                                  rel=GRAD_RTOL)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
    assert state["opt"]["step"].dtype == torch.int32
    _assert_grads_close(tm._tree_leaves(state["opt"]["mu"]),
                        jstate["opt"]["mu"], f"{arch} mu")
    moved = [float((a.float() - b.float()).abs().max()) for a, b in zip(
        tm._tree_leaves(s["tp"]), tm._tree_leaves(state["params"]))]
    assert max(moved) > 0


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_adamw_update_matches_reference_on_identical_gradients(clip_norm):
    """Two AdamW updates fed the reference's gradients, clipped (the
    gradient norm is about 5) and not: parameters, moments, lr and grad
    norm within UPDATE_TOL of the reference's update."""
    s = _setup("smollm-360m")
    _, _, jgrads = _reference_grads("smollm-360m")
    cfg = OptConfig(clip_norm=clip_norm, warmup_steps=1)
    jcfg = jadamw.OptConfig(clip_norm=clip_norm, warmup_steps=1)
    tgrads = weights.from_jax(jax.tree.map(np.asarray, jgrads), s["tcfg"])
    jp, jopt = s["jp"], jadamw.init(s["jp"])
    tp, topt = s["tp"], adamw.init(s["tp"])
    for _ in range(2):
        jp, jopt, jmet = jadamw.update(jcfg, jgrads, jopt, jp)
        tp, topt, tmet = adamw.update(cfg, tgrads, topt, tp)
        for name, got, want in (("params", tp, jp), ("mu", topt["mu"],
                                                     jopt["mu"]),
                                ("nu", topt["nu"], jopt["nu"])):
            for g, w in zip(tm._tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=UPDATE_TOL, rtol=0,
                                           err_msg=name)
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=1e-7)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-6)
    assert int(topt["step"]) == int(jopt["step"]) == 2


def test_microbatches_match_single_batch():
    """``microbatches=2`` accumulates float32 gradients and averages the
    metrics: the same step as one batch of 2 rows, to float32 rounding."""
    s = _setup("olmoe-1b-7b")
    out = {}
    for k in (1, 2):
        step = S.build_train_step(s["tcfg"], OptConfig(),
                                  S.make_context("cpu", microbatches=k))
        out[k] = step({"params": s["tp"], "opt": adamw.init(s["tp"])},
                      _t(s["batch"]))
    (s1, m1), (s2, m2) = out[1], out[2]
    # the halves route separately (capacity per call), so the losses are
    # those of two calls: compare to the mean of the two half-batch runs
    halves = [tm.forward(s["tcfg"], s["tp"],
                         {k: v[i:i + 1] for k, v in _t(s["batch"]).items()},
                         S.make_context("cpu"), "train")[1]
              for i in range(2)]
    for k in ("loss", "aux"):
        want = (float(halves[0][k]) + float(halves[1][k])) / 2
        assert float(m2[k]) == pytest.approx(want, abs=1e-6), k
    with pytest.raises(ValueError, match="microbatches"):
        S.build_train_step(s["tcfg"], OptConfig(), S.make_context(
            "cpu", microbatches=3))({"params": s["tp"],
                                     "opt": adamw.init(s["tp"])},
                                    _t(s["batch"]))
    # a dense model: one batch and two halves differ by rounding only
    d = _setup("smollm-360m")
    dense = {}
    for k in (1, 2):
        step = S.build_train_step(d["tcfg"], OptConfig(),
                                  S.make_context("cpu", microbatches=k))
        dense[k] = step({"params": d["tp"], "opt": adamw.init(d["tp"])},
                        _t(d["batch"]))
    (d1, dm1), (d2, dm2) = dense[1], dense[2]
    assert float(dm2["loss"]) == pytest.approx(float(dm1["loss"]), abs=1e-6)
    assert float(dm2["grad_norm"]) == pytest.approx(float(dm1["grad_norm"]),
                                                    rel=1e-5)
    for a, b in zip(tm._tree_leaves(d1["opt"]["mu"]),
                    tm._tree_leaves(d2["opt"]["mu"])):
        bound = GRAD_RTOL * float(a.abs().max()) + GRAD_ATOL
        assert float((a - b).abs().max()) <= bound


@pytest.mark.parametrize("factor", [1.25, 0.25])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_layer_gradients_match_reference_with_drops(arch, factor):
    """Layer 0's MoE at a training capacity factor, on skewed inputs that
    overflow experts: the gradients of <y, cotangent> + aux with respect
    to the input and every expert and router weight within the gradient
    tolerance of the reference's, and a token whose every assignment was
    dropped (its output row exactly zero) gets an exactly zero input
    gradient through the experts in both packages."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    s = _setup(arch)
    cfg, tcfg = s["cfg"], s["tcfg"]
    jf = jax.tree.map(lambda a: a[0], s["jp"]["layers"]["stack"]["b0"]["ffn"])
    rng = np.random.default_rng(11)
    x = (0.5 * rng.standard_normal((2, 16, cfg.d_model))
         + rng.standard_normal((1, 1, cfg.d_model))).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx, with_aux):
        y, aux = jmoe.moe_apply(p, xx, cfg,
                                JContext(moe_capacity_factor=factor))
        return jnp.sum(y * ct) + (aux if with_aux else 0.0), y

    tf = {k: v[0].detach().requires_grad_()
          for k, v in s["tp"]["layers"]["stack"]["b0"]["ffn"].items()}
    ctx = RunContext(CPU, "torch", moe_capacity_factor=factor)
    for with_aux in (True, False):
        (_, jy), (jg, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jf, jnp.asarray(x), with_aux)
        tx = torch.from_numpy(x).requires_grad_()
        y, aux = tmoe.moe_apply(tf, tx, tcfg, ctx)
        total = (y * torch.from_numpy(ct)).sum() + (aux if with_aux else 0.0)
        names = sorted(tf)
        grads = torch.autograd.grad(total, [tf[n] for n in names] + [tx])
        _assert_grads_close(list(grads[:-1]), [jg[n] for n in names],
                            f"{arch} {factor}")
        _assert_grads_close([grads[-1]], [jgx], f"{arch} {factor} x")
    # tokens with every assignment dropped: zero output, zero gradient
    zero_rows = np.all(np.asarray(jy) == 0, axis=-1)
    assert np.array_equal(zero_rows, np.all(y.detach().numpy() == 0, axis=-1))
    if factor == 0.25:
        assert zero_rows.any()
    assert not np.asarray(jgx)[zero_rows].any()
    assert not grads[-1].numpy()[zero_rows].any()


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b",
                                  "olmoe-1b-7b"])
def test_remat_policies_give_equal_gradients(arch):
    """``remat`` none, dots and full: bitwise equal losses and gradients
    (recomputation reruns the same ops on the same inputs)."""
    s = _setup(arch)
    out = {r: _port_grads(s["tcfg"], s["tp"], _t(s["batch"]),
                          S.make_context("cpu", remat=r))
           for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert torch.equal(out[r][0], out["none"][0]), r
        for a, b in zip(out[r][2], out["none"][2]):
            assert torch.equal(a, b), r
    with pytest.raises(ValueError, match="remat"):
        S.make_context("cpu", remat="some")


def test_chunked_cross_entropy_matches_unchunked():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 16, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, (2, 16), dtype=np.int32)
    mask = (rng.random((2, 16)) < 0.3).astype(np.float32)
    lg, tg, mk = (torch.from_numpy(x) for x in (logits, targets, mask))
    for m, jmask in ((None, None), (mk, jnp.asarray(mask))):
        whole = tm.cross_entropy(lg, tg, m)
        want = jm.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                jmask)
        assert abs(float(whole) - float(want)) <= 1e-6
        for chunk in (4, 8, 5, 16):
            got = tm.cross_entropy(lg, tg, m, chunk)
            assert torch.equal(got, whole), chunk
            jgot = jm.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                    jmask, chunk)
            assert abs(float(got) - float(jgot)) <= 1e-6
    zero = torch.zeros((2, 16))
    assert float(tm.cross_entropy(lg, tg, zero)) == 0.0
    s = _setup("smollm-360m")
    a, _ = tm.forward(s["tcfg"], s["tp"], _t(s["batch"]),
                      S.make_context("cpu"), "train")
    b, _ = tm.forward(s["tcfg"], s["tp"], _t(s["batch"]),
                      S.make_context("cpu", loss_chunk=4), "train")
    assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# prefix-LM attention (paligemma) and the kernels' gradient refusal
# --------------------------------------------------------------------------- #
def test_attn_mask_prefix_matches_reference():
    q = np.arange(10)
    for causal, window, prefix in ((True, None, 0), (True, None, 4),
                                   (True, 3, 4), (False, None, 0),
                                   (False, None, 4)):
        want = jlayers.attn_mask(jnp.asarray(q), jnp.asarray(q),
                                 causal=causal, window=window,
                                 prefix_len=prefix)
        got = tlayers.attn_mask(torch.from_numpy(q), torch.from_numpy(q),
                                causal=causal, window=window,
                                prefix_len=prefix)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _positions_out(s, batch):
    """Per-position logits of the port's train-mode trunk."""
    ctx = S.make_context("cpu")
    x, pos, prefix = tm.embed_inputs(s["tcfg"], s["tp"], batch)
    rope = tlayers.rope_tables(pos, s["tcfg"].head_dim, s["tcfg"].rope_theta)
    x, _, _ = tm.apply_stack(s["tcfg"], s["tp"], x, ctx, rope, None, "train",
                             prefix, None)
    return tm.unembed(s["tcfg"], s["tp"], x)


def test_paligemma_prefix_attention_bidirectional():
    """Patch positions see later patches (prefix-LM), text stays causal:
    the reference's test on the port, plus per-position checks."""
    s = _setup("paligemma-3b")
    batch = _t(s["batch"])
    ctx = S.make_context("cpu")
    lg1, _ = tm.forward(s["tcfg"], s["tp"], batch, ctx, "prefill")
    moved = dict(batch, patches=batch["patches"].clone())
    moved["patches"][:, -1] += 10.0
    lg2, _ = tm.forward(s["tcfg"], s["tp"], moved, ctx, "prefill")
    assert float((lg1 - lg2).abs().max()) > 0
    jl1, _ = jm.forward(s["cfg"], s["jp"], _j(s["batch"]), JContext(),
                        "prefill")
    np.testing.assert_allclose(lg1.numpy(), np.asarray(jl1), atol=1e-4)
    base = _positions_out(s, batch)
    assert float((_positions_out(s, moved)[:, 0] - base[:, 0])
                 .abs().max()) > 0
    later = dict(batch, tokens=batch["tokens"].clone())
    later["tokens"][:, -1] = (later["tokens"][:, -1] + 1) \
        % s["tcfg"].vocab_size
    out = _positions_out(s, later)
    assert torch.equal(out[:, :-1], base[:, :-1])
    assert float((out[:, -1] - base[:, -1]).abs().max()) > 0


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-7b",
                                  "recurrentgemma-2b"])
def test_kernel_impl_refuses_gradients(arch):
    """``impl="cuda"`` in train mode: with grad enabled and parameters that
    require it, the kernel wrapper raises (no backward kernel in either
    package); under ``no_grad`` the loss is impl="torch"'s (the wrappers
    run their plain versions on CPU tensors)."""
    s = _setup(arch)
    batch = _t(s["batch"])
    kctx = S.make_context("cpu", impl="cuda")
    live = tm.tree_map(lambda p: p.detach().requires_grad_(), s["tp"])
    with pytest.raises(RuntimeError, match="no backward|backward kernel"):
        tm.forward(s["tcfg"], live, batch, kctx, "train")
    with torch.no_grad():
        got, _ = tm.forward(s["tcfg"], live, batch, kctx, "train")
        want, _ = tm.forward(s["tcfg"], live, batch, S.make_context("cpu"),
                             "train")
    assert abs(float(got) - float(want)) <= LOSS_TOL


# --------------------------------------------------------------------------- #
# substrate: optimizer, checkpoints, pipeline, compression (the reference's
# tests/test_substrate.py on the port)
# --------------------------------------------------------------------------- #
def test_adamw_descends_quadratic():
    cfg = OptConfig(peak_lr=0.1, warmup_steps=1, decay_steps=1000,
                    weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw.init(params)
    loss = lambda p: torch.sum(p["w"] ** 2)                  # noqa: E731
    l0 = float(loss(params))
    for _ in range(50):
        w = params["w"].detach().requires_grad_()
        g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, opt, _ = adamw.update(cfg, g, opt, params)
    assert float(loss(params)) < 0.01 * l0


def test_adamw_clips_gradients():
    cfg = OptConfig(clip_norm=1.0, warmup_steps=1)
    params = {"w": torch.zeros(3)}
    opt = adamw.init(params)
    g = {"w": torch.tensor([1e6, 0.0, 0.0])}
    _, _, m = adamw.update(cfg, g, opt, params)
    assert float(m["grad_norm"]) == pytest.approx(1e6)


def test_schedule_warmup_and_decay():
    cfg = OptConfig(peak_lr=1.0, warmup_steps=10, decay_steps=110,
                    min_lr_ratio=0.1)
    def lr(k):
        return float(adamw.schedule(cfg, torch.tensor(k, dtype=torch.int32)))

    assert lr(5) == pytest.approx(0.5)
    assert lr(10) == pytest.approx(1.0)
    assert lr(110) == pytest.approx(0.1)
    jcfg = jadamw.OptConfig(peak_lr=1.0, warmup_steps=10, decay_steps=110,
                            min_lr_ratio=0.1)
    for k in (0, 1, 9, 10, 11, 60, 109, 110, 500):
        assert lr(k) == pytest.approx(
            float(jadamw.schedule(jcfg, jnp.int32(k))), rel=1e-6, abs=1e-9)


def test_checkpoint_roundtrip_and_prune(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(5),
            "b": {"c": torch.ones((2, 3)),
                  "h": torch.ones(4, dtype=torch.bfloat16)}}
    for step in (10, 20, 30, 40):
        ckpt.save(d, step, tree, keep=2)
    assert ckpt.latest_step(d) == 40
    files = [f for f in os.listdir(d) if f.endswith(".npz")]
    assert len(files) == 2                       # pruned to keep=2
    step, restored = ckpt.restore(d, tree)
    assert step == 40
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(5))
    assert restored["b"]["h"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["h"], tree["b"]["h"])


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"a": torch.ones(3)})
    with pytest.raises(ValueError):
        ckpt.restore(d, {"a": torch.ones(4)})
    with pytest.raises(ValueError):
        ckpt.restore(d, {"a": torch.ones(3), "b": torch.ones(1)})


def test_checkpoint_async(tmp_path):
    d = str(tmp_path)
    t = ckpt.save_async(d, 5, {"x": torch.ones(2)})
    t.join(timeout=10)
    assert not t.is_alive()
    assert ckpt.latest_step(d) == 5


def _bf16_state(arch="smollm-360m"):
    """A reduced model in bfloat16 with its optimizer state, in both
    packages (the same weights)."""
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="bfloat16")
    tcfg = dataclasses.replace(t_reduced_config(t_get_config(arch)),
                               dtype="bfloat16")
    jp = jm.init(cfg, jax.random.PRNGKey(5))
    jstate = {"params": jp, "opt": jadamw.init(jp)}
    jstate["opt"]["step"] = jnp.int32(7)
    tp = weights.from_jax(jax.tree.map(np.asarray, jp), tcfg)
    tstate = {"params": tp, "opt": adamw.init(tp)}
    return jstate, tstate


def _same_state(tstate, jstate):
    got, want = tm._tree_leaves(tstate), jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_reference_checkpoint_restores_into_port(tmp_path):
    jstate, tstate = _bf16_state()
    jckpt.save(str(tmp_path), 7, jstate)
    step, restored = ckpt.restore(str(tmp_path), tstate)
    assert step == 7
    _same_state(restored, jstate)
    assert int(restored["opt"]["step"]) == 7


def test_port_checkpoint_restores_into_reference(tmp_path):
    jstate, tstate = _bf16_state()
    tstate["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    ckpt.save(str(tmp_path), 7, tstate)
    with open(tmp_path / "ckpt_00000007.json") as f:
        manifest = __import__("json").load(f)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert manifest["names"] == names
    step, restored = jckpt.restore(str(tmp_path), jstate)
    assert step == 7
    _same_state(tstate, restored)


def test_pipeline_deterministic_and_resumable():
    cfg = t_reduced_config(t_get_config("smollm-360m"))
    p1 = Pipeline(cfg, DataConfig(4, 16, seed=7))
    p2 = Pipeline(cfg, DataConfig(4, 16, seed=7))
    b1, b2 = p1.batch(123), p2.batch(123)
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = p1.batch(124)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    b4 = Pipeline(cfg, DataConfig(4, 16, seed=8)).batch(123)
    assert not torch.equal(b1["tokens"], b4["tokens"])


def test_pipeline_targets_shifted():
    cfg = t_reduced_config(t_get_config("smollm-360m"))
    b = Pipeline(cfg, DataConfig(2, 8)).batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])


@pytest.mark.parametrize("arch", ["smollm-360m", "hubert-xlarge",
                                  "paligemma-3b"])
def test_pipeline_layout_matches_reference(arch):
    """The same keys, shapes and dtypes as the reference pipeline's batch
    (values differ: another generator)."""
    want = JPipeline(reduced_config(get_config(arch)),
                     JDataConfig(4, 16)).batch(3)
    got = Pipeline(t_reduced_config(t_get_config(arch)),
                   DataConfig(4, 16)).batch(3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    if "loss_mask" in got:
        assert set(got["loss_mask"].unique().tolist()) <= {0.0, 1.0}


def test_error_feedback_unbiased_over_steps():
    """EF residual keeps the cumulative quantized sum close to the true
    sum."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    residual = init_error_feedback({"g": g_true})["g"]
    assert residual.dtype == torch.float32 and not residual.any()
    acc = np.zeros(64)
    for _ in range(50):
        v = g_true + residual
        q, s = quantize_int8(v)
        deq = dequantize_int8(q, s)
        residual = v - deq
        acc += deq.numpy()
    np.testing.assert_allclose(acc / 50, g_true.numpy(), atol=1e-2)


# --------------------------------------------------------------------------- #
# the fleet trainer and the CLI (the reference's tests/test_system.py)
# --------------------------------------------------------------------------- #
def test_fleet_trainer_restart_from_fault(tmp_path):
    cfg = t_reduced_config(t_get_config("smollm-360m"))
    trainer = FleetTrainer(
        cfg, steps_total=8, data_cfg=DataConfig(2, 16),
        ckpt_dir=str(tmp_path), ckpt_every=2,
        fault_plan=FaultPlan(fail_every=5), device="cpu")
    state = trainer.run()
    assert trainer.report.steps_done == 8
    assert trainer.report.restarts >= 1        # hit the fault + recovered
    assert int(state["opt"]["step"]) == 8
    # the fault restores the step-4 checkpoint: the run takes the same
    # steps as one without faults
    clean = FleetTrainer(cfg, steps_total=8, data_cfg=DataConfig(2, 16),
                         device="cpu")
    clean.run()
    assert trainer.report.losses == clean.report.losses


def test_fleet_trainer_resumes_from_checkpoint(tmp_path):
    cfg = t_reduced_config(t_get_config("smollm-360m"))
    t1 = FleetTrainer(cfg, steps_total=4, data_cfg=DataConfig(2, 16),
                      ckpt_dir=str(tmp_path), ckpt_every=2, device="cpu")
    s1 = t1.run()
    t2 = FleetTrainer(cfg, steps_total=8, data_cfg=DataConfig(2, 16),
                      ckpt_dir=str(tmp_path), ckpt_every=2, device="cpu")
    s2 = t2.run()
    assert t2.report.restarts == 1             # restored, not from scratch
    assert t2.report.steps_done == 4           # only the remaining steps
    assert int(s2["opt"]["step"]) == 8
    # the resumed first step is the step an uninterrupted run takes
    _, m = t1.step_fn(s1, t1.batch(4))
    assert float(m["loss"]) == t2.report.losses[0]


def test_fleet_trainer_elastic_resize_and_refusals(tmp_path):
    cfg = t_reduced_config(t_get_config("smollm-360m"))
    t = FleetTrainer(cfg, steps_total=2, data_cfg=DataConfig(2, 16),
                     elastic_schedule={1: 2}, device="cpu")
    t.run()
    assert t.report.resizes == 1 and t.report.provision_seconds > 0
    # with no mesh (no data axis to reduce over) compression is off, as in
    # the reference: the same losses as an uncompressed trainer
    tc = FleetTrainer(cfg, steps_total=2, data_cfg=DataConfig(2, 16),
                      grad_compression=True, device="cpu")
    plain = FleetTrainer(cfg, steps_total=2, data_cfg=DataConfig(2, 16),
                         device="cpu")
    sc = tc.run()
    plain.run()
    assert not tc._compressed and "ef" not in sc
    assert tc.report.losses == plain.report.losses
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FleetTrainer(cfg, steps_total=2, data_cfg=DataConfig(2, 16))


def test_training_loss_decreases():
    cfg = t_reduced_config(t_get_config("smollm-360m"))
    step = S.build_train_step(
        cfg, OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=100),
        S.make_context("cpu"))
    params = tm.init(cfg, torch.Generator().manual_seed(0), CPU)
    state = {"params": params, "opt": adamw.init(params)}
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_train_cli_on_cpu(capsys):
    main(["--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
          "--arch", "paligemma-3b", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "step     1" in out and "done" in out and "device=cpu" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--steps", "1"])


def test_run_context_training_fields():
    ctx = S.make_context("cpu")
    assert (ctx.impl, ctx.remat, ctx.loss_chunk, ctx.microbatches,
            ctx.moe_capacity_factor) == ("torch", "full", 0, 1, 1.25)
    j = JContext()
    assert (j.remat, j.loss_chunk, j.microbatches,
            j.moe_capacity_factor) == (ctx.remat, ctx.loss_chunk,
                                       ctx.microbatches,
                                       ctx.moe_capacity_factor)
    assert RunContext(CPU, "torch").remat == "full"
