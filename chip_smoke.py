#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with nvcc (sm_90a), holds each against its plain PyTorch version, and
drives the port's serving paths at full width through
``ClientHandler`` on ``LMBackend`` with random weights from seed 0:
smollm-360m (32 layers, d_model 960, 15/5 heads, vocab 49152) and
qwen2.5-3b (36 layers, d_model 2048, 16/2 heads of 128, QKV bias, tied
embedding, vocab 151936; 3.09e9 parameters) on the paged path; rwkv6-7b (32 layers, d_model 4096, 64 WKV heads of 64, d_ff 14336,
vocab 65536; 7.53e9 parameters) and recurrentgemma-2b (26 layers: 18
RG-LRU, 8 local attention with window 2048, 10 query heads over 1 KV head
of 256; d_model 2560, d_ff 7680, vocab 256000; 2.89e9 parameters) on the
contiguous cohort path; olmoe-1b-7b (16 layers, d_model 2048, 16/16
heads of 128, 64 experts top-8 of d_ff 1024; 6.92e9 parameters) on the
paged path and mixtral-8x7b (d_model 4096, 32/8 heads of 128, window 4096,
8 experts top-2 of d_ff 14336) on the cohort path at 8 of its 32 layers;
for each it checks the float32 token streams of the kernel path against
the plain path.  Then it trains: smollm-360m whole through
``FleetTrainer`` (faults, checkpoints, a resume), float32 train steps on
the card against the host, the train-mode loss through the three
sequence kernels against the plain path, and the two modality frontends,
hubert-xlarge (48 layers, d_model 1280, audio stub, masked loss) and
paligemma-3b (18 layers, d_model 2048, vocab 257216, vision stub,
prefix-LM).  Phases:

1. device   — a CUDA device must be present; prints name and power limit;
2. build    — one nvcc per kernel source, all started together;
3. kernels  — each kernel vs its plain version at the serving shapes, in
              float32 (atol 2e-5, rtol 1e-5; TF32 off) and bfloat16 (atol
              2e-2, rtol 2e-2), with edge cases (zero-context row,
              n_live == 0 row, scattered tables, softcap, sliding window,
              per-head decode grid; WKV: s0 None, one step, ragged S, N
              16, 8 and 37, and the long shape B 8, S 2048; RG-LRU: the
              cohort-prefill shape B 8, S 2048, R 2560 with and without
              h0, one step, ragged S, R 96, float32 and bfloat16 outputs,
              final state within 1e-5; flash at
              recurrentgemma's shape, D 256, MQA 10:1, window 2048; the
              bf16 tensor-core flash kernel at every head dim it is built
              for (64, 80, 96, 128, 256) with GQA groups of 1, 3 and 10,
              ragged S, windows, softcap, non-causal, B 1 and S 1, and a
              head dim it refuses; paged decode over D 16/64/128/256,
              GQA groups 1/3/8, block 8 and 16, contexts 0, 1, bs, bs+1
              and the full table, both grids, softcap, and out-of-pool
              table ids past the context; paged decode at a long context:
              qwen2.5-3b's heads, 8 slots near 8192 tokens, block 16;
              paged prefill over an edge sweep (D 16-256, every built
              bf16 head dim, g 1/3/8, bs 8/16, C 1/8/16/64, pos0
              0/bs-1/300/3000, n_live 0/1/partial/C, softcap, out-of-pool
              ids past each slot's reach, dead rows exact zeros) and at 8
              slots near 8192 tokens with C 8, at qwen2.5-3b's heads (D
              128, bs 16) and smollm-360m's (D 64, bs 8), the deep slots
              and long shapes also within 5% of the output's RMS; the
              sweep also takes the verify chunks C 2, 3 and 5 with two
              windows ending at the table's capacity, and paged prefill is
              timed at the verify shape: 8 slots of smollm-360m's heads,
              C 5, ragged n_live with a dead row, contexts 16-110);
              CUDA-event times of kernel, plain version and, where one
              exists, one PyTorch library call (every kernel also
              replayed from a CUDA graph, which leaves out the host's
              launch path; the WKV scan also at its long shape); the
              three attention kernels also at olmoe-1b-7b's serving
              shapes (16/16 heads of 128, GQA group 1), compared and
              timed;
4. serving  — smollm-360m: 8 requests (prompts 16–96 tokens, two pairs
              sharing a 32-token prefix, 16 new tokens each) through the
              default paged handler path in bfloat16, decode_window 4;
              every request must finish its budget and every kernel of the
              path must have launched;
5. parity   — the same trace in float32 with impl="cuda" and impl="torch"
              on the same weights: token streams must be identical (a first
              mismatch is accepted only as a near-tie, top-two logit gap of
              the plain path < 1e-4);
6. rwkv6    — rwkv6-7b: 8 requests (prompts 16–64 tokens, padded to 64,
              16 new tokens each) through ``kv="contiguous"`` in bfloat16,
              each step run once and timed after a device synchronise;
              every request must finish its budget and the WKV kernel must
              have launched (32 layers per cohort prefill);
7. parity   — the same trace in float32 with impl="cuda" and impl="torch"
              on the same weights, under phase 5's near-tie rule, over the
              first 16 of the 32 layers at full width (at 32 layers two
              plain evaluation orders already disagree; see
              tools/rwkv6_parity_depth.py);
8. hybrid   — recurrentgemma-2b: 8 requests (prompts 1024-2048 tokens,
              padded to the 2048-token window, 16 new tokens each) through
              ``kv="contiguous"`` in bfloat16, each step run once and
              timed: one cohort prefill (18 rglru_scan and 8
              flash_attention launches, asserted) fills the attention
              ring, and 15 decode steps at positions 2048-2062 wrap it
              (asserted);
9. parity   — the same trace in float32 with impl="cuda" and impl="torch"
              on the same weights, under phase 5's near-tie rule, at all
              26 layers (tools/rglru_parity_depth.py sweeps the depth);
10. qwen    — qwen2.5-3b: phase 4's trace and paged settings in bfloat16
              (capacity 256, block 8, chunk 8, decode window 4), checked
              as phase 4 is; its paged prefill runs C 8 x g 8 = 64 query
              rows per kv-head at D 128;
11. parity  — the same trace in float32 with impl="cuda" and impl="torch"
              on the same weights, under phase 5's near-tie rule, at
              QWEN_PARITY_LAYERS of the 36 layers;
12. spec    — smollm-360m: phase 4's trace and paged settings in bfloat16
              with speculative=True, spec_k 4 (mixed dispatch off), once
              with the target as its own draft and once with the
              full-vocab reduced draft (2 layers, head_dim 16), each step
              closure run once and timed on a fixed timeline: every request
              finishes, a draft clone pairs, paged_prefill launches in the
              verify rounds (C = k + 1) and paged_decode in the draft
              rounds, and the oracle emits more than 1.5 tokens per round;
13. parity  — speculative streams in float32 with impl="cuda" (both
              drafts) held to the plain non-speculative impl="torch"
              streams on the same weights, under phase 5's near-tie rule;
14. disagg  — smollm-360m in bfloat16, prompts prefilled on a "large"
              partner clone (chunked paged prefill) and handed to the
              "basic" decode clone's pool, once as bf16 blocks and once
              through the int8 pair: every request finishes, handoffs
              happen, and the int8 run bills exactly the int8 block bytes
              for the same handoffs;
15. parity  — uncompressed disagg streams in float32 with impl="cuda" held
              to the co-located impl="torch" streams under phase 5's
              near-tie rule; the int8 handoff finishes every request at
              under half the float32 wire bytes;
16. chaos   — smollm-360m in bfloat16, phase 4's trace and paged settings
              on the chaos fleet (6 slots per engine, 3 secondaries, one
              spare RUNNING clone, hedge_min_samples 4, NVLink clone
              link), each closure run once on a fixed timeline: faultless,
              then a drain, a kill (both for 2 s) and a permanent kill of
              the primary at half the makespan, and a 40x slowdown of it
              at 0.6 of the makespan with hedge_factor 2.  Every request
              finishes, every surviving pool's blocks add up, the drain
              migrates slots (the exactly equal migrated streams are
              counted), the kills restore and do not migrate, the hedge
              fires and wins, paged_decode and paged_prefill launch in
              the recovery runs, and every stream is held to the
              faultless one under the near-tie rule (in bfloat16 the
              bound is twice the plain path's logit error against
              float32 at that step).  Then a gated run: an interactive
              tenant with a 5 s deadline, a batch tenant and an exact
              repeat of a served prompt, which comes back from the
              gateway's cache; prints slo_attainment and goodput_tps;
17. parity  — the drain, kill and hedged runs in float32 with impl="cuda"
              held to the faultless impl="torch" streams under phase 5's
              near-tie rule;
18. offload — smollm-360m in bfloat16 through the batch ``ServingEngine``
              (the ExecutionController on the card; capacity 256): 8
              requests of 12-96 prompt tokens, 16 new tokens each, served
              forced local, forced remote, remote over 2 clones (split
              prefill) and unforced under Policy.EXEC_TIME.  Every request
              finishes its budget, every prefill call launches
              flash_attention once per layer, every Venue timing is
              positive and synchronised on the card, and ``offloaded``
              counts the prefill and every decode step; then one engine
              at capacity 512, whose bf16 cache (about 168 MB) is past the
              clone types' 100 MiB heap, escalates 4 times (main ->
              x8large).  Then a ``@remote`` workload on the card under a
              controller on wifi-local, 3g and nvlink: local and remote
              virtual-clock time and energy, and the boundary input value
              of each link (3G's at least WiFi's);
19. parity  — phase 18's four placements in float32 with impl="cuda" held
              to impl="torch" on the same weights, and every placement
              held to the local one, under phase 5's near-tie rule (the
              float32 cache at capacity 256 also escalates 4 times);
20. olmoe   — olmoe-1b-7b: phase 4's trace and paged settings in bfloat16,
              checked as phase 4 is (weight bytes, wall, tokens per
              second and launches logged);
21. parity  — the same trace in float32 with impl="cuda" and impl="torch"
              on the same weights at OLMOE_PARITY_LAYERS layers, under
              phase 5's near-tie rule extended to routing: a first
              mismatch also passes when the two runs' first routing
              divergence (a row routed to another top-k set) is a
              near-tie, the plain path's k-th minus (k+1)-th router
              probability at every parted row under twice the largest
              probability drift of the runs up to that call, the drift
              under ROUTE_DRIFT_MAX;
22. mixtral — mixtral-8x7b at full width on MIXTRAL_LAYERS of its 32
              layers (drawn at that depth) in bfloat16: 8 requests of
              16-96 tokens, padded to 96, 16 new tokens each, through
              ``kv="contiguous"`` (the 4096-token window keeps it off the
              paged pool), each step run once and timed; every request
              finishes and the cohort prefill launches flash once per
              layer (asserted); then float32 parity as phase 21's on
              MIXTRAL_PARITY_LAYERS layers;
23. train   — smollm-360m at full width and depth in bfloat16 through
              ``FleetTrainer`` (impl="torch", full recomputation, AdamW
              with float32 moments): TRAIN_STEPS steps of TRAIN_BATCH x
              TRAIN_SEQ tokens, a checkpoint every TRAIN_CKPT_EVERY steps,
              ``FaultPlan(fail_every=TRAIN_FAIL_EVERY)``: at least one
              restart, every step done, all losses finite, every
              parameter leaf moved, ``opt["step"]`` right; then a second
              trainer over the same directory resumes and runs only
              TRAIN_RESUME_STEPS more, its first loss within RESUME_RTOL of
              the saved state's forward on that batch; prints losses, the
              median step time and peak memory;
24. train parity — float32, TF32 off: (a) smollm-360m at full width on
              TRAIN_PARITY_LAYERS layers, TRAIN_PARITY_STEPS train steps on
              the card and on the host from the same weights and batches,
              losses and grad norms within TRAIN_PARITY_RTOL; (b) the
              train-mode loss at impl="cuda" against impl="torch" under
              ``no_grad`` for smollm-360m (32 layers), rwkv6-7b
              (KERNEL_TRAIN_RWKV_LAYERS layers) and recurrentgemma-2b (26
              layers) at full width, within KERNEL_LOSS_TOL, with one
              flash_attention, rwkv6_scan or rglru_scan launch per layer of
              its kind (asserted); (c) impl="cuda" with grad enabled
              raises;
25. frontends — hubert-xlarge (batch 4 x 256 frames, about 8% of them in
              the loss mask) and paligemma-3b (batch 2, 256 patches + 64
              text tokens) at full width and depth in bfloat16 with
              float32 optimizer state, FRONTEND_STEPS train steps each
              (losses finite, step times and peak memory printed), one
              paligemma forward(mode="prefill") with patches; then
              paligemma in float32 on 2 layers: moving the last patch
              changes the first patch's logits (the prefix sees itself
              both ways), moving the last text token changes no earlier
              position;
26. mesh    — on a one-rank NCCL group (an in-process store) and
              ``make_local_mesh()``: (a) smollm-360m at full width and
              depth in bfloat16, one train step through the mesh path
              (DTensor state on the ``tp`` profile) against the mesh-free
              step on copies of the same state and batch (MESH_BATCH x
              MESH_SEQ), losses, grad norms and step times printed; then in
              float32 on MESH_PARITY_LAYERS layers, loss and grad norm
              within MESH_RTOL; (b) olmoe-1b-7b at full width and depth in
              bfloat16: prefill logits on the ``serve`` profile (the
              d_model-sliced expert contraction) and the train-mode loss
              without a gradient on ``tp`` (the expert-parallel body with
              FSDP gathers) against the mesh-free path, printed; in
              float32 on MESH_PARITY_LAYERS layers within MESH_RTOL; (c)
              ``compressed_psum`` over the one-rank data group on every
              gradient leaf of (a) against the int8 formula written out
              (one data rank: no collective runs; tools/mesh_nccl_check.py
              runs the compressed mean over NCCL on 4 cards), and
              ``FleetTrainer(mesh=..., grad_compression=True)`` for
              MESH_FLEET_STEPS steps (one data rank: uncompressed, as the
              reference); (d) ``hlo_analysis.cost_metrics`` of (a)'s step
              on the card against the same step traced on fake tensors
              under a fake one-rank group: FLOPs equal exactly; the traced
              peak beside ``torch.cuda.max_memory_allocated``;
27. dryrun  — on the host, one subprocess per cell, all started together:
              ``python -m repro_torch.launch.dryrun`` for DRYRUN_CELLS (a
              fake group of 256 or 512 ranks, fake tensors); each record
              read back: status ok, and the k = 1 / k = 2 extrapolation
              equal to the full-depth FLOPs, bytes and collective bytes;
              then the roofline table against H100 constants (estimates
              from counting, not measurements).

Prints, before the last line, one ``{"kernels": [...]}`` line; the last line
is ``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_HBM_BW = 3.35e12            # B/s
H100_PEAK = {"float32": 67e12, "bfloat16": 989e12}   # FLOP/s, dense
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2e-2),
       "state": (1e-5, 0.0)}
# over thousands of keys an attention output has an RMS near TOL's atol
# (about sqrt(e / keys) for standard-normal inputs), and one misread 64-key
# tile moves an element by about sqrt(2 * 64 / keys) of that RMS: deep
# contexts are also held to a max abs error of this share of the RMS
RMS_SHARE = 0.05
DEEP_POS0 = 3000                 # the prefill sweep's deep slots
CAPACITY = 256
PROMPT_PAD = 96
MAX_BATCH = 8
NEW_TOKENS = 16
BLOCK = 8
CHUNK = 8
RWKV_PROMPT_PAD = 64             # the plain WKV path needs S % 64 == 0
WKV_LONG_S = 2048                # phase 3's long WKV shape: 8 x 2048 tokens
RWKV_CAPACITY = RWKV_PROMPT_PAD + NEW_TOKENS
# phase 7 holds tokens to the near-tie rule over the first 16 of the 32
# layers: at all 32, this random-weight model turns float32 rounding into
# different tokens whichever code makes it, and two plain evaluation
# orders already disagree (tools/rwkv6_parity_depth.py)
RWKV_PARITY_LAYERS = 16
RG_PROMPT_PAD = 2048             # the window: the prefill fills the ring
# phase 11 holds qwen2.5-3b's float32 tokens to the near-tie rule at this
# depth (all 36 layers)
QWEN_PARITY_LAYERS = 36
RG_CAPACITY = RG_PROMPT_PAD + NEW_TOKENS
# phase 3's long decode shape: 8 slots near an 8192-token context
LONG_CTX = (8192, 8097, 8065, 8146, 8171, 8086, 8128, 8184)
# speculative phases: K draft tokens per round (verify chunk C = K + 1) and
# the paged-prefill sweep's verify chunks
VERIFY_K = 4
VERIFY_CHUNKS = (2, 3, 5)
REPLACES = {
    "paged_decode": "src/repro/kernels/flash_attention.py:337",
    "paged_prefill": "src/repro/kernels/flash_attention.py:264",
    "flash_attention": "src/repro/kernels/flash_attention.py:362",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:66",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:61",
}
PHASES = 27
# phase 18: the ServingEngine placements and the escalation engine's
# capacity (its bf16 cache is past the clone types' 100 MiB heap)
PLACEMENTS = {"local": dict(force="local"), "remote": dict(force="remote"),
              "split": dict(force="remote", n_clones=2), "policy": {}}
ESCALATE_CAPACITY = 512
# phases 20-22: olmoe-1b-7b is served whole; mixtral-8x7b (46.7e9
# parameters, 93 GB in bf16) at full width on its first MIXTRAL_LAYERS of
# 32 layers (about 23.7 GB), its float32 parity on MIXTRAL_PARITY_LAYERS
# (about 24.3 GB); olmoe's float32 parity holds at OLMOE_PARITY_LAYERS
OLMOE_PARITY_LAYERS = 16
MIXTRAL_LAYERS = 8
MIXTRAL_PARITY_LAYERS = 4
MIXTRAL_CAPACITY = PROMPT_PAD + NEW_TOKENS
# the routing near-tie rule (hold_to_plain): a router row of the two
# float32 runs is comparable when its inputs differ by float32 rounding
# only (relative max difference under ROUTE_INPUT_MAX: dead and pad rows,
# whose garbage inputs the two paths leave unequal by design, are not);
# before the runs route a comparable row apart, their router probabilities
# may drift by rounding only, and a drift past ROUTE_DRIFT_MAX means the
# paths disagree for another reason, so no swap is accepted
ROUTE_INPUT_MAX = 1e-3
ROUTE_DRIFT_MAX = 1e-3
# phase 23: smollm-360m trained whole in bf16 through FleetTrainer; the
# resumed trainer's first loss is held to the saved state's forward within
# RESUME_RTOL (a tolerance, not deterministic algorithms: the embedding's
# backward accumulates with atomics, the forward has none)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 8
TRAIN_CKPT_EVERY, TRAIN_FAIL_EVERY, TRAIN_RESUME_STEPS = 2, 5, 4
TRAIN_WARMUP = 2                 # AdamW reaches its 3e-4 peak at step 2
RESUME_RTOL = 1e-5
# phase 24: (a) float32 train steps card vs host on TRAIN_PARITY_LAYERS of
# smollm-360m's 32 layers at (batch, seq) TRAIN_PARITY_SHAPE, losses and
# grad norms within TRAIN_PARITY_RTOL; (b) the train loss through the
# kernels vs the plain path within KERNEL_LOSS_TOL (rwkv6-7b on
# KERNEL_TRAIN_RWKV_LAYERS of 32 layers, the others whole)
TRAIN_PARITY_LAYERS, TRAIN_PARITY_STEPS = 4, 3
TRAIN_PARITY_SHAPE = (2, 64)
TRAIN_PARITY_RTOL = 1e-4
KERNEL_TRAIN_SHAPE = (2, 256)
KERNEL_TRAIN_RWKV_LAYERS = 8
KERNEL_LOSS_TOL = 1e-4
# phase 25: (batch, seq) of hubert-xlarge (frames) and paligemma-3b (256
# patches + 64 text tokens), FRONTEND_STEPS train steps each
FRONTEND_STEPS = 3
HUBERT_SHAPE = (4, 256)
PALIGEMMA_SHAPE = (2, 320)
# phase 26: the mesh path on one card (a 1 x 1 mesh)
MESH_BATCH, MESH_SEQ = 8, 256
MESH_PARITY_LAYERS = 4
MESH_RTOL = 1e-5
MESH_MOE_SHAPE = (4, 128)
MESH_FLEET_STEPS = 4
# phase 27: where the dry-run records go, and its (arch, shape,
# multi-pod) cells
DRYRUN_DIR = ROOT / "benchmarks" / "results" / "dryrun_torch"
DRYRUN_CELLS = (("smollm-360m", "train_4k", False),
                ("qwen2.5-3b", "prefill_32k", False),
                ("olmoe-1b-7b", "decode_32k", True),
                ("rwkv6-7b", "long_500k", False))


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# phase 3: kernels vs plain versions
# --------------------------------------------------------------------------- #
def paged_inputs(torch, rng, b, hkv, d, lens, dtype, dev, extra=4,
                 bs=BLOCK, m=CAPACITY // BLOCK):
    """Pool of block size ``bs`` + scattered, shuffled (b, m) tables
    covering ``lens`` tokens per row."""
    import numpy as np
    spans = [max(-(-ln // bs), 1) for ln in lens]
    n = sum(spans) + 1 + extra
    ids = rng.permutation(np.arange(1, n))
    tables = np.zeros((b, m), np.int32)
    nxt = 0
    for i, sp in enumerate(spans):
        tables[i, :sp] = ids[nxt:nxt + sp]
        nxt += sp
    mk = lambda *s: torch.from_numpy(                      # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    return (mk(n, bs, hkv, d), mk(n, bs, hkv, d),
            torch.from_numpy(tables).to(dev), mk)


def paged_decode_cost(q, lens, hkv, d, bs, item):
    """Bytes and flops of one decode call: q read and out written, each
    live key and value read once per kv-head, the table entries j <
    ceil(ctx / bs) and the lengths read."""
    ctx_tok = sum(lens)
    entries = sum(-(-ln // bs) for ln in lens)
    byts = (2 * q.numel() * item + 2 * ctx_tok * hkv * d * item
            + entries * 4 + len(lens) * 4)
    return byts, 4 * q.shape[2] * d * ctx_tok


def paged_prefill_cost(q, p0, nl, hkv, bs, item):
    """Bytes and flops of one chunked-prefill call: q read and out written,
    each key and value at positions < pos0 + n_live read once per kv-head,
    the table entries j < ceil((pos0 + n_live) / bs) and pos0, n_live read;
    4 * D flops per (live row, admitted key) and q-head."""
    d, hq = q.shape[3], q.shape[2]
    ends = [int(p) + int(n) if n > 0 else 0 for p, n in zip(p0, nl)]
    entries = sum(-(-e // bs) for e in ends)
    byts = (2 * q.numel() * item + 2 * sum(ends) * hkv * d * item
            + entries * 4 + 4 * 2 * len(ends))
    flops = sum(4 * hq * d * (int(p) + c + 1)
                for p, n in zip(p0, nl) for c in range(int(n)))
    return byts, flops


def compare(torch, name, got, want, dtype_name, quiet=False):
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(((g - w).abs() <= atol + rtol * w.abs()).all())
    if not bool(torch.isfinite(g).all()):
        ok = False
    if not quiet or not ok:
        log(f"  {name:16s} {dtype_name:8s} max_abs_err={err:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} ({dtype_name}) disagrees with its plain version "
             f"(max abs err {err}, atol {atol}, rtol {rtol})")
    return err


def compare_rms(name, got, want):
    """Fails unless max |got - want| <= RMS_SHARE * RMS(want); returns
    that error over the RMS."""
    g, w = got.float(), want.float()
    rms = float(w.pow(2).mean().sqrt())
    err = float((g - w).abs().max())
    if not err <= RMS_SHARE * rms:
        fail(f"{name}: max abs err {err} exceeds {RMS_SHARE} of the "
             f"output's RMS {rms}")
    return err / rms


def time_ms(torch, fn, reps=50, host=None):
    """CUDA-event time per call over ``reps`` back-to-back calls; when
    ``host`` is a dict, also the host's enqueue time per call (no sync
    inside the loop) under ``host["ms"]`` — equal times mean the launch
    path, not the device, sets the pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if host is not None:
        host["ms"] = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps=50):
    """CUDA-event time per call of ``fn`` replayed from one CUDA graph of
    ``reps`` calls: the device's time without the host's launch path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(torch, dev, cfg):
    import numpy as np
    from repro_torch.kernels import ops, ref
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)
    main_err = {}
    results = {}
    host = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        # -------- paged decode: zero-context row, scattered tables,
        # softcap, both grids; the serving batch is MAX_BATCH slots
        lens = [0, 1, 17, 64, 97, 104, 112, 200]
        kp, vp, tables, mk = paged_inputs(torch, rng, MAX_BATCH, hkv, d,
                                          lens, dtype, dev)
        cls = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = mk(MAX_BATCH, 1, hq, d)
        for fused in (True, False):
            for softcap in (None, 30.0):
                got = ops.paged_attention(q, kp, vp, tables, cls,
                                          softcap=softcap, fused=fused)
                want = ref.paged_attention_ref(q[:, 0], kp, vp, tables, cls,
                                               softcap=softcap)[:, None]
                e = compare(torch, "paged_decode", got, want, dtype_name)
                if float(got[0].abs().max()) != 0.0:
                    fail("paged_decode: zero-context row is not exact zeros")
                if fused and softcap is None:
                    main_err[("paged_decode", dtype_name)] = e
        # -------- paged prefill: n_live == 0 row, partial rows, softcap
        p0 = np.array([0, 36, 32, 120, 5, 64, 88, 40], np.int32)
        nl = np.array([8, 8, 0, 3, 8, 1, 8, 8], np.int32)
        kp, vp, tables, mk = paged_inputs(torch, rng, 8, hkv, d, p0 + CHUNK,
                                          dtype, dev)
        q = mk(8, CHUNK, hq, d)
        tp0 = torch.from_numpy(p0).to(dev)
        tnl = torch.from_numpy(nl).to(dev)
        for softcap in (None, 30.0):
            got = ops.paged_prefill(q, kp, vp, tables, tp0, tnl,
                                    softcap=softcap)
            want = ref.paged_prefill_ref(q.transpose(1, 2), kp, vp, tables,
                                         tp0, tnl,
                                         softcap=softcap).transpose(1, 2)
            e = compare(torch, "paged_prefill", got, want, dtype_name)
            if float(got[2].abs().max()) != 0.0 or \
                    float(got[3, 3:].abs().max()) != 0.0:
                fail("paged_prefill: dead rows are not exact zeros")
            if softcap is None:
                main_err[("paged_prefill", dtype_name)] = e
        # -------- flash attention: S 96 (serving), 128, 256, ragged 100;
        # sliding window and softcap
        for s, window, softcap in ((PROMPT_PAD, None, None),
                                   (128, None, None), (256, None, None),
                                   (100, 32, None), (128, None, 30.0)):
            b = MAX_BATCH if s == PROMPT_PAD else 2
            q, k, v = mk(b, s, hq, d), mk(b, s, hkv, d), mk(b, s, hkv, d)
            got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
            want = ref.flash_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                window=window, softcap=softcap).transpose(1, 2)
            e = compare(torch, "flash_attention", got, want, dtype_name)
            if s == PROMPT_PAD:
                main_err[("flash_attention", dtype_name)] = e

    # -------- timings at the serving shapes, in the serving dtype (bf16)
    results.update(serving_shape_rows(torch, dev, hq, hkv, d, rng, host))
    finish(results, host, main_err)
    return results


def serving_shape_rows(torch, dev, hq, hkv, d, rng, host, suffix=""):
    """bf16 CUDA-event, host-enqueue and graph-replayed times, plain and
    library times, bytes and flops of the three attention kernels at a
    model's serving shapes (``hq`` / ``hkv`` heads of ``d``): paged decode
    over MAX_BATCH slots of 97-110 tokens, paged prefill of two slots' C 8
    chunks at pos0 36 and 32, flash over MAX_BATCH x PROMPT_PAD tokens
    (causal; SDPA beside it).  Keys are the kernel names + ``suffix``."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dtype = torch.bfloat16
    item = 2
    peak = H100_PEAK["bfloat16"]
    results = {}
    lens = [97, 100, 104, 108, 101, 103, 106, 110]
    kp, vp, tables, mk = paged_inputs(torch, rng, MAX_BATCH, hkv, d, lens,
                                      dtype, dev)
    cls = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = mk(MAX_BATCH, 1, hq, d)
    byts, flops = paged_decode_cost(q, lens, hkv, d, BLOCK, item)
    decode = lambda: ops.paged_attention(q, kp, vp, tables, cls)  # noqa
    name = "paged_decode" + suffix
    results[name] = dict(
        ms=time_ms(torch, decode, host=host.setdefault(name, {})),
        plain_ms=time_ms(torch, lambda: ref.paged_attention_ref(
            q[:, 0], kp, vp, tables, cls)),
        bytes=byts, flops=flops, library_ms=None,
        graph_ms=graph_ms(torch, decode))
    results[name]["plan"] = launch_plan(ops, "paged_decode")
    p0 = np.array([36, 32], np.int32)
    nl = np.array([8, 8], np.int32)
    kp, vp, tables, mk = paged_inputs(torch, rng, 2, hkv, d, p0 + CHUNK,
                                      dtype, dev)
    q = mk(2, CHUNK, hq, d)
    tp0 = torch.from_numpy(p0).to(dev)
    tnl = torch.from_numpy(nl).to(dev)
    byts, flops = paged_prefill_cost(q, p0, nl, hkv, BLOCK, item)
    prefill = lambda: ops.paged_prefill(q, kp, vp, tables, tp0,  # noqa
                                        tnl)
    name = "paged_prefill" + suffix
    results[name] = dict(
        ms=time_ms(torch, prefill, host=host.setdefault(name, {})),
        plain_ms=time_ms(torch, lambda: ref.paged_prefill_ref(
            q.transpose(1, 2), kp, vp, tables, tp0, tnl)),
        bytes=byts, flops=flops, library_ms=None,
        graph_ms=graph_ms(torch, prefill))
    results[name]["plan"] = launch_plan(ops, "paged_prefill")
    s = PROMPT_PAD
    q, k, v = (mk(MAX_BATCH, s, h, d) for h in (hq, hkv, hkv))
    byts = (2 * q.numel() + k.numel() + v.numel()) * item
    flops = 4 * MAX_BATCH * hq * d * s * (s + 1) // 2
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    name = "flash_attention" + suffix
    results[name] = dict(
        ms=time_ms(torch, lambda: ops.flash_attention(q, k, v),
                   host=host.setdefault(name, {})),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(qt, kt, vt)),
        bytes=byts, flops=flops,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        graph_ms=graph_ms(torch, lambda: ops.flash_attention(q, k, v)))
    # the plan the timed bf16 calls launched with
    results[name]["plan"] = ops.last_plan["flash_attention"]._asdict()
    for r in results.values():
        r["peak"] = peak
    return results


def olmoe_shape_phase(torch, dev, ocfg):
    """The three attention kernels at olmoe-1b-7b's serving shapes (16
    query heads over 16 KV heads of 128: GQA group 1, so paged decode
    plans one row per CTA and paged prefill puts C 8 x g 1 = 8 live rows
    in a 64-row tile): each vs its plain version in float32 and bfloat16
    at the shapes :func:`serving_shape_rows` times, then its times and
    bound (flash also against SDPA)."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    hq, hkv, d = ocfg.n_heads, ocfg.n_kv_heads, ocfg.head_dim
    rng = np.random.default_rng(21)
    main_err = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        lens = [97, 100, 104, 108, 101, 103, 106, 110]
        kp, vp, tables, mk = paged_inputs(torch, rng, MAX_BATCH, hkv, d,
                                          lens, dtype, dev)
        cls = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = mk(MAX_BATCH, 1, hq, d)
        got = ops.paged_attention(q, kp, vp, tables, cls)
        want = ref.paged_attention_ref(q[:, 0], kp, vp, tables,
                                       cls)[:, None]
        main_err[("paged_decode_olmoe", dtype_name)] = compare(
            torch, "paged_decode g1", got, want, dtype_name)
        p0 = np.array([36, 32], np.int32)
        nl = np.array([8, 8], np.int32)
        kp, vp, tables, mk = paged_inputs(torch, rng, 2, hkv, d, p0 + CHUNK,
                                          dtype, dev)
        q = mk(2, CHUNK, hq, d)
        tp0 = torch.from_numpy(p0).to(dev)
        tnl = torch.from_numpy(nl).to(dev)
        got = ops.paged_prefill(q, kp, vp, tables, tp0, tnl)
        want = ref.paged_prefill_ref(q.transpose(1, 2), kp, vp, tables, tp0,
                                     tnl).transpose(1, 2)
        main_err[("paged_prefill_olmoe", dtype_name)] = compare(
            torch, "paged_prefill g1", got, want, dtype_name)
        q, k, v = (mk(MAX_BATCH, PROMPT_PAD, h, d) for h in (hq, hkv, hkv))
        got = ops.flash_attention(q, k, v)
        want = ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2)).transpose(1, 2)
        main_err[("flash_attention_olmoe", dtype_name)] = compare(
            torch, "flash g1 D128", got, want, dtype_name)
    host = {}
    results = serving_shape_rows(torch, dev, hq, hkv, d, rng, host,
                                 suffix="_olmoe")
    finish(results, host, main_err)
    return results


def launch_plan(ops, name):
    """The plan of ``name``'s last launch, as a dict (None before any)."""
    plan = ops.last_plan.get(name)
    return None if plan is None else plan._asdict()


def paged_long_phase(torch, dev):
    """paged_decode at a long context (qwen2.5-3b's heads: Hq 16, Hkv 2,
    D 128; 8 slots of 8065-8192 tokens; block 16, table width 512) vs its
    plain version in float32 and bfloat16; then bf16 CUDA-event, host
    enqueue and graph-replayed times.  Its 66.6 MB of K/V exceed the 50 MB
    L2, so graph replays cannot run from the cache."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    hq, hkv, d, bs, m = 16, 2, 128, 16, 512
    lens = list(LONG_CTX)
    rng = np.random.default_rng(5)
    cls = torch.tensor(lens, dtype=torch.int32, device=dev)
    main_err = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        kp, vp, tables, mk = paged_inputs(torch, rng, len(lens), hkv, d,
                                          lens, dtype, dev, bs=bs, m=m)
        q = mk(len(lens), 1, hq, d)
        got = ops.paged_attention(q, kp, vp, tables, cls)
        want = ref.paged_attention_ref(q[:, 0], kp, vp, tables,
                                       cls)[:, None]
        main_err[("paged_decode_long", dtype_name)] = compare(
            torch, "paged_decode long", got, want, dtype_name)
        del want
    byts, flops = paged_decode_cost(q, lens, hkv, d, bs, 2)
    decode = lambda: ops.paged_attention(q, kp, vp, tables, cls)  # noqa
    host = {}
    results = {"paged_decode_long": dict(
        ms=time_ms(torch, decode,
                   host=host.setdefault("paged_decode_long", {})),
        plain_ms=time_ms(torch, lambda: ref.paged_attention_ref(
            q[:, 0], kp, vp, tables, cls), reps=5),
        bytes=byts, flops=flops, library_ms=None,
        graph_ms=graph_ms(torch, decode), peak=H100_PEAK["bfloat16"],
        plan=launch_plan(ops, "paged_decode"))}
    finish(results, host, main_err)
    return results


def paged_sweep_phase(torch, dev):
    """paged_decode vs its plain version over the edge cases: D 16, 64,
    128, 256; GQA groups 1, 3, 8 over 2 kv-heads; block 8 and 16; one row
    each of ctx 0, 1, bs, bs + 1 and the full table (M 4); fused and
    per-head grids; softcap 30 on scores of std 8 (q scaled by 8, so the
    cap moves the output beyond the tolerance); table entries past each
    row's context hold ids outside the pool (the kernel must never read
    them; the plain version, which gathers every entry, gets 0 there)."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(6)
    m, hkv = 4, 2
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        atol, rtol = TOL[dtype_name]
        worst = 0.0
        for d in (16, 64, 128, 256):
            for g in (1, 3, 8):
                for bs in (8, 16):
                    lens = [0, 1, bs, bs + 1, m * bs]
                    kp, vp, tables, mk = paged_inputs(
                        torch, rng, len(lens), hkv, d, lens, dtype, dev,
                        bs=bs, m=m)
                    live = torch.arange(m, device=dev)[None, :] < torch.tensor(
                        [-(-ln // bs) for ln in lens], device=dev)[:, None]
                    wild = torch.where(live, tables, torch.where(
                        torch.arange(m, device=dev) % 2 == 0,
                        kp.shape[0] + 7, -3).to(torch.int32)[None, :]
                        .expand_as(tables)).contiguous()
                    cls = torch.tensor(lens, dtype=torch.int32, device=dev)
                    q = mk(len(lens), 1, g * hkv, d)
                    for softcap, qs in ((None, 1.0), (30.0, 8.0)):
                        for fused in (True, False):
                            got = ops.paged_attention(
                                q * qs, kp, vp, wild, cls, softcap=softcap,
                                fused=fused)
                            want = ref.paged_attention_ref(
                                (q * qs)[:, 0], kp, vp, tables, cls,
                                softcap=softcap)[:, None]
                            worst = max(worst, compare(
                                torch, f"paged D{d} g{g} bs{bs}", got, want,
                                dtype_name, quiet=True))
                            if float(got[0].abs().max()) != 0.0:
                                fail("paged_decode: zero-context row is not "
                                     "exact zeros")
                        if softcap:
                            plain = ref.paged_attention_ref(
                                (q * qs)[:, 0], kp, vp, tables, cls)[:, None]
                            if torch.allclose(plain.float(), want.float(),
                                              atol=atol, rtol=rtol):
                                fail(f"paged D{d} g{g} bs{bs}: softcap does "
                                     "not move the plain output beyond the "
                                     "tolerance")
        log(f"  paged_decode     {dtype_name:8s} edge sweep: D 16/64/128/256 "
            f"x g 1/3/8 x bs 8/16 x ctx 0/1/bs/bs+1/M*bs, fused and "
            f"per-head, softcap, out-of-pool ids past ctx: "
            f"max_abs_err={worst:.3e} ok")


def prefill_long_phase(torch, dev):
    """paged_prefill at a long context: 8 slots of 8065-8192 tokens whose
    last 8 are the chunk (C 8, n_live 8, pos0 = context - 8), for two head
    layouts: qwen2.5-3b's (Hq 16 / Hkv 2, D 128, bs 16, table width 512;
    66.6 MB of K/V, C * g * D = 8192, past a one-CTA query tile) and
    smollm-360m's (Hq 15 / Hkv 5, D 64, bs 8, table width 1024; 83.3 MB).
    Each vs its plain version in float32 and bfloat16, at TOL and within
    RMS_SHARE of the output's RMS; then bf16 CUDA-event, host enqueue and
    graph-replayed times (the K/V exceed the 50 MB L2)."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    lens = np.array(LONG_CTX, np.int32)
    p0 = lens - CHUNK
    nl = np.full(len(lens), CHUNK, np.int32)
    rng = np.random.default_rng(7)
    tp0 = torch.from_numpy(p0).to(dev)
    tnl = torch.from_numpy(nl).to(dev)
    results, host, main_err = {}, {}, {}
    for key, hq, hkv, d, bs in (("paged_prefill_long_qwen", 16, 2, 128, 16),
                                ("paged_prefill_long_smollm", 15, 5, 64, 8)):
        m = -(-max(LONG_CTX) // bs)
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            kp, vp, tables, mk = paged_inputs(torch, rng, len(lens), hkv, d,
                                              lens, dtype, dev, bs=bs, m=m)
            q = mk(len(lens), CHUNK, hq, d)
            got = ops.paged_prefill(q, kp, vp, tables, tp0, tnl)
            want = ref.paged_prefill_ref(q.transpose(1, 2), kp, vp, tables,
                                         tp0, tnl).transpose(1, 2)
            name = key.replace("paged_prefill_", "prefill ")
            main_err[(key, dtype_name)] = compare(torch, name, got, want,
                                                  dtype_name)
            log(f"  {name:16s} {dtype_name:8s} max_abs_err / RMS = "
                f"{compare_rms(name, got, want):.3e} ok")
            del got, want
        byts, flops = paged_prefill_cost(q, p0, nl, hkv, bs, 2)
        prefill = lambda: ops.paged_prefill(q, kp, vp, tables,  # noqa
                                            tp0, tnl)
        results[key] = dict(
            ms=time_ms(torch, prefill, host=host.setdefault(key, {})),
            plain_ms=time_ms(torch, lambda: ref.paged_prefill_ref(
                q.transpose(1, 2), kp, vp, tables, tp0, tnl), reps=3),
            bytes=byts, flops=flops, library_ms=None,
            graph_ms=graph_ms(torch, prefill), peak=H100_PEAK["bfloat16"],
            plan=launch_plan(ops, "paged_prefill"))
        del kp, vp, q
    finish(results, host, main_err)
    return results


def prefill_sweep_phase(torch, dev):
    """paged_prefill vs its plain version over the edge cases: D 16, 64,
    128, 256 in float32, every built head dim (64, 80, 96, 128, 256) in
    bfloat16; GQA groups 1, 3, 8 over 2 kv-heads; block 8 and 16; chunks 1,
    2, 3, 5, 8, 16, 64; slots at pos0 0, bs - 1, 300 and DEEP_POS0 with
    n_live 0, 1, partial and C, and at the verify chunks (C 2, 3, 5) two
    windows that end at the table's capacity (the deep slots give each of
    a cluster's 8 ranks several 64-key tiles, so the ring wraps and the
    softmax rescales across tiles; their live rows are also held to
    RMS_SHARE of their RMS); softcap 30 on scores of std 8 (q scaled by
    8, so the cap moves the output beyond the tolerance); table
    entries past each slot's reach ceil((pos0 + n_live) / bs) hold ids
    outside the pool (never read; the plain version gets 0 there); rows at
    chunk positions >= n_live must be exact zeros."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(8)
    # the verify chunks draw from their own generator: the other cases
    # keep the draws they always had
    rng_verify = np.random.default_rng(10)
    hkv = 2
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        atol, rtol = TOL[dtype_name]
        dims = ((16, 64, 128, 256) if dtype_name == "float32"
                else ops.FLASH_TC_HEAD_DIMS)
        worst, worst_rms, cases = 0.0, 0.0, 0
        for d in dims:
            for g in (1, 3, 8):
                for bs in (8, 16):
                    for c in (1, 2, 3, 5, 8, 16, 64):
                        m = -(-(DEEP_POS0 + c) // bs)
                        if c in VERIFY_CHUNKS:
                            # the verify window: ragged n_live, a dead
                            # row, and two windows ending at the table's
                            # capacity (pos0 = capacity - n_live)
                            cap = m * bs
                            p0 = np.array([0, bs - 1, 300, 300, cap - c,
                                           cap - 1, DEEP_POS0, DEEP_POS0],
                                          np.int32)
                            nl = np.array([c, 1, c // 2 + 1, 0, c, 1, c,
                                           c - 1], np.int32)
                        else:
                            p0 = np.array([0, bs - 1, 300, 300, bs - 1, 300,
                                           DEEP_POS0, DEEP_POS0], np.int32)
                            nl = np.array([c, 1, c // 2 + 1, 0, c, c, c,
                                           c // 2 + 1], np.int32)
                        kp, vp, tables, mk = paged_inputs(
                            torch, rng_verify if c in VERIFY_CHUNKS else rng,
                            len(p0), hkv, d, np.minimum(p0 + c, m * bs),
                            dtype, dev, bs=bs, m=m)
                        reach = torch.tensor(
                            [-(-int(p + n) // bs) for p, n in zip(p0, nl)],
                            device=dev)
                        col = torch.arange(m, device=dev)
                        wild = torch.where(
                            col[None, :] < reach[:, None], tables,
                            torch.where(col % 2 == 0, kp.shape[0] + 7, -3)
                            .to(torch.int32)[None, :].expand_as(tables)
                        ).contiguous()
                        tp0 = torch.from_numpy(p0).to(dev)
                        tnl = torch.from_numpy(nl).to(dev)
                        q = mk(len(p0), c, g * hkv, d)
                        for softcap, qs in ((None, 1.0), (30.0, 8.0)):
                            got = ops.paged_prefill(q * qs, kp, vp, wild, tp0,
                                                    tnl, softcap=softcap)
                            want = ref.paged_prefill_ref(
                                (q * qs).transpose(1, 2), kp, vp, tables, tp0,
                                tnl, softcap=softcap).transpose(1, 2)
                            worst = max(worst, compare(
                                torch, f"prefill D{d} g{g} bs{bs} C{c}", got,
                                want, dtype_name, quiet=True))
                            cases += 1
                            for i, n in enumerate(nl):
                                if bool(got[i, n:].any()):
                                    fail(f"paged_prefill D{d} g{g} bs{bs} "
                                         f"C{c}: rows past n_live are not "
                                         "exact zeros")
                                if p0[i] == DEEP_POS0:
                                    worst_rms = max(worst_rms, compare_rms(
                                        f"prefill D{d} g{g} bs{bs} C{c} "
                                        f"pos0 {DEEP_POS0}", got[i, :n],
                                        want[i, :n]))
                            if softcap:
                                plain = ref.paged_prefill_ref(
                                    (q * qs).transpose(1, 2), kp, vp, tables,
                                    tp0, tnl).transpose(1, 2)
                                if torch.allclose(plain.float(), want.float(),
                                                  atol=atol, rtol=rtol):
                                    fail(f"prefill D{d} g{g} bs{bs} C{c}: "
                                         "softcap does not move the plain "
                                         "output beyond the tolerance")
        log(f"  paged_prefill    {dtype_name:8s} edge sweep: {cases} calls, "
            f"D {'/'.join(map(str, dims))} x g 1/3/8 x bs 8/16 x C "
            f"1/2/3/5/8/16/64, pos0 0/bs-1/300/{DEEP_POS0} (C 2/3/5 also "
            f"capacity - n_live) x n_live 0/1/partial/C, softcap, "
            f"out-of-pool ids past reach: "
            f"max_abs_err={worst:.3e}, at pos0 {DEEP_POS0} "
            f"max_abs_err / RMS={worst_rms:.3e} ok")


def prefill_verify_phase(torch, dev, cfg):
    """paged_prefill at the speculative verify shape: 8 slots of
    smollm-360m's heads (Hq 15 / Hkv 5, D 64), block 8, C = K + 1 = 5 with
    n_live drawn from 1-5 and one dead row, contexts (pos0) 16-110 as
    phase 4's; vs its plain version in float32 and bfloat16, then bf16
    CUDA-event, host enqueue and graph-replayed times."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(9)
    c = VERIFY_K + 1
    p0 = rng.integers(16, 111, MAX_BATCH).astype(np.int32)
    nl = rng.integers(1, c + 1, MAX_BATCH).astype(np.int32)
    nl[3] = 0
    tp0 = torch.from_numpy(p0).to(dev)
    tnl = torch.from_numpy(nl).to(dev)
    main_err = {}
    for dtype_name in ("float32", "bfloat16"):
        kp, vp, tables, mk = paged_inputs(torch, rng, MAX_BATCH, hkv, d,
                                          p0 + c, getattr(torch, dtype_name),
                                          dev)
        q = mk(MAX_BATCH, c, hq, d)
        got = ops.paged_verify(q, kp, vp, tables, tp0, tnl)
        want = ref.paged_prefill_ref(q.transpose(1, 2), kp, vp, tables, tp0,
                                     tnl).transpose(1, 2)
        main_err[("paged_prefill_verify", dtype_name)] = compare(
            torch, "prefill verify", got, want, dtype_name)
        if bool(got[3].any()):
            fail("paged_prefill verify: the dead row is not exact zeros")
    byts, flops = paged_prefill_cost(q, p0, nl, hkv, BLOCK, 2)
    verify = lambda: ops.paged_verify(q, kp, vp, tables, tp0,  # noqa: E731
                                      tnl)
    host = {}
    results = {"paged_prefill_verify": dict(
        ms=time_ms(torch, verify,
                   host=host.setdefault("paged_prefill_verify", {})),
        plain_ms=time_ms(torch, lambda: ref.paged_prefill_ref(
            q.transpose(1, 2), kp, vp, tables, tp0, tnl)),
        bytes=byts, flops=flops, library_ms=None,
        graph_ms=graph_ms(torch, verify), peak=H100_PEAK["bfloat16"],
        plan=launch_plan(ops, "paged_prefill"),
        pos0=p0.tolist(), n_live=nl.tolist())}
    finish(results, host, main_err)
    return results


def finish(results, host, main_err):
    """Bound (larger of bytes over the HBM rate and operations over the
    peak rate of their type) and the serving-shape bf16 error per kernel;
    logs one timing line each."""
    for name, r in results.items():
        t_bytes = r["bytes"] / H100_HBM_BW * 1e3
        t_ops = r["flops"] / r["peak"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["max_abs_err"] = main_err[(name, "bfloat16")]
        r["max_abs_err_float32"] = main_err[(name, "float32")]
        lib = r["library_ms"]
        graph = (f", {r['graph_ms']:.5f} ms from a CUDA graph"
                 if "graph_ms" in r else "")
        log(f"  time {name:16s} kernel {r['ms']:.5f} ms (host enqueue "
            f"{host[name]['ms']:.5f} ms{graph})  plain "
            f"{r['plain_ms']:.5f} ms  library "
            f"{lib if lib is None else round(lib, 5)}"
            f" ms  bound {r['bound_ms']:.5f} ms ({r['bound_by']}: "
            f"{r['bytes']} bytes, {r['flops']} flops)")


def wkv_inputs(torch, rng, b, s, h, n, dtype, dev):
    """r, k, v ~ N(0, 1) in ``dtype``; float32 decays in (0.29, 0.99) (the
    model computes w in float32); u, s0 ~ N(0, 1) float32.  Drawn on the
    device from a generator seeded by ``rng`` (the long shape is 67M
    elements per tensor)."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    mk = lambda *sh: torch.randn(sh, generator=gen,        # noqa: E731
                                 device=dev)
    r, k, v = (mk(b, s, h, n).to(dtype) for _ in range(3))
    w = torch.sigmoid(mk(b, s, h, n)) * 0.7 + 0.29
    return r, k, v, w, mk(h, n), mk(b, h, n, n)


def wkv_cost(r, w, u, state):
    """Bytes and flops of one WKV call from a zero state: r, k, v read and
    y written in r's dtype, w read in float32, u read, the final state
    written in float32 (no s0 read); 5 N flops per (b, t, h, column)."""
    byts = (r.numel() * (4 * r.element_size() + w.element_size())
            + u.numel() * 4 + state.numel() * 4)
    return byts, 5 * r.numel() * r.shape[3]


def wkv_phase(torch, dev, cfg):
    """rwkv6_scan vs ``ref.rwkv6_scan_ref``: the cohort-prefill shape
    (MAX_BATCH x RWKV_PROMPT_PAD, all heads) with and without s0, one step,
    a ragged S, N 16, N 8 (rows padded to 64) and N 37 (no 16-byte copies;
    S crossing two chunks), and the long shape (MAX_BATCH x WKV_LONG_S);
    then CUDA-event, host-enqueue and graph-replayed times at the serving
    and long shapes in bf16 from a zero state, as the cohort prefill calls
    it, each plan held to the CTAs per SM the card reports for it."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    h, n = cfg.n_heads, cfg.head_dim
    b, s = MAX_BATCH, RWKV_PROMPT_PAD
    rng = np.random.default_rng(1)
    main_err = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for bb, ss, hh, nn, with_s0 in ((b, s, h, n, True),
                                        (b, s, h, n, False),
                                        (2, 1, 4, n, True),
                                        (2, 37, 4, n, True),
                                        (3, 40, 4, 16, True),
                                        (2, 19, 3, 8, True),
                                        (2, 35, 3, 37, False),
                                        (b, WKV_LONG_S, h, n, False)):
            r, k, v, w, u, s0 = wkv_inputs(torch, rng, bb, ss, hh, nn, dtype,
                                           dev)
            y, s_final = ops.rwkv6_scan(r, k, v, w, u,
                                        s0 if with_s0 else None)
            init = s0 if with_s0 else torch.zeros_like(s0)
            want_y, want_s = ref.rwkv6_scan_ref(
                *(x.transpose(1, 2) for x in (r, k, v, w)), u, init)
            e = compare(torch, "rwkv6_scan", y, want_y.transpose(1, 2),
                        dtype_name)
            compare(torch, "rwkv6_scan state", s_final, want_s, "float32")
            if bb == b and not with_s0:
                main_err[("rwkv6_scan" if ss == s else "rwkv6_scan_long",
                          dtype_name)] = e
            del r, k, v, w, y, want_y
    torch.cuda.empty_cache()
    results, host = {}, {}
    for key, ss, reps, plain_reps in (("rwkv6_scan", s, 50, 10),
                                      ("rwkv6_scan_long", WKV_LONG_S, 20, 2)):
        r, k, v, w, u, _ = wkv_inputs(torch, rng, b, ss, h, n,
                                      torch.bfloat16, dev)
        zeros = torch.zeros((b, h, n, n), dtype=torch.float32, device=dev)
        rt = [x.transpose(1, 2) for x in (r, k, v, w)]
        byts, flops = wkv_cost(r, w, u, zeros)
        scan = lambda: ops.rwkv6_scan(r, k, v, w, u)     # noqa: E731
        scan()
        plan = ops.last_plan["rwkv6_scan"]
        resident = ops.rwkv6_scan_resident(plan, torch.bfloat16)
        if resident < plan.ctas_per_sm:
            fail(f"rwkv6_scan: the card holds {resident} CTAs per SM, the "
                 f"plan counts on {plan.ctas_per_sm}")
        results[key] = dict(
            ms=time_ms(torch, scan, reps=reps, host=host.setdefault(key, {})),
            graph_ms=graph_ms(torch, scan, reps=reps),
            plan=dict(plan._asdict(), resident=resident),
            plain_ms=time_ms(torch, lambda: ref.rwkv6_scan_ref(*rt, u, zeros),
                             reps=plain_reps),
            bytes=byts, flops=flops, library_ms=None,
            peak=H100_PEAK["float32"])
        del r, k, v, w, rt
        torch.cuda.empty_cache()
    finish(results, host, main_err)
    return results


def rglru_phase(torch, dev, gcfg):
    """rglru_scan vs ``ref.rglru_scan_ref``: the cohort-prefill shape
    (MAX_BATCH x RG_PROMPT_PAD x lru_width) with and without h0, one step,
    a ragged S and R 96, float32 and bfloat16 outputs; then CUDA-event
    times at the serving shape (bf16 output, zero state), as the cohort
    prefill calls it."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    b, s, r = MAX_BATCH, RG_PROMPT_PAD, gcfg.d_model
    rng = np.random.default_rng(2)
    mk = lambda *sh: torch.from_numpy(                     # noqa: E731
        rng.standard_normal(sh).astype(np.float32)).to(dev)
    main_err = {}
    for bb, ss, rr, with_h0 in ((b, s, r, True), (b, s, r, False),
                                (2, 1, r, True), (2, 37, r, True),
                                (3, 40, 96, True)):
        a, bv, h0 = torch.sigmoid(mk(bb, ss, rr)), mk(bb, ss, rr), mk(bb, rr)
        want_h, want_last = ref.rglru_scan_ref(
            a, bv, h0 if with_h0 else torch.zeros_like(h0))
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            h, last = ops.rglru_scan(a, bv, h0 if with_h0 else None,
                                     out_dtype=dtype)
            e = compare(torch, "rglru_scan", h, want_h.to(dtype), dtype_name)
            compare(torch, "rglru_scan state", last, want_last, "state")
            if (bb, ss) == (b, s) and not with_h0:
                main_err[("rglru_scan", dtype_name)] = e
    a, bv = torch.sigmoid(mk(b, s, r)), mk(b, s, r)
    zeros = torch.zeros((b, r), dtype=torch.float32, device=dev)
    # a and b read in float32, h written in bf16, h_last in float32
    byts = a.numel() * (4 + 4 + 2) + zeros.numel() * 4
    host = {}
    scan = lambda: ops.rglru_scan(a, bv,                  # noqa: E731
                                  out_dtype=torch.bfloat16)
    results = {"rglru_scan": dict(
        ms=time_ms(torch, scan, host=host.setdefault("rglru_scan", {})),
        graph_ms=graph_ms(torch, scan),
        plain_ms=time_ms(torch, lambda: ref.rglru_scan_ref(a, bv, zeros),
                         reps=3),
        bytes=byts, flops=2 * a.numel(), library_ms=None,
        peak=H100_PEAK["float32"])}
    finish(results, host, main_err)
    return results


def flash_tc_phase(torch, dev):
    """The bf16 tensor-core flash kernel vs its plain version at every head
    dim it is built for: GQA groups of 1, 3 and 10, ragged S (100, 129),
    windows 32 and 48, softcap 30, non-causal, B 1 and S 1; and a head dim
    it was not built for, which must raise ValueError."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(4)
    # q is scaled by 8 in the softcap case: scores of std 8 pass the cap
    cases = [dict(s=100), dict(s=129), dict(s=129, window=32),
             dict(s=100, window=48), dict(s=100, softcap=30.0, qs=8.0),
             dict(s=129, causal=False), dict(s=100, b=1), dict(s=1)]
    for d in ops.FLASH_TC_HEAD_DIMS:
        worst = 0.0
        for g, hkv in ((1, 2), (3, 5), (10, 1)):
            for case in cases:
                kw = dict(case)
                b, s, qs = kw.pop("b", 2), kw.pop("s"), kw.pop("qs", 1.0)
                q, k, v = (torch.from_numpy(rng.standard_normal(
                    (b, s, h, d)).astype(np.float32)).to(dev, torch.bfloat16)
                    for h in (g * hkv, hkv, hkv))
                q = q * qs
                got = ops.flash_attention(q, k, v, **kw)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                want = ref.flash_attention_ref(qt, kt, vt, **kw).transpose(
                    1, 2)
                worst = max(worst, compare(
                    torch, f"flash D{d} g{g}", got, want, "bfloat16",
                    quiet=True))
                if kw.get("softcap"):
                    # the case fails a kernel that drops the cap
                    atol, rtol = TOL["bfloat16"]
                    plain = ref.flash_attention_ref(
                        qt, kt, vt, **dict(kw, softcap=None)).transpose(1, 2)
                    if torch.allclose(plain.float(), want.float(), atol=atol,
                                      rtol=rtol):
                        fail(f"flash D{d} g{g}: softcap does not change "
                             "the plain output beyond the tolerance")
        log(f"  flash_attention  bfloat16 D {d}: {3 * len(cases)} cases "
            f"(g 1/3/10, S 100/129, window 32/48, softcap, non-causal, "
            f"B 1, S 1) max_abs_err={worst:.3e} ok")
    q, k, v = (torch.zeros((1, 8, h, 48), dtype=torch.bfloat16, device=dev)
               for h in (4, 2, 2))
    try:
        ops.flash_attention(q, k, v)
    except ValueError as e:
        log(f"  flash_attention  bfloat16 D 48 refused: {e}")
    else:
        fail("flash_attention: bf16 head dim 48 did not raise ValueError")


def flash_d256_phase(torch, dev, gcfg):
    """flash_attention at recurrentgemma's prefill shape (MAX_BATCH x
    RG_PROMPT_PAD, Hq 10 / Hkv 1, D 256, window 2048, causal) vs its plain
    version in float32 and bfloat16; then bf16 CUDA-event times beside
    ``F.scaled_dot_product_attention`` (causal: a window as long as the
    prompt masks nothing more)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    b, s, w = MAX_BATCH, RG_PROMPT_PAD, gcfg.window
    hq, hkv, d = gcfg.n_heads, gcfg.n_kv_heads, gcfg.head_dim
    rng = np.random.default_rng(3)
    main_err = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, s, h, d)).astype(np.float32)).to(dev, dtype)
            for h in (hq, hkv, hkv))
        got = ops.flash_attention(q, k, v, window=w)
        want = ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            window=w).transpose(1, 2)
        main_err[("flash_d256", dtype_name)] = compare(
            torch, "flash_d256", got, want, dtype_name)
        del want
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    host = {}
    results = {"flash_d256": dict(
        ms=time_ms(torch, lambda: ops.flash_attention(q, k, v, window=w),
                   reps=20, host=host.setdefault("flash_d256", {})),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(
            qt, kt, vt, window=w), reps=3),
        bytes=(2 * q.numel() + k.numel() + v.numel()) * 2,
        flops=4 * b * hq * d * s * (s + 1) // 2,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=20),
        graph_ms=graph_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                             window=w),
                          reps=20),
        peak=H100_PEAK["bfloat16"],
        plan=ops.last_plan["flash_attention"]._asdict())}
    finish(results, host, main_err)
    return results


# --------------------------------------------------------------------------- #
# phases 4-5: serving
# --------------------------------------------------------------------------- #
def trace(vocab):
    """8 requests, prompts 16-96 tokens; (A1, A2) share 36 tokens — a
    32-token prefix plus 4 tokens of the next block, so A2 maps 4 blocks
    shared and copies the fifth on write — and (B1, B2) share exactly a
    32-token prefix.  A2 and B2 arrive while the first step is in flight,
    so they join mid-flight through the chunked suffix prefill fused with
    the resident cohort's decode window."""
    import numpy as np
    from repro_torch.core.scheduler import ServeRequest
    rng = np.random.default_rng(11)
    tok = lambda n: rng.integers(0, vocab, n, dtype=np.int32)  # noqa: E731
    pa, pb = tok(32), tok(32)
    a1 = np.concatenate([pa, tok(60)])
    a2 = np.concatenate([a1[:36], tok(40)])
    b1 = np.concatenate([pb, tok(48)])
    b2 = np.concatenate([pb, tok(30)])
    cold = [a1, b1, tok(16), tok(24), tok(70), tok(96)]
    reqs = [ServeRequest(i, p, NEW_TOKENS, arrival_t=0.0)
            for i, p in enumerate(cold)]
    reqs += [ServeRequest(6, a2, NEW_TOKENS, arrival_t=0.01),
             ServeRequest(7, b2, NEW_TOKENS, arrival_t=0.02)]
    return reqs


def rwkv_trace(vocab):
    """8 requests of 16-64 prompt tokens (both ends included), arriving
    together: one cohort of MAX_BATCH rows."""
    import numpy as np
    from repro_torch.core.scheduler import ServeRequest
    rng = np.random.default_rng(12)
    lens = [16, RWKV_PROMPT_PAD] + [int(x) for x in rng.integers(17, 64, 6)]
    return [ServeRequest(i, rng.integers(0, vocab, n, dtype=np.int32),
                         NEW_TOKENS, arrival_t=0.0)
            for i, n in enumerate(lens)]


def rg_trace(vocab):
    """8 requests of 1024-2048 prompt tokens (both ends included),
    arriving together: one cohort of MAX_BATCH rows."""
    import numpy as np
    from repro_torch.core.scheduler import ServeRequest
    rng = np.random.default_rng(13)
    lens = [1024, RG_PROMPT_PAD] + [int(x) for x in
                                    rng.integers(1025, RG_PROMPT_PAD, 6)]
    return [ServeRequest(i, rng.integers(0, vocab, n, dtype=np.int32),
                         NEW_TOKENS, arrival_t=0.0)
            for i, n in enumerate(lens)]


def cut_depth(model, cfg, params, depth):
    """The first ``depth`` layers of a model: its config and a view of its
    parameters (stacked groups cut, the rest taken from the next group)."""
    if depth == cfg.n_layers:
        return cfg, params
    groups, rest = divmod(depth, len(cfg.block_pattern))
    stack = params["layers"]["stack"]
    if groups < cfg.n_layers // len(cfg.block_pattern):
        tail = {f"r{j}": model.tree_map(lambda t: t[groups], stack[f"b{j}"])
                for j in range(rest)}
    else:
        tail = {f"r{j}": params["layers"]["rest"][f"r{j}"]
                for j in range(rest)}
    layers = {"stack": model.tree_map(lambda t: t[:groups], stack),
              "rest": tail}
    return (dataclasses.replace(cfg, n_layers=depth),
            dict(params, layers=layers))


def serve(torch, backend, reqs, executor=None, setup=None, **kw):
    """Serve ``reqs`` through ``ClientHandler`` (phase 4's paged settings
    unless ``kw`` overrides them; ``setup(handler)`` runs before the
    trace); every request must finish its budget."""
    from repro_torch.launch.serve import ClientHandler
    kw = {"prompt_pad": PROMPT_PAD, "decode_window": 4, "max_secondaries": 0,
          "max_batch": MAX_BATCH, **kw}
    h = ClientHandler(backend, executor=executor, **kw)
    if setup is not None:
        setup(h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = h.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = {c.rid: [int(t) for t in c.tokens] for c in rep.completions}
    if sorted(toks) != list(range(len(reqs))):
        fail(f"served {sorted(toks)} of {len(reqs)} requests")
    for rid, t in toks.items():
        if len(t) != NEW_TOKENS or not all(0 <= x < backend.cfg.vocab_size
                                           for x in t):
            fail(f"request {rid}: {len(t)} tokens {t[:4]}...")
    return toks, rep, h, wall, reqs


def timed_once(torch, steps):
    """Executor running each step closure once, timed on the host clock
    between device synchronisations; appends (closure name, seconds)."""
    def executor(clone, fn, args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append((fn.__name__, dt))
        return out, dt
    return executor


def timed_fixed(torch, steps):
    """Executor running each step closure once and timing it on the host
    clock between device synchronisations, appending (closure name,
    seconds); the timeline is charged a fixed 0.05 s per closure, so two
    runs of one trace schedule alike whatever the card's times."""
    timed = timed_once(torch, steps)

    def executor(clone, fn, args):
        return timed(clone, fn, args)[0], 0.05
    return executor


def counted(ops, fn, tally):
    """``fn`` wrapped to add the kernel launches each of its calls makes
    to ``tally`` (by kernel name)."""
    def run(*args):
        before = dict(ops.launches)
        out = fn(*args)
        for k, v in ops.launches.items():
            tally[k] = tally.get(k, 0) + v - before[k]
        return out
    run.__name__ = fn.__name__
    return run


def logits_at(torch, backend, req, generated, prompt_pad):
    """float32 logits of ``backend`` at the step that produced
    ``generated[-1]``: prefill of the padded prompt, then one decode step
    per earlier token (a contiguous cache; valid for every family)."""
    import numpy as np
    from repro_torch.models import model
    cfg, params, ctx = backend.cfg, backend.params, backend.ctx
    toks = np.zeros((1, prompt_pad), np.int32)
    toks[0, :min(len(req.prompt), prompt_pad)] = req.prompt[:prompt_pad]
    logits, cache = model.forward(cfg, params,
                                  {"tokens": backend.tensor(toks)}, ctx,
                                  "prefill", cache_capacity=backend.capacity)
    for i, tok in enumerate(generated[:-1]):
        pos = min(prompt_pad + i, backend.capacity - 1)
        logits, cache = model.decode_step(cfg, params, cache,
                                          backend.tensor([[tok]]), pos, ctx)
    return logits[0].float()


def parity(torch, cfg32, params, capacity, trace_fn, prompt_pad, **kw):
    """float32, impl="cuda" vs impl="torch" on one set of weights:
    identical token streams, or a first mismatch at a near-tie (plain-path
    top-two gap < 1e-4); fails otherwise."""
    from repro_torch.launch.serve import LMBackend
    fixed = lambda c, f, a: (f(*a), 0.05)          # noqa: E731
    runs, routes = {}, {}
    for impl in ("cuda", "torch"):
        b = LMBackend(cfg32, capacity=capacity, params=params, device="cuda",
                      impl=impl)
        with RouteLog(torch, cfg32.is_moe) as routes[impl]:
            runs[impl] = serve(torch, b, trace_fn(cfg32.vocab_size),
                               executor=fixed, prompt_pad=prompt_pad, **kw)
        n = sum(len(t) for t in runs[impl][0].values())
        log(f"  impl={impl}: wall {runs[impl][3]:.4f} s for {n} tokens "
            f"(fixed-time executor, each step run once)")
    routing = None
    if cfg32.is_moe:
        routing = routing_divergence(torch, routes["cuda"].calls,
                                     routes["torch"].calls, cfg32)
    plain = LMBackend(cfg32, capacity=capacity, params=params, device="cuda",
                      impl="torch")
    return hold_to_plain(torch, plain, runs["torch"][4], runs["cuda"][0],
                         runs["torch"][0], prompt_pad, routing=routing)


class RouteLog:
    """While active (and ``on``), records every call of ``models/moe.py``'s
    ``_route`` in call order, on the device: its float32 input rows (T, D)
    and router probabilities (T, E), which the hook recomputes from the
    call's inputs before it runs the package's own function unchanged."""

    def __init__(self, torch, on=True):
        self.torch, self.on, self.calls = torch, on, []

    def __enter__(self):
        if self.on:
            from repro_torch.models import moe
            self._moe, self._route = moe, moe._route

            def hook(x2d, router, cfg):
                x = x2d.float()
                logits = self.torch.matmul(x, router.float())
                self.calls.append((x, self.torch.softmax(logits, dim=-1)))
                return self._route(x2d, router, cfg)
            moe._route = hook
        return self

    def __exit__(self, *exc):
        if self.on:
            self._moe._route = self._route


def routing_divergence(torch, got, want, cfg):
    """The first router call at which two runs of one schedule (``got``:
    the kernel path, ``want``: the plain path; lists of (inputs,
    probabilities) per call) route a comparable row (ROUTE_INPUT_MAX) to
    another set of top-k experts, as a dict: the call, its layer, the
    rows, the plain path's k-th minus (k+1)-th probability at each
    (``gaps``) and ``drift``, the largest |probability difference| over
    the comparable rows of that call and every earlier one; None when
    every comparable row routes alike.  A swap of the k-th and (k+1)-th
    experts needs their difference to change sign, which two evaluations
    can do only where the gap is under |dp_k| + |dp_k+1| <= 2 * drift."""
    if len(got) != len(want):
        fail(f"router calls {len(got)} != {len(want)}: the schedules differ")
    k = cfg.top_k
    drift, skipped = 0.0, 0
    for c, ((xg, pg), (xw, pw)) in enumerate(zip(got, want)):
        if pg.shape != pw.shape:
            fail(f"router call {c}: shapes {tuple(pg.shape)} != "
                 f"{tuple(pw.shape)}")
        scale = xw.abs().amax(dim=-1).clamp_min(1e-30)
        same = (xg - xw).abs().amax(dim=-1) < ROUTE_INPUT_MAX * scale
        skipped += int((~same).sum())
        if not bool(same.any()):
            continue
        drift = max(drift, float((pg - pw).abs()[same].max()))
        sg = torch.sort(pg, dim=-1, descending=True, stable=True)
        sw = torch.sort(pw, dim=-1, descending=True, stable=True)
        ids_g = sg.indices[:, :k].sort(dim=-1).values
        ids_w = sw.indices[:, :k].sort(dim=-1).values
        parted = (ids_g != ids_w).any(dim=-1) & same
        rows = parted.nonzero().flatten().tolist()
        if rows:
            gaps = [float(sw.values[r, k - 1] - sw.values[r, k])
                    for r in rows]
            out = dict(call=c, calls=len(got), layer=c % cfg.n_layers,
                       rows=rows, gaps=gaps, drift=drift)
            log(f"  routing parts at router call {c} of {len(got)} (layer "
                f"{out['layer']}), rows {rows}: plain-path k-th minus "
                f"(k+1)-th probability {[f'{g:.3e}' for g in gaps]}, drift "
                f"{drift:.3e} (near-tie bound {2 * drift:.3e}); "
                f"{skipped} incomparable rows so far")
            return out
    log(f"  router calls: {len(got)}, every comparable row routes alike; "
        f"largest probability drift {drift:.3e}; {skipped} incomparable "
        "(dead or pad) rows")
    return None


def routing_near_tie(routing):
    """Whether the first routing divergence is a near-tie: every parted
    row's gap under twice the drift, the drift itself float32 rounding
    (under ROUTE_DRIFT_MAX)."""
    return (routing is not None and routing["drift"] < ROUTE_DRIFT_MAX
            and all(g < 2 * routing["drift"] for g in routing["gaps"]))


def hold_to_plain(torch, plain, reqs, got, want, prompt_pad, truth=None,
                  routing=None):
    """Fails unless the streams ``got`` equal ``want``, or each first
    mismatch is a near-tie: the top-two logit gap of the plain backend
    ``plain`` at that step under 1e-4 (float32), or, when ``truth`` (the
    plain path in float32 on the same weights) is given for a bfloat16
    ``plain``, under twice the largest logit error of ``plain`` against
    ``truth`` at that step (two bfloat16 evaluations each err by up to
    that much).  For a mixture-of-experts model a first mismatch also
    passes after a routing near-tie (``routing``: the runs' first routing
    divergence, :func:`routing_divergence`; :func:`routing_near_tie`).
    Returns the number of identical streams."""
    reqs = {r.rid: r for r in reqs}
    mismatched = first_mismatches(got, want)
    for rid, j in mismatched:
        logits = logits_at(torch, plain, reqs[rid], want[rid][:j + 1],
                           prompt_pad)
        top = torch.topk(logits, 2).values
        gap, bound = float(top[0] - top[1]), 1e-4
        if truth is not None:
            exact = logits_at(torch, truth, reqs[rid], want[rid][:j + 1],
                              prompt_pad)
            bound = 2 * float((logits - exact).abs().max())
        log(f"  request {rid}: first mismatch at token {j}, plain-path "
            f"top-two gap {gap:.3e} (near-tie bound {bound:.3e})")
        if gap >= bound:
            if routing_near_tie(routing):
                log(f"  request {rid}: accepted after the routing near-tie "
                    f"at router call {routing['call']}")
                continue
            fail(f"request {rid}: token streams differ at {j} "
                 f"(gap {gap} is no near-tie, bound {bound}; routing "
                 f"{routing})")
    log(f"  {len(want) - len(mismatched)}/{len(want)} streams identical"
        + (f", {len(mismatched)} near-tie(s) accepted" if mismatched
           else ""))
    return len(want) - len(mismatched)


def first_mismatches(got, want):
    """``[(rid, first differing token index)]`` of two stream dicts."""
    return [(rid, next(i for i, (x, y) in enumerate(zip(got[rid], want[rid]))
                       if x != y))
            for rid in want if got[rid] != want[rid]]


def cohort_parity(torch, cfg, depth, capacity, trace_fn, prompt_pad):
    """Phases 7 and 9: parity() through ``kv="contiguous"`` on the first
    ``depth`` layers of ``cfg`` at full width in float32 (random weights
    from seed 0)."""
    from repro_torch.models import model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = model.init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                        torch.device("cuda"))
    log(f"  first {depth} of {cfg.n_layers} layers")
    parity(torch, *cut_depth(model, cfg32, params, depth), capacity,
           trace_fn, prompt_pad, kv="contiguous", decode_window=1)


def rg_serving(torch, gcfg):
    """Phase 8: recurrentgemma-2b at full width in bf16 through the cohort
    mode, each step run once and timed.  Asserts one cohort prefill of 18
    rglru_scan and 8 flash_attention launches, and decode steps at
    positions past the window on a ring one window long.  Returns the
    launch counts."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import LMBackend
    from repro_torch.models import model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    backend = LMBackend(gcfg, capacity=RG_CAPACITY, device="cuda")
    torch.cuda.synchronize()
    n_par = model.n_params(gcfg)
    log(f"  {n_par} parameters, {n_par * 2 / 1e9:.2f} GB of bf16 weights "
        f"drawn in {time.perf_counter() - t0:.2f} s")
    steps, rings = [], []
    timed = timed_once(torch, steps)

    def executor(clone, fn, args):
        if fn.__name__ == "decode":          # (params, cache, tok, pos)
            rings.append((args[3], args[1]["stack"]["b2"]["k"].shape[2]))
        return timed(clone, fn, args)

    ops.reset_launches()
    toks, rep, _, wall, _ = serve(
        torch, backend, rg_trace(gcfg.vocab_size), executor=executor,
        kv="contiguous", decode_window=1, prompt_pad=RG_PROMPT_PAD)
    got = dict(ops.launches)
    n_tok = sum(len(t) for t in toks.values())
    pre = [dt for name, dt in steps if name == "prefill"]
    dec = [dt for name, dt in steps if name == "decode"]
    log(f"  {rep.summary()}")
    log(f"  wall {wall:.4f} s for {n_tok} tokens ({n_tok / wall:.3f} tok/s, "
        f"each step run once); cohort prefill {len(pre)} x "
        f"{1e3 * float(np.mean(pre)):.3f} ms, decode steps {len(dec)} "
        f"(median {1e3 * float(np.median(dec)):.3f} ms, min "
        f"{1e3 * min(dec):.3f} ms) at positions {rings[0][0]}-"
        f"{rings[-1][0]} on a {rings[0][1]}-slot ring; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {got}")
    kinds = gcfg.layer_kinds()
    want = {"paged_decode": 0, "paged_prefill": 0, "rwkv6_scan": 0,
            "rglru_scan": len(pre) * kinds.count("rglru"),
            "flash_attention": len(pre) * kinds.count("attn")}
    if len(pre) != 1 or got != want:
        fail(f"hybrid launches {got} (prefills {len(pre)}), want {want}")
    if any(length != gcfg.window or pos < gcfg.window
           for pos, length in rings):
        fail(f"decode did not wrap a {gcfg.window}-slot ring: {rings}")
    return got


def paged_serving(torch, cfg):
    """Phases 4 and 10: ``cfg`` at full width in bf16 through the paged
    handler (capacity 256, block 8, chunk 8, decode window 4) on phase 4's
    trace; every request must finish its budget, the prefix cache must hit,
    and paged prefill (C 8 x g query rows per kv-head: 64 at qwen2.5-3b's
    D 128, past a one-CTA query tile), paged decode and flash must all have
    launched.  Returns the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import LMBackend
    from repro_torch.models import model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    backend = LMBackend(cfg, capacity=CAPACITY, device="cuda")
    torch.cuda.synchronize()
    log(f"  {model.n_params(cfg)} parameters, "
        f"{weight_bytes(backend) / 1e9:.2f} GB of weights drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    ops.reset_launches()
    toks, rep, h, wall, _ = serve(torch, backend, trace(cfg.vocab_size))
    got = dict(ops.launches)
    n_tok = sum(len(t) for t in toks.values())
    log(f"  {rep.summary()}")
    log(f"  wall {wall:.4f} s for {n_tok} tokens ({n_tok / wall:.3f} tok/s, "
        f"Venue executor re-runs each step closure); prefix hit tokens "
        f"{h.prefix_hit_tokens}, launches {got}; paged_prefill plan "
        f"{launch_plan(ops, 'paged_prefill')}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if h.prefix_hit_tokens <= 0:
        fail("no prefix hit: the trace did not exercise the prefix cache")
    for name in ("paged_decode", "paged_prefill", "flash_attention"):
        if got[name] <= 0:
            fail(f"{name} never launched on the {cfg.name} serving path")
    return got


def weight_bytes(backend):
    """Bytes of a backend's parameters as they lie on the device (a MoE
    router stays float32 in a bf16 model)."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]
    return sum(t.numel() * t.element_size() for t in leaves(backend.params))


def full_vocab_draft(cfg):
    """The reduced-cost draft (``configs.draft_config``: 2 layers, d_model
    32, 3 query heads over 1 KV head of 16) at the target's vocab and
    dtype, as ``LMBackend(draft=...)`` takes it."""
    from repro_torch.configs import draft_config
    return dataclasses.replace(draft_config(cfg), vocab_size=cfg.vocab_size,
                               dtype=cfg.dtype)


def step_times(steps):
    """``{closure name: (count, median ms)}`` of a timed run."""
    import numpy as np
    names = sorted({n for n, _ in steps})
    return {n: (sum(1 for m, _ in steps if m == n),
                round(1e3 * float(np.median([dt for m, dt in steps
                                             if m == n])), 4))
            for n in names}


def spec_serving(torch, cfg):
    """Phase 12: smollm-360m at full width in bf16 through the paged
    handler with ``speculative=True, spec_k=VERIFY_K`` on phase 4's trace,
    once with the target as its own draft ("oracle") and once with the
    full-vocab reduced draft (random weights from seed 7), each closure
    run once and timed on a fixed timeline.  Every request must finish its
    budget and a draft clone must pair; paged_prefill must launch inside
    the verify rounds and paged_decode inside the draft rounds (counted
    from 0 over each run); the oracle run must emit more than 1.5 tokens
    per round.  Returns the launches per run."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import LMBackend
    target = LMBackend(cfg, capacity=CAPACITY, device="cuda")
    out = {}
    for name, draft in (("oracle", "oracle"),
                        ("draft", full_vocab_draft(cfg))):
        backend = LMBackend(cfg, capacity=CAPACITY, params=target.params,
                            device="cuda", draft=draft)
        part = {"draft": {}, "verify": {}}
        dfn, vfn = backend.spec_draft_fn, backend.spec_verify_fn
        backend.spec_draft_fn = lambda *a, f=dfn: counted(ops, f(*a),
                                                          part["draft"])
        backend.spec_verify_fn = lambda *a, f=vfn: counted(ops, f(*a),
                                                           part["verify"])
        steps = []
        ops.reset_launches()
        toks, rep, h, wall, _ = serve(
            torch, backend, trace(cfg.vocab_size),
            executor=timed_fixed(torch, steps), speculative=True,
            spec_k=VERIFY_K)
        got = dict(ops.launches)
        n_tok = sum(len(t) for t in toks.values())
        per_round = rep.spec_tokens / max(rep.spec_rounds, 1)
        log(f"  draft={name}: {rep.spec_rounds} rounds, {rep.spec_tokens} "
            f"tokens ({per_round:.3f} per round), acceptance "
            f"{rep.acceptance_rate:.4f}, fallbacks {rep.spec_fallbacks}; "
            f"wall {wall:.4f} s for {n_tok} tokens (each closure run "
            f"once); closures (count, median ms) {step_times(steps)}; "
            f"draft/target parameters {backend.draft_cost_ratio:.3e}; "
            f"launches {got}, in verify {part['verify']}, in draft "
            f"{part['draft']}")
        if not h.spec_draft_cids:
            fail(f"spec ({name}): no draft clone paired")
        if part["verify"].get("paged_prefill", 0) <= 0:
            fail(f"spec ({name}): paged_prefill never launched in a verify "
                 "round")
        if part["draft"].get("paged_decode", 0) <= 0:
            fail(f"spec ({name}): paged_decode never launched in a draft "
                 "round")
        if name == "oracle" and not per_round > 1.5:
            fail(f"spec (oracle): {per_round} tokens per round, want > 1.5")
        out[name] = got
    return out


def spec_parity(torch, cfg):
    """Phase 13: float32 smollm-360m at full width (random weights from
    seed 0): speculative streams with impl="cuda" (verify on
    paged_prefill.cu, draft and plain decode on paged_decode.cu), with the
    oracle and with the reduced draft, held to the plain non-speculative
    impl="torch" streams under phase 5's near-tie rule."""
    from repro_torch.launch.serve import LMBackend
    from repro_torch.models import model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = model.init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                        torch.device("cuda"))
    fixed = lambda c, f, a: (f(*a), 0.05)          # noqa: E731
    plain = LMBackend(cfg32, capacity=CAPACITY, params=params, device="cuda",
                      impl="torch")
    want, _, _, wall, reqs = serve(torch, plain, trace(cfg.vocab_size),
                                   executor=fixed)
    log(f"  impl=torch, no speculation: wall {wall:.4f} s")
    for name, draft in (("oracle", "oracle"),
                        ("draft", full_vocab_draft(cfg32))):
        b = LMBackend(cfg32, capacity=CAPACITY, params=params, device="cuda",
                      impl="cuda", draft=draft)
        got, rep, _, wall, _ = serve(torch, b, trace(cfg.vocab_size),
                                     executor=fixed, speculative=True,
                                     spec_k=VERIFY_K)
        log(f"  impl=cuda, draft={name}: wall {wall:.4f} s, "
            f"{rep.spec_rounds} rounds, acceptance "
            f"{rep.acceptance_rate:.4f}")
        hold_to_plain(torch, plain, reqs, got, want, PROMPT_PAD)
    del params


DISAGG = dict(fleet=["basic", "large"], clone_type="basic", disagg=True,
              disagg_min_prompt=1, disagg_prefill_type="large",
              max_secondaries=2)


def disagg_serving(torch, cfg):
    """Phase 14: smollm-360m at full width in bf16, prompts prefilled on a
    "large" partner clone and handed to the "basic" decode clone's pool,
    uncompressed and through the int8 pair, each closure run once and
    timed on a fixed timeline (both runs schedule alike).  Every request
    must finish, at least one handoff must happen, paged_prefill (the
    partner's chunks) and paged_decode must launch, and the compressed
    run must bill exactly the int8 block bytes (payload + per-head scales:
    a bf16 block's half plus its scales) for the same handoffs.  Returns
    the launches per run."""
    from repro_torch.core.venues import kv_block_bytes
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import LMBackend
    backend = LMBackend(cfg, capacity=CAPACITY, device="cuda")
    out, reps = {}, {}
    for compress in (False, True):
        name = "int8" if compress else "bf16"
        steps = []
        ops.reset_launches()
        toks, rep, h, wall, _ = serve(
            torch, backend, trace(cfg.vocab_size),
            executor=timed_fixed(torch, steps), disagg_compress=compress,
            **DISAGG)
        got = dict(ops.launches)
        n_tok = sum(len(t) for t in toks.values())
        log(f"  handoff {name}: {rep.disagg_handoffs} handoffs, "
            f"{rep.disagg_colocated} co-located, {rep.disagg_fallbacks} "
            f"fallbacks, kv_transfer_bytes {rep.kv_transfer_bytes:.0f} "
            f"({rep.kv_transfer_s * 1e6:.3f} us on the link); wall "
            f"{wall:.4f} s for {n_tok} tokens; closures (count, median ms) "
            f"{step_times(steps)}; launches {got}")
        if rep.disagg_handoffs < 1:
            fail(f"disagg ({name}): no handoff")
        for kname in ("paged_prefill", "paged_decode"):
            if got[kname] <= 0:
                fail(f"disagg ({name}): {kname} never launched")
        out[name], reps[name] = got, rep
    raw, quant = (kv_block_bytes(cfg, BLOCK, quantized=q)
                  for q in (False, True))
    u, c = reps["bf16"], reps["int8"]
    if not (c.disagg_handoffs == u.disagg_handoffs
            and 0 < c.kv_transfer_bytes * raw == u.kv_transfer_bytes * quant):
        fail(f"disagg: int8 handoff billed {c.kv_transfer_bytes} bytes, want "
             f"{u.kv_transfer_bytes} x {quant} / {raw}")
    log(f"  int8 / bf16 handoff bytes "
        f"{c.kv_transfer_bytes / u.kv_transfer_bytes:.4f} ({quant} / {raw} "
        "per block)")
    return out


def disagg_parity(torch, cfg):
    """Phase 15: float32 smollm-360m at full width: uncompressed disagg
    streams with impl="cuda" held to the co-located impl="torch" streams
    under phase 5's near-tie rule; the int8 handoff (impl="cuda") must
    finish every request at under half the uncompressed wire bytes (the
    reference test's bound: float32 blocks, so int8 is a quarter plus
    scales)."""
    from repro_torch.launch.serve import LMBackend
    from repro_torch.models import model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = model.init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                        torch.device("cuda"))
    fixed = lambda c, f, a: (f(*a), 0.05)          # noqa: E731
    plain = LMBackend(cfg32, capacity=CAPACITY, params=params, device="cuda",
                      impl="torch")
    want, _, _, wall, reqs = serve(torch, plain, trace(cfg.vocab_size),
                                   executor=fixed)
    log(f"  impl=torch, co-located: wall {wall:.4f} s")
    cuda = LMBackend(cfg32, capacity=CAPACITY, params=params, device="cuda",
                     impl="cuda")
    reps = {}
    for compress in (False, True):
        got, reps[compress], _, wall, _ = serve(
            torch, cuda, trace(cfg.vocab_size), executor=fixed,
            disagg_compress=compress, **DISAGG)
        log(f"  impl=cuda, disagg {'int8' if compress else 'float32'}: "
            f"wall {wall:.4f} s, {reps[compress].disagg_handoffs} handoffs, "
            f"kv_transfer_bytes {reps[compress].kv_transfer_bytes:.0f}")
        if not compress:
            hold_to_plain(torch, plain, reqs, got, want, PROMPT_PAD)
    if not 0 < reps[True].kv_transfer_bytes \
            < 0.5 * reps[False].kv_transfer_bytes:
        fail(f"disagg: int8 handoff bytes {reps[True].kv_transfer_bytes} not "
             f"under half of {reps[False].kv_transfer_bytes}")
    del params


# phases 16-17: the chaos fleet.  Six slots per engine split phase 4's
# trace over the primary (6 requests) and the spare (2), so a survivor has
# room to take migrated slots; every fault lands on the primary (cid 0),
# which serves most of the trace; the clone link is NVLink, so a hedge's
# KV context crosses it in time to race the straggler (over the default
# wifi link a full-width context takes longer than the slowed step)
CHAOS = dict(max_batch=6, max_secondaries=3, hedge_min_samples=4,
             link="nvlink")
CHAOS_CID = 0


def chaos_faults(span):
    """(name, fault dicts, hedge_factor) of the chaos runs, the fault
    times relative to the faultless run's makespan ``span``."""
    at = dict(cid=CHAOS_CID)
    return [("drain", [dict(at=0.5 * span, kind="drain", duration=2.0,
                            **at)], 0.0),
            ("kill", [dict(at=0.5 * span, kind="kill", duration=2.0, **at)],
             0.0),
            ("permanent_kill", [dict(at=0.5 * span, kind="kill", **at)], 0.0),
            ("slow_hedged", [dict(at=0.6 * span, kind="slow",
                                  duration=0.4 * span, factor=40.0, **at)],
             2.0)]


def block_leaks(h):
    """Block accounting of every surviving pool: each block's refcount
    equals its slot-table references, and free + cached-free + live
    blocks are every allocatable block.  Returns the faults found."""
    import numpy as np
    bad = []
    for cid, kv in h._kv_pools.items():
        refs = np.zeros(kv.num_blocks, np.int64)
        for slot in range(kv.max_slots):
            for j in range(int(kv.n_blocks_of[slot])):
                refs[kv.tables[slot, j]] += 1
        if (refs[1:] != kv.ref[1:]).any():
            bad.append(f"clone {cid}: refcounts differ from table references")
        live = set(np.nonzero(kv.ref)[0].tolist())
        if set(kv._free_blocks) | set(kv._cached_free) | live \
                != set(range(1, kv.num_blocks)):
            bad.append(f"clone {cid}: free + cached + live != all blocks")
    return bad


def chaos_run(torch, backend, faults, hedge, executor, reqs=None, **kw):
    """One run on the chaos fleet (one spare RUNNING clone) under
    ``faults``; the slots that migrate and the requests that restore are
    recorded on the handler.  Fails on a leaked block."""
    from repro_torch.core.clones import CloneState
    from repro_torch.core.faults import CloneFault

    def setup(h):
        h.pool.provision(h.clone_type, 1, state=CloneState.RUNNING)
        h.moved, h.lost = [], []
        migrate, requeue = h._try_migrate, h._requeue_lost

        def try_migrate(src, slot, st, engines):
            ok = migrate(src, slot, st, engines)
            if ok:
                h.moved.append(st.req.rid)
            return ok

        def requeue_lost(req):
            h.lost.append(req.rid)
            requeue(req)
        h._try_migrate, h._requeue_lost = try_migrate, requeue_lost

    out = serve(torch, backend, reqs or trace(backend.cfg.vocab_size),
                executor=executor, setup=setup, hedge_factor=hedge,
                faults=[CloneFault(**f) for f in faults] or None,
                **CHAOS, **kw)
    bad = block_leaks(out[2])
    if bad:
        fail(f"chaos: {bad}")
    return out


def chaos_serving(torch, cfg):
    """Phase 16: smollm-360m at full width in bf16 on the chaos fleet,
    phase 4's trace and paged settings, each closure run once and timed on
    a fixed timeline (fault times and hedges land alike in every run):
    faultless, drain, kill and permanent kill of the primary at half the
    makespan, and a 40x slowdown at 0.6 of it with hedging.  Every
    request finishes, no block leaks, the drain migrates, the kills
    restore and do not migrate, the hedge fires and wins, paged_decode
    and paged_prefill launch in every recovery run, and each stream is
    held to the faultless one under the near-tie rule (bfloat16 bound:
    the plain path's error against float32); the migrated streams that
    stay exactly equal are counted.  Then one gated run: an interactive
    tenant with a deadline, a batch tenant and an exact repeat of a served
    prompt, which must come back from the gateway's cache.  Returns the
    launches per run."""
    from repro_torch.core.gateway import StreamingGateway, TenantPolicy
    from repro_torch.core.scheduler import ServeRequest
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import LMBackend
    from repro_torch.models import model
    backend = LMBackend(cfg, capacity=CAPACITY, device="cuda")
    plain = LMBackend(cfg, capacity=CAPACITY, params=backend.params,
                      device="cuda", impl="torch")
    # the bfloat16 weights in float32: the near-tie rule's truth
    truth = LMBackend(dataclasses.replace(cfg, dtype="float32"),
                      capacity=CAPACITY, device="cuda", impl="torch",
                      params=model.tree_map(lambda t: t.float(),
                                            backend.params))
    out, base = {}, None
    for name, faults, hedge in [("faultless", [], 0.0)] + chaos_faults(0):
        if base is not None:
            faults = [f for n, f, _ in chaos_faults(base[1].makespan_s)
                      if n == name][0]
        steps = []
        ops.reset_launches()
        toks, rep, h, wall, reqs = chaos_run(
            torch, backend, faults, hedge, timed_fixed(torch, steps))
        got = dict(ops.launches)
        log(f"  {name}: makespan {rep.makespan_s:.4f} s (virtual), wall "
            f"{wall:.4f} s; faults {rep.faults_injected}, migrated "
            f"{rep.recoveries_migrated} {sorted(h.moved)}, restored "
            f"{rep.recoveries_restored} {sorted(set(h.lost))}, hedges "
            f"{rep.hedges_fired}/{rep.hedge_wins} won, breaker opens "
            f"{rep.breaker_opens}; closures (count, median ms) "
            f"{step_times(steps)}; launches {got}")
        if name == "faultless":
            base = (toks, rep)
            out[name] = got
            continue
        same = hold_to_plain(torch, plain, reqs, toks, base[0], PROMPT_PAD,
                             truth=truth)
        if name == "drain":
            if rep.recoveries_migrated < 1:
                fail("chaos (drain): no slot migrated")
            equal = sum(toks[r] == base[0][r] for r in h.moved)
            log(f"  drain: {equal}/{len(h.moved)} migrated streams exactly "
                f"equal to the faultless run's ({same}/{len(toks)} in all)")
        elif name in ("kill", "permanent_kill"):
            if rep.recoveries_restored < 1 or rep.recoveries_migrated != 0:
                fail(f"chaos ({name}): restored {rep.recoveries_restored}, "
                     f"migrated {rep.recoveries_migrated}")
        elif rep.hedges_fired < 1 or rep.hedge_wins < 1:
            fail(f"chaos (slow): hedges {rep.hedges_fired}/{rep.hedge_wins}")
        if rep.faults_injected != 1:
            fail(f"chaos ({name}): {rep.faults_injected} faults fired")
        if name != "slow_hedged":
            for kname in ("paged_decode", "paged_prefill"):
                if got[kname] <= 0:
                    fail(f"chaos ({name}): {kname} never launched")
        out[name] = got

    # the gated run: every other request interactive with a deadline, and
    # an exact repeat of request 3 after the trace has been served
    reqs = trace(cfg.vocab_size)
    for r in reqs:
        r.tenant = r.slo = "interactive" if r.rid % 2 == 0 else "batch"
        r.deadline_s = 5.0 if r.rid % 2 == 0 else None
    reqs.append(ServeRequest(8, reqs[3].prompt.copy(), NEW_TOKENS,
                             arrival_t=base[1].makespan_s + 0.5,
                             tenant="batch", slo="batch"))
    gw = StreamingGateway(tenants={"interactive": TenantPolicy(weight=4.0),
                                   "batch": TenantPolicy()})
    ops.reset_launches()
    toks, rep, _, wall, _ = chaos_run(torch, backend, [], 0.0,
                                      timed_fixed(torch, []), reqs=reqs,
                                      gateway=gw)
    got = dict(ops.launches)
    cached = [c.rid for c in rep.completions if c.cached]
    log(f"  gated: {rep.summary()}")
    log(f"  gated: slo_attainment {rep.slo_attainment}, goodput_tps "
        f"{rep.goodput_tps:.4f} (virtual), per tenant {rep.per_tenant}, "
        f"cached {cached}, wall {wall:.4f} s; launches {got}")
    if cached != [8] or toks[8] != toks[3]:
        fail(f"gated: the repeat was not served from the cache ({cached})")
    if rep.gateway_rejected or rep.gateway_shed:
        fail(f"gated: rejected {rep.gateway_rejected}, shed "
             f"{rep.gateway_shed}")
    out["gated"] = got
    return out


def chaos_parity(torch, cfg):
    """Phase 17: float32 smollm-360m at full width (random weights from
    seed 0) on the chaos fleet: the drain, kill and hedged runs with
    impl="cuda" held to the faultless impl="torch" streams under phase
    5's near-tie rule."""
    from repro_torch.launch.serve import LMBackend
    from repro_torch.models import model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = model.init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                        torch.device("cuda"))
    fixed = lambda c, f, a: (f(*a), 0.05)          # noqa: E731
    plain = LMBackend(cfg32, capacity=CAPACITY, params=params, device="cuda",
                      impl="torch")
    want, rep, _, wall, reqs = chaos_run(torch, plain, [], 0.0, fixed)
    log(f"  impl=torch, faultless: wall {wall:.4f} s, makespan "
        f"{rep.makespan_s:.4f} s (virtual)")
    cuda = LMBackend(cfg32, capacity=CAPACITY, params=params, device="cuda",
                     impl="cuda")
    for name, faults, hedge in chaos_faults(rep.makespan_s):
        if name == "permanent_kill":
            continue
        got, r, h, wall, _ = chaos_run(torch, cuda, faults, hedge, fixed)
        log(f"  impl=cuda, {name}: wall {wall:.4f} s, migrated "
            f"{r.recoveries_migrated} {sorted(h.moved)}, restored "
            f"{r.recoveries_restored}, hedges {r.hedges_fired}/"
            f"{r.hedge_wins}")
        hold_to_plain(torch, plain, reqs, got, want, PROMPT_PAD)
    del params


# --------------------------------------------------------------------------- #
# phases 18-19: the offload path (ExecutionController + ServingEngine)
# --------------------------------------------------------------------------- #
def offload_trace(vocab):
    """8 requests of 12-96 prompt tokens (both ends included), 16 new
    tokens each: one ``ServingEngine`` batch (prompts right-padded to 96)."""
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(14)
    lens = [12, PROMPT_PAD] + [int(x) for x in
                               rng.integers(13, PROMPT_PAD, 6)]
    return [Request(i, rng.integers(0, vocab, n, dtype=np.int32), NEW_TOKENS)
            for i, n in enumerate(lens)]


def engine_serve(torch, backend, placement, capacity=CAPACITY):
    """One batch of ``offload_trace`` through a fresh ``ServingEngine`` on
    ``backend`` at ``placement``.  Fails unless every request finishes its
    budget, every prefill call (each shard, each Venue re-run) launched
    flash_attention once per attention layer and nothing else launched
    it, every ExecutionResult time is positive and every Venue timing
    synchronised ``backend``'s device.  Returns (streams, engine, wall
    seconds, flash launches per prefill call, results)."""
    from repro_torch.core import venues
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServingEngine
    eng = ServingEngine(backend.cfg, capacity=capacity, backend=backend)
    prefill, execute, sync = eng.rm_prefill.fn, eng.ec.execute, venues._sync
    per_call, results, syncs = [], [], []

    def counted_prefill(params, tokens):
        before = ops.launches["flash_attention"]
        out = prefill(params, tokens)
        per_call.append(ops.launches["flash_attention"] - before)
        return out

    def recorded(rm, *args, **kw):
        res = execute(rm, *args, **kw)
        results.append((rm.name, res))
        return res

    def counted_sync(device):
        syncs.append(device.type)
        sync(device)

    eng.rm_prefill.fn, eng.ec.execute = counted_prefill, recorded
    venues._sync = counted_sync
    reqs = offload_trace(backend.cfg.vocab_size)
    try:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = eng.serve_batch(reqs, **PLACEMENTS[placement])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        venues._sync = sync
    got = dict(ops.launches)
    toks = {c.rid: c.tokens for c in comps}
    if sorted(toks) != list(range(len(reqs))) or any(
            len(t) != NEW_TOKENS or not all(0 <= x < backend.cfg.vocab_size
                                            for x in t)
            for t in toks.values()):
        fail(f"offload ({placement}): streams {toks}")
    n_attn = backend.cfg.layer_kinds().count("attn")
    k = PLACEMENTS[placement].get("n_clones", 1)
    if backend.ctx.impl == "cuda" and (
            len(per_call) < k or set(per_call) != {n_attn}
            or got["flash_attention"] != sum(per_call)):
        fail(f"offload ({placement}): flash launches per prefill call "
             f"{per_call}, {got['flash_attention']} in all (want {n_attn} "
             f"in each of at least {k} calls)")
    if any(r.time_s <= 0 for _, r in results):
        fail(f"offload ({placement}): non-positive venue time")
    if not syncs or set(syncs) != {backend.device.type}:
        fail(f"offload ({placement}): Venue synchronised {set(syncs)}")
    return toks, eng, wall, per_call, results


def offload_serving(torch, cfg):
    """Phase 18: smollm-360m at full width in bf16 through the batch
    ``ServingEngine`` in four placements (see ``PLACEMENTS``), then the
    capacity-512 engine that must escalate 4 times.  Returns the flash
    launches of all its serves and the streams per placement."""
    import numpy as np
    from repro_torch.launch.serve import LMBackend
    backend = LMBackend(cfg, capacity=CAPACITY, device="cuda")
    log(f"  controller device {backend.device}; bf16 cache "
        f"{backend.cache_mem_bytes(MAX_BATCH) / 1e6:.1f} MB at capacity "
        f"{CAPACITY}")
    streams, flash = {}, 0
    for placement in PLACEMENTS:
        toks, eng, wall, per_call, results = engine_serve(torch, backend,
                                                          placement)
        flash += sum(per_call)
        streams[placement] = toks
        pre = [r for name, r in results if name == "serve_prefill"][0]
        dec = [r for name, r in results if name == "serve_decode"]
        log(f"  {placement}: wall {wall:.4f} s for "
            f"{MAX_BATCH * NEW_TOKENS} tokens; prefill on {pre.venue} "
            f"{pre.time_s:.4f} s (virtual; overhead {pre.overhead_s:.4f} s, "
            f"energy {pre.energy_j:.4f} J), decode on "
            f"{sorted({r.venue for r in dec})} median "
            f"{float(np.median([r.time_s for r in dec])):.4f} s (virtual); "
            f"stats {eng.stats}; decisions {eng.ec.decisions}; flash "
            f"launches per prefill call {per_call}")
        want_off = {"local": 0, "remote": 1 + NEW_TOKENS,
                    "split": 1 + NEW_TOKENS}.get(placement)
        if want_off is not None and eng.stats["offloaded"] != want_off:
            fail(f"offload ({placement}): offloaded {eng.stats['offloaded']}"
                 f", want {want_off}")
        if eng.stats["escalations"] != 0:
            fail(f"offload ({placement}): escalated at capacity {CAPACITY}")
        if placement == "policy" and pre.venue == "phone":
            fail("offload (policy): first encounter stayed local over "
                 "wifi-local")
    for placement in list(PLACEMENTS)[1:]:
        same = sum(streams[placement][r] == streams["local"][r]
                   for r in streams["local"])
        log(f"  {placement}: {same}/{MAX_BATCH} bf16 streams bitwise equal "
            f"to local")
    big = LMBackend(cfg, capacity=ESCALATE_CAPACITY, params=backend.params,
                    device="cuda")
    toks, eng, wall, per_call, results = engine_serve(
        torch, big, "remote", capacity=ESCALATE_CAPACITY)
    flash += sum(per_call)
    pre = [r for name, r in results if name == "serve_prefill"][0]
    log(f"  capacity {ESCALATE_CAPACITY}: bf16 cache "
        f"{big.cache_mem_bytes(MAX_BATCH) / 1e6:.1f} MB; prefill on "
        f"{pre.venue} after {pre.escalations} escalations, "
        f"{pre.time_s:.4f} s (virtual); stats {eng.stats}; wall "
        f"{wall:.4f} s")
    if eng.stats["escalations"] != 4 or pre.venue != "x8large":
        fail(f"offload: capacity {ESCALATE_CAPACITY} escalated "
             f"{eng.stats['escalations']} times to {pre.venue} (want 4 to "
             "x8large)")
    del big, backend
    remote_workload(torch)
    return flash


def remote_workload(torch):
    """Phase 18, second part: a ``@remote`` workload (n x 50 steps of a
    64 x 64 float32 matmul and tanh on the card) under a controller on
    wifi-local, 3g and nvlink: local and remote virtual-clock time and
    energy, and the boundary input value (the least n that offloading
    makes faster); 3G's must be at least WiFi's."""
    from repro_torch.core import (ExecutionController, Policy, remote,
                                  set_default_controller)

    @remote(size=lambda n: n, name="smoke_heavy")
    def heavy(n):
        x = torch.full((64, 64), 1.0 / n, device="cuda")
        acc = x
        for i in range(n * 50):
            acc = torch.tanh(acc @ x + i)
        return acc.sum()

    rm = heavy.remoteable
    bivs = {}
    for link in ("wifi-local", "3g", "nvlink"):
        ec = ExecutionController(policy=Policy.EXEC_TIME, link=link)
        set_default_controller(ec)
        try:
            value = float(heavy(4))         # routed through the controller
        finally:
            set_default_controller(None)
        bivs[link] = None
        for n in (1, 2, 4, 8, 16, 32, 64):
            loc = ec.execute(rm, n, force="local")
            rem = ec.execute(rm, n, force="remote")
            log(f"  @remote {link} n={n}: local {loc.time_s:.6g} s "
                f"{loc.energy_j:.6g} J, remote on {rem.venue} "
                f"{rem.time_s:.6g} s {rem.energy_j:.6g} J (virtual)")
            if rem.time_s < loc.time_s:
                bivs[link] = n
                break
        log(f"  @remote {link}: boundary input value {bivs[link]}; "
            f"transparent call value {value:.6g}, decisions {ec.decisions}")
    if bivs["wifi-local"] is None or bivs["3g"] is None \
            or bivs["3g"] < bivs["wifi-local"]:
        fail(f"@remote: boundary input values {bivs}")


def offload_parity(torch, cfg):
    """Phase 19: phase 18's placements in float32 (random weights from
    seed 0) with impl="cuda" held to impl="torch", and every placement
    held to the local one, under phase 5's near-tie rule.  Returns the
    impl="cuda" flash launches."""
    from repro_torch.launch.serve import LMBackend
    from repro_torch.models import model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = model.init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                        torch.device("cuda"))
    backends = {impl: LMBackend(cfg32, capacity=CAPACITY, params=params,
                                device="cuda", impl=impl)
                for impl in ("cuda", "torch")}
    streams, flash = {}, 0
    for impl, backend in backends.items():
        for placement in PLACEMENTS:
            toks, eng, wall, per_call, results = engine_serve(
                torch, backend, placement)
            streams[impl, placement] = toks
            if impl == "cuda":
                flash += sum(per_call)
            pre = [r for name, r in results if name == "serve_prefill"][0]
            log(f"  impl={impl} {placement}: wall {wall:.4f} s, prefill on "
                f"{pre.venue} ({pre.escalations} escalations), stats "
                f"{eng.stats}")
    reqs = offload_trace(cfg.vocab_size)
    plain = backends["torch"]
    for placement in PLACEMENTS:
        log(f"  {placement}: impl=cuda vs impl=torch")
        hold_to_plain(torch, plain, reqs, streams["cuda", placement],
                      streams["torch", placement], PROMPT_PAD)
        if placement != "local":
            log(f"  {placement}: impl=cuda vs impl=cuda local")
            hold_to_plain(torch, plain, reqs, streams["cuda", placement],
                          streams["cuda", "local"], PROMPT_PAD)
    del backends, params
    return flash


# --------------------------------------------------------------------------- #
# phases 20-22: mixture-of-experts serving
# --------------------------------------------------------------------------- #
def moe_trace(vocab):
    """8 requests of 16-96 prompt tokens (both ends included), arriving
    together: one cohort of MAX_BATCH rows, prompts padded to 96."""
    import numpy as np
    from repro_torch.core.scheduler import ServeRequest
    rng = np.random.default_rng(14)
    lens = [16, PROMPT_PAD] + [int(x) for x in rng.integers(17, PROMPT_PAD,
                                                            6)]
    return [ServeRequest(i, rng.integers(0, vocab, n, dtype=np.int32),
                         NEW_TOKENS, arrival_t=0.0)
            for i, n in enumerate(lens)]


def moe_parity(torch, cfg, depth, capacity, trace_fn, **kw):
    """Phases 21 and 22's parity: float32 ``cfg`` at full width on
    ``depth`` layers, drawn at that depth (random weights from seed 0:
    the whole model is never built), impl="cuda" vs impl="torch" under the
    near-tie rules, routing included."""
    from repro_torch.models import model
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=depth)
    params = model.init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                        torch.device("cuda"))
    log(f"  {depth} of {cfg.n_layers} layers, {model.n_params(cfg32)} "
        "float32 parameters")
    same = parity(torch, cfg32, params, capacity, trace_fn, PROMPT_PAD, **kw)
    del params
    return same


def mixtral_serving(torch, mcfg):
    """Phase 22: mixtral-8x7b at full width on its first MIXTRAL_LAYERS
    layers in bf16 through the cohort mode (the 4096-token sliding window
    keeps it off the paged pool), each step run once and timed: every
    request finishes and each cohort prefill launches flash once per
    layer (asserted); decode is plain ops.  Returns the launch counts."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import LMBackend
    cfg = dataclasses.replace(mcfg, n_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    backend = LMBackend(cfg, capacity=MIXTRAL_CAPACITY, device="cuda")
    torch.cuda.synchronize()
    log(f"  {MIXTRAL_LAYERS} of {mcfg.n_layers} layers: "
        f"{weight_bytes(backend) / 1e9:.2f} GB of weights drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    steps = []
    ops.reset_launches()
    toks, rep, _, wall, _ = serve(
        torch, backend, moe_trace(cfg.vocab_size),
        executor=timed_once(torch, steps), kv="contiguous", decode_window=1)
    got = dict(ops.launches)
    n_tok = sum(len(t) for t in toks.values())
    pre = [dt for name, dt in steps if name == "prefill"]
    dec = [dt for name, dt in steps if name == "decode"]
    log(f"  {rep.summary()}")
    log(f"  wall {wall:.4f} s for {n_tok} tokens ({n_tok / wall:.3f} tok/s, "
        f"each step run once); cohort prefill {len(pre)} x "
        f"{1e3 * float(np.mean(pre)):.3f} ms, decode steps {len(dec)} "
        f"(median {1e3 * float(np.median(dec)):.3f} ms, min "
        f"{1e3 * min(dec):.3f} ms); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {got}")
    want = {"paged_decode": 0, "paged_prefill": 0, "rwkv6_scan": 0,
            "rglru_scan": 0, "flash_attention": len(pre) * MIXTRAL_LAYERS}
    if not pre or got != want:
        fail(f"mixtral launches {got} (prefills {len(pre)}), want {want}")
    return got


# --------------------------------------------------------------------------- #
# phases 23-25: training
# --------------------------------------------------------------------------- #
def device_batch(batch):
    return {k: v.to("cuda") for k, v in batch.items()}


def timed_steps(torch, step_fn, times):
    """``step_fn`` timed on the host clock between device synchronisations
    (seconds appended to ``times``)."""
    def run(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    return run


def check_losses(name, losses):
    import math
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"{name}: losses {losses}")


def train_phase(torch, cfg):
    """Phase 23: ``cfg`` at full width and depth in bf16 through
    ``FleetTrainer`` on the card: TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ tokens, a checkpoint every TRAIN_CKPT_EVERY steps, a fault
    at every TRAIN_FAIL_EVERY-th step check.  Then a second trainer over
    the same directory resumes and runs only TRAIN_RESUME_STEPS more."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core.faults import FaultPlan
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import FleetTrainer
    from repro_torch.models import model
    from repro_torch.optim.adamw import OptConfig
    opt = OptConfig(warmup_steps=TRAIN_WARMUP)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.reset_peak_memory_stats()
        data = DataConfig(TRAIN_BATCH, TRAIN_SEQ)
        t1 = FleetTrainer(cfg, steps_total=TRAIN_STEPS, data_cfg=data,
                          opt_cfg=opt, ckpt_dir=ckpt_dir,
                          ckpt_every=TRAIN_CKPT_EVERY,
                          fault_plan=FaultPlan(fail_every=TRAIN_FAIL_EVERY),
                          device="cuda")
        state = t1.init_state()
        before = [x.clone() for x in model._tree_leaves(state["params"])]
        times = []
        t1.step_fn = timed_steps(torch, t1.step_fn, times)
        t0 = time.perf_counter()
        state = t1.run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = t1.report
        check_losses("train", rep.losses)
        if rep.restarts < 1 or rep.steps_done != TRAIN_STEPS \
                or int(state["opt"]["step"]) != TRAIN_STEPS:
            fail(f"train: restarts {rep.restarts}, steps {rep.steps_done}, "
                 f"opt step {int(state['opt']['step'])}")
        still = [i for i, (a, b) in enumerate(zip(
            before, model._tree_leaves(state["params"])))
                 if torch.equal(a, b)]
        if still:
            fail(f"train: parameter leaves {still} never moved")
        del before
        med = float(np.median(times))
        log(f"  {model.n_params(cfg)} parameters; {rep.steps_done} steps, "
            f"{rep.restarts} restart(s) from the checkpoint; losses "
            f"{[round(x, 4) for x in rep.losses]}")
        log(f"  step time median {1e3 * med:.1f} ms (min "
            f"{1e3 * min(times):.1f}, max {1e3 * max(times):.1f}; "
            f"{TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s); run wall "
            f"{wall:.2f} s with {TRAIN_STEPS // TRAIN_CKPT_EVERY + 1} "
            f"checkpoint saves; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        # the resumed trainer's first step starts from the saved state: its
        # loss is the first trainer's final state's forward on the same
        # batch, recorded for autograd as a step's is (without autograd the
        # bf16 products take aten::mm.dtype, other sums); a forward has no
        # atomics: equal in practice, held to RESUME_RTOL
        live = model.tree_map(lambda t: t.detach().requires_grad_(),
                              state["params"])
        want, _ = model.forward(cfg, live, t1.batch(TRAIN_STEPS), t1.ctx,
                                "train")
        want = float(want.detach())
        del live
        del state
        t2 = FleetTrainer(cfg, steps_total=TRAIN_STEPS + TRAIN_RESUME_STEPS,
                          data_cfg=data, opt_cfg=opt, ckpt_dir=ckpt_dir,
                          ckpt_every=TRAIN_CKPT_EVERY, device="cuda")
        state = t2.run()
        r2 = t2.report
        check_losses("resume", r2.losses)
        got = r2.losses[0]
        if r2.restarts != 1 or r2.steps_done != TRAIN_RESUME_STEPS \
                or int(state["opt"]["step"]) != TRAIN_STEPS \
                + TRAIN_RESUME_STEPS or abs(got - want) > RESUME_RTOL * abs(
                    want):
            fail(f"resume: restarts {r2.restarts}, steps {r2.steps_done}, "
                 f"opt step {int(state['opt']['step'])}, first loss {got} "
                 f"vs {want}")
        log(f"  resume: {r2.steps_done} remaining steps from step "
            f"{TRAIN_STEPS}, opt step {int(state['opt']['step'])}; first "
            f"loss {got!r} vs the saved state's {want!r} "
            f"(|diff| {abs(got - want):.3e}); losses "
            f"{[round(x, 4) for x in r2.losses]}")
        del state
        return {"step_ms": 1e3 * med, "peak_gb":
                torch.cuda.max_memory_allocated() / 1e9}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def train_parity_phase(torch, cfg, rcfg, gcfg):
    """Phase 24: (a) float32 ``cfg`` at full width on TRAIN_PARITY_LAYERS
    layers, TRAIN_PARITY_STEPS train steps on the card and on the host
    from the same weights and batches: losses and grad norms within
    TRAIN_PARITY_RTOL; (b) the train-mode loss at impl="cuda" against
    impl="torch" under no_grad for smollm-360m, rwkv6-7b and
    recurrentgemma-2b at full width (KERNEL_LOSS_TOL), counting the
    kernels' launches; (c) impl="cuda" with grad enabled raises.  Returns
    the launches of (b) by kernel."""
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.models import model
    from repro_torch.optim import adamw
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=TRAIN_PARITY_LAYERS)
    params = model.init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                         torch.device("cuda"))
    pipe = Pipeline(cfg32, DataConfig(*TRAIN_PARITY_SHAPE))
    runs = {}
    for dev in ("cuda", "cpu"):
        p = model.tree_map(lambda t: t.to(dev, copy=True), params)
        step = S.build_train_step(cfg32, adamw.OptConfig(),
                                  S.make_context(dev))
        state = {"params": p, "opt": adamw.init(p)}
        out = []
        t0 = time.perf_counter()
        for i in range(TRAIN_PARITY_STEPS):
            batch = {k: v.to(dev) for k, v in pipe.batch(i).items()}
            state, m = step(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = out
        log(f"  (a) {dev}: (loss, grad norm) per step {out} in "
            f"{time.perf_counter() - t0:.2f} s")
        del state, p
    del params
    worst = max(abs(a - b) / abs(b) for x, y in zip(runs["cuda"], runs["cpu"])
                for a, b in zip(x, y))
    log(f"  (a) {TRAIN_PARITY_LAYERS} of {cfg.n_layers} layers, batch "
        f"{TRAIN_PARITY_SHAPE}: largest relative difference card vs host "
        f"{worst:.3e} (tolerance {TRAIN_PARITY_RTOL})")
    if worst > TRAIN_PARITY_RTOL:
        fail(f"train parity: card {runs['cuda']} vs host {runs['cpu']}")

    launched = {}
    for c, depth in ((cfg, cfg.n_layers), (rcfg, KERNEL_TRAIN_RWKV_LAYERS),
                     (gcfg, gcfg.n_layers)):
        c32 = dataclasses.replace(c, dtype="float32", n_layers=depth)
        params = model.init(c32, torch.Generator(device="cuda").manual_seed(0),
                            torch.device("cuda"))
        batch = device_batch(Pipeline(c32, DataConfig(*KERNEL_TRAIN_SHAPE))
                             .batch(0))
        with torch.no_grad():
            ops.reset_launches()
            got, gm = model.forward(c32, params, batch,
                                    S.make_context("cuda", impl="cuda"),
                                    "train")
            got = float(got)
            counts = {k: v for k, v in ops.launches.items() if v}
            want, _ = model.forward(c32, params, batch,
                                    S.make_context("cuda"), "train")
            want = float(want)
        n_attn = sum(k == "attn" for k in c32.layer_kinds())
        expect = {"flash_attention": n_attn,
                  "rwkv6_scan": sum(k == "rwkv" for k in c32.layer_kinds()),
                  "rglru_scan": sum(k == "rglru" for k in c32.layer_kinds())}
        expect = {k: v for k, v in expect.items() if v}
        log(f"  (b) {c.name} {depth} of {c.n_layers} layers, batch "
            f"{KERNEL_TRAIN_SHAPE}: loss impl=cuda {got!r} impl=torch "
            f"{want!r} (|diff| {abs(got - want):.3e}); launches {counts}")
        if counts != expect or abs(got - want) > KERNEL_LOSS_TOL:
            fail(f"{c.name}: train loss {got} vs {want}, launches {counts} "
                 f"(want {expect})")
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v
        if c is cfg:
            live = model.tree_map(lambda t: t.detach().requires_grad_(),
                                  params)
            try:
                model.forward(c32, live, batch,
                              S.make_context("cuda", impl="cuda"), "train")
            except RuntimeError as e:
                log(f"  (c) impl=cuda with grad enabled raises: {e}")
            else:
                fail("impl=cuda with grad enabled did not raise")
            del live
        del params, batch
        torch.cuda.empty_cache()
    return launched


def frontend_phase(torch):
    """Phase 25: hubert-xlarge (audio stub, masked loss) and paligemma-3b
    (vision stub, prefix-LM) at full width and depth in bf16 with float32
    optimizer state: FRONTEND_STEPS train steps each, then one paligemma
    forward(mode="prefill") with patches; then paligemma in float32 on 2
    layers: moving the last patch changes the first patch's output,
    moving the last text token changes no position before it."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import steps as S
    from repro_torch.models import layers, model
    from repro_torch.optim import adamw
    ctx = S.make_context("cuda")
    out = {}
    for name, shape in (("hubert-xlarge", HUBERT_SHAPE),
                        ("paligemma-3b", PALIGEMMA_SHAPE)):
        cfg = get_config(name)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                            torch.device("cuda"))
        state = {"params": params, "opt": adamw.init(params)}
        del params
        pipe = Pipeline(cfg, DataConfig(*shape))
        times, losses, masked = [], [], []
        step = timed_steps(torch, S.build_train_step(cfg, adamw.OptConfig(),
                                                     ctx), times)
        for i in range(FRONTEND_STEPS):
            batch = device_batch(pipe.batch(i))
            if "loss_mask" in batch:
                masked.append(int(batch["loss_mask"].sum()))
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        check_losses(name, losses)
        if int(state["opt"]["step"]) != FRONTEND_STEPS:
            fail(f"{name}: opt step {int(state['opt']['step'])}")
        log(f"  {name}: {model.n_params(cfg)} parameters, batch {shape}"
            f"{'' if not masked else f', masked positions {masked}'}; "
            f"losses {[round(x, 4) for x in losses]}; step times "
            f"{[round(1e3 * t, 1) for t in times]} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        out[name] = {"step_ms": 1e3 * float(np.median(times)),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if cfg.frontend == "vision":
            batch = device_batch(pipe.batch(FRONTEND_STEPS))
            with torch.no_grad():
                logits, _ = model.forward(cfg, state["params"], batch, ctx,
                                          "prefill")
            if tuple(logits.shape) != (shape[0], cfg.vocab_size) \
                    or not bool(torch.isfinite(logits).all()):
                fail(f"{name}: prefill logits {tuple(logits.shape)}")
            log(f"  {name}: forward(mode='prefill') with {cfg.n_patches} "
                f"patches: logits {tuple(logits.shape)}, finite")
        del state, step
        torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("paligemma-3b"), dtype="float32",
                              n_layers=2)
    params = model.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        torch.device("cuda"))
    batch = device_batch(Pipeline(cfg, DataConfig(*PALIGEMMA_SHAPE))
                         .batch(0))

    def per_position(b):
        with torch.no_grad():
            x, pos, prefix = model.embed_inputs(cfg, params, b)
            rope = layers.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
            x, _, _ = model.apply_stack(cfg, params, x, ctx, rope, None,
                                        "train", prefix, None)
            return model.unembed(cfg, params, x)

    base = per_position(batch)
    moved = dict(batch, patches=batch["patches"].clone())
    moved["patches"][:, -1] += 10.0
    first = float((per_position(moved)[:, 0] - base[:, 0]).abs().max())
    later = dict(batch, tokens=batch["tokens"].clone())
    later["tokens"][:, -1] = (later["tokens"][:, -1] + 1) % cfg.vocab_size
    after = per_position(later)
    earlier = float((after[:, :-1] - base[:, :-1]).abs().max())
    last = float((after[:, -1] - base[:, -1]).abs().max())
    log(f"  paligemma-3b float32, 2 layers: moving the last patch moves the "
        f"first patch's logits by {first:.3e}; moving the last text token "
        f"moves the earlier positions by {earlier!r} and its own by "
        f"{last:.3e}")
    if not first > 0 or earlier != 0 or not last > 0:
        fail("paligemma prefix-LM attention")
    del params, base, after
    torch.cuda.empty_cache()
    return out



def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def mesh_train_pair(torch, cfg, mesh, times=None):
    """One train step of ``cfg`` (seed 0, pipeline batch 0) mesh-free and
    on ``mesh`` from copies of one state.  Returns (plain metrics, mesh
    metrics, mesh step, mesh state after the step, batch on the mesh)."""
    import copy
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.models import model
    from repro_torch.optim import adamw
    dev = torch.device("cuda")
    opt = adamw.OptConfig(warmup_steps=TRAIN_WARMUP)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    pp = shd.distribute_tree(copy.deepcopy(params),
                             S.param_shardings(cfg, mesh), mesh)
    batch = device_batch(Pipeline(cfg, DataConfig(MESH_BATCH, MESH_SEQ))
                         .batch(0))
    specs = shd.input_shardings(batch, mesh, MESH_BATCH)
    bd = {k: shd.distribute(v, shd.placements(specs[k], mesh), mesh)
          for k, v in batch.items()}
    plain = S.build_train_step(cfg, opt, S.make_context("cuda"))
    step = S.build_train_step(cfg, opt, S.make_context(mesh=mesh))
    state0 = {"params": params, "opt": adamw.init(params)}
    state1 = {"params": pp, "opt": adamw.init(pp)}
    if times is not None:
        plain = timed_steps(torch, plain, times.setdefault("plain", []))
        step = timed_steps(torch, step, times.setdefault("mesh", []))
    _, m0 = plain(state0, batch)
    del state0, params
    state1, m1 = step(state1, bd)
    return m0, m1, step, state1, bd


def mesh_phase(torch, cfg, ocfg):
    """Phase 26 (see the module docstring)."""
    import gc
    import logging
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import compression
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, hlo_analysis as H
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import FleetTrainer
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import model
    from repro_torch.models.context import RunContext
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    out = {}
    try:
        mesh = make_local_mesh()
        # (a) smollm-360m whole, bf16
        times = {}
        torch.cuda.reset_peak_memory_stats()
        m0, m1, step, state, bd = mesh_train_pair(torch, cfg, mesh, times)
        l0, l1 = float(m0["loss"]), float(m1["loss"])
        g0, g1 = float(m0["grad_norm"]), float(m1["grad_norm"])
        log(f"  (a) smollm-360m bf16, {cfg.n_layers} layers, "
            f"{MESH_BATCH} x {MESH_SEQ}: loss mesh {l1!r} / plain {l0!r}; "
            f"grad norm mesh {g1!r} / plain {g0!r}; step "
            f"{1e3 * times['mesh'][0]:.1f} ms mesh (first, DTensor "
            f"propagation cold) / {1e3 * times['plain'][0]:.1f} ms plain")
        check_losses("mesh (a)", [l0, l1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, _ = step(state, bd)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        peak_real = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        (state, _), rec = H.trace(step, state, bd)
        torch.cuda.synchronize()
        real_cost = H.cost_metrics(rec)
        real_mem = H.memory_metrics(rec)
        out["mesh_step_ms"] = 1e3 * warm
        log(f"  (a) second mesh step {1e3 * warm:.1f} ms; device memory "
            f"above the state {peak_real / 1e9:.3f} GB "
            f"(torch.cuda.max_memory_allocated)")
        del state, bd, step
        gc.collect()
        torch.cuda.empty_cache()
        cfg4 = dataclasses.replace(cfg, n_layers=MESH_PARITY_LAYERS,
                                   dtype="float32")
        m0, m1, *_ = mesh_train_pair(torch, cfg4, mesh)
        l0, l1 = float(m0["loss"]), float(m1["loss"])
        g0, g1 = float(m0["grad_norm"]), float(m1["grad_norm"])
        log(f"  (a) float32, {MESH_PARITY_LAYERS} layers: loss {l1!r} / "
            f"{l0!r} (rel {_rel(l1, l0):.2e}); grad norm {g1!r} / {g0!r} "
            f"(rel {_rel(g1, g0):.2e})")
        if _rel(l1, l0) > MESH_RTOL or _rel(g1, g0) > MESH_RTOL:
            fail("mesh (a): float32 train step off the mesh-free step")
        gc.collect()
        torch.cuda.empty_cache()
        # (b) olmoe-1b-7b whole, bf16; then float32 on a few layers
        for ocfg_b, gate in ((ocfg, False),
                             (dataclasses.replace(
                                 ocfg, n_layers=MESH_PARITY_LAYERS,
                                 dtype="float32"), True)):
            capf = ocfg_b.n_experts / ocfg_b.top_k
            params = model.init(ocfg_b,
                                torch.Generator(device=dev).manual_seed(0),
                                dev)
            b, s = MESH_MOE_SHAPE
            toks = torch.randint(0, ocfg_b.vocab_size, (b, s + 1),
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(1), device=dev,
                                 dtype=torch.int32)
            batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
            specs = shd.input_shardings(batch, mesh, b)
            bd = {k: shd.distribute(v, shd.placements(specs[k], mesh), mesh)
                  for k, v in batch.items()}
            plain = RunContext(dev, "torch", moe_capacity_factor=capf)
            row = {}
            with torch.no_grad():
                want, _ = model.forward(ocfg_b, params, batch, plain,
                                        "prefill")
                for prof in ("serve", "tp"):
                    ctx = S.make_context(mesh=mesh, sharding_profile=prof,
                                         moe_capacity_factor=capf)
                    pp = shd.distribute_tree(
                        params, S.param_shardings(ocfg_b, mesh, prof), mesh)
                    if prof == "serve":
                        got, _ = model.forward(ocfg_b, pp, bd, ctx,
                                               "prefill")
                        got = got.full_tensor()
                        row["prefill"] = float(
                            (got.float() - want.float()).abs().max()
                            / want.float().abs().max())
                    else:
                        lw, _ = model.forward(ocfg_b, params, batch, plain,
                                              "train")
                        lg, _ = model.forward(ocfg_b, pp, bd, ctx, "train")
                        row["loss"] = (float(lg.full_tensor()), float(lw))
                    del pp
            log(f"  (b) olmoe-1b-7b {ocfg_b.dtype}, {ocfg_b.n_layers} "
                f"layers, {b} x {s}: serve-profile prefill logits rel max "
                f"diff {row['prefill']:.3e}; tp train loss (no grad) mesh "
                f"{row['loss'][0]!r} / plain {row['loss'][1]!r} (rel "
                f"{_rel(*row['loss']):.2e})")
            if gate and (row["prefill"] > MESH_RTOL
                         or _rel(*row["loss"]) > MESH_RTOL):
                fail("mesh (b): float32 olmoe off the mesh-free path")
            del params, want
            gc.collect()
            torch.cuda.empty_cache()
        # (c) compressed_psum on every gradient leaf of (a); FleetTrainer
        params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        from repro_torch.data.pipeline import Pipeline
        batch = device_batch(Pipeline(cfg, DataConfig(MESH_BATCH, MESH_SEQ))
                             .batch(0))
        live = model.tree_map(lambda p: p.detach().requires_grad_(), params)
        total, _ = model.forward(cfg, live, batch, S.make_context("cuda"),
                                 "train")
        grads = torch.autograd.grad(total, model._tree_leaves(live))
        del live, total
        worst = 0.0
        gen = torch.Generator(device=dev).manual_seed(2)
        for g in grads:
            r = torch.randn(g.shape, generator=gen, device=dev) * 1e-3
            mean, resid = compression.compressed_psum(g, r, "data",
                                                      mesh=mesh)
            # the int8 round trip written out: per-tensor scale
            # max|v| / 127, rounded and clamped codes, one rank's mean
            v = g.float() + r
            scale = v.abs().max() / 127.0 + 1e-12
            want = torch.clamp(torch.round(v / scale), -127, 127) * scale
            worst = max(worst, float((mean - want).abs().max()
                                     / want.abs().max().clamp(min=1e-30)),
                        float((resid - (v - want)).abs().max()
                              / want.abs().max().clamp(min=1e-30)))
        log(f"  (c) compressed_psum on {len(grads)} gradient leaves over "
            f"the one-rank data group (no collective runs on one card: "
            f"the int8 round trip and the residual only): max |diff| from "
            f"the formula, relative to the leaf's largest value, {worst!r}")
        if worst > 1e-6:
            fail("mesh (c): compressed_psum off its formula")
        del grads, params
        tr = FleetTrainer(cfg, steps_total=MESH_FLEET_STEPS,
                          data_cfg=DataConfig(MESH_BATCH, MESH_SEQ),
                          grad_compression=True, mesh=mesh)
        tr.run()
        check_losses("mesh fleet", tr.report.losses)
        if tr._compressed:
            fail("mesh (c): one data rank must train uncompressed")
        log(f"  (c) FleetTrainer(mesh 1x1, grad_compression=True): "
            f"uncompressed on one data rank, losses "
            f"{[round(x, 4) for x in tr.report.losses]}")
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    # (d) the same step traced on fake tensors under a fake one-rank group
    fake = dryrun.fake_world(1, device_type="cuda")
    try:
        shape = ShapeConfig("mesh", "train", MESH_SEQ, MESH_BATCH)
        rec, _ = dryrun.lower_cell(cfg, shape, fake,
                                   S.make_context(mesh=fake))
    finally:
        dist.destroy_process_group()
    fake_cost = H.cost_metrics(rec)
    fake_mem = H.memory_metrics(rec)
    above = real_mem["peak_bytes"] - real_mem["argument_bytes"]
    log(f"  (d) FLOPs card {real_cost['flops']!r} / fake trace "
        f"{fake_cost['flops']!r}; bytes accessed "
        f"{real_cost['bytes_accessed']!r} / {fake_cost['bytes_accessed']!r};"
        f" traced peak card {real_mem['peak_bytes'] / 1e9:.3f} GB / fake "
        f"{fake_mem['peak_bytes'] / 1e9:.3f} GB ({above / 1e9:.3f} GB "
        f"above the {real_mem['argument_bytes'] / 1e9:.3f} GB of "
        f"arguments) beside torch.cuda.max_memory_allocated "
        f"{peak_real / 1e9:.3f} GB above the state; fake trace "
        f"{rec.seconds:.2f} s")
    if real_cost["flops"] != fake_cost["flops"]:
        fail("mesh (d): FLOPs of the card's step and the fake trace differ")
    out.update(flops=real_cost["flops"], peak_traced=real_mem["peak_bytes"],
               peak_real=peak_real)
    return out


def dryrun_phase():
    """Phase 27: the dry-run CLI for DRYRUN_CELLS, one subprocess each, all
    started together, then the roofline table."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, mp in DRYRUN_CELLS:
        cell = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
        (DRYRUN_DIR / f"{cell}.json").unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(DRYRUN_DIR)] + (
                   ["--multi-pod"] if mp else [])
        procs.append(((arch, shape, mp), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    bad = []
    for (arch, shape, mp), p in procs:
        cell = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
        try:
            text = p.communicate(timeout=900)[0]
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            fail(f"dryrun {cell}: timed out")
        for line in text.splitlines():
            if line.startswith("[") or "corrected" in line:
                log(f"  {line}")
        if p.returncode != 0:
            bad.append((cell, text[-2000:]))
            continue
        # the CLI records a failed k = 1 / k = 2 pass and exits 0: read the
        # record, and hold the extrapolation to the full-depth counts
        rec = json.loads((DRYRUN_DIR / f"{cell}.json").read_text())
        corr = rec.get("corrected", {})
        full = (rec.get("cost_reported", {}).get("flops"),
                rec.get("cost_reported", {}).get("bytes_accessed"),
                rec.get("collectives_reported", {}).get("total"))
        got = (corr.get("flops"), corr.get("bytes_accessed"),
               corr.get("collective_bytes"))
        if rec.get("status") != "ok" or "error" in corr or got != full:
            bad.append((cell, {"status": rec.get("status"),
                               "corrected": corr, "full_depth": full}))
    if bad:
        fail(f"dryrun: {bad}")
    log(f"  k = 1 / k = 2 extrapolation equal to the full-depth FLOPs, "
        f"bytes and collective bytes in all {len(procs)} records")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import roofline
    log("  roofline (H100 SXM constants; estimates from counting):")
    for line in roofline.table().splitlines():
        log(f"  {line}")


def main():
    t_start = time.perf_counter()
    import gc
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.launch.serve import LMBackend
    from repro_torch.models import model

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/{PHASES} device] {kind} x{torch.cuda.device_count()} | {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[2/{PHASES} build] {len(libs)} kernels in "
        f"{time.perf_counter() - t0:.1f} s -> {build.build_dir()}")
    for name in libs:
        for line in (build.build_dir() / f"{name}.log").read_text() \
                .splitlines():
            if "entry function" in line:
                entry = line.split("'")[1]
                log(f"  {name}: {entry}")
            elif "registers" in line or "spill" in line:
                log(f"  {name}:   {line.strip()}")

    cfg = get_config("smollm-360m")
    rcfg = get_config("rwkv6-7b")
    gcfg = get_config("recurrentgemma-2b")
    log(f"[3/{PHASES} kernels] each kernel vs its plain version")
    results = kernel_phase(torch, dev, cfg)
    paged_sweep_phase(torch, dev)
    long = paged_long_phase(torch, dev)["paged_decode_long"]
    gc.collect()
    torch.cuda.empty_cache()
    prefill_sweep_phase(torch, dev)
    prefill_verify = prefill_verify_phase(torch, dev, cfg)
    prefill_long = prefill_long_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    flash_tc_phase(torch, dev)
    results.update(wkv_phase(torch, dev, rcfg))
    results.update(rglru_phase(torch, dev, gcfg))
    d256 = flash_d256_phase(torch, dev, gcfg)["flash_d256"]
    ocfg = get_config("olmoe-1b-7b")
    olmoe_rows = olmoe_shape_phase(torch, dev, ocfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[4/{PHASES} serving] smollm-360m full width, bfloat16, paged "
        "ClientHandler")
    launches = paged_serving(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[5/{PHASES} parity] smollm-360m float32, impl=cuda vs impl=torch, "
        "same weights")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = model.init(cfg32, torch.Generator(device=dev).manual_seed(0),
                        dev)
    parity(torch, cfg32, params, CAPACITY, trace, PROMPT_PAD)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[6/{PHASES} rwkv6] rwkv6-7b full width, bfloat16, "
        "ClientHandler(kv='contiguous')")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    backend = LMBackend(rcfg, capacity=RWKV_CAPACITY, device="cuda")
    torch.cuda.synchronize()
    n_par = model.n_params(rcfg)
    log(f"  {n_par} parameters, {n_par * 2 / 1e9:.2f} GB of bf16 weights "
        f"drawn in {time.perf_counter() - t0:.2f} s")
    steps = []
    ops.reset_launches()
    toks, rep, _, wall, _ = serve(
        torch, backend, rwkv_trace(rcfg.vocab_size),
        executor=timed_once(torch, steps), kv="contiguous", decode_window=1,
        prompt_pad=RWKV_PROMPT_PAD)
    rwkv_launches = dict(ops.launches)
    n_tok = sum(len(t) for t in toks.values())
    pre = [dt for name, dt in steps if name == "prefill"]
    dec = [dt for name, dt in steps if name == "decode"]
    log(f"  {rep.summary()}")
    log(f"  wall {wall:.4f} s for {n_tok} tokens ({n_tok / wall:.3f} tok/s, "
        f"each step run once); cohort prefill {len(pre)} x "
        f"{1e3 * float(np.mean(pre)):.3f} ms, decode steps {len(dec)} "
        f"(median {1e3 * float(np.median(dec)):.3f} ms, min "
        f"{1e3 * min(dec):.3f} ms); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{rwkv_launches}")
    if rwkv_launches["rwkv6_scan"] <= 0:
        fail("rwkv6_scan never launched on the rwkv6 serving path")
    del backend
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[7/{PHASES} parity] rwkv6-7b float32 (full width), impl=cuda vs "
        "impl=torch, same weights")
    cohort_parity(torch, rcfg, RWKV_PARITY_LAYERS, RWKV_CAPACITY, rwkv_trace,
                  RWKV_PROMPT_PAD)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[8/{PHASES} hybrid] recurrentgemma-2b full width, bfloat16, "
        "ClientHandler(kv='contiguous')")
    rg_launches = rg_serving(torch, gcfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[9/{PHASES} parity] recurrentgemma-2b float32 (full width), "
        "impl=cuda vs impl=torch, same weights")
    cohort_parity(torch, gcfg, gcfg.n_layers, RG_CAPACITY, rg_trace,
                  RG_PROMPT_PAD)
    gc.collect()
    torch.cuda.empty_cache()

    qcfg = get_config("qwen2.5-3b")
    log(f"[10/{PHASES} qwen] qwen2.5-3b full width, bfloat16, paged "
        "ClientHandler")
    qwen_launches = paged_serving(torch, qcfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[11/{PHASES} parity] qwen2.5-3b float32 (full width), impl=cuda "
        "vs impl=torch, same weights")
    q32 = dataclasses.replace(qcfg, dtype="float32")
    params = model.init(q32, torch.Generator(device=dev).manual_seed(0), dev)
    log(f"  first {QWEN_PARITY_LAYERS} of {qcfg.n_layers} layers")
    parity(torch, *cut_depth(model, q32, params, QWEN_PARITY_LAYERS),
           CAPACITY, trace, PROMPT_PAD)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[12/{PHASES} spec] smollm-360m full width, bfloat16, "
        f"ClientHandler(speculative=True, spec_k={VERIFY_K})")
    spec_launches = spec_serving(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[13/{PHASES} spec parity] smollm-360m float32, speculative "
        "impl=cuda vs plain impl=torch, same weights")
    spec_parity(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[14/{PHASES} disagg] smollm-360m full width, bfloat16, "
        "ClientHandler(disagg=True), bf16 and int8 handoff")
    disagg_launches = disagg_serving(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[15/{PHASES} disagg parity] smollm-360m float32, disagg "
        "impl=cuda vs co-located impl=torch, same weights")
    disagg_parity(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[16/{PHASES} chaos] smollm-360m full width, bfloat16, faults on "
        "the primary (drain, kill, permanent kill, slow + hedge), then the "
        "SLO gateway")
    chaos_launches = chaos_serving(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[17/{PHASES} chaos parity] smollm-360m float32, drain / kill / "
        "hedge impl=cuda vs faultless impl=torch, same weights")
    chaos_parity(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[18/{PHASES} offload] smollm-360m full width, bfloat16, "
        "ServingEngine (local, remote, 2 clones, EXEC_TIME policy; "
        f"capacity {ESCALATE_CAPACITY} escalation), then @remote")
    offload_flash = offload_serving(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[19/{PHASES} offload parity] smollm-360m float32, ServingEngine "
        "placements impl=cuda vs impl=torch, same weights")
    offload_parity_flash = offload_parity(torch, cfg)
    log(f"  flash launches: phase 18 {offload_flash}, phase 19 (impl=cuda) "
        f"{offload_parity_flash}")
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[20/{PHASES} olmoe] olmoe-1b-7b full width (16 layers, 64 experts "
        "top-8), bfloat16, paged ClientHandler")
    olmoe_launches = paged_serving(torch, ocfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[21/{PHASES} olmoe parity] olmoe-1b-7b float32 (full width), "
        "impl=cuda vs impl=torch, same weights")
    moe_parity(torch, ocfg, OLMOE_PARITY_LAYERS, CAPACITY, trace)
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = get_config("mixtral-8x7b")
    log(f"[22/{PHASES} mixtral] mixtral-8x7b full width ({MIXTRAL_LAYERS} of "
        "32 layers, 8 experts top-2), bfloat16, "
        "ClientHandler(kv='contiguous'); then float32 parity on "
        f"{MIXTRAL_PARITY_LAYERS} layers")
    mixtral_launches = mixtral_serving(torch, mcfg)
    gc.collect()
    torch.cuda.empty_cache()
    moe_parity(torch, mcfg, MIXTRAL_PARITY_LAYERS, MIXTRAL_CAPACITY,
               moe_trace, kv="contiguous", decode_window=1)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[23/{PHASES} train] smollm-360m full width and depth, bfloat16, "
        f"FleetTrainer: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, a checkpoint every {TRAIN_CKPT_EVERY}, a fault every "
        f"{TRAIN_FAIL_EVERY}th check; then a resume")
    train_phase(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[24/{PHASES} train parity] float32: smollm-360m train steps card "
        "vs host; the train loss impl=cuda vs impl=torch for smollm-360m, "
        "rwkv6-7b and recurrentgemma-2b; the gradient refusal")
    train_launches = train_parity_phase(torch, cfg, rcfg, gcfg)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[25/{PHASES} frontends] hubert-xlarge and paligemma-3b full width "
        f"and depth, bfloat16, {FRONTEND_STEPS} train steps each; the "
        "prefix-LM check in float32")
    frontend_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[26/{PHASES} mesh] one-rank NCCL group, 1 x 1 mesh: smollm-360m "
        "train step and olmoe-1b-7b prefill / train loss through the mesh "
        "path vs mesh-free; compressed_psum; FleetTrainer(mesh); FLOPs card "
        "vs fake trace")
    t26 = time.perf_counter()
    mesh_phase(torch, cfg, ocfg)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 26 {time.perf_counter() - t26:.1f} s")

    log(f"[27/{PHASES} dryrun] {len(DRYRUN_CELLS)} cells on a fake 256 / "
        "512-rank group, then the roofline")
    t27 = time.perf_counter()
    dryrun_phase()
    log(f"  phase 27 {time.perf_counter() - t27:.1f} s")

    # launches per serving path, each counted from 0 over its own run
    # (spec: both drafts' runs; disagg: both handoff runs; chaos: the five
    # fault runs and the gated run; offload: phase 18's five serves)
    by_path = {
        name: {"smollm": launches[name], "qwen": qwen_launches[name],
               "spec": sum(r[name] for r in spec_launches.values()),
               "disagg": sum(r[name] for r in disagg_launches.values()),
               "chaos": sum(r[name] for r in chaos_launches.values()),
               "olmoe": olmoe_launches[name]}
        for name in ("paged_decode", "paged_prefill", "flash_attention")}
    by_path["flash_attention"]["recurrentgemma"] = \
        rg_launches["flash_attention"]
    by_path["flash_attention"]["offload"] = offload_flash
    by_path["flash_attention"]["mixtral"] = \
        mixtral_launches["flash_attention"]
    by_path["flash_attention"]["train"] = train_launches["flash_attention"]
    by_path["rwkv6_scan"] = {"rwkv6": rwkv_launches["rwkv6_scan"],
                             "train": train_launches["rwkv6_scan"]}
    by_path["rglru_scan"] = {"recurrentgemma": rg_launches["rglru_scan"],
                             "train": train_launches["rglru_scan"]}
    for name, paths in by_path.items():
        launches[name] = sum(paths.values())
    kernels = []
    for name in ("paged_decode", "paged_prefill", "flash_attention",
                 "rwkv6_scan", "rglru_scan"):
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        kernels[-1]["launches_by_path"] = by_path[name]
        if name + "_olmoe" in olmoe_rows:
            # the same kernel at olmoe-1b-7b's serving shape (GQA group 1)
            orow = olmoe_rows[name + "_olmoe"]
            kernels[-1]["olmoe"] = {key: orow[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "graph_ms", "plan")}
        if name == "paged_decode":
            kernels[-1]["graph_ms"] = r["graph_ms"]
            kernels[-1]["long"] = {
                key: long[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "graph_ms")}
            # the plans the timed bf16 calls launched with
            kernels[-1]["plans"] = {"serving": r["plan"],
                                    "long": long["plan"]}
        if name == "paged_prefill":
            kernels[-1]["graph_ms"] = r["graph_ms"]
            # the same kernel at the speculative verify shape (C 5)
            vr = prefill_verify["paged_prefill_verify"]
            kernels[-1]["verify"] = {k: vr[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "graph_ms", "bytes", "flops", "pos0",
                "n_live")}
            # the same kernel at 8 slots near 8192 tokens, two head layouts
            for key, lr in prefill_long.items():
                kernels[-1][key.replace("paged_prefill_", "")] = {
                    k: lr[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "graph_ms", "bytes",
                        "flops")}
            kernels[-1]["plans"] = {
                "serving": r["plan"], "verify": vr["plan"],
                **{key.replace("paged_prefill_", ""): lr["plan"]
                   for key, lr in prefill_long.items()}}
        if name == "flash_attention":
            # the same kernel at recurrentgemma's prefill shape (D 256)
            kernels[-1]["graph_ms"] = r["graph_ms"]
            kernels[-1]["d256"] = {
                key: d256[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "graph_ms")}
            # the plans the timed bf16 calls launched with
            kernels[-1]["plans"] = {"d64": r["plan"], "d256": d256["plan"]}
        if name == "rwkv6_scan":
            # the same kernel at 8 x 2048 tokens
            lr = results["rwkv6_scan_long"]
            kernels[-1]["graph_ms"] = r["graph_ms"]
            kernels[-1]["long"] = {
                key: lr[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "graph_ms", "bytes", "flops")}
            kernels[-1]["plans"] = {"serving": r["plan"], "long": lr["plan"]}
        if name == "rglru_scan":
            kernels[-1]["graph_ms"] = r["graph_ms"]
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
