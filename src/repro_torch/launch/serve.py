"""Serving stack: ThinkAir's Client Handler for LM inference, on PyTorch.

``LMBackend`` binds a model (parameters on one device, a ``RunContext``
selecting the hand-written CUDA kernels or the plain path) and hands the
serving layer its step functions.

``ServingEngine`` is the batch-at-a-time offload path: each batch's
prefill and every decode step is a remoteable method run through an
:class:`~repro_torch.core.controller.ExecutionController` on the backend's
device, which places it on the phone venue or a cloud clone from profiled
history; a batch whose KV working set exceeds the clone's memory escalates
to a bigger clone type (the paper's OutOfMemoryError path), and prefill can
be split over k clones (the paper's parallelization path).

``ClientHandler`` is the
event-driven continuous-batching server: requests arrive on a shared
:class:`~repro_torch.core.clock.VirtualClock`, pass admission control, and
are admitted into the slots of a per-clone :class:`_SlotEngine` over a
refcounted copy-on-write paged KV pool (:class:`KVBlockPool`).  One engine
step folds every pending join into one dispatch — a batched full prefill
for cold prompts (flash kernel), device block copies for copy-on-write
splits, chunked suffix prefill for prefix hits and restores (paged-prefill
kernel), fused with the resident cohort's decode window (paged-decode
kernel) when mixed dispatch is on — and requests retire at step
granularity.  A :class:`~repro_torch.core.scheduler.FleetAutoscaler`
provisions and TTL-pauses secondaries on the clone pool.

``kv="contiguous"`` is the cohort mode instead: requests admitted at one
step boundary form a :class:`_Cohort` that prefills once
(``model.forward``) and decodes in lockstep on a contiguous cache at one
shared cursor, one token per dispatch; rows retire at step granularity and
late arrivals wait for a free clone.  It is the mode that serves
recurrent-state models (RWKV-6) and the RG-LRU hybrid with its
sliding-window ring cache (recurrentgemma): the paged path raises for them
(ROADMAP Queue 3; the reference has no paged ring).

Speculative decoding (ADR-008) pairs each engine with a draft clone: a
round drafts K tokens per slot on the draft model (``model.draft_loop``,
decode mode) and scores them in one chunked pass on the target
(``model.verify_window``, the paged-prefill kernel); the host accepts the
longest agreeing prefix, so the streams are the plain greedy streams.
Disaggregated prefill (ADR-009) prefills cold prompts on a shared partner
clone and hands their KV blocks to the decode pool inside the engine's next
step, optionally through the int8 pair; ``routing="affinity"`` prefers
engines and clones by prefix-match depth.

Fault tolerance (ADR-006): a :class:`~repro_torch.core.faults.FaultInjector`
kills, drains or slows clones on the clock; the handler migrates a drained
engine's slots to a survivor's pool (a ``"recover"`` migration folded by the
survivor's next step) and restores a killed one's by re-prefilling them, and
``hedge_factor`` races a straggling step on a second clone.  A
:class:`~repro_torch.core.gateway.StreamingGateway` in front of the queue
applies tenant quotas, fair share, shedding and a response cache (ADR-007).

KV caches are updated in place, recurrent state is replaced.  Every step
closure is idempotent (each write is a function of the step's inputs,
attention writes before it reads, and no input other than the KV cache is
mutated), so an executor may re-run a closure, as
:class:`~repro_torch.core.venues.Venue` does to stabilise its timing and a
hedge does on a second clone.  A clone that dies with a step in flight has
already had that step's writes land in its pool: a drain migrates the
blocks up to the slot's cursor, and the survivor rewrites every position
from the cursor on before it attends to it.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.clock import VirtualClock
from repro_torch.core.clones import (CLONE_TYPES, KV_SCALE_BY_CLONE_TYPE,
                                     PAUSE_IDLE_TTL, CircuitBreaker,
                                     ClonePool)
from repro_torch.core.controller import ExecutionController
from repro_torch.core.dispatch import Dispatcher
from repro_torch.core.energy import GpuEnergyModel
from repro_torch.core.faults import CloneFault, FaultInjector
from repro_torch.core.gateway import StreamingGateway
from repro_torch.core.policy import Policy
from repro_torch.core.remoteable import RemoteableMethod
from repro_torch.core.scheduler import (AdmissionQueue, FleetAutoscaler,
                                        PlacementEngine, ServeCompletion,
                                        ServeRequest, SlotLedger,
                                        poisson_arrivals)
from repro_torch.core.venues import (LINKS, Venue, kv_block_bytes,
                                     pytree_bytes, transfer_time)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models import model
from repro_torch.models.context import RunContext


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1): the dispatch bucket size, so
    variable-size batches (join rows, CoW pairs, suffix rows and steps)
    take O(log) distinct shapes."""
    if n < 1:
        raise ValueError(f"bucket size needs n >= 1: {n}")
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]
    prefill_venue: str
    decode_venue: str
    latency_s: float              # virtual-clock seconds of the batch
    escalations: int


def _capacity_factor(cfg) -> float:
    """The serving capacity factor: ``n_experts / top_k`` for a
    mixture-of-experts model (every expert's buffer holds every routed
    row), 1.25 (the ``RunContext`` default) otherwise."""
    return cfg.n_experts / cfg.top_k if cfg.is_moe else 1.25


class LMBackend:
    """Model binding: parameters on a device + the contiguous and paged
    step functions.

    ``params`` accepts bridged weights (``models.weights.from_jax``);
    without it parameters are drawn from a ``torch.Generator`` seeded 0.
    ``device`` defaults to ``cuda`` (raising where there is none);
    ``impl`` defaults to the CUDA kernels on a card and the plain path
    elsewhere.  A configuration with a modality frontend is served on its
    text path, as in the reference.  A mixture-of-experts model is served at
    capacity factor ``n_experts / top_k``, where no token is dropped
    (``ctx.moe_capacity_factor``; 1.25 for dense models, which ignore it).

    ``draft`` arms speculative decoding (ADR-008): a ``ModelConfig``
    sharing the target's vocab binds a draft model on the same device
    (``draft_params``, else drawn from a generator seeded 7) with its own
    context (``draft_ctx``: the same device and kernels, the draft's own
    capacity factor); ``"oracle"`` makes the target its own draft.
    """

    def __init__(self, cfg, capacity: int = 256, *,
                 params: Optional[Dict] = None, device=None,
                 impl: Optional[str] = None, draft=None,
                 draft_params: Optional[Dict] = None):
        self.cfg = cfg
        self.capacity = capacity
        self.ctx = RunContext.on(device, impl, _capacity_factor(cfg))
        self.device = self.ctx.device
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = model.init(cfg, gen, self.device)
        self.params = params
        self.draft_cfg = None
        self.draft_params = None
        self.draft_ctx = None
        if draft == "oracle":
            self.draft_cfg, self.draft_params = cfg, params
            self.draft_ctx = self.ctx
        elif draft is not None:
            if draft.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft model must share the target's vocab "
                    f"({draft.vocab_size} != {cfg.vocab_size}): acceptance "
                    "compares token ids directly")
            if draft_params is None:
                gen = torch.Generator(device=self.device).manual_seed(7)
                draft_params = model.init(draft, gen, self.device)
            self.draft_cfg, self.draft_params = draft, draft_params
            self.draft_ctx = dataclasses.replace(
                self.ctx, moe_capacity_factor=_capacity_factor(draft))
        elif draft_params is not None:
            raise ValueError("draft_params given without a draft config")

    @property
    def supports_chunked(self) -> bool:
        """Whether chunked prefill / mixed dispatch cover this config."""
        return model.supports_chunked_prefill(self.cfg)

    @property
    def supports_speculative(self) -> bool:
        """Whether a draft model is bound and the target can run the
        chunked verify pass."""
        return self.draft_cfg is not None and self.supports_chunked

    @property
    def draft_cost_ratio(self) -> float:
        """Draft / target parameter-count ratio (informational)."""
        if self.draft_cfg is None:
            return 1.0
        return model.n_params(self.draft_cfg) / model.n_params(self.cfg)

    def cache_mem_bytes(self, batch: int) -> int:
        """Bytes of a contiguous (batch, capacity) cache (KV and state
        leaves, ``venues.pytree_bytes`` framing; shapes only)."""
        return pytree_bytes(model.init_cache(self.cfg, batch, self.capacity,
                                             device=torch.device("meta")))

    def tensor(self, x) -> torch.Tensor:
        """A host array as an int32 tensor on the backend's device (a
        copy: later host mutation never reaches a dispatched step)."""
        return torch.tensor(np.asarray(x), dtype=torch.int32,
                            device=self.device)

    # ----------------------------------------------------------- contiguous
    def prefill(self, params, tokens):
        """Cohort prefill: ``tokens`` (B, P) -> (greedy first tokens (B,)
        int32, contiguous cache at ``capacity``)."""
        logits, cache = model.forward(self.cfg, params, {"tokens": tokens},
                                      self.ctx, "prefill",
                                      cache_capacity=self.capacity)
        return torch.argmax(logits, -1).to(torch.int32), cache

    def decode(self, params, cache, tokens, pos: int):
        """One lockstep decode step of a cohort at the shared cursor
        ``pos``: tokens (B, 1) -> (next tokens (B,) int32, cache)."""
        logits, cache = model.decode_step(self.cfg, params, cache, tokens,
                                          pos, self.ctx)
        return torch.argmax(logits, -1).to(torch.int32), cache

    def cache_take(self, cache, keep_idx) -> Dict:
        """Shrink a cohort cache to the surviving batch rows (new
        tensors: the cache a dispatched step read stays intact)."""
        idx = torch.as_tensor(np.asarray(keep_idx, np.int64),
                              device=self.device)
        b_ax, _ = model.cache_axes(self.cfg)
        return model.tree_map(lambda leaf, ax: leaf.index_select(ax, idx),
                              cache, b_ax)

    # ---------------------------------------------------------------- paged
    def init_paged_pool(self, max_slots: int, num_blocks: int,
                        block_size: int):
        """Zero KV block pool on the backend's device (block 0 = trash)."""
        return model.init_paged_cache(self.cfg, max_slots, num_blocks,
                                      block_size, device=self.device)

    def init_draft_pool(self, max_slots: int, num_blocks: int,
                        block_size: int):
        """Zero paged pool of the draft model with the target pool's block
        geometry, so both share one set of block tables."""
        return model.init_paged_cache(self.draft_cfg, max_slots, num_blocks,
                                      block_size, device=self.device)

    def spec_draft_fn(self, block_size: int, catchup_steps: int,
                      k_max: int):
        """Draft half of a speculative round: ``fn(dparams, dpool, ctoks
        (S,Tc), cpos0 (S,), n_c (S,), tok (S,1), pos (S,), k_live (S,),
        tables (S,M)) -> (drafts (S, k_max), dpool)`` (the catch-up and the
        proposals of :func:`model.draft_loop`, decode mode only)."""
        dcfg, ctx, capacity = self.draft_cfg, self.draft_ctx, self.capacity

        def draft(dparams, dpool, ctoks, cpos0, n_c, tok, pos, k_live,
                  tables):
            return model.draft_loop(
                dcfg, dparams, dpool, ctoks, cpos0, n_c, tok, pos, k_live,
                ctx, block_tables=tables, block_size=block_size,
                catchup_steps=catchup_steps, num_steps=k_max,
                capacity=capacity)
        return draft

    def spec_verify_fn(self, block_size: int):
        """Verify half: ``fn(params, pool, toks (S, K+1), pos0 (S,), n_live
        (S,), tables (S,M)) -> (greedy (S, K+1), pool)`` through
        :func:`model.verify_window` (chunk mode: the paged-prefill kernel
        on the card)."""
        cfg, ctx, capacity = self.cfg, self.ctx, self.capacity

        def verify(params, pool, toks, pos0, n_live, tables):
            return model.verify_window(cfg, params, pool, toks, pos0, n_live,
                                       ctx, block_tables=tables,
                                       block_size=block_size,
                                       capacity=capacity)
        return verify

    def paged_fns(self, block_size: int, window: int = 1):
        """(prefill_into, decode_window).

        ``prefill_into(params, toks (J,P), pool, blk_ids (J,nb0), slots
        (J,))`` prefills J prompts in one batched forward (flash kernel)
        and scatters each row's KV into its pool blocks, returning
        ``(first_tokens (J,), pool)``.  Bucket-padding rows carry block id
        0 (the trash block); ``slots`` addresses per-slot state rows,
        which attention-only models do not have.

        ``decode_window(params, pool, tok, pos, steps_left, tables)`` runs
        ``window`` greedy steps (``model.decode_loop``), returning
        ``(tokens (S, window), pool)``.
        """
        cfg, ctx, capacity = self.cfg, self.ctx, self.capacity

        def prefill_into(params, toks, pool, blk_ids, slots):
            j, nb0 = blk_ids.shape
            logits, pcache = model.forward(cfg, params, {"tokens": toks}, ctx,
                                           "prefill",
                                           cache_capacity=nb0 * block_size)
            flat = blk_ids.reshape(-1).long()
            for (leaf, ax), (pre, _) in zip(model.cache_leaves(cfg, pool),
                                            model.cache_leaves(cfg, pcache)):
                rows = pre.reshape(pre.shape[:ax] + (j * nb0, block_size)
                                   + pre.shape[ax + 2:])
                leaf.movedim(ax, 0)[flat] = rows.movedim(ax, 0)
            return torch.argmax(logits, -1).to(torch.int32), pool

        def decode_window(params, pool, tok, pos, steps_left, tables):
            return model.decode_loop(cfg, params, pool, tok, pos, steps_left,
                                     ctx, block_tables=tables,
                                     block_size=block_size,
                                     num_steps=window, capacity=capacity)

        return prefill_into, decode_window

    def prefill_window_fn(self, block_size: int, num_steps: int,
                          chunk: int = 0):
        """Suffix prefill for prefix-hit / restored rows:
        ``fn(params, pool, toks (J,T), pos0 (J,), n_tok (J,), tables (J,M))
        -> (first_tokens (J,), pool)``.  ``chunk > 0`` advances ``chunk``
        tokens per step through the paged-prefill kernel
        (``model.prefill_chunks``); 0 is the stepwise teacher-forced scan."""
        cfg, ctx, capacity = self.cfg, self.ctx, self.capacity
        if chunk > 0:
            if not self.supports_chunked:
                raise ValueError("chunked prefill requires all-attention "
                                 "windowless layers (see "
                                 "model.supports_chunked_prefill)")
            n_chunks = -(-num_steps // chunk)

            def prefill_window(params, pool, toks, pos0, n_tok, tables):
                return model.prefill_chunks(
                    cfg, params, pool, toks, pos0, n_tok, ctx,
                    block_tables=tables, block_size=block_size, chunk=chunk,
                    num_steps=n_chunks, capacity=capacity)
        else:
            def prefill_window(params, pool, toks, pos0, n_tok, tables):
                return model.prefill_loop(
                    cfg, params, pool, toks, pos0, n_tok, ctx,
                    block_tables=tables, block_size=block_size,
                    num_steps=num_steps, capacity=capacity)
        return prefill_window

    def mixed_fn(self, block_size: int, chunk: int, num_steps: int):
        """Mixed prefill/decode engine step: ``fn(params, pool, tok (S,1),
        pos, steps_left, tables, stoks (J,T), spos, sn, stabs) -> (tokens
        (S, num_steps), first_tokens (J,), pool)`` (``model.mixed_loop``)."""
        if not self.supports_chunked:
            raise ValueError("mixed dispatch requires all-attention "
                             "windowless layers (see "
                             "model.supports_chunked_prefill)")
        cfg, ctx, capacity = self.cfg, self.ctx, self.capacity

        def mixed(params, pool, tok, pos, steps_left, tables,
                  stoks, spos, sn, stabs):
            return model.mixed_loop(
                cfg, params, pool, tok, pos, steps_left, stoks, spos, sn,
                ctx, block_tables=tables, sfx_tables=stabs,
                block_size=block_size, chunk=chunk, num_steps=num_steps,
                capacity=capacity)
        return mixed

    def copy_fn(self):
        """Copy-on-write: ``fn(pool, src (C,), dst (C,))`` copies the listed
        KV blocks on device across every pool leaf (``ref.copy_blocks``);
        (0, 0) pads are no-ops."""
        cfg = self.cfg

        def copy_into(pool, src, dst):
            for leaf, ax in model.cache_leaves(cfg, pool):
                kref.copy_blocks(leaf, src, dst, axis=ax)
            return pool
        return copy_into

    def migrate_fn(self, compress: bool = False):
        """Cross-pool KV migration: ``fn(dst_pool, src_pool, src_ids (C,),
        dst_ids (C,))`` writes the listed source blocks into the listed
        destination blocks of every leaf, in place (block 0 is the trash
        block on both sides: 0 -> 0 pads are harmless).  The reference's
        two slot-id arguments address per-slot recurrent-state rows, which
        the port's paged pool never holds (``init_paged_cache`` raises for
        recurrent configurations), so they are left out.
        ``compress=True`` round-trips the gathered blocks through the int8
        pair (``ops.quantize_kv_blocks`` / ``dequantize_kv_blocks``, to
        the destination's dtype) before they land: the compressed handoff
        of ADR-009."""
        cfg = self.cfg

        def migrate(dst_pool, src_pool, src_ids, dst_ids):
            sids, dids = src_ids.long(), dst_ids.long()
            for (dleaf, ax), (sleaf, _) in zip(
                    model.cache_leaves(cfg, dst_pool),
                    model.cache_leaves(cfg, src_pool)):
                payload = sleaf.movedim(ax, 0)[sids]
                if compress:
                    q, scales = ops.quantize_kv_blocks(payload)
                    payload = ops.dequantize_kv_blocks(q, scales,
                                                       dtype=dleaf.dtype)
                dleaf.movedim(ax, 0)[dids] = payload
            return dst_pool
        return migrate


class ServingEngine:
    """Batched prefill + decode with ThinkAir placement decisions.

    Bound to ``backend``, or to an ``LMBackend(cfg, capacity,
    device=device)`` built here (the card unless ``device`` names
    another); the controller runs on the backend's device.  Prefill and
    decode are ``RemoteableMethod``s: the KV working set
    (``cache_mem_bytes``) drives escalation past the clone type's heap,
    and prefill splits its batch over ``n_clones`` clones, whose caches
    merge on each leaf's batch axis (``model.cache_axes``).  Shorter
    prompts are zero-padded on the right, as in the reference."""

    def __init__(self, cfg, *, policy: Policy = Policy.EXEC_TIME,
                 link: str = "wifi-local", max_batch: int = 8,
                 capacity: int = 256, backend: Optional[LMBackend] = None,
                 device=None):
        self.cfg = cfg
        self.max_batch = max_batch
        self.capacity = capacity
        self.backend = backend or LMBackend(cfg, capacity, device=device)
        self.params = self.backend.params
        self.ec = ExecutionController(policy=policy, link=link,
                                      device=self.backend.device)
        self.ec.pool.provision("main", 8)       # paused secondaries (paper)
        self._batch_axis = model.cache_axes(self.backend.cfg)[0]
        backend_ = self.backend

        # KV working set drives escalation: bytes ~ cache size
        def prefill_mem(params, tokens):
            return backend_.cache_mem_bytes(tokens.shape[0])

        self.rm_prefill = RemoteableMethod(
            "serve_prefill", self.backend.prefill, jit=False,
            size_fn=lambda p, t: t.numel(),
            split_fn=self._split_prefill, merge_fn=self._merge_prefill,
            mem_fn=prefill_mem)
        self.rm_decode = RemoteableMethod(
            "serve_decode", self.backend.decode, jit=False,
            size_fn=lambda p, c, t, pos: t.shape[0])
        self.stats = {"requests": 0, "batches": 0, "offloaded": 0,
                      "escalations": 0}

    @staticmethod
    def _split_prefill(args, k):
        params, tokens = args
        return [(params, t) for t in torch.tensor_split(tokens, k, dim=0)]

    def _merge_prefill(self, values):
        toks = torch.cat([v[0] for v in values], dim=0)
        caches = model.tree_map(lambda ax, *xs: torch.cat(xs, dim=ax),
                                self._batch_axis, *[v[1] for v in values])
        return toks, caches

    def serve_batch(self, reqs: List[Request], *, n_clones: int = 1,
                    force: Optional[str] = None) -> List[Completion]:
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), plen), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :len(r.prompt)] = r.prompt
        res_p = self.ec.execute(self.rm_prefill, self.params,
                                self.backend.tensor(toks), n_clones=n_clones,
                                force=force)
        next_tok, cache = res_p.value
        out = [list() for _ in reqs]
        steps_needed = max(r.max_new_tokens for r in reqs)
        tok = next_tok[:, None]
        total_time = res_p.time_s
        decode_venue = "-"
        # per-batch aggregation over prefill AND every decode step
        offloaded = int(res_p.offloaded)
        escalations = res_p.escalations
        for step_i in range(steps_needed):
            for i, t in enumerate(tok[:, 0].tolist()):
                out[i].append(int(t))
            pos = min(plen + step_i, self.capacity - 1)
            res_d = self.ec.execute(self.rm_decode, self.params, cache, tok,
                                    pos, force=force)
            tok, cache = res_d.value
            tok = tok[:, None]
            total_time += res_d.time_s
            decode_venue = res_d.venue
            offloaded += int(res_d.offloaded)
            escalations += res_d.escalations
        self.stats["requests"] += len(reqs)
        self.stats["batches"] += 1
        self.stats["offloaded"] += offloaded
        self.stats["escalations"] += escalations
        return [Completion(r.rid, out[i], res_p.venue, decode_venue,
                           total_time, escalations)
                for i, r in enumerate(reqs)]


class PoolExhausted(RuntimeError):
    """Raised by the allocator when no block can be produced — the signal
    the serving layer converts into a preemption, never a crash."""


class KVBlockPool:
    """Host-side paged-KV bookkeeping for one engine (one clone).

    Owns the device block pool plus the block table, per-slot decode
    cursors, per-block *refcounts*, and a content-addressed **prefix
    index**.  Block id 0 is the *trash block*: it is never allocated, and
    every inactive slot's table points at it.

    A block may appear in several slots' tables (``ref[b]`` = table
    references).  ``free_slot`` only decrements; at refcount zero a prompt
    block recorded in the prefix index parks on the ``cached-free`` LRU
    list (still resident), so a later request with the same prefix maps it
    back instead of re-prefilling.  The index is a trie over full token
    blocks; admission maps fully-matched blocks shared and copies the
    first divergent block on write.  Admission reserves only the prompt's
    private blocks; decode growth that exhausts the pool raises
    :class:`PoolExhausted`, which the engine resolves by preemption.
    """

    def __init__(self, backend, max_slots: int, block_size: int,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True):
        self.backend = backend
        self.bs = block_size
        self.max_slots = max_slots
        self.capacity = backend.capacity
        self.max_blk = -(-backend.capacity // block_size)
        self.num_blocks = num_blocks or max_slots * self.max_blk + 1
        self.pool = backend.init_paged_pool(max_slots, self.num_blocks,
                                            block_size)
        self.prefix_cache = prefix_cache
        self.tables = np.zeros((max_slots, self.max_blk), np.int32)
        self.pos = np.zeros((max_slots,), np.int32)
        self.active = np.zeros((max_slots,), bool)
        self.n_blocks_of = np.zeros((max_slots,), np.int32)
        self.ref = np.zeros((self.num_blocks,), np.int32)
        # bumped on every host-side table mutation; _SlotEngine caches the
        # device copy of ``tables`` against it
        self.tables_version = 0
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self._free_blocks = list(range(self.num_blocks - 1, 0, -1))
        self._children: Dict[int, Dict[tuple, int]] = {}
        self._node: Dict[int, tuple] = {}        # bid -> (parent, tokens)
        self._cached_free: Dict[int, None] = {}  # ref==0, indexed (LRU)
        # blocks whose cached content lands via an in-flight suffix scan:
        # not yet readable by a same-round sharer
        self._pending: set = set()
        # cached-free blocks serving as CoW sources this round
        self._hold: set = set()
        # trie nodes created by each slot's admission, until its prefill
        # completes (a cancelled admission unindexes exactly these)
        self._fresh_nodes: Dict[int, List[int]] = {}
        self.stats = {"hit_tokens": 0, "prompt_tokens": 0,
                      "cow_copies": 0, "evictions": 0}

    def reset(self) -> None:
        """Release every slot for engine reuse, keeping the prefix index
        (the device pool is retained as-is)."""
        for slot in range(self.max_slots):
            if self.n_blocks_of[slot]:
                self.free_slot(slot)
        self.pos[:] = 0
        self.active[:] = False
        self.tables_version += 1
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._pending.clear()
        self._hold.clear()

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def available_blocks(self) -> int:
        """Blocks allocatable now: free plus cached-but-unreferenced."""
        return len(self._free_blocks) + len(self._cached_free)

    # ------------------------------------------------------------ prefix
    def match_prefix(self, prompt: np.ndarray):
        """Longest cached prefix of ``prompt`` (pure).  Returns
        ``(shared_ids, cow_src, cached_len)``; the match is capped at
        ``len(prompt) - 1`` so at least one suffix token is re-prefilled
        (the logits after the last prompt token are not cached)."""
        shared: List[int] = []
        cow_src = None
        c = 0
        if not self.prefix_cache:
            return shared, cow_src, 0
        p = len(prompt)
        parent = -1
        while c + self.bs <= p - 1:
            tok = tuple(int(t) for t in prompt[c:c + self.bs])
            b = self._children.get(parent, {}).get(tok)
            if b is None or b in self._pending:
                break
            shared.append(b)
            parent = b
            c += self.bs
        rem_cap = min(p - 1 - c, self.bs)
        if rem_cap > 0:
            want = tuple(int(t) for t in prompt[c:c + rem_cap])
            best_m = 0
            for tok, b in self._children.get(parent, {}).items():
                if b in self._pending:
                    continue
                m = 0
                while m < rem_cap and tok[m] == want[m]:
                    m += 1
                if m > best_m:      # ties: first-inserted child wins
                    best_m, cow_src = m, b
            c += best_m
        return shared, cow_src, c

    def _index_prompt(self, slot: int, prompt: np.ndarray,
                      n_shared: int, via_suffix: bool) -> None:
        """Record the slot's fully-covered prompt blocks as trie nodes;
        blocks written by an in-flight suffix scan are marked pending."""
        if not self.prefix_cache:
            return
        parent = -1
        created = self._fresh_nodes.setdefault(slot, [])
        for i in range(len(prompt) // self.bs):
            tok = tuple(int(t) for t in prompt[i * self.bs:
                                               (i + 1) * self.bs])
            kids = self._children.setdefault(parent, {})
            b = kids.get(tok)
            if b is None:
                b = int(self.tables[slot, i])
                kids[tok] = b
                self._node[b] = (parent, tok)
                created.append(b)
                if via_suffix and i >= n_shared:
                    self._pending.add(b)
            parent = b

    def clear_pending(self) -> None:
        """A submitted step folded back: suffix-written blocks are real and
        in-flight CoW sources have been copied."""
        self._pending.clear()
        self._hold.clear()

    def _unindex(self, bid: int) -> None:
        """Drop ``bid`` and its (now unreachable) descendants from the
        trie; unreferenced descendants return to the free list."""
        parent, tok = self._node.pop(bid)
        kids = self._children.pop(bid, {})
        d = self._children.get(parent)
        if d is not None:
            d.pop(tok, None)
            if not d and parent != -1:
                del self._children[parent]
        self._pending.discard(bid)
        for child in kids.values():
            self._unindex(child)
            if self.ref[child] == 0 and child in self._cached_free:
                del self._cached_free[child]
                self._free_blocks.append(child)

    # ------------------------------------------------------- block alloc
    def _alloc_block(self) -> int:
        """A private block: free list first, then LRU-evict a cached-free
        block; ``PoolExhausted`` when every block is referenced."""
        evictable = (b for b in self._cached_free if b not in self._hold)
        if self._free_blocks:
            b = self._free_blocks.pop()
        elif (b := next(evictable, None)) is not None:  # LRU: oldest first
            del self._cached_free[b]
            self._unindex(b)
            self.stats["evictions"] += 1
        else:
            raise PoolExhausted(
                "KV block pool exhausted: all "
                f"{self.num_blocks - 1} blocks referenced by live slots "
                "(the engine preempts a victim when this surfaces "
                "mid-decode; a single request whose context exceeds the "
                "pool cannot be served — raise num_blocks)")
        self.ref[b] = 1
        return b

    def _ref_inc(self, bid: int) -> None:
        if self.ref[bid] == 0:
            self._cached_free.pop(bid, None)      # resurrected from cache
        self.ref[bid] += 1

    def can_admit(self, prompt, max_new_tokens: int = 0) -> bool:
        """True when a request's *prompt* fits now: a free slot plus enough
        allocatable blocks for its non-shared prompt blocks (``prompt`` is
        a token array, or a bare length for the no-match worst case)."""
        if not self._free_slots:
            return False
        if isinstance(prompt, (int, np.integer)):
            p, n_shared, n_spoken_for = int(prompt), 0, len(self._hold)
        else:
            p = len(prompt)
            shared, cow_src, _ = self.match_prefix(prompt)
            n_shared = len(shared)
            n_spoken_for = (sum(1 for b in shared if self.ref[b] == 0)
                            + sum(1 for b in self._hold
                                  if b in self._cached_free
                                  and b not in shared))
            if (cow_src is not None and self.ref[cow_src] == 0
                    and cow_src not in self._hold):
                n_spoken_for += 1
        nb0 = -(-p // self.bs)
        return self.available_blocks() - n_spoken_for >= nb0 - n_shared

    def used_blocks(self) -> int:
        """Blocks referenced by live slots (cached-free excluded)."""
        return int((self.ref[1:] > 0).sum())

    def written_tokens(self) -> int:
        """Logical tokens resident across slots (shared prefixes count once
        per sharer)."""
        return int(self.pos[self.active | (self.pos > 0)].sum())

    def alloc_slot(self, prompt, max_new_tokens: int = 0,
                   force_suffix: bool = False):
        """Claim a free slot for ``prompt``; cursor starts at its length.
        Returns ``(slot, new_ids, cached_len, cow_pair)``: ``new_ids`` are
        the blocks a full prefill must write, ``cow_pair`` is ``(src,
        dst)`` or None.  ``force_suffix`` marks the row suffix-prefilled
        regardless of match (restores)."""
        if isinstance(prompt, (int, np.integer)):
            p = int(prompt)
            shared, cow_src, cached_len = [], None, 0
            indexable = False
        else:
            prompt = np.asarray(prompt, np.int32)
            p = len(prompt)
            shared, cow_src, cached_len = self.match_prefix(prompt)
            indexable = True
        slot = self._free_slots.pop()
        nb0 = -(-p // self.bs)
        for b in shared:
            self._ref_inc(b)
        cow_pair = None
        new_ids = []
        row = list(shared)
        if cow_src is not None:
            if self.ref[cow_src] == 0:
                # shield a cached-free source from eviction until the
                # round's device copy has read it
                self._hold.add(cow_src)
            dst = self._alloc_block()
            cow_pair = (cow_src, dst)
            row.append(dst)
            self.stats["cow_copies"] += 1
        while len(row) < nb0:
            b = self._alloc_block()
            new_ids.append(b)
            row.append(b)
        self.tables[slot, :] = 0
        self.tables[slot, :nb0] = row
        self.pos[slot] = p
        self.n_blocks_of[slot] = nb0
        self.tables_version += 1
        if indexable:
            self._index_prompt(slot, prompt, len(shared),
                               via_suffix=force_suffix or cached_len > 0)
            self.stats["hit_tokens"] += cached_len
            self.stats["prompt_tokens"] += p
        return slot, np.asarray(new_ids, np.int32), cached_len, cow_pair

    def grow_for_window(self, counts) -> None:
        """Before a decode window every active slot must own every block
        its next ``counts[slot]`` writes land in (writes clamp at
        ``capacity - 1``).  Raises :class:`PoolExhausted`; resumable."""
        for slot in np.nonzero(self.active)[0]:
            n = int(counts[slot])
            if n <= 0:
                continue
            last = min(int(self.pos[slot]) + n - 1, self.capacity - 1)
            top = min(last // self.bs, self.max_blk - 1)
            while int(self.n_blocks_of[slot]) <= top:
                blk_i = int(self.n_blocks_of[slot])
                self.tables[slot, blk_i] = self._alloc_block()
                self.n_blocks_of[slot] = blk_i + 1
                self.tables_version += 1

    def free_slot(self, slot: int) -> None:
        """Retire (or preempt) a slot: decrement each referenced block and
        point its table row at the trash block."""
        for j in range(int(self.n_blocks_of[slot])):
            b = int(self.tables[slot, j])
            self.ref[b] -= 1
            if self.ref[b] == 0:
                if b in self._node:
                    self._cached_free[b] = None       # LRU tail
                else:
                    self._free_blocks.append(b)
        self.tables[slot, :] = 0
        self.pos[slot] = 0
        self.active[slot] = False
        self.n_blocks_of[slot] = 0
        self.tables_version += 1
        self._fresh_nodes.pop(slot, None)
        self._free_slots.append(slot)

    def cancel_slot(self, slot: int) -> None:
        """Undo an admission whose prefill never ran: its freshly created
        trie nodes point at unwritten blocks and leave the index first."""
        for b in self._fresh_nodes.get(slot, ()):
            if b in self._node:
                self._unindex(b)
        self.free_slot(slot)


@dataclasses.dataclass
class _Slot:
    """One request occupying one decode slot; ``token_ts`` mirrors ``out``
    with each token's streamed delivery time."""

    req: ServeRequest
    out: List[int]
    first_token_t: float = 0.0
    token_ts: List[float] = dataclasses.field(default_factory=list)


def _carried_ts(req: ServeRequest, n: int) -> List[float]:
    """Delivery stamps carried across preempt/restore, clamped to ``n``
    tokens and padded with the TTFT stamp."""
    ts = list(req.token_ts[:n])
    pad = req.first_token_t if req.first_token_t is not None else 0.0
    return ts + [pad] * (n - len(ts))


class _SlotEngine:
    """A clone's decode loop: max_batch slots over one paged KV pool.

    A request is admitted into any free slot at any time — including while
    a step is in flight — and its prefill folds into the next step; slots
    retire independently at step granularity.
    """

    def __init__(self, backend, clone, kv: KVBlockPool, window: int = 1,
                 chunk: int = 0, mixed: bool = False):
        self.backend = backend
        self.clone = clone
        self.kv = kv
        self.window = window
        self.chunk = chunk          # suffix prefill tokens per step (0 = 1)
        self.mixed = mixed          # fold suffix chunks into the window
        self.prefill_into, self.decode_window = backend.paged_fns(kv.bs,
                                                                  window)
        self.slots: List[Optional[_Slot]] = [None] * kv.max_slots
        self.tok_host = np.zeros((kv.max_slots,), np.int32)
        self.joins: List[tuple] = []        # (slot, req, eff, blk_ids)
        self.sfx_joins: List[tuple] = []    # (slot, req, sfx, pos0, restore)
        self.cow_pairs: List[tuple] = []    # (slot, src, dst) this round
        # inbound KV moves folded into the next step as a device copy:
        # (slot, req, out, first_token_t, src_pool, src_ids, dst_ids,
        # src_slot, n_tokens, kind), kind "disagg" (a handoff from the
        # partner's scratch pool) or "recover" (a drained clone's slot)
        self.migrations: List[tuple] = []
        self.submitted_joins: List[tuple] = []
        self.submitted_sfx: List[tuple] = []
        self.submitted_migrations: List[tuple] = []
        self.decode_rows: Optional[np.ndarray] = None
        self.decode_counts: Optional[np.ndarray] = None
        self._tables_dev = None
        self._tables_ver = -1
        # speculative decoding (ADR-008): the paired draft clone, the draft
        # model's pool (same block tables as ``kv``), per-slot draft
        # cursors (``dpos <= kv.pos``: the gap is the history the next
        # catch-up replays), the stashed verify builder and per-row k of
        # the round in flight, the (drafts, n_spec) awaiting acceptance;
        # ``spec_on`` goes stickily False when acceptance collapses
        self.spec_on = False
        self.draft_clone = None
        self.draft_pool = None
        self.spec_k = 0
        self.dpos = np.zeros((kv.max_slots,), np.int32)
        self._verify_builder = None
        self._spec_round: Optional[np.ndarray] = None
        self.spec_pending: Optional[tuple] = None
        self.spec_rounds_done = 0
        # disaggregated prefill (ADR-009): the shared partner clone and
        # this engine's scratch pool on it, rows waiting for the partner
        # dispatch or riding one, and the decode-pool blocks still waiting
        # for their handoff (kept pending, so no sharer reads them early)
        self.disagg_on = False
        self.prefill_clone = None
        self.prefill_pool: Optional[KVBlockPool] = None
        self.disagg_joins: List[tuple] = []       # (slot, req, eff, new_ids)
        self.submitted_disagg: List[tuple] = []
        self.disagg_blocks: Dict[int, List[int]] = {}
        # one step and at most one partner prefill in flight at a time
        self.main_inflight = False
        self.disagg_inflight = False

    def device_tables(self):
        """Device copy of ``kv.tables``, re-uploaded only when dirty."""
        if self._tables_ver != self.kv.tables_version:
            self._tables_dev = self.backend.tensor(self.kv.tables)
            self._tables_ver = self.kv.tables_version
        return self._tables_dev

    @staticmethod
    def effective_prompt(req: ServeRequest, prompt_pad: int,
                         capacity: int) -> np.ndarray:
        """The tokens a slot's prefill must make resident: the prompt
        zero-padded to ``prompt_pad``; for a restore, plus every generated
        token except the last (the next decode input), clamped to
        ``capacity``."""
        base = np.zeros((prompt_pad,), np.int32)
        base[:min(len(req.prompt), prompt_pad)] = req.prompt[:prompt_pad]
        if not req.generated:
            return base
        eff = np.concatenate(
            [base, np.asarray(req.generated[:-1], np.int32)])
        return eff[:capacity]

    def admit(self, req: ServeRequest, prompt_pad: int) -> dict:
        """Claim a slot + blocks; route the row to the batched full
        prefill (no cached prefix) or the suffix prefill (prefix hit or
        restore).  Returns admission stats."""
        restore = bool(req.generated)
        eff = self.effective_prompt(req, prompt_pad, self.kv.capacity)
        slot, new_ids, cached_len, cow = self.kv.alloc_slot(
            eff, req.max_new_tokens, force_suffix=restore)
        if cow is not None:
            self.cow_pairs.append((slot,) + cow)
        if restore or cached_len > 0:
            sfx = eff[cached_len:]
            self.sfx_joins.append((slot, req, sfx, cached_len, restore))
            return {"cached": cached_len, "suffix": len(sfx),
                    "restore": restore, "prompt": len(eff)}
        self.joins.append((slot, req, eff, new_ids))
        return {"cached": 0, "suffix": 0, "restore": False,
                "prompt": len(eff)}

    def alive(self) -> bool:
        return (any(s is not None for s in self.slots)
                or bool(self.joins) or bool(self.sfx_joins)
                or bool(self.migrations) or bool(self.disagg_joins)
                or bool(self.submitted_disagg))

    def step_work(self) -> bool:
        """Work for the engine's own clone; rows parked on the disagg
        partner wait for their handoff instead of an empty step."""
        return (bool(self.kv.active.any()) or bool(self.joins)
                or bool(self.sfx_joins) or bool(self.migrations))


@dataclasses.dataclass
class _Cohort:
    """Requests admitted at one step boundary, decoding in lockstep.

    The *contiguous* (``kv="contiguous"``) batching unit: one shared
    position cursor, so only requests admitted at the same step boundary
    fuse, and late arrivals wait for a clone to free up.
    """

    reqs: List[ServeRequest]
    clone: object
    plen: int
    outs: List[List[int]] = dataclasses.field(default_factory=list)
    first_token_t: List[float] = dataclasses.field(default_factory=list)
    token_ts: List[List[float]] = dataclasses.field(default_factory=list)
    cache: object = None
    tok: object = None
    step: int = 0
    phase: str = "prefill"


@dataclasses.dataclass
class ServeReport:
    """One ``ClientHandler.run`` outcome: latency, elasticity, KV economy.

    ``kv_util`` is the time-averaged fraction of reserved KV memory holding
    written tokens (above 1.0 with prefix sharing); ``prefix_hit_rate`` is
    cached / total prompt tokens over all admissions; ``preemptions`` counts
    slot evictions under pool pressure and ``restored_tokens`` the tokens
    re-prefilled bringing victims back.  Fleet economics: completions per
    clone type, escalations, RUNNING clone-seconds and $ per type, busy
    energy per type, power-offs.
    """

    completions: List[ServeCompletion]
    accepted: int
    rejected: int
    makespan_s: float
    p50_latency_s: float
    p99_latency_s: float
    p50_ttft_s: float
    tokens_per_s: float
    peak_secondaries: int
    scale_ups: int
    busy_energy_j: float
    pool_stats: Dict
    clone_samples: List[tuple]
    kv_mode: str = "paged"
    kv_util: float = 0.0
    kv_reserved_peak: int = 0
    prefix_hit_rate: float = 0.0
    preemptions: int = 0
    restored_tokens: int = 0
    fleet_mix: Dict[str, int] = dataclasses.field(default_factory=dict)
    escalations: int = 0
    clone_seconds_by_type: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    cost_usd: float = 0.0
    energy_j_by_type: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    power_offs: int = 0
    # speculative decoding (ADR-008): completed draft + verify rounds, the
    # tokens they emitted, accepted / proposed draft tokens, and engines
    # that served plainly (no draft clone, or acceptance collapsed)
    spec_rounds: int = 0
    spec_tokens: int = 0
    acceptance_rate: float = 0.0
    spec_fallbacks: int = 0
    # disaggregated prefill (ADR-009): prompts prefilled on the partner
    # whose blocks migrated to the decode clone, candidates the planner
    # kept local, engines without a partner, and the modeled handoff
    # traffic (int8 payload + scales when compressed) and its link time
    disagg_handoffs: int = 0
    disagg_colocated: int = 0
    disagg_fallbacks: int = 0
    kv_transfer_bytes: float = 0.0
    kv_transfer_s: float = 0.0
    # fault tolerance (ADR-006): fired clone faults (kills, drains and
    # slowdowns), in-flight requests whose KV blocks moved to a survivor,
    # those requeued to re-prefill, straggling steps raced on a second
    # clone and the races the duplicate won, breaker open transitions
    faults_injected: int = 0
    recoveries_migrated: int = 0
    recoveries_restored: int = 0
    hedges_fired: int = 0
    hedge_wins: int = 0
    breaker_opens: int = 0
    # the SLO gateway (ADR-007): per SLO class the fraction of *offered*
    # requests served inside their deadline (no deadline counts as met;
    # rejected, shed or dropped work as missed), deadline-meeting tokens
    # per second (cache hits included), backlog sheds, up-front
    # rejections, Retry-After replays, exact-match cache hits, sheds per
    # class, served / p50 TTFT / p50 TPOT per tenant, and the deepest
    # admission queue (gateway backlog included)
    slo_attainment: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    goodput_tps: float = 0.0
    gateway_shed: int = 0
    gateway_rejected: int = 0
    gateway_retries: int = 0
    cache_hits: int = 0
    shed_by_slo: Dict[str, int] = dataclasses.field(default_factory=dict)
    per_tenant: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    peak_queue_depth: int = 0
    # per-clone routing telemetry, keyed by clone id: clone type, prefix
    # hit rate, and the KV handoff volume and link seconds the clone took
    # in (disaggregated prefill)
    per_clone: Dict[str, Dict[str, object]] = dataclasses.field(
        default_factory=dict)

    def summary(self) -> str:
        """One-line digest; the fault and gateway parts appear only when
        a fault or hedge fired or the gateway shed, rejected, retried or
        answered from its cache."""
        out = (f"served={len(self.completions)} shed={self.rejected} "
               f"p50={self.p50_latency_s:.3f}s p99={self.p99_latency_s:.3f}s "
               f"ttft50={self.p50_ttft_s:.3f}s "
               f"tok/s={self.tokens_per_s:.1f} "
               f"kv={self.kv_mode} kv_util={self.kv_util:.0%} "
               f"prefix_hits={self.prefix_hit_rate:.0%} "
               f"preempt={self.preemptions} "
               f"peak_secondaries={self.peak_secondaries}")
        if self.faults_injected or self.hedges_fired:
            out += (f" faults={self.faults_injected} "
                    f"migrated={self.recoveries_migrated} "
                    f"restored={self.recoveries_restored} "
                    f"hedges={self.hedges_fired}/{self.hedge_wins}")
        if (self.gateway_shed or self.gateway_rejected
                or self.gateway_retries or self.cache_hits):
            slo = " ".join(f"{k}:{v:.0%}"
                           for k, v in sorted(self.slo_attainment.items()))
            out += (f" slo=[{slo}] goodput={self.goodput_tps:.1f} "
                    f"gw_shed={self.gateway_shed} "
                    f"gw_rejected={self.gateway_rejected} "
                    f"cache_hits={self.cache_hits}")
        return out


def _with_cost(fn: Callable, **cost) -> Callable:
    """``fn`` wrapped (name kept) to carry step-cost attributes for a
    step-aware executor: ``seq_steps`` (sequential scan steps the dispatch
    runs), ``step_scale`` (venue-time scale against a target step) and
    ``prefill_tokens`` (prompt tokens of a batched prefill)."""
    @functools.wraps(fn)
    def run(*args):
        return fn(*args)
    run.__dict__.update(cost)
    return run


class ClientHandler:
    """Event-driven continuous-batching server on an elastic clone pool:
    with ``kv="paged"`` each clone runs a :class:`_SlotEngine` —
    ``max_batch`` slots over a :class:`KVBlockPool`, per-slot cursors,
    mid-flight admission; with ``kv="contiguous"`` each clone decodes one
    :class:`_Cohort` in lockstep."""

    def __init__(self, backend, *, link: str = "wifi-local",
                 clone_type: str = "main", max_batch: int = 4,
                 queue_depth: int = 64, max_secondaries: int = 8,
                 min_secondaries: int = 0, work_per_clone: int = 1,
                 prompt_pad: int = 8, use_primary: bool = True,
                 provision_paused: bool = True,
                 kv: str = "paged", block_size: int = 8,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 decode_window: int = 1,
                 prefill_chunk: Optional[int] = None,
                 mixed_dispatch: Optional[bool] = None,
                 fleet: Optional[List[str]] = None,
                 placement_policy: Policy = Policy.EXEC_TIME_AND_ENERGY,
                 energy_model: Optional[GpuEnergyModel] = None,
                 provision: Optional[Dict[str, int]] = None,
                 executor: Optional[Callable] = None,
                 pool: Optional[ClonePool] = None,
                 clock: Optional[VirtualClock] = None,
                 breaker_max_open_s: Optional[float] = None,
                 breaker_max_probes: Optional[int] = None,
                 speculative: bool = False, spec_k: int = 4,
                 spec_corruption: float = 0.0,
                 draft_cost: Optional[float] = None,
                 routing: str = "ledger",
                 disagg: bool = False, disagg_link: str = "nvlink",
                 disagg_compress: bool = False,
                 disagg_min_prompt: Optional[int] = None,
                 disagg_prefill_type: Optional[str] = None,
                 faults: Optional[List[CloneFault]] = None,
                 hedge_factor: float = 0.0,
                 hedge_quantile: float = 0.95,
                 hedge_min_samples: int = 8,
                 gateway: Optional[StreamingGateway] = None):
        if kv not in ("paged", "contiguous"):
            raise ValueError(f"kv must be 'paged' or 'contiguous': {kv!r}")
        # fault tolerance (ADR-006); a hedge re-runs a step closure on the
        # engine's own pool, which the idempotent closures allow (the
        # reference refuses hedging with a donated pool; the port has none)
        if faults and kv != "paged":
            raise ValueError("fault injection requires kv='paged' — the "
                             "contiguous cohort keeps no per-slot restore "
                             "state, so a clone death would lose tokens")
        if hedge_factor > 0 and kv != "paged":
            raise ValueError("hedged dispatch races _SlotEngine decode "
                             "windows; it requires kv='paged'")
        # speculative decoding (ADR-008)
        if speculative:
            if kv != "paged":
                raise ValueError("speculative decoding scores draft "
                                 "windows through per-slot block tables; "
                                 "it requires kv='paged'")
            if not getattr(backend, "supports_speculative", False):
                raise ValueError("speculative decoding needs a backend "
                                 "with a bound draft model "
                                 "(LMBackend(draft=...)) and chunked-"
                                 "verify support")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1: {spec_k}")
        # prefix-affinity / random routing (ADR-009): "ledger" is the pure
        # free-slot policy, "affinity" prefers engines by prefix-match
        # depth, "random" is the affinity sweep's control arm
        if routing not in ("ledger", "affinity", "random"):
            raise ValueError("routing must be 'ledger', 'affinity' or "
                             f"'random': {routing!r}")
        if routing != "ledger" and kv != "paged":
            raise ValueError("prefix-affinity/random routing scores the "
                             "paged prefix index; it requires kv='paged'")
        # disaggregated prefill (ADR-009)
        if disagg:
            if kv != "paged":
                raise ValueError("disaggregated prefill migrates paged KV "
                                 "blocks between clones; it requires "
                                 "kv='paged'")
            if not getattr(backend, "supports_chunked", False):
                raise ValueError("disaggregated prefill replays prompts "
                                 "through the chunked paged-prefill scan; "
                                 "the backend must support chunked prefill "
                                 "(all-attention, windowless layers)")
            if speculative:
                raise ValueError("disaggregated prefill and speculative "
                                 "decoding both pair the engine with a "
                                 "partner clone; run one at a time")
            if disagg_link not in LINKS:
                raise ValueError(f"unknown disagg_link {disagg_link!r}; "
                                 f"known: {sorted(LINKS)}")
        if disagg_prefill_type is not None \
                and disagg_prefill_type not in CLONE_TYPES:
            raise ValueError(f"unknown disagg_prefill_type "
                             f"{disagg_prefill_type!r}")
        self.routing = routing
        self.speculative = speculative
        self.spec_k = spec_k
        self.spec_corruption = spec_corruption
        # venue-time scale of a draft dispatch against a target step (the
        # ``step_scale`` a step-aware executor reads); defaults to the
        # parameter-count ratio
        self.draft_cost = (draft_cost if draft_cost is not None
                           else getattr(backend, "draft_cost_ratio", 1.0))
        self.disagg = disagg
        self.disagg_link = disagg_link
        self.disagg_compress = disagg_compress
        self.disagg_min_prompt = disagg_min_prompt
        if decode_window < 1:
            raise ValueError(f"decode_window must be >= 1: {decode_window}")
        if decode_window > 1 and kv != "paged":
            raise ValueError("decode_window > 1 requires kv='paged' (the "
                             "contiguous cohort path decodes per token)")
        window = backend.cfg.window
        if kv == "paged" and window is not None:
            raise NotImplementedError(
                f"{backend.cfg.name}: paged KV cache requires full attention "
                "(cfg.window=None); use kv='contiguous'")
        if window is not None and prompt_pad > window and prompt_pad % window:
            raise ValueError(
                f"prompt_pad {prompt_pad} exceeds the {window}-token window "
                "without being a multiple of it: the prefill would fill the "
                "ring cache out of phase")
        if kv == "paged" and model.has_state_rows(backend.cfg):
            raise NotImplementedError(
                f"{backend.cfg.name}: recurrent state is not served from the "
                "paged pool (the reference's paged path corrupts it, "
                "ROADMAP Queue 3); use kv='contiguous'")
        chunk_ok = kv == "paged" and bool(getattr(backend, "supports_chunked",
                                                  False))
        if prefill_chunk is None:
            prefill_chunk = 8 if chunk_ok else 0
        elif prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0: {prefill_chunk}")
        elif prefill_chunk > 0 and not chunk_ok:
            raise ValueError("prefill_chunk > 0 requires kv='paged' and a "
                             "backend with chunked-prefill support "
                             "(all-attention, windowless layers)")
        if mixed_dispatch is None:
            # a speculative round's decode tile is a verify window, which
            # the fused mixed scan has no variant of
            mixed_dispatch = prefill_chunk > 0 and not speculative
        elif mixed_dispatch and speculative:
            raise ValueError("mixed_dispatch and speculative decoding are "
                             "mutually exclusive: the spec round's decode "
                             "tile is a verify window, not a decode scan")
        elif mixed_dispatch and prefill_chunk == 0:
            raise ValueError("mixed_dispatch requires prefill_chunk > 0 "
                             "(the fused step advances chunk tokens per "
                             "scan step)")
        self.prefill_chunk = prefill_chunk
        self.mixed_dispatch = mixed_dispatch
        self.kv_mode = kv
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.prefix_cache = prefix_cache
        self.decode_window = decode_window
        self.backend = backend
        breaker_kwargs = {}
        if breaker_max_open_s is not None:
            breaker_kwargs["max_open_seconds"] = breaker_max_open_s
        if breaker_max_probes is not None:
            breaker_kwargs["max_probes"] = breaker_max_probes
        if pool is not None:
            if not getattr(pool.clock, "virtual", False):
                raise TypeError("ClientHandler needs a pool on a "
                                "VirtualClock")
            if clock is not None and clock is not pool.clock:
                raise ValueError("pool and clock disagree — pass one "
                                 "timeline")
            self.clock = pool.clock
            self.pool = pool
            if breaker_kwargs:
                self.pool.breaker_kwargs.update(breaker_kwargs)
                for c in self.pool.clones:
                    c.breaker = CircuitBreaker(**self.pool.breaker_kwargs)
        else:
            self.clock = clock or VirtualClock()
            self.pool = ClonePool(link_name=link, clock=self.clock,
                                  max_clones=max_secondaries + 8,
                                  breaker_kwargs=breaker_kwargs)
        self.dispatcher = Dispatcher(self.pool, self.clock)
        self.queue = AdmissionQueue(queue_depth)
        names = set(fleet or []) | {clone_type}
        self.fleet = sorted(names, key=lambda n: CLONE_TYPES[n].rank())
        self._fleet_set = set(self.fleet)
        self.energy = energy_model or GpuEnergyModel()
        self.placement = PlacementEngine(self.pool, fleet=self.fleet,
                                         policy=placement_policy,
                                         energy=self.energy)
        self.autoscaler = FleetAutoscaler(
            self.pool, self.placement, base_type=clone_type,
            work_per_clone=work_per_clone,
            min_secondaries=min_secondaries, max_secondaries=max_secondaries)
        if provision_paused:     # paper §5.3: secondaries pre-created paused
            self.pool.provision(clone_type, max_secondaries)
        for tname, n in (provision or {}).items():
            self.pool.provision(tname, n)
        self.clone_type = clone_type
        self.max_batch = max_batch
        self.prompt_pad = prompt_pad
        self.use_primary = use_primary
        if not use_primary and max_secondaries < 1:
            raise ValueError("no primary and no secondaries: nothing can run")
        # executor(clone, fn, args) -> (value, venue_seconds); the default
        # times the closure on the backend's device, scaled to the clone
        if executor is None:
            device = getattr(backend, "device", "cpu")

            def executor(clone, fn, args):
                return Venue(clone.spec, device).execute(fn, *args)
        self.executor = executor
        self.busy_energy_j = 0.0
        self.tokens_emitted = 0
        self.ledger = SlotLedger()
        self.kv_samples: List[tuple] = []   # (written_tokens, reserved)
        self._kv_pools: Dict[int, KVBlockPool] = {}   # clone.cid -> pool
        self.preemptions = 0
        self.restored_tokens = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.energy_j_by_type: Dict[str, float] = {}
        self.busy_seconds_by_type: Dict[str, float] = {}
        self.fleet_mix: Dict[str, int] = {}
        self._escalated: set = set()
        self.demand_by_class: Dict[tuple, int] = {}
        self._band_cache: Dict[int, tuple] = {}
        # speculative telemetry; ``_spec_rng`` drives the deterministic
        # proposal corruption, drawn on the host only (never in a closure
        # an executor may re-run)
        self.spec_rounds = 0
        self.spec_tokens = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_fallbacks = 0
        self.spec_draft_cids: List[int] = []
        self._spec_rng = np.random.default_rng(0xC0FFEE)
        # disaggregated prefill + routing: the partner tier defaults to the
        # top of the fleet; ONE partner clone is shared, refcounted, by
        # every disagg engine, each keeping a private scratch pool on it
        # (keyed by its decode clone); the seeded rng keeps "random"
        # routing deterministic
        self.disagg_prefill_type = disagg_prefill_type or self.fleet[-1]
        self._prefill_pools: Dict[int, KVBlockPool] = {}
        self._partner_clone = None
        self._partner_refs = 0
        self._route_rng = np.random.default_rng(0xD15A66)
        self.disagg_handoffs = 0
        self.disagg_colocated = 0
        self.disagg_fallbacks = 0
        self.kv_transfer_bytes = 0.0
        self.kv_transfer_s = 0.0
        self.per_clone_stats: Dict[int, Dict[str, object]] = {}
        self._disagg_blk_bytes: Optional[int] = None
        # the SLO gateway shares the serving timeline; it hears of a kill
        # or drain at the fault instant (the capacity-loss signal)
        self.gateway = gateway
        if gateway is not None:
            gateway.adopt_clock(self.clock)
        self.injector = (FaultInjector(
            self.pool, faults,
            on_fire=(gateway.note_fault if gateway is not None else None))
            if faults else None)
        self._peak_queue_depth = 0
        self.hedge_factor = hedge_factor
        self.hedge_quantile = hedge_quantile
        self.hedge_min_samples = hedge_min_samples
        self.recoveries_migrated = 0
        self.recoveries_restored = 0
        self.hedges_fired = 0
        self.hedge_wins = 0
        self._hedges: Dict[object, object] = {}   # task <-> its duplicate
        self._step_hist: List[float] = []         # step durations so far
        self._kv_tok_bytes: Optional[float] = None

    # ---------------------------------------------------------------- clones
    def _free_clone(self, lo_rank: Optional[int] = None,
                    hi_rank: Optional[int] = None,
                    prefer_cid: Optional[int] = None):
        """Best usable clone inside the ``[lo_rank, hi_rank]`` band:
        soonest-ready first, then the smallest tier, then cid.  The primary
        is exempt from the band's upper bound (standing capacity).
        ``prefer_cid`` (affinity routing) wins among the candidates tied on
        readiness; ``routing="random"`` picks uniformly."""
        def in_band(rank, primary=False):
            return ((lo_rank is None or rank >= lo_rank)
                    and (primary or hi_rank is None or rank <= hi_rank))

        now = self.clock.now()
        cands = []
        p = self.pool.primary
        if self.use_primary and not p.busy and p.serveable \
                and in_band(p.ctype.rank(), primary=True):
            cands.append((0.0, p.ctype.rank(), 0, p))
        for c in self.pool.running_secondaries():
            if c.busy or not c.serveable \
                    or c.ctype.name not in self._fleet_set:
                continue
            if not in_band(c.ctype.rank()):
                continue
            cands.append((self.autoscaler.clone_ready_delay(c, now),
                          c.ctype.rank(), c.cid, c))
        if not cands:
            return None
        if self.routing == "random":
            return cands[int(self._route_rng.integers(len(cands)))][3]
        best = min(cands)
        if prefer_cid is not None:
            for c in cands:
                if c[3].cid == prefer_cid and c[0] <= best[0] + 1e-12:
                    return c[3]
        return best[3]

    def _net_s(self, nbytes: int) -> float:
        return transfer_time(nbytes, self.pool.link)

    def _kv_token_bytes(self) -> float:
        """KV bytes of one context token (what a migration or a hedge's
        context transfer moves per token), from the backend's cache
        accounting; backends without one (test fakes) count 64."""
        if self._kv_tok_bytes is None:
            fn = getattr(self.backend, "cache_mem_bytes", None)
            self._kv_tok_bytes = (float(fn(1)) / self.backend.capacity
                                  if fn is not None else 64.0)
        return self._kv_tok_bytes

    # ------------------------------------------- disagg / affinity (ADR-009)
    def _disagg_block_bytes(self) -> int:
        """Modeled wire bytes of one KV block on the handoff link
        (``venues.kv_block_bytes``: int8 payload + per-head scales when
        compressing)."""
        if self._disagg_blk_bytes is None:
            self._disagg_blk_bytes = kv_block_bytes(
                self.backend.cfg, self.block_size,
                quantized=self.disagg_compress)
        return self._disagg_blk_bytes

    def _disagg_worth(self, engine: _SlotEngine, plen: int) -> bool:
        """Ship the prefill to the partner only when the modeled prefill
        time it saves (prompt FLOPs at the decode tier vs the partner
        tier) exceeds the handoff's wire time on ``disagg_link``; an
        explicit ``disagg_min_prompt`` replaces the model with a length
        threshold."""
        if self.disagg_min_prompt is not None:
            return plen >= self.disagg_min_prompt
        flops = 2.0 * model.n_params(self.backend.cfg) * plen
        gain = (flops / engine.clone.spec.eff_flops
                - flops / engine.prefill_clone.spec.eff_flops)
        nb = -(-plen // self.block_size)
        wire = transfer_time(nb * self._disagg_block_bytes(),
                             LINKS[self.disagg_link])
        return gain > wire

    def _affinity_depth(self, kvp: KVBlockPool, req: ServeRequest) -> int:
        """Cached-prefix depth (tokens) ``kvp`` holds for ``req`` (pure)."""
        eff = _SlotEngine.effective_prompt(req, self.prompt_pad,
                                           self.backend.capacity)
        return int(kvp.match_prefix(eff)[2])

    def _affinity_by_type(self, req: ServeRequest) -> Dict[str, int]:
        """Best prefix-match depth per tier over live clone pools: the
        ``prefix_affinity`` hint of ``PlacementEngine.choose_type``."""
        out: Dict[str, int] = {}
        by_cid = {c.cid: c for c in self.pool.clones}
        for cid, kvp in self._kv_pools.items():
            clone = by_cid.get(cid)
            if clone is None or not clone.serveable:
                continue
            d = self._affinity_depth(kvp, req)
            t = clone.ctype.name
            out[t] = max(out.get(t, 0), d)
        return out

    def _best_affinity_cid(self, req: ServeRequest) -> Optional[int]:
        """Clone id with the deepest cached prefix for ``req`` (pools
        persist across engine generations on one clone)."""
        best, best_d = None, 0
        for cid, kvp in sorted(self._kv_pools.items()):
            d = self._affinity_depth(kvp, req)
            if d > best_d:
                best, best_d = cid, d
        return best

    def _charge(self, clone, venue_seconds: float) -> None:
        """Bill one dispatch's busy energy, chips-aware."""
        e = self.energy.busy_j(chips=clone.spec.chips, seconds=venue_seconds)
        self.busy_energy_j += e
        t = clone.ctype.name
        self.energy_j_by_type[t] = self.energy_j_by_type.get(t, 0.0) + e
        self.busy_seconds_by_type[t] = (
            self.busy_seconds_by_type.get(t, 0.0) + venue_seconds)

    def _blocks_for_type(self, type_name: str) -> int:
        """KV block-pool size for an engine on this clone type: the base
        tier gets ``num_blocks``, bigger tiers scale with the fleet memory
        ladder, all capped at the worst case every slot could write."""
        max_blk = -(-self.backend.capacity // self.block_size)
        worst = self.max_batch * max_blk + 1
        if self.num_blocks is None:
            return worst
        if len(self.fleet) == 1:
            return self.num_blocks
        scale = (KV_SCALE_BY_CLONE_TYPE[type_name]
                 / KV_SCALE_BY_CLONE_TYPE[self.clone_type])
        return min(worst, max(2, int(self.num_blocks * scale)))

    def _request_blocks(self, req: ServeRequest) -> int:
        """Worst-case KV blocks this request's slot can come to hold."""
        p = self.prompt_pad
        if req.generated:
            p = min(p + len(req.generated) - 1, self.backend.capacity)
        total = min(p + req.max_new_tokens, self.backend.capacity)
        max_blk = -(-self.backend.capacity // self.block_size)
        return min(-(-max(total, p) // self.block_size), max_blk)

    def _required_type(self, req: ServeRequest) -> str:
        """The smallest fleet tier whose block pool holds this request
        (the paper's OutOfMemoryError -> bigger-VM escalation)."""
        if len(self.fleet) == 1:
            return self.clone_type
        t = self.placement.required_type(
            self.clone_type, self._request_blocks(req),
            lambda n: self._blocks_for_type(n) - 1)   # -1: trash block
        if t != self.clone_type:
            self._escalated.add(req.rid)
        return t

    def _placement_band(self, req: ServeRequest) -> tuple:
        """Rank band ``(lo, hi)`` of clone types this request may run on:
        ``lo`` the escalation floor, ``hi`` the tier the placement engine
        would provision for it now.  Cached per scheduler round."""
        cached = self._band_cache.get(req.rid)
        if cached is not None:
            return cached
        if len(self.fleet) == 1:
            band = (None, None)
        else:
            rt = self._required_type(req)
            lo = CLONE_TYPES[rt].rank()
            hints = {}
            if self.routing == "affinity":
                # a tier holding the request's cached prefix outranks the
                # $-policy order
                hints = {"hint": "prefix_affinity",
                         "affinity": self._affinity_by_type(req)}
            ct = self.placement.choose_type(rt, urgent=req.priority > 0,
                                            **hints) or rt
            band = (lo, max(lo, CLONE_TYPES[ct].rank()))
        self._band_cache[req.rid] = band
        return band

    def _in_band(self, req: ServeRequest, clone) -> bool:
        lo, hi = self._placement_band(req)
        rank = clone.ctype.rank()
        if lo is not None and rank < lo:
            return False
        return clone.is_primary or hi is None or rank <= hi

    def _fits_slot(self, engine: _SlotEngine, req: ServeRequest) -> bool:
        """May ``req`` take a free slot of this engine right now?"""
        return (self._in_band(req, engine.clone)
                and engine.kv.can_admit(
                    _SlotEngine.effective_prompt(
                        req, self.prompt_pad, self.backend.capacity),
                    req.max_new_tokens))

    def _demand_buckets(self) -> List[tuple]:
        """Queued demand as ``(required_type, urgent, cohort_units)``."""
        counts: Dict[tuple, int] = {}
        for r in self.queue.snapshot():
            key = (self._required_type(r), r.priority > 0, r.tenant)
            counts[key] = counts.get(key, 0) + 1
        agg: Dict[tuple, int] = {}
        for (t, urgent, _tenant), n in counts.items():
            agg[(t, urgent)] = agg.get((t, urgent), 0) + n
        for key, n in counts.items():
            self.demand_by_class[key] = max(self.demand_by_class.get(key, 0),
                                            n)
        return [(t, urgent, -(-n // self.max_batch))
                for (t, urgent), n in agg.items()]

    @staticmethod
    def _in_flight_by_type(inflight: Dict) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for unit in inflight.values():
            t = unit.clone.ctype.name
            out[t] = out.get(t, 0) + 1
        return out

    # ---------------------------------------------------------------- cohort
    def _start_cohort(self, batch: List[ServeRequest], clone):
        """Prefill a new cohort on ``clone``: prompts zero-padded (or cut)
        to ``prompt_pad``, one batched ``model.forward``."""
        plen = self.prompt_pad
        toks = np.zeros((len(batch), plen), np.int32)
        for i, r in enumerate(batch):
            toks[i, :min(len(r.prompt), plen)] = r.prompt[:plen]
        cohort = _Cohort(reqs=batch, clone=clone, plen=plen,
                         outs=[[] for _ in batch],
                         first_token_t=[0.0] * len(batch),
                         token_ts=[[] for _ in batch])
        clone.busy = True
        delay = (self.autoscaler.clone_ready_delay(clone, self.clock.now())
                 + self._net_s(toks.nbytes))
        task = self.dispatcher.submit(
            clone, self.backend.prefill,
            (self.backend.params, self.backend.tensor(toks)),
            executor=self.executor, extra_delay=delay, label="prefill")
        self._charge(clone, task.venue_seconds)
        return task, cohort

    def _submit_decode(self, cohort: _Cohort):
        """One lockstep decode step at the cohort's cursor (pinned at
        ``capacity - 1``)."""
        pos = min(cohort.plen + cohort.step, self.backend.capacity - 1)
        written = len(cohort.reqs) * min(cohort.plen + cohort.step + 1,
                                         self.backend.capacity)
        self.kv_samples.append((written,
                                len(cohort.reqs) * self.backend.capacity))
        task = self.dispatcher.submit(
            cohort.clone, self.backend.decode,
            (self.backend.params, cohort.cache, cohort.tok, pos),
            executor=self.executor,
            extra_delay=self._net_s(len(cohort.reqs) * 8), label="decode")
        self._charge(cohort.clone, task.venue_seconds)
        return task

    def _retire(self, cohort: _Cohort, completions: List[ServeCompletion]
                ) -> bool:
        """Emit current tokens; drop finished rows.  True while alive."""
        now = self.clock.now()
        tok = cohort.tok[:, 0].cpu().numpy()
        keep = []
        for i, r in enumerate(cohort.reqs):
            cohort.outs[i].append(int(tok[i]))
            cohort.token_ts[i].append(now)
            if len(cohort.outs[i]) == 1:
                cohort.first_token_t[i] = now
            if len(cohort.outs[i]) >= r.max_new_tokens:
                self.tokens_emitted += len(cohort.outs[i])
                completions.append(ServeCompletion(
                    r.rid, cohort.outs[i], r.arrival_t,
                    cohort.first_token_t[i], now, cohort.clone.spec.name,
                    tenant=r.tenant, slo=r.slo, deadline_s=r.deadline_s,
                    token_ts=cohort.token_ts[i]))
                t = cohort.clone.ctype.name
                self.fleet_mix[t] = self.fleet_mix.get(t, 0) + 1
            else:
                keep.append(i)
        if not keep:
            self.pool.release([cohort.clone])
            return False
        if len(keep) < len(cohort.reqs):      # leave at step granularity
            cohort.reqs = [cohort.reqs[i] for i in keep]
            cohort.outs = [cohort.outs[i] for i in keep]
            cohort.first_token_t = [cohort.first_token_t[i] for i in keep]
            cohort.token_ts = [cohort.token_ts[i] for i in keep]
            cohort.tok = cohort.tok[self.backend.tensor(keep).long()]
            cohort.cache = self.backend.cache_take(cohort.cache, keep)
        return True

    # ------------------------------------------------------------- slots
    def _start_engine(self, clone) -> _SlotEngine:
        """Engine for ``clone``; its KV pool is allocated once and reset
        across engine generations, so the prefix index survives.  A
        speculative handler pairs the engine with a draft clone and a
        fresh draft pool of the target pool's geometry; a disaggregated
        one attaches it to the shared prefill partner and its scratch
        pool.  No partner means the engine serves plainly (a fallback,
        never a stall)."""
        clone.busy = True
        kv = self._kv_pools.get(clone.cid)
        if kv is None:
            kv = KVBlockPool(self.backend, self.max_batch, self.block_size,
                             self._blocks_for_type(clone.ctype.name),
                             prefix_cache=self.prefix_cache)
            self._kv_pools[clone.cid] = kv
        else:
            kv.reset()
        engine = _SlotEngine(self.backend, clone, kv, self.decode_window,
                             self.prefill_chunk, self.mixed_dispatch)
        if self.speculative:
            dc = self._acquire_draft_clone(clone)
            if dc is not None:
                engine.spec_on = True
                engine.draft_clone = dc
                engine.spec_k = self.spec_k
                engine.draft_pool = self.backend.init_draft_pool(
                    kv.max_slots, kv.num_blocks, kv.bs)
                if dc.cid not in self.spec_draft_cids:
                    self.spec_draft_cids.append(dc.cid)
            else:
                self.spec_fallbacks += 1
        if self.disagg:
            pc = self._acquire_prefill_clone(clone)
            if pc is not None:
                engine.disagg_on = True
                engine.prefill_clone = pc
                ppool = self._prefill_pools.get(clone.cid)
                if ppool is None:
                    # worst-case blocks, no prefix index: the partner's
                    # content is transient
                    ppool = KVBlockPool(self.backend, self.max_batch,
                                        self.block_size, None,
                                        prefix_cache=False)
                    self._prefill_pools[clone.cid] = ppool
                else:
                    ppool.reset()
                engine.prefill_pool = ppool
            else:
                self.disagg_fallbacks += 1
        return engine

    def _claim_clone(self, type_name: str, exclude):
        """A free RUNNING clone of ``type_name`` other than ``exclude``,
        else one resumed or booted through the pool; marked busy.  None
        when the pool has none to give."""
        for c in self.pool.running_secondaries():
            if (c is not exclude and not c.busy and c.serveable
                    and c.ctype.name == type_name):
                c.busy = True
                return c
        try:
            clones, _ = self.pool.acquire(type_name, n=1,
                                          exclude_primary=True)
        except RuntimeError:            # the pool is at max_clones
            return None
        for c in clones:
            if c is not exclude and c.serveable:
                c.busy = True
                return c
        self.pool.release(clones)
        return None

    def _acquire_prefill_clone(self, decode_clone):
        """Attach an engine to the shared disagg partner (refcounted): the
        first engine claims a clone of the prefill tier, later ones bump
        the count.  The decode clone is never a candidate."""
        if (self._partner_clone is not None
                and self._partner_clone.serveable):
            self._partner_refs += 1
            return self._partner_clone
        c = self._claim_clone(self.disagg_prefill_type, decode_clone)
        if c is not None:
            self._partner_clone, self._partner_refs = c, 1
        return c

    def _release_partner(self) -> None:
        """Drop one engine's reference on the shared partner; the last one
        returns the clone to the pool."""
        self._partner_refs = max(0, self._partner_refs - 1)
        if self._partner_refs == 0 and self._partner_clone is not None:
            self.pool.release([self._partner_clone])
            self._partner_clone = None

    def _acquire_draft_clone(self, verify_clone):
        """A clone of the cheapest adequate tier (the ``spec_draft``
        placement hint) as the engine's draft partner; never the verify
        clone itself (the point is overlap)."""
        t = self.placement.choose_type(self.fleet[0], hint="spec_draft") \
            or self.fleet[0]
        return self._claim_clone(t, verify_clone)

    def _release_engine(self, engine: _SlotEngine) -> None:
        """Return an engine's clone, and its draft partner, to the pool."""
        clones = [engine.clone]
        if engine.draft_clone is not None:
            clones.append(engine.draft_clone)
            engine.draft_clone = None
            engine.spec_on = False
        if engine.prefill_clone is not None:
            engine.prefill_clone = None
            engine.disagg_on = False
            self._release_partner()
        self.pool.release(clones)

    def _clone_stat(self, clone) -> Dict[str, object]:
        """Per-clone routing telemetry bucket (``ServeReport.per_clone``)."""
        st = self.per_clone_stats.get(clone.cid)
        if st is None:
            st = self.per_clone_stats[clone.cid] = {
                "type": clone.ctype.name, "prefix_hit_tokens": 0,
                "prompt_tokens": 0, "kv_transfer_bytes": 0.0,
                "kv_transfer_s": 0.0}
        return st

    def _admit(self, engine: _SlotEngine, req: ServeRequest) -> None:
        """Admit through the engine and fold its prefix-cache economics
        into the counters; disagg-eligible cold prompts take a decode slot
        and defer their prefill to the partner."""
        st = self._clone_stat(engine.clone)
        if self._try_disagg_admit(engine, req):
            self.prompt_tokens += self.prompt_pad   # fresh eff is pad-long
            st["prompt_tokens"] += self.prompt_pad
            return
        info = engine.admit(req, self.prompt_pad)
        self.prefix_hit_tokens += info["cached"]
        self.prompt_tokens += info["prompt"]
        st["prefix_hit_tokens"] += info["cached"]
        st["prompt_tokens"] += info["prompt"]
        if info["restore"]:
            self.restored_tokens += info["suffix"]

    def _try_disagg_admit(self, engine: _SlotEngine,
                          req: ServeRequest) -> bool:
        """Route a cold prompt to the partner when the planner says its
        compute win beats the wire cost; restores and local prefix hits
        stay co-located (resident blocks are cheaper than a remote
        recompute)."""
        if not engine.disagg_on or req.generated:
            return False
        eff = _SlotEngine.effective_prompt(req, self.prompt_pad,
                                           engine.kv.capacity)
        if engine.kv.match_prefix(eff)[2] > 0:
            return False
        if not self._disagg_worth(engine, len(eff)):
            self.disagg_colocated += 1
            return False
        slot, new_ids, _, _ = engine.kv.alloc_slot(
            eff, req.max_new_tokens, force_suffix=True)
        ids = [int(b) for b in new_ids]
        engine.disagg_joins.append((slot, req, eff, ids))
        engine.disagg_blocks[slot] = ids
        return True

    def _preempt_slot(self, engine: _SlotEngine, victim: int,
                      counts: np.ndarray) -> None:
        """Evict ``victim`` under pool pressure: carry its generated
        tokens and stamps on the request, reclaim its blocks, requeue it
        at the queue head."""
        s = engine.slots[victim]
        req = s.req
        req.generated = list(s.out)
        req.first_token_t = s.first_token_t
        req.token_ts = list(s.token_ts)
        req.preemptions += 1
        engine.slots[victim] = None
        engine.tok_host[victim] = 0
        counts[victim] = 0
        engine.kv.free_slot(victim)
        self.queue.requeue(req)
        self.preemptions += 1

    def _cancel_join(self, engine: _SlotEngine) -> None:
        """Roll back the newest not-yet-submitted join (its prefill never
        ran, so nothing is lost) and requeue it at the head.  An inbound
        migration whose copy never ran goes last: the request restores
        with its generated tokens carried."""
        if engine.sfx_joins:
            slot, req, _, _, _ = engine.sfx_joins.pop()
        elif engine.joins:
            slot, req, _, _ = engine.joins.pop()
        elif engine.disagg_joins:
            # partner prefill not yet submitted: a free rollback too
            slot, req, _, _ = engine.disagg_joins.pop()
        else:
            slot, req, out, ft, _, _, _, sslot, _, kind = \
                engine.migrations.pop()
            req.generated = list(out)
            req.first_token_t = ft
            req.preemptions += 1
            if kind == "recover":
                # admitted by length: nothing indexed, nothing shared
                engine.kv.free_slot(slot)
                self.recoveries_restored += 1
                self.queue.requeue(req)
                self.preemptions += 1
                return
            # a handoff: the partner's slot holding its blocks is dropped
            if engine.prefill_pool is not None:
                engine.prefill_pool.free_slot(sslot)
        engine.disagg_blocks.pop(slot, None)
        engine.cow_pairs = [p for p in engine.cow_pairs if p[0] != slot]
        engine.kv.cancel_slot(slot)
        self.queue.requeue(req)
        self.preemptions += 1

    def _grow_or_preempt(self, engine: _SlotEngine,
                         counts: np.ndarray) -> None:
        """Reserve the window's blocks, shedding load on exhaustion: roll
        back pending joins first, then preempt active victims."""
        kv = engine.kv
        while True:
            try:
                kv.grow_for_window(counts)
                return
            except PoolExhausted:
                if (engine.joins or engine.sfx_joins or engine.migrations
                        or engine.disagg_joins):
                    self._cancel_join(engine)
                    continue
                cands = [(slot, s.req.priority, len(s.out))
                         for slot, s in enumerate(engine.slots)
                         if s is not None and kv.active[slot]]
                if len(cands) <= 1:
                    raise RuntimeError(
                        "KV block pool cannot hold a single request's "
                        f"context (num_blocks={kv.num_blocks}, "
                        f"block_size={kv.bs}): preemption has no victim "
                        "left — raise num_blocks or lower capacity")
                # prefer victims whose restore context fits capacity
                safe = [c for c in cands
                        if self.prompt_pad + c[2] - 1
                        <= self.backend.capacity]
                self._preempt_slot(
                    engine, self.ledger.pick_victim(safe or cands), counts)

    def _submit_engine_step(self, engine: _SlotEngine):
        """One dispatched unit of engine work: full batched prefill for
        cold joins, device block copies for CoW splits, suffix prefill for
        prefix-hit and restored rows, then a decode window for every active
        slot.  In-closure order matters: full prefills write the blocks the
        same round's CoW copies read, and both precede the suffix prefill
        that attends over them.  All block/slot bookkeeping happens here on
        the host before submission."""
        kv = engine.kv
        backend = self.backend
        spec = engine.spec_on
        # tokens each slot emits this step: min(window, budget left); a
        # speculative round sizes each row's verify width k + 1 instead,
        # k from the row's acceptance EMA, clamped so the current token is
        # scored, a full accept fits the budget (k <= left - 1), and no
        # window write needs the capacity - 1 pin (k <= capacity - 1 - pos)
        counts = np.zeros((kv.max_slots,), np.int32)
        for slot in np.nonzero(kv.active)[0]:
            s = engine.slots[slot]
            left = s.req.max_new_tokens - len(s.out)
            if spec:
                p = int(kv.pos[slot])
                room = max(kv.capacity - 1 - min(p, kv.capacity - 1), 0)
                k = max(1, int(round(s.req.spec_ema * engine.spec_k)))
                k = max(min(k, engine.spec_k, left - 1, room), 0)
                counts[slot] = k + 1
            else:
                counts[slot] = min(engine.window, left)
        if counts.any():
            self._grow_or_preempt(engine, counts)
        joins, engine.joins = engine.joins, []
        sfx, engine.sfx_joins = engine.sfx_joins, []
        cow, engine.cow_pairs = engine.cow_pairs, []
        migs, engine.migrations = engine.migrations, []
        engine.submitted_joins = joins
        engine.submitted_sfx = sfx
        engine.submitted_migrations = migs
        rows = np.nonzero(kv.active)[0]
        do_decode = rows.size > 0
        engine.decode_rows = rows if do_decode else None
        if do_decode:
            # writes past capacity pin to the last cell: not newly written
            eff = np.minimum(counts, np.maximum(kv.capacity - kv.pos, 0))
            written = kv.written_tokens() + int(eff.sum())
            self.kv_samples.append((written, kv.used_blocks() * kv.bs))
        engine.decode_counts = counts
        tables = engine.device_tables()
        pos = backend.tensor(np.minimum(kv.pos, backend.capacity - 1))
        tok = backend.tensor(engine.tok_host[:, None])
        steps_left = backend.tensor(counts)
        prefill_into = engine.prefill_into
        decode_window = engine.decode_window
        nbytes = 8 * int(counts.sum())
        join_batch = None
        if joins:
            # one batched prefill padded to a power-of-two row bucket; pad
            # rows write the trash block
            j = len(joins)
            jpad = pow2_bucket(j)
            toks = np.zeros((jpad, len(joins[0][2])), np.int32)
            blks = np.zeros((jpad, len(joins[0][3])), np.int32)
            for i, (_, _, eff_p, ids) in enumerate(joins):
                toks[i] = eff_p
                blks[i] = ids
            slots = [s for s, _, _, _ in joins] + [kv.max_slots] * (jpad - j)
            join_batch = (backend.tensor(toks), backend.tensor(blks),
                          backend.tensor(slots))
            nbytes += int(toks.nbytes)
        cow_batch = None
        if cow:
            cpad = pow2_bucket(len(cow))
            src = [s for _, s, _ in cow] + [0] * (cpad - len(cow))
            dst = [d for _, _, d in cow] + [0] * (cpad - len(cow))
            cow_batch = (backend.copy_fn(), backend.tensor(src),
                         backend.tensor(dst))
            nbytes += 4 * cpad * 2
        mig_batches, xfer_s, mig_bytes = self._migration_batches(engine,
                                                                 migs)
        nbytes += mig_bytes
        sfx_batch = None
        mixed_batch = None
        sfx_steps = mix_steps = 0
        if sfx:
            # suffix rows as ONE prefill, rows and steps padded to
            # power-of-two buckets (pad rows carry n_tok=0 -> trash block)
            j2 = len(sfx)
            jpad2 = pow2_bucket(j2)
            tpad = pow2_bucket(max(len(s_) for _, _, s_, _, _ in sfx))
            stoks = np.zeros((jpad2, tpad), np.int32)
            spos = np.zeros((jpad2,), np.int32)
            sn = np.zeros((jpad2,), np.int32)
            stabs = np.zeros((jpad2, kv.max_blk), np.int32)
            for i, (slot, _, s_, pos0, _) in enumerate(sfx):
                stoks[i, :len(s_)] = s_
                spos[i] = pos0
                sn[i] = len(s_)
                stabs[i] = kv.tables[slot]
            chunk = engine.chunk
            sfx_args = (backend.tensor(stoks), backend.tensor(spos),
                        backend.tensor(sn), backend.tensor(stabs))
            sfx_steps = -(-tpad // chunk) if chunk else tpad
            if engine.mixed and do_decode:
                # the suffix chunks ride inside the decode window's scan
                mix_steps = max(engine.window, sfx_steps)
                mixed_batch = (backend.mixed_fn(kv.bs, chunk, mix_steps),) \
                    + sfx_args
                sfx_steps = 0
            else:
                sfx_batch = (backend.prefill_window_fn(kv.bs, tpad,
                                                       chunk=chunk),) \
                    + sfx_args
            nbytes += int(stoks.nbytes)

        if spec and do_decode:
            return self._submit_spec_round(engine, counts, rows, join_batch,
                                           cow_batch, mig_batches, sfx_batch,
                                           sfx_steps, tables, pos, nbytes)

        def step_fn(params, pool, tok, pos, steps_left, tables):
            for mfn, spool, sids, dids in mig_batches:
                pool = mfn(pool, spool, sids, dids)
            firsts = None
            if join_batch is not None:
                toks, blks, slots = join_batch
                firsts, pool = prefill_into(params, toks, pool, blks, slots)
            if cow_batch is not None:
                copy_into, src, dst = cow_batch
                pool = copy_into(pool, src, dst)
            firsts_sfx = None
            nxt = None
            if mixed_batch is not None:
                mw, stoks, spos, sn, stabs = mixed_batch
                nxt, firsts_sfx, pool = mw(params, pool, tok, pos, steps_left,
                                           tables, stoks, spos, sn, stabs)
            else:
                if sfx_batch is not None:
                    pw, stoks, spos, sn, stabs = sfx_batch
                    firsts_sfx, pool = pw(params, pool, stoks, spos, sn,
                                          stabs)
                if do_decode:
                    nxt, pool = decode_window(params, pool, tok, pos,
                                              steps_left, tables)
            return firsts, firsts_sfx, nxt, pool

        # sequential scan steps this dispatch runs — what a step-aware
        # executor bills: the batched join prefill, the CoW copy and each
        # migration are one parallel pass each; the suffix scan and the
        # decode window are sequential, fused into max(..) steps by the
        # mixed path instead of added
        step_fn.seq_steps = (
            int(join_batch is not None) + int(cow_batch is not None)
            + len(mig_batches)
            + (mix_steps if mixed_batch is not None
               else sfx_steps + (engine.window if do_decode else 0)))
        # prompt tokens the batched co-located prefill folded this step, so
        # a step-aware executor bills the whole prefill compute
        step_fn.prefill_tokens = (int(join_batch[0].shape[1])
                                  if join_batch is not None else 0)
        delay = (self.autoscaler.clone_ready_delay(engine.clone,
                                                   self.clock.now())
                 + self._net_s(nbytes) + xfer_s)
        task = self.dispatcher.submit(
            engine.clone, step_fn,
            (backend.params, kv.pool, tok, pos, steps_left, tables),
            executor=self.executor, extra_delay=delay,
            label="step" if do_decode else "prefill")
        self._charge(engine.clone, task.venue_seconds)
        return task

    def _migration_batches(self, engine: _SlotEngine, migs: List[tuple]):
        """Inbound migrations as one cross-pool copy per (source pool,
        kind), block ids padded to a power-of-two bucket with 0 -> 0 pads.
        A handoff bills per block on ``disagg_link`` (int8 + scales when
        compressed); a recovery move bills its tokens' KV bytes on the
        clone link.  Returns ``(batches, handoff link seconds, recovery
        bytes)``."""
        backend = self.backend
        groups: Dict[tuple, list] = {}
        for m in migs:
            groups.setdefault((id(m[4]), m[9]), []).append(m)
        batches, xfer_s, nbytes = [], 0.0, 0
        for (_, kind), group in groups.items():
            sids = [b for m in group for b in m[5]]
            dids = [b for m in group for b in m[6]]
            n_blk = len(sids)
            bpad = pow2_bucket(n_blk)
            compress = kind == "disagg" and self.disagg_compress
            batches.append((backend.migrate_fn(compress), group[0][4],
                            backend.tensor(sids + [0] * (bpad - n_blk)),
                            backend.tensor(dids + [0] * (bpad - n_blk))))
            if kind == "disagg":
                dbytes = n_blk * self._disagg_block_bytes()
                dt = transfer_time(dbytes, LINKS[self.disagg_link])
                xfer_s += dt
                self.kv_transfer_bytes += dbytes
                self.kv_transfer_s += dt
                st = self._clone_stat(engine.clone)
                st["kv_transfer_bytes"] += dbytes
                st["kv_transfer_s"] += dt
            else:
                nbytes += int(sum(m[8] for m in group)
                              * self._kv_token_bytes())
        return batches, xfer_s, nbytes

    # ----------------------------------------------------- disagg prefill
    def _submit_disagg_prefill(self, engine: _SlotEngine):
        """Dispatch every pending disagg admission as one paged prefill on
        the partner clone, into the engine's scratch pool (chunked through
        the paged-prefill kernel, or stepwise when ``prefill_chunk`` is
        0).  The handoff rides the engine's next step as a migration.
        Returns the task or None."""
        if engine.disagg_inflight or not engine.disagg_joins:
            return None
        ppool = engine.prefill_pool
        rows, engine.disagg_joins = engine.disagg_joins, []
        sub = []
        for slot, req, eff, new_ids in rows:
            # a bare-length alloc: the scratch pool indexes nothing, so it
            # yields exactly the decode side's block count
            pslot, p_ids, _, _ = ppool.alloc_slot(len(eff))
            sub.append((slot, req, eff, new_ids, pslot,
                        [int(b) for b in p_ids]))
        engine.submitted_disagg = sub
        jpad = pow2_bucket(len(sub))
        tpad = pow2_bucket(max(len(e) for _, _, e, _, _, _ in sub))
        ptoks = np.zeros((jpad, tpad), np.int32)
        ppos = np.zeros((jpad,), np.int32)
        pn = np.zeros((jpad,), np.int32)
        ptabs = np.zeros((jpad, ppool.max_blk), np.int32)
        for k, (_s, _r, eff, _n, pslot, _p) in enumerate(sub):
            ptoks[k, :len(eff)] = eff
            pn[k] = len(eff)
            ptabs[k] = ppool.tables[pslot]
        pw = _with_cost(self.backend.prefill_window_fn(ppool.bs, tpad,
                                                       chunk=engine.chunk),
                        seq_steps=(-(-tpad // engine.chunk) if engine.chunk
                                   else tpad),
                        prefill_tokens=0)    # chunk-billed via seq_steps
        delay = (self.autoscaler.clone_ready_delay(engine.prefill_clone,
                                                   self.clock.now())
                 + self._net_s(int(ptoks.nbytes)))
        task = self.dispatcher.submit(
            engine.prefill_clone, pw,
            (self.backend.params, ppool.pool, self.backend.tensor(ptoks),
             self.backend.tensor(ppos), self.backend.tensor(pn),
             self.backend.tensor(ptabs)),
            executor=self.executor, extra_delay=delay,
            label="disagg_prefill")
        self._charge(engine.prefill_clone, task.venue_seconds)
        engine.disagg_inflight = True
        return task

    def _disagg_prefill_done(self, engine: _SlotEngine, task) -> None:
        """Fold a partner prefill: stamp TTFT now (the first token exists
        when the partner finishes) and queue each row's block copy into
        the engine's next step as a ``"disagg"`` migration."""
        firsts, engine.prefill_pool.pool = task.value
        engine.disagg_inflight = False
        sub, engine.submitted_disagg = engine.submitted_disagg, []
        now = self.clock.now()
        for (slot, req, eff, new_ids, pslot, p_ids), ft in zip(
                sub, firsts.cpu().numpy()):
            req.first_token_t = now
            req.token_ts = [now]
            engine.migrations.append(
                (slot, req, [int(ft)], now, engine.prefill_pool.pool, p_ids,
                 new_ids, pslot, len(eff), "disagg"))

    def _pump(self, engine: _SlotEngine, inflight: Dict) -> None:
        """Submit what the engine can run now: its next step unless one
        is in flight and, independently, a partner prefill for pending
        disagg admissions (the two overlap)."""
        if engine.step_work() and not engine.main_inflight:
            task = self._submit_engine_step(engine)
            engine.main_inflight = True
            inflight[task] = engine
            self._maybe_hedge(task, engine, inflight)
        pt = self._submit_disagg_prefill(engine)
        if pt is not None:
            inflight[pt] = engine

    # ------------------------------------------------------- speculative
    def _slot_history(self, engine: _SlotEngine, slot: int) -> List[int]:
        """Tokens resident at positions ``0 .. kv.pos[slot] - 1`` of a
        slot: the committed context the draft's catch-up replays."""
        s = engine.slots[slot]
        base = np.zeros((self.prompt_pad,), np.int32)
        pr = s.req.prompt
        base[:min(len(pr), self.prompt_pad)] = pr[:self.prompt_pad]
        seq = base.tolist() + list(s.out)
        return seq[:int(engine.kv.pos[slot])]

    def _submit_spec_round(self, engine: _SlotEngine, counts, rows,
                           join_batch, cow_batch, mig_batches, sfx_batch,
                           sfx_steps, tables, pos, nbytes):
        """One speculative round: stash the verify closure (carrying the
        round's join/CoW/migration/suffix folds), then dispatch the draft
        on the draft clone; the verify goes out when the draft completes,
        or at once with zero drafts when every row clamped to k = 0."""
        kv = engine.kv
        backend = self.backend
        act = kv.active.astype(bool)
        k_arr = np.maximum(counts - 1, 0).astype(np.int32)
        n_live = backend.tensor(counts)
        tok_snap = engine.tok_host.copy()
        prefill_into = engine.prefill_into
        v_fn = backend.spec_verify_fn(kv.bs)
        params, pool0 = backend.params, kv.pool

        def verify_builder(drafts_np):
            x = np.concatenate([tok_snap[:, None],
                                drafts_np.astype(np.int32)], axis=1)

            def step_fn(params, pool, toks, pos, n_live, tables):
                for mfn, spool, sids, dids in mig_batches:
                    pool = mfn(pool, spool, sids, dids)
                firsts = None
                if join_batch is not None:
                    jtoks, blks, slots = join_batch
                    firsts, pool = prefill_into(params, jtoks, pool, blks,
                                                slots)
                if cow_batch is not None:
                    copy_into, src, dst = cow_batch
                    pool = copy_into(pool, src, dst)
                firsts_sfx = None
                if sfx_batch is not None:
                    pw, stoks, spos, sn, stabs = sfx_batch
                    firsts_sfx, pool = pw(params, pool, stoks, spos, sn,
                                          stabs)
                greedy, pool = v_fn(params, pool, toks, pos, n_live, tables)
                return firsts, firsts_sfx, greedy, pool

            # the chunked verify scores every window position in one pass
            step_fn.seq_steps = (int(join_batch is not None)
                                 + int(cow_batch is not None)
                                 + len(mig_batches) + sfx_steps + 1)
            args = (params, pool0, backend.tensor(x), pos, n_live, tables)
            return step_fn, args, nbytes + int(x.nbytes)

        engine._verify_builder = verify_builder
        engine._spec_round = k_arr
        if int(k_arr.sum()) == 0:
            return self._submit_spec_verify(
                engine, np.zeros((kv.max_slots, engine.spec_k), np.int32),
                np.zeros((kv.max_slots,), np.int32))
        # draft: catch-up (committed tokens the draft pool has not
        # ingested) + k greedy proposals, one dispatch
        n_c = np.where(act, kv.pos - engine.dpos, 0).astype(np.int32)
        tcpad = pow2_bucket(max(int(n_c.max()), 1))
        ctoks = np.zeros((kv.max_slots, tcpad), np.int32)
        for slot in rows:
            if n_c[slot] > 0:
                hist = self._slot_history(engine, slot)
                ctoks[slot, :n_c[slot]] = hist[int(engine.dpos[slot]):]
        d_fn = _with_cost(backend.spec_draft_fn(kv.bs, tcpad, engine.spec_k),
                          seq_steps=tcpad + engine.spec_k,
                          step_scale=self.draft_cost)
        dargs = (backend.draft_params, engine.draft_pool,
                 backend.tensor(ctoks),
                 backend.tensor(np.where(act, engine.dpos, 0)),
                 backend.tensor(n_c), backend.tensor(tok_snap[:, None]),
                 pos, backend.tensor(k_arr), tables)
        delay = (self.autoscaler.clone_ready_delay(engine.draft_clone,
                                                   self.clock.now())
                 + self._net_s(int(ctoks.nbytes)))
        task = self.dispatcher.submit(
            engine.draft_clone, d_fn, dargs, executor=self.executor,
            extra_delay=delay, label="draft")
        self._charge(engine.draft_clone, task.venue_seconds)
        return task

    def _spec_draft_done(self, engine: _SlotEngine, task):
        """Fold a draft dispatch: keep the draft pool, corrupt proposals
        on the host when asked (``_spec_rng``), advance the draft cursors
        past what the draft ingested and proposed, chain the verify."""
        drafts, dpool = task.value
        engine.draft_pool = dpool
        drafts = drafts.cpu().numpy().astype(np.int32)
        k_arr = engine._spec_round
        if self.spec_corruption > 0:
            vocab = getattr(getattr(self.backend, "cfg", None),
                            "vocab_size", None)
            flips = self._spec_rng.random(drafts.shape) \
                < self.spec_corruption
            bumped = drafts + 1 if vocab is None else (drafts + 1) % vocab
            drafts = np.where(flips, bumped, drafts).astype(np.int32)
        rows = engine.decode_rows
        if rows is not None:
            engine.dpos[rows] = engine.kv.pos[rows] + k_arr[rows]
        return self._submit_spec_verify(engine, drafts, k_arr)

    def _submit_spec_verify(self, engine: _SlotEngine, drafts: np.ndarray,
                            n_spec: np.ndarray):
        """Dispatch the stashed verify closure with the round's
        proposals."""
        builder, engine._verify_builder = engine._verify_builder, None
        step_fn, args, nbytes = builder(drafts)
        engine.spec_pending = (drafts, np.asarray(n_spec, np.int32))
        delay = (self.autoscaler.clone_ready_delay(engine.clone,
                                                   self.clock.now())
                 + self._net_s(nbytes))
        task = self.dispatcher.submit(
            engine.clone, step_fn, args, executor=self.executor,
            extra_delay=delay, label="step")
        self._charge(engine.clone, task.venue_seconds)
        return task

    def _engine_step_done(self, engine: _SlotEngine, task,
                          completions: List[ServeCompletion]) -> bool:
        """Fold a completed step back into host state.  True while alive."""
        now = self.clock.now()
        firsts, firsts_sfx, nxt, pool = task.value
        kv = engine.kv
        kv.pool = pool
        firsts = [] if firsts is None else firsts.cpu().numpy()
        for (slot, req, _, _), ft in zip(engine.submitted_joins, firsts):
            t0 = int(ft)
            engine.slots[slot] = _Slot(req, [t0], now, token_ts=[now])
            engine.tok_host[slot] = t0
            engine.dpos[slot] = 0       # the draft replays the history
            kv.active[slot] = True
        engine.submitted_joins = []
        firsts_sfx = [] if firsts_sfx is None else firsts_sfx.cpu().numpy()
        for (slot, req, _, _, restore), ft in zip(engine.submitted_sfx,
                                                  firsts_sfx):
            if restore:
                # resume where preemption stopped: the last generated
                # token is authoritative (the prefill only re-derives it)
                t0 = int(req.generated[-1])
                engine.slots[slot] = _Slot(
                    req, list(req.generated), req.first_token_t,
                    token_ts=_carried_ts(req, len(req.generated)))
            else:
                t0 = int(ft)
                engine.slots[slot] = _Slot(req, [t0], now, token_ts=[now])
            engine.tok_host[slot] = t0
            engine.dpos[slot] = 0
            kv.active[slot] = True
        engine.submitted_sfx = []
        for slot, req, out, ft, _, _, _, sslot, _, kind in \
                engine.submitted_migrations:
            # a migrated slot resumes where its source stopped: tokens
            # already emitted, the last one the next decode input
            engine.slots[slot] = _Slot(req, list(out), ft,
                                       token_ts=_carried_ts(req, len(out)))
            engine.tok_host[slot] = int(out[-1])
            engine.dpos[slot] = 0
            kv.active[slot] = True
            if kind == "disagg":
                # the partner's scratch slot retires and the slot's blocks
                # leave the pending set below
                self.disagg_handoffs += 1
                engine.disagg_blocks.pop(slot, None)
                if engine.prefill_pool is not None:
                    engine.prefill_pool.free_slot(sslot)
            else:
                self.recoveries_migrated += 1
        # dropping the tuples drops the last reference to a dead clone's
        # pool, so its device memory is returned
        engine.submitted_migrations = []
        kv.clear_pending()
        # slots still waiting for their handoff keep their prompt blocks
        # unshareable (clear_pending is pool-wide)
        for ids in engine.disagg_blocks.values():
            kv._pending.update(int(b) for b in ids)
        if engine.decode_rows is not None and nxt is not None:
            nxt = nxt.cpu().numpy()                     # (S, window)
            rows = engine.decode_rows
            spec_pend, engine.spec_pending = engine.spec_pending, None
            if spec_pend is not None:
                # the verify grid scored the current token and every
                # proposal: accept the longest agreeing prefix and emit one
                # more target token (the stepwise greedy stream)
                drafts, n_spec = spec_pend
                acc = model.spec_accept(nxt, drafts, n_spec)[rows]
                n = (acc + 1).astype(np.int32)
                self.spec_rounds += 1
                self.spec_proposed += int(n_spec[rows].sum())
                self.spec_accepted += int(acc.sum())
                self.spec_tokens += int(n.sum())
                for slot, a in zip(rows, acc.tolist()):
                    k_i = int(n_spec[slot])
                    if k_i > 0:     # the EMA sizes the row's next window
                        req = engine.slots[slot].req
                        req.spec_ema = 0.5 * req.spec_ema + 0.5 * (a / k_i)
            else:
                n = engine.decode_counts[rows]          # >= 1 per active row
            engine.tok_host[rows] = nxt[rows, n - 1]
            kv.pos[rows] = np.minimum(kv.pos[rows] + n, kv.capacity)
            # the draft cursor never runs ahead of the committed context:
            # rejected proposals' K/V is overwritten by the next catch-up
            engine.dpos[rows] = np.minimum(engine.dpos[rows], kv.pos[rows])
            if spec_pend is not None:
                engine.spec_rounds_done += 1
                self._maybe_drop_speculation(engine)
            # streamed delivery stamps interpolate within the dispatch
            t0 = getattr(task, "submitted_at", now)
            span = max(now - t0, 0.0)
            for slot, row, k in zip(rows, nxt[rows].tolist(), n.tolist()):
                engine.slots[slot].out.extend(row[:k])
                engine.slots[slot].token_ts.extend(
                    t0 + span * (j + 1) / k for j in range(k))
            engine.decode_rows = None
        for slot, s in enumerate(engine.slots):   # evict at step granularity
            if s is not None and len(s.out) >= s.req.max_new_tokens:
                self.tokens_emitted += len(s.out)
                completions.append(ServeCompletion(
                    s.req.rid, s.out, s.req.arrival_t, s.first_token_t,
                    now, engine.clone.spec.name,
                    tenant=s.req.tenant, slo=s.req.slo,
                    deadline_s=s.req.deadline_s,
                    token_ts=(s.token_ts if len(s.token_ts) == len(s.out)
                              else [])))
                t = engine.clone.ctype.name
                self.fleet_mix[t] = self.fleet_mix.get(t, 0) + 1
                engine.slots[slot] = None
                kv.free_slot(slot)
        return engine.alive()

    def _maybe_drop_speculation(self, engine: _SlotEngine) -> None:
        """When the engine's mean acceptance EMA collapses below 0.25
        after 3 rounds, release the draft clone and decode plainly from
        then on (sticky; counted as a fallback)."""
        if not engine.spec_on or engine.spec_rounds_done < 3:
            return
        emas = [s.req.spec_ema for s in engine.slots if s is not None]
        if emas and float(np.mean(emas)) < 0.25:
            engine.spec_on = False
            self.spec_fallbacks += 1
            if engine.draft_clone is not None:
                self.pool.release([engine.draft_clone])
                engine.draft_clone = None

    # ------------------------------------------------------- fault recovery
    def _requeue_lost(self, req: ServeRequest) -> None:
        """Send a dead engine's request back through admission on the
        prefix-accelerated restore path (its generated tokens, if any,
        are already carried on the request)."""
        req.preemptions += 1
        self.queue.requeue(req)
        self.recoveries_restored += 1

    def _try_migrate(self, src_engine: _SlotEngine, slot: int, s: _Slot,
                     engines: Dict[int, _SlotEngine]) -> bool:
        """Queue one active slot of a drained engine for migration into a
        survivor with room: claim the destination slot and blocks now (so
        later candidates of the same pass see them), fold the device copy
        into the destination's next step.  False when no survivor can
        admit the context.

        The source pool is updated in place, so it already holds the
        writes of the step that was in flight when the clone died (the
        reference drops that step's pool with its result).  They sit at
        positions ``pos`` and later of the last copied block, and the
        survivor's decode writes each of those positions before any step
        attends to it: the request still has every token from ``pos`` on
        to emit."""
        if getattr(self.backend, "migrate_fn", None) is None:
            return False
        kv = src_engine.kv
        pos = int(kv.pos[slot])
        nb = (pos - 1) // kv.bs + 1
        src_ids = [int(b) for b in kv.tables[slot, :nb]]
        cands = sorted((e for e in engines.values()
                        if e is not src_engine and e.clone.serveable),
                       key=lambda e: e.clone.cid)
        for dst in cands:
            if not dst.kv.can_admit(pos, s.req.max_new_tokens):
                continue
            dslot, new_ids, _, _ = dst.kv.alloc_slot(pos)
            s.req.token_ts = list(s.token_ts)   # stamps survive the move
            dst.migrations.append(
                (dslot, s.req, list(s.out), s.first_token_t, kv.pool,
                 src_ids, [int(b) for b in new_ids], slot, pos, "recover"))
            return True
        return False

    def _recover_engine(self, engine: _SlotEngine, fault: CloneFault,
                        engines: Dict[int, _SlotEngine]) -> None:
        """Recover every request a dead engine held.  Joins and inbound
        migrations never folded a token here, so they requeue (carrying
        any generated tokens).  Active slots hold decode progress: after a
        ``drain`` their blocks move to a survivor that can admit them;
        after a ``kill`` (memory lost) they requeue to re-prefill."""
        for (_, req, _e, _b) in engine.joins + engine.submitted_joins:
            self._requeue_lost(req)
        for (_, req, _s, _p, _r) in engine.sfx_joins + engine.submitted_sfx:
            self._requeue_lost(req)
        for (_, req, out, ft, *_rest) in (engine.migrations
                                          + engine.submitted_migrations):
            req.generated = list(out)
            req.first_token_t = ft
            self._requeue_lost(req)
        # rows parked on the partner never folded a token here either
        for (_, req, _e, _i) in engine.disagg_joins:
            self._requeue_lost(req)
        for (_, req, _e, _i, _ps, _pi) in engine.submitted_disagg:
            self._requeue_lost(req)
        engine.joins, engine.sfx_joins, engine.cow_pairs = [], [], []
        engine.submitted_joins, engine.submitted_sfx = [], []
        engine.migrations, engine.submitted_migrations = [], []
        engine.disagg_joins, engine.submitted_disagg = [], []
        engine.disagg_blocks = {}
        for slot, s in enumerate(engine.slots):
            if s is None:
                continue
            if not (fault.kind == "drain"
                    and self._try_migrate(engine, slot, s, engines)):
                s.req.generated = list(s.out)
                s.req.first_token_t = s.first_token_t
                s.req.token_ts = list(s.token_ts)
                self._requeue_lost(s.req)
            engine.slots[slot] = None
        # the pools die with the clone: a revived clone gets fresh ones,
        # so nothing resets or reuses the tensors that a pending
        # migration still reads
        self._kv_pools.pop(engine.clone.cid, None)
        self._prefill_pools.pop(engine.clone.cid, None)

    def _recover_failed(self, inflight: Dict,
                        engines: Dict[int, _SlotEngine]) -> None:
        """Handle every clone the injector killed or drained since the
        last round: cancel its in-flight dispatches, settle hedge races,
        recover its engine's requests, and degrade the engines whose draft
        or prefill partner it was."""
        for clone, fault in self.injector.drain_failed():
            draft_orphans = []        # engines whose draft died mid-round
            disagg_orphans = []       # engines whose partner died mid-prefill
            for task in [t for t in inflight if t.clone is clone]:
                unit = inflight.pop(task)
                self.dispatcher.cancel(task)
                if task.label == "draft":
                    # the stashed verify can still run, with zero drafts
                    draft_orphans.append(unit)
                    continue
                if task.label == "disagg_prefill":
                    disagg_orphans.append(unit)
                    continue
                partner = self._hedges.pop(task, None)
                if partner is not None:
                    self._hedges.pop(partner, None)
                    if task.label == "hedge":
                        continue      # the original keeps racing
                    # the engine's own step died: its hedge cannot rescue
                    # an engine that is being recovered
                    inflight.pop(partner, None)
                    self.dispatcher.cancel(partner)
                    self.pool.release([partner.clone])
            engine = None
            for key, eng in list(engines.items()):
                if eng.clone is clone:
                    engine = engines.pop(key)
                    self.ledger.drop(key)
                    break
            if engine is not None:
                # a dead verify clone orphans its in-flight draft and
                # frees its partners
                for t in [t for t, u in inflight.items() if u is engine]:
                    inflight.pop(t)
                    self.dispatcher.cancel(t)
                if engine.draft_clone is not None:
                    self.pool.release([engine.draft_clone])
                    engine.draft_clone = None
                if engine.prefill_clone is not None:
                    engine.prefill_clone = None
                    engine.disagg_on = False
                    self._release_partner()
                self._recover_engine(engine, fault, engines)
            self.pool.release([clone])
            # a dead draft degrades its engines to plain decode: the
            # interrupted round completes as a zero-draft verify (one
            # plain greedy token per row, the round's folds kept)
            for eng in engines.values():
                if eng.draft_clone is clone:
                    eng.draft_clone = None
                    eng.spec_on = False
                    self.spec_fallbacks += 1
            for eng in draft_orphans:
                if id(eng) in engines and eng._verify_builder is not None:
                    vt = self._submit_spec_verify(
                        eng,
                        np.zeros((eng.kv.max_slots, max(eng.spec_k, 1)),
                                 np.int32),
                        np.zeros((eng.kv.max_slots,), np.int32))
                    inflight[vt] = eng
            # a dead partner degrades its engines to co-located prefill:
            # rows riding the dead prefill requeue (no token emitted yet),
            # rows still pending become plain joins on the decode clone
            for eng in disagg_orphans:
                if id(eng) not in engines:
                    continue            # the decode engine died too
                eng.disagg_inflight = False
                sub, eng.submitted_disagg = eng.submitted_disagg, []
                for (slot, req, _e, _i, _ps, _pi) in sub:
                    eng.disagg_blocks.pop(slot, None)
                    eng.kv.cancel_slot(slot)
                    self._requeue_lost(req)
            for eng in engines.values():
                if eng.prefill_clone is not clone:
                    continue
                eng.prefill_clone = None
                eng.prefill_pool = None
                eng.disagg_on = False
                self.disagg_fallbacks += 1
                self._prefill_pools.pop(eng.clone.cid, None)
                rows, eng.disagg_joins = eng.disagg_joins, []
                for (slot, req, eff, ids) in rows:
                    eng.disagg_blocks.pop(slot, None)
                    eng.joins.append((slot, req, eff,
                                      np.asarray(ids, np.int32)))
                self._pump(eng, inflight)
            if self._partner_clone is clone:
                # every engine's reference died with the partner
                self._partner_clone = None
                self._partner_refs = 0

    # ---------------------------------------------------------------- hedge
    def _maybe_hedge(self, task, engine: _SlotEngine,
                     inflight: Dict) -> None:
        """Race a straggling step on a second clone: a step whose timeline
        duration exceeds ``hedge_factor`` times the ``hedge_quantile`` of
        the earlier steps re-issues its closure on a free clone, which
        first pays the engine's live KV context over the link.  The first
        copy to complete is folded; the other's completion is cancelled.

        The duplicate runs the same closure on the engine's own pool, in
        place, right after the first run: the closures are idempotent
        (their writes depend only on their inputs, attention writes
        before it reads), so the pool and the tokens are those of one
        run."""
        if self.hedge_factor <= 0 or task.label != "step":
            return
        hist = self._step_hist
        fire = (len(hist) >= self.hedge_min_samples
                and task.duration > self.hedge_factor
                * float(np.quantile(hist, self.hedge_quantile)))
        hist.append(task.duration)    # after the decision: never vs itself
        if not fire:
            return
        clone = self._free_clone()
        if clone is None or clone is engine.clone:
            return
        kv = engine.kv
        ctx_tokens = int(kv.pos[kv.active].sum())
        delay = (self.autoscaler.clone_ready_delay(clone, self.clock.now())
                 + self._net_s(int(ctx_tokens * self._kv_token_bytes())))
        clone.busy = True
        dup = self.dispatcher.submit(clone, task.fn, task.fn_args,
                                     executor=self.executor,
                                     extra_delay=delay, label="hedge")
        self._charge(clone, dup.venue_seconds)
        self.hedges_fired += 1
        self._hedges[task] = dup
        self._hedges[dup] = task
        inflight[dup] = engine

    def _resolve_hedge(self, winner, inflight: Dict) -> None:
        """The first of a hedge pair completed: cancel the other, return
        the borrowed clone, count a win when the duplicate was first."""
        partner = self._hedges.pop(winner, None)
        if partner is None:
            return
        self._hedges.pop(partner, None)
        inflight.pop(partner, None)
        self.dispatcher.cancel(partner)
        hedge = winner if winner.label == "hedge" else partner
        self.pool.release([hedge.clone])
        if winner is hedge:
            self.hedge_wins += 1

    # ------------------------------------------------------------------ run
    def run(self, requests: List[ServeRequest], *,
            drain_idle_s: float = 0.0) -> ServeReport:
        """Serve ``requests`` on the virtual timeline; returns a report.

        Each round: admit due arrivals into the bounded queue (through
        the gateway when there is one); recover clones that died since the
        last round; offer queued requests to partially-full in-flight
        engines first (mid-flight joins); autoscale on the residual
        demand; start new engines on free clones; advance to the next
        completion, arrival, fault or gateway event.
        """
        reqs = sorted(requests, key=lambda r: r.arrival_t)
        t_start = self.clock.now()
        paged = self.kv_mode == "paged"
        i = 0
        inflight: Dict[object, object] = {}     # task -> engine or cohort
        engines: Dict[int, _SlotEngine] = {}
        completions: List[ServeCompletion] = []
        notified = 0                    # completions fed back to the gateway
        gw = self.gateway
        if self.injector is not None:
            self.injector.arm()
        while True:
            now = self.clock.now()
            self._band_cache.clear()
            while i < len(reqs) and reqs[i].arrival_t <= now + 1e-12:
                if gw is not None:
                    gw.offer(reqs[i], now)
                else:
                    self.queue.offer(reqs[i], now)
                i += 1
            if self.injector is not None:
                # before joins and spawns consult the engine set
                self._recover_failed(inflight, engines)
            if gw is not None:
                # fleet census after recovery: dead and open-breaker
                # clones shrink the gateway's admission envelope
                healthy = sum(1 for c in self.pool.clones if c.serveable)
                gw.observe_fleet(healthy, len(self.pool.clones),
                                 self.max_batch * max(healthy, 1))
                while notified < len(completions):
                    gw.observe_completion(completions[notified])
                    notified += 1
                gw.release(now, self.queue,
                           self.queue.max_depth - self.queue.depth)
                completions.extend(gw.drain_cached())
            self._peak_queue_depth = max(
                self._peak_queue_depth,
                self.queue.depth + (gw.queued if gw is not None else 0))
            if paged and engines:
                for key, eng in engines.items():
                    self.ledger.update(key, eng.kv.free_slots)
                # admit via on_assign so each fits() check sees the block
                # allocations of earlier assignments in the same round;
                # affinity routing prefers engines by cached-prefix depth,
                # random is its control arm
                prefer = None
                if self.routing == "affinity":
                    prefer = (lambda key, r:
                              float(self._affinity_depth(engines[key].kv,
                                                         r)))
                elif self.routing == "random":
                    prefer = lambda key, r: float(self._route_rng.random())
                self.ledger.assign(
                    self.queue,
                    fits=lambda key, r: self._fits_slot(engines[key], r),
                    on_assign=lambda key, r: self._admit(engines[key], r),
                    prefer=prefer)
                for eng in engines.values():
                    self._pump(eng, inflight)
            self.autoscaler.step(now, self._demand_buckets(),
                                 self._in_flight_by_type(inflight))
            while self.queue.depth > 0:
                # first queued request some free clone can serve
                picked = clone = None
                for r in self.queue.snapshot():
                    lo, hi = self._placement_band(r)
                    pc = (self._best_affinity_cid(r)
                          if self.routing == "affinity" else None)
                    clone = self._free_clone(lo, hi, prefer_cid=pc)
                    if clone is not None:
                        picked = r
                        break
                if clone is None:
                    break
                if not paged:
                    # the cohort seeds with the picked request and fills
                    # with band-compatible requests in FIFO order
                    batch = []
                    while len(batch) < self.max_batch:
                        req = self.queue.take_where(
                            lambda r: r is picked or self._in_band(r,
                                                                   clone))
                        if req is None:
                            break
                        batch.append(req)
                    task, cohort = self._start_cohort(batch, clone)
                    inflight[task] = cohort
                    self._band_cache.clear()
                    continue
                engine = self._start_engine(clone)

                def fill(r, picked=picked, engine=engine):
                    if r is picked:
                        return engine.kv.can_admit(
                            _SlotEngine.effective_prompt(
                                r, self.prompt_pad, self.backend.capacity),
                            r.max_new_tokens)
                    return self._fits_slot(engine, r)

                n = 0
                while n < self.max_batch and self.queue.depth > 0:
                    req = self.queue.take_where(fill)
                    if req is None:
                        break
                    self._admit(engine, req)
                    n += 1
                if n == 0:
                    raise RuntimeError(
                        "KV block pool too small to hold one request's "
                        "prompt even when empty — preemption has no "
                        f"victim (num_blocks={engine.kv.num_blocks}, "
                        f"prompt_pad={self.prompt_pad}, "
                        f"block_size={self.block_size})")
                engines[id(engine)] = engine
                self.ledger.update(id(engine), engine.kv.free_slots)
                self._pump(engine, inflight)
                self._band_cache.clear()

            if inflight:
                # bound the wait so arrivals are admitted on time and a
                # clone death is seen when it fires, not when the doomed
                # dispatch would have completed
                next_arrival = reqs[i].arrival_t if i < len(reqs) else None
                next_fault = (self.injector.next_event_time()
                              if self.injector is not None else None)
                next_gw = gw.next_event_time() if gw is not None else None
                bound = min((t for t in (next_arrival, next_fault, next_gw)
                             if t is not None and t > now), default=None)
                first_done = min(t.done_at for t in inflight)
                if bound is not None and bound < first_done:
                    self.clock.advance_to(bound)
                    continue
                for task in self.dispatcher.wait_any(list(inflight)):
                    unit = inflight.pop(task, None)
                    if unit is None:
                        continue          # a hedge loser already resolved
                    self._resolve_hedge(task, inflight)
                    if not paged:
                        cohort = unit
                        tok, cohort.cache = task.value
                        cohort.tok = tok[:, None]
                        if cohort.phase == "prefill":
                            cohort.phase = "decode"
                        else:
                            cohort.step += 1
                        if self._retire(cohort, completions):
                            inflight[self._submit_decode(cohort)] = cohort
                        continue
                    if task.label == "draft":
                        # half a round: chain the verify on the target
                        vt = self._spec_draft_done(unit, task)
                        inflight[vt] = unit
                        self._maybe_hedge(vt, unit, inflight)
                        continue
                    if task.label == "disagg_prefill":
                        # the handoff rides the engine's next step (pumped
                        # now: the engine may have been waiting on it)
                        self._disagg_prefill_done(unit, task)
                        self._pump(unit, inflight)
                        continue
                    unit.main_inflight = False
                    if self._engine_step_done(unit, task, completions):
                        self._pump(unit, inflight)
                    else:
                        engines.pop(id(unit), None)
                        self.ledger.drop(id(unit))
                        self._release_engine(unit)
            elif i < len(reqs):
                self.clock.advance_to(reqs[i].arrival_t)
            elif self.queue.depth > 0:
                # every clone may be dead or tripped with revivals and
                # breaker probes pending: advance to the next clock event
                nxt = (self.clock.next_event_time()
                       if self.injector is not None else None)
                if nxt is not None and nxt > now + 1e-12:
                    self.clock.advance_to(nxt)
                    continue
                raise RuntimeError("requests queued but no clone can run "
                                   "(max_secondaries too small?)")
            elif gw is not None and gw.pending > 0:
                # the gateway still owes work (a quota-blocked head or a
                # Retry-After replay): advance to what releases it
                nxt = gw.next_event_time()
                if nxt is None:
                    nxt = self.clock.next_event_time()
                if nxt is not None and nxt > now + 1e-12:
                    self.clock.advance_to(nxt)
                    continue
                raise RuntimeError("gateway holds queued work but no clock "
                                   "event can release it")
            else:
                break

        if drain_idle_s > 0.0:       # let idle TTLs pause the secondaries
            end = self.clock.now() + drain_idle_s
            while self.clock.now() < end - 1e-9:
                self.clock.advance(min(PAUSE_IDLE_TTL,
                                       end - self.clock.now()))
                self.pool.reap_idle()
            self.autoscaler.step(self.clock.now(), [], {})

        lat = np.array([c.latency_s for c in completions]) \
            if completions else np.zeros(1)
        ttft = np.array([c.ttft_s for c in completions]) \
            if completions else np.zeros(1)
        makespan = self.clock.now() - t_start - drain_idle_s
        utils = [w / r for w, r in self.kv_samples if r > 0]
        # SLO accounting over *offered* requests: rejected, shed or
        # dropped work counts as missed
        offered_by_slo: Dict[str, int] = {}
        for r in reqs:
            offered_by_slo[r.slo] = offered_by_slo.get(r.slo, 0) + 1
        met_by_slo: Dict[str, int] = {}
        for c in completions:
            if c.met_deadline:
                met_by_slo[c.slo] = met_by_slo.get(c.slo, 0) + 1
        by_tenant: Dict[str, List[ServeCompletion]] = {}
        for c in completions:
            by_tenant.setdefault(c.tenant or "", []).append(c)
        per_tenant = {
            t: {"served": float(len(cs)),
                "p50_ttft_s": float(np.percentile([c.ttft_s for c in cs],
                                                  50)),
                "p50_tpot_s": float(np.percentile([c.tpot_s for c in cs],
                                                  50))}
            for t, cs in sorted(by_tenant.items())}
        good_tokens = sum(len(c.tokens) for c in completions
                          if c.met_deadline)
        return ServeReport(
            completions=completions,
            accepted=self.queue.accepted,
            rejected=self.queue.rejected,
            makespan_s=makespan,
            p50_latency_s=float(np.percentile(lat, 50)),
            p99_latency_s=float(np.percentile(lat, 99)),
            p50_ttft_s=float(np.percentile(ttft, 50)),
            tokens_per_s=self.tokens_emitted / max(makespan, 1e-9),
            peak_secondaries=self.autoscaler.peak_secondaries,
            scale_ups=self.autoscaler.scale_ups,
            busy_energy_j=self.busy_energy_j,
            pool_stats=dict(self.pool.stats),
            clone_samples=list(self.autoscaler.samples),
            kv_mode=self.kv_mode,
            kv_util=float(np.mean(utils)) if utils else 0.0,
            kv_reserved_peak=max((r for _, r in self.kv_samples),
                                 default=0),
            prefix_hit_rate=(self.prefix_hit_tokens
                             / max(self.prompt_tokens, 1)),
            preemptions=self.preemptions,
            restored_tokens=self.restored_tokens,
            fleet_mix=dict(self.fleet_mix),
            escalations=len(self._escalated),
            clone_seconds_by_type=self.pool.clone_seconds_by_type(
                self.clock.now()),
            cost_usd=self.pool.cost_usd(self.clock.now()),
            energy_j_by_type=dict(self.energy_j_by_type),
            power_offs=self.pool.stats["offs"],
            spec_rounds=self.spec_rounds,
            spec_tokens=self.spec_tokens,
            acceptance_rate=(self.spec_accepted
                             / max(self.spec_proposed, 1)),
            spec_fallbacks=self.spec_fallbacks,
            disagg_handoffs=self.disagg_handoffs,
            disagg_colocated=self.disagg_colocated,
            disagg_fallbacks=self.disagg_fallbacks,
            kv_transfer_bytes=self.kv_transfer_bytes,
            kv_transfer_s=self.kv_transfer_s,
            faults_injected=(self.injector.stats["injected"]
                             if self.injector is not None else 0),
            recoveries_migrated=self.recoveries_migrated,
            recoveries_restored=self.recoveries_restored,
            hedges_fired=self.hedges_fired,
            hedge_wins=self.hedge_wins,
            breaker_opens=sum(c.breaker.opens for c in self.pool.clones),
            slo_attainment={s: met_by_slo.get(s, 0) / n
                            for s, n in offered_by_slo.items() if n},
            goodput_tps=good_tokens / max(makespan, 1e-9),
            gateway_shed=gw.shed if gw is not None else 0,
            gateway_rejected=gw.rejected if gw is not None else 0,
            gateway_retries=gw.retries if gw is not None else 0,
            cache_hits=gw.cache_hits if gw is not None else 0,
            shed_by_slo=dict(gw.shed_by_slo) if gw is not None else {},
            per_tenant=per_tenant,
            peak_queue_depth=self._peak_queue_depth,
            per_clone={
                str(cid): {
                    "type": st["type"],
                    "prefix_hit_rate": (st["prefix_hit_tokens"]
                                        / max(st["prompt_tokens"], 1)),
                    "kv_transfer_bytes": float(st["kv_transfer_bytes"]),
                    "kv_transfer_s": float(st["kv_transfer_s"])}
                for cid, st in sorted(self.per_clone_stats.items())})


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--policy", default="exec_time",
                    help="offload policy of the batch ServingEngine")
    ap.add_argument("--handler", action="store_true",
                    help="serve through the event-driven ClientHandler")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson offered load (req/s) for --handler")
    ap.add_argument("--kv", choices=["paged", "contiguous"], default="paged",
                    help="KV cache mode for --handler")
    ap.add_argument("--window", type=int, default=1,
                    help="decode window: tokens fused per device dispatch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    cfg = reduced_config(get_config(args.arch))
    if args.handler:
        backend = LMBackend(cfg, capacity=64, device=args.device)
        handler = ClientHandler(backend, max_batch=args.batch, kv=args.kv,
                                decode_window=args.window)
        reqs = poisson_arrivals(args.rate, args.requests,
                                prompt_len=8, vocab=cfg.vocab_size,
                                max_new_tokens=args.new_tokens)
        report = handler.run(reqs, drain_idle_s=60.0)
        print(report.summary())
        print("pool:", report.pool_stats)
        return

    eng = ServingEngine(cfg, policy=Policy(args.policy), device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=12,
                                    dtype=np.int32), args.new_tokens)
            for i in range(args.requests)]
    for i in range(0, len(reqs), args.batch):
        comps = eng.serve_batch(reqs[i:i + args.batch])
        c = comps[0]
        print(f"batch {i // args.batch}: venue={c.prefill_venue} "
              f"latency={c.latency_s:.3f}s tokens={c.tokens[:6]}...")
    print("stats:", eng.stats)


if __name__ == "__main__":
    main()
