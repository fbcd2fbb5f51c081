"""Serving stack: ThinkAir's Client Handler for LM inference, on PyTorch.

``LMBackend`` binds a model (parameters on one device, a ``RunContext``
selecting the hand-written CUDA kernels or the plain path) and hands the
serving layer its paged step functions.  ``ClientHandler`` is the
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

This slice ports the default paged path.  The contiguous cohort mode,
speculative decoding, disaggregated prefill, fault injection and hedging,
the SLO gateway, non-ledger routing and the legacy ``ServingEngine`` raise
``NotImplementedError`` naming their ROADMAP item.

The KV pool is updated in place.  Every step closure is idempotent (each
write is a function of the step's inputs, attention writes before it
reads, and no input other than the pool is mutated), so an executor may
re-run a closure, as :class:`~repro_torch.core.venues.Venue` does to
stabilise its timing.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.clock import VirtualClock
from repro_torch.core.clones import (CLONE_TYPES, KV_SCALE_BY_CLONE_TYPE,
                                     PAUSE_IDLE_TTL, CircuitBreaker,
                                     ClonePool)
from repro_torch.core.dispatch import Dispatcher
from repro_torch.core.energy import GpuEnergyModel
from repro_torch.core.policy import Policy
from repro_torch.core.scheduler import (AdmissionQueue, FleetAutoscaler,
                                        PlacementEngine, ServeCompletion,
                                        ServeRequest, SlotLedger,
                                        poisson_arrivals)
from repro_torch.core.venues import Venue, transfer_time
from repro_torch.kernels import ref as kref
from repro_torch.models import blocks, model
from repro_torch.models.context import RunContext


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1): the dispatch bucket size, so
    variable-size batches (join rows, CoW pairs, suffix rows and steps)
    take O(log) distinct shapes."""
    if n < 1:
        raise ValueError(f"bucket size needs n >= 1: {n}")
    return 1 << (n - 1).bit_length()


class LMBackend:
    """Model binding: parameters on a device + the paged step functions.

    ``params`` accepts bridged weights (``models.weights.from_jax``);
    without it parameters are drawn from a ``torch.Generator`` seeded 0.
    ``device`` defaults to ``cuda`` (raising where there is none);
    ``impl`` defaults to the CUDA kernels on a card and the plain path
    elsewhere.  Configurations outside the dense full-attention family
    raise ``NotImplementedError``.
    """

    def __init__(self, cfg, capacity: int = 256, *,
                 params: Optional[Dict] = None, device=None,
                 impl: Optional[str] = None):
        blocks.check_supported(cfg)
        self.cfg = cfg
        self.capacity = capacity
        self.ctx = RunContext.on(device, impl)
        self.device = self.ctx.device
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = model.init(cfg, gen, self.device)
        self.params = params

    @property
    def supports_chunked(self) -> bool:
        """Whether chunked prefill / mixed dispatch cover this config."""
        return model.supports_chunked_prefill(self.cfg)

    def cache_mem_bytes(self, batch: int) -> int:
        """Bytes of a contiguous (batch, capacity) KV cache, with the same
        per-leaf framing tax as ``venues.pytree_bytes``."""
        cfg = self.cfg
        per_layer = (2 * batch * self.capacity * cfg.n_kv_heads
                     * cfg.head_dim * model.dtype_of(cfg).itemsize)
        pat, _, rest = model.grouping(cfg)
        return per_layer * cfg.n_layers + 64 * 2 * (len(pat) + len(rest))

    def tensor(self, x) -> torch.Tensor:
        """A host array as an int32 tensor on the backend's device (a
        copy: later host mutation never reaches a dispatched step)."""
        return torch.tensor(np.asarray(x), dtype=torch.int32,
                            device=self.device)

    # ---------------------------------------------------------------- paged
    def init_paged_pool(self, max_slots: int, num_blocks: int,
                        block_size: int):
        """Zero KV block pool on the backend's device (block 0 = trash)."""
        return model.init_paged_cache(self.cfg, max_slots, num_blocks,
                                      block_size, device=self.device)

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
        self.submitted_joins: List[tuple] = []
        self.submitted_sfx: List[tuple] = []
        self.decode_rows: Optional[np.ndarray] = None
        self.decode_counts: Optional[np.ndarray] = None
        self._tables_dev = None
        self._tables_ver = -1
        self.main_inflight = False

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
                or bool(self.joins) or bool(self.sfx_joins))

    def step_work(self) -> bool:
        return (bool(self.kv.active.any()) or bool(self.joins)
                or bool(self.sfx_joins))


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

    def summary(self) -> str:
        return (f"served={len(self.completions)} shed={self.rejected} "
                f"p50={self.p50_latency_s:.3f}s p99={self.p99_latency_s:.3f}s "
                f"ttft50={self.p50_ttft_s:.3f}s "
                f"tok/s={self.tokens_per_s:.1f} "
                f"kv={self.kv_mode} kv_util={self.kv_util:.0%} "
                f"prefix_hits={self.prefix_hit_rate:.0%} "
                f"preempt={self.preemptions} "
                f"peak_secondaries={self.peak_secondaries}")


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is ported in a later slice "
                               f"(ROADMAP Queue 1: {item})")


class ClientHandler:
    """Event-driven continuous-batching server on an elastic clone pool:
    each clone runs a :class:`_SlotEngine` — ``max_batch`` slots over a
    :class:`KVBlockPool`, per-slot cursors, mid-flight admission."""

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
                 speculative: bool = False, disagg: bool = False,
                 faults=None, hedge_factor: float = 0.0, gateway=None,
                 routing: str = "ledger"):
        if kv == "contiguous":
            raise _later("kv='contiguous'", "contiguous mode")
        if kv != "paged":
            raise ValueError(f"kv must be 'paged' or 'contiguous': {kv!r}")
        if speculative:
            raise _later("speculative decoding", "verify/spec + draft_loop")
        if disagg:
            raise _later("disaggregated prefill", "disagg + int8 pair")
        if faults or hedge_factor > 0:
            raise _later("fault injection and hedging",
                         "faults/hedging/gateway")
        if gateway is not None:
            raise _later("the SLO gateway", "faults/hedging/gateway")
        if routing != "ledger":
            raise _later(f"routing={routing!r}", "disagg + int8 pair")
        if decode_window < 1:
            raise ValueError(f"decode_window must be >= 1: {decode_window}")
        chunk_ok = bool(getattr(backend, "supports_chunked", False))
        if prefill_chunk is None:
            prefill_chunk = 8 if chunk_ok else 0
        elif prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0: {prefill_chunk}")
        elif prefill_chunk > 0 and not chunk_ok:
            raise ValueError("prefill_chunk > 0 requires a backend with "
                             "chunked-prefill support (all-attention, "
                             "windowless layers)")
        if mixed_dispatch is None:
            mixed_dispatch = prefill_chunk > 0
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

    # ---------------------------------------------------------------- clones
    def _free_clone(self, lo_rank: Optional[int] = None,
                    hi_rank: Optional[int] = None):
        """Best usable clone inside the ``[lo_rank, hi_rank]`` band:
        soonest-ready first, then the smallest tier, then cid.  The primary
        is exempt from the band's upper bound (standing capacity)."""
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
        return min(cands)[3] if cands else None

    def _net_s(self, nbytes: int) -> float:
        return transfer_time(nbytes, self.pool.link)

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
            ct = self.placement.choose_type(rt, urgent=req.priority > 0) \
                or rt
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

    # ------------------------------------------------------------- slots
    def _start_engine(self, clone) -> _SlotEngine:
        """Engine for ``clone``; its KV pool is allocated once and reset
        across engine generations, so the prefix index survives."""
        clone.busy = True
        kv = self._kv_pools.get(clone.cid)
        if kv is None:
            kv = KVBlockPool(self.backend, self.max_batch, self.block_size,
                             self._blocks_for_type(clone.ctype.name),
                             prefix_cache=self.prefix_cache)
            self._kv_pools[clone.cid] = kv
        else:
            kv.reset()
        return _SlotEngine(self.backend, clone, kv, self.decode_window,
                           self.prefill_chunk, self.mixed_dispatch)

    def _admit(self, engine: _SlotEngine, req: ServeRequest) -> None:
        info = engine.admit(req, self.prompt_pad)
        self.prefix_hit_tokens += info["cached"]
        self.prompt_tokens += info["prompt"]
        if info["restore"]:
            self.restored_tokens += info["suffix"]

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
        ran, so nothing is lost) and requeue it at the head."""
        if engine.sfx_joins:
            slot, req, _, _, _ = engine.sfx_joins.pop()
        else:
            slot, req, _, _ = engine.joins.pop()
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
                if engine.joins or engine.sfx_joins:
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
        counts = np.zeros((kv.max_slots,), np.int32)
        for slot in np.nonzero(kv.active)[0]:
            s = engine.slots[slot]
            counts[slot] = min(engine.window,
                               s.req.max_new_tokens - len(s.out))
        if counts.any():
            self._grow_or_preempt(engine, counts)
        joins, engine.joins = engine.joins, []
        sfx, engine.sfx_joins = engine.sfx_joins, []
        cow, engine.cow_pairs = engine.cow_pairs, []
        engine.submitted_joins = joins
        engine.submitted_sfx = sfx
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
        sfx_batch = None
        mixed_batch = None
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
                mix_steps = max(engine.window, sfx_steps)
                mixed_batch = (backend.mixed_fn(kv.bs, chunk, mix_steps),) \
                    + sfx_args
            else:
                sfx_batch = (backend.prefill_window_fn(kv.bs, tpad,
                                                       chunk=chunk),) \
                    + sfx_args
            nbytes += int(stoks.nbytes)

        def step_fn(params, pool, tok, pos, steps_left, tables):
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

        delay = (self.autoscaler.clone_ready_delay(engine.clone,
                                                   self.clock.now())
                 + self._net_s(nbytes))
        task = self.dispatcher.submit(
            engine.clone, step_fn,
            (backend.params, kv.pool, tok, pos, steps_left, tables),
            executor=self.executor, extra_delay=delay,
            label="step" if do_decode else "prefill")
        self._charge(engine.clone, task.venue_seconds)
        engine.main_inflight = True
        return task

    def _pump(self, engine: _SlotEngine, inflight: Dict) -> None:
        """Submit the engine's next step unless one is in flight."""
        if engine.step_work() and not engine.main_inflight:
            inflight[self._submit_engine_step(engine)] = engine

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
            kv.active[slot] = True
        engine.submitted_sfx = []
        kv.clear_pending()
        if engine.decode_rows is not None and nxt is not None:
            nxt = nxt.cpu().numpy()                     # (S, window)
            rows = engine.decode_rows
            n = engine.decode_counts[rows]              # >= 1 per active row
            engine.tok_host[rows] = nxt[rows, n - 1]
            kv.pos[rows] = np.minimum(kv.pos[rows] + n, kv.capacity)
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

    # ------------------------------------------------------------------ run
    def run(self, requests: List[ServeRequest], *,
            drain_idle_s: float = 0.0) -> ServeReport:
        """Serve ``requests`` on the virtual timeline; returns a report.

        Each round: admit due arrivals into the bounded queue; offer
        queued requests to partially-full in-flight engines first
        (mid-flight joins); autoscale on the residual demand; start new
        engines on free clones; advance to the next completion or arrival.
        """
        reqs = sorted(requests, key=lambda r: r.arrival_t)
        t_start = self.clock.now()
        i = 0
        inflight: Dict[object, _SlotEngine] = {}
        engines: Dict[int, _SlotEngine] = {}
        completions: List[ServeCompletion] = []
        while True:
            now = self.clock.now()
            self._band_cache.clear()
            while i < len(reqs) and reqs[i].arrival_t <= now + 1e-12:
                self.queue.offer(reqs[i], now)
                i += 1
            if engines:
                for key, eng in engines.items():
                    self.ledger.update(key, eng.kv.free_slots)
                # admit via on_assign so each fits() check sees the block
                # allocations of earlier assignments in the same round
                self.ledger.assign(
                    self.queue,
                    fits=lambda key, r: self._fits_slot(engines[key], r),
                    on_assign=lambda key, r: self._admit(engines[key], r))
                for eng in engines.values():
                    self._pump(eng, inflight)
            self.autoscaler.step(now, self._demand_buckets(),
                                 self._in_flight_by_type(inflight))
            while self.queue.depth > 0:
                # first queued request some free clone can serve
                picked = clone = None
                for r in self.queue.snapshot():
                    clone = self._free_clone(*self._placement_band(r))
                    if clone is not None:
                        picked = r
                        break
                if clone is None:
                    break
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
                next_arrival = reqs[i].arrival_t if i < len(reqs) else None
                first_done = min(t.done_at for t in inflight)
                if next_arrival is not None and now < next_arrival \
                        < first_done:
                    self.clock.advance_to(next_arrival)
                    continue
                for task in self.dispatcher.wait_any(list(inflight)):
                    unit = inflight.pop(task, None)
                    if unit is None:
                        continue
                    unit.main_inflight = False
                    if self._engine_step_done(unit, task, completions):
                        self._pump(unit, inflight)
                    else:
                        engines.pop(id(unit), None)
                        self.ledger.drop(id(unit))
                        self.pool.release([unit.clone])
            elif i < len(reqs):
                self.clock.advance_to(reqs[i].arrival_t)
            elif self.queue.depth > 0:
                raise RuntimeError("requests queued but no clone can run "
                                   "(max_secondaries too small?)")
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
            power_offs=self.pool.stats["offs"])


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--handler", action="store_true",
                    help="serve through the event-driven ClientHandler")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson offered load (req/s) for --handler")
    ap.add_argument("--window", type=int, default=1,
                    help="decode window: tokens fused per device dispatch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    if not args.handler:
        raise NotImplementedError("the batch-at-a-time ServingEngine is "
                                  "ported in a later slice (ROADMAP Queue 1: "
                                  "ServingEngine); use --handler")
    cfg = reduced_config(get_config(args.arch))
    backend = LMBackend(cfg, capacity=64, device=args.device)
    handler = ClientHandler(backend, max_batch=args.batch,
                            decode_window=args.window)
    reqs = poisson_arrivals(args.rate, args.requests,
                            prompt_len=8, vocab=cfg.vocab_size,
                            max_new_tokens=args.new_tokens)
    report = handler.run(reqs, drain_idle_s=60.0)
    print(report.summary())
    print("pool:", report.pool_stats)


if __name__ == "__main__":
    main()
