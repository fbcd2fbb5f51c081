"""The yardstick's arithmetic: operations and bytes that the traffic needs,
worked out from shapes and from the arguments the timed path handed to
each step, and the card's peaks they are held to.

Nothing here reads a kernel's launch plan.  Every count is what the work
needs: each input byte read once, each output byte written once (a KV
block that several rows share is read once), attention over the keys a
causal query needs, and 2 operations per multiply-add.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense, no sparsity; at the
# 700 W power limit): bf16 tensor-core operations and HBM3 bandwidth.
PEAK_FLOPS_BF16 = 989e12
PEAK_HBM_BYTES_S = 3.35e12
ACT_BYTES = 2                    # bfloat16 activations and KV


@dataclasses.dataclass(frozen=True)
class Shape:
    """The widths the counts need, from a configuration file."""

    layers: int
    d_model: int
    q_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    experts: int = 0
    top_k: int = 0

    @classmethod
    def of(cls, conf: dict) -> "Shape":
        return cls(conf["num_hidden_layers"], conf["hidden_size"],
                   conf["num_attention_heads"], conf["num_key_value_heads"],
                   conf["head_dim"], conf["intermediate_size"],
                   conf["vocab_size"], conf.get("num_experts", 0),
                   conf.get("num_experts_per_tok", 0))

    def layer_matmul_params(self) -> int:
        """Weights one token multiplies in one layer: the q/k/v/o
        projections and the gated feed-forward it is routed to (for a
        mixture of experts, the router and ``top_k`` experts)."""
        d, n = self.d_model, self.head_dim
        attn = d * self.q_heads * n * 2 + d * self.kv_heads * n * 2
        per_ffn = 3 * d * self.d_ff
        if self.experts:
            return attn + d * self.experts + self.top_k * per_ffn
        return attn + per_ffn

    def kv_token_bytes(self) -> int:
        """K and V of one token in one layer."""
        return 2 * self.kv_heads * self.head_dim * ACT_BYTES


def _pos_sum(a: int, b: int) -> int:
    """sum of (p + 1) for p in [a, b): the keys causal queries at
    positions a .. b-1 attend to."""
    return (b * (b + 1) - a * (a + 1)) // 2


def attn_flops(shape: Shape, keys: int) -> int:
    """One layer's attention operations for ``keys`` query-key pairs:
    QK^T and PV, 2 operations per multiply-add, every query head."""
    return 4 * shape.q_heads * shape.head_dim * keys


def span_flops(shape: Shape, start: int, end: int) -> int:
    """Model operations of the tokens at positions [start, end): every
    layer's projections, feed-forward and causal attention (no
    unembedding)."""
    n = end - start
    return shape.layers * (2 * shape.layer_matmul_params() * n
                           + attn_flops(shape, _pos_sum(start, end)))


def logits_flops(shape: Shape, n: int) -> int:
    """The unembedding of ``n`` tokens whose next token is picked."""
    return 2 * shape.d_model * shape.vocab * n


def request_flops(shape: Shape, prompt: int, outputs: int,
                  start: int = 0) -> int:
    """What one finished request needs: prompt positions [start, prompt)
    (``start`` > 0 for a prefix already counted), every output token but
    the last fed back, and one unembedding per output token."""
    return (span_flops(shape, start, prompt + outputs - 1)
            + logits_flops(shape, outputs))


# ---------------------------------------------------------------- kernels
@dataclasses.dataclass
class Launches:
    """Operations and bytes of a set of attention launches: one entry per
    (step, layer-stack) launch group, each repeated ``layers`` times."""

    groups: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    def add(self, flops: int, nbytes: int) -> None:
        self.groups.append((flops, nbytes))

    def least_s(self, layers: int) -> float:
        """The least time on the card: per launch the larger of operations
        over peak compute and bytes over peak bandwidth."""
        return layers * sum(max(f / PEAK_FLOPS_BF16, b / PEAK_HBM_BYTES_S)
                            for f, b in self.groups)


def _kv_tokens(tables: np.ndarray, ctx: np.ndarray, bs: int) -> int:
    """Distinct KV tokens that rows with contexts ``ctx`` read through
    their block tables: a block shared by several rows counts once, at
    the most tokens any of them needs from it."""
    ctx = np.asarray(ctx, np.int64)
    cols = np.arange(tables.shape[1])
    used = cols[None, :] < -(-ctx // bs)[:, None]
    need = np.minimum(bs, ctx[:, None] - cols[None, :] * bs)[used]
    blocks, inv = np.unique(tables[used], return_inverse=True)
    most = np.zeros(len(blocks), np.int64)
    np.maximum.at(most, inv, need)
    return int(most.sum())


def decode_attn(shape: Shape, pos: np.ndarray, steps: np.ndarray,
                tables: np.ndarray, bs: int, out: Launches) -> None:
    """Paged decode: row r at cursor pos[r] emits steps[r] tokens, one
    launch per step; a step reads each live row's query and its context
    (distinct KV tokens) and writes its output."""
    live = np.nonzero(steps > 0)[0]
    for t in range(int(steps.max(initial=0))):
        rows = live[steps[live] > t]
        if rows.size == 0:
            continue
        ctx = pos[rows].astype(np.int64) + t + 1
        q_bytes = 2 * rows.size * shape.q_heads * shape.head_dim * ACT_BYTES
        kv = _kv_tokens(tables[rows], ctx, bs) * shape.kv_token_bytes()
        out.add(attn_flops(shape, int(ctx.sum())), q_bytes + kv)


def cold_prefill_attn(shape: Shape, rows: int, tokens: int,
                      out: Launches) -> None:
    """Batched causal prefill of ``rows`` prompts of ``tokens``: reads
    Q, K, V, writes O."""
    if rows:
        per_tok = (2 * shape.q_heads + 2 * shape.kv_heads) * shape.head_dim
        out.add(rows * attn_flops(shape, _pos_sum(0, tokens)),
                rows * tokens * per_tok * ACT_BYTES)


def suffix_prefill_attn(shape: Shape, pos0: np.ndarray, n: np.ndarray,
                        tables: np.ndarray, bs: int, chunk: int,
                        out: Launches) -> None:
    """Chunked paged prefill: row r's n[r] suffix tokens from pos0[r],
    ``chunk`` a launch; a launch reads its queries and the distinct KV
    tokens of its rows' contexts and writes its outputs."""
    live = np.nonzero(n > 0)[0]
    if live.size == 0:
        return
    chunk = chunk or int(n.max())
    for base in range(0, int(n[live].max()), chunk):
        m = np.clip(n[live] - base, 0, chunk)
        rows = live[m > 0]
        m = m[m > 0]
        a = pos0[rows].astype(np.int64) + base
        keys = sum(_pos_sum(int(x), int(x + k)) for x, k in zip(a, m))
        q_bytes = 2 * int(m.sum()) * shape.q_heads * shape.head_dim \
            * ACT_BYTES
        kv = _kv_tokens(tables[rows], a + m, bs) * shape.kv_token_bytes()
        out.add(attn_flops(shape, keys), q_bytes + kv)


def step_work(free: Dict[str, object], args: Sequence,
              max_slots: int, bs: int, chunk: int, shape: Shape,
              decode: Launches, prefill: Launches) -> None:
    """Add one engine step's attention work to ``decode`` and ``prefill``,
    read from what the handler handed the step: its arguments (``tok,
    pos, steps_left, tables`` after the parameters and the pool) and the
    batches it captured (``join_batch``: tokens, blocks, slots of the
    cold joins, pad rows at slot ``max_slots``; ``mixed_batch`` /
    ``sfx_batch``: the suffix rows' tokens, first positions, lengths and
    tables)."""
    join = free.get("join_batch")
    if join is not None:
        toks, _, slots = join
        real = int((_host(slots) < max_slots).sum())
        cold_prefill_attn(shape, real, int(toks.shape[1]), prefill)
    sfx = free.get("mixed_batch") or free.get("sfx_batch")
    if sfx is not None:
        _, _, spos, sn, stabs = sfx
        suffix_prefill_attn(shape, _host(spos), _host(sn), _host(stabs), bs,
                            chunk, prefill)
    if free.get("do_decode"):
        _, _, _, pos, steps, tables = args[:6]
        decode_attn(shape, _host(pos), _host(steps), _host(tables), bs,
                    decode)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def closure_vars(fn) -> Dict[str, object]:
    """The variables a step closure captured, by name."""
    code = getattr(fn, "__code__", None)
    cells = getattr(fn, "__closure__", None) or ()
    if code is None:
        return {}
    return {k: c.cell_contents
            for k, c in zip(code.co_freevars, cells)}


def join_rows(free: Dict[str, object]) -> int:
    """Rows of a step's batched cold prefill plus its suffix rows, padded
    to their buckets (shapes only: nothing is read from the card)."""
    n = 0
    join = free.get("join_batch")
    if join is not None:
        n += int(join[0].shape[0])
    sfx = free.get("mixed_batch") or free.get("sfx_batch")
    if sfx is not None:
        n += int(sfx[1].shape[0])
    return n


# The names of the engine step closure (``repro_torch.launch.serve.
# ClientHandler._submit_engine_step``) that the yardstick reads: a change
# to them in the program is a change to the yardstick.
STEP_NAMES = ("join_batch", "mixed_batch", "sfx_batch", "do_decode")


class StepDrift(RuntimeError):
    """The engine step no longer exposes what the yardstick reads."""


def check_step(fn, free: Dict[str, object]) -> None:
    """Fail loudly where a step closure lacks one of ``STEP_NAMES``, or
    where its batched prefill disagrees with the ``prefill_tokens`` the
    program sets on the step for executors: a renamed or restructured
    closure would otherwise move steps between kinds, or drop their work
    from the counts, without a word."""
    missing = [k for k in STEP_NAMES if k not in free]
    if missing:
        raise StepDrift(
            f"the engine step closure exposes no {', '.join(missing)} (it "
            f"has {sorted(free)}): the step kinds and attention counts read "
            f"these names from ClientHandler._submit_engine_step")
    join = free["join_batch"]
    want = int(join[0].shape[1]) if join is not None else 0
    have = getattr(fn, "prefill_tokens", None)
    if have is not None and int(have) != want:
        raise StepDrift(f"the step's prefill_tokens {have} disagree with its "
                        f"join_batch ({want} prompt tokens)")


def step_kind(free: Dict[str, object]) -> Optional[str]:
    """``"join"`` for a step that carries joins (cold or suffix prefill),
    ``"decode"`` for one that only decodes, else None."""
    if any(free.get(k) is not None
           for k in ("join_batch", "mixed_batch", "sfx_batch")):
        return "join"
    if free.get("do_decode"):
        return "decode"
    return None
