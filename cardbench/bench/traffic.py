"""One general generator of serving traffic, driven by a mix's parameters.

A traffic file (``cardbench/traffic/<cell>.json``) holds only data:

- ``prompt``: ``{"kind": "distinct", "tokens": L}`` (every prompt L fresh
  random tokens) or ``{"kind": "shared_prefix", "prefixes": K,
  "prefix_tokens": P, "suffix_tokens": S}`` (K prefixes per run; each
  request is one of them followed by S fresh tokens);
- ``output``: ``{"median": m, "sigma": s, "min": a, "max": b}``, a
  log-normal number of output tokens, rounded and clipped to [a, b];
- ``arrivals``: ``{"kind": "poisson", "rate": r}`` (requests per second) or
  ``{"kind": "bursts", "burst": n, "rate": r}`` (bursts of n requests that
  arrive together, r bursts per second, the gaps between bursts
  exponential); a burst of a shared-prefix mix shares one prefix;
- ``base_seed``: the seed of the sizes and gaps.

The arrival times, the output lengths and which prefix a burst uses are
drawn once from ``base_seed`` and depend on ``--seconds`` only.
``--seed`` shuffles the output lengths within each run of ``SHUFFLE``
consecutive requests and the prefixes within each run of K consecutive
bursts, and draws every token id.  So every seed offers the same work on
the same schedule, in another order locally, and a run's spread is the
system's, not the draw's: a permutation over the whole window would move
clusters of arrivals and long answers from seed to seed, and with them
the batch sizes the tails depend on.  The gaps are scaled so that the
last arrival falls at ``seconds``: the number of requests is
``round(rate * seconds)`` (times the burst size).

Window prompts start with a token id of at least ``WARM_IDS`` and the
warm-up's prompts each with their own id below it, so the prefix index
never matches, even partly, a warm-up block in the window, nor one
warm-up prompt another's.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

WARM_IDS = 64
SHUFFLE = 8


@dataclasses.dataclass
class Arrival:
    """One request as the harness offers it: due time on the serving
    timeline (seconds from the window's start), prompt, output budget and
    the prefix it shares (-1 for none)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    due_s: float
    prefix: int = -1


def _units(arr: dict, seconds: float) -> int:
    """Arrival units (requests, or bursts) in a window of ``seconds``."""
    return max(1, int(round(float(arr["rate"]) * seconds)))


def _burst(arr: dict) -> int:
    return int(arr.get("burst", 1)) if arr["kind"] == "bursts" else 1


def sizes(mix: dict, seconds: float):
    """The seed-independent multiset of the window: (gaps between arrival
    units, output lengths of every request, prefix of every unit)."""
    arr, out = mix["arrivals"], mix["output"]
    if arr["kind"] not in ("poisson", "bursts"):
        raise ValueError(f"unknown arrivals kind {arr['kind']!r}")
    n_units = _units(arr, seconds)
    n_req = n_units * _burst(arr)
    rng = np.random.default_rng(int(mix["base_seed"]))
    gaps = rng.exponential(1.0, n_units)
    gaps *= seconds / gaps.sum()
    lens = np.exp(np.log(float(out["median"]))
                  + float(out["sigma"]) * rng.standard_normal(n_req))
    lens = np.clip(np.rint(lens), int(out["min"]), int(out["max"]))
    k = int(mix["prompt"].get("prefixes", 0))
    prefixes = (np.arange(n_units) % k) if k else np.full(n_units, -1)
    return gaps, lens.astype(np.int64), prefixes


def generate(mix: dict, vocab: int, seed: int,
             seconds: float) -> List[Arrival]:
    """The window's requests for ``seed``, in due order."""
    gaps, lens, prefixes = sizes(mix, seconds)
    rng = np.random.default_rng([int(seed), 0x7AF1C])
    lens = lens[_local_perm(len(lens), SHUFFLE, rng)]
    k = int(mix["prompt"].get("prefixes", 0))
    if k:
        prefixes = prefixes[_local_perm(len(prefixes), k, rng)]
    due = np.cumsum(gaps)
    burst = _burst(mix["arrivals"])
    prompt = mix["prompt"]
    bodies = _prefix_tokens(prompt, vocab, rng)
    out: List[Arrival] = []
    for u, t in enumerate(due):
        for _ in range(burst):
            rid = len(out)
            toks = _prompt(prompt, vocab, rng, bodies, int(prefixes[u]))
            out.append(Arrival(rid, toks, int(lens[rid]), float(t),
                               int(prefixes[u])))
    return out


def _local_perm(n: int, block: int, rng) -> np.ndarray:
    """A permutation of range(n) that moves each index only within its run
    of ``block`` consecutive ones."""
    idx = np.arange(n)
    for a in range(0, n, block):
        idx[a:a + block] = a + rng.permutation(min(block, n - a))
    return idx


def _prefix_tokens(prompt: dict, vocab: int, rng) -> List[np.ndarray]:
    """The run's shared prefixes, their first tokens pairwise distinct
    (a prefix's first block never partially matches another's)."""
    if prompt["kind"] == "distinct":
        return []
    if prompt["kind"] != "shared_prefix":
        raise ValueError(f"unknown prompt kind {prompt['kind']!r}")
    k, p = int(prompt["prefixes"]), int(prompt["prefix_tokens"])
    firsts = rng.choice(np.arange(WARM_IDS, vocab), size=k, replace=False)
    bodies = []
    for f in firsts:
        b = rng.integers(0, vocab, p, dtype=np.int64).astype(np.int32)
        b[0] = f
        bodies.append(b)
    return bodies


def _prompt(prompt: dict, vocab: int, rng, bodies, prefix: int) -> np.ndarray:
    if prompt["kind"] == "distinct":
        t = rng.integers(0, vocab, int(prompt["tokens"]),
                         dtype=np.int64).astype(np.int32)
        t[0] = rng.integers(WARM_IDS, vocab)
        return t
    sfx = rng.integers(0, vocab, int(prompt["suffix_tokens"]),
                       dtype=np.int64).astype(np.int32)
    return np.concatenate([bodies[prefix], sfx])


def prompt_tokens(prompt: dict) -> int:
    """Every prompt's length (the handler's ``prompt_pad``)."""
    if prompt["kind"] == "distinct":
        return int(prompt["tokens"])
    return int(prompt["prefix_tokens"]) + int(prompt["suffix_tokens"])


def warmup(mix: dict, vocab: int) -> List[Arrival]:
    """Seed-independent warm-up requests that make every shape the window
    makes: for each ``warmup.join_rows`` size n, n cold prompts arriving
    together (one batched prefill of n rows); for a shared-prefix mix also,
    for each ``warmup.suffix_rows`` size n, n prefix hits arriving together
    while an earlier request decodes (one mixed step with n suffix rows).
    Groups sit 1000 s apart on the timeline, so each runs alone; the i-th
    fresh prompt starts with token i (below ``WARM_IDS``)."""
    wu = mix["warmup"]
    prompt = mix["prompt"]
    rng = np.random.default_rng(0x3A3)
    plen = prompt_tokens(prompt)

    firsts = iter(range(WARM_IDS))

    def fresh(n):
        t = rng.integers(0, vocab, n, dtype=np.int64).astype(np.int32)
        t[0] = next(firsts)
        return t

    out: List[Arrival] = []
    t = 0.0
    for n in wu["join_rows"]:
        t += 1000.0
        for _ in range(int(n)):
            out.append(Arrival(len(out), fresh(plen), 2, t))
    if prompt["kind"] == "shared_prefix":
        pfx = fresh(int(prompt["prefix_tokens"]))
        sfx = int(prompt["suffix_tokens"])
        t += 1000.0
        out.append(Arrival(len(out), np.concatenate([pfx, fresh(sfx)]),
                           int(wu.get("decode_tokens", 64)), t, 0))
        for i, n in enumerate(wu["suffix_rows"]):
            # after the cold prefill, each group lands in its own step
            ti = t + float(wu.get("suffix_gap_s", 0.5)) * (i + 1)
            for _ in range(int(n)):
                out.append(Arrival(len(out),
                                   np.concatenate([pfx, fresh(sfx)]), 2, ti,
                                   0))
    return out
