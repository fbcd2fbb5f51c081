"""Named host ranges in the profiler's trace, free when no trace is taken.

``span(name)`` wraps a stage of the serving path (``serve.*``) or of the
model (``model.*``).  With no ``torch.profiler`` session open it returns
one shared ``contextlib.nullcontext``, so the cost is a flag read.  With a
session open it enters a function-scope ``RecordFunction``: the range
lands among the trace's host events on the clock the device events use,
so a gap in the device's work can be named by the stage the host was in.
Function-scope ranges are not mirrored onto the device as user
annotations, as ``torch.profiler.record_function`` ranges are.

The ranges, from the handler down:

- ``serve.admit``: a handler round's admission: due arrivals into the
  queue, queued requests into free slots of running engines, and
  placement onto free clones (where a new engine's first step goes out
  inside it);
- ``serve.schedule``: planning an engine step, up to its dispatch;
- ``serve.step.<kind>``: the step closure's body, ``kind`` one of
  ``join``, ``mixed``, ``suffix``, ``decode``;
- ``serve.harvest``: folding a finished step back into the slots;
- ``model.embed``, ``model.unembed``: each pass over the stack's inputs
  (the embedding, rotary tables, per-row masks) and outputs (the
  unembedding and the greedy pick);
- ``model.layer``: one repetition of the block pattern (one layer of a
  uniform stack), around the ranges of its blocks: ``model.attn.qkv``
  (norm, projections, rotary), ``model.attn.kv`` (the cache write),
  ``model.attn.core`` (the attention kernel or the plain path),
  ``model.attn.out`` (the output projection) and ``model.mlp`` (the
  residual add, norm and feed-forward).

A step of a deep model records tens of thousands of host events, so each
layer carries ranges of its own: a stage is named by a range that opened
close to it, not only by the step's.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager holding ``name`` as a host range while a profiler
    session is open; otherwise the one shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
