"""The programmer API (paper §4.1): ``@remote`` marks a method offloadable.

The paper's toolchain (Remoteable base class + @Remote annotation + code
generator emitting reflection wrappers) collapses to a decorator: the
wrapped callable takes tensors or nested dicts/lists of them (the
serializable state), and the generated "localGenerate + controller.execute"
indirection is the returned wrapper.  ``copyState`` is unnecessary —
results are the only mutated state and flow back as return values.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass
class RemoteableMethod:
    """Registered offloadable method + its ThinkAir metadata.

    ``jit`` and ``static_args`` keep the reference's signature and are not
    used: the port has no tracing step, so :meth:`callable` returns ``fn``
    itself whatever they say."""

    name: str
    fn: Callable                                   # function of tensors
    size_fn: Callable[..., float] = None           # input-size proxy
    split_fn: Optional[Callable] = None            # (args, k) -> [shard_args]
    merge_fn: Optional[Callable] = None            # [shard_results] -> result
    mem_fn: Optional[Callable[..., int]] = None    # working-set bytes
    jit: bool = True                               # accepted, ignored
    static_args: tuple = ()                        # accepted, ignored

    def callable(self) -> Callable:
        return self.fn

    def size_key(self, *args, **kw) -> float:
        if self.size_fn is not None:
            return float(self.size_fn(*args, **kw))
        from repro_torch.core.venues import pytree_bytes
        return float(pytree_bytes((args, kw)))

    @property
    def parallelizable(self) -> bool:
        return self.split_fn is not None and self.merge_fn is not None


REGISTRY: Dict[str, RemoteableMethod] = {}

_DEFAULT_CONTROLLER = None


def set_default_controller(controller) -> None:
    global _DEFAULT_CONTROLLER
    _DEFAULT_CONTROLLER = controller


def get_default_controller():
    return _DEFAULT_CONTROLLER


def remote(fn: Callable = None, *, size: Callable = None,
           split: Callable = None, merge: Callable = None,
           mem: Callable = None, jit: bool = True, name: str = None):
    """Decorator: register ``fn`` as remoteable and route calls through the
    ambient ExecutionController (transparent offloading, paper §4.4)."""

    def wrap(f: Callable):
        rm = RemoteableMethod(name or f.__name__, f, size_fn=size,
                              split_fn=split, merge_fn=merge, mem_fn=mem,
                              jit=jit)
        REGISTRY[rm.name] = rm

        def wrapper(*args, **kw):
            ec = get_default_controller()
            if ec is None:                     # no framework: plain local call
                return rm.callable()(*args, **kw)
            return ec.execute(rm, *args, **kw).value

        wrapper.remoteable = rm
        wrapper.__name__ = rm.name
        return wrapper

    return wrap(fn) if fn is not None else wrap
