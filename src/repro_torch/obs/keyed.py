"""When the trace-time wire events fire in an eager program.

The reference emits ``pipeline.wire``, ``dp.wire`` and ``tp.wire`` while
jax traces a step: once per compilation.  jit compiles a step once per
input key, which holds every input's shape, dtype and placement.  A mesh
step therefore compiles twice in a run: once for the caller's arrays on
one device, once more for the mesh-placed arrays it returned itself, and
then never again.  A step built anew (a policy flip) starts over.

The port runs eagerly: the bodies that emit these events run on every
step.  :func:`keyed_step` wraps a built step to play jit's cache.  A
tensor that a wrapped step returned counts as placed.  A call whose key
(each input tensor's shape, dtype and placement, and the inputs'
structure) the wrapper has not seen opens a scope in which
:func:`trace_time_instant` emits each distinct event once: the pipeline x
DP step runs ``pipeline_apply`` once per replica row where the reference
traces it once.  A call whose key was seen emits none.  Outside any
wrapped step (a direct ``pipeline_apply`` call, which the reference would
trace on every eager call) every call emits.

With tracing off the wrapper only calls the step: it records no key and
places nothing, so a step first called while tracing is off emits at its
first traced call.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref

import torch

from repro_torch.obs import trace

# id -> a tensor returned by a keyed step (the identity check guards
# against a reused id)
_PLACED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_QUIET = frozenset()        # scope of a call whose key was seen
_scope = None               # None: no keyed step is running


def _key(tree):
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype,
                _PLACED.get(id(tree)) is tree)
    if isinstance(tree, dict):
        return tuple((k, _key(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_key(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return (type(tree).__name__,) + tuple(
            _key(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, (str, bool, type(None))):
        return tree
    return type(tree).__name__


def _place(tree) -> None:
    if isinstance(tree, torch.Tensor):
        _PLACED[id(tree)] = tree
    elif isinstance(tree, dict):
        for v in tree.values():
            _place(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _place(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _place(getattr(tree, f.name))


def keyed_step(step):
    """Wrap a built step so that its trace-time events fire once per
    input key (module doc)."""
    seen = set()

    @functools.wraps(step)
    def run(*args, **kwargs):
        global _scope
        if trace.get_tracer() is None:
            return step(*args, **kwargs)
        key = _key((args, kwargs))
        outer = _scope
        _scope = _QUIET if key in seen else set()
        seen.add(key)
        try:
            out = step(*args, **kwargs)
        finally:
            _scope = outer
        _place(out)
        return out

    return run


def trace_time_instant(name: str, cat: str = "default", **args) -> None:
    """An instant the reference emits while jax traces: once per new key
    of the running keyed step, every call outside one."""
    tr = trace.get_tracer()
    if tr is None or _scope is _QUIET:
        return
    if _scope is not None:
        ev = (name, cat, repr(sorted(args.items())))
        if ev in _scope:
            return
        _scope.add(ev)
    tr.instant(name, cat, **args)
