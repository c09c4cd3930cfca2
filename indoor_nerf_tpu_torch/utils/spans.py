"""The port's one span recorder: host time per layer, and the names a
device trace carries.

    from indoor_nerf_tpu_torch.utils.spans import span

    with span("encode"):
        ...
    with span("request", request=7):   # ids, inherited by the span's children
        ...

``span(name, **ids)`` opens one span of a layer; ``NAMES`` lists every name
the package opens. A span is in one of three states:

- **off** (the default, and whenever ``disable()`` was called last): the
  span reads no clock, records nothing and does not call into
  ``torch.profiler``; ``span`` returns one shared context manager that
  does nothing.
- **profiler active** (a ``torch.profiler`` profile runs): the span also
  opens ``torch.profiler.record_function(name)`` under the same name, so a
  device trace groups the operations a span launched by that name.
- **on** (``enable()``): the span records its name, parent, thread (the
  native id, as a Chrome trace gives it), start and end in nanoseconds of
  ``time.time_ns()``, the clock of the profiler's CPU events, so a recorded
  span lines up with a device trace of the same stretch. A span opened on
  autograd's worker thread (on CUDA, the encode's backward runs there)
  takes as its parent the ``backward`` span, which is open on the thread
  that called ``torch.autograd.grad``.

A **unit** is a root span named in ``UNITS``: ``train_step`` in training,
``request`` in serving. A unit holds every span its thread closed since its
previous unit closed, so the sampler and the draws before a step count in
that step. When a unit closes, its total and self nanoseconds per span
name go into a ring of the last ``RING_UNITS`` units. A span's self time
is its duration minus the union of its children's intervals.

``reset()`` drops what was recorded; ``snapshot()`` returns the ring, the
per-name totals over the units and the last ``RECENT_SPANS`` spans.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

NAMES = (
    # training: train/step.py, train/trainer.py
    "train_step", "draw", "sampler", "batch", "read", "tv", "reg_patches",
    "priors", "backward", "acaq_fp_forward", "optimizer", "occ_update",
    # the field and the renderer: models/field.py, render/renderer.py
    "sample", "encode", "mlp", "composite",
    # the proposal chains: render/proposal.py, train/step.py ("ipe":
    # Mip-NeRF 360's frustums, Gaussians, contraction and encoding)
    "contract", "proposal", "pdf", "interlevel", "ipe",
    # the encodes' backward: ops/blockhash.py, ops/encoding.py
    "encode_bwd",
    # serving: serve.py
    "request", "queue", "render", "drain", "copy",
    # the bake and the baked renderer: render/baked.py
    "bake_vertices", "bake_visibility", "baked_sample", "baked_pass1",
    "baked_composite", "baked_pass2", "baked_color",
)
UNITS = ("train_step", "request")
GRAD_CALLER = "backward"  # the span around torch.autograd.grad
RING_UNITS = 8192
RECENT_SPANS = 65536

_on = False
_epoch_ns = 0  # the time of the last reset(): older spans are dropped
_tls = threading.local()
_grad_owner: Optional["Span"] = None
_units: collections.deque = collections.deque(maxlen=RING_UNITS)
_recent: collections.deque = collections.deque(maxlen=RECENT_SPANS)
_totals: Dict[str, List[int]] = {}  # name -> [count, total_ns, self_ns]
_lock = threading.Lock()


def enable() -> None:
    """Record every span opened from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans already open still close into the record."""
    global _on
    _on = False


def reset() -> None:
    """Drop every unit, total and span recorded so far, and every span
    still waiting for its unit."""
    global _epoch_ns
    with _lock:
        _epoch_ns = time.time_ns()
        _units.clear()
        _recent.clear()
        _totals.clear()


def snapshot() -> Dict:
    """``{"units": [...], "totals": {...}, "spans": [...]}``:

    - ``units``: the ring, oldest first; each unit is ``{"unit": name,
      "ids": {...}, "start_ns", "end_ns", "total_ns": {span name: ns},
      "self_ns": {span name: ns}}``, ``start_ns`` the earliest start of its
      spans;
    - ``totals``: ``{span name: {"count", "total_ns", "self_ns"}}`` summed
      over every unit closed since the last reset (beyond the ring too);
    - ``spans``: the last spans closed, each ``(name, parent name or None,
      thread, start_ns, end_ns, ids)``."""
    with _lock:
        units = list(_units)
        totals = {k: {"count": c, "total_ns": t, "self_ns": s}
                  for k, (c, t, s) in _totals.items()}
        recent = list(_recent)
    return {"units": units, "totals": totals,
            "spans": [(s.name, None if s.parent is None else s.parent.name,
                       s.tid, s.start, s.end, s.ids) for s in recent]}


class _Off:
    """The span of the off state: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **ids):
    """A context manager over one span of the layer ``name`` (a name of
    ``NAMES``); ``ids`` (e.g. ``request=7``) tag it and its children."""
    if _on or _autograd_profiler._is_profiler_enabled:
        return Span(name, ids)
    return _OFF


def _thread_state() -> list:
    _tls.stack = []
    _tls.done = []
    _tls.tid = threading.get_native_id()
    return _tls.stack


class Span:
    """One span; recorded where it was entered while the recorder was on,
    and a ``record_function`` where it was made while a profiler ran."""

    __slots__ = ("name", "ids", "parent", "tid", "start", "end", "own",
                 "_rf", "_done", "_owner", "_kids")

    def __init__(self, name: str, ids: Dict):
        self.name = name
        self.ids = ids
        self.parent = self._kids = None
        self.start = self.end = self.own = 0
        self._rf = (record_function(name)
                    if _autograd_profiler._is_profiler_enabled else None)

    def __enter__(self):
        global _grad_owner
        if self._rf is not None:
            self._rf.__enter__()
        if _on:
            try:
                stack = _tls.stack
            except AttributeError:
                stack = _thread_state()
            parent = stack[-1] if stack else _grad_owner
            self.parent = parent
            self.tid = _tls.tid
            if parent is None:
                self._done = _tls.done
            else:
                self._done = parent._done
                if not self.ids:
                    self.ids = parent.ids
            if self.name == GRAD_CALLER:
                self._owner = _grad_owner
                _grad_owner = self
            stack.append(self)
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _grad_owner
        if self.start:
            start, end = self.start, time.time_ns()
            self.end = end
            _tls.stack.pop()
            # Every child has closed: on the card the backward's worker
            # thread finishes before torch.autograd.grad returns.
            kids = self._kids
            self.own = end - start - (union_length(kids) if kids else 0)
            self._kids = None
            parent = self.parent
            if self.name == GRAD_CALLER:
                _grad_owner = self._owner
            self._done.append(self)
            _recent.append(self)
            if parent is not None:
                if parent._kids is None:
                    parent._kids = [(start, end)]
                else:
                    parent._kids.append((start, end))
            elif self.name in UNITS:
                _close_unit(self)
            elif len(self._done) > RECENT_SPANS:  # no unit comes
                self._done.clear()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def union_length(intervals) -> int:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is not None and s < end:
            s = end
        if e > s:
            total += e - s
            end = e
    return total


def _close_unit(unit: Span) -> None:
    done = unit._done
    spans = [s for s in done if s.start >= _epoch_ns]
    done.clear()
    if unit.start < _epoch_ns:
        return
    total: Dict[str, int] = {}
    own: Dict[str, int] = {}
    first = unit.start
    for s in spans:
        n = s.name
        total[n] = total.get(n, 0) + s.end - s.start
        own[n] = own.get(n, 0) + s.own
        if s.start < first:
            first = s.start
    rec = {"unit": unit.name, "ids": unit.ids, "start_ns": first,
           "end_ns": unit.end, "total_ns": total, "self_ns": own}
    with _lock:
        _units.append(rec)
        for s in spans:
            t = _totals.get(s.name)
            if t is None:
                t = _totals[s.name] = [0, 0, 0]
            t[0] += 1
        for k, v in total.items():
            _totals[k][1] += v
            _totals[k][2] += own[k]
