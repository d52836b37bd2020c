"""Structured per-stage metrics, and the recorder of spans and counters.

Every pipeline stage can record its wall-clock, sizes and solver residuals
into a structured report (``flgp_tpu.utils.metrics``), and a
``torch.profiler`` trace can wrap any scope.  PyTorch queues work on the card
asynchronously, so a stage synchronizes the devices of what it names in its
``_sync`` slot before its clock stops.

The recorder.  The fit path marks its layers with :func:`span` and its
rounds with :func:`count`.  ``host_syncs`` counts every call of the fit path
that makes the host wait for the card: each read through :func:`to_host`,
each upload through :func:`to_device`, and the library calls that read on
the host on a card (``torch.bincount`` sizing its output, ``eigh`` checking
its status), counted where they are made.  Counters always
add to :data:`COUNTS`, the one store of running totals (the kernels'
``hopper_kernels.LAUNCHES`` and ``nuts.STATS`` are views of it), and
:data:`FIT_COUNTS` keeps each of the last fits' own share of them.  Spans cost
one flag read until :func:`recording` turns the recorder on: then each span
appends ``(fit, id, parent, name, t0, t1)`` (``time.perf_counter_ns``) to the
record, each count is also attributed to the current fit and innermost open
span, and while a ``torch.profiler`` runs each span is also the profiler
range ``flgp:<name>``, on the trace's clock beside the device activities.  No
span synchronizes the device or allocates on it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import Counter, deque
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, NamedTuple, Optional

import torch


@dataclass
class StageMetrics:
    name: str
    wall_s: float
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MetricsReport:
    stages: list = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, **extra) -> Iterator[Dict[str, Any]]:
        """Time a stage; the yielded dict collects extra metrics.  A tensor
        put in its ``_sync`` slot is waited for before the clock stops, so
        the wall covers the work queued for it.  While recording, the stage
        is also the span ``report:<name>``."""
        slot: Dict[str, Any] = dict(extra)
        t0 = time.perf_counter_ns()
        with span("report:" + name):
            try:
                yield slot
            finally:
                t = slot.pop("_sync", None)
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    torch.cuda.synchronize(t.device)
                self.stages.append(StageMetrics(name, (time.perf_counter_ns() - t0) * 1e-9,
                                                slot))

    def to_json(self) -> str:
        return json.dumps([{"stage": s.name, "wall_s": round(s.wall_s, 6), **s.extra}
                           for s in self.stages])

    def total(self) -> float:
        return sum(s.wall_s for s in self.stages)


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]) -> Iterator[None]:
    """Wrap a scope in a ``torch.profiler`` trace (CPU, and CUDA where there
    is a card) written as a Chrome trace into ``logdir``; a no-op for None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

# running totals of every counter since the process started
COUNTS: Counter = Counter()

# each of the last fits' own counts, oldest first: what COUNTS gained during
# one outermost call of a public fit driver, failed calls too
FIT_COUNTS: deque = deque(maxlen=1024)
_FIT_DEPTH = 0


class Span(NamedTuple):
    fit: Optional[int]      # the fit it lies in (None outside every fit)
    id: int
    parent: Optional[int]   # the span it lies in (None for a fit's root)
    name: str
    t0: int                 # time.perf_counter_ns() at the start
    t1: int                 # ... and at the end


@dataclass
class Record:
    """What :func:`recording` saw: the closed spans, in the order they closed,
    and the counts attributed to each (fit, innermost span) pair."""

    spans: list = field(default_factory=list)
    counts: Dict[tuple, Counter] = field(default_factory=dict)
    n_fits: int = 0
    n_spans: int = 0

    def fits(self) -> list:
        """The ids of the fits recorded, in order."""
        return sorted({s.fit for s in self.spans if s.fit is not None})

    def fit_counts(self, fit: Optional[int]) -> Counter:
        """Every counter's total over the spans of ``fit``."""
        out: Counter = Counter()
        for (f, _), c in self.counts.items():
            if f == fit:
                out.update(c)
        return out

    def seconds(self, name: str, fit: Optional[int] = None) -> float:
        """Seconds inside the spans called ``name`` (of ``fit``, if given)."""
        return sum(s.t1 - s.t0 for s in self.spans
                   if s.name == name and (fit is None or s.fit == fit)) * 1e-9


_ON = False                         # the recorder's one switch: see recording()
_RECORD: Optional[Record] = None
_OPEN: list = []                    # the open spans, innermost last


class _Off:
    """The shared context of a span while the recorder is off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "record", "fit", "id", "parent", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = self.record = _RECORD
        top = _OPEN[-1] if _OPEN else None
        self.fit = top.fit if top is not None else None
        if self.fit is None and self.name == "fit":
            rec.n_fits += 1
            self.fit = rec.n_fits
        self.parent = top.id if top is not None else None
        rec.n_spans += 1
        self.id = rec.n_spans
        _OPEN.append(self)
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function("flgp:" + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self in _OPEN:           # recording() may have ended inside the span
            _OPEN.remove(self)
        self.record.spans.append(Span(self.fit, self.id, self.parent, self.name, self.t0, t1))
        return False


def span(name: str):
    """A context manager marking one layer of the fit path.  Off (the
    default) it is a shared no-op; while recording see the module's
    docstring.  A span named ``fit`` opened outside every fit starts a new
    fit of the record."""
    if not _ON:
        return _OFF
    return _On(name)


def spanned(name: str):
    """Decorate a function to run in the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def fit_entry(fn):
    """Decorate a public fit driver: each call counts one ``fits`` and runs
    in a ``fit`` span; an outermost call appends its own counts to
    :data:`FIT_COUNTS` when it returns or raises."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        global _FIT_DEPTH
        before = COUNTS.copy() if _FIT_DEPTH == 0 else None
        _FIT_DEPTH += 1
        try:
            count("fits")
            with span("fit"):
                return fn(*args, **kwargs)
        finally:
            _FIT_DEPTH -= 1
            if before is not None:
                FIT_COUNTS.append(COUNTS - before)

    return entry


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name``; while recording, also to the
    current fit's innermost open span."""
    COUNTS[name] += k
    if _ON:
        top = _OPEN[-1] if _OPEN else None
        key = (top.fit, top.id) if top is not None else (None, None)
        _RECORD.counts.setdefault(key, Counter())[name] += k


def to_host(x: torch.Tensor, array: bool = False):
    """The one blocking device-to-host read of the fit path: counts
    ``host_syncs`` and returns x's value, a Python number for a 0-dim tensor
    (as ``bool``/``int``/``float`` of it would read it) or a numpy array (any
    other tensor, or ``array=True``)."""
    count("host_syncs")
    if array or x.dim() > 0:
        return x.detach().cpu().numpy()
    return x.item()


def to_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, the one upload of
    host values on the fit path.  A copy from the host onto the card returns
    once it has landed, which drains the launch queue as a read does: it
    counts one ``host_syncs`` (none where x is already on the card or the
    device is the CPU)."""
    out = torch.as_tensor(x, dtype=dtype, device=device)
    if out.is_cuda and not (isinstance(x, torch.Tensor) and x.is_cuda):
        count("host_syncs")
    return out


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Turn the recorder on for the scope and yield its record."""
    global _ON, _RECORD
    if _ON:
        raise RuntimeError("the recorder is already on")
    _RECORD, _ON = Record(), True
    try:
        yield _RECORD
    finally:
        _ON = False
        _OPEN.clear()


class CounterView(Mapping):
    """The counters ``prefix + key`` of :data:`COUNTS` for the fixed ``keys``,
    read under their short names (0 until counted)."""

    def __init__(self, prefix: str, keys):
        self._prefix = prefix
        self._keys = tuple(keys)

    def __getitem__(self, key: str) -> int:
        if key not in self._keys:
            raise KeyError(key)
        return COUNTS[self._prefix + key]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return repr(dict(self))

    def reset(self) -> None:
        """Zero the viewed counters (the store's other counters run on)."""
        for key in self._keys:
            COUNTS.pop(self._prefix + key, None)
