"""Probes around the calls into the port's layers, installed from the benchmark.

The port's drivers look these names up in their modules when they call
them, so rebinding a name there wraps every call of it.  Each file under
``benchmark/spans/`` names one span: the module attributes it wraps.  A
``Capture`` keeps what one chosen fit's graph stage returned, for the
comparison; ``Spans`` times each span (``synced``: host clock between two
``torch.cuda.synchronize()``) or marks it for the profiler (a
``record_function`` range, no sync).  The wrappers return what the wrapped
call returned, untouched.
"""

from __future__ import annotations

import functools
import importlib
import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch

SPANS = Path(__file__).resolve().parent.parent / "spans"


def span_table() -> dict:
    """span name -> list of (module, attribute) it wraps."""
    return {p.stem: [tuple(x) for x in json.loads(p.read_text())["wraps"]]
            for p in sorted(SPANS.glob("*.json"))}


@contextmanager
def _rebound(targets):
    """Rebind each (module, attribute, wrapper-maker); restore on exit."""
    saved = []
    try:
        for mod_name, attr, make in targets:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            saved.append((mod, attr, orig))
            setattr(mod, attr, make(orig))
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


class Capture:
    """Keeps the last result of each wrapped call while ``armed``."""

    WRAPS = {"subsample": ("flgp_tpu_torch.fit.spectral", "subsample"),
             "knn": ("flgp_tpu_torch.fit.spectral", "knn"),
             "lae_weights": ("flgp_tpu_torch.fit.spectral", "lae_weights")}

    def __init__(self):
        self.armed = False
        self.got = {}

    def _make(self, key):
        def make(orig):
            @functools.wraps(orig)
            def wrapper(*args, **kwargs):
                out = orig(*args, **kwargs)
                if self.armed:
                    self.got[key] = out
                return out
            return wrapper
        return make

    def installed(self):
        return _rebound([(m, a, self._make(k)) for k, (m, a) in self.WRAPS.items()])


class Spans:
    """Per-span host seconds of each fit (``synced``), or profiler ranges."""

    def __init__(self, synced: bool, device: torch.device):
        self.synced = synced
        self.device = device
        self.seconds = defaultdict(float)     # span -> seconds within the current fit

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _make(self, name):
        def make(orig):
            @functools.wraps(orig)
            def wrapper(*args, **kwargs):
                if not self.synced:
                    with torch.profiler.record_function(f"span:{name}"):
                        return orig(*args, **kwargs)
                self._sync()
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                self._sync()
                self.seconds[name] += time.perf_counter() - t0
                return out
            return wrapper
        return make

    def installed(self):
        return _rebound([(m, a, self._make(name))
                         for name, wraps in span_table().items() for m, a in wraps])
