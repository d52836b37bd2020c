"""Faults planted under the timed path, to show that the comparison sees them.

Each replaces one function of the port for the duration of a ``with``:
- ``state_unchanged``: Lloyd's update returns the centers it was given;
- ``half_the_batch``: each cluster's sum runs over half of its points and is
  doubled, so every center is the mean of half of its cluster;
- ``answer_altered``: the first test point's label, as the driver hands it
  to the result, is another class;
- ``mean_altered``: the first test point's posterior mean, as the driver
  hands it to the result, has the other sign;
- ``t_altered``: every t the training returns is ten times what it found;
- ``t_shrunk``: every t the training returns is a tenth of what it found;
- ``t_lower_bound``: every t the training returns is the bottom of its
  search window, ``t_lb``, where a search that never moved would stop.
The cells run on one card, so the fault of an exchange between chips left
out has nothing to break.
"""

from __future__ import annotations

import importlib
from contextlib import contextmanager

import torch


def _unchanged(orig):
    def update(X, assign, s, old):
        counts = torch.zeros((s,), dtype=X.dtype, device=X.device).index_add_(
            0, assign, torch.ones(assign.shape, dtype=X.dtype, device=X.device))
        return old, counts
    return update


def _half(orig):
    def sums(values, assign, s):
        keep = torch.arange(values.shape[0], device=values.device) % 2 == 0
        out = torch.zeros((s, values.shape[1]), dtype=torch.float64, device=values.device)
        return 2.0 * out.index_add_(0, assign[keep], values[keep].to(torch.float64))
    return sums


def _altered(orig):
    def to_result(out, *args, **kwargs):
        y = out["test"].clone()
        y[0] = (y[0] + 1) % max(int(out["mean"].shape[-1]) if out["mean"].dim() > 1 else 2, 2)
        return orig(dict(out, test=y), *args, **kwargs)
    return to_result


def _mean_negated(orig):
    def to_result(out, *args, **kwargs):
        mean = out["mean"].clone()
        mean[0] = -mean[0]
        return orig(dict(out, mean=mean), *args, **kwargs)
    return to_result


def _t_scaled(factor):
    def make(orig):
        def train(*args, **kwargs):
            res = orig(*args, **kwargs)
            return res._replace(x=factor * res.x)
        return train
    return make


def _t_lower_bound(orig):
    def train(*args, **kwargs):
        res = orig(*args, **kwargs)
        cfg = kwargs.get("cfg", args[-1])
        return res._replace(x=torch.full_like(res.x, cfg.train.t_lb))
    return train


FAULTS = {
    "state_unchanged": (("flgp_tpu_torch.ops.kmeans",), "_update", _unchanged),
    "half_the_batch": (("flgp_tpu_torch.ops.kmeans",), "_segment_sums", _half),
    "answer_altered": (("flgp_tpu_torch.fit.drivers", "flgp_tpu_torch.fit.multiclass"), "_to_result",
                       _altered),
    "mean_altered": (("flgp_tpu_torch.fit.drivers", "flgp_tpu_torch.fit.multiclass"), "_to_result",
                     _mean_negated),
    "t_altered": (("flgp_tpu_torch.fit.drivers", "flgp_tpu_torch.fit.multiclass"), "_train_gpc",
                  _t_scaled(10.0)),
    "t_shrunk": (("flgp_tpu_torch.fit.drivers", "flgp_tpu_torch.fit.multiclass"), "_train_gpc",
                 _t_scaled(0.1)),
    "t_lower_bound": (("flgp_tpu_torch.fit.drivers", "flgp_tpu_torch.fit.multiclass"),
                      "_train_gpc", _t_lower_bound),
}


@contextmanager
def planted(name: str):
    mod_names, attr, make = FAULTS[name]
    mods = [importlib.import_module(m) for m in mod_names]
    saved = [getattr(m, attr) for m in mods]
    for mod, orig in zip(mods, saved):
        setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        for mod, orig in zip(mods, saved):
            setattr(mod, attr, orig)
