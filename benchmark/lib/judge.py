"""The comparison that decides ``correct``: each number the reference reads
against its limit (``benchmark/limits/<cell>.json``)."""

from __future__ import annotations

import math


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, checks): every limited number present, finite and at or
    under its limit; ``checks`` maps each to its value and limit."""
    checks = {name: {"value": readings.get(name, float("nan")), "limit": limit}
              for name, limit in limits.items()}
    ok = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
