"""Compulsory work of the graph kernels and the card's published peaks.

``work`` and ``bound`` are frozen copies of ``chip_smoke.py:work`` and
``bound`` (the K1 and K2 rows): each input byte read once, each output byte
written once, and the algorithm's float32 operations, from the shapes alone,
whatever a kernel does with them.  The peaks are NVIDIA's data sheet for the
H100 SXM at its full 700 W: a share is stated with the card's power limit
beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
LAE_STEPS = 150                # FISTA steps of one anchor embedding


def work(name: str, n: int, r: int, s: int, d: int) -> dict:
    """Bytes and float32 operations of one call of K1 (``knn``) or K2
    (``lae_weights``) over n points, s anchors, fan-in r, width d."""
    if name == "knn":           # d²: 2d for the dot product, 2 to add the norms
        return dict(bytes=4 * (n * d + s * d) + 8 * n * r, flops=n * s * (2 * d + 2))
    if name == "lae_weights":
        # set-up: G and b (2d−1)(r²+r), the step bound L 2r²+2; one FISTA step:
        # momentum 3r+2, gradient step 2r²+2r, simplex projection (sorting network
        # r(r−1), running sums r−1, ρ 4r, θ 2, clip 2r), next d 6
        step = 3 * r * r + 11 * r + 9
        return dict(bytes=4 * (n * d + s * d) + 8 * n * r,
                    flops=n * ((2 * d - 1) * (r * r + r) + 2 * r * r + 2 + LAE_STEPS * step))
    raise KeyError(name)


def bound(w: dict) -> tuple:
    """(least ms the card could take, which of the two terms sets it)."""
    by_bytes, by_ops = w["bytes"] / HBM_BYTES_PER_S, w["flops"] / F32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"
