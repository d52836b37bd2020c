"""k-means‖ as ``flgp_tpu_torch/ops/kmeans.py:_kmeanspar_rows`` ran it with its
weighted k-means++ loop inline, one Gumbel draw of C a step: the yardstick the
CPU and card tests hold the seeding's plain loop and its kernel to, bit for
bit.  It imports no JAX, so the card tests can import it."""

import torch

from flgp_tpu_torch.ops import kmeans
from flgp_tpu_torch.ops.knn import knn


def weighted_kmeanspp(generator, dcc, w, s):
    """The inline loop's s picks (int64) over the C candidates."""
    C = w.shape[0]
    j = torch.argmax(w).reshape(1)
    mindc = dcc[j][0]
    picks = [j]
    for _ in range(s - 1):
        logits = torch.log(torch.clamp(w * mindc, min=1e-30))
        j = torch.argmax(logits + kmeans._gumbel(generator, C, logits)).reshape(1)
        mindc = torch.minimum(mindc, dcc[j][0])
        picks.append(j)
    return torch.cat(picks)


def kmeanspar_rows(generator, X, s, rounds=4, oversample=2.0, polish_iters=5):
    """The whole seeding: the s centers."""
    n = X.shape[0]
    B = max(-(-int(oversample * s) // rounds), 1)
    C = 1 + rounds * B
    c0 = X[torch.randint(0, n, (1,), generator=generator, device=X.device)]
    mind = torch.sum((X - c0) ** 2, dim=1)
    cands = [c0]
    for _ in range(rounds):
        logits = torch.log(torch.clamp(mind, min=1e-30))
        cr = X[torch.topk(logits + kmeans._gumbel(generator, n, logits), B).indices].contiguous()
        mind = torch.minimum(mind, knn(X, cr, 1).sqdists[:, 0])
        cands.append(cr)
    cands = torch.cat(cands, dim=0)
    w = kmeans._counts(knn(X, cands, 1).indices[:, 0].long(), C, X.dtype)
    dcc = torch.clamp(kmeans.sqdist(cands, cands), min=0.0)
    centers = cands[weighted_kmeanspp(generator, dcc, w, s)]
    for _ in range(polish_iters):
        a = torch.argmin(kmeans.sqdist(cands, centers), dim=1)
        sums = kmeans._segment_sums(torch.cat([w[:, None], w[:, None] * cands], dim=1), a,
                                    s).to(X.dtype)
        cw, csum = sums[:, 0], sums[:, 1:]
        centers = torch.where(cw[:, None] > 0, csum / torch.clamp(cw, min=1.0)[:, None], centers)
    return centers
