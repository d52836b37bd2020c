"""Graph-Laplacian normalizations of the cross-similarity matrix Z."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import EPS, LaplacianType
from ..types import EllMatrix


def normalize_graph_laplacian(
    Z: EllMatrix,
    gl: LaplacianType,
    cluster_sizes: Optional[torch.Tensor] = None,
) -> EllMatrix:
    """Apply the requested normalization then row-normalize.

    - rw: row-normalize only
    - normalized: column-normalize, then row-normalize
    - cluster-normalized: column-normalize, scale columns by cluster sizes,
      then row-normalize

    Column sums add in a fixed order (``EllMatrix.colsum_ordered``), so the
    result is the same bits on every run on the card as well.
    """
    gl = LaplacianType(gl)
    if gl == LaplacianType.RW:
        pass
    elif gl == LaplacianType.NORMALIZED:
        Z = Z.scale_cols(1.0 / (Z.colsum_ordered() + EPS))
    elif gl == LaplacianType.CLUSTER_NORMALIZED:
        if cluster_sizes is None:
            raise ValueError("cluster-normalized Laplacian requires cluster sizes")
        Z = Z.scale_cols(1.0 / (Z.colsum_ordered() + EPS))
        Z = Z.scale_cols(cluster_sizes.to(Z.dtype))
    else:
        raise ValueError(f"unsupported graph Laplacian: {gl}")
    return Z.scale_rows(1.0 / (Z.rowsum() + EPS))
