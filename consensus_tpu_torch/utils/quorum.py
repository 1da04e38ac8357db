"""BFT quorum arithmetic.

Parity: reference internal/bft/util.go:166-187 (computeQuorum).

The PyTorch port's copy of ``consensus_tpu/utils/quorum.py``, its imports renamed.
"""

from __future__ import annotations

import math


def compute_quorum(n: int) -> tuple[int, int]:
    """Return ``(q, f)`` for a cluster of ``n`` replicas.

    ``f`` is the maximum number of Byzantine faults tolerated
    (``f = argmax(n >= 3f+1)``), and ``q`` is the smallest quorum size such
    that any two quorums intersect in at least ``f + 1`` replicas:
    ``q = ceil((n + f + 1) / 2)``.
    """
    if n <= 0:
        raise ValueError("cluster size must be positive")
    f = (n - 1) // 3
    q = int(math.ceil((n + f + 1) / 2.0))
    return q, f


__all__ = ["compute_quorum"]
