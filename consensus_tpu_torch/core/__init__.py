"""The consensus protocol state machines (single-threaded, event-driven).

The PyTorch port's copy of ``consensus_tpu/core/__init__.py``, its imports renamed.
"""

from consensus_tpu_torch.core.batcher import Batcher
from consensus_tpu_torch.core.pool import PoolOptions, RequestPool, RequestTimeoutHandler

__all__ = [
    "RequestPool",
    "PoolOptions",
    "RequestTimeoutHandler",
    "Batcher",
]
