"""Wire-native state transfer: verified, chunked catch-up behind the
Synchronizer port.

* :mod:`consensus_tpu_torch.sync.store` — position-addressed decision storage.
* :mod:`consensus_tpu_torch.sync.server` — serves ranged chunks with size caps.
* :mod:`consensus_tpu_torch.sync.transport` — blocking fetch channels (sim + TCP).
* :mod:`consensus_tpu_torch.sync.client` — the verifying Synchronizer.

The PyTorch port's copy of ``consensus_tpu/sync/__init__.py``, its imports renamed.
"""

from consensus_tpu_torch.sync.client import (
    LedgerSynchronizer,
    honest_endorsement_threshold,
)
from consensus_tpu_torch.sync.server import SyncServer
from consensus_tpu_torch.sync.store import DecisionStore, LedgerDecisionStore
from consensus_tpu_torch.sync.transport import (
    InProcessSyncTransport,
    SyncListener,
    SyncTransport,
    TcpSyncTransport,
)

__all__ = [
    "DecisionStore",
    "LedgerDecisionStore",
    "SyncServer",
    "SyncTransport",
    "InProcessSyncTransport",
    "SyncListener",
    "TcpSyncTransport",
    "LedgerSynchronizer",
    "honest_endorsement_threshold",
]
