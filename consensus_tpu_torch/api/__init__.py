"""Dependency-injection ports: the interfaces an embedding application
implements to wire the consensus core to its transport, storage, crypto, and
ledger.

The PyTorch port's copy of ``consensus_tpu/api/__init__.py``, its imports renamed.
"""

from consensus_tpu_torch.api.deps import (  # noqa: F401
    Application,
    Assembler,
    BatchVerifier,
    Comm,
    MembershipNotifier,
    RequestInspector,
    Signer,
    Synchronizer,
    TracerPort,
    Verifier,
    WriteAheadLog,
)
