"""In-process simulated network + all-ports test application.

Parity: reference test/ (network.go, test_app.go).  The port's copy of
``consensus_tpu/testing/__init__.py`` exports what the port has: the
cluster, its apps and the simulated network.  The chaos engine, fault
plans, invariant monitor, storage faults, adversary, fuzzer and membership
harness are ROADMAP.md queue A item 7b.
"""

from consensus_tpu_torch.testing.app import (
    ByteInspector,
    Cluster,
    DeferredMemWAL,
    MemWAL,
    Node,
    TestApp,
    make_request,
    pack_batch,
    unpack_batch,
)
from consensus_tpu_torch.testing.crypto_app import (
    ClientKeyring,
    CryptoApp,
    SigOnlyVerifier,
    SignedRequestApp,
)
from consensus_tpu_torch.testing.network import INJECTED_EVENT_KINDS, NodeComm, SimNetwork

__all__ = [
    "INJECTED_EVENT_KINDS",
    "ClientKeyring",
    "CryptoApp",
    "SigOnlyVerifier",
    "SignedRequestApp",
    "Cluster",
    "Node",
    "TestApp",
    "ByteInspector",
    "DeferredMemWAL",
    "MemWAL",
    "make_request",
    "pack_batch",
    "unpack_batch",
    "SimNetwork",
    "NodeComm",
]
