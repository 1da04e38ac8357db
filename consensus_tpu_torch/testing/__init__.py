"""In-process simulated network + all-ports test application.

Parity: reference test/ (network.go, test_app.go).  The port's copy of
``consensus_tpu/testing/__init__.py`` exports what the JAX package's does,
and ``SigOnlyVerifier`` besides.
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
from consensus_tpu_torch.testing.chaos import (
    ChaosAction,
    ChaosEngine,
    ChaosResult,
    ChaosSchedule,
    format_repro,
    shrink,
)
from consensus_tpu_torch.testing.crypto_app import (
    ClientKeyring,
    CryptoApp,
    SigOnlyVerifier,
    SignedRequestApp,
)
from consensus_tpu_torch.testing.faults import (
    CRASH_POINTS,
    FaultPlan,
    InjectedIOError,
    SimulatedCrash,
    registered_crash_points,
)
from consensus_tpu_torch.testing.invariants import (
    InvariantMonitor,
    InvariantViolation,
    Violation,
    is_known_unresolvable_split,
)
from consensus_tpu_torch.testing.membership import (
    boot_node,
    install_reconfig_hook,
    reconfig_request,
)
from consensus_tpu_torch.testing.network import INJECTED_EVENT_KINDS, NodeComm, SimNetwork
from consensus_tpu_torch.testing.storage import (
    STORAGE_FAULT_CLASSES,
    FaultyDecisionStore,
    StorageFaultInjector,
)

__all__ = [
    "ChaosAction",
    "ChaosEngine",
    "ChaosResult",
    "ChaosSchedule",
    "format_repro",
    "shrink",
    "InvariantMonitor",
    "InvariantViolation",
    "Violation",
    "is_known_unresolvable_split",
    "INJECTED_EVENT_KINDS",
    "CRASH_POINTS",
    "FaultPlan",
    "InjectedIOError",
    "SimulatedCrash",
    "registered_crash_points",
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
    "boot_node",
    "install_reconfig_hook",
    "reconfig_request",
    "STORAGE_FAULT_CLASSES",
    "FaultyDecisionStore",
    "StorageFaultInjector",
]
