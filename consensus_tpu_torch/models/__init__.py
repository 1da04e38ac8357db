"""Batched signature-verification models (Ed25519 and ECDSA-P256) built on
:mod:`consensus_tpu_torch.ops`, the fused Ed25519 engines and the
half-aggregator of quorum certs, and the engine layer above them: the
coalescers, the supervisor and the registry."""

from consensus_tpu_torch.models.aggregate import HalfAggregator

from consensus_tpu_torch.models.ecdsa_p256 import EcdsaP256BatchVerifier
from consensus_tpu_torch.models.ed25519 import (
    Ed25519BatchVerifier,
    Ed25519RandomizedBatchVerifier,
    L,
)
from consensus_tpu_torch.models.fused import (
    FusedEd25519BatchVerifier,
    FusedEd25519RandomizedBatchVerifier,
)
from consensus_tpu_torch.models.engine import BatchCoalescer, ThreadCoalescingVerifier
from consensus_tpu_torch.models.supervisor import (
    ENGINE_HEALTH,
    FAULT_CLASSES,
    CircuitBreaker,
    EngineHealth,
    EngineHealthRegistry,
    EngineSupervisor,
    HostTwin,
    LaunchTimeout,
)
from consensus_tpu_torch.models.verifier import (
    EcdsaP256Signer,
    EcdsaP256VerifierMixin,
    Ed25519Signer,
    Ed25519VerifierMixin,
    commit_message,
    degrade_ladder_configs,
    engine_for_config,
    raw_message,
)

__all__ = [
    "EcdsaP256BatchVerifier",
    "EcdsaP256Signer",
    "EcdsaP256VerifierMixin",
    "Ed25519BatchVerifier",
    "Ed25519RandomizedBatchVerifier",
    "FusedEd25519BatchVerifier",
    "FusedEd25519RandomizedBatchVerifier",
    "HalfAggregator",
    "L",
    "BatchCoalescer",
    "ThreadCoalescingVerifier",
    "CircuitBreaker",
    "ENGINE_HEALTH",
    "EngineHealth",
    "EngineHealthRegistry",
    "EngineSupervisor",
    "FAULT_CLASSES",
    "HostTwin",
    "LaunchTimeout",
    "Ed25519Signer",
    "Ed25519VerifierMixin",
    "commit_message",
    "degrade_ladder_configs",
    "engine_for_config",
    "raw_message",
]
