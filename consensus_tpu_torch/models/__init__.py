"""Batched signature-verification models (Ed25519 and ECDSA-P256) built on
:mod:`consensus_tpu_torch.ops`."""

from consensus_tpu_torch.models.ecdsa_p256 import EcdsaP256BatchVerifier
from consensus_tpu_torch.models.ed25519 import (
    Ed25519BatchVerifier,
    Ed25519RandomizedBatchVerifier,
    L,
)
from consensus_tpu_torch.models.verifier import (
    EcdsaP256Signer,
    EcdsaP256VerifierMixin,
    Ed25519Signer,
    Ed25519VerifierMixin,
    commit_message,
    engine_for_config,
    raw_message,
)

__all__ = [
    "EcdsaP256BatchVerifier",
    "EcdsaP256Signer",
    "EcdsaP256VerifierMixin",
    "Ed25519BatchVerifier",
    "Ed25519RandomizedBatchVerifier",
    "Ed25519Signer",
    "Ed25519VerifierMixin",
    "L",
    "commit_message",
    "engine_for_config",
    "raw_message",
]
