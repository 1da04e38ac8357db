"""Batched signature-verification models built on :mod:`consensus_tpu_torch.ops`."""

from consensus_tpu_torch.models.ed25519 import Ed25519BatchVerifier, L
from consensus_tpu_torch.models.verifier import (
    Ed25519Signer,
    Ed25519VerifierMixin,
    commit_message,
    engine_for_config,
    raw_message,
)

__all__ = [
    "Ed25519BatchVerifier",
    "Ed25519Signer",
    "Ed25519VerifierMixin",
    "L",
    "commit_message",
    "engine_for_config",
    "raw_message",
]
