"""Crypto test application pieces (torch port of ``SigOnlyVerifier`` from
``consensus_tpu/testing/crypto_app.py``).  ``CryptoApp`` and
``SignedRequestApp`` need the protocol core and come with it."""

from __future__ import annotations

from consensus_tpu_torch.models.verifier import Ed25519VerifierMixin


class SigOnlyVerifier(Ed25519VerifierMixin):
    """Signature-only half of the Verifier port: the application half
    (proposal/request semantics) lives in the app that wraps this."""

    def verify_proposal(self, proposal):
        raise NotImplementedError  # app half lives in the wrapping app

    def verify_request(self, raw):
        raise NotImplementedError

    def verification_sequence(self):
        return 0

    def requests_from_proposal(self, proposal):
        return []


__all__ = ["SigOnlyVerifier"]
