"""Deterministic cross-process identity for the deployment rig.

Separate OS processes share no in-process key registry, so every process
derives the SAME keys from the cluster spec's ``key_namespace`` (a random
hex string minted once by the launcher and distributed in the config
file).  Derivation is pure SHA-256 over namespaced tags — restarting a
killed replica re-derives its identity bit-for-bit, which is what lets it
rejoin the cluster after a ``kill -9`` with nothing but its config file
and its WAL directory.

Ed25519 only: the pure-Python RFC 8032 fallback in
``consensus_tpu_torch/models`` keeps the rig dependency-free (the ``cryptography``
package is not required).

The PyTorch port's copy of ``consensus_tpu/deploy/identity.py``, its imports renamed.
"""

from __future__ import annotations

import hashlib


def _seed32(namespace: str, tag: str, i: int) -> bytes:
    return hashlib.sha256(
        b"ctpu-deploy:%s:%s:%d" % (namespace.encode(), tag.encode(), i)
    ).digest()


def make_node_signer(namespace: str, node_id: int):
    from consensus_tpu_torch.models import Ed25519Signer

    return Ed25519Signer(
        node_id, private_key_bytes=_seed32(namespace, "node", node_id)
    )


def make_node_keys(namespace: str, node_ids) -> dict:
    return {
        i: make_node_signer(namespace, i).public_bytes for i in node_ids
    }


def make_client_keyring(namespace: str, n_clients: int):
    from consensus_tpu_torch.models import Ed25519Signer
    from consensus_tpu_torch.testing.crypto_app import ClientKeyring

    return ClientKeyring(
        [
            Ed25519Signer(
                10_000 + i, private_key_bytes=_seed32(namespace, "client", i)
            )
            for i in range(n_clients)
        ]
    )


def make_sig_verifier(namespace: str, node_ids, *, engine):
    """The signature half of the Verifier port (app half lives in
    SignedRequestApp)."""
    from consensus_tpu_torch.models import Ed25519VerifierMixin

    class _SigVerifier(Ed25519VerifierMixin):
        def verify_proposal(self, proposal):
            raise NotImplementedError

        def verify_request(self, raw):
            raise NotImplementedError

        def verification_sequence(self):
            return 0

        def requests_from_proposal(self, proposal):
            return []

    return _SigVerifier(make_node_keys(namespace, node_ids), engine=engine)


__all__ = [
    "make_node_signer",
    "make_node_keys",
    "make_client_keyring",
    "make_sig_verifier",
]
