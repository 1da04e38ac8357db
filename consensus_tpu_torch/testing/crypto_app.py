"""Test/bench application with REAL crypto on every signature path.

Two layers over :class:`consensus_tpu_torch.testing.app.TestApp` (whose crypto is
trivial byte-compares):

* :class:`CryptoApp` — replica identity: proposals and consensus messages
  are signed by a per-replica key and verified through a batch-verify
  engine (the device seam).  The verifier half is injected so Ed25519 and
  ECDSA-P256 share one app class.
* :class:`SignedRequestApp` — additionally, CLIENT requests carry a
  signature; followers batch-verify every request in a proposal in ONE
  engine call (``verify_proposal``).  This is the integrated equivalent of
  the reference's per-request VerifyRequest loop inside proposal
  verification (reference internal/bft/view.go:602-647 verifies requests
  and prev-commit signatures sequentially per proposal).

Request wire format (SignedRequestApp):
``client_idx(4) || seq(8) || body || signature(64)`` — signed over
everything before the signature with the client's key.

The PyTorch port's copy of ``consensus_tpu/testing/crypto_app.py``.  The
verifier half is the port's mixin (``models/verifier.py``), whose engine
runs on ``cuda`` unless it was built with ``device="cpu"``.
"""

from __future__ import annotations

import struct
from typing import Mapping, Optional, Sequence

from consensus_tpu_torch.models.verifier import Ed25519VerifierMixin
from consensus_tpu_torch.testing.app import TestApp, pack_batch, unpack_batch
from consensus_tpu_torch.types import QuorumCert, RequestInfo

_REQ_TAG = b"ctpu/request"


class SigOnlyVerifier(Ed25519VerifierMixin):
    """Signature-only half of the Verifier port: the application half
    (proposal/request semantics) lives in the app that wraps this —
    CryptoApp delegates only the four signature paths here."""

    def verify_proposal(self, proposal):
        raise NotImplementedError  # app half lives in CryptoApp

    def verify_request(self, raw):
        raise NotImplementedError

    def verification_sequence(self):
        return 0

    def requests_from_proposal(self, proposal):
        return []


class CryptoApp(TestApp):
    """TestApp with the trivial crypto swapped for a real signer/verifier."""

    def __init__(self, node_id, cluster, signer, verifier):
        super().__init__(node_id, cluster)
        self._signer = signer
        self._verifier = verifier
        # With a randomized batch engine behind the verifier, the Verifier
        # base class coalesces multi-batch calls through this delegate in
        # ONE launch (api/deps.py); strict engines keep the per-group loop
        # bit-for-bit.
        self.multi_batch_delegate = verifier
        self.batch_verify_enabled = getattr(verifier, "batch_verify_enabled", False)

    # Signer
    def sign(self, data):
        return self._signer.sign(data)

    def sign_proposal(self, proposal, aux=b""):
        return self._signer.sign_proposal(proposal, aux)

    # Verifier signature paths
    def verify_consenter_sig(self, signature, proposal):
        return self._verifier.verify_consenter_sig(signature, proposal)

    def verify_consenter_sigs_batch(self, signatures, proposal):
        return self._verifier.verify_consenter_sigs_batch(signatures, proposal)

    def verify_signature(self, signature):
        return self._verifier.verify_signature(signature)

    def auxiliary_data(self, msg):
        return self._verifier.auxiliary_data(msg)

    # Half-aggregated quorum certs: delegate straight to the crypto half.
    @property
    def supports_cert_aggregation(self):
        return getattr(self._verifier, "supports_cert_aggregation", False)

    def aggregate_cert(self, proposal, signatures):
        agg = getattr(self._verifier, "aggregate_cert", None)
        return agg(proposal, signatures) if agg is not None else None

    def verify_aggregate_cert(self, cert, proposal):
        vac = getattr(self._verifier, "verify_aggregate_cert", None)
        return vac(cert, proposal) if vac is not None else None


class ClientKeyring:
    """A set of client signing keys + the matching verification registry."""

    def __init__(self, signers: Sequence) -> None:
        self.signers = list(signers)
        self.public_keys = [s.public_bytes for s in self.signers]

    def make_request(self, client_idx: int, seq: int, body: bytes = b"x" * 64) -> bytes:
        head = struct.pack(">IQ", client_idx, seq) + body
        return head + self.signers[client_idx].sign_raw(_REQ_TAG + head)


class SignedRequestApp(CryptoApp):
    """CryptoApp whose client requests carry signatures, batch-verified per
    proposal through the engine — the device hot path."""

    def __init__(self, node_id, cluster, signer, verifier, *,
                 client_keys: Sequence[bytes], engine, sig_len: int = 64):
        super().__init__(node_id, cluster, signer, verifier)
        self._client_keys = list(client_keys)
        self._engine = engine
        self._sig_len = sig_len

    def _split(self, raw: bytes) -> tuple[int, int, bytes, bytes]:
        if len(raw) < 12 + self._sig_len:
            raise ValueError("request too short")
        client_idx, seq = struct.unpack(">IQ", raw[:12])
        if client_idx >= len(self._client_keys):
            raise ValueError(f"unknown client {client_idx}")
        return client_idx, seq, raw[: -self._sig_len], raw[-self._sig_len :]

    def _request_info(self, raw: bytes) -> RequestInfo:
        client_idx, seq, _, _ = self._split(raw)
        return RequestInfo(client_id=str(client_idx), request_id=str(seq))

    # RequestInspector-ish surface (pool ingress id computation). The pool
    # uses an inspector object; TestApp exposes self.inspector — override
    # with ourselves.
    def request_id(self, raw: bytes) -> RequestInfo:
        return self._request_info(raw)

    @property
    def inspector(self):
        return self

    @inspector.setter
    def inspector(self, value):  # TestApp.__init__ assigns; ignore
        pass

    def verify_request(self, raw: bytes) -> RequestInfo:
        client_idx, seq, signed, sig = self._split(raw)
        ok = self._engine.verify_batch(
            [_REQ_TAG + signed], [sig], [self._client_keys[client_idx]]
        )
        if not ok[0]:
            raise ValueError("bad request signature")
        return RequestInfo(client_id=str(client_idx), request_id=str(seq))

    def _collect(self, raws, *, tolerate_parse_errors: bool):
        """(messages, sigs, keys, infos, parsed) for a list of raw requests;
        ``parsed[i]`` is the batch index of ``raws[i]`` or None if it failed
        to parse (only when tolerated)."""
        messages, sigs, keys, infos = [], [], [], []
        parsed = []
        for raw in raws:
            try:
                client_idx, seq, signed, sig = self._split(raw)
            except ValueError:
                if not tolerate_parse_errors:
                    raise
                parsed.append(None)
                continue
            parsed.append(len(messages))
            messages.append(_REQ_TAG + signed)
            sigs.append(sig)
            keys.append(self._client_keys[client_idx])
            infos.append(RequestInfo(client_id=str(client_idx), request_id=str(seq)))
        return messages, sigs, keys, infos, parsed

    def verify_requests_batch(self, raw_requests) -> "list":
        """ONE engine call for a list of raw requests (the pool's
        re-validation burst path — controller.maybe_prune_revoked_requests)."""
        messages, sigs, keys, infos, parsed = self._collect(
            raw_requests, tolerate_parse_errors=True
        )
        if not messages:
            return [None] * len(raw_requests)
        ok = self._engine.verify_batch(messages, sigs, keys)
        return [
            infos[j] if (j is not None and ok[j]) else None for j in parsed
        ]

    def verify_proposal(self, proposal) -> Sequence[RequestInfo]:
        """Batch-verify EVERY request signature in the proposal in one
        engine call (vs the reference's sequential per-request loop)."""
        messages, sigs, keys, infos, _ = self._collect(
            unpack_batch(proposal.payload), tolerate_parse_errors=False
        )
        if messages:
            ok = self._engine.verify_batch(messages, sigs, keys)
            if not ok.all():
                raise ValueError("proposal carries an invalid request signature")
        return infos

    def verify_proposal_and_prev_commits(self, proposal, prev_commits, prev_proposal):
        """Fuse the proposal's request-signature wave and the previous
        decision's commit cert into ONE engine launch (ROADMAP item 3a tail:
        request waves coalesce like consenter certs).  Only when both waves
        run on the SAME engine — mixing engines inside one wave would break
        the SAFETY.md §7 no-mixed-engine rule — and errors keep the split
        path's order: request failures raise before any cert verdict is
        consumed."""
        if getattr(self._verifier, "engine", None) is not self._engine:
            return super().verify_proposal_and_prev_commits(
                proposal, prev_commits, prev_proposal
            )
        if isinstance(prev_commits, QuorumCert):
            # A half-aggregated cert verifies through its own MSM launch —
            # it has no per-signature triples to splice into the request
            # wave; the split path routes it via verify_aggregate_cert.
            return super().verify_proposal_and_prev_commits(
                proposal, prev_commits, prev_proposal
            )
        messages, sigs, keys, infos, _ = self._collect(
            unpack_batch(proposal.payload), tolerate_parse_errors=False
        )
        n_req = len(messages)
        c_msgs, c_sigs, c_keys, known = self._verifier.consenter_sig_triples(
            prev_commits, prev_proposal
        )
        messages += c_msgs
        sigs += c_sigs
        keys += c_keys
        if not messages:
            return infos, []
        ok = self._engine.verify_batch(messages, sigs, keys)
        if n_req and not ok[:n_req].all():
            raise ValueError("proposal carries an invalid request signature")
        cert_results = [
            prev_commits[i].msg if (known[i] and ok[n_req + i]) else None
            for i in range(len(prev_commits))
        ]
        return infos, cert_results


__all__ = ["CryptoApp", "SigOnlyVerifier", "SignedRequestApp", "ClientKeyring"]
