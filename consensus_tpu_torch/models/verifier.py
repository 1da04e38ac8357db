"""Ed25519 and ECDSA-P256 implementations of the signature ports (torch
port of the strict half of ``consensus_tpu/models/verifier.py``).

* :class:`Ed25519Signer` holds this replica's private key on the host and
  signs raw payloads and proposals with the RFC 8032 reference;
  :class:`EcdsaP256Signer` does the same with the RFC 6979 P-256 reference.
* :class:`Ed25519VerifierMixin` implements the signature-verification
  methods of the ``Verifier`` port against a node-id -> public-key
  registry, draining ``verify_consenter_sigs_batch`` -- and all the groups
  of ``verify_consenter_sigs_multi_batch`` -- into one engine call;
  :class:`EcdsaP256VerifierMixin` is the same over the P-256 engine.

Message binding is byte-identical to the JAX package: a consenter
signature covers ``b"ctpu/commit" + proposal-digest + len(aux) + aux`` and a
raw signature ``b"ctpu/raw" + data``, so a cluster that mixes replicas of
both packages verifies every vote the same way.

:func:`engine_for_config` returns the strict single-device engine of the
curve for the default configuration and the randomized Ed25519 engine for
``batch_verify_mode``; every other lane raises ``NotImplementedError``
naming its ROADMAP item (queue A), except the Ed25519-only features on
P-256, which raise ``ValueError`` with the JAX registry's reasons.
"""

from __future__ import annotations

import os
import struct
from typing import Mapping, Optional, Sequence

from consensus_tpu_torch.api.deps import Signer, Verifier
from consensus_tpu_torch.device import DeviceLike
from consensus_tpu_torch.models.ecdsa_p256 import (
    N as P256_N,
    EcdsaP256BatchVerifier,
    ref_p256_public_key,
    ref_p256_sign,
)
from consensus_tpu_torch.models.ed25519 import (
    Ed25519BatchVerifier,
    Ed25519RandomizedBatchVerifier,
    ref_public_key,
    ref_sign,
)
from consensus_tpu_torch.types import Proposal, QuorumCert, Signature

_COMMIT_TAG = b"ctpu/commit"
_RAW_TAG = b"ctpu/raw"


def commit_message(proposal: Proposal, aux: bytes) -> bytes:
    digest = bytes.fromhex(proposal.digest())
    return _COMMIT_TAG + digest + struct.pack(">I", len(aux)) + aux


def raw_message(data: bytes) -> bytes:
    return _RAW_TAG + data


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"consensus_tpu_torch: {what} is not ported yet (ROADMAP.md queue A, {item})"
    )


def engine_for_config(config, curve: str = "ed25519", *, device: DeviceLike = None):
    """The batch engine matching a ``Configuration``'s crypto knobs.

    The default configuration maps to the strict single-device engine of
    ``curve`` -- :class:`Ed25519BatchVerifier` or
    :class:`EcdsaP256BatchVerifier` -- and ``batch_verify_mode`` to
    :class:`Ed25519RandomizedBatchVerifier`, with the config's padding and
    host-path threshold, on ``device`` (``cuda`` unless the caller names
    one)."""
    if curve not in ("ed25519", "p256"):
        raise ValueError(f"unknown curve {curve!r}")
    if curve == "p256":
        # The JAX registry's own reasons: these lanes do not exist for P-256.
        if config.batch_verify_mode:
            raise ValueError("batch_verify_mode is Ed25519-only (no randomized P-256 lane)")
        if config.device_prep:
            raise ValueError("device_prep is Ed25519-only (no fused P-256 front-end)")
    if config.device_prep:
        raise _not_ported("device_prep", "item 10: fused device prep")
    if config.mesh_shards > 1 or config.mesh_topology:
        raise _not_ported("mesh_shards > 1 / mesh_topology", "item 12: multi-GPU")
    if config.engine_supervision:
        raise _not_ported("engine_supervision", "item 6: registry and supervisor")
    if curve == "p256":
        engine = EcdsaP256BatchVerifier
    elif config.batch_verify_mode:
        engine = Ed25519RandomizedBatchVerifier
    else:
        engine = Ed25519BatchVerifier
    return engine(
        pad_pow2=config.crypto_pad_pow2,
        min_device_batch=config.crypto_tpu_min_batch,
        device=device,
    )


class Ed25519Signer(Signer):
    """This replica's signing identity (private key stays host-side),
    signing with the RFC 8032 reference of :mod:`.ed25519`."""

    def __init__(self, node_id: int, private_key_bytes: Optional[bytes] = None) -> None:
        self.node_id = node_id
        seed = private_key_bytes if private_key_bytes is not None else os.urandom(32)
        self.public_bytes = ref_public_key(seed)
        self._seed = seed

    def sign_raw(self, data: bytes) -> bytes:
        """Sign ``data`` exactly as given (no domain tag) -- for embedders
        that bring their own message framing (e.g. client requests)."""
        return ref_sign(self._seed, data)

    def sign(self, data: bytes) -> bytes:
        return self.sign_raw(raw_message(data))

    def sign_proposal(self, proposal: Proposal, aux: bytes = b"") -> Signature:
        return Signature(
            id=self.node_id,
            value=self.sign_raw(commit_message(proposal, aux)),
            msg=aux,
        )


class Ed25519VerifierMixin(Verifier):
    """Signature-verification half of the ``Verifier`` port, batched onto
    the device.  Subclasses provide the application half (proposal and
    request checks)."""

    def __init__(
        self,
        public_keys: Mapping[int, bytes],
        *,
        engine: Optional[Ed25519BatchVerifier] = None,
        batch_verify_mode: bool = False,
    ) -> None:
        """``batch_verify_mode`` selects the randomized engine as the
        default; an explicit ``engine`` wins, but a non-randomized engine
        together with the flag is a contradiction and raises."""
        self._public_keys = dict(public_keys)
        if engine is None:
            engine = (
                Ed25519RandomizedBatchVerifier()
                if batch_verify_mode
                else Ed25519BatchVerifier()
            )
        elif batch_verify_mode and not getattr(engine, "randomized", False):
            raise ValueError(
                "batch_verify_mode=True requires a randomized engine "
                f"(got {type(engine).__name__})"
            )
        self._engine = engine
        #: Read by the Verifier port's default multi-batch loop: whether it
        #: may coalesce groups through this verifier's engine.
        self.batch_verify_enabled = bool(getattr(engine, "randomized", False))

    def set_public_keys(self, public_keys: Mapping[int, bytes]) -> None:
        """Swap the key registry (reconfiguration)."""
        self._public_keys = dict(public_keys)

    @property
    def engine(self) -> Ed25519BatchVerifier:
        """The batch engine behind this verifier -- lets applications fuse
        their own signature waves (e.g. client requests) into its launch."""
        return self._engine

    def consenter_sig_triples(
        self, signatures: Sequence[Signature], proposal: Proposal
    ) -> tuple[list[bytes], list[bytes], list[bytes], list[bool]]:
        """The (messages, sigs, keys, known) arrays that
        :meth:`verify_consenter_sigs_batch` would launch -- exposed so a
        caller can append them to a larger wave."""
        if isinstance(signatures, QuorumCert):
            raise ValueError(
                "consenter_sig_triples cannot flatten a half-aggregated "
                "QuorumCert into a strict-verification wave -- route it "
                "through verify_aggregate_cert instead"
            )
        messages, sigs, keys = [], [], []
        known: list[bool] = []
        for sig in signatures:
            key = self._public_keys.get(sig.id)
            known.append(key is not None)
            messages.append(commit_message(proposal, sig.msg))
            sigs.append(sig.value)
            keys.append(key if key is not None else b"")
        return messages, sigs, keys, known

    def verify_consenter_sig(self, signature: Signature, proposal: Proposal) -> bytes:
        result = self.verify_consenter_sigs_batch([signature], proposal)[0]
        if result is None:
            raise ValueError(f"invalid consenter signature from {signature.id}")
        return result

    def verify_signature(self, signature: Signature) -> None:
        key = self._public_keys.get(signature.id)
        if key is None:
            raise ValueError(f"unknown signer {signature.id}")
        ok = self._engine.verify_batch(
            [raw_message(signature.msg)], [signature.value], [key]
        )
        if not ok[0]:
            raise ValueError(f"invalid signature from {signature.id}")

    def verify_consenter_sigs_batch(
        self, signatures: Sequence[Signature], proposal: Proposal
    ) -> list[Optional[bytes]]:
        if isinstance(signatures, QuorumCert):
            # Half-aggregated certs are not ported: the port's default
            # verify_aggregate_cert rejects them.
            aux = self.verify_aggregate_cert(signatures, proposal)
            if aux is None:
                return [None] * len(signatures)
            return list(aux)
        messages, sigs, keys, known = self.consenter_sig_triples(signatures, proposal)
        ok = self._engine.verify_batch(messages, sigs, keys)
        return [
            signatures[i].msg if (known[i] and ok[i]) else None
            for i in range(len(signatures))
        ]

    def verify_consenter_sigs_multi_batch(
        self, groups: Sequence[tuple[Proposal, Sequence[Signature]]]
    ) -> list[list[Optional[bytes]]]:
        """Flatten every (proposal, signatures) group into ONE engine call:
        the per-item message array lets signatures over different proposals
        share a wave, so a whole sync chunk verifies as one batch.

        Groups of half-aggregated ``QuorumCert``s take the per-cert path
        (which rejects them until half-aggregation is ported); mixing cert
        kinds in one call raises."""
        if groups:
            kinds = {isinstance(sigs, QuorumCert) for _, sigs in groups}
            if len(kinds) > 1:
                raise ValueError(
                    "verify_consenter_sigs_multi_batch: groups mix "
                    "half-aggregated QuorumCerts with full signature tuples "
                    "-- cert modes contradict; partition the groups first"
                )
            if kinds == {True}:
                return [
                    self.verify_consenter_sigs_batch(cert, proposal)
                    for proposal, cert in groups
                ]
        messages, sigs, keys, known = [], [], [], []
        for proposal, cert in groups:
            m, s, k, kn = self.consenter_sig_triples(cert, proposal)
            messages += m
            sigs += s
            keys += k
            known += kn
        if not messages:
            return [[] for _ in groups]
        ok = self._engine.verify_batch(messages, sigs, keys)
        out: list[list[Optional[bytes]]] = []
        i = 0
        for _, cert in groups:
            out.append([
                sig.msg if (known[i + j] and ok[i + j]) else None
                for j, sig in enumerate(cert)
            ])
            i += len(cert)
        return out

    def auxiliary_data(self, msg: bytes) -> bytes:
        return msg


class EcdsaP256Signer(Signer):
    """ECDSA-P256 replica identity (private key host-side), signing with the
    RFC 6979 reference of :mod:`.ecdsa_p256`; signatures are the framework's
    raw 64-byte r || s format.  ``private_key`` is an int in [1, n) or its
    32 big-endian bytes; None draws a fresh one."""

    def __init__(self, node_id: int, private_key=None) -> None:
        if private_key is None:
            private_key = 0
            while not 1 <= private_key < P256_N:
                private_key = int.from_bytes(os.urandom(32), "big")
        elif isinstance(private_key, (bytes, bytearray)):
            if len(private_key) != 32:
                raise ValueError("P-256 private key bytes must be 32 long")
            private_key = int.from_bytes(private_key, "big")
        self.node_id = node_id
        self.public_bytes = ref_p256_public_key(private_key)
        self._key = private_key

    def sign_raw(self, data: bytes) -> bytes:
        """Sign ``data`` exactly as given (no domain tag); returns the
        framework's raw 64-byte r || s format."""
        return ref_p256_sign(self._key, data)

    def sign(self, data: bytes) -> bytes:
        return self.sign_raw(raw_message(data))

    def sign_proposal(self, proposal: Proposal, aux: bytes = b"") -> Signature:
        return Signature(
            id=self.node_id,
            value=self.sign_raw(commit_message(proposal, aux)),
            msg=aux,
        )


class EcdsaP256VerifierMixin(Ed25519VerifierMixin):
    """Signature-verification half of the Verifier port over ECDSA-P256:
    the Ed25519 mixin's registry and batching semantics on the P-256
    engine (``EcdsaP256BatchVerifier()`` on ``cuda`` unless given one)."""

    # Half-aggregation rides the Ed25519 group law; there is no P-256
    # analogue.
    supports_cert_aggregation = False

    def __init__(
        self,
        public_keys: Mapping[int, bytes],
        *,
        engine: Optional[EcdsaP256BatchVerifier] = None,
    ) -> None:
        super().__init__(
            public_keys,
            engine=engine if engine is not None else EcdsaP256BatchVerifier(),
        )


__all__ = [
    "EcdsaP256Signer",
    "EcdsaP256VerifierMixin",
    "Ed25519Signer",
    "Ed25519VerifierMixin",
    "commit_message",
    "engine_for_config",
    "raw_message",
]
