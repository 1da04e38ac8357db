"""Ed25519 and ECDSA-P256 implementations of the signature ports (torch
port of ``consensus_tpu/models/verifier.py``).

* :class:`Ed25519Signer` holds this replica's private key on the host and
  signs raw payloads and proposals with the RFC 8032 reference;
  :class:`EcdsaP256Signer` does the same with the RFC 6979 P-256 reference.
* :class:`Ed25519VerifierMixin` implements the signature-verification
  methods of the ``Verifier`` port against a node-id -> public-key
  registry, draining ``verify_consenter_sigs_batch`` -- and all the groups
  of ``verify_consenter_sigs_multi_batch`` -- into one engine call, and
  builds and checks half-aggregated quorum certs (``aggregate_cert``,
  ``verify_aggregate_cert``) through a
  :class:`~consensus_tpu_torch.models.aggregate.HalfAggregator` over its
  engine; :class:`EcdsaP256VerifierMixin` is the same over the P-256
  engine, without cert aggregation.

Message binding is byte-identical to the JAX package: a consenter
signature covers ``b"ctpu/commit" + proposal-digest + len(aux) + aux`` and a
raw signature ``b"ctpu/raw" + data``, so a cluster that mixes replicas of
both packages verifies every vote the same way.

:func:`engine_for_config` routes a ``Configuration`` through the engine
registry (:mod:`consensus_tpu_torch.models.registry`), as the JAX package
does: the strict single-device engine of the curve for the default
configuration, the randomized Ed25519 engine for ``batch_verify_mode``,
the fused engines of :mod:`consensus_tpu_torch.models.fused` for
``device_prep``, and, with ``engine_supervision``, an
:class:`~consensus_tpu_torch.models.supervisor.EngineSupervisor` over the
ladder of :func:`degrade_ladder_configs` with the host twin as its floor.
Every other lane raises :class:`~consensus_tpu_torch.models.registry
.UnknownEngineError`: the JAX registry's own reasons for the Ed25519-only
features on P-256, and the ROADMAP.md queue A item for a lane not ported
yet.
"""

from __future__ import annotations

import os
import struct
import warnings
from typing import Mapping, Optional, Sequence

from consensus_tpu_torch.api.deps import Signer, Verifier
from consensus_tpu_torch.config import CompileCacheConfig
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
from consensus_tpu_torch.models.registry import ENGINE_REGISTRY, engine_key_for
from consensus_tpu_torch.models.supervisor import EngineSupervisor
from consensus_tpu_torch.obs.kernels import COMPILE_CACHE
from consensus_tpu_torch.types import Proposal, QuorumCert, Signature

_COMMIT_TAG = b"ctpu/commit"
_RAW_TAG = b"ctpu/raw"


def commit_message(proposal: Proposal, aux: bytes) -> bytes:
    digest = bytes.fromhex(proposal.digest())
    return _COMMIT_TAG + digest + struct.pack(">I", len(aux)) + aux


def raw_message(data: bytes) -> bytes:
    return _RAW_TAG + data


def engine_for_config(
    config, curve: str = "ed25519", *, device: DeviceLike = None, metrics=None
):
    """The batch engine matching a ``Configuration``'s crypto knobs
    (``batch_verify_mode``, ``crypto_pad_pow2``, ``crypto_tpu_min_batch``,
    ``mesh_shards`` / ``mesh_topology``, ``device_prep``), routed through the
    engine registry on ``device`` (``cuda`` unless the caller names one).
    The config maps to an ``EngineKey`` (:func:`~consensus_tpu_torch.models
    .registry.engine_key_for`), and an unregistered key fails loudly with the
    curve-specific reason or the queue A item of the lane.  On the card the
    builder also builds the engine's kernel libraries, so its first launch
    never waits on nvcc.

    Pass a ``Metrics`` bundle as ``metrics`` to book this construction's
    kernel-library loads (hits) and nvcc builds (misses) into the pinned
    ``engine_compile_cache_{hits,misses}_total`` counters, and a supervised
    engine's degrades, recoveries, cross-checks and rung into the
    ``engine_*`` series (the JAX package books those only for a supervisor
    built with its own ``metrics``).

    ``engine_supervision`` wraps the result in an
    :class:`~consensus_tpu_torch.models.supervisor.EngineSupervisor` over
    the config's degrade ladder (:func:`degrade_ladder_configs`) with the
    host twin as its floor, cross-checking every
    ``engine_crosscheck_interval``-th launch on the host.  Supervision
    changes only WHERE work runs, never the verdict.

    ``compile_cache`` is inert in the port (it has no jit memo and no XLA
    cache; kernel libraries are cached on disk by their source's hash), so
    a non-default value warns instead of being ignored in silence."""
    cache = getattr(config, "compile_cache", CompileCacheConfig())
    if cache != CompileCacheConfig():
        warnings.warn(
            f"compile_cache={cache} has no effect in the PyTorch port: it has no "
            "jit memo and no XLA cache to configure (ROADMAP.md queue C, divergence 14)",
            stacklevel=2,
        )
    before = COMPILE_CACHE.snapshot()
    if not getattr(config, "engine_supervision", False):
        engine = _engine_for_config(config, curve, device)
    else:
        rungs = [
            _engine_for_config(c, curve, device) for c in degrade_ladder_configs(config)
        ]
        engine = EngineSupervisor(
            rungs,
            crosscheck_interval=int(
                getattr(config, "engine_crosscheck_interval", 0) or 0
            ),
            metrics=metrics,
            name=f"{curve}-engine",
        )
    if metrics is not None:
        after = COMPILE_CACHE.snapshot()
        metrics.engine.count_compile_cache_hits.add(
            after["hits"] - before["hits"]
        )
        metrics.engine.count_compile_cache_misses.add(
            after["misses"] - before["misses"]
        )
    return engine


def degrade_ladder_configs(config) -> list:
    """The best-first ``Configuration`` ladder supervision degrades down:
    as configured, then mesh -> single device, then fused -> unfused
    host-prep.  Derived by walking the engine registry's degrade keys
    (:meth:`~consensus_tpu_torch.models.registry.EngineRegistry.degrade_keys`)
    and mapping each key transition back onto the config, so the ladder
    always mirrors what is actually registered.  (The host twin is not a
    config -- the supervisor appends it as the ladder's floor itself.)"""
    ladder = [config]
    keys = ENGINE_REGISTRY.degrade_keys(engine_key_for(config))
    for prev_key, next_key in zip(keys, keys[1:]):
        prev = ladder[-1]
        if prev_key.topology == "mesh" and next_key.topology == "single":
            ladder.append(prev.with_(mesh_shards=1, mesh_topology=()))
        elif prev_key.device_prep and not next_key.device_prep:
            ladder.append(prev.with_(device_prep=False))
    return ladder


def _engine_for_config(config, curve: str, device: DeviceLike):
    """The unsupervised engine routing (see :func:`engine_for_config`):
    config -> ``EngineKey`` -> registered builder."""
    return ENGINE_REGISTRY.build(
        engine_key_for(config, curve),
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
        self._aggregator = None

    #: Half-aggregated quorum certs are Ed25519-only (the aggregator's MSM
    #: rides the Ed25519 shared-doubling kernel); the P-256 subclass
    #: overrides this back to False.
    supports_cert_aggregation = True

    @property
    def aggregator(self):
        """The lazily built :class:`~consensus_tpu_torch.models.aggregate
        .HalfAggregator` sharing this verifier's engine (same padding,
        device threshold, device and fused front end, so cert checks route
        host/device exactly like the engine's own batches)."""
        if self._aggregator is None:
            from consensus_tpu_torch.models.aggregate import HalfAggregator

            self._aggregator = HalfAggregator(engine=self._engine)
        return self._aggregator

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

    # --- half-aggregated quorum certs (models/aggregate.py) --------------

    def aggregate_cert(
        self, proposal: Proposal, signatures: Sequence[Signature]
    ) -> Optional[QuorumCert]:
        if not self.supports_cert_aggregation:
            return None
        if isinstance(signatures, QuorumCert):
            return signatures
        sigs = list(signatures)
        if not sigs:
            return None
        messages, values, keys = [], [], []
        for sig in sigs:
            key = self._public_keys.get(sig.id)
            if key is None:
                return None
            messages.append(commit_message(proposal, sig.msg))
            values.append(sig.value)
            keys.append(key)
        agg, _bad = self.aggregator.aggregate(messages, values, keys)
        if agg is None:
            return None
        rs, s_agg = agg
        aux_table: list[bytes] = []
        aux_index: list[int] = []
        seen: dict[bytes, int] = {}
        for sig in sigs:
            idx = seen.get(sig.msg)
            if idx is None:
                idx = len(aux_table)
                seen[sig.msg] = idx
                aux_table.append(sig.msg)
            aux_index.append(idx)
        return QuorumCert(
            signer_ids=tuple(s.id for s in sigs),
            rs=tuple(rs),
            s_agg=s_agg,
            aux_table=tuple(aux_table),
            aux_index=tuple(aux_index),
        )

    def verify_aggregate_cert(
        self, cert: QuorumCert, proposal: Proposal
    ) -> Optional[list[bytes]]:
        if not self.supports_cert_aggregation or len(cert) == 0:
            return None
        messages, keys, aux = [], [], []
        for comp in cert:
            key = self._public_keys.get(comp.id)
            if key is None:
                return None
            messages.append(commit_message(proposal, comp.msg))
            keys.append(key)
            aux.append(comp.msg)
        try:
            ok = self.aggregator.verify(
                messages, list(cert.rs), cert.s_agg, keys
            )
        except ValueError:
            return None
        return aux if ok else None

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
            # A half-aggregated cert: all-or-nothing through the aggregate
            # path (one MSM check), never flattened into a strict wave.
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

        Groups of half-aggregated ``QuorumCert``s take the per-cert
        aggregate path (one MSM check each); mixing cert kinds in one call
        raises."""
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
    "degrade_ladder_configs",
    "engine_for_config",
    "raw_message",
]
