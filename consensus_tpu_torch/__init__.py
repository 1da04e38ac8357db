"""consensus_tpu_torch — the PyTorch and CUDA port of ``consensus_tpu``.

A second package beside the JAX one.  It keeps the JAX package's module
names so each counterpart is easy to find, imports ``torch`` and numpy and
never ``jax`` or ``consensus_tpu``, and holds its own copies of what it
needs.  Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no CPU request it raises.  The protocol
modules touch no tensor: the device comes in only through the verifier a
replica's application is handed.

Layout:
    api/        dependency-injection ports (the seam applications implement)
    wire/       message schema + deterministic binary codec (byte-identical
                to the JAX package's)
    wal/        segmented CRC-chained write-ahead log (the same file format)
    runtime/    deterministic clock + event scheduler
    core/       the consensus protocol state machines; consensus.py is the
                facade over them
    sync/       verified, chunked state transfer behind the Synchronizer port
    membership/ membership epochs and the joining-node bootstrap
    net/        the listener-hardening framing layer the sync transport uses
    trace/      decision-lifecycle tracer
    utils/      quorum math, leader selection, blacklist, digests
    ops/        GF(2^255-19) and GF(p256) limb arithmetic, edwards25519 and
                P-256 formulas, and the Horner-scan and Straus-MSM kernel
                wrappers (CUDA on the card, torch on CPU)
    csrc/       hand-written CUDA sources, built with nvcc on first use
    models/     the strict and randomized Ed25519 and the ECDSA-P256 batch
                verifiers, their signers and Verifier-port mixins, and the
                engine layer: coalescers (engine.py), supervision
                (supervisor.py) and the engine registry (registry.py)
    obs/        the kernel ledger (launches and nvcc builds)
    metrics.py  the metric providers and every instrument bundle
    testing/    in-process simulated network, the all-ports test
                application and cluster, and the real-crypto apps
                (CryptoApp, SignedRequestApp)
"""

from consensus_tpu_torch.config import Configuration, default_config
from consensus_tpu_torch.device import resolve_device
from consensus_tpu_torch.types import (
    Checkpoint,
    Decision,
    Proposal,
    Reconfig,
    RequestInfo,
    Signature,
    SyncResponse,
    ViewSequence,
)

__all__ = [
    "Checkpoint",
    "Configuration",
    "Decision",
    "Proposal",
    "Reconfig",
    "RequestInfo",
    "Signature",
    "SyncResponse",
    "ViewSequence",
    "default_config",
    "resolve_device",
]
