"""consensus_tpu_torch — the PyTorch and CUDA port of ``consensus_tpu``.

A second package beside the JAX one.  It keeps the JAX package's module
names so each counterpart is easy to find, imports ``torch`` and numpy and
never ``jax`` or ``consensus_tpu``, and holds its own copies of what it
needs.  Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no CPU request it raises.

Layout:
    ops/       GF(2^255-19) and GF(p256) limb arithmetic, edwards25519 and
               P-256 formulas, and the Horner-scan kernel wrappers (CUDA on
               the card, torch on CPU)
    csrc/      hand-written CUDA sources, built with nvcc on first use
    models/    the strict Ed25519 and ECDSA-P256 batch verifiers, their
               signers and Verifier-port mixins
    api/       the Signer / Verifier ports
    testing/   SigOnlyVerifier
"""

from consensus_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
