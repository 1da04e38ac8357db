"""The ports (dependency interfaces) the signature slice implements."""

from consensus_tpu_torch.api.deps import Signer, Verifier

__all__ = ["Signer", "Verifier"]
