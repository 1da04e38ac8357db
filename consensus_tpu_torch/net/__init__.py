"""Network transports: production Comm implementations (TCP over DCN).

The PyTorch port's copy of ``consensus_tpu/net/__init__.py``, its imports renamed.
"""

from consensus_tpu_torch.net.transport import MAX_FRAME_BYTES, TcpComm
from consensus_tpu_torch.net.sidecar import SidecarVerifierClient, VerifySidecarServer

__all__ = [
    "TcpComm",
    "MAX_FRAME_BYTES",
    "VerifySidecarServer",
    "SidecarVerifierClient",
]
