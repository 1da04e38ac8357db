"""Network pieces of the port: the listener-hardening framing layer that
the sync transport uses.  The TCP transport and the verification sidecar
(``net/transport.py``, ``net/sidecar.py`` in the JAX package) are
ROADMAP.md queue A item 14.
"""

from consensus_tpu_torch.net.framing import FrameStall, ListenerGuard, recv_exact

__all__ = ["FrameStall", "ListenerGuard", "recv_exact"]
