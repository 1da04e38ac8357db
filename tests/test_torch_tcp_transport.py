"""The JAX package's live TCP transport tests (``tests/test_tcp_transport.py``)
on the port's ``net/transport.py``, its imports renamed (``torch_mirror``):
framing round trips, HELLO identity pinning and its HMAC proof, the sync
listener's resilience, reconnect and resend, listener pause and resume, and
a 4-replica cluster over localhost sockets ordering blocks in wall-clock
time.  The wire bytes and a cluster mixing both packages' replicas are held
against the JAX package in ``test_torch_net_parity.py``.
"""

from torch_mirror import mirror

mirror("test_tcp_transport", globals())
