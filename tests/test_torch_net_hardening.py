"""The JAX package's listener-hardening battery (``tests/test_net_hardening.py``)
on the port, its imports renamed (``torch_mirror``): the guard's quotas,
strikes and bans, the chunked framing reads, and the real-socket batteries
of ``testing/adversary.py`` against every listener family the port carries
(``TcpComm``, the sync listener, the deploy control listener and the
verification sidecar), each still serving honest traffic afterwards.

The JAX file's sync chain comes from ``tests/test_sync_subsystem.py``,
built of the JAX package's types; here the same function, renamed, builds
it of the port's.
"""

from torch_mirror import mirror

_sync_subsystem: dict = {"__name__": "torch_sync_subsystem"}
mirror("test_sync_subsystem", _sync_subsystem)
build_chain = _sync_subsystem["build_chain"]

mirror("test_net_hardening", globals(), drop={
    "build_chain": "the JAX package's chain; the port's, renamed, is defined above",
})
