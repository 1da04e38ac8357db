"""The JAX package's deployment-rig unit tests (``tests/test_deploy.py``)
on the port's ``deploy/``, its imports renamed (``torch_mirror``): the
cluster spec's round trip, the JSON control channel, the supervisor's
restarts, backoff and flight records against a trivial child, the
cross-process invariant monitor, the fleet autoscaler's decisions and the
seeded process-chaos schedule.  All 16 cases run unchanged: none builds an
engine.  The spec files and the schedules are held byte for byte against
the JAX package's in ``test_torch_deploy_parity.py``.
"""

from torch_mirror import mirror

mirror("test_deploy", globals())
