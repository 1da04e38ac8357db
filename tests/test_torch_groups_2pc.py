"""The JAX package's cross-group commit tests (``tests/test_groups_2pc.py``)
on the port's ``groups/``, its imports renamed (``torch_mirror``): the
two-phase commit's happy path, WAL replay, coordinator death and
presumed-abort recovery, seeded per-group chaos mid-commit, the silent
honest runs and the planted one-sided commit the atomicity invariant
catches and shrinks.  Every case runs unchanged: the sharded cluster
resolves no device on a crypto-free run (ROADMAP.md queue C, divergence
25).  The chaos results are held against the JAX package's in
``test_torch_deploy_parity.py``.
"""

from torch_mirror import mirror

mirror("test_groups_2pc", globals())
