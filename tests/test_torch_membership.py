"""The JAX package's membership tests (``tests/test_membership.py``) on the
port, and its churn chaos runs held against the JAX package's.

The membership configuration and directory, epoch tagging on the wire,
removal, sync-learned reconfiguration, the join bootstrap, the stale
membership sentinel and its shrinker, churn chaos and the
``membership_churn`` detector run as the JAX test file has them, its
imports renamed (``torch_mirror``).  Then the same churn schedules run in
both packages, which must give the same event log, ledgers and repro text.
"""

import pytest

import consensus_tpu.testing.chaos as jchaos
from consensus_tpu_torch.testing.chaos import format_repro
from torch_mirror import mirror

mirror("test_membership", globals())


@pytest.mark.parametrize("seed", [2, 4])
def test_churn_chaos_run_equals_the_jax_packages(seed):
    ours = ChaosEngine(ChaosSchedule.generate(seed, n=4, steps=12, churn=True)).run()  # noqa: F821
    theirs = jchaos.ChaosEngine(jchaos.ChaosSchedule.generate(seed, n=4, steps=12, churn=True)).run()
    assert ours.ok, ours.violation
    assert ours.event_log == theirs.event_log
    assert ours.ledgers == theirs.ledgers
    assert format_repro(ours).replace("consensus_tpu_torch", "consensus_tpu") == \
        jchaos.format_repro(theirs)
