"""The JAX package's storage-fault tests (``tests/test_storage_faults.py``)
on the port, and its storage chaos matrix held against the JAX package's.

The injector's six fault classes on the port's file WAL, the faulty
decision store, the cluster cells (scrub, quarantine, fence, ENOSPC,
fsync lies, torn writes), the storage chaos matrix and the eager-unfence
sentinel run as the JAX test file has them, its imports renamed
(``torch_mirror``).  Each storage chaos schedule of the matrix then runs
in both packages, which must give the same event log, ledgers and repro
text.
"""

import pytest

import consensus_tpu.testing.chaos as jchaos
from consensus_tpu_torch.testing.chaos import format_repro
from torch_mirror import mirror

mirror("test_storage_faults", globals())


def _same_run(jres, tres):
    assert tres.ok == jres.ok
    assert tres.event_log == jres.event_log
    assert tres.ledgers == jres.ledgers
    assert format_repro(tres).replace("consensus_tpu_torch", "consensus_tpu") == \
        jchaos.format_repro(jres)


@pytest.mark.parametrize("fault", sorted(MATRIX_SEEDS))  # noqa: F821
def test_storage_chaos_run_equals_the_jax_packages(fault):
    seed = MATRIX_SEEDS[fault]  # noqa: F821
    ours = ChaosEngine(ChaosSchedule.generate(seed, n=4, steps=25, storage_faults=True)).run()  # noqa: F821
    theirs = jchaos.ChaosEngine(
        jchaos.ChaosSchedule.generate(seed, n=4, steps=25, storage_faults=True)).run()
    assert ours.ok, ours.violation
    _same_run(theirs, ours)
