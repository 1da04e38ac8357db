"""The half-agg mode of the JAX package's device-fault matrix
(``tests/test_supervisor.py`` 466-497) on the port, its engine on the CPU.

The supervisor masks a hang, a raise and a silent verdict flip while every
decided quorum is compressed into a half-aggregated certificate: the
faulted run's event log and ledgers equal the fault-free run's.  As in the
JAX package, the certificates' aggregator reads no device threshold through
the supervisor, so in the faulted run it checks each certificate on the
engine's device path (here the plain torch MSM), which makes this the
slowest case of the matrix and the reason it has a file of its own.
"""

from consensus_tpu_torch.metrics import (
    ENGINE_CROSSCHECK_MISMATCH_KEY,
    ENGINE_DEGRADE_KEY,
    ENGINE_RECOVERED_KEY,
    ENGINE_RUNG_KEY,
)
from consensus_tpu_torch.models import FAULT_CLASSES
from consensus_tpu_torch.testing.chaos import ChaosEngine, ChaosSchedule

MATRIX_FAULTS = ((2, "hang"), (5, "raise"), (8, "flip"))
MATRIX_SEED = 31


def test_halfagg_device_fault_matrix_is_byte_identical_to_clean_run():
    sched = ChaosSchedule.generate(MATRIX_SEED, n=4, steps=6)
    clean = ChaosEngine(sched, crypto="ed25519-halfagg", device="cpu").run()
    engine = ChaosEngine(sched, crypto="ed25519-halfagg", device="cpu",
                         device_faults=MATRIX_FAULTS)
    res = engine.run()
    assert clean.ok, clean.violation
    assert res.ok, res.violation
    assert res.event_log == clean.event_log
    assert res.ledgers == clean.ledgers
    assert engine.fault_injector.fired == list(MATRIX_FAULTS)
    assert engine.fault_injector.pending == 0
    dump = engine.engine_metrics.provider.dump()
    for reason in FAULT_CLASSES:
        assert dump[f"{ENGINE_DEGRADE_KEY}{{{reason}}}"]["value"] == 1, reason
    assert dump[ENGINE_RECOVERED_KEY]["value"] == 3
    assert dump[ENGINE_CROSSCHECK_MISMATCH_KEY]["value"] == 1
    assert dump[ENGINE_RUNG_KEY]["value"] == 0
    assert not engine.supervisor.degraded
    assert all(b.state == "closed" for b in engine.supervisor.breakers.values())
