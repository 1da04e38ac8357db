"""The JAX package's crash matrix (``tests/test_crash_matrix.py``) on the
port, and held against the JAX package cell for cell.

Every registered crash point under the commit, rotation and view-change
schedule families, the two pinned endorsement regressions, the sync-path
seams, the storage cells, the TCP transport and sidecar I/O cases (the four
``net.*`` and ``sidecar.*`` crash points) and the zero-overhead guarantee
run as the JAX test file has them, its imports renamed (``torch_mirror``);
its coverage gate audits every registered point.  Each matrix cell then
runs in both packages, and the ledgers the recovered clusters hold are
equal.
"""

import pytest

import test_crash_matrix as jax_matrix
from torch_mirror import mirror

mirror("test_crash_matrix", globals())


def _cell_ledgers(ns, family, point, wal_dir=None):
    """``_run_cell`` of the test namespace ``ns`` (the JAX test module's or
    this one's), returning the fired point and every node's ledger after
    the recovery."""
    seed = ns["_seed"](family, point)
    cluster = ns["_build_cluster"](family, seed, wal_dir=wal_dir)
    cluster.start()
    victim = cluster.nodes[ns["VICTIM"]]
    plan = ns["FaultPlan"](point, on_hit=ns["_ON_HIT"][family], label=f"{family}:{point}")
    victim.arm_fault_plan(plan)
    crash_info = {"view": 0}
    teardown = plan.on_crash

    def on_crash():
        crash_info["view"] = victim.consensus.controller.curr_view_number
        teardown()

    plan.on_crash = on_crash
    ns["_run_schedule"](cluster, family)
    ns["_recover_and_check"](cluster, victim, plan, family, point, seed, crash_info)
    # The packages' dataclasses differ by type only: compare their reprs.
    return plan.fired, {nid: [repr(d) for d in n.app.ledger] for nid, n in cluster.nodes.items()}


@pytest.mark.parametrize("point", STATE_POINTS + WAL_POINTS)  # noqa: F821
@pytest.mark.parametrize("family", FAMILIES)  # noqa: F821
def test_cell_recovers_to_the_jax_packages_ledgers(family, point, tmp_path):
    wal = point.startswith("wal.")
    ours = _cell_ledgers(globals(), family, point,
                         wal_dir=str(tmp_path / "port") if wal else None)
    theirs = _cell_ledgers(vars(jax_matrix), family, point,
                           wal_dir=str(tmp_path / "jax") if wal else None)
    assert ours == theirs
