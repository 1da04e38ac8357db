"""The JAX package's simulated-network adversary tests
(``tests/test_network_adversary.py``) on the port's ``testing/network.py``,
its imports renamed (``torch_mirror``), and one seeded adversarial run held
against the JAX package's network send for send.
"""

import consensus_tpu.runtime.scheduler as jscheduler
import consensus_tpu.testing.network as jnetwork
from torch_mirror import mirror

mirror("test_network_adversary", globals())


def _adversarial_trace(scheduler_mod, network_mod):
    sched = scheduler_mod.SimScheduler()
    net = network_mod.SimNetwork(sched, seed=9)
    got = []
    for node in (1, 2, 3):
        net.register(node, lambda s, p, r, node=node: got.append((sched.now(), node, s, p, r)))
    net.set_loss(1, 2, 0.2)
    net.set_duplicate(1, 3, 0.3)
    net.set_reorder(2, 3, 0.3)
    net.set_replay(3, 1, 0.3)
    for i in range(200):
        for a, b in ((1, 2), (1, 3), (2, 3), (3, 1)):
            net.send(a, b, b"m%d-%d" % (a, i), is_request=bool(i % 2))
        sched.advance(0.003)
    sched.advance(1.0)
    return got, dict(net.injected)


def test_seeded_adversarial_network_delivers_as_the_jax_package():
    import consensus_tpu_torch.runtime.scheduler as tscheduler
    import consensus_tpu_torch.testing.network as tnetwork

    ours = _adversarial_trace(tscheduler, tnetwork)
    assert ours == _adversarial_trace(jscheduler, jnetwork)
    assert sum(ours[1].values()) > 0
