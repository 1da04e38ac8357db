"""The port's sharded randomized engines (``consensus_tpu_torch/parallel/
sharding.py``) held against the JAX package on the CPU: the randomized mesh
case of ``tests/test_mesh.py:157`` and the padding-only shards of a small
batch, in the host-prep and the fused randomized lanes.

Each shard checks its own aggregate with the plain torch versions on its
slice of the CPU's virtual shards.  Verdicts are compared with tolerance 0
against the single engine and the JAX package's randomized verdicts (its
host twin's aggregates, which its sharded engine equals in its own tests);
the JAX package's sharded randomized engine compiles for minutes on the
CPU, so the case that runs it is marked ``slow``, as the JAX test is.
"""

import numpy as np
import pytest
import torch

from consensus_tpu.models.ed25519 import (
    Ed25519RandomizedBatchVerifier as JaxEd25519RandomizedBatchVerifier,
)
from consensus_tpu_torch.models.ed25519 import (
    Ed25519RandomizedBatchVerifier,
    ref_public_key,
    ref_sign,
)
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.parallel import (
    ShardedEd25519RandomizedVerifier,
    ShardedFusedEd25519RandomizedVerifier,
    mesh_for_shards,
)

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shards' tensors are a few lanes wide: one intra-op thread runs
    them faster than many, and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n, seed=0, msg_len=100):
    rng = np.random.default_rng(seed)
    seeds = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)]
    keys = [ref_public_key(s) for s in seeds]
    msgs = [rng.integers(0, 256, msg_len, dtype=np.uint8).tobytes() for _ in range(n)]
    sigs = [ref_sign(s, m) for s, m in zip(seeds, msgs)]
    return msgs, sigs, keys


def _flip(raw, i):
    raw = bytes(raw)
    return raw[:i] + bytes([raw[i] ^ 1]) + raw[i + 1:]


def _jax_randomized(msgs, sigs, keys) -> np.ndarray:
    """The JAX package's randomized verdicts (its host twin's aggregates)."""
    engine = JaxEd25519RandomizedBatchVerifier(min_device_batch=10**9)
    return np.asarray(engine.verify_batch(msgs, sigs, keys))


# --- randomized Ed25519 ------------------------------------------------------------


def test_sharded_randomized_isolates_a_corrupt_lane_on_2_shards():
    """``tests/test_mesh.py:157``'s batches on 2 shards: an all-valid batch
    passes one per-shard aggregate, and a corrupt lane is isolated by the
    bisection driver -- the JAX package's verdicts and the single engine's."""
    eng = ShardedEd25519RandomizedVerifier(mesh_for_shards(2, **CPU), min_device_batch=1)
    msgs, sigs, keys = _batch(8, seed=3)
    before = KERNELS.stats("ed25519.sharded_batch_verify").launches
    assert eng.verify_batch(msgs, sigs, keys).all()
    assert KERNELS.stats("ed25519.sharded_batch_verify").launches == before + 1
    sigs = list(sigs)
    sigs[5] = bytes(64)
    out = eng.verify_batch(msgs, sigs, keys)
    assert list(np.flatnonzero(~out)) == [5]
    assert (out == _jax_randomized(msgs, sigs, keys)).all()
    single = Ed25519RandomizedBatchVerifier(min_device_batch=1, **CPU)
    assert (out == single.verify_batch(msgs, sigs, keys)).all()


def test_padding_only_shards_vote_ok():
    """3 signatures on 8 shards pad to 8 lanes, one a shard: shards 3-7 hold
    padding only (u_s = 0, every digit masked), their aggregate is the
    identity and they vote ok -- in both randomized lanes."""
    msgs, sigs, keys = _batch(3, seed=4)
    mesh = mesh_for_shards(8, **CPU)
    eng = ShardedEd25519RandomizedVerifier(mesh, min_device_batch=1)
    assert eng.padded_size(3) == 8
    assert eng.verify_batch(msgs, sigs, keys).all()
    forged = list(sigs)
    forged[1] = _flip(forged[1], 40)  # a forged S: decodes, fails the equation
    out = eng.verify_batch(msgs, forged, keys)
    assert out.tolist() == [True, False, True]
    assert (out == _jax_randomized(msgs, forged, keys)).all()
    fused = ShardedFusedEd25519RandomizedVerifier(mesh, min_device_batch=1)
    before = KERNELS.stats("ed25519.sharded_fused_batch_verify").launches
    assert fused.verify_batch(msgs, sigs, keys).all()
    assert KERNELS.stats("ed25519.sharded_fused_batch_verify").launches == before + 1


@pytest.mark.slow
def test_sharded_randomized_matches_the_jax_sharded_engine():
    """``tests/test_mesh.py:157`` itself: the JAX package's
    ``ShardedEd25519RandomizedVerifier`` over 2 devices (its first compile
    takes minutes on the CPU) and the port's give the same verdicts."""
    from consensus_tpu.parallel import ShardedEd25519RandomizedVerifier as Jax
    from consensus_tpu.parallel import mesh_for_shards as jax_mesh_for_shards

    theirs = Jax(jax_mesh_for_shards(2), min_device_batch=1)
    ours = ShardedEd25519RandomizedVerifier(mesh_for_shards(2, **CPU), min_device_batch=1)
    for corrupt in ((), (5,)):
        msgs, sigs, keys = _batch(8, seed=3)
        sigs = list(sigs)
        for i in corrupt:
            sigs[i] = bytes(64)
        assert list(ours.verify_batch(msgs, sigs, keys)) == list(
            np.asarray(theirs.verify_batch(msgs, sigs, keys))
        )
