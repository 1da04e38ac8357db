"""The port's sharded P-256, randomized and fused engines
(``consensus_tpu_torch/parallel/sharding.py``) held against the JAX package
on the CPU: the mesh cases of ``tests/test_ecdsa_p256.py:243-250`` and
``tests/test_fused.py:170-195, :307-330``; the randomized lane's (with
``tests/test_mesh.py:157``) are in ``tests/test_torch_mesh_randomized.py``.

Each shard runs the plain torch versions on its slice of the CPU's virtual
shards.  Verdicts are compared with tolerance 0 against the single engines
and the JAX package's verdicts on the same seeded batches; the fused
randomized transcript's coefficients against the host twin's, bit for bit,
on 1-D and (2, 4) topologies.  The JAX package's fused engines compile for
minutes on the CPU, and its own tests of them are marked ``slow``; the case
that runs them here is marked ``slow`` too, and the tier-1 cases compare
with the JAX package's host-path verdicts, which its fused engines equal
(its own tests).
"""

import numpy as np
import pytest
import torch

from consensus_tpu.models.ed25519 import Ed25519BatchVerifier as JaxEd25519BatchVerifier
from consensus_tpu.models.ed25519 import (
    Ed25519RandomizedBatchVerifier as JaxEd25519RandomizedBatchVerifier,
)
from consensus_tpu.models.ed25519 import _transcript_coefficients as jax_transcript_coefficients
from consensus_tpu.parallel import ShardedEcdsaP256Verifier as JaxShardedEcdsaP256Verifier
from consensus_tpu.parallel import make_mesh as jax_make_mesh
from consensus_tpu_torch.models.ecdsa_p256 import (
    EcdsaP256BatchVerifier,
    ref_p256_public_key,
    ref_p256_sign,
)
from consensus_tpu_torch.models.ed25519 import (
    L,
    Ed25519BatchVerifier,
    Ed25519RandomizedBatchVerifier,
    _transcript_coefficients,
    _Z_TAG,
    ref_public_key,
    ref_sign,
)
from consensus_tpu_torch.models.fused import (
    FusedEd25519BatchVerifier,
    FusedEd25519RandomizedBatchVerifier,
    _frame,
    _pack_blocks,
    _to_device,
)
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import sha512 as sh
from consensus_tpu_torch.parallel import (
    MeshTopology,
    ShardedEcdsaP256Verifier,
    ShardedFusedEd25519RandomizedVerifier,
    ShardedFusedEd25519Verifier,
    make_mesh,
    mesh_for_shards,
)
from consensus_tpu_torch.parallel.sharding import sharded_transcript

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


def _adversarial_waves():
    """``tests/test_fused.py``'s two 8-lane waves: every rejection class
    next to honest lanes, honest empty and long messages among them."""
    msgs, sigs, keys = (list(x) for x in _batch(16, seed=42))
    sigs[1] = _flip(sigs[1], 2)                  # tampered R: forged
    msgs[2] = _flip(msgs[2], 50)                 # tampered message
    keys[3] = keys[0]                            # wrong key
    sigs[4] = sigs[4][:32] + (int.from_bytes(sigs[4][32:], "little") + L).to_bytes(32, "little")
    sigs[5] = sigs[5][:32] + (2**256 - 1).to_bytes(32, "little")  # S max
    keys[6] = fe.P.to_bytes(32, "little")        # non-canonical A (y = p)
    sigs[7] = (fe.P + 1).to_bytes(32, "little") + sigs[7][32:]  # y_r > p
    sigs[9] = sigs[9][:40]                       # bad signature length
    keys[10] = keys[10][:16]                     # bad key length
    sigs[11] = (2).to_bytes(32, "little") + sigs[11][32:]  # non-square y
    extra = np.random.default_rng(1).integers(0, 256, 32, dtype=np.uint8).tobytes()
    msgs[12] = b""                               # honest empty message
    sigs[12] = ref_sign(extra, msgs[12])
    keys[12] = ref_public_key(extra)
    return [(msgs[:8], sigs[:8], keys[:8]), (msgs[8:], sigs[8:], keys[8:])]


def _jax_strict(msgs, sigs, keys) -> np.ndarray:
    """The JAX package's strict verdicts (its host path)."""
    return np.asarray(JaxEd25519BatchVerifier(min_device_batch=10**9).verify_batch(msgs, sigs, keys))


def _jax_randomized(msgs, sigs, keys) -> np.ndarray:
    """The JAX package's randomized verdicts (its host twin's aggregates)."""
    engine = JaxEd25519RandomizedBatchVerifier(min_device_batch=10**9)
    return np.asarray(engine.verify_batch(msgs, sigs, keys))


# --- ECDSA-P256 ----------------------------------------------------------------


def test_sharded_p256_matches_single_device():
    """``tests/test_ecdsa_p256.py``'s mesh case: 12 signatures, lane 5
    zeroed, over the 8 virtual shards, against the single engine and the
    JAX package's ``ShardedEcdsaP256Verifier(make_mesh())``."""
    rng = np.random.default_rng(5)
    privs = [int(rng.integers(1, 2**62)) for _ in range(12)]
    msgs = [b"p256-%d" % i for i in range(12)]
    sigs = [ref_p256_sign(d, m) for d, m in zip(privs, msgs)]
    keys = [ref_p256_public_key(d) for d in privs]
    bad = list(sigs)
    bad[5] = bytes(64)
    mesh = make_mesh(**CPU)
    assert mesh.devices.size == 8
    sharded = ShardedEcdsaP256Verifier(mesh).verify_batch(msgs, bad, keys)
    single = EcdsaP256BatchVerifier(**CPU).verify_batch(msgs, bad, keys)
    assert (sharded == single).all()
    assert sharded.sum() == 11 and not sharded[5]
    theirs = JaxShardedEcdsaP256Verifier(jax_make_mesh()).verify_batch(msgs, bad, keys)
    assert (sharded == np.asarray(theirs)).all()


# --- fused engines -----------------------------------------------------------------


def test_sharded_fused_strict_parity():
    """``tests/test_fused.py:307``'s strict half on 2 shards: the rejection
    matrix's verdicts equal the host-prep engines' (the port's and the JAX
    package's) and the single fused engine's, one ledger entry a wave."""
    kw = dict(min_device_batch=1, pad_to=8, **CPU)
    shard = ShardedFusedEd25519Verifier(mesh_for_shards(2, **CPU), **kw)
    host = Ed25519BatchVerifier(**kw)
    fused = FusedEd25519BatchVerifier(**kw)
    for msgs, sigs, keys in _adversarial_waves():
        before = KERNELS.stats("ed25519.sharded_fused_verify").launches
        got = shard.verify_batch(msgs, sigs, keys)
        assert KERNELS.stats("ed25519.sharded_fused_verify").launches == before + 1
        assert list(got) == list(host.verify_batch(msgs, sigs, keys))
        assert list(got) == list(fused.verify_batch(msgs, sigs, keys))
        assert list(got) == list(_jax_strict(msgs, sigs, keys))


def test_sharded_fused_randomized_parity():
    """``tests/test_fused.py:307``'s randomized half on 2 shards, with
    ``min_randomized=8`` so the failed aggregate's halves take the sharded
    fused strict floor."""
    rkw = dict(min_device_batch=1, pad_to=8, min_randomized=8, **CPU)
    rshard = ShardedFusedEd25519RandomizedVerifier(mesh_for_shards(2, **CPU), **rkw)
    assert rshard._min_randomized == 8 and rshard.shard_count == 2
    msgs, sigs, keys = _batch(8, seed=6)
    sigs = list(sigs)
    sigs[2] = _flip(sigs[2], 4)
    got = rshard.verify_batch(msgs, sigs, keys)
    assert list(got) == list(Ed25519RandomizedBatchVerifier(**rkw).verify_batch(msgs, sigs, keys))
    assert list(got) == list(FusedEd25519RandomizedBatchVerifier(**rkw).verify_batch(
        msgs, sigs, keys))
    assert list(got) == list(_jax_randomized(msgs, sigs, keys))
    assert list(np.flatnonzero(~got)) == [2]


@pytest.mark.parametrize("axes", [(8,), (2, 4)], ids=["8", "2x4"])
def test_sharded_transcript_coefficients_equal_the_host_twins(axes):
    """Each shard hashes its own leaves, the gathered table gives every
    shard the identical root, and its lanes' ``z_i = H(root || i)`` are the
    host twin's (the port's and the JAX package's), bit for bit, on a
    padded batch whose last shards hold padding only."""
    msgs, sigs, keys = _batch(13, seed=8, msg_len=40)
    n, padded = 13, 16
    mesh = MeshTopology(axes).build_mesh(device="cpu")
    leaf_blocks, leaf_nblocks = _pack_blocks(
        [_frame(m) + _frame(s) + _frame(a) for m, s, a in zip(msgs, sigs, keys)]
    )
    leaf_blocks = np.pad(leaf_blocks, ((0, 0),) * 3 + ((0, padded - n),))
    leaf_nblocks = np.pad(leaf_nblocks, (0, padded - n))
    per = padded // mesh.size
    leaves = [
        sh.digest_bytes(sh.sha512_blocks(*_to_device(
            [leaf_blocks[..., s * per:(s + 1) * per], leaf_nblocks[s * per:(s + 1) * per]],
            torch.device("cpu"),
        )))
        for s in range(mesh.size)
    ]
    zs = torch.cat(sharded_transcript(mesh, _Z_TAG, n, padded, leaves), dim=1)
    got = [int.from_bytes(bytes(zs[:, i].to(torch.uint8).tolist()), "little") for i in range(n)]
    want = _transcript_coefficients(msgs, sigs, keys)
    assert got == want == jax_transcript_coefficients(msgs, sigs, keys)


# --- against the JAX package's sharded engines (slow, as the JAX tests) ------------


@pytest.mark.slow
def test_sharded_fused_parity_with_the_jax_fused_engines():
    """``tests/test_fused.py:307``'s batches against the JAX package's fused
    engines.  Its sharded fused engines do not trace under the installed
    JAX (the SHA-512 scan's carry loses its ``shard_map`` varying axis,
    ``consensus_tpu/ops/sha512.py:182``; ``tests/test_fused.py::
    test_sharded_fused_parity`` fails the same way), so the port's sharded
    engines are held to its single-device fused engines, which its own
    tests hold to the sharded ones where they trace.  Slow: those engines'
    first compiles on the CPU."""
    from consensus_tpu.models.fused import FusedEd25519BatchVerifier as JaxStrict
    from consensus_tpu.models.fused import FusedEd25519RandomizedBatchVerifier as JaxRand

    kw = dict(min_device_batch=1, pad_to=8)
    jfused = JaxStrict(**kw)
    shard = ShardedFusedEd25519Verifier(mesh_for_shards(2, **CPU), **kw)
    for msgs, sigs, keys in _adversarial_waves():
        assert list(shard.verify_batch(msgs, sigs, keys)) == list(
            np.asarray(jfused.verify_batch(msgs, sigs, keys))
        )
    rkw = dict(min_device_batch=1, pad_to=8, min_randomized=8)
    jrand = JaxRand(**rkw)
    rshard = ShardedFusedEd25519RandomizedVerifier(mesh_for_shards(2, **CPU), **rkw)
    msgs, sigs, keys = _batch(8, seed=6)
    sigs = list(sigs)
    sigs[2] = _flip(sigs[2], 4)
    assert list(rshard.verify_batch(msgs, sigs, keys)) == list(
        np.asarray(jrand.verify_batch(msgs, sigs, keys))
    )
