"""The port's multi-device engines (``consensus_tpu_torch/parallel/``) held
against the JAX package's on the CPU: the cases of ``tests/test_mesh.py``
and the strict mesh case of ``tests/test_crypto.py:716-723``.

The port's CPU mesh has 8 virtual shards, the counterpart of the 8 virtual
CPU devices ``tests/conftest.py`` gives the JAX package; each shard runs the
plain torch versions.  Verdicts are compared with tolerance 0: the port's
sharded engines give exactly the JAX sharded engines' verdicts, and the
single engines', on the same seeded batch.  The P-256, randomized and
fused lanes are in ``tests/test_torch_mesh_lanes.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from consensus_tpu.config import Configuration as JaxConfiguration
from consensus_tpu.models import verifier as jver
from consensus_tpu.parallel import MeshTopology as JaxMeshTopology
from consensus_tpu.parallel import ShardedEd25519Verifier as JaxShardedEd25519Verifier
from consensus_tpu.parallel import engine_padded_size as jax_engine_padded_size
from consensus_tpu.parallel import make_mesh as jax_make_mesh
from consensus_tpu.parallel import mesh_padded_size as jax_mesh_padded_size
from consensus_tpu_torch.config import CompileCacheConfig, Configuration
from consensus_tpu_torch.models import Ed25519BatchVerifier, Ed25519Signer
from consensus_tpu_torch.models.ecdsa_p256 import EcdsaP256BatchVerifier
from consensus_tpu_torch.models.ed25519 import Ed25519RandomizedBatchVerifier
from consensus_tpu_torch.models.engine import _slice_wave_target
from consensus_tpu_torch.models.registry import (
    ENGINE_REGISTRY,
    MODES,
    TOPOLOGIES,
    EngineKey,
    UnknownEngineError,
    engine_key_for,
)
from consensus_tpu_torch.models.verifier import engine_for_config
from consensus_tpu_torch.obs.kernels import COMPILE_CACHE, KERNELS
from consensus_tpu_torch.parallel import (
    MeshTopology,
    ShardedEcdsaP256Verifier,
    ShardedEd25519RandomizedVerifier,
    ShardedEd25519Verifier,
    clear_compiled_kernels,
    engine_padded_size,
    make_mesh,
    mesh_for_shards,
    mesh_padded_size,
)
from consensus_tpu_torch.parallel import sharding

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' tensors here are a few lanes wide: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_sigs(n, corrupt=(), seed=0):
    """``n`` signatures of 4 signers whose seeds come from ``seed``, the
    lanes in ``corrupt`` zeroed (tests/test_mesh.py's batch)."""
    rng = np.random.default_rng(seed)
    signers = [Ed25519Signer(i, rng.integers(0, 256, 32, dtype=np.uint8).tobytes()) for i in range(4)]
    msgs, sigs, keys = [], [], []
    for i in range(n):
        s = signers[i % len(signers)]
        m = b"mesh-req-%d" % i
        msgs.append(m)
        sigs.append(s.sign_raw(m))
        keys.append(s.public_bytes)
    for i in corrupt:
        sigs[i] = bytes(64)
    return msgs, sigs, keys


def jax_sharded_verdicts(topology: dict, msgs, sigs, keys) -> np.ndarray:
    """The JAX package's sharded strict engine's verdicts over ``topology``
    on the 8 virtual CPU devices."""
    engine = jver.engine_for_config(JaxConfiguration(crypto_tpu_min_batch=1, **topology))
    assert isinstance(engine, JaxShardedEd25519Verifier)
    return np.asarray(engine.verify_batch(msgs, sigs, keys))


# --- padding / mesh construction -------------------------------------------


def test_engine_padded_size_honours_knobs_and_shard_multiple():
    assert engine_padded_size(5, 1) == 8
    assert engine_padded_size(13, 8) == 16
    assert engine_padded_size(9, 8) == 16
    assert engine_padded_size(5, 4, pad_to=12) == 12
    assert engine_padded_size(10, 8, pad_pow2=False) == 16
    assert engine_padded_size(10, 5, pad_pow2=False) == 10
    # The copied helpers equal the JAX package's over a grid.
    for n in range(0, 70, 3):
        for shards in (1, 2, 3, 5, 8):
            assert mesh_padded_size(n, shards) == jax_mesh_padded_size(n, shards)
            for pad_to in (0, 12, 64):
                for pow2 in (True, False):
                    assert engine_padded_size(n, shards, pad_to=pad_to, pad_pow2=pow2) == \
                        jax_engine_padded_size(n, shards, pad_to=pad_to, pad_pow2=pow2)


def test_mesh_for_shards_errors_are_loud():
    mesh = mesh_for_shards(8, **CPU)
    assert mesh.devices.size == 8  # the CPU's virtual shards
    with pytest.raises(ValueError, match="only 8 device"):
        mesh_for_shards(9, **CPU)
    with pytest.raises(ValueError, match="mesh_shards"):
        mesh_for_shards(0, **CPU)
    # An explicit list may repeat a device: virtual shards on one device.
    assert [str(d) for d in mesh_for_shards(2, ["cpu"] * 2).shard_devices()] == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="one type"):
        make_mesh(["cpu", "meta"])


def test_config_validates_mesh_shards():
    with pytest.raises(ValueError, match="mesh_shards"):
        Configuration(self_id=1, mesh_shards=0).validate()
    Configuration(self_id=1, mesh_shards=8).validate()


# --- engine selection matrix ------------------------------------------------


def test_engine_for_config_selects_the_full_matrix():
    base = Configuration()
    assert type(engine_for_config(base, **CPU)) is Ed25519BatchVerifier
    assert type(
        engine_for_config(dataclasses.replace(base, batch_verify_mode=True), **CPU)
    ) is Ed25519RandomizedBatchVerifier
    assert type(engine_for_config(base, curve="p256", **CPU)) is EcdsaP256BatchVerifier

    sharded = engine_for_config(dataclasses.replace(base, mesh_shards=4), **CPU)
    assert type(sharded) is ShardedEd25519Verifier
    assert sharded.mesh.devices.size == 4 and sharded.device.type == "cpu"
    rand = engine_for_config(dataclasses.replace(base, mesh_shards=2, batch_verify_mode=True), **CPU)
    assert type(rand) is ShardedEd25519RandomizedVerifier
    assert rand.mesh.devices.size == 2
    p256 = engine_for_config(dataclasses.replace(base, mesh_shards=8), curve="p256", **CPU)
    assert type(p256) is ShardedEcdsaP256Verifier

    with pytest.raises(ValueError, match="Ed25519-only"):
        engine_for_config(dataclasses.replace(base, batch_verify_mode=True), curve="p256", **CPU)
    with pytest.raises(ValueError, match="unknown curve"):
        engine_for_config(base, curve="ed448", **CPU)


def test_engine_for_config_threads_pad_and_min_batch_knobs():
    cfg = dataclasses.replace(
        Configuration(), mesh_shards=8, crypto_tpu_min_batch=7, crypto_pad_pow2=False
    )
    eng = engine_for_config(cfg, **CPU)
    assert eng._min_device_batch == 7
    assert eng._pad_pow2 is False


def test_the_card_is_the_default_and_a_mesh_never_falls_back(monkeypatch):
    """With no device named the mesh takes the visible cards; with none (or
    too few) it raises -- it neither shrinks nor moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_for_shards(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_for_config(Configuration(mesh_shards=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        mesh_for_shards(2)
    with pytest.raises(ValueError, match="not visible"):
        mesh_for_shards(2, ["cuda:0", "cuda:1"])
    assert [str(d) for d in mesh_for_shards(2, ["cuda:0"] * 2).shard_devices()] == [
        "cuda:0", "cuda:0",
    ]


# --- exact parity: 8-way CPU mesh vs single device and the JAX mesh ---------


def test_sharded_strict_parity_on_8_way_host_mesh():
    """``engine_for_config(mesh_shards=8)`` returns the EXACT verdicts of
    the single-device engine and of the JAX package's 8-device engine, on a
    batch that is not a multiple of the shard count and carries invalid
    lanes."""
    cfg = dataclasses.replace(Configuration(), mesh_shards=8, crypto_tpu_min_batch=1)
    sharded_engine = engine_for_config(cfg, **CPU)
    assert isinstance(sharded_engine, ShardedEd25519Verifier)
    msgs, sigs, keys = make_sigs(13, corrupt=(3, 9))
    sharded = sharded_engine.verify_batch(msgs, sigs, keys)
    single = Ed25519BatchVerifier(min_device_batch=1, **CPU).verify_batch(msgs, sigs, keys)
    assert sharded.dtype == bool and (sharded == single).all()
    assert list(np.flatnonzero(~sharded)) == [3, 9]
    assert (sharded == jax_sharded_verdicts(dict(mesh_shards=8), msgs, sigs, keys)).all()


def test_sharded_matches_single_device():
    """``tests/test_crypto.py``'s mesh case: 12 lanes, lane 5 zeroed, over
    every visible shard (``make_mesh()``), against the single engine and the
    JAX package's ``ShardedEd25519Verifier(make_mesh())``."""
    msgs, sigs, keys = make_sigs(12, seed=1)
    bad = list(sigs)
    bad[5] = bytes(64)
    mesh = make_mesh(**CPU)
    assert mesh.devices.size == 8
    sharded = ShardedEd25519Verifier(mesh).verify_batch(msgs, bad, keys)
    single = Ed25519BatchVerifier(**CPU).verify_batch(msgs, bad, keys)
    assert (sharded == single).all()
    assert sharded.sum() == 11 and not sharded[5]
    theirs = JaxShardedEd25519Verifier(jax_make_mesh()).verify_batch(msgs, bad, keys)
    assert (sharded == np.asarray(theirs)).all()


def test_launches_one_body_per_shard_per_wave(monkeypatch):
    """One ledger entry per wave under the JAX package's name; every shard
    runs its body (on the card each launches D1, B1 and D2 once)."""
    calls = []
    real = sharding.verify_impl

    def counting_impl(*args):
        calls.append(args[0].shape[-1])
        return real(*args)

    monkeypatch.setattr(sharding, "verify_impl", counting_impl)
    clear_compiled_kernels()  # the body binds verify_impl when it is built
    eng = ShardedEd25519Verifier(mesh_for_shards(2, **CPU), min_device_batch=1)
    msgs, sigs, keys = make_sigs(6)
    before = KERNELS.stats("ed25519.sharded_verify").launches
    assert eng.verify_batch(msgs, sigs, keys).all()
    assert KERNELS.stats("ed25519.sharded_verify").launches == before + 1
    assert calls == [4, 4]  # 6 signatures padded to 8 lanes, 4 a shard
    clear_compiled_kernels()  # drop the body bound to the counting impl


# --- mesh_shards=1 is bit-for-bit the single engine ---------------------------


def test_mesh_shards_one_chaos_run_is_bit_for_bit_identical():
    """A chaos schedule run with the engine ``engine_for_config(mesh_shards=1)``
    builds is byte-identical to the default engine construction, and to the
    JAX package's run of the same schedule."""
    from consensus_tpu.testing import chaos as jchaos
    from consensus_tpu_torch.testing.chaos import ChaosEngine, ChaosSchedule

    schedule = ChaosSchedule.generate(31, n=4, steps=6)
    baseline = ChaosEngine(schedule, crypto="ed25519", **CPU).run()
    cfg = dataclasses.replace(Configuration(), mesh_shards=1, crypto_tpu_min_batch=10**9)
    routed = ChaosEngine(
        schedule, crypto="ed25519", engine_factory=lambda: engine_for_config(cfg, **CPU),
    ).run()
    assert baseline.ok and routed.ok
    assert routed.ledgers == baseline.ledgers
    assert routed.event_log == baseline.event_log
    theirs = jchaos.ChaosEngine(jchaos.ChaosSchedule.generate(31, n=4, steps=6),
                                crypto="ed25519").run()
    assert routed.event_log == theirs.event_log and routed.ledgers == theirs.ledgers


# --- topologies: parse/normalize sugar and 2-D meshes ------------------------


def test_topology_normalize_parse_and_sugar():
    assert MeshTopology.parse("2x4").axes == (2, 4)
    assert MeshTopology.parse("8").axes == (8,)
    assert MeshTopology.normalize(8) == MeshTopology((8,))
    assert MeshTopology.normalize(None) == MeshTopology((1,))
    assert MeshTopology.normalize("2x2").shard_count == 4
    assert MeshTopology((2, 4)).label == "2x4"
    assert MeshTopology((8,)).label == "8"
    assert MeshTopology((2, 4)).axis_names == JaxMeshTopology((2, 4)).axis_names
    assert MeshTopology((2, 2, 2)).axis_names == JaxMeshTopology((2, 2, 2)).axis_names
    with pytest.raises(ValueError, match="cannot parse topology"):
        MeshTopology.parse("2xbatch")
    with pytest.raises(ValueError, match="needs 16 devices"):
        MeshTopology((4, 4)).build_mesh(device="cpu")
    mesh = MeshTopology((2, 4)).build_mesh(device="cpu")
    assert mesh.devices.shape == (2, 4) and mesh.shape == {"slice": 2, "batch": 4}


def test_2d_topology_strict_parity_on_2x4_host_mesh():
    """A (2, 4) named 2-D mesh returns the EXACT verdicts of the single
    engine and of the JAX package's (2, 4) engine."""
    cfg = dataclasses.replace(Configuration(), mesh_topology=(2, 4), crypto_tpu_min_batch=1)
    eng = engine_for_config(cfg, **CPU)
    assert isinstance(eng, ShardedEd25519Verifier)
    assert eng.mesh.devices.shape == (2, 4)
    assert eng.shard_count == 8
    msgs, sigs, keys = make_sigs(13, corrupt=(3, 9))
    sharded = eng.verify_batch(msgs, sigs, keys)
    single = Ed25519BatchVerifier(min_device_batch=1, **CPU).verify_batch(msgs, sigs, keys)
    assert (sharded == single).all()
    assert list(np.flatnonzero(~sharded)) == [3, 9]
    assert (sharded == jax_sharded_verdicts(dict(mesh_topology=(2, 4)), msgs, sigs, keys)).all()


def test_config_validates_mesh_topology_and_compile_cache():
    Configuration(self_id=1, mesh_shards=8, mesh_topology=(2, 4)).validate()
    with pytest.raises(ValueError, match="axes product must equal"):
        Configuration(self_id=1, mesh_shards=4, mesh_topology=(2, 4)).validate()
    with pytest.raises(ValueError, match="axes must all be >= 1"):
        Configuration(self_id=1, mesh_topology=(2, 0)).validate()
    with pytest.raises(ValueError, match="min_compile_time_secs"):
        Configuration(
            self_id=1, compile_cache=CompileCacheConfig(min_compile_time_secs=-1.0)
        ).validate()


# --- engine registry: every advertised key resolves or fails loud ------------


def test_engine_registry_completeness_and_loud_failures():
    for key in ENGINE_REGISTRY.keys():
        assert key in ENGINE_REGISTRY
        assert callable(ENGINE_REGISTRY.builder(key))
    # Every cell of the advertised matrix, the mxu axis included, is
    # registered or refuses with the curve-specific reason (the Ed25519-only
    # lanes; P-256 x mxu), as in the JAX package.
    for curve in ENGINE_REGISTRY.curves():
        for mode in MODES:
            for topo in TOPOLOGIES:
                for prep in (False, True):
                    for mxu in (False, True):
                        key = EngineKey(curve, mode, topo, prep, mxu)
                        if key in ENGINE_REGISTRY:
                            assert curve == "ed25519" or not mxu
                            continue
                        with pytest.raises(UnknownEngineError) as exc:
                            ENGINE_REGISTRY.builder(key)
                        assert "Ed25519-only" in str(exc.value)
    assert EngineKey("ed25519", "randomized", "mesh", True) in ENGINE_REGISTRY
    assert EngineKey("p256", "strict", "mesh") in ENGINE_REGISTRY
    with pytest.raises(UnknownEngineError, match="unknown curve"):
        ENGINE_REGISTRY.builder(EngineKey(curve="ed448"))
    with pytest.raises(ValueError, match="already registered"):
        ENGINE_REGISTRY.register(EngineKey(), lambda **kw: None)
    # The degrade ladder of the widest key walks mesh -> single -> host prep.
    ladder = ENGINE_REGISTRY.degrade_keys(EngineKey("ed25519", "randomized", "mesh", True))
    assert [(k.topology, k.device_prep) for k in ladder] == [
        ("mesh", True), ("single", True), ("single", False),
    ]


def test_engine_registry_mxu_axis(monkeypatch):
    """``tests/test_mesh.py:299-331``: every Ed25519 cell exists under
    ``mxu=True`` but refuses to build unless ``CTPU_MXU_LIMBS=1`` selects
    the lane, ``engine_key_for`` derives the axis from the environment, and
    the degrade ladder keeps it."""
    mxu_key = EngineKey("ed25519", "strict", "single", False, True)
    assert mxu_key in ENGINE_REGISTRY
    monkeypatch.delenv("CTPU_MXU_LIMBS", raising=False)
    with pytest.raises(RuntimeError, match="CTPU_MXU_LIMBS"):
        ENGINE_REGISTRY.build(mxu_key, **CPU)
    assert engine_key_for(Configuration()).mxu is False
    monkeypatch.setenv("CTPU_MXU_LIMBS", "1")
    assert engine_key_for(Configuration()).mxu is True
    assert type(ENGINE_REGISTRY.build(mxu_key, **CPU)) is Ed25519BatchVerifier
    mesh_key = EngineKey("ed25519", "strict", "mesh", False, True)
    assert ENGINE_REGISTRY.build(mesh_key, **CPU).shard_count == 8
    fused_mesh = EngineKey("ed25519", "randomized", "mesh", True, True)
    ladder = ENGINE_REGISTRY.degrade_keys(fused_mesh)
    assert len(ladder) == 3  # mesh -> single, fused -> host prep
    assert all(k.mxu for k in ladder)
    assert all(k in ENGINE_REGISTRY for k in ladder)


# --- the compiled-kernel memo: rebuilds book zero new compiles ---------------


def test_engine_rebuild_books_zero_new_compiles_with_cache_on():
    """Rebuilding the same sharded engine over the same mesh reuses the
    process-wide body memo: a hit in ``COMPILE_CACHE`` and ZERO new compiles
    in the kernel ledger (its ``compiles`` count nvcc builds, and the kernel
    libraries are loaded once per process; a body is no build).  Another
    mesh is another body: a miss."""
    clear_compiled_kernels()
    cfg = dataclasses.replace(Configuration(), mesh_shards=8, crypto_tpu_min_batch=1)
    engine_for_config(cfg, **CPU)
    booked = KERNELS.totals()["compiles"]
    hits0 = COMPILE_CACHE.snapshot()["hits"]
    rebuilt = engine_for_config(cfg, **CPU)
    assert KERNELS.totals()["compiles"] == booked
    assert KERNELS.stats("ed25519.sharded_verify").compiles == 0
    assert COMPILE_CACHE.snapshot()["hits"] == hits0 + 1
    assert rebuilt._fn is engine_for_config(cfg, **CPU)._fn
    misses = COMPILE_CACHE.snapshot()["misses"]
    ShardedEd25519Verifier(MeshTopology((2, 4)), **CPU)
    assert COMPILE_CACHE.snapshot()["misses"] == misses + 1
    assert KERNELS.totals()["compiles"] == booked


# --- slice-filling wave formation --------------------------------------------


def test_slice_wave_target_fills_whole_slices():
    class MeshEngine:
        shard_count = 4
        preferred_wave_size = 32

    class NoPreference:
        shard_count = 4
        preferred_wave_size = 0

    assert _slice_wave_target(MeshEngine(), 256) == 32
    assert _slice_wave_target(MeshEngine(), 16) == 16
    assert _slice_wave_target(NoPreference(), 256) == 256
    assert _slice_wave_target(Ed25519BatchVerifier(**CPU), 256) == 256


def test_preferred_wave_size_is_a_whole_slice_multiple():
    eng = engine_for_config(
        dataclasses.replace(Configuration(), mesh_shards=8, crypto_tpu_min_batch=1), **CPU
    )
    assert eng.preferred_wave_size % eng.shard_count == 0
    assert eng.preferred_wave_size >= eng.shard_count
    assert Ed25519BatchVerifier(min_device_batch=5, **CPU).preferred_wave_size == 8
    # The JAX engine's wave size for the same knobs.
    jeng = jver.engine_for_config(
        JaxConfiguration(mesh_shards=8, crypto_tpu_min_batch=3, crypto_pad_pow2=False)
    )
    port = engine_for_config(
        Configuration(mesh_shards=8, crypto_tpu_min_batch=3, crypto_pad_pow2=False), **CPU
    )
    assert port.preferred_wave_size == jeng.preferred_wave_size == 24


def test_engine_for_config_routes_mesh_through_supervision():
    """``tests/test_supervisor.py:337-347``: a supervised mesh engine's
    ladder is mesh -> single device -> host, each rung labelled."""
    cfg = Configuration().with_(engine_supervision=True, engine_crosscheck_interval=4, mesh_shards=2)
    sup = engine_for_config(cfg, **CPU)
    assert [sup.rung_label(i) for i in range(sup.rung_count)] == [
        "ShardedEd25519Verifier[2]", "Ed25519BatchVerifier", "HostTwin",
    ]
    assert sup.shard_count == 2
    jsup = jver.engine_for_config(JaxConfiguration().with_(
        engine_supervision=True, engine_crosscheck_interval=4, mesh_shards=2,
    ))
    assert [jsup.rung_label(i) for i in range(jsup.rung_count)] == [
        sup.rung_label(i) for i in range(sup.rung_count)
    ]
