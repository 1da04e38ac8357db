"""The port's engine registry, routing and pinned metric names held against
the JAX package's.

``consensus_tpu_torch.models.registry`` against
``consensus_tpu.models.registry``: the two register the same keys, every
one builds in the port (an ``mxu`` key only under ``CTPU_MXU_LIMBS=1``,
and refuses without it in the JAX package's words), and every refusal
carries the JAX text exactly; ``engine_key_for`` and
``degrade_ladder_configs`` equal the JAX package's over a grid of
configurations; the engine-layer metric names (``ENGINE_KEYS``,
``GROUPS_KEYS``) and the names a fresh ``Metrics`` creates equal the JAX
package's and the pinned Prometheus golden's.
"""

import dataclasses
from pathlib import Path

import pytest

from consensus_tpu import metrics as jmetrics
from consensus_tpu.config import Configuration as JaxConfiguration
from consensus_tpu.models import registry as jreg
from consensus_tpu.models import verifier as jver
from consensus_tpu_torch import metrics as tmetrics
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.models import registry as treg
from consensus_tpu_torch.models import verifier as tver
from consensus_tpu_torch.models.ecdsa_p256 import EcdsaP256BatchVerifier
from consensus_tpu_torch.models.ed25519 import (
    Ed25519BatchVerifier,
    Ed25519RandomizedBatchVerifier,
)
from consensus_tpu_torch.models.fused import (
    FusedEd25519BatchVerifier,
    FusedEd25519RandomizedBatchVerifier,
)
from consensus_tpu_torch.models.registry import (
    ENGINE_REGISTRY,
    MODES,
    TOPOLOGIES,
    EngineKey,
    UnknownEngineError,
    engine_key_for,
)
from consensus_tpu_torch.obs.kernels import COMPILE_CACHE, KERNELS
from consensus_tpu_torch.parallel import (
    ShardedEcdsaP256Verifier,
    ShardedEd25519RandomizedVerifier,
    ShardedEd25519Verifier,
    ShardedFusedEd25519RandomizedVerifier,
    ShardedFusedEd25519Verifier,
)

GOLDEN = Path(__file__).resolve().parent / "golden" / "obs_prometheus_3node.txt"


def _matrix():
    for curve in ("ed25519", "p256"):
        for mode in MODES:
            for topo in TOPOLOGIES:
                for prep in (False, True):
                    for mxu in (False, True):
                        yield curve, mode, topo, prep, mxu


def test_registry_completeness_and_loud_failures():
    """The JAX package's completeness case on the port's registry: every
    cell is registered or refuses with the Ed25519-only reason, and the
    registered keys are the JAX registry's, in its order."""
    for key in ENGINE_REGISTRY.keys():
        assert key in ENGINE_REGISTRY and callable(ENGINE_REGISTRY.builder(key))
    assert set(ENGINE_REGISTRY.keys()) == {
        EngineKey(curve, mode, topo, prep, mxu)
        for topo in TOPOLOGIES
        for curve, mode, prep, mxu in (
            ("ed25519", "strict", False, False), ("ed25519", "randomized", False, False),
            ("ed25519", "strict", True, False), ("ed25519", "randomized", True, False),
            ("ed25519", "strict", False, True), ("ed25519", "randomized", False, True),
            ("ed25519", "strict", True, True), ("ed25519", "randomized", True, True),
            ("p256", "strict", False, False),
        )
    }
    assert [dataclasses.astuple(k) for k in ENGINE_REGISTRY.keys()] == [
        dataclasses.astuple(k) for k in jreg.ENGINE_REGISTRY.keys()
    ]
    for cell in _matrix():
        key = EngineKey(*cell)
        if key in ENGINE_REGISTRY:
            continue
        with pytest.raises(UnknownEngineError) as exc:
            ENGINE_REGISTRY.builder(key)
        assert "Ed25519-only" in str(exc.value)
    with pytest.raises(UnknownEngineError, match="unknown curve"):
        ENGINE_REGISTRY.builder(EngineKey(curve="ed448"))
    with pytest.raises(ValueError, match="already registered"):
        ENGINE_REGISTRY.register(EngineKey(), lambda **kw: None)
    with pytest.raises(ValueError, match="mode must be"):
        EngineKey(mode="fast")


@pytest.mark.parametrize("cell", list(_matrix()), ids=lambda c: "-".join(map(str, c)))
def test_every_jax_key_builds_or_names_its_queue_item(cell, monkeypatch):
    """Every cell the JAX registry has builds in the port (the tensor-core
    lane's under ``CTPU_MXU_LIMBS=1``; without it both refuse in the same
    words), and every cell it refuses, the port refuses with its text."""
    jkey, tkey = jreg.EngineKey(*cell), EngineKey(*cell)
    monkeypatch.delenv("CTPU_MXU_LIMBS", raising=False)
    if jkey not in jreg.ENGINE_REGISTRY:
        # A cell JAX refuses: the port refuses it with the same words.
        with pytest.raises(jreg.UnknownEngineError) as jax_err:
            jreg.ENGINE_REGISTRY.builder(jkey)
        with pytest.raises(UnknownEngineError) as port_err:
            ENGINE_REGISTRY.builder(tkey)
        assert str(port_err.value) == str(jax_err.value)
        return
    assert tkey in ENGINE_REGISTRY
    if tkey.mxu:
        with pytest.raises(RuntimeError) as jax_err:
            jreg.ENGINE_REGISTRY.build(jkey, topology=None, compile_cache=False)
        with pytest.raises(RuntimeError) as port_err:
            ENGINE_REGISTRY.build(tkey, device="cpu")
        assert str(port_err.value) == str(jax_err.value)
        monkeypatch.setenv("CTPU_MXU_LIMBS", "1")
    engine = ENGINE_REGISTRY.build(tkey, pad_pow2=True, min_device_batch=16, device="cpu")
    want = {
        ("ed25519", "strict", False): Ed25519BatchVerifier,
        ("ed25519", "randomized", False): Ed25519RandomizedBatchVerifier,
        ("ed25519", "strict", True): FusedEd25519BatchVerifier,
        ("ed25519", "randomized", True): FusedEd25519RandomizedBatchVerifier,
        ("p256", "strict", False): EcdsaP256BatchVerifier,
    }[(tkey.curve, tkey.mode, tkey.device_prep)]
    if tkey.topology == "mesh":
        # The sharded class of the JAX package's name, over a 1-D mesh
        # of the CPU's 8 virtual shards.
        want = {
            Ed25519BatchVerifier: ShardedEd25519Verifier,
            Ed25519RandomizedBatchVerifier: ShardedEd25519RandomizedVerifier,
            FusedEd25519BatchVerifier: ShardedFusedEd25519Verifier,
            FusedEd25519RandomizedBatchVerifier: ShardedFusedEd25519RandomizedVerifier,
            EcdsaP256BatchVerifier: ShardedEcdsaP256Verifier,
        }[want]
        assert engine.shard_count == 8
    assert type(engine) is want and engine.device.type == "cpu"


def test_p256_refusals_through_engine_for_config_carry_the_jax_text():
    for knobs in (dict(batch_verify_mode=True), dict(device_prep=True)):
        with pytest.raises(UnknownEngineError) as port_err:
            tver.engine_for_config(Configuration(**knobs), curve="p256", device="cpu")
        with pytest.raises(jreg.UnknownEngineError) as jax_err:
            jver.engine_for_config(JaxConfiguration(self_id=1, **knobs), curve="p256")
        assert str(port_err.value) == str(jax_err.value)


def _grid():
    for mesh_shards, mesh_topology in ((1, ()), (2, ()), (4, ()), (1, (1,)), (1, (2, 4)), (8, (2, 4))):
        for device_prep in (False, True):
            for batch_verify_mode in (False, True):
                for supervision in (False, True):
                    yield dict(
                        mesh_shards=mesh_shards, mesh_topology=mesh_topology,
                        device_prep=device_prep, batch_verify_mode=batch_verify_mode,
                        engine_supervision=supervision,
                    )


_LADDER_FIELDS = ("mesh_shards", "mesh_topology", "device_prep", "batch_verify_mode")


@pytest.mark.parametrize("mxu", ["", "1"])
def test_engine_key_for_matches_jax_over_a_grid(monkeypatch, mxu):
    monkeypatch.setenv("CTPU_MXU_LIMBS", mxu)
    for knobs in _grid():
        for curve in ("ed25519", "p256"):
            port = engine_key_for(Configuration(**knobs), curve)
            jax = jreg.engine_key_for(JaxConfiguration(self_id=1, **knobs), curve)
            assert dataclasses.astuple(port) == dataclasses.astuple(jax), knobs


def test_degrade_ladder_configs_match_jax_where_the_port_builds():
    """Equal ladders for every config of the grid (every one builds in the
    port since the mesh lanes are ported), and each builds its engine."""
    built = 0
    for knobs in _grid():
        port_ladder = tver.degrade_ladder_configs(Configuration(**knobs))
        jax_ladder = jver.degrade_ladder_configs(JaxConfiguration(self_id=1, **knobs))
        assert port_ladder[0] == Configuration(**knobs)
        assert engine_key_for(Configuration(**knobs)) in ENGINE_REGISTRY
        assert [tuple(getattr(c, f) for f in _LADDER_FIELDS) for c in port_ladder] == [
            tuple(getattr(c, f) for f in _LADDER_FIELDS) for c in jax_ladder
        ]
        engine = tver.engine_for_config(Configuration(**knobs), device="cpu")
        assert engine is not None
        built += 1
    # Strict and randomized, host prep and fused, supervised or not, over
    # the grid's six topologies (1, 2, 4, (1,), (2, 4) and 8 as (2, 4)).
    assert built == 48


def test_mxu_keys_are_refused_from_the_environment(monkeypatch):
    """``CTPU_MXU_LIMBS=1`` selects the ``mxu`` key: ``engine_for_config``
    builds the lane's engine, whose device calls book under the ``_mxu``
    names, and refuses P-256 in the JAX package's words."""
    monkeypatch.setenv("CTPU_MXU_LIMBS", "1")
    engine = tver.engine_for_config(Configuration(), device="cpu")
    assert type(engine) is Ed25519BatchVerifier
    assert engine_key_for(Configuration()).mxu
    signer = tver.Ed25519Signer(1, bytes(range(32)))
    before = KERNELS.stats("ed25519.verify_mxu").launches
    plain = KERNELS.stats("ed25519.verify").launches
    msgs = [b"m%d" % i for i in range(16)]
    got = engine.verify_batch(msgs, [signer.sign_raw(m) for m in msgs], [signer.public_bytes] * 16)
    assert got.tolist() == [True] * 16
    assert KERNELS.stats("ed25519.verify_mxu").launches == before + 1
    assert KERNELS.stats("ed25519.verify").launches == plain
    with pytest.raises(UnknownEngineError) as port_err:
        tver.engine_for_config(Configuration(), curve="p256", device="cpu")
    assert str(port_err.value) == jreg.ENGINE_REGISTRY._missing_reason(
        jreg.EngineKey("p256", mxu=True)
    )


def test_engine_for_config_books_the_kernel_builds_it_triggers(monkeypatch):
    """``metrics`` books the construction's library loads and builds; the
    CPU builds nothing, so a stand-in builder plays the card's nvcc."""
    provider = tmetrics.InMemoryProvider()
    metrics = tmetrics.Metrics(provider)
    tver.engine_for_config(Configuration(), device="cpu", metrics=metrics)
    dump = provider.dump()
    assert dump[tmetrics.ENGINE_COMPILE_CACHE_HITS_KEY]["value"] == 0
    assert dump[tmetrics.ENGINE_COMPILE_CACHE_MISSES_KEY]["value"] == 0

    def card_like(**kw):
        COMPILE_CACHE.record(hit=False)
        COMPILE_CACHE.record(hit=True)
        return Ed25519BatchVerifier(**kw)

    builders = dict(ENGINE_REGISTRY._builders)
    builders[EngineKey()] = card_like
    monkeypatch.setattr(ENGINE_REGISTRY, "_builders", builders)
    tver.engine_for_config(Configuration(), device="cpu", metrics=metrics)
    dump = provider.dump()
    assert dump[tmetrics.ENGINE_COMPILE_CACHE_HITS_KEY]["value"] == 1
    assert dump[tmetrics.ENGINE_COMPILE_CACHE_MISSES_KEY]["value"] == 1


def test_engine_for_config_warns_that_compile_cache_is_inert():
    """``compile_cache`` is kept for parity and read by nothing in the port,
    so setting it to anything but its default warns; the default does not."""
    import warnings

    from consensus_tpu_torch.config import CompileCacheConfig

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tver.engine_for_config(Configuration(), device="cpu")
    for cache in (CompileCacheConfig(enabled=False), CompileCacheConfig(persistent_dir="cache")):
        with pytest.warns(UserWarning, match="compile_cache.*no effect in the PyTorch port"):
            engine = tver.engine_for_config(Configuration(compile_cache=cache), device="cpu")
        assert isinstance(engine, Ed25519BatchVerifier)


def test_engine_metric_names_match_jax_and_the_golden():
    assert tmetrics.ENGINE_KEYS == jmetrics.ENGINE_KEYS
    assert tmetrics.GROUPS_KEYS == jmetrics.GROUPS_KEYS
    port, jax = tmetrics.InMemoryProvider(), jmetrics.InMemoryProvider()
    tmetrics.Metrics(port, label_names=("node",))
    jmetrics.Metrics(jax, label_names=("node",))
    names = set(port.dump())
    assert set(tmetrics.ENGINE_KEYS + tmetrics.GROUPS_KEYS) <= names
    assert names == set(jax.dump())
    golden = {
        line.split()[2] for line in GOLDEN.read_text().splitlines() if line.startswith("# TYPE ")
    }
    assert set(tmetrics.ENGINE_KEYS) <= golden
    # Labelled children bind like the JAX package's: the bundle binds the
    # embedder's label, the supervisor binds the fault class.
    bound = tmetrics.Metrics(port, label_names=("node",)).with_labels("3")
    bound.engine.count_degrade.with_labels("launch_raise").add(1)
    assert port.dump()["engine_degrade_total{launch_raise,3}"]["value"] == 1


def test_registry_module_names_match_jax():
    assert treg.MODES == jreg.MODES and treg.TOPOLOGIES == jreg.TOPOLOGIES
    assert [f.name for f in dataclasses.fields(EngineKey)] == [
        f.name for f in dataclasses.fields(jreg.EngineKey)
    ]
    assert issubclass(UnknownEngineError, ValueError)
    assert Configuration().crypto_batch_window == JaxConfiguration().crypto_batch_window == 0.002
