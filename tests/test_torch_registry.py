"""The port's engine registry, routing and pinned metric names held against
the JAX package's.

``consensus_tpu_torch.models.registry`` against
``consensus_tpu.models.registry``: every key of the JAX registry either
builds in the port or is refused naming its ROADMAP.md queue A item; the
P-256 refusals carry the JAX text exactly; ``engine_key_for`` and
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
from consensus_tpu_torch.obs.kernels import COMPILE_CACHE

GOLDEN = Path(__file__).resolve().parent / "golden" / "obs_prometheus_3node.txt"
_ITEMS = {"mesh": "item 12", "mxu": "item 13"}


def _matrix():
    for curve in ("ed25519", "p256"):
        for mode in MODES:
            for topo in TOPOLOGIES:
                for prep in (False, True):
                    for mxu in (False, True):
                        yield curve, mode, topo, prep, mxu


def test_registry_completeness_and_loud_failures():
    """The JAX package's completeness case on the port's registry: every
    cell is registered or refuses, Ed25519-only refusals keep the JAX
    reason, and every other refusal names the lane's queue A item."""
    for key in ENGINE_REGISTRY.keys():
        assert key in ENGINE_REGISTRY and callable(ENGINE_REGISTRY.builder(key))
    assert set(ENGINE_REGISTRY.keys()) == {
        EngineKey("ed25519", "strict"), EngineKey("ed25519", "randomized"), EngineKey("p256"),
        EngineKey("ed25519", "strict", device_prep=True),
        EngineKey("ed25519", "randomized", device_prep=True),
    }
    for cell in _matrix():
        key = EngineKey(*cell)
        if key in ENGINE_REGISTRY:
            continue
        with pytest.raises(UnknownEngineError) as exc:
            ENGINE_REGISTRY.builder(key)
        assert "Ed25519-only" in str(exc.value) or "ROADMAP.md queue A" in str(exc.value)
    with pytest.raises(UnknownEngineError, match="unknown curve"):
        ENGINE_REGISTRY.builder(EngineKey(curve="ed448"))
    with pytest.raises(ValueError, match="already registered"):
        ENGINE_REGISTRY.register(EngineKey(), lambda **kw: None)
    with pytest.raises(ValueError, match="mode must be"):
        EngineKey(mode="fast")


@pytest.mark.parametrize("cell", list(_matrix()), ids=lambda c: "-".join(map(str, c)))
def test_every_jax_key_builds_or_names_its_queue_item(cell):
    jkey, tkey = jreg.EngineKey(*cell), EngineKey(*cell)
    if jkey not in jreg.ENGINE_REGISTRY:
        # A cell JAX refuses: the port refuses it with the same words.
        with pytest.raises(jreg.UnknownEngineError) as jax_err:
            jreg.ENGINE_REGISTRY.builder(jkey)
        with pytest.raises(UnknownEngineError) as port_err:
            ENGINE_REGISTRY.builder(tkey)
        assert str(port_err.value) == str(jax_err.value)
        return
    if tkey in ENGINE_REGISTRY:
        engine = ENGINE_REGISTRY.build(tkey, pad_pow2=True, min_device_batch=16, device="cpu")
        want = {
            ("ed25519", "strict", False): Ed25519BatchVerifier,
            ("ed25519", "randomized", False): Ed25519RandomizedBatchVerifier,
            ("ed25519", "strict", True): FusedEd25519BatchVerifier,
            ("ed25519", "randomized", True): FusedEd25519RandomizedBatchVerifier,
            ("p256", "strict", False): EcdsaP256BatchVerifier,
        }[(tkey.curve, tkey.mode, tkey.device_prep)]
        assert type(engine) is want and engine.device.type == "cpu"
        return
    with pytest.raises(UnknownEngineError) as exc:
        ENGINE_REGISTRY.builder(tkey)
    lanes = [axis for axis, on in (("mesh", tkey.topology == "mesh"), ("mxu", tkey.mxu)) if on]
    assert lanes
    for axis in lanes:
        assert f"ROADMAP.md queue A, {_ITEMS[axis]}" in str(exc.value)


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
    """Equal ladders for every config whose engine the port builds (their
    ladder is the config alone); a config naming a lane not ported is
    refused with the lane's item, whatever the JAX ladder below it."""
    built = 0
    for knobs in _grid():
        port_ladder = tver.degrade_ladder_configs(Configuration(**knobs))
        jax_ladder = jver.degrade_ladder_configs(JaxConfiguration(self_id=1, **knobs))
        assert port_ladder[0] == Configuration(**knobs)
        if engine_key_for(Configuration(**knobs)) in ENGINE_REGISTRY:
            assert [tuple(getattr(c, f) for f in _LADDER_FIELDS) for c in port_ladder] == [
                tuple(getattr(c, f) for f in _LADDER_FIELDS) for c in jax_ladder
            ]
            engine = tver.engine_for_config(Configuration(**knobs), device="cpu")
            assert engine is not None
            built += 1
        else:
            with pytest.raises(UnknownEngineError, match="ROADMAP.md queue A, item 12"):
                tver.engine_for_config(Configuration(**knobs), device="cpu")
    # Strict and randomized, host prep and fused, supervised or not, at
    # mesh_shards 1 with mesh_topology () and (1,).
    assert built == 16


def test_mxu_keys_are_refused_from_the_environment(monkeypatch):
    monkeypatch.setenv("CTPU_MXU_LIMBS", "1")
    with pytest.raises(UnknownEngineError, match="item 13"):
        tver.engine_for_config(Configuration(), device="cpu")
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
