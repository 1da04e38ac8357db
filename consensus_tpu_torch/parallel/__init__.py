"""Multi-device sharding of the crypto batch path (torch port of
``consensus_tpu/parallel/__init__.py``).

Re-exports resolve lazily (PEP 562), as in the JAX package: the topology
surface (``MeshTopology``, ``topology_for_config``, ``apply_compile_cache``,
the padding helpers) imports nothing of the engines, while the sharded
engines in :mod:`consensus_tpu_torch.parallel.sharding` load the model
modules only when first touched.
"""

_TOPOLOGY_NAMES = frozenset(
    {
        "BATCH_AXIS",
        "MeshTopology",
        "apply_compile_cache",
        "engine_padded_size",
        "mesh_padded_size",
        "topology_for_config",
    }
)

_SHARDING_NAMES = frozenset(
    {
        "ShardedEcdsaP256Verifier",
        "ShardedEd25519RandomizedVerifier",
        "ShardedEd25519Verifier",
        "ShardedFusedEd25519RandomizedVerifier",
        "ShardedFusedEd25519Verifier",
        "clear_compiled_kernels",
        "compiled_kernel",
        "make_mesh",
        "mesh_for_shards",
        "sharded_batch_verify_fn",
        "sharded_fused_aggregate_fn",
        "sharded_fused_verify_fn",
        "sharded_p256_verify_fn",
        "sharded_verify_fn",
    }
)

__all__ = sorted(_TOPOLOGY_NAMES | _SHARDING_NAMES)


def __getattr__(name: str):
    if name in _TOPOLOGY_NAMES:
        from consensus_tpu_torch.parallel import topology

        return getattr(topology, name)
    if name in _SHARDING_NAMES:
        from consensus_tpu_torch.parallel import sharding

        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
