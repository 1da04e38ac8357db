"""The port's copies of the JAX package's JAX-free modules stay copies.

Each module below is the JAX module with ``consensus_tpu.`` imports renamed
to ``consensus_tpu_torch.``.  With the rename undone:

- every module's code (its AST, docstrings left out) equals the JAX
  module's, apart from the divergences listed in ``DIVERGENCES``;
- the verbatim copies' text, comments included, equals the JAX module's
  outside the module docstring (where the port says whose copy it is).

The reworded copies differ from the JAX text in comments and docstrings
only (they speak of the device where the JAX text speaks of the TPU).
The test reads both files and imports neither.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "consensus_tpu_torch"
JAX = ROOT / "consensus_tpu"

VERBATIM = [
    "api/__init__.py",
    "consensus.py",
    "core/__init__.py",
    "core/batcher.py",
    "core/collector.py",
    "core/controller.py",
    "core/heartbeat.py",
    "core/pool.py",
    "core/state.py",
    "core/view.py",
    "core/viewchanger.py",
    "deploy/__init__.py",
    "deploy/autoscaler.py",
    "deploy/control.py",
    "deploy/identity.py",
    "deploy/invariants.py",
    "deploy/launcher.py",
    "deploy/replica_main.py",
    "deploy/sidecar_main.py",
    "deploy/spec.py",
    "deploy/supervisor.py",
    "groups/__init__.py",
    "groups/chaos.py",
    "groups/cluster.py",
    "groups/deploy.py",
    "groups/directory.py",
    "groups/router.py",
    "groups/twopc.py",
    "ingress/__init__.py",
    "ingress/admission.py",
    "ingress/driver.py",
    "ingress/placement.py",
    "ingress/workload.py",
    "membership/__init__.py",
    "membership/bootstrap.py",
    "membership/epoch.py",
    "net/__init__.py",
    "net/framing.py",
    "net/sidecar.py",
    "net/transport.py",
    "obs/detectors.py",
    "obs/export.py",
    "obs/flightrec.py",
    "obs/sampler.py",
    "sync/__init__.py",
    "sync/client.py",
    "sync/server.py",
    "sync/store.py",
    "sync/transport.py",
    "testing/adversary.py",
    "testing/app.py",
    "testing/chaos.py",
    "testing/faults.py",
    "testing/fuzz.py",
    "testing/invariants.py",
    "testing/membership.py",
    "testing/network.py",
    "testing/storage.py",
    "trace/export.py",
    "trace/report.py",
    "trace/tracer.py",
    "types.py",
    "utils/__init__.py",
    "utils/blacklist.py",
    "utils/digests.py",
    "utils/leader.py",
    "utils/quorum.py",
    "wal/__init__.py",
    "wal/log.py",
    "wal/scrub.py",
    "wire/__init__.py",
    "wire/codec.py",
    "wire/messages.py",
]
REWORDED = [
    "api/deps.py", "config.py", "deploy/chaos.py", "deploy/driver_main.py", "metrics.py",
    "parallel/__init__.py", "parallel/topology.py", "testing/crypto_app.py",
]

#: The divergences the port keeps on purpose, each as pairs of (the JAX
#: text, the port's text in its place).
DIVERGENCES = {
    # ROADMAP.md queue C, divergence 20: the chaos engine builds its crypto
    # engines on a device the caller names (``cuda`` when it names none).
    "testing/chaos.py": [
        (
            """        device_faults: tuple = (),
    ) -> None:""",
            """        device_faults: tuple = (),
        device=None,
    ) -> None:""",
        ),
        (
            """        ``"ed25519"`` when unset.\"\"\"
""",
            """        ``"ed25519"`` when unset.

        ``device`` is where the engines this constructor builds for a crypto
        run live (``cuda`` unless the caller names one); an
        ``engine_factory`` places its own engine.\"\"\"
""",
        ),
        (
            """        self.engine_factory = engine_factory
""",
            """        self.engine_factory = engine_factory
        self.device = device
""",
        ),
        (
            """                min_device_batch=10**9, min_randomized=2
            )
        else:
            engine = Ed25519BatchVerifier(min_device_batch=10**9)
""",
            """                min_device_batch=10**9, min_randomized=2, device=self.device
            )
        else:
            engine = Ed25519BatchVerifier(
                min_device_batch=10**9, device=self.device
            )
""",
        ),
    ],
    # ROADMAP.md queue C, divergence 25: the rig's mains take ``--device``
    # (``cuda`` when it is not given), the launcher passes it to every
    # child when it is named, and the sharded cluster's fleet drives build
    # their default engine on the device it names, resolved only then.
    "deploy/sidecar_main.py": [
        (
            """    ap.add_argument("--sidecar-id", required=True)
    args = ap.parse_args()
""",
            """    ap.add_argument("--sidecar-id", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
""",
        ),
        (
            """    engine = _CountingEngine(Ed25519BatchVerifier(min_device_batch=10**9))
""",
            """    engine = _CountingEngine(
        Ed25519BatchVerifier(min_device_batch=10**9, device=args.device)
    )
""",
        ),
    ],
    "deploy/replica_main.py": [
        (
            """    ap.add_argument("--node-id", type=int, required=True)
    args = ap.parse_args()
""",
            """    ap.add_argument("--node-id", type=int, required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
""",
        ),
        (
            """    host_engine = Ed25519BatchVerifier(min_device_batch=10**9)
""",
            """    host_engine = Ed25519BatchVerifier(min_device_batch=10**9, device=args.device)
""",
        ),
    ],
    "deploy/launcher.py": [
        (
            """        spawn_sidecars: bool = True,
    ) -> None:
""",
            """        spawn_sidecars: bool = True,
        device: Optional[str] = None,
    ) -> None:
""",
        ),
        (
            """        self.spawn_sidecars = spawn_sidecars
""",
            """        self.spawn_sidecars = spawn_sidecars
        #: The device the children's engines live on, passed as
        #: ``--device``; unset, the children resolve ``cuda``.
        self.device = device
""",
        ),
        (
            """            "--config", self.spec.config_path, "--node-id", str(node_id),
        ]
""",
            """            "--config", self.spec.config_path, "--node-id", str(node_id),
        ] + self._device_argv()
""",
        ),
        (
            """            "--config", self.spec.config_path, "--sidecar-id", sidecar_id,
        ]
""",
            """            "--config", self.spec.config_path, "--sidecar-id", sidecar_id,
        ] + self._device_argv()

    def _device_argv(self) -> list:
        return [] if self.device is None else ["--device", str(self.device)]
""",
        ),
    ],
    "groups/cluster.py": [
        (
            """        check_durability: bool = True,
    ) -> None:
        if n_groups < 1:
            raise ValueError("need at least one group")
        self.seed = seed
""",
            """        check_durability: bool = True,
        device=None,
    ) -> None:
        if n_groups < 1:
            raise ValueError("need at least one group")
        self.seed = seed
        #: Where the fleet drives' default engines live (``cuda`` unless
        #: named); resolved only when a drive builds one.
        self.device = device
""",
        ),
        (
            """            engine if engine is not None else _host_engine()
""",
            """            engine if engine is not None else _host_engine(self.device)
""",
        ),
        (
            """        factory = engine_factory if engine_factory is not None else _host_engine
""",
            """        factory = (
            engine_factory if engine_factory is not None
            else lambda: _host_engine(self.device)
        )
""",
        ),
        (
            """def _host_engine():
    from consensus_tpu.models.ed25519 import Ed25519BatchVerifier

    return Ed25519BatchVerifier(min_device_batch=10**9)
""",
            """def _host_engine(device=None):
    from consensus_tpu.models.ed25519 import Ed25519BatchVerifier

    return Ed25519BatchVerifier(min_device_batch=10**9, device=device)
""",
        ),
    ],
    # ROADMAP.md divergence 21: the port's mesh is its own DeviceMesh of
    # torch devices (virtual shards by an explicit device list, 8 virtual
    # CPU shards), and the compile cache is inert (divergence 14).
    "parallel/topology.py": [
        (
            """    def build_mesh(self, devices: Optional[Sequence] = None):
        \"\"\"A ``jax.sharding.Mesh`` laying the first ``shard_count`` visible
        devices out as ``axes``.  1-D topologies build byte-identical meshes
        to the historical ``mesh_for_shards`` (same device order, same
        ``("batch",)`` axis name).  Fails loudly when the host exposes fewer
        devices than the spec demands — silently shrinking the mesh would
        make the compiled kernel shape depend on deploy-time topology — and
        when a multi-host slice would be partially covered (every process
        must participate in the same global mesh).\"\"\"
        import jax
        import numpy as np
        from jax.sharding import Mesh

        devices = list(devices if devices is not None else jax.devices())
        count = self.shard_count
        if len(devices) < count:
            raise ValueError(
                f"topology {self.label} needs {count} devices but only "
                f"{len(devices)} device(s) visible (set XLA_FLAGS="
                "--xla_force_host_platform_device_count for a host mesh, "
                "or shrink the topology)"
            )
        if jax.process_count() > 1 and count != len(devices):
            raise ValueError(
                f"topology {self.label} covers {count} of "
                f"{len(devices)} global devices on a "
                f"{jax.process_count()}-process slice; multi-host meshes "
                "must span the whole slice (every process participates)"
            )
        arr = np.array(devices[:count])
        if self.ndim > 1:
            arr = arr.reshape(self.axes)
        return Mesh(arr, self.axis_names)
""",
            """    def build_mesh(self, devices: Optional[Sequence] = None, *, device=None):
        \"\"\"A :class:`~consensus_tpu.parallel.mesh.DeviceMesh` laying
        the first ``shard_count`` devices out as ``axes``.

        ``devices`` is an explicit list of torch devices and may repeat one
        (``[cuda:0] * 2`` is two virtual shards on one card); without it the
        mesh takes the visible devices of ``device``'s type (every visible
        card for ``cuda``, the default; 8 virtual shards for ``cpu``).  Fails
        loudly when fewer devices are visible than the spec demands: the
        mesh never shrinks, and never moves to the CPU on its own.\"\"\"
        from consensus_tpu.parallel.mesh import DeviceMesh, mesh_devices

        devices = mesh_devices(devices, device)
        count = self.shard_count
        if len(devices) < count:
            raise ValueError(
                f"topology {self.label} needs {count} devices but only "
                f"{len(devices)} device(s) visible (name the shards' devices "
                "in an explicit list, one card repeated for virtual shards, "
                "or shrink the topology)"
            )
        return DeviceMesh(devices[:count], self.axes, self.axis_names)
""",
        ),
        (
            """def apply_compile_cache(cache) -> None:
    \"\"\"Wire a ``CompileCacheConfig``'s persistent-cache knobs into
    ``jax.config`` (idempotent; repeated calls with the same values are
    no-ops inside jax).  ``persistent_dir=""`` leaves the runtime default
    untouched — the in-process memo works either way.\"\"\"
    if cache is None or not getattr(cache, "persistent_dir", ""):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", cache.persistent_dir)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs",
        float(getattr(cache, "min_compile_time_secs", 1.0)),
    )
    # Cache every entry regardless of serialized size: correctness work like
    # this repo's is dominated by many small-but-slow-to-trace kernels.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
""",
            """def apply_compile_cache(cache) -> None:
    \"\"\"Inert in the port, as ``Configuration.compile_cache`` is (ROADMAP.md,
    divergence 14): there is no jit cache to configure, and the kernel
    libraries are cached on disk by their source's hash whatever ``cache``
    says.  Kept so the JAX package's callers find it.\"\"\"
    return None
""",
        ),
    ],
    # The engine bundle's compile-cache keys are exported as well (the
    # port's engine layer books them, models/verifier.py).
    "metrics.py": [
        (
            """    "ENGINE_RUNG_KEY",
    "ENGINE_KEYS",
""",
            """    "ENGINE_RUNG_KEY",
    "ENGINE_COMPILE_CACHE_HITS_KEY",
    "ENGINE_COMPILE_CACHE_MISSES_KEY",
    "ENGINE_KEYS",
""",
        ),
    ],
}
# Divergence 14 (``compile_cache`` inert in the port) is a comment and a
# warning in models/verifier.py, not a code difference in config.py.


def _sources(module: str) -> tuple[str, str]:
    """(the port's source with the rename undone, the JAX source with the
    listed divergence applied)."""
    port = (PORT / module).read_text().replace("consensus_tpu_torch", "consensus_tpu")
    jax_src = (JAX / module).read_text()
    for old, new in DIVERGENCES.get(module, ()):
        assert jax_src.count(old) == 1, f"{module}: the JAX text of the divergence moved"
        assert port.count(new) == 1, f"{module}: the port's text of the divergence moved"
        jax_src = jax_src.replace(old, new)
    return port, jax_src


def _code(source: str) -> str:
    """The AST of ``source`` without its docstrings."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def _outside_module_docstring(source: str) -> list[str]:
    lines = source.splitlines()
    doc = ast.parse(source).body[0]
    assert isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant)
    return lines[:doc.lineno - 1] + lines[doc.end_lineno:]


@pytest.mark.parametrize("module", VERBATIM + REWORDED)
def test_copy_has_the_jax_modules_code(module):
    port, jax_src = _sources(module)
    assert _code(port) == _code(jax_src)


@pytest.mark.parametrize("module", VERBATIM)
def test_verbatim_copy_has_the_jax_modules_text(module):
    port, jax_src = _sources(module)
    assert _outside_module_docstring(port) == _outside_module_docstring(jax_src)


def test_every_copy_is_listed():
    """Every port module whose JAX namesake it copies whole is listed; the
    rest of the port (the engine layer, the kernels, the package
    ``__init__`` files that export less) is its own code."""
    own = {
        "__init__.py", "device.py", "trace/__init__.py",
        "testing/__init__.py", "parallel/mesh.py", "parallel/sharding.py",
    }
    own_dirs = {"models", "ops", "obs", "runtime", "csrc"}
    listed = set(VERBATIM) | set(REWORDED)
    for path in PORT.rglob("*.py"):
        rel = path.relative_to(PORT).as_posix()
        if rel in own or rel.split("/")[0] in own_dirs:
            continue
        assert rel in listed, f"{rel} is neither a listed copy nor the port's own"
