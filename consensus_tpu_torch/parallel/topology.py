"""Device topologies for the sharded batch engines (torch port of
``consensus_tpu/parallel/topology.py``).

:class:`MeshTopology` generalizes ``Configuration.mesh_shards`` from a 1-D
device count to a named N-D device mesh: ``MeshTopology((2, 4))`` lays the
first 8 devices out as a ``("slice", "batch")`` mesh, while
``MeshTopology((8,))`` -- and the ``mesh_shards=8`` sugar that normalizes to
it -- builds the 1-D ``("batch",)`` mesh.

The verification workload is pure data parallelism, so every engine splits
its batch dimension over ALL mesh axes, in row-major order, and reduces once;
a 2-D topology changes only the device layout, never the per-lane math or
the verdict.

The port's copy of the JAX module: every helper and the topology class are
the JAX code, apart from :meth:`MeshTopology.build_mesh`, which builds the
port's :class:`~consensus_tpu_torch.parallel.mesh.DeviceMesh` of torch
devices, and :func:`apply_compile_cache`, which is inert (both listed in
``tests/test_torch_copies.py``'s divergences).  Nothing here imports torch
at import time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

#: The trailing mesh axis every kernel shards its batch dimension over (the
#: leading axes of an N-D topology join it via the full axis-name tuple).
BATCH_AXIS = "batch"

TopologySpec = Union["MeshTopology", int, str, Sequence[int], None]


def mesh_padded_size(n: int, n_shards: int, minimum: int = 8) -> int:
    """Pow-2 growth for compile-shape reuse, then rounded UP to a multiple
    of the mesh size — terminates for any shard count (a pure doubling loop
    never exits for non-power-of-two meshes)."""
    size = minimum
    while size < n:
        size *= 2
    size += (-size) % n_shards
    return size


def engine_padded_size(
    n: int,
    n_shards: int,
    *,
    pad_to: int = 0,
    pad_pow2: bool = True,
    minimum: int = 8,
) -> int:
    """Mesh-aligned padded batch size honouring the engine's padding knobs
    (``pad_to`` pins one compiled shape, ``pad_pow2`` grows by doubling),
    then rounded UP to a multiple of the mesh size so every shard gets an
    equal slice."""
    if pad_to >= n:
        size = pad_to
    elif pad_pow2:
        size = minimum
        while size < n:
            size *= 2
    else:
        size = max(n, 1)
    size += (-size) % n_shards
    return size


def _default_axis_names(ndim: int) -> tuple:
    if ndim == 1:
        return (BATCH_AXIS,)
    if ndim == 2:
        return ("slice", BATCH_AXIS)
    return tuple(f"slice{i}" for i in range(ndim - 1)) + (BATCH_AXIS,)


@dataclass(frozen=True)
class MeshTopology:
    """A named device-mesh layout for the sharded engines.

    ``axes`` are per-axis device counts (product = total shard count);
    ``axis_names`` name them, defaulting to ``("batch",)`` for 1-D and
    ``("slice", "batch")`` for 2-D, so ``MeshTopology((n,))`` is exactly
    the mesh ``mesh_shards=n`` always built.
    """

    axes: tuple = (1,)
    axis_names: Optional[tuple] = None

    def __post_init__(self) -> None:
        axes = tuple(int(a) for a in self.axes)
        if not axes or any(a < 1 for a in axes):
            raise ValueError(
                f"topology axes must be a non-empty tuple of positive device "
                f"counts, got {self.axes!r}"
            )
        names = self.axis_names
        names = _default_axis_names(len(axes)) if names is None else tuple(names)
        if len(names) != len(axes) or len(set(names)) != len(names):
            raise ValueError(
                f"axis_names {names!r} must be distinct and match axes {axes!r}"
            )
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "axis_names", names)

    # -- identity ----------------------------------------------------------

    @property
    def shard_count(self) -> int:
        """Total devices the topology spans (the batch is sharded this many
        ways regardless of how the axes factor it)."""
        count = 1
        for a in self.axes:
            count *= a
        return count

    @property
    def ndim(self) -> int:
        return len(self.axes)

    @property
    def label(self) -> str:
        """Canonical spelling — ``"8"`` for 1-D, ``"2x4"`` for 2-D — used in
        bench sweep keys, ``last_good`` JSON, and registry errors."""
        return "x".join(str(a) for a in self.axes)

    # -- construction ------------------------------------------------------

    @classmethod
    def parse(cls, text: str) -> "MeshTopology":
        """``"8"`` -> ``(8,)``; ``"2x4"`` -> ``(2, 4)`` (the CLI seam)."""
        try:
            axes = tuple(int(part) for part in str(text).split("x"))
        except ValueError:
            raise ValueError(
                f"cannot parse topology {text!r} (want e.g. '8' or '2x4')"
            ) from None
        return cls(axes)

    @classmethod
    def normalize(cls, spec: TopologySpec) -> "MeshTopology":
        """Coerce every accepted spelling to a :class:`MeshTopology`:
        ``None`` -> single device, int ``n`` (the ``mesh_shards`` sugar) ->
        ``(n,)``, a string via :meth:`parse`, a sequence of axis sizes
        verbatim."""
        if isinstance(spec, cls):
            return spec
        if spec is None:
            return cls((1,))
        if isinstance(spec, int):
            if spec < 1:
                raise ValueError(f"mesh_shards must be >= 1, got {spec}")
            return cls((spec,))
        if isinstance(spec, str):
            return cls.parse(spec)
        return cls(tuple(spec))

    def build_mesh(self, devices: Optional[Sequence] = None, *, device=None):
        """A :class:`~consensus_tpu_torch.parallel.mesh.DeviceMesh` laying
        the first ``shard_count`` devices out as ``axes``.

        ``devices`` is an explicit list of torch devices and may repeat one
        (``[cuda:0] * 2`` is two virtual shards on one card); without it the
        mesh takes the visible devices of ``device``'s type (every visible
        card for ``cuda``, the default; 8 virtual shards for ``cpu``).  Fails
        loudly when fewer devices are visible than the spec demands: the
        mesh never shrinks, and never moves to the CPU on its own."""
        from consensus_tpu_torch.parallel.mesh import DeviceMesh, mesh_devices

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


def topology_for_config(config) -> MeshTopology:
    """The topology a ``Configuration`` selects: ``mesh_topology`` when set,
    else the ``mesh_shards`` 1-D sugar."""
    axes = tuple(getattr(config, "mesh_topology", ()) or ())
    if axes:
        return MeshTopology(axes)
    return MeshTopology.normalize(int(getattr(config, "mesh_shards", 1) or 1))


def apply_compile_cache(cache) -> None:
    """Inert in the port, as ``Configuration.compile_cache`` is (ROADMAP.md,
    divergence 14): there is no jit cache to configure, and the kernel
    libraries are cached on disk by their source's hash whatever ``cache``
    says.  Kept so the JAX package's callers find it."""
    return None


__all__ = [
    "BATCH_AXIS",
    "MeshTopology",
    "apply_compile_cache",
    "engine_padded_size",
    "mesh_padded_size",
    "topology_for_config",
]
