"""The port's device mesh: the torch devices a sharded engine splits its
batch over, laid out by a topology's axes.

The JAX package builds a ``jax.sharding.Mesh`` and lets ``shard_map`` run
one program on every device of it.  The port has one process and no such
runtime, so a mesh is only the devices in row-major order
(:class:`DeviceMesh`) and the sharded engines
(:mod:`consensus_tpu_torch.parallel.sharding`) run each shard's slice on its
device themselves.  A device may appear more than once: ``[cuda:0] * 2``
is two virtual shards on one card, which split a wave and launch its
kernels once per shard on that card (ROADMAP.md, divergence 21).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from consensus_tpu_torch.device import DeviceLike, resolve_device

#: Virtual shards a CPU mesh offers when no device list is given: the
#: counterpart of the 8 virtual CPU devices the JAX package's tests run
#: their meshes on.
CPU_VIRTUAL_SHARDS = 8


def visible_devices(device: DeviceLike = None) -> list[torch.device]:
    """The devices a mesh takes when given no list: every visible card for
    ``cuda`` (the default; raises with no card), or
    :data:`CPU_VIRTUAL_SHARDS` virtual shards for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.type == "cpu":
        return [torch.device("cpu")] * CPU_VIRTUAL_SHARDS
    raise ValueError(f"no mesh over {dev.type} devices")


def mesh_devices(devices: Optional[Sequence] = None, device: DeviceLike = None) -> list[torch.device]:
    """``devices`` as torch devices, each checked like an engine's device
    (a ``cuda`` entry raises with no card, or past the visible cards), all
    of one type; without a list, :func:`visible_devices` of ``device``."""
    if devices is None:
        return visible_devices(device)
    out = [resolve_device(d) for d in devices]
    for d in out:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(
                f"mesh device {d} is not visible ({torch.cuda.device_count()} card(s))"
            )
    if len({d.type for d in out}) > 1:
        raise ValueError(f"a mesh holds devices of one type, got {[str(d) for d in out]}")
    if device is not None and out and resolve_device(device).type != out[0].type:
        raise ValueError(f"device {device} disagrees with the mesh's {out[0].type} devices")
    return out


class DeviceMesh:
    """Devices laid out by a topology's ``axes``, with its ``axis_names``.

    ``devices`` is a numpy object array of :class:`torch.device` shaped by
    the axes (so ``mesh.devices.shape == (2, 4)`` and ``.size`` read as on
    a JAX mesh); ``shape`` maps each axis name to its size, and
    :meth:`shard_devices` lists the shards' devices in row-major order,
    the order every engine slices its batch in."""

    def __init__(self, devices: Sequence[torch.device], axes: Sequence[int],
                 axis_names: Sequence[str]) -> None:
        axes = tuple(int(a) for a in axes)
        arr = np.empty(len(devices), dtype=object)
        arr[:] = list(devices)
        self.devices = arr.reshape(axes)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def shard_devices(self) -> list[torch.device]:
        return list(self.devices.flat)

    def key(self) -> tuple:
        """What identifies the mesh in the compiled-kernel memo."""
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat))

    def __repr__(self) -> str:
        return f"DeviceMesh({dict(self.shape)}, {[str(d) for d in self.devices.flat]})"


__all__ = ["CPU_VIRTUAL_SHARDS", "DeviceMesh", "mesh_devices", "visible_devices"]
