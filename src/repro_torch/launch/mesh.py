"""Meshes: the shard mesh of the item-sharded routes and the training
meshes ``(data, model)`` and ``(pod, data, model)``.

The reference builds a ``jax.sharding.Mesh`` and runs its sharded regions
as ``shard_map`` from a single controller.  The port keeps the single
controller and drops the process group: a :class:`ShardMesh` is a grid of
devices over named axes, in row-major order, and a manual region runs its
body once per position of its manual axis, in turn, on that position's
device, with the collectives as explicit merges on the lead device
(:mod:`repro_torch.distributed.sharding`).  Several positions may share one
card, so one GPU serves a whole mesh at full width; with several GPUs
position i lies on ``cuda:i``.

Single pod:  ``(data=16, model=16)``.  Multi-pod: ``(pod=2, data=16,
model=16)``; the ``pod`` axis carries only data-parallel (optionally
PowerSGD-compressed) gradient traffic.

Functions, not module-level constants: importing this module touches no
device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch import resolve_device

AXIS = "model"


class ShardMesh:
    """Devices in row-major order over named axes.  ``mesh.shape[axis]`` is
    the axis's size, as on the reference's mesh, so call sites read the
    same; position 0's device is the lead, where the collectives merge.
    ``ShardMesh(devices)`` is the item shards' one-axis ``"model"`` mesh."""

    def __init__(self, devices: Sequence, axis=AXIS,
                 shape: Optional[Sequence[int]] = None):
        if not devices:
            raise ValueError("a shard mesh needs at least one device")
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        sizes = (len(devices),) if shape is None else tuple(shape)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"axes {names} do not fit shape {sizes}")
        if math.prod(sizes) != len(devices):
            raise ValueError(f"{len(devices)} devices for a mesh of shape "
                             f"{dict(zip(names, sizes))}")
        self.devices = tuple(resolve_device(d) for d in devices)
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def device_at(self, **coords: int) -> torch.device:
        """The device at the given coordinates (absent axes at 0)."""
        flat = 0
        for name in self.axis_names:
            flat = flat * self.shape[name] + coords.get(name, 0)
        return self.devices[flat]

    def axis_devices(self, axis: str):
        """One device per position of ``axis``: the first device of that
        position's block (every other coordinate 0), where a manual region
        over ``axis`` runs that position's body."""
        return tuple(self.device_at(**{axis: i})
                     for i in range(self.shape[axis]))

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        if len(self.axis_names) == 1:
            return (f"ShardMesh({[str(d) for d in self.devices]}, "
                    f"axis={self.axis_names[0]!r})")
        return f"ShardMesh({self.shape}, lead={self.lead})"


def _devices_for(n: int, devices: Optional[Sequence], what: str):
    """``devices``, or one GPU per position (``cuda:0 .. cuda:n-1``),
    raising when the host has fewer."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"{what} asks for one GPU per position ({n}) but {have} are "
                f"available; pass devices=['cuda:0'] * {n} to put the "
                "positions on one card")
        devices = [f"cuda:{i}" for i in range(n)]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} positions")
    return list(devices)


def make_mesh(n_shards: int, devices: Optional[Sequence] = None
              ) -> ShardMesh:
    """A one-axis mesh of ``n_shards`` shards.  ``devices=None`` asks for
    one GPU per shard (``cuda:0 .. cuda:n-1``) and raises when the host has
    fewer; several shards on one card, or the CPU, are asked for
    explicitly, as ``devices=["cuda:0"] * 4`` or ``["cpu"] * 4``."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    return ShardMesh(_devices_for(n_shards, devices,
                                  f"make_mesh({n_shards})"))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> ShardMesh:
    """``(data=16, model=16)``, or ``(pod=2, data=16, model=16)``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    return ShardMesh(_devices_for(n, devices, "make_production_mesh"),
                     axes, shape)


def make_test_mesh(*, multi_pod: bool = False,
                   devices: Optional[Sequence] = None) -> ShardMesh:
    """A small mesh over ``devices`` (by default every GPU of the host),
    split as the reference's: ``(data, model)`` with ``data`` the largest
    factor of n up to its square root, or with ``multi_pod`` 2 pods (when
    n is even) over such a split of the rest."""
    n = len(devices) if devices is not None else (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if n < 1:
        raise RuntimeError("make_test_mesh: no device (pass devices=)")
    devs = _devices_for(n, devices, "make_test_mesh")
    if multi_pod:
        pod = 2 if n % 2 == 0 and n >= 2 else 1
        rest = n // pod
        data = _largest_factor(rest)
        return ShardMesh(devs, ("pod", "data", "model"),
                         (pod, data, rest // data))
    data = _largest_factor(n)
    return ShardMesh(devs, ("data", "model"), (data, n // data))


def _largest_factor(n: int) -> int:
    f = int(n ** 0.5)
    while n % f:
        f -= 1
    return max(f, 1)
