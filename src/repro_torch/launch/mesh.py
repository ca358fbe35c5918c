"""The shard mesh of the item-sharded routes.

The reference builds a ``jax.sharding.Mesh`` and runs its sharded routes
as one ``shard_map`` from a single controller.  The port keeps the single
controller and drops the process group: a :class:`ShardMesh` is an
ordered tuple of devices on one axis, ``"model"``, and a sharded route runs
each shard's body on that shard's device from the calling thread, with the
collectives as explicit merges on the lead device
(:mod:`repro_torch.distributed.sharding`).  Several shards may share one
card, so one GPU serves S = 2 or 4 at full width; with several GPUs shard i
lies on ``cuda:i``.

A function, not a module-level constant: importing this module touches no
device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import resolve_device

AXIS = "model"


class ShardMesh:
    """Devices in shard order on one axis.  ``mesh.shape[axis]`` is the
    shard count, as on the reference's mesh, so call sites read the same;
    shard 0's device is the lead, where the collectives merge."""

    def __init__(self, devices: Sequence, axis: str = AXIS):
        if not devices:
            raise ValueError("a shard mesh needs at least one device")
        self.devices = tuple(resolve_device(d) for d in devices)
        self.axis_names = (axis,)
        self.shape = {axis: len(self.devices)}

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"ShardMesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_names[0]!r})")


def make_mesh(n_shards: int, devices: Optional[Sequence] = None
              ) -> ShardMesh:
    """A mesh of ``n_shards`` shards.  ``devices=None`` asks for one GPU
    per shard (``cuda:0 .. cuda:n-1``) and raises when the host has fewer;
    several shards on one card, or the CPU, are asked for explicitly, as
    ``devices=["cuda:0"] * 4`` or ``["cpu"] * 4``."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_shards:
            raise RuntimeError(
                f"make_mesh({n_shards}) asks for one GPU per shard but "
                f"{have} are available; pass devices=['cuda:0'] * "
                f"{n_shards} to put the shards on one card")
        devices = [f"cuda:{i}" for i in range(n_shards)]
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    return ShardMesh(devices)
