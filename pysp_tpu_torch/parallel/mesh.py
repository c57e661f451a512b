"""The device mesh of batched and row-sharded develops.

Counterpart of ``pysp_tpu/parallel/mesh.py``: a ('batch', 'spatial') grid of
devices, where the batch axis splits a burst's frames and the spatial axis
one frame's rows. The JAX mesh has one controller; so has this one: one
process drives every position (``shard.shard_map`` runs a thread for each).

A device may stand at several positions, as XLA's virtual CPU devices do in
the JAX package's tests: the shards at those positions share it (on a CUDA
device, each on its own stream). So a mesh of ``["cpu"] * 8`` runs the JAX
tests' eight-device layouts on the CPU, and ``[torch.device("cuda:0")] * 4``
four shards on one card.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..core.device import resolve_device

BATCH_AXIS = "batch"
SPATIAL_AXIS = "spatial"
AXIS_NAMES = (BATCH_AXIS, SPATIAL_AXIS)


def _canonical(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA device with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A (batch, spatial) grid of ``torch.device``.

    ``shape`` maps each axis name to its size, as a JAX mesh's does;
    ``device_at(batch, spatial)`` is the device of one position and
    ``devices`` every position's, row by row."""

    axis_names = AXIS_NAMES

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        rows = [[_canonical(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        self._rows = rows
        self.shape = {BATCH_AXIS: len(rows), SPATIAL_AXIS: len(rows[0])}

    @property
    def size(self) -> int:
        return self.shape[BATCH_AXIS] * self.shape[SPATIAL_AXIS]

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(d for row in self._rows for d in row)

    def device_at(self, batch: int, spatial: int) -> torch.device:
        return self._rows[batch][spatial]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('batch', 'spatial') mesh.

    ``devices`` defaults to every visible CUDA device, and raises without
    one: there is no fall-back to the CPU (pass ``devices=["cpu"] * n`` for a
    CPU mesh). A device named more than once stands at several positions.
    With no shape, all devices go to the batch axis (the common
    burst-develop case)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh takes the visible CUDA devices by default, but none is "
                "present (torch.cuda.is_available() is False). Pass devices=['cpu'] * n "
                "for a mesh on the CPU."
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_canonical(d) for d in devices]
    if shape is None:
        shape = (len(devices), 1)
    need = shape[0] * shape[1]
    if need > len(devices) or need < 1:
        raise ValueError(f"mesh shape {shape} needs {need} devices")
    n_sp = shape[1]
    return Mesh([devices[b * n_sp:(b + 1) * n_sp] for b in range(shape[0])])
