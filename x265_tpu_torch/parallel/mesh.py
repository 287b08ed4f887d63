"""Device mesh construction (x265 ThreadPool/NUMA-pool analog).

Axes of the full design:
  frames — frame-pipeline axis (frame parallelism)
  tile   — intra-frame CTU-band axis (WPP rows / slices)

`Mesh` is the port's counterpart of jax.sharding.Mesh: a numpy object
array of torch devices with one name an axis. A mesh may name one device
several times (tiles.make_tile_mesh(n, devices=[dev] * n)): the port's
counterpart of XLA's virtual host devices, on which bands, halos and the
frame-cost sum run as they would across cards, without the copies
between cards.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """devices: a (nested) sequence of devices; axis_names: one name an
    axis of it. `devices` reads back as a numpy object array of
    torch.device (`mesh.devices.size`, `.shape`, `.flat` as in JAX);
    `shape` maps each axis name to its size."""

    def __init__(self, devices, axis_names):
        shape = np.shape(np.asarray(devices, dtype=object))
        arr = np.empty(shape, dtype=object)
        for idx in np.ndindex(shape):
            d = devices
            for i in idx:
                d = d[i]
            arr[idx] = torch.device(d)
        axis_names = tuple(axis_names)
        if len(axis_names) != arr.ndim:
            raise ValueError(f"{len(axis_names)} axis names for a mesh of "
                             f"{arr.ndim} axes")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def device_key(d) -> torch.device:
    """The device with its index spelled out ("cuda" is the current CUDA
    device): two names of one device compare equal as keys."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _cuda_devices(n: int):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def make_tile_mesh(n_devices: int) -> Mesh:
    """The first n_devices CUDA devices on the `tile` axis; raises
    RuntimeError when the machine has fewer."""
    return Mesh(_cuda_devices(n_devices), ("tile",))


def make_frame_tile_mesh(n_frames: int, n_tiles: int) -> Mesh:
    """n_frames x n_tiles CUDA devices on the (`frames`, `tile`) axes;
    raises RuntimeError when the machine has fewer."""
    devs = _cuda_devices(n_frames * n_tiles)
    return Mesh([devs[i * n_tiles:(i + 1) * n_tiles]
                 for i in range(n_frames)], ("frames", "tile"))
