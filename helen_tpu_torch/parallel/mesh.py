"""Device-mesh construction helpers (port of helen_tpu/parallel/mesh.py).

A mesh is a 2-D ("data", "model") grid of the devices of one process: the
data axis splits each batch's rows, the model axis each GRU layer's hidden
units and each head's input (parallel.sharding). The device list may name
one device more than once (``["cuda:0", "cuda:0"]``, ``["cpu", "cpu"]``):
the split then runs for real on the one device, its shards exchanging the
hidden state as they would between devices.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def mesh_shape_for(n_devices: int, model_parallel: int = 1) -> Tuple[int, int]:
    """(data, model) mesh shape: model axis bounded by n_devices."""
    model_parallel = max(1, min(model_parallel, n_devices))
    while n_devices % model_parallel != 0:
        model_parallel -= 1
    return n_devices // model_parallel, model_parallel


class Mesh:
    """A (data, model) grid of torch devices: ``devices[d][m]`` runs model
    shard ``m`` of data shard ``d``; ``shape`` maps each axis name to its
    size, as a ``jax.sharding.Mesh`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str] = ("data", "model")):
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def local_devices(device) -> list:
    """The devices of this process of the kind of ``device``: every visible
    GPU for a CUDA device, the CPU for the CPU (helen_tpu's
    ``jax.local_devices()``)."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(
    devices: Optional[Sequence] = None,
    model_parallel: int = 1,
    axis_names: Tuple[str, str] = ("data", "model"),
) -> Mesh:
    """Build a 2-D ("data", "model") mesh over the given (default: every
    visible GPU) devices. model_parallel=1 gives pure data parallelism."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else local_devices("cuda"))
    dp, mp = mesh_shape_for(len(devices), model_parallel)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, mp), axis_names)
