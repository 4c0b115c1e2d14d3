"""The device mesh: a list of torch devices that the term axis is split over.

Counterpart of ``symmer_tpu/parallel/mesh.py``.  symmer_tpu lays a 1-D
``jax.sharding.Mesh`` over the term axis, and one process drives every shard
(its drivers gather the shards with one ``jax.device_get``).  The port keeps
that single-controller model: a :class:`Mesh` is an ordered tuple of
``torch.device``s, one per shard, and one Python process runs each shard's
step on its device in turn (parallel/distributed.py).  A device may appear
more than once, as XLA's virtual host devices do: ``Mesh([cpu] * 8)`` runs
eight shards on the CPU, ``Mesh([cuda:0] * 4)`` four on one card, and
``get_mesh()`` spans every local card.

A mesh spanning processes (``torch.distributed`` collectives between
ranks) is not what symmer_tpu's mesh layer does and is not built here;
``distributed_init`` only forms the process group its contract asks for.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import config


class Mesh:
    """An ordered tuple of torch devices, one per shard of the term axis
    (repeats allowed); ``size`` stands for jax's ``mesh.devices.size``."""

    def __init__(self, devices: Sequence, axis_names=("terms",)):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def check_devices(mesh: Mesh, device: torch.device) -> None:
    """Raise unless every shard of the mesh is a device of ``device``'s type:
    a mesh of CPU shards under a CUDA configuration would hide the card."""
    wrong = [str(d) for d in mesh.devices if d.type != device.type]
    if wrong:
        raise ValueError(f"mesh shards on {wrong}, but the device path runs on {device}")


def on_device(dev: torch.device):
    """Context that makes a card current, so that a kernel wrapper launches
    on that card's stream; nothing for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def get_mesh(n_devices: Optional[int] = None, axis_name: str = "terms") -> Mesh:
    """A 1-D mesh over up to n_devices (default: all) local devices of
    ``config.device``'s type: the cards when it is CUDA (raising when CUDA
    is absent, as config.torch_device() does), the one CPU device
    otherwise."""
    dev = config.torch_device()
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    return _mesh(dev.type, count, n_devices, axis_name)


@functools.lru_cache(maxsize=None)
def _mesh(kind: str, count: int, n_devices: Optional[int], axis_name: str) -> Mesh:
    devs = [torch.device(kind, i) if kind == "cuda" else torch.device(kind)
            for i in range(count)]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis_name,))


get_mesh.cache_clear = _mesh.cache_clear


def shard_terms(arr, mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Split an array along axis 0 (the term axis) into mesh.size equal
    parts, the last ones padded with zero rows, each a tensor on its shard's
    device."""
    if mesh is None:
        mesh = get_mesh()
    a = torch.as_tensor(np.ascontiguousarray(arr) if isinstance(arr, np.ndarray) else arr)
    L = -(-a.shape[0] // mesh.size)
    out = []
    for s, dev in enumerate(mesh.devices):
        part = torch.zeros((L,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        rows = a[s * L:(s + 1) * L]
        part[:rows.shape[0]] = rows.to(dev)
        out.append(part)
    return out


def replicate(arr, mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """The whole array on every shard's device: one copy per distinct
    device, shared (read-only) by the shards on it."""
    if mesh is None:
        mesh = get_mesh()
    a = torch.as_tensor(np.ascontiguousarray(arr) if isinstance(arr, np.ndarray) else arr)
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = a.to(dev, copy=True)
    return [copies[dev] for dev in mesh.devices]


@contextlib.contextmanager
def mesh_context(n_devices: Optional[int] = None, axis_name: str = "terms"):
    """Yield ``get_mesh(n_devices, axis_name)``.  torch has no ambient mesh
    for ``with mesh:`` to set; ``symmer_torch.use_mesh`` is what routes the
    operator kernels over a mesh."""
    yield get_mesh(n_devices, axis_name)


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> int:
    """Form a ``torch.distributed`` process group when asked; return the
    local device count, the devices ``get_mesh()`` spans.

    The counterpart of symmer_tpu's ``distributed_init`` (a wrapper of
    ``jax.distributed.initialize``), with the same contract:
      - no coordinator and one process: a no-op, safe to leave in
        single-host scripts;
      - explicit arguments (``coordinator_address='host0:29500'``,
        ``num_processes``, ``process_id``): ``init_process_group`` with
        ``tcp://<coordinator_address>``, NCCL when ``config.device`` is
        CUDA and gloo otherwise (``backend=`` and ``timeout=`` in kwargs
        override); a group that cannot form raises;
      - a launcher's environment (``MASTER_ADDR`` and ``WORLD_SIZE`` > 1,
        as torchrun sets them) without explicit arguments: the group is
        formed from it (``env://``), and when that fails the process stays
        single-process.
    The mesh of the port is single-process: the group is there for the
    caller's own collectives, and the return value counts local devices.
    """
    import torch.distributed as dist

    explicit = coordinator_address is not None or (num_processes or 1) > 1
    if (explicit or _launcher_env()) and not dist.is_initialized():
        kwargs.setdefault("backend", "nccl" if config.device.type == "cuda" else "gloo")
        if explicit:
            if coordinator_address is not None:
                kwargs.setdefault("init_method", f"tcp://{coordinator_address}")
            kwargs.setdefault("world_size", num_processes or 1)
            kwargs.setdefault("rank", process_id or 0)
        else:
            kwargs.setdefault("init_method", "env://")
            kwargs.setdefault("timeout", datetime.timedelta(seconds=30))
        try:
            dist.init_process_group(**kwargs)
        except Exception:
            if explicit:
                raise  # a requested group that cannot form is an error
            # launcher-like variables that lead nowhere: stay single-process
    get_mesh.cache_clear()  # meshes must span the (possibly new) device set
    dev = config.torch_device()
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _launcher_env() -> bool:
    """True when a multi-process launcher's environment is present."""
    try:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    except ValueError:
        return False
    return bool(os.environ.get("MASTER_ADDR")) and world > 1
