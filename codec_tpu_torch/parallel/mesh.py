"""A device mesh for one controlling process (counterpart of
codec_tpu/parallel/mesh.py:20-61).

codec_tpu is single-controller: one process holds a jax `Mesh` and XLA
partitions each program over it. The port keeps that contract without a
partitioner: a `Mesh` here is a numpy array of `torch.device`s with axis
names, and the code that shards over it (runtime/model.py::set_mesh,
lm/backbone.py::set_mesh*, parallel/pipeline.py) places each device's
share itself and launches each device's work from this one process.
CUDA launches return before the work ends, so work put on several cards
runs on them at once.

A mesh may name one device more than once (`devices=["cuda:0"] * 2`, or
`["cpu"] * 8` as the CPU tests do, the counterpart of the 8 virtual CPU
devices of codec_tpu's tests). Every entry then still holds its own share,
and the shares that land on one device run there one after the other.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """`devices`: an ndarray of torch.device, one axis per name in
    `axis_names`. `shape[axis]` is that axis's size, as in jax."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            devs[idx] = torch.device(d)
        if devs.ndim != len(axis_names):
            raise ValueError(f"a {devs.ndim}-D device array needs "
                             f"{devs.ndim} axis names, got {axis_names}")
        self.devices = devs
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devs.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} "
                             f"(axes {self.axis_names})")
        i = self.axis_names.index(axis)
        idx = tuple(slice(None) if j == i else 0
                    for j in range(self.devices.ndim))
        return list(self.devices[idx])

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices.ravel()]}, "
                f"shape={self.shape})")


def _devices(n: int, devices: Optional[Sequence], what: str
             ) -> List[torch.device]:
    """`devices` as given (n of them), or the first n CUDA cards."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"{what}: {n} devices wanted, {len(devs)} given")
        return devs
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"need {n} devices for a {what} mesh, have {have} "
                         f"CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over `axis`: the first `n_devices` CUDA cards (all of
    them when None), or the entries of `devices` (names or
    torch.device; one may repeat)."""
    if n_devices is None:
        n_devices = len(devices) if devices is not None \
            else torch.cuda.device_count()
    return Mesh(_devices(int(n_devices), devices, repr(axis)), (axis,))


def make_mesh_2d(n_first: int, n_second: int,
                 axes: Sequence[str] = ("dp", "tp"),
                 devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D mesh [n_first, n_second]; the second axis is the inner one
    (consecutive devices), as in codec_tpu. The dp x tp form of the batch
    runners, the engine and the server's `--dp N --tp M`: streams split
    over "dp" (dp_share), each dp row's backbone shares over "tp"
    (LlamaBackbone.set_mesh(mesh, axis="tp"))."""
    devs = _devices(n_first * n_second, devices, f"{tuple(axes)}")
    return Mesh(np.array(devs, dtype=object).reshape(n_first, n_second),
                tuple(axes))


def named_devices(device, n: int) -> Optional[List[torch.device]]:
    """The mesh entries a CLI's --device gives n-way parallelism: None (the
    first n cards) for "cuda", else n entries of the device it names
    ("cpu", "cuda:0")."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return None
    return [d] * n


def dp_share(mesh: Mesh, b: int, s: int, axis: str = "dp",
             what: str = "batched generation", unit: str = "streams"
             ) -> Tuple[int, List[torch.device]]:
    """Stream (or slot) s of b split over mesh[axis] as codec_tpu splits
    a batch over a dp axis (b must be a multiple of the axis size n;
    ValueError "`what` DP: b `unit` not divisible by mesh size n"): its
    share j, which holds streams [j b/n, (j + 1) b/n), and that share's
    devices, mesh[axis = j]: one device on a 1-D mesh, the row of the
    other axis (its tp devices) on a 2-D one."""
    n = int(mesh.shape[axis])
    if b % n:
        raise ValueError(f"{what} DP: {b} {unit} not divisible by mesh "
                         f"size {n}")
    j = int(s) // (b // n)
    i = mesh.axis_names.index(axis)
    sub = mesh.devices[tuple(j if k == i else slice(None)
                             for k in range(mesh.devices.ndim))]
    return j, list(sub.ravel()) if isinstance(sub, np.ndarray) else [sub]


def physical(device) -> torch.device:
    """The card a device name means ("cuda" is the current one)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def row_slices(b: int, n: int) -> List[slice]:
    """n contiguous slices of b rows, the first b mod n one row longer
    (empty ones where b < n): the one rule every batch split follows."""
    q, r = divmod(b, n)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(n)])
    return [slice(int(a), int(z)) for a, z in zip(bounds[:-1], bounds[1:])]


def shard_batch(mesh: Mesh, x: torch.Tensor, axis: str = "dp"
                ) -> List[torch.Tensor]:
    """x split on dim 0 into one contiguous slice per device of `axis`
    (row_slices), each on its device."""
    devs = mesh.axis_devices(axis)
    return [x[s].to(d) for s, d in zip(row_slices(x.shape[0], len(devs)),
                                       devs)]


def place(tree, device):
    """`tree` (tensors in dicts, lists and tuples; other leaves such as
    sizes and None kept as they are) with its tensors on `device`; a
    tensor already there is shared, not copied (weights are only read)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, device) for v in tree)
    return tree


def replicate(mesh: Mesh, tree, axis: Optional[str] = None):
    """One copy of `tree` per device of the mesh (of `axis` when given), a
    list of trees placed as `place` places them."""
    devs = mesh.axis_devices(axis) if axis is not None \
        else list(mesh.devices.ravel())
    return [place(tree, d) for d in devs]
