"""The device mesh of the distributed CPD (≙ splatt_tpu/parallel/mesh.py).

The JAX package runs one process over a ``jax.sharding.Mesh``.  The port
does the same: a :class:`Mesh` is a list of ``torch.device``s, one per
rank, driven by one process.  There is no collective library and no
process group: a rank's work runs on its device, and data moves between
ranks by ``Tensor.to`` (the plain paths) or by the ring kernels' stores
into a neighbour's memory through CUDA peer pointers
(``parallel/ring_kernels.py``).

Where there are fewer cards than ranks, ranks share cards round-robin
(``mesh.virtual``): the ring kernels then run every rank of a card in one
launch.  With ``device="cpu"`` every rank is a virtual CPU rank, the
counterpart of the JAX tests' 8 virtual CPU devices
(``tests/conftest.py``).

The MEDIUM decomposition runs on a :class:`GridMesh`, the counterpart of
a JAX mesh with one axis ``m<k>`` per tensor mode: rank r sits at grid
coordinates ``coords(r)`` (row-major over ``grid``), and
:meth:`GridMesh.group` lists the ranks a collective over some axes
combines (≙ the reference's per-mode layer communicators,
src/mpi/mpi_setup.c:201-243).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: ranks of a CPU mesh when the caller names none: the JAX tests' count of
#: virtual CPU devices
CPU_DEFAULT_RANKS = 8


def _prime_factors(n: int) -> List[int]:
    out: List[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def auto_grid(n_devices: int, dims: Sequence[int]) -> Tuple[int, ...]:
    """Choose an n-D device grid for tensor `dims` (≙ p_get_best_mpi_dim).

    Greedy: hand each prime factor (largest first) to the mode with the
    most remaining length per grid slot.
    """
    grid = [1] * len(dims)
    for p in _prime_factors(n_devices):
        target = int(np.argmax([d / g for d, g in zip(dims, grid)]))
        grid[target] *= p
    return tuple(grid)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[r]`` is the device of rank r."""

    devices: Tuple[torch.device, ...]
    axis: str = "nnz"

    @property
    def ndev(self) -> int:
        return len(self.devices)

    @property
    def cards(self) -> Tuple[torch.device, ...]:
        """The distinct devices, in the order of their first rank."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def virtual(self) -> bool:
        """Whether ranks share a device."""
        return len(self.cards) < self.ndev

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    def ranks_on(self, device: torch.device) -> List[int]:
        return [r for r, d in enumerate(self.devices) if d == device]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis,)


@dataclasses.dataclass(frozen=True)
class GridMesh(Mesh):
    """An n-D mesh: ``devices[r]`` is the device of the rank at grid
    coordinates ``coords(r)``, in row-major order over ``grid``."""

    grid: Tuple[int, ...] = ()

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(f"m{m}" for m in range(len(self.grid)))

    def coords(self, r: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(r, self.grid))

    def group(self, r: int, axes: Sequence[int]) -> List[int]:
        """The ranks that agree with rank r on every axis outside
        `axes`, in rank order: the members of a collective over `axes`
        (a psum over ``m<k>`` for k in `axes`) that rank r takes part
        in."""
        mine = self.coords(r)
        keep = [k for k in range(len(self.grid)) if k not in axes]
        return [q for q in range(self.ndev)
                if all(self.coords(q)[k] == mine[k] for k in keep)]

    def groups(self, axes: Sequence[int]) -> List[List[int]]:
        """Every rank's :meth:`group` over `axes`, each group once, in
        the order of its first rank."""
        seen = dict.fromkeys(tuple(self.group(r, axes))
                             for r in range(self.ndev))
        return [list(g) for g in seen]

    def line(self, m: int) -> List[int]:
        """The ranks at coordinate 0 on every axis but m, ordered by
        their coordinate on m: one holder of each of mode m's row
        blocks."""
        return self.group(0, (m,))


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              device=None, axis: str = "nnz") -> Mesh:
    """Build a mesh of `n_devices` ranks.

    `devices` lists the devices to use (ranks take them round-robin);
    otherwise ``device="cpu"`` gives virtual CPU ranks
    (:data:`CPU_DEFAULT_RANKS` by default) and the default is every
    visible card, one rank each.  With fewer cards than `n_devices`,
    ranks share cards round-robin and ``mesh.virtual`` is true.  On
    cards, peer access is enabled between each rank's card and its ring
    neighbours' (a pair of cards without it raises).
    """
    if devices is not None:
        pool = [torch.device(d) for d in devices]
    else:
        from splatt_tpu_torch.config import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda":
            pool = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            pool = [dev]
            if n_devices is None:
                n_devices = CPU_DEFAULT_RANKS
    if not pool:
        raise ValueError("a mesh needs at least one device")
    n = len(pool) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if devices is not None and n_devices is not None and n <= len(pool):
        pool = pool[:n]
    mesh = Mesh(tuple(pool[r % len(pool)] for r in range(n)), axis)
    if mesh.is_cuda and len(mesh.cards) > 1:
        from splatt_tpu_torch.parallel.ring_kernels import enable_peer_access

        for r in range(n):
            a, b = mesh.devices[r], mesh.devices[(r + 1) % n]
            if a != b:
                enable_peer_access(a, b)
                enable_peer_access(b, a)
    return mesh


def make_grid_mesh(grid: Sequence[int], devices: Optional[Sequence] = None,
                   device=None) -> GridMesh:
    """A :class:`GridMesh` of ``prod(grid)`` ranks (≙ GridDecomp.make_mesh):
    `devices`, when given, must hold one device per rank (the JAX
    package's check); otherwise the ranks take :func:`make_mesh`'s
    devices, sharing cards round-robin where there are fewer."""
    grid = tuple(int(g) for g in grid)
    n = int(np.prod(grid))
    if devices is not None and n > len(devices):
        raise ValueError(f"grid {'x'.join(str(g) for g in grid)} needs {n} "
                         f"devices, only {len(devices)} available")
    flat = make_mesh(n_devices=n, devices=devices, device=device)
    return GridMesh(flat.devices, "grid", grid)


def single_axis_of(mesh: Optional[Mesh], default_axis: str
                   ) -> Tuple[Optional[Mesh], str]:
    """Normalize a user mesh for the 1-D decompositions: a 1-D mesh is
    returned with its axis name; a multi-axis :class:`GridMesh` raises,
    as the JAX package rejects a multi-axis mesh."""
    if mesh is None:
        return None, default_axis
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"this decomposition needs a 1-D mesh; got axes "
            f"{mesh.axis_names} — build one with make_mesh(), or use the "
            f"MEDIUM grid decomposition for multi-axis meshes")
    if isinstance(mesh, GridMesh):
        mesh = Mesh(mesh.devices, mesh.axis_names[0])
    return mesh, mesh.axis
