"""Device meshes of the port (port of ``repro/launch/mesh.py``).

A :class:`Mesh` is an ordered map of axis names to sizes over a block of
ranks, laid out row-major in axis order as ``jax.make_mesh`` lays out its
devices.  It may stay abstract, shape only: the sharding specs of the
production meshes (256 or 512 ranks) resolve against it without a world.
:meth:`Mesh.bind`, called by every rank of a running ``torch.distributed``
world, gives the :class:`BoundMesh` of this rank: its coordinate on each axis
and one process group for each slice of the mesh along each set of axes.

:meth:`Mesh.bind_abstract` gives the bound mesh of one rank with no world:
its coordinate, and for each slice a ``core.capture.CaptureGroup`` (the
slice's axes, size and this rank's index in it) in place of a process
group.  The exchanges record what they are handed over such a group and
exchange nothing, so one rank's step runs alone, as it would in the world,
for the capture bridge (``launch/dryrun.py``).

A dim sharded over several axes is cut in the mesh's axis order, the first
axis major; :meth:`BoundMesh.index` gives this rank's chunk.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..core.capture import CaptureGroup
from ..distributed.collectives import name_group

__all__ = ["Mesh", "BoundMesh", "make_production_mesh", "make_mesh_by_name", "BATCH_AXES"]

BATCH_AXES = ("pod", "data")  # the axes batch rows are sharded over, when present


class Mesh:
    """``{axis: size}`` in order, over ``devices`` (global ranks, row-major;
    ``range(size)`` by default)."""

    def __init__(self, shape: Dict[str, int], devices: Optional[Sequence[int]] = None):
        self.shape: Dict[str, int] = dict(shape)
        n = math.prod(self.shape.values())
        devices = np.arange(n) if devices is None else np.asarray(devices, dtype=np.int64)
        if devices.size != n:
            raise ValueError(f"mesh {self.shape} needs {n} ranks, got {devices.size}")
        self.devices = devices.reshape(tuple(self.shape.values()))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def axes_in_order(self, axes: str | Iterable[str] | None) -> Tuple[str, ...]:
        """``axes`` (one name or several) that the mesh has, in mesh order."""
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.shape if a in axes)

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (1 for none)."""
        return math.prod(self.shape[a] for a in self.axes_in_order(axes))

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return self.axes_in_order(BATCH_AXES)

    def coords(self, rank: int) -> Optional[Dict[str, int]]:
        """``{axis: index}`` of global ``rank``, or None if it is not in the mesh."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            return None
        return dict(zip(self.shape, (int(i) for i in where[0])))

    def bind(self) -> Optional["BoundMesh"]:
        """The bound mesh of this rank in the running world.

        Every rank of the world must call it, in the same order as the
        other ranks' calls (``dist.new_group`` is collective); a rank outside
        the mesh gets None.
        """
        groups = {}
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                others = [a for a in names if a not in axes]
                moved = np.moveaxis(self.devices, [names.index(a) for a in others],
                                    range(len(others)))
                for members in moved.reshape(-1, math.prod(self.shape[a] for a in axes)):
                    g = dist.new_group(sorted(int(r) for r in members))
                    if dist.get_rank() in members:
                        groups[axes] = g
                        name_group(g, axes)
        coords = self.coords(dist.get_rank())
        return None if coords is None else BoundMesh(self, coords, groups)

    def bind_abstract(self, rank: int) -> "BoundMesh":
        """The bound mesh of global ``rank`` with no world: a
        :class:`~repro_torch.core.capture.CaptureGroup` for each set of axes
        along which it has company, as :meth:`bind` has a process group."""
        coord = self.coords(rank)
        if coord is None:
            raise ValueError(f"rank {rank} is not in {self}")
        groups = {}
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                # this rank's slice: the other axes fixed at its coordinate
                members = self.devices[tuple(slice(None) if a in axes else coord[a]
                                             for a in names)]
                if members.size > 1:
                    # its index in the slice, as in bind's group of the sorted ranks
                    index = sorted(int(r) for r in members.reshape(-1)).index(rank)
                    groups[axes] = CaptureGroup(axes, members.size, index)
        return BoundMesh(self, coord, groups)


class BoundMesh(Mesh):
    """A mesh bound in a running world: this rank's ``coord`` on each axis and
    its process group along each set of axes."""

    def __init__(self, mesh: Mesh, coord: Dict[str, int], groups: Dict[Tuple[str, ...], object]):
        super().__init__(mesh.shape, mesh.devices.reshape(-1))
        self.coord = coord
        self._groups = groups
        self.rank = int(self.devices[tuple(coord.values())])

    def index(self, axes) -> int:
        """This rank's chunk of a dim cut over ``axes`` (mesh order, first major)."""
        i = 0
        for a in self.axes_in_order(axes):
            i = i * self.shape[a] + self.coord[a]
        return i

    def group(self, axes):
        """The process group of this rank's slice along ``axes``; None where
        that slice is this rank alone (no exchange)."""
        return self._groups.get(self.axes_in_order(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_mesh_by_name(name: str) -> Mesh:
    """'single' -> 16x16, 'multi' -> 2x16x16, 'AxB[xC]' -> custom, as the
    reference names them: A is data, B model; with three, pod x data x model."""
    if name == "single":
        return make_production_mesh(multi_pod=False)
    if name == "multi":
        return make_production_mesh(multi_pod=True)
    dims = tuple(int(x) for x in name.split("x"))
    axes = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]
    return Mesh(dict(zip(axes, dims)))
