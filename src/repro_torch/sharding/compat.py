"""Meshes without devices, and one reader of a mesh's axis sizes.

``abstract_mesh`` is the counterpart of the JAX package's (``jax.sharding.
AbstractMesh``): axis names and sizes, no devices and no process group, so
the rules can be evaluated at the production meshes on any machine.  Every
rule reads a mesh through ``mesh_shape``, which takes an ``AbstractMesh``
or a ``torch.distributed.device_mesh.DeviceMesh``.

``shard_map`` has no counterpart here.  The JAX package uses it in two
places: the bucketed engine's group axis, which waits for a check on
several cards (ROADMAP.md Queue 1 item 14b), and ``tests/test_compress.py``,
whose psum on a one-wide axis the port runs over a ``torch.distributed``
group (``optim/compress.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh that has no devices."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in mesh order (``AbstractMesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    sizes = tuple(int(s) for s in axis_sizes)
    names = tuple(axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} axis sizes vs {len(names)} names")
    return AbstractMesh(sizes, names)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of an ``AbstractMesh`` or a ``DeviceMesh``, in
    mesh order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the rules need a mesh with named dimensions")
    return dict(zip(names, (int(s) for s in mesh.shape)))
