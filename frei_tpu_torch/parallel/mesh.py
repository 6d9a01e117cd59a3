"""The ('columns', 'bins') device mesh and its placements.

Counterpart of ``frei_tpu.parallel.mesh`` on ``torch.distributed``: one
process per device (the torchrun model), a
``torch.distributed.device_mesh.DeviceMesh`` with dims
``("columns", "bins")``, and DTensor placements where the JAX package
has ``NamedSharding``\\ s.

* ``columns``: batched atmospheric columns.  Every per-column quantity
  is sharded on this dim and no collective ever crosses it.
* ``bins``: spectral bins.  All per-wavelength physics is local; the one
  cross-bin coupling of the solver is the bolometric quadrature entering
  the temperature tendency, completed by one all-reduce of the (B, 4,
  L-1) quadrature block per sweep over the ``bins`` group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "column_sharding", "replicated", "COLUMNS", "BINS"]

COLUMNS = "columns"
BINS = "bins"


def make_mesh(n_columns: Optional[int] = None, n_bins: int = 1,
              device_type: str = "cuda"):
    """A ('columns', 'bins') ``DeviceMesh`` over the initialized world,
    rank = column index x n_bins + bins index, so that the ranks of one
    bins group are adjacent (they stay inside one host).

    Defaults to every rank on the columns dim (zero collectives).  Put
    ranks on the bins dim only when one column's spectral grid is too
    large or too slow for one device.  Needs a process group
    (:func:`~frei_tpu_torch.parallel.initialize_distributed`, or
    ``torch.distributed.init_process_group``); every rank calls it."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "parallel.initialize_distributed (or "
            "torch.distributed.init_process_group) on every rank first")
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    if n_columns is None:
        n_columns = world // n_bins
    if n_columns * n_bins != world:
        raise ValueError(f"mesh {n_columns} x {n_bins} != {world} devices")
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(n_columns, n_bins),
                      mesh_dim_names=(COLUMNS, BINS))


def column_sharding(mesh, *, batch_axis: bool = True,
                    bins_axis_index: Optional[int] = None) -> list:
    """DTensor placements (one per mesh dim) of a tensor with a leading
    columns axis and, optionally, a wavelength axis at
    ``bins_axis_index``: ``[Shard(0), Shard(i)]``, with ``Replicate()``
    for an axis not sharded."""
    from torch.distributed.tensor import Replicate, Shard
    del mesh  # the placements are the same on every ('columns', 'bins') mesh
    return [Shard(0) if batch_axis else Replicate(),
            Replicate() if bins_axis_index is None else Shard(bins_axis_index)]


def replicated(mesh) -> list:
    """DTensor placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim
