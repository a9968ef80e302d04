"""The sample-axis layout of a sharded solve.

Counterpart of ``sampling_gpmpc_tpu/parallel/mesh.py``.  The ns dynamics
samples couple only through the shared input trajectory, so one axis over
the samples ("ns") is the layout: each rank holds ``ns // world`` of them.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from sampling_gpmpc_torch.parallel.collectives import (BlockGroup,
                                                       group_rank,
                                                       group_size)

AXIS = "ns"


@dataclasses.dataclass(frozen=True)
class SampleMesh:
    """One sample axis over ``group`` (None: a single device).

    ``device_mesh`` is the ``torch.distributed`` DeviceMesh of a process
    group (None for a :class:`BlockGroup` or a single device).  ``rank``
    of a BlockGroup is the calling block's, inside ``BlockGroup.run``.
    """

    group: object = None
    device_mesh: object = None
    axis: str = AXIS

    @property
    def world(self) -> int:
        return group_size(self.group)

    @property
    def rank(self) -> int:
        return group_rank(self.group)

    def local_ns(self, ns: int) -> int:
        """Samples per rank of a global count ``ns``."""
        assert ns % self.world == 0, (
            f"num_dyn_samples={ns} must divide over {self.world} devices")
        return ns // self.world

    def offset(self, ns: int) -> int:
        """Global index of this rank's first sample."""
        return self.rank * self.local_ns(ns)


def sample_mesh(n: int = None, group=None) -> SampleMesh:
    """The sample axis over ``group``, or else over the initialised
    ``torch.distributed`` world (a one-axis DeviceMesh named "ns"), or
    else over ``n`` in-process blocks (a :class:`BlockGroup`; n in (None,
    1) is a single device).  ``n``, where given, must be the world size."""
    if group is None and dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        world = dist.get_world_size()
        # the backend says where the collectives run: NCCL on the card,
        # gloo on the host (parallel/collectives.py stages CUDA tensors)
        dtype = "cuda" if dist.get_backend() == "nccl" else "cpu"
        mesh = init_device_mesh(dtype, (world,), mesh_dim_names=(AXIS,))
        out = SampleMesh(group=mesh.get_group(AXIS), device_mesh=mesh)
    elif group is None:
        out = SampleMesh(group=BlockGroup(n) if n and n > 1 else None)
    else:
        out = SampleMesh(group=group)
    if n is not None and out.world != n:
        raise ValueError(f"sample_mesh: asked for {n} ranks, the group has "
                         f"{out.world}")
    return out
