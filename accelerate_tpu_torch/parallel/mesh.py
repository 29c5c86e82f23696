"""The device mesh — the counterpart of ``accelerate_tpu/parallel/mesh.py``.

The JAX package makes every parallelism strategy an axis of one
``jax.sharding.Mesh``. The port runs one process per rank and builds a
``torch.distributed.device_mesh.DeviceMesh`` over the job's ranks with the
axes it has ported so far: ``dp`` (data parallel: parameters replicated,
batch rows split), ``fsdp`` (fully sharded: parameters, gradients and
optimizer state sharded, batch rows split; ``parallel/fsdp.py``) and ``sp``
(sequence parallel: the sequence split, with ring attention over the axis).
The axis order is the JAX package's (``accelerate_tpu/utils/constants.py:
177``: ``dp``, then ``fsdp``, then ``sp``), so
rank = (dp_index * fsdp + fsdp_index) * sp + sp_index; with fsdp 1 the
groups and the rank order are those of a ``("dp", "sp")`` mesh. The tp, pp
and ep axes are not ported yet (ROADMAP.md) and raise when asked for.
"""

from __future__ import annotations

from dataclasses import dataclass

MESH_AXES = ("dp", "fsdp", "sp")
UNPORTED_AXES = ("tp_size", "pp_size", "ep_size")


@dataclass
class ParallelismConfig:
    """Declarative mesh shape; ``dp_size=-1`` (or 0) means "every rank left
    over after the other axes", and so does ``fsdp_size=-1`` (or 0), which
    takes the remainder when both are -1 (the JAX package's full-shard
    preference)."""

    dp_size: int = -1
    fsdp_size: int = 1
    tp_size: int = 1
    pp_size: int = 1
    sp_size: int = 1
    ep_size: int = 1

    def __post_init__(self):
        if self.dp_size == 0:
            self.dp_size = -1
        if self.fsdp_size == 0:
            self.fsdp_size = -1
        for name in UNPORTED_AXES:
            if getattr(self, name) != 1:
                raise NotImplementedError(
                    f"ParallelismConfig({name}={getattr(self, name)}) is not ported yet "
                    "(ROADMAP.md, module queue: the tp, pp and ep axes)")
        if self.sp_size < 1:
            raise ValueError(f"sp_size must be >= 1, got {self.sp_size}")
        for name in ("dp_size", "fsdp_size"):
            if getattr(self, name) < 1 and getattr(self, name) != -1:
                raise ValueError(f"{name} must be >= 1 or -1, got {getattr(self, name)}")

    def resolved_sizes(self, world_size: int) -> dict:
        """``{"dp": ..., "fsdp": ..., "sp": ...}`` for a job of ``world_size``
        ranks (the JAX package's ``resolved_sizes``)."""
        dp, fsdp, sp = self.dp_size, self.fsdp_size, self.sp_size
        if fsdp == -1:
            dp = 1 if dp == -1 else dp
            fsdp = max(world_size // (dp * sp), 1)
        if dp == -1:
            dp = max(world_size // (fsdp * sp), 1)
        if dp * fsdp * sp != world_size:
            raise ValueError(f"{world_size} ranks do not make a dp x sp mesh of "
                             f"dp={self.dp_size} x sp={self.sp_size} (fsdp={self.fsdp_size})")
        return {"dp": dp, "fsdp": fsdp, "sp": sp}

    def build_mesh(self, world_size: int, device_type: str):
        """The job's ``DeviceMesh`` with dims ``("dp", "fsdp", "sp")``; every
        rank calls this (it creates the axes' process groups)."""
        from torch.distributed.device_mesh import init_device_mesh

        sizes = self.resolved_sizes(world_size)
        return init_device_mesh(device_type, tuple(sizes[a] for a in MESH_AXES),
                                mesh_dim_names=MESH_AXES)


def mesh_coordinate(mesh) -> dict:
    """``{axis: index}`` of this rank on ``mesh``."""
    return dict(zip(MESH_AXES, mesh.get_coordinate()))
