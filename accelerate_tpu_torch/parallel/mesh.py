"""The device mesh — the counterpart of ``accelerate_tpu/parallel/mesh.py``.

The JAX package makes every parallelism strategy an axis of one
``jax.sharding.Mesh``. The port runs one process per rank and builds a
``torch.distributed.device_mesh.DeviceMesh`` over the job's ranks with the
axes it has ported so far: ``dp`` (data parallel: parameters replicated,
batch rows split) and ``sp`` (sequence parallel: the sequence split, with
ring attention over the axis). The axis order is the JAX package's
(``accelerate_tpu/utils/constants.py:177``, ``sp`` inside ``dp``), so
rank = dp_index * sp + sp_index. The fsdp, tp, pp and ep axes are not
ported yet (ROADMAP.md) and raise when asked for.
"""

from __future__ import annotations

from dataclasses import dataclass

MESH_AXES = ("dp", "sp")
UNPORTED_AXES = ("fsdp_size", "tp_size", "pp_size", "ep_size")


@dataclass
class ParallelismConfig:
    """Declarative mesh shape; ``dp_size=-1`` (or 0) means "every rank left
    over after the other axes"."""

    dp_size: int = -1
    fsdp_size: int = 1
    tp_size: int = 1
    pp_size: int = 1
    sp_size: int = 1
    ep_size: int = 1

    def __post_init__(self):
        if self.dp_size == 0:
            self.dp_size = -1
        for name in UNPORTED_AXES:
            if getattr(self, name) != 1:
                raise NotImplementedError(
                    f"ParallelismConfig({name}={getattr(self, name)}) is not ported yet "
                    "(ROADMAP.md, module queue: the fsdp, tp, pp and ep axes)")
        if self.sp_size < 1:
            raise ValueError(f"sp_size must be >= 1, got {self.sp_size}")
        if self.dp_size < 1 and self.dp_size != -1:
            raise ValueError(f"dp_size must be >= 1 or -1, got {self.dp_size}")

    def resolved_sizes(self, world_size: int) -> dict:
        """``{"dp": ..., "sp": ...}`` for a job of ``world_size`` ranks."""
        dp = world_size // self.sp_size if self.dp_size == -1 else self.dp_size
        if dp * self.sp_size != world_size:
            raise ValueError(f"{world_size} ranks do not make a dp x sp mesh of "
                             f"dp={self.dp_size} x sp={self.sp_size}")
        return {"dp": dp, "sp": self.sp_size}

    def build_mesh(self, world_size: int, device_type: str):
        """The job's ``DeviceMesh`` with dims ``("dp", "sp")``; every rank
        calls this (it creates the axes' process groups)."""
        from torch.distributed.device_mesh import init_device_mesh

        sizes = self.resolved_sizes(world_size)
        return init_device_mesh(device_type, tuple(sizes[a] for a in MESH_AXES),
                                mesh_dim_names=MESH_AXES)
