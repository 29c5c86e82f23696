"""The device mesh — the counterpart of ``accelerate_tpu/parallel/mesh.py``.

The JAX package makes every parallelism strategy an axis of one
``jax.sharding.Mesh``. The port runs one process per rank and builds a
``torch.distributed.device_mesh.DeviceMesh`` over the job's ranks with the
axes it has ported so far: ``pp`` (pipeline stages: each rank holds a
contiguous block of the layer stack, ``parallel/pipeline.py``), ``dp``
(data parallel: parameters replicated, batch rows split), ``fsdp`` (fully sharded: parameters, gradients and
optimizer state sharded, batch rows split; ``parallel/fsdp.py``), ``sp``
(sequence parallel: the sequence split, with ring or Ulysses attention over
the axis) and ``tp`` (tensor parallel: the Megatron split of the heads, the
MLP's columns and the vocab; ``parallel/tensor.py``) and ``ep`` (expert
parallel: each rank holds ``E / ep`` of a mixture-of-experts layer's experts
and sees the same tokens as the other ep ranks; ``ops/moe.py``). The axis
order is the JAX package's (``accelerate_tpu/utils/constants.py:177``
without its ``dcn`` axis: ``pp`` outermost, then ``dp``, ``fsdp``, ``ep``,
``sp``, and ``tp`` innermost), so rank = ((((pp_index * dp + dp_index) *
fsdp + fsdp_index) * ep + ep_index) * sp + sp_index) * tp + tp_index.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..utils.constants import ENV_MESH_SHAPE

MESH_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")


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
        for name in ("pp_size", "sp_size", "tp_size", "ep_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        for name in ("dp_size", "fsdp_size"):
            if getattr(self, name) < 1 and getattr(self, name) != -1:
                raise ValueError(f"{name} must be >= 1 or -1, got {getattr(self, name)}")

    @classmethod
    def from_env(cls) -> "ParallelismConfig":
        """The mesh of ``ACCELERATE_MESH_SHAPE`` (``pp:2,dp:2,fsdp:2,ep:2,tp:2``; JAX
        ``parallel/mesh.py:88-102``): 0 for dp or fsdp means every rank
        left over. The port has no dcn axis: ``dcn`` is accepted at 1."""
        spec = os.environ.get(ENV_MESH_SHAPE, "")
        kwargs = {}
        for part in (p for p in spec.split(",") if p.strip()):
            axis, _, size = part.partition(":")
            axis = axis.strip()
            if axis not in ("dp", "fsdp", "tp", "pp", "sp", "ep", "dcn"):
                raise ValueError(f"Unknown mesh axis {axis!r} in {ENV_MESH_SHAPE}")
            size = int(size)
            if axis == "dcn":
                if size not in (0, 1):
                    raise NotImplementedError(f"{ENV_MESH_SHAPE} dcn:{size}: the port has no "
                                              "dcn axis (ROADMAP.md)")
                continue
            if axis in ("dp", "fsdp") and size == 0:
                size = -1
            kwargs[f"{axis}_size"] = size
        return cls(**kwargs)

    def resolved_sizes(self, world_size: int) -> dict:
        """``{"pp", "dp", "fsdp", "ep", "sp", "tp"}`` for a job of
        ``world_size`` ranks (the JAX package's ``resolved_sizes``: pp, ep,
        tp and sp are fixed, fsdp and dp take what is left)."""
        dp, fsdp = self.dp_size, self.fsdp_size
        other = self.pp_size * self.sp_size * self.tp_size * self.ep_size
        if fsdp == -1:
            dp = 1 if dp == -1 else dp
            fsdp = max(world_size // (dp * other), 1)
        if dp == -1:
            dp = max(world_size // (fsdp * other), 1)
        if dp * fsdp * other != world_size:
            raise ValueError(f"{world_size} ranks do not make a dp x sp mesh of "
                             f"dp={self.dp_size} x sp={self.sp_size} (fsdp={self.fsdp_size}, "
                             f"tp={self.tp_size}, pp={self.pp_size}, ep={self.ep_size})")
        return {"pp": self.pp_size, "dp": dp, "fsdp": fsdp, "ep": self.ep_size,
                "sp": self.sp_size, "tp": self.tp_size}

    def build_mesh(self, world_size: int, device_type: str):
        """The job's ``DeviceMesh`` with dims ``("pp", "dp", "fsdp", "ep", "sp", "tp")``;
        every rank calls this (it creates the axes' process groups)."""
        from torch.distributed.device_mesh import init_device_mesh

        sizes = self.resolved_sizes(world_size)
        return init_device_mesh(device_type, tuple(sizes[a] for a in MESH_AXES),
                                mesh_dim_names=MESH_AXES)


def mesh_coordinate(mesh) -> dict:
    """``{axis: index}`` of this rank on ``mesh``."""
    return dict(zip(MESH_AXES, mesh.get_coordinate()))
