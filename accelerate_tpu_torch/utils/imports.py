"""Availability probes — the counterpart of ``accelerate_tpu/utils/imports.py:17-177``.

The probes the port's trackers (``tracking.py``) and ``env`` command read,
and ``is_cuda_available`` (a card torch can use), which the JAX package
keeps as an always-false slot. ``is_tpu_available`` and
``is_pallas_available`` have no counterpart: the port runs no TPU backend
and no Pallas kernel (its kernels are CUDA sources built by ``nvcc``).
Nothing here imports the probed package.
"""

from __future__ import annotations

import functools
import importlib.metadata
import importlib.util


@functools.lru_cache(maxsize=None)
def _is_package_available(pkg_name: str, metadata_name: str | None = None) -> bool:
    if importlib.util.find_spec(pkg_name) is None:
        return False
    try:
        importlib.metadata.version(metadata_name or pkg_name)
        return True
    except importlib.metadata.PackageNotFoundError:
        # Namespace or source-only packages have a spec but no metadata.
        return True


def is_cuda_available() -> bool:
    """Whether torch sees a CUDA card."""
    import torch

    return torch.cuda.is_available()


def is_triton_available() -> bool:
    return _is_package_available("triton")


# Tracker backends (tracking.py's ``is_available``).
def is_wandb_available() -> bool:
    return _is_package_available("wandb")


def is_comet_ml_available() -> bool:
    return _is_package_available("comet_ml")


def is_mlflow_available() -> bool:
    return _is_package_available("mlflow")


def is_aim_available() -> bool:
    return _is_package_available("aim")


def is_clearml_available() -> bool:
    return _is_package_available("clearml")


def is_dvclive_available() -> bool:
    return _is_package_available("dvclive")
