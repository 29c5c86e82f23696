"""Tiny training fixtures — the counterpart of
``accelerate_tpu/test_utils/training.py``.

``RegressionDataset`` / ``RegressionModel`` fit ``y = a*x + b``, so a
check can hold exact parameter values; the data are the JAX package's
(numpy, the same seed), the model the port's (a ``Module`` with explicit
f32 parameters). :func:`unsharded_loss` is the reference a check of any
layout holds a step to on the parameters the layout holds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..modules import ModelOutput, Module
from ..utils.device import resolve_device


class RegressionDataset:
    """Map-style dataset of (x, y) pairs with y = a*x + b + noise."""

    def __init__(self, a: float = 2.0, b: float = 3.0, length: int = 64, seed: int = 42):
        rng = np.random.default_rng(seed)
        self.length = length
        self.x = rng.normal(size=(length,)).astype(np.float32)
        self.y = (a * self.x + b + 0.01 * rng.normal(size=(length,))).astype(np.float32)

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


class RegressionModel(Module):
    """``y_hat = a*x + b``; the forward returns the MSE loss when ``y`` is
    given (HF convention). Parameters live on ``device`` (the card unless
    ``device="cpu"``)."""

    def __init__(self, a: float = 0.0, b: float = 0.0, device=None):
        self.a0, self.b0 = a, b
        self.device = resolve_device(device)
        self.params = None

    def init(self, generator=None, **kwargs):
        return {k: torch.tensor(v, dtype=torch.float32, device=self.device)
                for k, v in (("a", self.a0), ("b", self.b0))}

    def apply(self, params, x=None, y=None, **kwargs):
        pred = params["a"] * torch.as_tensor(x, device=params["a"].device) + params["b"]
        out = ModelOutput(prediction=pred)
        if y is not None:
            out["loss"] = torch.mean((pred - torch.as_tensor(y, device=pred.device)) ** 2)
        return out


class MatrixRegressionModel(Module):
    """``y_hat = x @ W + b`` with matrix parameters large enough for the
    sharding planner (the fixture of the ZeRO tests; deterministic init)."""

    def __init__(self, dim: int = 64, device=None):
        self.dim = dim
        self.device = resolve_device(device)
        self.params = None

    def init(self, generator=None, **kwargs):
        d = self.dim
        w = ((np.arange(d * d, dtype=np.float32).reshape(d, d) % 7) - 3.0) / d
        return {"w": torch.as_tensor(w, device=self.device),
                "b": torch.zeros((d,), dtype=torch.float32, device=self.device)}

    def apply(self, params, x=None, y=None, **kwargs):
        pred = torch.as_tensor(x, device=params["w"].device) @ params["w"] + params["b"]
        out = ModelOutput(prediction=pred)
        if y is not None:
            out["loss"] = torch.mean((pred - torch.as_tensor(y, device=pred.device)) ** 2)
        return out


def regression_batches(dataset: RegressionDataset, batch_size: int, drop_last: bool = True):
    """Plain-python list of numpy batches (a loader that is not torch's)."""
    batches = []
    n = len(dataset) - (len(dataset) % batch_size if drop_last else 0)
    for start in range(0, n, batch_size):
        idx = slice(start, min(start + batch_size, len(dataset)))
        batches.append({"x": dataset.x[idx], "y": dataset.y[idx]})
    return batches


def unsharded_loss(pm, batch, microbatches: int = 0) -> float:
    """A prepared causal LM's loss on ``batch`` (``input_ids`` as labels) at
    its current parameters, computed unsharded: the full parameters (every
    rank of a process group joins the gathers), in the model's compute
    dtype, through the plain versions of the kernels (``kernels="off"``:
    nothing is launched). With ``microbatches`` the forward runs through a
    GPipe of 2 stages in this process, so a router loss is the mean over
    the microbatches, as a pipelined step's. Two free-running trajectories
    of a routed model in bf16 part within a few steps, so a layout is held
    step by step to this on its own parameters."""
    from ..parallel.pipeline import PipelineSpec
    from ..utils.tree import tree_map, tree_unflatten

    engine, dtype = pm.handle.sharded, pm.handle.compute_dtype
    if engine is None:
        tree = tree_map(lambda p: p.to(dtype), pm.params)
    else:
        tree = tree_unflatten(engine.template, [engine.full_leaf(i).to(dtype)
                                                for i in range(len(engine.layouts))])
    ids = torch.as_tensor(np.asarray(batch["input_ids"]), device=pm.handle.device)
    spec = PipelineSpec(stages=2, num_microbatches=microbatches) if microbatches else None
    with torch.no_grad():
        return float(pm.module.apply(tree, input_ids=ids, labels=ids, kernels="off",
                                     pipeline=spec)["loss"])
