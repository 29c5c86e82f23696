"""Carry parameters and optimizer state across from the JAX package.

``llama_params_from_numpy`` (and ``bert_params_from_numpy``, for BERT,
``gpt2_params_from_numpy`` and ``gptx_params_from_numpy``) takes
the JAX package's parameter tree with
its leaves already converted to numpy arrays (``jax.tree_util.tree_map(
np.asarray, params)`` on the JAX side — this module imports no JAX) and
returns the port's parameter dictionary. The layouts are the same by design
(stacked ``(L, ...)`` layer weights, ``(in, out)`` projections, ``(h, V)``
LM head), so the conversion is a shape check and a copy; both packages then
compute the same function on the same inputs.

``convnet_params_from_numpy`` does it for the CV examples' convnet, whose
stage list becomes a dict keyed by index and whose HWIO kernels become
OIHW (``models/vision.py``).

``optax_state_from_numpy`` does the same for an optax chain state (adamw's
``count``/``mu``/``nu``, sgd's momentum ``trace``), converted to numpy the
same way, into the state of the port's matching ``optim`` chain.
"""

from __future__ import annotations

import numpy as np
import torch

from ..optim import EmptyState, ScaleByAdam, ScaleByAdamState, Trace, TraceState
from ..utils.device import resolve_device
from ..utils.tree import tree_map
from .bert import BertConfig, BertForSequenceClassification
from .gpt2 import GPT2, GPT2Config
from .gptx import GPTX, GPTXConfig
from .llama import Llama, LlamaConfig
from .moe import MoELlama, MoELlamaConfig
from .vision import ConvNetConfig, ConvNetForImageClassification


def _expected_shapes(model_cls, config) -> dict:
    """The parameter tree's shapes, from the port's own initializer run on
    the meta device (no memory, no numbers)."""
    probe = model_cls.__new__(model_cls)
    probe.config = config
    probe.device = torch.device("meta")
    return probe.init(0)


def _params_from_numpy(tree, expected, device, dtype):
    dev = resolve_device(device)

    def convert(src, ref, path):
        if isinstance(ref, dict):
            if not isinstance(src, dict) or set(src) != set(ref):
                got = sorted(src) if isinstance(src, dict) else type(src).__name__
                raise ValueError(f"parameter tree mismatch at {path or '/'}: "
                                 f"expected keys {sorted(ref)}, got {got}")
            return {k: convert(src[k], ref[k], f"{path}/{k}") for k in ref}
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"parameter {path}: expected shape {tuple(ref.shape)}, "
                             f"got {arr.shape}")
        return torch.tensor(arr.astype(np.float32), device=dev, dtype=dtype)

    return convert(tree, expected, "")


def llama_params_from_numpy(tree, config: LlamaConfig, device=None, dtype=torch.float32):
    """Numpy Llama parameter tree (the JAX layout) → the port's parameters
    on ``device`` in ``dtype``. Raises on a missing, extra or mis-shaped
    leaf instead of loading a partial model."""
    return _params_from_numpy(tree, _expected_shapes(Llama, config), device, dtype)


def gpt2_params_from_numpy(tree, config: GPT2Config, device=None, dtype=torch.float32):
    """Numpy GPT-2 parameter tree (the JAX layout: ``embed/{wte,wpe}``, the
    stacked ``layers``, ``ln_f``) → the port's parameters, leaf for leaf;
    raises as :func:`llama_params_from_numpy` does."""
    return _params_from_numpy(tree, _expected_shapes(GPT2, config), device, dtype)


def gptx_params_from_numpy(tree, config: GPTXConfig, device=None, dtype=torch.float32):
    """Numpy GPTX (GPT-NeoX / GPT-J / OPT) parameter tree (the JAX layout,
    its leaves set by the config: ``wpe`` for learned positions, the biases,
    ``ln_2``, ``lm_head`` and its bias) → the port's parameters, leaf for
    leaf; raises as :func:`llama_params_from_numpy` does."""
    return _params_from_numpy(tree, _expected_shapes(GPTX, config), device, dtype)


def moe_llama_params_from_numpy(tree, config: MoELlamaConfig, device=None,
                                dtype=torch.float32):
    """Numpy MoELlama parameter tree (the JAX layout: ``layers/mlp`` holds
    ``router`` (L,h,E), ``w_gate``/``w_up`` (L,E,h,i), ``w_down`` (L,E,i,h))
    → the port's parameters, leaf for leaf; raises as
    :func:`llama_params_from_numpy` does."""
    return _params_from_numpy(tree, _expected_shapes(MoELlama, config), device, dtype)


def bert_params_from_numpy(tree, config: BertConfig, device=None, dtype=torch.float32):
    """Numpy BERT parameter tree (the JAX package's
    ``BertForSequenceClassification`` layout) → the port's parameters on
    ``device`` in ``dtype``, checked leaf by leaf as
    :func:`llama_params_from_numpy` checks."""
    return _params_from_numpy(tree, _expected_shapes(BertForSequenceClassification, config),
                              device, dtype)


def convnet_params_from_numpy(tree, config: ConvNetConfig, device=None, dtype=torch.float32):
    """Numpy convnet parameters (the JAX package's ``ConvNetForImageClassification``
    layout: a list of stages with HWIO kernels) → the port's: stages keyed
    ``"0"``, ``"1"``, ..., kernels OIHW; checked leaf by leaf."""
    stages = {str(i): dict(stage, kernel=np.transpose(np.asarray(stage["kernel"]), (3, 2, 0, 1)))
              for i, stage in enumerate(tree["stages"])}
    return _params_from_numpy({"stages": stages, "head": tree["head"]},
                              _expected_shapes(ConvNetForImageClassification, config), device,
                              dtype)


def optax_state_from_numpy(tx, state, params, device=None):
    """An optax chain state with numpy leaves (``jax.tree_util.tree_map(
    np.asarray, opt_state)``) → the state of the port's chain ``tx`` for
    ``params``, on ``device``. The two chains must match transform for
    transform (``optim.adamw`` mirrors ``optax.adamw`` and so on): the adam
    state carries ``count``, ``mu`` and ``nu``, the momentum state its
    ``trace``; the moments take each parameter's shape and dtype; stateless
    transforms get ``EmptyState()``. Raises on a length, key or shape
    mismatch."""
    dev = resolve_device(device)
    if len(state) != len(tx.transforms):
        raise ValueError(f"optimizer state has {len(state)} entries, the chain "
                         f"{len(tx.transforms)}")

    def like_params(src, what):
        def leaf(a, ref):
            arr = np.asarray(a)
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{what}: expected shape {tuple(ref.shape)}, got {arr.shape}")
            return torch.tensor(arr, dtype=ref.dtype, device=dev)
        return tree_map(leaf, src, params)

    out = []
    for t, src in zip(tx.transforms, state):
        if isinstance(t, ScaleByAdam):
            count = torch.tensor(np.asarray(src.count), dtype=torch.int32, device=dev)
            out.append(ScaleByAdamState(count=count, mu=like_params(src.mu, "mu"),
                                        nu=like_params(src.nu, "nu")))
        elif isinstance(t, Trace):
            out.append(TraceState(trace=like_params(src.trace, "trace")))
        else:
            out.append(EmptyState())
    return tuple(out)
