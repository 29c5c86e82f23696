"""``mixed_precision="fp8"`` — int8 quantization-aware training — against the
JAX package's.

The recipe (``Fp8RecipeKwargs``) and ``fp8_backend`` are checked field by
field; ``prepare`` swaps the model's ``matmul_precision`` to ``"int8"`` as
JAX's does (``tests/test_kwargs_handlers.py:199-235``'s cases), and the
swapped model trains against JAX's on ``tests/test_torch_train.py``'s small
Llama at 8 x 64 (the JAX side on the 8-device CPU mesh), weights from the
JAX package's init, batches numpy ids from a seed, ``adamw(3e-4)``, clip
1.0, 4 fused steps. Tolerances, with their reasons:

- losses: ``atol=3e-3``. Both sides compute in bf16 (fp8's compute dtype)
  with the int8 forward bitwise alike (``tests/test_torch_int8_matmul.py``),
  but XLA and PyTorch round the bf16 activations at other places (a
  relative 2**-9 each); 8e-4 seen at a loss of 6;
- parameters: ``atol`` of two learning-rate steps per update (Adam's
  normalized step can take the other sign where a bf16 gradient element
  sits at the rounding level; 1.6e-3 seen after 4 updates);
- the straight-through backward against ``_int8_matmul_bwd``: the f32
  products of both (summed in another order), cast to the operands' dtype:
  ``rtol=1e-5`` in f32, one bf16 ulp (``2**-8`` relative) in bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
from accelerate_tpu.ops.int8 import _int8_matmul_bwd
from accelerate_tpu.state import AcceleratorState as JState, GradientState as JGradientState
from accelerate_tpu.utils.dataclasses import Fp8RecipeKwargs as JRecipe

import accelerate_tpu_torch as T
from accelerate_tpu_torch.ops.int8 import _Int8Matmul
from accelerate_tpu_torch.ops.kernels.int8_matmul import BLOCK_K, SMEM_LIMIT, plan
from accelerate_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

SEED = 5
WIDTHS = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
LR, LOSS_ATOL = 3e-4, 3e-3


def test_recipe_validation_and_kwargs_match_jax():
    for backend in ("int8", "bf16"):
        got, want = T.Fp8RecipeKwargs(backend=backend), JRecipe(backend=backend)
        assert got.backend == want.backend and got.to_kwargs() == want.to_kwargs()
    for bad in ("fp8", "INT8", "e4m3"):
        with pytest.raises(ValueError, match="int8|bf16"):
            T.Fp8RecipeKwargs(backend=bad)
        with pytest.raises(ValueError, match="int8|bf16"):
            JRecipe(backend=bad)
    with pytest.raises(ValueError, match="only pass one"):
        T.Accelerator(device="cpu", kwargs_handlers=[T.Fp8RecipeKwargs(), T.Fp8RecipeKwargs()])
    with pytest.raises(TypeError, match="KwargsHandler"):
        T.Accelerator(device="cpu", kwargs_handlers=[object()])


def test_fp8_backend_matches_jax():
    cases = [("fp8", None, "INT8"), ("fp8", "bf16", "BF16"), ("fp8", "int8", "INT8"),
             ("bf16", None, None), ("fp16", None, None), ("no", None, None)]
    for mode, backend, want in cases:
        handlers = [T.Fp8RecipeKwargs(backend=backend)] if backend else None
        acc = T.Accelerator(mixed_precision=mode, device="cpu", kwargs_handlers=handlers)
        JState._reset_state()  # the JAX package's state is a process-wide singleton
        JGradientState._reset_state()
        jacc = JAccelerator(mixed_precision=mode,
                            kwargs_handlers=[JRecipe(backend=backend)] if backend else None)
        assert acc.fp8_backend == jacc.fp8_backend == want
        assert acc.state.compute_dtype == {"fp8": torch.bfloat16, "bf16": torch.bfloat16,
                                           "fp16": torch.float16, "no": torch.float32}[mode]


def _models():
    jm = JLlama(JConfig.tiny(**WIDTHS))
    jm.init_params(jax.random.key(0))
    tm = T.Llama(T.LlamaConfig.tiny(attention_impl="flash", **WIDTHS), device="cpu")
    tm.params = T.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                          tm.config, device="cpu")
    return jm, tm


def test_prepare_swaps_to_int8_and_trains_as_jax():
    """``prepare`` gives the model a config with ``matmul_precision="int8"``
    (a new config: the caller's stays ``"default"``) and the fused steps
    agree with JAX's fp8 steps at the pins."""
    jm, tm = _models()
    shared = tm.config
    jacc = JAccelerator(mixed_precision="fp8")
    jpm, jpo = jacc.prepare(jm, optax.adamw(LR))
    jstep = jacc.build_train_step(jpm, jpo)
    acc = T.Accelerator(mixed_precision="fp8", device="cpu")
    pm, po = acc.prepare(tm, T.adamw(LR, device="cpu"))
    assert pm.module.config.matmul_precision == jpm.handle.module.config.matmul_precision \
        == "int8"
    assert shared.matmul_precision == "default" and pm.module.config is not shared
    step = acc.build_train_step(pm, po)
    rng = np.random.default_rng(SEED)
    for _ in range(4):
        ids = rng.integers(0, 256, (8, 64)).astype(np.int32)
        batch = {"input_ids": ids, "labels": ids}
        assert abs(float(step(batch, clip_norm=1.0)) - float(jstep(batch, clip_norm=1.0))) \
            <= LOSS_ATOL
    for a, b in zip(jax.tree_util.tree_leaves(jpm.handle.params), tree_leaves(pm.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2 * LR * 4, rtol=0)


def test_fp8_training_falls_and_bf16_recipe_leaves_matmuls_alone():
    """JAX's cases: fp8 trains (the loss falls over 8 adam(1e-2) steps on a
    repeated batch); the bf16 recipe keeps ``"default"`` matmuls."""
    acc = T.Accelerator(mixed_precision="fp8", device="cpu")
    model = T.Llama(T.LlamaConfig.tiny(), device="cpu")
    model.init_params(0)
    assert model.config.matmul_precision == "default"
    pm, po = acc.prepare(model, T.adam(1e-2, device="cpu"))
    assert pm.module.config.matmul_precision == "int8"
    step = acc.build_train_step(pm, po)
    ids = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(np.int32)
    losses = [float(step({"input_ids": ids, "labels": ids})) for _ in range(8)]
    assert losses[-1] < losses[0], losses
    bf16 = T.Accelerator(mixed_precision="fp8", device="cpu",
                         kwargs_handlers=[T.Fp8RecipeKwargs(backend="bf16")])
    model = T.Llama(T.LlamaConfig.tiny(), device="cpu")
    model.init_params(0)
    pm, _ = bf16.prepare(model, T.adam(1e-2, device="cpu"))
    assert pm.module.config.matmul_precision == "default"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_straight_through_backward_matches_int8_matmul_bwd(dtype):
    """The port's backward (f32 products, cast to the operands' dtype)
    against JAX's ``_int8_matmul_bwd`` on the same (x, w, g), at a block
    projection's layout: x (B, S, K), w (K, N)."""
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
    g = rng.standard_normal((2, 24, 48)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx, jw, jg = (jnp.asarray(a).astype(jdt) for a in (x, w, g))
    jdx, jdw = _int8_matmul_bwd((jx, jw), jg)
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    tw = torch.tensor(w).to(tdt).requires_grad_(True)
    out = _Int8Matmul.apply(tx, tw, None)
    out.backward(torch.tensor(g).to(tdt))
    for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        want = np.asarray(want.astype(jnp.float32))
        rtol = 1e-5 if dtype == "float32" else 2.0**-8
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                                   atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)])
def test_plan_partitions_every_projection_at_training_rows(K, N):
    """``plan()`` at M = 4096 (2 x 2048 tokens) on Llama-3-8B's four
    projection shapes, bf16, on an H100's 132 SMs: a partition whose K
    slices cover K in order, none empty, within a block's shared memory,
    with 128-row tiles (32 of them a CTA walks in turn)."""
    p = plan(4096, N, K, 2, 132)
    assert p is not None and p.mt == 128 and p.smem <= SMEM_LIMIT and p.cluster <= 8
    slices = p.k_slices()
    assert slices[0][0] == 0 and slices[-1][1] == p.kblocks * BLOCK_K >= K
    assert all(a < b for a, b in slices) and all(s[1] == t[0] for s, t in zip(slices, slices[1:]))
    assert p.panels * p.nt >= N
