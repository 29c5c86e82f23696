"""Parity of the port's fused (vocab-chunked) cross-entropy with the JAX package's.

The same hidden states, head table and labels (numpy, seed below) go through
``accelerate_tpu.ops.losses.fused_cross_entropy_loss`` (values and gradients
for the hidden states and the head from ``jax.value_and_grad``) and through
the port's, with autograd. The grid: the custom single-pass backward and the
differentiated chunk loop ("ad"); a tied (V, h) table and an untied (h, V)
head; Gemma-2's final logit softcap; z-loss; ignored positions; fp32 and
bf16 chunk dtypes; a vocabulary that the chunk does not divide (a ragged
tail). The port's fused loss is also held to its own unfused
``cross_entropy_loss`` on the full logits.

Tolerances, with their reasons: fp32 chunks compute in fp32 on the CPU in
both frameworks, sums in another order — ``atol=1e-5`` on the loss (about 5)
and on gradients (at most about 0.17). bf16 chunks round the chunk logits and
their exp to bf16 in both; the row sums and the gradient products then run
in another order over bf16-rounded terms: ``atol=5e-4`` on the loss and
``2e-4`` on the custom backward's gradients (largest differences seen:
8.2e-5 and 1.1e-4). The differentiated bf16 loop ("ad") also rounds its
cotangents to bf16 op by op, where XLA fuses the backward and rounds at
fewer places, and its max and exp paths cancel in bf16: ``3e-3`` on its
gradients (largest seen 1.4e-3; the JAX package's own custom and "ad"
gradients differ by up to 8.3e-4 on these inputs, and its tests hold bf16
chunks to 2e-2 of the exact loss).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models.llama import LlamaConfig as JLlamaConfig
from accelerate_tpu.ops.losses import fused_cross_entropy_loss as j_fused
from accelerate_tpu_torch.models.llama import LlamaConfig
from accelerate_tpu_torch.ops.losses import cross_entropy_loss, fused_cross_entropy_loss

torch.set_num_threads(2)

SEED = 17
B, S, H, V, CHUNK = 2, 12, 32, 100, 32  # 3 full chunks and a tail of 4


@pytest.fixture(autouse=True)
def _f32_jax_matmuls():
    with jax.default_matmul_precision("float32"):
        yield


def _inputs(tied: bool, holes: bool, seed=SEED):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, H)).astype(np.float32)
    w = (rng.standard_normal((V, H) if tied else (H, V)) / np.sqrt(H)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    if holes:
        labels[0, :3] = -100
        labels[1, -1] = -100
    return hidden, w, labels


@pytest.mark.parametrize("chunk_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("custom_backward", [True, False], ids=["custom", "ad"])
@pytest.mark.parametrize("tied,cap,z_loss,holes", [
    (True, 30.0, 0.0, True),
    (False, None, 1e-4, True),
    (True, None, 0.0, False),
    (False, 5.0, 1e-3, False),
], ids=["tied-cap-holes", "untied-zloss-holes", "tied-plain", "untied-cap-zloss"])
def test_fused_loss_matches_jax(chunk_dtype, custom_backward, tied, cap, z_loss, holes):
    hidden, w, labels = _inputs(tied, holes)
    kw = dict(vocab_chunk=CHUNK, logit_cap=cap, z_loss=z_loss, chunk_dtype=chunk_dtype,
              head_transposed=tied, custom_backward=custom_backward)
    want, (want_dh, want_dw) = jax.value_and_grad(
        lambda h, w: j_fused(h, w, jnp.asarray(labels), **kw), argnums=(0, 1))(hidden, w)
    th, tw = torch.tensor(hidden, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = fused_cross_entropy_loss(th, tw, torch.tensor(labels), **kw)
    got.backward()
    if chunk_dtype == "fp32":
        loss_atol, grad_atol = 1e-5, 1e-5
    else:
        loss_atol, grad_atol = 5e-4, (2e-4 if custom_backward else 3e-3)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=loss_atol, rtol=0)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh), atol=grad_atol, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), atol=grad_atol, rtol=0)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("cap", [None, 30.0], ids=["uncapped", "capped"])
def test_fused_loss_matches_unfused_loss(tied, cap):
    """Against the full logits: the same loss and gradients, both backward
    strategies; a chunk wider than the vocabulary is one chunk."""
    hidden, w, labels = _inputs(tied, holes=True)
    th, tw = torch.tensor(hidden, requires_grad=True), torch.tensor(w, requires_grad=True)
    logits = th @ (tw.T if tied else tw)
    if cap is not None:
        logits = torch.tanh(logits / cap) * cap
    want = cross_entropy_loss(logits, torch.tensor(labels), z_loss=1e-4)
    want_grads = torch.autograd.grad(want, (th, tw))
    for custom in (True, False):
        for chunk in (CHUNK, 7, 4 * V):
            got = fused_cross_entropy_loss(th, tw, torch.tensor(labels), vocab_chunk=chunk,
                                           logit_cap=cap, z_loss=1e-4, head_transposed=tied,
                                           custom_backward=custom)
            grads = torch.autograd.grad(got, (th, tw))
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
            for a, b in zip(grads, want_grads):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_fused_loss_rejects_what_jax_rejects():
    hidden, w, labels = _inputs(True, False)
    args = (torch.tensor(hidden), torch.tensor(w), torch.tensor(labels))
    with pytest.raises(ValueError, match="chunk_dtype"):
        fused_cross_entropy_loss(*args, chunk_dtype="fp16", head_transposed=True)
    with pytest.raises(ValueError, match="vocab_chunk"):
        fused_cross_entropy_loss(*args, vocab_chunk=0, head_transposed=True)
    # The chunk scan's unroll is a config field in both packages, checked
    # where the config is built.
    for config_cls in (JLlamaConfig, LlamaConfig):
        with pytest.raises(ValueError, match="fused_loss_unroll"):
            config_cls(fused_loss_unroll=-1)
