"""Parity of the port's splash attention with the JAX package's.

The same q, k, v and output cotangent (numpy, seed below) go through:

- the JAX package's own ``accelerate_tpu.ops.attention.splash_attention``,
  which reaches the library splash kernel (``make_splash_mha``). The kernel
  is written for the TPU; here it runs in Pallas interpret mode: the test
  replaces ``splash_attention_kernel.make_splash_mha`` with the same function
  and ``interpret=True`` (a pytest ``monkeypatch`` of the library module;
  nothing of the JAX package changes). Values and gradients come from one
  ``jax.vjp`` through the kernel's own custom backward;
- the port's ``splash_attention`` on CPU tensors, which runs its plain
  version ``splash_attention_reference`` through the registry (values from
  the forward, gradients from autograd).

The cases cover a window alone, a softcap alone, a query scale alone and all
three; with and without right padding (pads see only pads, through segment
ids); GQA; head widths 128 and 256; S of 256 and 384 with windows small
enough that the library's 128-key blocks are skipped; logits of standard
deviation 16 against a cap of 50, so that the cap bends them; and a window
of 100 at S=384, where the library kernel's first visited block is wholly
masked for the last rows of a query block (keys 128-255 for row 383, which
sees keys 284-383): the online max must recover from its ``MASK_VALUE``
start. Every row is compared, pads included.

Tolerances, with their reasons: fp32 on the CPU in both frameworks, sums in
another order — ``atol=1e-5`` on values (O(1)) and ``atol=1e-4`` on
gradients (O(1-10)), the flash test's pins; the largest differences seen are
1e-6 and 2.6e-6. The case whose logits reach the cap has larger gradients
and its own stated pin (``GRAD_ATOL_AT_THE_CAP``). JAX runs under
``jax.default_matmul_precision("float32")`` (the fixture below;
``tests/test_torch_flash_attention.py`` says why).

The CUDA kernel is held against the plain version on the card by the
``cuda``-marked tests of ``tests/test_torch_package.py`` and by
``chip_smoke.py`` at the Gemma-2-9B shapes.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_kernel as sk

from accelerate_tpu.ops.attention import attention as j_attention
from accelerate_tpu.ops.attention import dense_attention as j_dense_attention
from accelerate_tpu.ops.attention import splash_attention as j_splash_attention
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ,
    attention,
    resolve_auto_impl,
    splash_attention,
    splash_attention_reference,
)

torch.set_num_threads(2)

SEED = 13
VALUE_ATOL = 1e-5
GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _f32_jax_matmuls():
    with jax.default_matmul_precision("float32"):
        yield


@pytest.fixture
def interpret_splash(monkeypatch):
    """The library splash kernel in Pallas interpret mode (runs on the CPU)."""
    monkeypatch.setattr(sk, "make_splash_mha",
                        functools.partial(sk.make_splash_mha, interpret=True))


def _inputs(B, S, H, Hkv, D, padded, seed=SEED):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    mask = None
    if padded:
        mask = np.ones((B, S), np.int32)
        mask[1, -S // 5:] = 0  # right padding on the second row
    return q, k, v, do, mask


CASES = {
    # name: (S, H, Hkv, D, padded, window, softcap, scale)
    "window-gqa": (256, 4, 2, 128, False, 64, None, None),
    "softcap-padded": (256, 2, 2, 128, True, None, 20.0, None),
    "scale-d256": (256, 2, 1, 256, False, None, None, 0.1),
    "all-d256-padded": (256, 2, 2, 256, True, 64, 30.0, 1 / 16),
    "all-gqa-padded": (256, 4, 2, 128, True, 64, 50.0, 0.08),
    "all-s384-first-block-masked": (384, 2, 2, 128, False, 100, 20.0, 0.1),
    # Scale 1 on unit inputs: logits of standard deviation 16 against a cap
    # of 50, where the cap bends them (the cases above barely reach theirs).
    "logits-at-the-cap-d256-padded": (256, 2, 2, 256, True, 64, 50.0, 1.0),
}
# The logits-at-the-cap case's gradients reach 44 (dq), ten times the other
# cases': its largest difference seen is 9.5e-5, so it is held to 2e-4, which
# is 4.5e-6 of its largest gradient. Without the cap the port's gradients
# would miss the library's by 24.
GRAD_ATOL_AT_THE_CAP = 2e-4


@pytest.mark.parametrize("case", list(CASES))
def test_plain_splash_matches_jax_splash_kernel(case, interpret_splash):
    S, H, Hkv, D, padded, window, softcap, scale = CASES[case]
    q, k, v, do, mask = _inputs(2, S, H, Hkv, D, padded)
    kw = dict(window=window, softcap=softcap, scale=scale)
    jmask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda q, k, v: j_splash_attention(q, k, v, causal=True, mask=jmask,
                                                           **kw), q, k, v)
    want_grads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    registry.reset_launch_counts()
    out = splash_attention(tq, tk, tv, causal=True,
                           mask=None if mask is None else torch.tensor(mask), **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=VALUE_ATOL, rtol=0)
    out.backward(torch.tensor(do))
    assert registry.launch_counts == {}
    for got, ref in zip((tq, tk, tv), want_grads):
        assert got.grad.shape == ref.shape
        atol = GRAD_ATOL_AT_THE_CAP if case == "logits-at-the-cap-d256-padded" else GRAD_ATOL
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("window,softcap,padded", [(None, None, False), (48, 30.0, False),
                                                   (None, 10.0, True), (100, None, True)],
                         ids=["causal", "window-softcap", "softcap-segments",
                              "window-segments"])
def test_plain_splash_matches_library_attention_reference(window, softcap, padded):
    """The plain version on pre-scaled q against the library's
    ``attention_reference``, head by head, with the local or causal mask
    and segment ids built as the JAX wrapper builds them."""
    B, S, H, D = 2, 192, 2, 64
    q, k, v, _, mask = _inputs(B, S, H, H, D, padded)
    rows, cols = np.arange(S)[:, None], np.arange(S)[None, :]
    dense_mask = cols <= rows
    if window is not None:
        dense_mask &= rows - cols < window
    seg = None if mask is None else np.where(mask.astype(bool), 2, 1).astype(np.int32)
    want = np.zeros((B, S, H, D), np.float32)
    for b in range(B):
        ids = None if seg is None else sk.SegmentIds(q=jnp.asarray(seg[b]), kv=jnp.asarray(seg[b]))
        for h in range(H):
            want[b, :, h] = np.asarray(sk.attention_reference(
                jnp.asarray(dense_mask), q[b, :, h], k[b, :, h], v[b, :, h], ids,
                attn_logits_soft_cap=softcap))
    got = splash_attention_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        segment_ids=None if seg is None else torch.tensor(seg), window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, atol=VALUE_ATOL, rtol=0)


def test_splash_matches_dense_attention_on_real_rows():
    """The same recipe through splash and dense agree where both are
    defined alike: on real-token rows (a pad row sees only pads under
    segment ids, but every real key under dense's key mask)."""
    q, k, v, _, mask = _inputs(2, 256, 4, 2, 128, padded=True)
    kw = dict(window=64, softcap=50.0, scale=1 / 16)
    k_rep, v_rep = (np.repeat(x, 2, axis=2) for x in (k, v))
    want = np.asarray(j_dense_attention(q, k_rep, v_rep, causal=True, mask=jnp.asarray(mask),
                                        **kw))
    got = attention(*(torch.tensor(x) for x in (q, k, v)), causal=True,
                    mask=torch.tensor(mask), impl="splash", **kw).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=VALUE_ATOL, rtol=0)


def test_unshaped_splash_impl_runs_dense_as_in_jax():
    """``impl="splash"`` with no window, softcap or scale falls through to
    dense in the JAX package's ``attention``, so it does in the port: every
    row agrees, pad rows included (dense keeps real keys in view of a pad
    row, where splash's segment ids would show it only pads)."""
    q, k, v, _, mask = _inputs(2, 256, 4, 2, 128, padded=True)
    k_rep, v_rep = (np.repeat(x, 2, axis=2) for x in (k, v))
    want = np.asarray(j_attention(q, k_rep, v_rep, causal=True, mask=jnp.asarray(mask),
                                  impl="splash"))
    registry.reset_launch_counts()
    got = attention(*(torch.tensor(x) for x in (q, k_rep, v_rep)), causal=True,
                    mask=torch.tensor(mask), impl="splash").numpy()
    assert registry.launch_counts == {}
    np.testing.assert_allclose(got, want, atol=VALUE_ATOL, rtol=0)


@pytest.mark.parametrize("S,D,recipe,device,dtype,kv_len,causal,want", [
    (8192, 256, dict(window=4096, softcap=50.0, scale=1 / 16), "cuda", torch.bfloat16, None,
     True, "splash"),
    (8192, 256, dict(softcap=50.0, scale=1 / 16), "cuda", torch.bfloat16, None, True, "splash"),
    (4096, 128, dict(window=4096), "cuda", torch.bfloat16, None, True, "splash"),
    (1024, 64, dict(scale=0.1), "cuda", None, None, True, "splash"),
    (512, 256, dict(softcap=50.0), "cuda", torch.bfloat16, None, True, "dense"),
    (1100, 128, dict(window=64), "cuda", torch.bfloat16, None, True, "dense"),
    (2048, 96, dict(window=64), "cuda", torch.bfloat16, None, True, "dense"),
    (2048, 256, dict(softcap=50.0), "cuda", torch.float32, None, True, "dense"),
    (2048, 256, dict(softcap=50.0), "cpu", torch.bfloat16, None, True, "dense"),
    (2048, 128, dict(window=64), "cuda", torch.bfloat16, 1024, True, "dense"),
    (2048, 128, dict(window=64), "cuda", torch.bfloat16, None, False, "dense"),
    (2048, 256, dict(), "cuda", torch.bfloat16, None, True, "dense"),
    (2048, 128, dict(), "cuda", torch.bfloat16, None, True, "flash"),
])
def test_auto_resolution_table(S, D, recipe, device, dtype, kv_len, causal, want):
    assert FLASH_MIN_SEQ == 1024
    assert resolve_auto_impl(S, D, kv_len=kv_len, causal=causal, device=device, dtype=dtype,
                             **recipe) == want


def test_splash_on_cpu_runs_the_plain_version_and_launches_nothing():
    g = torch.Generator().manual_seed(SEED)
    q = torch.randn((1, 128, 2, 64), generator=g)
    k, v = torch.randn((1, 128, 1, 64), generator=g), torch.randn((1, 128, 1, 64), generator=g)
    registry.reset_launch_counts()
    out = attention(q, k, v, impl="splash", window=32, softcap=5.0)
    auto = attention(q, k, v, window=32, softcap=5.0)  # a CPU tensor resolves to dense
    assert registry.launch_counts == {}
    k_rep, v_rep = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
    torch.testing.assert_close(out, splash_attention_reference(q / 8.0, k_rep, v_rep, window=32,
                                                               softcap=5.0))
    torch.testing.assert_close(out, auto, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="causal-only"):
        splash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="equal q/kv lengths"):
        splash_attention(q, k[:, :64], v[:, :64])
    with pytest.raises(ValueError, match="dense path or splash"):
        attention(q, k, v, impl="flash", window=8)
