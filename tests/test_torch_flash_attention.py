"""Parity of the port's flash attention with the JAX package's.

The same q, k, v and output cotangent (numpy, seed below) go through the
library's reference attention, ``mha_reference_no_custom_vjp`` (the plain
version the JAX flash kernel is tested against; values and gradients from
one ``jax.vjp``), and through the port's ``flash_attention_reference``,
which is what ``impl="flash"`` runs for a CPU tensor. Layouts: the
library's is (B, H, S, D), the port's (B, S, H, D).

Every JAX reference here runs under ``jax.default_matmul_precision("float32")``
(the fixture below). The library's jitted ``mha_reference`` sets
``"bfloat16"`` (DEFAULT precision) on its einsums, and eager einsums default
to DEFAULT too. At DEFAULT precision XLA may compute f32 products with
fewer bits (x86 hosts with AMX or AVX-512 bf16 units can), and then the
tolerances below do not hold: one run of the whole suite failed the first
case here with a forward mismatch of up to 9.2e-5 in 12% of the elements,
where full f32 products summed in another order differ by at most 5e-7.

Tolerances, with their reasons: fp32 on the CPU in both frameworks, with
sums in another order — ``atol=1e-5`` on values (O(1)) and ``atol=1e-4`` on
gradients (O(1-10)). Against ``dense_attention`` only real-token rows are
compared: a pad row sees only pads under segment ids, but every real key
under dense's key mask.

The CUDA kernel is held against the plain version on the card by the
``cuda``-marked tests of ``tests/test_torch_package.py`` (a file without
JAX, so they run there) and by ``chip_smoke.py`` at the Llama-3-8B shape.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
    mha_reference_no_custom_vjp,
)

from accelerate_tpu.ops.attention import dense_attention as j_dense_attention
from chip_smoke import FLASH_FWD_TILE_REL, tile_rel_err
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ,
    attention,
    dense_attention,
    flash_attention,
    flash_attention_reference,
    resolve_auto_impl,
)

torch.set_num_threads(2)

SEED = 11
VALUE_ATOL = 1e-5
GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _f32_jax_matmuls():
    """Full f32 products in every JAX reference of a test (thread-local,
    undone after the test), compiled in this test: the worker's persistent
    compilation cache and its in-memory executables are set aside for the
    test and restored after it, and torch's f32 matmuls are pinned to full
    precision.

    Under the suite's xdist run a worker that has built an ``Accelerator``
    earlier routes every XLA compile through the persistent cache that all
    workers and their launched subprocesses share (``tests/conftest.py``
    sets ``ACCELERATE_COMPILE_CACHE_DIR``, ``AcceleratorState`` turns it on
    with a minimum compile time of 0), and the cache stays on for the rest
    of that worker's life. The first case here then failed in one such run
    and passed alone; with no executable loaded from the shared cache or
    left from an earlier test's config, each reference is what this test
    compiles under its own precision."""
    from jax._src import compilation_cache

    cache_dir = jax.config.jax_compilation_cache_dir
    torch_precision = torch.get_float32_matmul_precision()
    compilation_cache.reset_cache()
    jax.config.update("jax_compilation_cache_dir", None)
    jax.clear_caches()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("float32"):
            yield
    finally:
        torch.set_float32_matmul_precision(torch_precision)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        compilation_cache.reset_cache()


def _seg(B, S):
    seg = np.full((B, S), 2, np.int32)
    seg[1, -S // 5:] = 1  # right padding on the second row
    return seg


def _attention_f64(q, k, v, seg, scale):
    """The same causal attention in float64 numpy, (B, H, S, D)."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    S = q.shape[2]
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    keep = np.tril(np.ones((S, S), bool))[None, None]
    if seg is not None:
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    logits = np.where(keep, logits, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v)


def _drift_report(got, want, q, k, v, seg, scale):
    """Which side left full f32 precision when the forward values differ:
    each side's largest distance from the float64 evaluation."""
    exact = _attention_f64(q, k, v, seg, scale)
    return (f"max |port - f64| = {np.abs(got - exact).max():.3e}, "
            f"max |jax - f64| = {np.abs(want - exact).max():.3e}")


def _bhsd_to_port(x):
    return torch.tensor(np.asarray(x)).transpose(1, 2).contiguous()


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("with_segments", [False, True], ids=["causal", "causal+segments"])
def test_plain_flash_matches_mha_reference(S, D, with_segments):
    B, H = 2, 2
    rng = np.random.default_rng(SEED)
    q, k, v, do = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    seg = _seg(B, S) if with_segments else None
    jseg = None if seg is None else SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    tseg = None if seg is None else torch.tensor(seg)

    want, vjp = jax.vjp(lambda q, k, v: mha_reference_no_custom_vjp(
        q, k, v, None, segment_ids=jseg, causal=True, sm_scale=scale), q, k, v)
    want = np.asarray(want)
    want_grads = vjp(jnp.asarray(do))

    tq, tk, tv = (_bhsd_to_port(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_reference(tq, tk, tv, segment_ids=tseg, causal=True, sm_scale=scale)
    got = out.detach().transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, atol=VALUE_ATOL, rtol=0,
                               err_msg=_drift_report(got, want, q, k, v, seg, scale))
    out.backward(_bhsd_to_port(do))
    for got, ref in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(got.grad.transpose(1, 2).numpy(), np.asarray(ref),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("with_mask", [False, True], ids=["causal", "padded"])
def test_gqa_flash_matches_repeated_mha_reference(with_mask):
    """GQA: the port repeats KV heads itself; its gradient w.r.t. each KV
    head is the sum over that head's G query heads (the repeat's VJP)."""
    B, S, H, Hkv, D = 2, 128, 4, 2, 64
    rng = np.random.default_rng(SEED)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    mask = _seg(B, S) - 1 if with_mask else None  # 1 = real token
    scale = 1.0 / math.sqrt(D)

    def jax_fn(q, k, v):
        k, v = jnp.repeat(k, H // Hkv, axis=2), jnp.repeat(v, H // Hkv, axis=2)
        t = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
        seg = None
        if mask is not None:
            s = jnp.where(jnp.asarray(mask).astype(bool), 2, 1).astype(jnp.int32)
            seg = SegmentIds(q=s, kv=s)
        return t(mha_reference_no_custom_vjp(t(q), t(k), t(v), None, segment_ids=seg,
                                             causal=True, sm_scale=scale))

    want, vjp = jax.vjp(jax_fn, q, k, v)
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True,
                          mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=VALUE_ATOL, rtol=0)
    out.backward(torch.tensor(do))
    for got, ref in zip((tq, tk, tv), want_grads):
        assert got.grad.shape == ref.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=GRAD_ATOL, rtol=0)


def test_flash_matches_dense_attention_on_real_rows():
    B, S, H, D = 2, 128, 2, 64
    rng = np.random.default_rng(SEED)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    mask = _seg(B, S) - 1
    want = np.asarray(j_dense_attention(q, k, v, causal=True, mask=jnp.asarray(mask)))
    got = attention(*(torch.tensor(x) for x in (q, k, v)), causal=True,
                    mask=torch.tensor(mask), impl="flash").numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=VALUE_ATOL, rtol=0)


def test_auto_resolution_and_dispatch():
    # The JAX default crossover, for a CUDA tensor only, at the head widths
    # the kernel takes (the JAX predicate also admits 96 and 256).
    assert FLASH_MIN_SEQ == 1024
    for S, D, want in [(2048, 128, "flash"), (1024, 128, "flash"), (1024, 64, "flash"),
                       (512, 128, "dense"), (1152, 128, "flash"), (1100, 128, "dense"),
                       (2048, 80, "dense"), (2048, 96, "dense"), (2048, 256, "dense")]:
        assert resolve_auto_impl(S, D, device="cuda") == want, (S, D)
        assert resolve_auto_impl(S, D, device="cpu") == "dense"
    assert resolve_auto_impl(2048, 128, kv_len=1024, device="cuda") == "dense"
    assert resolve_auto_impl(2048, 128, window=64, device="cuda",
                             dtype=torch.bfloat16) == "splash"
    assert resolve_auto_impl(2048, 128, device="cuda", dtype=torch.bfloat16) == "flash"
    assert resolve_auto_impl(2048, 128, device="cuda", dtype=torch.float32) == "dense"
    # impl="flash" on the CPU runs the plain version through the registry
    # and launches nothing.
    x = torch.randn((1, 128, 2, 64), generator=torch.Generator().manual_seed(SEED))
    registry.reset_launch_counts()
    out = attention(x, x, x, impl="flash")
    assert registry.launch_counts == {}
    torch.testing.assert_close(out, flash_attention_reference(x, x, x, causal=True,
                                                              sm_scale=1 / 8.0))
    # impl="ring" or "ulysses" without a process group is dense attention
    # here (the JAX package's ring and Ulysses on a mesh without an sp axis).
    torch.testing.assert_close(attention(x, x, x, impl="ring"),
                               dense_attention(x, x, x, causal=True), rtol=0, atol=0)
    torch.testing.assert_close(attention(x, x, x, impl="ulysses"),
                               dense_attention(x, x, x, causal=True), rtol=0, atol=0)
    with pytest.raises(ValueError, match="dense path"):
        attention(x, x, x, impl="flash", window=8)


def test_forward_tile_pin_catches_a_dropped_kv_tile():
    """``chip_smoke.py`` holds the flash kernel's forward to the plain
    version per 64-row query tile, relative to the tile's own size. A kernel
    that skipped one KV tile (keys 320-383) for one late query tile (rows
    1920-1983) moves that tile by far more than the pin, though its largest
    absolute error stays under 6.25e-2, two bf16 spacings on [4, 8), which a
    whole-tensor absolute pin would have to allow: causal outputs shrink
    along the sequence, row i as sqrt(e / (i + 1))."""
    B, S, H, D = 1, 2048, 2, 128
    g = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn((B, S, H, D), generator=g).to(torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    ref = flash_attention_reference(q, k, v, causal=True, sm_scale=scale)
    rows = torch.arange(30 * 64, 31 * 64)
    keys = torch.arange(S)
    keep = (keys[None, :] <= rows[:, None]) & (keys[None, :] // 64 != 5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q[:, rows].float(), k.float()) * scale
    weights = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
    bad = ref.clone()
    bad[:, rows] = torch.einsum("bhqk,bkhd->bqhd", weights, v.float()).to(torch.bfloat16)
    real = torch.ones((B, S), dtype=torch.bool)
    assert tile_rel_err(ref, ref, real) == 0.0
    assert tile_rel_err(bad, ref, real) > 5 * FLASH_FWD_TILE_REL
    assert float((bad.float() - ref.float()).abs().max()) < 6.25e-2
