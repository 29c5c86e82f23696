"""Parity of the PyTorch port's paged-attention ops with the JAX reference.

Inputs are made with numpy from a stated seed and go through both packages
on the CPU. The port's CPU path is the plain PyTorch version of each op (the
CUDA kernel runs only on the card; chip_smoke.py holds it against the plain
version there). Tolerances, with their reasons:

- the paged gather, with and without int8 dequant, is pure data movement
  plus one f32 multiply and one cast: bitwise, against both JAX's
  ``gather_block_view`` and the Pallas ``gather_block_view_kernel`` run in
  interpret mode (on active slots; the kernel zeroes inactive ones);
- ``quantize_kv``/``dequantize_kv``: bitwise (an f32 division, then round
  half to even in both frameworks);
- attention: fp32 softmax and einsums whose sums run in another order,
  ``atol=rtol=1e-5``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accelerate_tpu.ops import attention as jattn
from accelerate_tpu.ops import int8 as jint8
from accelerate_tpu.ops import paged_attention as jpaged
from accelerate_tpu.ops.pallas.paged_decode import gather_block_view_kernel
from accelerate_tpu_torch.ops import attention as tattn
from accelerate_tpu_torch.ops import int8 as tint8
from accelerate_tpu_torch.ops import paged_attention as tpaged
from accelerate_tpu_torch.ops import registry

torch.set_num_threads(2)

SEED = 1234


def _pool_case(quant: bool, stacked: bool, seed=SEED):
    """A pool with ragged chains, trash-block (0) table tails and two
    inactive slots. Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    L, N, bs, H, D, B, M = 3, 13, 4, 2, 16, 5, 4
    shape = ((L,) if stacked else ()) + (N, bs, H, D)
    if quant:
        pool = rng.integers(-127, 128, shape).astype(np.int8)
        scales = rng.uniform(1e-3, 0.1, shape[:-2]).astype(np.float32)
    else:
        pool = rng.standard_normal(shape).astype(np.float32)
        scales = None
    tables = np.zeros((B, M), np.int32)
    free = rng.permutation(np.arange(1, N))
    for b, n in enumerate((4, 2, 0, 3, 1)):
        tables[b, :n], free = free[:n], free[n:]
    active = np.array([1, 1, 0, 1, 0], bool)
    return pool, scales, tables, active


@pytest.mark.parametrize("stacked", [False, True], ids=["4d", "L-stacked"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-pool", "int8-pool"])
def test_gather_block_view_bitwise_vs_jax(quant, stacked):
    pool, scales, tables, active = _pool_case(quant, stacked)
    kw_j = {"scales": jnp.asarray(scales)} if quant else {}
    kw_t = {"scales": torch.as_tensor(scales)} if quant else {}
    ref = np.asarray(jpaged.gather_block_view(jnp.asarray(pool), jnp.asarray(tables), **kw_j))
    pallas = np.asarray(gather_block_view_kernel(
        jnp.asarray(pool), jnp.asarray(tables), active=jnp.asarray(active), interpret=True,
        **kw_j))
    got = tpaged.gather_block_view(torch.as_tensor(pool), torch.as_tensor(tables),
                                   active=torch.as_tensor(active), **kw_t).numpy()
    assert got.shape == ref.shape == pallas.shape
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))
    slot_axis = got.ndim - 4
    on = np.take(got, np.nonzero(active)[0], axis=slot_axis)
    np.testing.assert_array_equal(on, np.take(pallas, np.nonzero(active)[0], axis=slot_axis))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gather_dequant_out_dtype_bitwise_vs_jax(out_dtype):
    pool, scales, tables, _ = _pool_case(quant=True, stacked=True, seed=SEED + 1)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[out_dtype]
    ref = jpaged.gather_block_view(jnp.asarray(pool), jnp.asarray(tables),
                                   scales=jnp.asarray(scales), out_dtype=jdt)
    got = tpaged.gather_block_view(torch.as_tensor(pool), torch.as_tensor(tables),
                                   scales=torch.as_tensor(scales), out_dtype=out_dtype)
    assert got.dtype == out_dtype
    ref32 = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), ref32.view(np.uint32))


def test_gather_view_dispatches_plain_on_cpu_and_counts_no_launch():
    pool, _, tables, active = _pool_case(quant=False, stacked=True)
    registry.reset_launch_counts()
    args = (torch.as_tensor(pool), torch.as_tensor(tables))
    for spec in (None, "kernel", "off"):
        got = tpaged.gather_view(*args, active=torch.as_tensor(active), kernels=spec)
        np.testing.assert_array_equal(got.numpy(), tpaged.gather_block_view(*args).numpy())
    assert registry.launch_counts == {}
    with pytest.raises(ValueError, match="unknown kernels spec"):
        tpaged.gather_view(*args, kernels="pallas")


def test_gather_block_mask_matches_jax():
    rng = np.random.default_rng(SEED)
    mask = rng.integers(0, 2, (13, 4)).astype(np.int32)
    _, _, tables, _ = _pool_case(quant=False, stacked=False)
    ref = np.asarray(jpaged.gather_block_mask(jnp.asarray(mask), jnp.asarray(tables)))
    got = tpaged.gather_block_mask(torch.as_tensor(mask), torch.as_tensor(tables)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_quantize_dequantize_kv_bitwise_vs_jax():
    rng = np.random.default_rng(SEED)
    t = (rng.standard_normal((3, 7, 2, 16)) * rng.uniform(0.01, 10, (3, 7, 1, 1))).astype(np.float32)
    t[1, 2] = 0.0  # an all-zero row takes the scale-1 branch
    qj, sj = jint8.quantize_kv(jnp.asarray(t))
    qt, st = tint8.quantize_kv(torch.as_tensor(t))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        dj = np.asarray(jint8.dequantize_kv(qj, sj, jdt).astype(jnp.float32))
        dt = tint8.dequantize_kv(qt, st, tdt).float().numpy()
        np.testing.assert_array_equal(dt.view(np.uint32), dj.view(np.uint32))


def test_init_kv_pool_layout():
    from accelerate_tpu_torch.models import Llama, LlamaConfig

    model = Llama(LlamaConfig.tiny(), device="cpu")
    pool = tpaged.init_kv_pool(model, 6, 4, dtype=torch.float32, device="cpu")
    assert pool["k"].shape == (2, 7, 4, 2, 16) and pool["k"].dtype == torch.float32
    assert pool["mask"].shape == (7, 4) and not tpaged.pool_is_quantized(pool)
    qpool = tpaged.init_kv_pool(model, 6, 4, quant="int8", device="cpu")
    assert qpool["k"].dtype == torch.int8 and qpool["k_scale"].shape == (2, 7, 4)
    assert tpaged.pool_is_quantized(qpool)
    with pytest.raises(ValueError, match="quant"):
        tpaged.init_kv_pool(model, 6, 4, quant="fp8", device="cpu")


def _attn_case(seed=SEED):
    rng = np.random.default_rng(seed)
    B, S, H, Hkv, D, K = 2, 3, 4, 2, 8, 12
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, K, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, K, Hkv, D)).astype(np.float32)
    kv_mask = np.ones((B, K), np.int32)
    kv_mask[0, [1, 4, 5]] = 0  # holes
    kv_mask[1, [0, 7]] = 0
    q_pos = np.array([[6, 8, 10], [9, 10, 11]], np.int32)
    return q, k, v, kv_mask, q_pos


@pytest.mark.parametrize("window,softcap,scale", [
    (None, None, None), (3, None, None), (None, 5.0, 0.3), (4, 2.0, None)])
def test_cached_attention_matches_jax(window, softcap, scale):
    q, k, v, kv_mask, q_pos = _attn_case()
    ref = jattn.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(q_pos),
        kv_mask=jnp.asarray(kv_mask), window=window, softcap=softcap, scale=scale)
    got = tattn.cached_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        q_positions=torch.as_tensor(q_pos), kv_mask=torch.as_tensor(kv_mask),
        window=window, softcap=softcap, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_cached_attention_1d_positions_without_mask_matches_jax():
    q, k, v, _, _ = _attn_case(SEED + 2)
    pos = np.array([4, 5, 6], np.int32)
    ref = jattn.cached_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 q_positions=jnp.asarray(pos), window=2)
    got = tattn.cached_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                 q_positions=torch.as_tensor(pos), window=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window,softcap", [(None, None), (3, 4.0)])
def test_dense_attention_matches_jax(window, softcap):
    rng = np.random.default_rng(SEED + 3)
    q, k, v = (rng.standard_normal((2, 6, 4, 8)).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 6), np.int32)
    mask[1, :2] = 0
    ref = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                mask=jnp.asarray(mask), window=window, softcap=softcap)
    got = tattn.dense_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                mask=torch.as_tensor(mask), window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_paged_attention_reference_matches_jax():
    rng = np.random.default_rng(SEED + 4)
    pool_k, scales, tables, _ = _pool_case(quant=True, stacked=False, seed=SEED + 4)
    pool_v, v_scales, _, _ = _pool_case(quant=True, stacked=False, seed=SEED + 5)
    pool_mask = rng.integers(0, 2, (13, 4)).astype(np.int32)
    pool_mask[0] = 0
    q = rng.standard_normal((5, 2, 4, 16)).astype(np.float32)
    pos = np.array([14, 15], np.int32)
    ref = jpaged.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(tables),
        q_positions=jnp.asarray(pos), pool_mask=jnp.asarray(pool_mask), window=6,
        k_scale=jnp.asarray(scales), v_scale=jnp.asarray(v_scales))
    got = tpaged.paged_attention_reference(
        torch.as_tensor(q), torch.as_tensor(pool_k), torch.as_tensor(pool_v),
        torch.as_tensor(tables), q_positions=torch.as_tensor(pos),
        pool_mask=torch.as_tensor(pool_mask), window=6, k_scale=torch.as_tensor(scales),
        v_scale=torch.as_tensor(v_scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_repeat_and_softcap_match_jax():
    rng = np.random.default_rng(SEED + 6)
    k = rng.standard_normal((2, 3, 2, 4)).astype(np.float32)
    jk, jv = jattn.repeat_kv(jnp.asarray(k), jnp.asarray(k) * 2, 3)
    tk, tv = tattn.repeat_kv(torch.as_tensor(k), torch.as_tensor(k) * 2, 3)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    s = rng.standard_normal((4, 5)).astype(np.float32) * 20
    np.testing.assert_allclose(tattn.softcap_scores(torch.as_tensor(s), 7.0).numpy(),
                               np.asarray(jattn.softcap_scores(jnp.asarray(s), 7.0)),
                               atol=1e-5, rtol=1e-5)
