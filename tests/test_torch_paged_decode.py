"""Parity of the port's fused paged decode attention op with the JAX package's.

The port's op face ``paged_attention`` (op ``paged_decode``) runs its plain
version on the CPU: the plain gather of each slot's chain, then
``cached_attention``. The same inputs (numpy, seeds below) go through the
JAX package's ``paged_attention_reference`` and its Pallas kernel
``paged_attention_kernel`` run by the interpreter, both jitted, as
tests/test_kernels.py runs them. The cases are that file's ``_pool_case``
cases (ragged chains with trash-block table tails, GQA, holes in the pool
mask: plain, without a mask, a window with softcap, a chunk of S=4), plus
an int8 pool with per-token scales and a vector of active slots.

Tolerance, with its reason: f32 on the CPU with softmax and einsum sums in
another order, ``atol=1e-5`` (outputs O(1)), on active slots; the JAX
kernel zeroes inactive slots, the plain versions compute masked garbage
there.

The kernel's own arithmetic order, flash-decoding (the chain cut into
splits of whole blocks, an online softmax over each consumer warp's blocks,
the warps and then the splits merged in a fixed order), runs on the CPU as
``paged_decode_split_reference``: it is held to the plain version and to the
JAX kernel at every split length from one block to the whole chain, on the
cases above and on three edge cases (a split with no visible key, rows with
no visible key at all, a window whose edge crosses a split boundary over
holes in the mask), at the same ``atol``. ``plan()``, the kernel's
partition, is tested here too: its splits cover every key once, its grid
fills the card at the engine's geometry and on 4096-token chains, and its
scratch and shared memory are the counts the kernel uses.

The CUDA kernel is held against the plain version on the card by the
``cuda``-marked tests of ``tests/test_torch_package.py`` and by
``chip_smoke.py`` (a per-row relative L2 error pin: the kernel sums in
another order).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.ops.paged_attention import paged_attention_reference as j_reference
from accelerate_tpu.ops.pallas.paged_decode import paged_attention_kernel as j_kernel
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.ops.kernels.paged_decode import (
    CONSUMERS,
    CTAS_PER_SM,
    NUM_SMS,
    RING_BUDGET,
    paged_decode_cuda,
    plan,
    smem_bytes,
)
from accelerate_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
    paged_attention_reference,
    paged_decode_split_reference,
)

torch.set_num_threads(2)

SEED = 0
ATOL = 1e-5


def _pool_case(seed=SEED, N=9, bs=4, Hkv=2, D=8, B=3, M=3, S=1, H=4, quant=False):
    """tests/test_kernels.py's ``_pool_case`` (same draws, same order), with
    an int8 variant: int8 payloads plus f32 per-token scales."""
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(N, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(N, bs, Hkv, D)).astype(np.float32)
    mask = rng.integers(0, 2, (N, bs)).astype(np.int32)
    mask[0] = 0  # the trash block stays mask-zero
    tables = np.asarray([[1, 3, 0], [2, 4, 6], [5, 0, 0]], np.int32)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    pos = rng.integers(0, M * bs, (B, S)).astype(np.int32)
    scales = None
    if quant:
        kp = rng.integers(-127, 128, kp.shape).astype(np.int8)
        vp = rng.integers(-127, 128, vp.shape).astype(np.int8)
        scales = [rng.uniform(1e-3, 0.05, (N, bs)).astype(np.float32) for _ in range(2)]
    return q, kp, vp, tables, pos, mask, scales


CASES = {
    "plain": dict(),
    "no_mask": dict(no_mask=True),
    "windowed": dict(window=5, softcap=10.0),
    "chunk": dict(S=4),
    "int8_pool": dict(quant=True),
    "int8_pool_windowed_active": dict(quant=True, window=6, softcap=8.0, active=[1, 0, 1]),
}


def _run(case):
    kw = dict(CASES[case])
    no_mask, active = kw.pop("no_mask", False), kw.pop("active", None)
    opts = {k: kw.pop(k) for k in ("window", "softcap") if k in kw}
    q, kp, vp, tables, pos, mask, scales = _pool_case(**kw)
    pool_mask = None if no_mask else mask
    j_scales = {} if scales is None else dict(k_scale=jnp.asarray(scales[0]),
                                              v_scale=jnp.asarray(scales[1]))
    j_args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables))
    j_kw = dict(q_positions=jnp.asarray(pos),
                pool_mask=None if pool_mask is None else jnp.asarray(pool_mask), **opts)
    ref = jax.jit(lambda *a: j_reference(*a, **j_kw, **j_scales))(*j_args)
    j_active = None if active is None else jnp.asarray(active, jnp.int32)
    ker = jax.jit(lambda *a: j_kernel(*a, **j_kw, **j_scales, active=j_active,
                                      interpret=True))(*j_args)
    t_scales = {} if scales is None else dict(k_scale=torch.tensor(scales[0]),
                                              v_scale=torch.tensor(scales[1]))
    t_kw = dict(q_positions=torch.tensor(pos),
                pool_mask=None if pool_mask is None else torch.tensor(pool_mask),
                active=None if active is None else torch.tensor(active), **opts, **t_scales)
    registry.reset_launch_counts()
    got = paged_attention(torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
                          torch.tensor(tables), **t_kw)
    assert registry.launch_counts == {}  # CPU tensors run the plain version
    rows = np.arange(q.shape[0]) if active is None else np.nonzero(active)[0]
    t_args = tuple(torch.tensor(a) for a in (q, kp, vp, tables))
    return got, np.asarray(ref), np.asarray(ker), rows, t_kw, t_args


@pytest.mark.parametrize("case", list(CASES))
def test_paged_attention_matches_jax_reference_and_pallas_kernel(case):
    got, ref, ker, rows, _, _ = _run(case)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy()[rows], ref[rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy()[rows], ker[rows], atol=ATOL, rtol=0)
    inactive = np.setdiff1d(np.arange(got.shape[0]), rows)
    assert (ker[inactive] == 0).all()


def test_plain_version_is_the_reference_composition():
    """On the CPU the op face, its ``kernels="off"`` arm and the slice-1
    reference composition are one computation."""
    q, kp, vp, tables, pos, mask, _ = _pool_case(S=2)
    args = [torch.tensor(a) for a in (q, kp, vp, tables)]
    kw = dict(q_positions=torch.tensor(pos), pool_mask=torch.tensor(mask), window=3)
    a = paged_attention(*args, **kw)
    assert torch.equal(a, paged_attention(*args, **kw, kernels="off"))
    assert torch.equal(a, paged_attention_plain(*args, **kw))
    assert torch.equal(a, paged_attention_reference(*args, **kw))


def test_output_types_follow_the_jax_package():
    """f32 for an int8 pool (the dequantized view is f32), else the
    promotion of q's and the pool's types."""
    q, kp, vp, tables, pos, mask, scales = _pool_case(quant=True)
    qb = torch.tensor(q).to(torch.bfloat16)
    kw = dict(q_positions=torch.tensor(pos), pool_mask=torch.tensor(mask))
    out = paged_attention(qb, torch.tensor(kp), torch.tensor(vp), torch.tensor(tables),
                          k_scale=torch.tensor(scales[0]), v_scale=torch.tensor(scales[1]), **kw)
    assert out.dtype == torch.float32
    kb = torch.tensor(kp).float().to(torch.bfloat16)
    out = paged_attention(qb, kb, kb, torch.tensor(tables), **kw)
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="come together"):
        paged_attention(qb, torch.tensor(kp), torch.tensor(vp), torch.tensor(tables),
                        k_scale=torch.tensor(scales[0]), **kw)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    q, kp, vp, tables, pos, mask, _ = _pool_case()
    registry.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_decode_cuda(torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
                          torch.tensor(tables), q_positions=torch.tensor(pos),
                          pool_mask=torch.tensor(mask))
    assert registry.launch_counts == {}


# ------------------------------------------------- the kernel's split math

_cached_run = lru_cache(maxsize=None)(_run)


@pytest.mark.parametrize("split_blocks", [1, 2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_split_reference_matches_plain_and_jax_kernel(case, split_blocks):
    """Every split length of the 3-block chains: splits of one block (some
    hold no visible key: a trash-block tail, keys past the frontier), two,
    and the whole chain."""
    plain, ref, ker, rows, t_kw, t_args = _cached_run(case)
    got = paged_decode_split_reference(*t_args, **t_kw, split_blocks=split_blocks)
    assert got.dtype == torch.float32 and got.shape == plain.shape
    np.testing.assert_allclose(got.numpy()[rows], plain.numpy()[rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy()[rows], ref[rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), ker, atol=ATOL, rtol=0)  # zeros where inactive


def _edge_inputs(kind):
    """Six-block chains (bs 4, 2 KV heads of 8, G = 2), three slots.

    - ``split_without_visible_key``: slot 0's first two blocks are all
      holes, so a split of one or two blocks there sees no key; slot 1's
      query sits in its first block, so its later splits see none either.
    - ``row_without_visible_key``: slot 0's first query sits at position
      -1 (every key is in its future), slot 1's chain is all trash block
      (every key masked): both rows see no key, and the plain version's
      answer is the mean over the keys with one exclusion.
    - ``window_across_splits``: a chunk of S = 3 queries near the end of
      chains with holes, a window of 7 valid slots, so the window's edge
      falls inside a block and crosses split boundaries."""
    rng = np.random.default_rng(7)
    N, bs, Hkv, D, H, M, B = 16, 4, 2, 8, 4, 6, 3
    S = 3 if kind == "window_across_splits" else 2
    kp = rng.normal(size=(N, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(N, bs, Hkv, D)).astype(np.float32)
    mask = (rng.random((N, bs)) > 0.3).astype(np.int32)
    mask[0] = 0
    tables = np.asarray([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 0], [12, 13, 14, 15, 0, 0]],
                        np.int32)
    pos = np.stack([M * bs - 1 - np.arange(S)[::-1]] * B).astype(np.int32)
    opts = {}
    if kind == "split_without_visible_key":
        mask[[1, 2]] = 0
        pos[1] = np.arange(S)  # in block 0: blocks 1.. are all in the future
    elif kind == "row_without_visible_key":
        pos[0, 0] = -1
        tables[1] = 0
    else:
        mask[[3, 9, 13]] = [[1, 0, 1, 1], [0, 1, 0, 1], [1, 1, 0, 0]]
        opts = dict(window=7, softcap=8.0)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return q, kp, vp, tables, pos, mask, opts


@lru_cache(maxsize=None)
def _edge_run(kind):
    q, kp, vp, tables, pos, mask, opts = _edge_inputs(kind)
    j_args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables))
    j_kw = dict(q_positions=jnp.asarray(pos), pool_mask=jnp.asarray(mask), **opts)
    ref = jax.jit(lambda *a: j_reference(*a, **j_kw))(*j_args)
    ker = jax.jit(lambda *a: j_kernel(*a, **j_kw, interpret=True))(*j_args)
    t_args = tuple(torch.tensor(a) for a in (q, kp, vp, tables))
    t_kw = dict(q_positions=torch.tensor(pos), pool_mask=torch.tensor(mask), **opts)
    return t_args, t_kw, np.asarray(ref), np.asarray(ker)


@pytest.mark.parametrize("split_blocks", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("kind", ["split_without_visible_key", "row_without_visible_key",
                                  "window_across_splits"])
def test_split_reference_edge_cases(kind, split_blocks):
    t_args, t_kw, ref, ker = _edge_run(kind)
    plain = paged_attention_plain(*t_args, **t_kw)
    got = paged_decode_split_reference(*t_args, **t_kw, split_blocks=split_blocks)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), ker, atol=ATOL, rtol=0)


def test_rows_without_visible_key_take_the_uniform_answer():
    """The edge case's premise: slot 0's first row and slot 1's rows see no
    key, and get the mean of V over the keys with one exclusion (the -1e30
    biases are added, so doubly excluded keys drop out)."""
    t_args, t_kw, _, _ = _edge_run("row_without_visible_key")
    q, kp, vp, tables = t_args
    got = paged_decode_split_reference(*t_args, **t_kw, split_blocks=1)
    mask = t_kw["pool_mask"]
    v0 = vp[tables[0]].reshape(-1, 2, 8)[mask[tables[0]].reshape(-1) == 1].mean(0)
    np.testing.assert_allclose(got[0, 0].reshape(2, 2, 8).numpy(),
                               v0[:, None].expand(2, 2, 8).numpy(), atol=ATOL)
    v1 = vp[tables[1]].reshape(-1, 2, 8)  # all trash: every key is masked, none also future
    future = torch.arange(v1.shape[0]) > t_kw["q_positions"][1, 1]
    np.testing.assert_allclose(got[1, 1].reshape(2, 2, 8).numpy(),
                               v1[~future].mean(0)[:, None].expand(2, 2, 8).numpy(), atol=ATOL)


GEOMETRIES = {  # (B, S, H, Hkv, D, bs, M)
    "engine-m26": (8, 1, 32, 8, 128, 16, 26),
    "llama-m256": (8, 1, 32, 8, 128, 16, 256),
    "one-slot-4096": (1, 1, 32, 8, 128, 16, 256),
    "chunk-s5": (3, 5, 32, 8, 128, 16, 40),
    "tiny": (3, 1, 4, 2, 64, 16, 3),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_plan_splits_cover_every_key_once(geometry):
    B, S, H, Hkv, D, bs, M = GEOMETRIES[geometry]
    p = plan(B, S, H, Hkv, D, bs, M)
    covered = [j for j0, j1 in p["ranges"] for j in range(j0, j1)]
    assert covered == list(range(M))
    assert all(0 < j1 - j0 <= p["split_blocks"] for j0, j1 in p["ranges"])
    assert p["splits"] == len(p["ranges"])
    assert p["row_tiles"] == -(-(H // Hkv * S) // 16)
    assert p["ctas"] == p["splits"] * Hkv * B * p["row_tiles"]
    # splits enough to give every SM two CTAs at least, unless the chain is too short,
    # and no more than one resident wave's worth of splits
    assert p["ctas"] >= 2 * NUM_SMS or p["split_blocks"] == 1
    assert p["splits"] <= max(1, -(-CTAS_PER_SM * NUM_SMS // (B * Hkv * p["row_tiles"])))


@pytest.mark.parametrize("geometry", ["engine-m26", "llama-m256", "one-slot-4096"])
def test_plan_fills_the_card(geometry):
    """At least 2 x 132 CTAs at the engine's geometry and at M = 256; one
    slot with a 4096-token chain gets a wave that the card holds at once
    (three CTAs an SM fit its shared memory and registers)."""
    p = plan(*GEOMETRIES[geometry])
    assert p["ctas"] >= 2 * NUM_SMS
    if geometry == "one-slot-4096":
        assert p["smem"] <= RING_BUDGET and p["ctas"] <= 3 * NUM_SMS
    assert p["stages"] == 2 * CONSUMERS


def test_plan_scratch_and_shared_memory():
    """The scratch holds (m, l, o) of every split for every row; the shared
    memory is the kernel's region count, and the ring drops to one stage a
    consumer only where two do not fit the budget."""
    p = plan(*GEOMETRIES["llama-m256"])
    assert p["scratch_floats"] == p["splits"] * 8 * 1 * 32 * (128 + 2)
    # Llama-3-8B, bf16: 12,800 bytes before the ring (six 64-byte mask rows
    # and the split's 37 table entries among them), 1024 of alignment, six
    # stages of a 16 x 128 K and V tile.
    assert p["split_blocks"] == 37
    assert p["smem"] == 12800 + 1024 + 6 * 8192 == smem_bytes(128, 16, 256, 37, 6, 2, 2, True,
                                                              False, False)
    q8 = plan(*GEOMETRIES["llama-m256"], kv_dtype=torch.int8)
    assert q8["mma"] and q8["smem"] < p["smem"] and q8["stages"] == 2 * CONSUMERS
    ranked = plan(*GEOMETRIES["llama-m256"], use_rank=True)
    assert ranked["smem"] == p["smem"] + 256 * 4  # the chain's per-block valid counts
    wide = plan(2, 1, 16, 8, 256, 16, 64, q_dtype=torch.float32, kv_dtype=torch.float32)
    assert not wide["mma"] and wide["stages"] == CONSUMERS
    assert wide["smem"] == smem_bytes(256, 16, 64, wide["split_blocks"], CONSUMERS, 4, 4, True,
                                      False, False)
