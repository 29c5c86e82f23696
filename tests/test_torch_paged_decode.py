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

The CUDA kernel is held against the plain version on the card by the
``cuda``-marked tests of ``tests/test_torch_package.py`` and by
``chip_smoke.py`` (a per-row relative L2 error pin: the kernel sums in
another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.ops.paged_attention import paged_attention_reference as j_reference
from accelerate_tpu.ops.pallas.paged_decode import paged_attention_kernel as j_kernel
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.ops.kernels.paged_decode import paged_decode_cuda
from accelerate_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
    paged_attention_reference,
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
    return got, np.asarray(ref), np.asarray(ker), rows, t_kw


@pytest.mark.parametrize("case", list(CASES))
def test_paged_attention_matches_jax_reference_and_pallas_kernel(case):
    got, ref, ker, rows, _ = _run(case)
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
