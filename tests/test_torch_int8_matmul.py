"""Parity of the port's int8 matmul with the JAX package's.

The same operands (numpy, seeds below) go through the JAX package's
``ops/int8.py`` — its quantizer, its jitted reference forward
``_int8_matmul_fwd_value`` and its Pallas kernel ``int8_matmul_kernel`` run
by the interpreter, as tests/test_kernels.py runs it — and through the
port's ``ops/int8.py`` on the CPU, where op ``int8_matmul`` runs its plain
version. The CUDA kernel is held bitwise against the plain version on the
card by the ``cuda``-marked tests of ``tests/test_torch_package.py`` and by
``chip_smoke.py``.

Every JAX side is jitted, the regime in which the JAX package runs these
functions (its tests and its serving programs): there XLA turns the
division by the constant 127 into a multiply by its f32 reciprocal, which
the port does too; eager JAX divides and differs in the last bit of some
scales.

Tolerances, with their reasons:

- quantizer and forward: bitwise. The scale is one f32 multiply, both
  frameworks round half to even, the integer contraction is exact in any
  order, and the rescale is two f32 multiplies in one order, then one cast;
- straight-through gradients: f32 on the CPU with sums in another order,
  ``atol=1e-5`` (values O(1-10)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.ops.int8 import _int8_matmul_fwd_value
from accelerate_tpu.ops.int8 import int8_matmul as j_int8_matmul
from accelerate_tpu.ops.int8 import quantize_rowwise as j_quantize_rowwise
from accelerate_tpu.ops.pallas.int8_mm import int8_matmul_kernel
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.ops.int8 import (
    int8_matmul,
    int8_matmul_reference,
    matmul,
    quantize_rowwise,
)
from accelerate_tpu_torch.ops.kernels.int8_matmul import (
    MAX_CLUSTER,
    SMEM_LIMIT,
    plan,
    smem_bytes,
)

torch.set_num_threads(2)

SEED = 7
GRAD_ATOL = 1e-5
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype`` (bf16
    rounded once, by JAX, and carried across exactly through f32)."""
    j = jnp.asarray(a, _JAX[dtype])
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(_TORCH[dtype])
    return j, t


def _bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a JAX array, for bitwise compares."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _operands(dtype: str):
    """Random rows, an all-zero row, and a row whose scale is exactly 1 with
    values on .5 ties (rounded half to even by both frameworks)."""
    rng = np.random.default_rng(SEED)
    a = rng.standard_normal((6, 40)).astype(np.float32) * 3
    a[1] = 0.0
    a[2, :8] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5, -126.5, 4.5]
    a[2, 8:] = 0.25
    return _pair(a, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [-1, 0])
def test_quantize_rowwise_bitwise_equals_jax(dtype, dim):
    j, t = _operands(dtype)
    jq, js = jax.jit(lambda t: j_quantize_rowwise(t, axis=dim))(j)
    tq, ts = quantize_rowwise(t, dim)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    if dim == -1:  # the tie row: scale 1, every .5 rounded to the even neighbour
        assert ts[2, 0] == 1.0
        assert tq[2, :8].tolist() == [127, 2, -4, 0, 2, 0, -126, 4]
        assert ts[1, 0] == 1.0 and not tq[1].any()


# JAX's three shapes (tests/test_kernels.py) and one at a serving chunk's size.
CASES = [((2, 17, 33), "float32", 29), ((8, 16), "bfloat16", 29),
         ((300, 64), "float32", 300), ((16, 256, 384), "bfloat16", 160)]


@pytest.mark.parametrize("shape,dtype,N", CASES, ids=lambda c: str(c))
def test_plain_int8_matmul_bitwise_equals_jax_reference_and_pallas_kernel(shape, dtype, N):
    rng = np.random.default_rng(SEED)
    jx, tx = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    jw, tw = _pair(rng.standard_normal((shape[-1], N)).astype(np.float32), dtype)
    registry.reset_launch_counts()
    got = int8_matmul(tx, tw)
    assert got.dtype == _TORCH[dtype] and tuple(got.shape) == shape[:-1] + (N,)
    assert registry.launch_counts == {}  # CPU tensors run the plain version
    assert np.array_equal(_bits(got), _bits(int8_matmul_reference(tx, tw)))
    want = jax.jit(_int8_matmul_fwd_value)(jx, jw)
    kernel = jax.jit(lambda x, w: int8_matmul_kernel(x, w, interpret=True))(jx, jw)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got), _bits(kernel))


def test_straight_through_gradient_matches_jax_grad():
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    w = rng.standard_normal((12, 7)).astype(np.float32)
    ct = rng.standard_normal((3, 5, 7)).astype(np.float32)
    jdx, jdw = jax.grad(lambda x, w: jnp.sum(j_int8_matmul(x, w) * ct), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    (int8_matmul(tx, tw) * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=GRAD_ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=GRAD_ATOL)


def test_matmul_dispatches_by_precision_and_rejects_unknown():
    rng = np.random.default_rng(SEED + 2)
    x = torch.tensor(rng.standard_normal((4, 8)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((8, 3)).astype(np.float32))
    assert torch.equal(matmul(x, w), x @ w)
    assert torch.equal(matmul(x, w, "default"), x @ w)
    assert torch.equal(matmul(x, w, "int8"), int8_matmul_reference(x, w))
    assert torch.equal(matmul(x, w, "int8", kernels="off"), int8_matmul_reference(x, w))
    for bad in ("fp8", "INT8", None):
        with pytest.raises(ValueError, match="matmul precision"):
            matmul(x, w, bad)
    with pytest.raises(ValueError, match="kernels spec"):
        matmul(x, w, "int8", kernels="pallas")


# (K, N) of the Llama-3-8B block projections: wq and wo, wk and wv, w_gate
# and w_up, w_down.
LLAMA_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))


@pytest.mark.parametrize("M,N,K", [(8, 1024, 4096), (8, 14336, 4096), (8, 4096, 14336),
                                   (128, 14336, 4096), (34, 29, 33), (1, 8, 1)])
def test_kernel_k_splits_cover_k_with_no_empty_split(M, N, K):
    """The wrapper's partition (host arithmetic, no card), for bf16 and f32:
    the cluster's K slices are non-empty and cover K in order, each CTA's
    shared memory is within what a block can use, the cluster is portable,
    the panels cover N, and at the Llama shapes the grid covers the 132 SMs."""
    for itemsize in (2, 4):
        p = plan(M, N, K, itemsize, sms=132)
        slices = p.k_slices()
        assert len(slices) == p.cluster and 1 <= p.cluster <= MAX_CLUSTER
        assert all(k1 > k0 for k0, k1 in slices)  # no empty slice
        assert slices[0][0] == 0 and slices[-1][1] >= K > slices[-1][0]
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        assert p.smem == smem_bytes(itemsize, p.nt, p.per, p.mt, p.stages) <= SMEM_LIMIT
        assert p.smem >= p.per * 128 * p.nt * itemsize  # the whole K slice stays resident
        assert p.nt in (32, 64) and p.panels * p.nt >= N > (p.panels - 1) * p.nt
        assert M <= p.mt or p.mt == 128
        assert 1 <= p.stages <= p.per
        if (K, N) in LLAMA_SHAPES:
            assert p.ctas >= 132


# The kernel rounds a quotient q (|q| < 128) to an int8 without a conversion
# instruction: the bits of rn(q + 1.5 * 2^23) are 0x4B400000 + rint(q), so
# their low byte is rint(q) as an int8 (kRound in csrc/int8_matmul.cu).
ROUND = np.float32(1.5 * 2**23)


def test_rounding_by_constant_gives_rint_in_the_low_byte():
    """Every f32 in [-128, 128] whose 11 low significand bits are zero, and
    every half-integer there with its two neighbours: the low byte of
    rn(q + 1.5 * 2^23) equals rint(q) (half to even) as an int8, as
    ``quantize_rowwise`` rounds."""
    bits = np.arange(0, 0x43000001 >> 11, dtype=np.uint32) << 11  # +0 .. 128
    q = bits.view(np.float32)
    halves = np.arange(-255, 256, dtype=np.float32) / 2
    q = np.concatenate([q, -q, halves, np.nextafter(halves, np.float32(np.inf)),
                        np.nextafter(halves, np.float32(-np.inf))])
    q = q[np.abs(q) <= 127.5]
    z = q + ROUND  # one f32 addition, rounded to nearest even
    low_byte = (z.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    want = np.rint(q).astype(np.int8)
    np.testing.assert_array_equal(low_byte, want)
    assert torch.equal(torch.round(torch.from_numpy(q)).to(torch.int8),
                       torch.from_numpy(want))
