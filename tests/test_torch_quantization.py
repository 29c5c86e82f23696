"""Parity of the port's weight-only quantization (``utils/quantization.py``)
with the JAX package's, on the same numpy inputs (seeds stated).

- ``quantize_leaf``: int8 and nibble-packed int4 data and f32 scales
  bitwise the JAX package's (eager JAX: ``absmax / qmax`` is a division),
  per layer on a stacked leaf, for f32 and bf16 weights;
- ``dequantize_leaf``: bitwise;
- ``load_and_quantize_model`` on a tiny Llama: the quantized tree's leaves
  bitwise, ``quantized_nbytes`` equal, int8 logits with ``compute_dtype=
  "float32"`` within 1e-4 (the same weights; the forward's sums run in
  another order), int4 logits with bf16 compute within 5e-2 (both round
  every activation to bf16);
- int4 on random weights: its logits correlate with the unquantized ones
  far below int8's (the JAX package's bar of 0.99 is its int8 case),
  in both packages alike, since their int4 weights are bitwise equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch.models import Llama, LlamaConfig, llama_params_from_numpy
from accelerate_tpu_torch.utils import quantization as tq
from accelerate_tpu_torch.big_modeling import init_empty_weights
from accelerate_tpu_torch.utils.tree import flatten_with_paths, map_with_paths, tree_map

torch.set_num_threads(2)

SEED = 11


def _bf16_bits(x):
    """A bf16 array's bits, from either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _weights(shape, dtype, seed=SEED):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    if len(shape) >= 3:
        w[1] *= 100.0  # an outlier layer
    if dtype == "bfloat16":
        return jnp.asarray(w, jnp.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    return jnp.asarray(w), torch.from_numpy(w)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(33, 16), (3, 7, 5)])
def test_quantize_and_dequantize_leaf_bitwise_jax(bits, dtype, shape):
    jw, tw = _weights(shape, dtype)
    jl, tl = jq.quantize_leaf(jw, bits), tq.quantize_leaf(tw, bits)
    assert tl.bits == jl.bits and tl.shape == jl.shape
    np.testing.assert_array_equal(tl.data.numpy(), np.asarray(jl.data))
    np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
    assert tl.nbytes == jl.nbytes
    for out_dtype, t_dtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jd, td = jq.dequantize_leaf(jl, out_dtype), tq.dequantize_leaf(tl, t_dtype)
        if t_dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bf16_bits(td), _bf16_bits(jd))
        else:
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_stacked_leaf_has_per_layer_scales():
    _, tw = _weights((4, 16, 8), "float32")
    q = tq.quantize_leaf(tw, 8)
    assert q.scale.shape == (4, 1, 8)
    back = tq.dequantize_leaf(q, torch.float32)
    for layer in (0, 2, 3):  # the outlier layer 1 does not coarsen the others
        max_err = tw[layer].abs().amax(dim=0) / 127
        assert bool(((back[layer] - tw[layer]).abs() <= max_err[None] + 1e-6).all())


def test_config_validation_and_tree_skips():
    with pytest.raises(ValueError):
        tq.QuantizationConfig(load_in_8bit=True, load_in_4bit=True)
    with pytest.raises(ValueError):
        tq.QuantizationConfig()
    assert tq.QuantizationConfig(load_in_4bit=True).bits == 4
    params = {"attn": {"wq": torch.ones(8, 8), "norm": torch.ones(8)},
              "lm_head": {"w": torch.ones(8, 4)}}
    qt = tq.quantize_tree(params, tq.QuantizationConfig(load_in_8bit=True,
                                                        skip_modules=["lm_head"]))
    assert tq.is_quantized_leaf(qt["attn"]["wq"])
    assert not tq.is_quantized_leaf(qt["attn"]["norm"])
    assert not tq.is_quantized_leaf(qt["lm_head"]["w"])
    # A quantized leaf is one leaf of the tree helpers, moved whole.
    names = [k for k, _ in flatten_with_paths(qt)]
    assert names == ["attn.norm", "attn.wq", "lm_head.w"]
    moved = tree_map(lambda t: t.to("cpu"), qt)
    assert tq.is_quantized_leaf(moved["attn"]["wq"]) and moved["attn"]["wq"].bits == 8


@pytest.fixture(scope="module")
def numpy_params():
    return numpy_llama_params(SEED)


def numpy_llama_params(seed: int) -> dict:
    """Tiny Llama weights drawn with numpy (std 1/sqrt(fan-in), norms ones)
    in the tree both packages share, shaped by the port's meta init."""
    with init_empty_weights():
        meta = Llama(LlamaConfig.tiny(), device="cpu").init_params()
    rng = np.random.default_rng(seed)

    def draw(name, leaf):
        if "norm" in name:
            return np.ones(tuple(leaf.shape), np.float32)
        fan_in = leaf.shape[-2] if leaf.dim() > 1 else 1
        return (rng.standard_normal(tuple(leaf.shape)) / np.sqrt(fan_in)).astype(np.float32)

    return map_with_paths(draw, meta)


def _pair(numpy_params):
    """Fresh JAX and port tiny Llamas on the same weights."""
    jm = JLlama(JConfig.tiny())
    jm.params = jax.tree_util.tree_map(jnp.asarray, numpy_params)
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.params = llama_params_from_numpy(numpy_params, tm.config, device="cpu")
    return jm, tm


@pytest.mark.parametrize("bits,compute,atol", [(8, "float32", 1e-4), (4, "bfloat16", 5e-2)])
def test_load_and_quantize_model_matches_jax(numpy_params, bits, compute, atol):
    jm, tm = _pair(numpy_params)
    ids = np.random.default_rng(SEED).integers(0, 256, (2, 8)).astype(np.int32)
    flag = {"load_in_8bit": True} if bits == 8 else {"load_in_4bit": True}
    j = jq.load_and_quantize_model(jm, quantization_config=jq.QuantizationConfig(
        compute_dtype=compute, **flag))
    t = tq.load_and_quantize_model(tm, quantization_config=tq.QuantizationConfig(
        compute_dtype=compute, **flag))
    assert t.is_quantized and tq.quantized_nbytes(t.params) == jq.quantized_nbytes(j.params)
    for (name, leaf), jleaf in zip(flatten_with_paths(t.params), _jax_leaves(j.params)):
        if tq.is_quantized_leaf(leaf):
            np.testing.assert_array_equal(leaf.data.numpy(), np.asarray(jleaf.data), name)
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(jleaf.scale), name)
    forward = jax.jit(lambda p, i: j.apply(p, input_ids=i)["logits"])  # the hooked apply
    want = np.asarray(forward(j.params, jnp.asarray(ids)), np.float32)
    got = t.apply(t.params, input_ids=torch.as_tensor(ids))["logits"].float().numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol)


def _jax_leaves(params):
    """JAX tree leaves in the port's order (sorted dotted names), a
    ``QuantizedTensor`` kept whole."""
    flat = jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor))[0]
    named = {".".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}
    return [named[k] for k in sorted(named)]


def test_int4_on_random_weights_correlates_below_int8(numpy_params):
    """int4's step is absmax / 7, a third of a Gaussian weight's std over a
    64-wide channel, so on random weights its logits correlate with the
    unquantized ones well below int8's at 2 layers; int8 stays above JAX's 0.99
    (tests/test_quantization.py:92-94, its int8 case). Both packages give
    the same correlation (their int4 weights are bitwise equal)."""
    _, tm = _pair(numpy_params)
    ids = torch.as_tensor(np.random.default_rng(SEED).integers(0, 256, (4, 16)))
    want = tm.apply(tm.params, input_ids=ids)["logits"].numpy().ravel()
    corr = {}
    for bits, flag in ((8, "load_in_8bit"), (4, "load_in_4bit")):
        t = Llama(tm.config, device="cpu")
        t.params = tm.params
        t = tq.load_and_quantize_model(t, quantization_config=tq.QuantizationConfig(
            compute_dtype="float32", **{flag: True}))
        got = t.apply(t.params, input_ids=ids)["logits"].numpy().ravel()
        corr[bits] = np.corrcoef(got, want)[0, 1]
    assert corr[8] > 0.99
    assert 0.5 < corr[4] < 0.99, corr


def test_quantization_config_is_required(numpy_params):
    _, tm = _pair(numpy_params)
    with pytest.raises(ValueError):
        tq.load_and_quantize_model(tm, quantization_config=None)
