"""Parity of the port's int8-weight serving (``matmul_precision="int8"``) with
the JAX package's, on ``LlamaConfig.tiny()`` in f32 on the CPU.

Weights are initialized by the JAX package from a fixed key and carried
across with ``models/from_jax``; token ids come from numpy with the seeds
below. The JAX side runs jitted, as its serving programs do. The port runs
the plain int8 matmul on the CPU, which is bitwise equal to JAX's jitted
``_int8_matmul_fwd_value`` on equal operands (tests/test_torch_int8_matmul.py).

Quantization turns ulp-level differences in a matmul's input (the two
frameworks round norms and attention differently) into whole quantization
steps, and so into logit differences where an element sits on a rounding
boundary. Tolerances, with their reasons:

- logits, uncached, prefill and decode: ``atol=1e-4`` (measured at most
  1.5e-6 on these inputs; logits O(1));
- the paged engine with int8 weights, with the f32 pool and with the int8
  pool: token-identical to the JAX engine on the wave below;
- ``generate``: JAX's own jitted generate flips a near tie on this batch
  (row 2, third new token: JAX's top-2 logit gap there is 1.75e-3, and the
  JAX model's own uncached forward and the port pick the other token), so
  the check is
  teacher-forced: both cached paths are fed JAX's tokens and their logits
  agree to ``atol=1e-4`` at every step, the port's own greedy tokens equal
  JAX's up to the first position where they part, and JAX's top-2 gap
  there is below 1e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.generation import generate as jgenerate
from accelerate_tpu.generation import left_align as j_left_align
from accelerate_tpu.generation import mask_positions as j_mask_positions
from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
from accelerate_tpu.serving import ContinuousBatcher as JBatcher
from accelerate_tpu_torch import ContinuousBatcher, generate
from accelerate_tpu_torch.generation import _precision_variant, left_align, mask_positions
from accelerate_tpu_torch.models import Llama, LlamaConfig, llama_params_from_numpy
from accelerate_tpu_torch.ops import registry

torch.set_num_threads(2)

SEED = 7
LOGIT_ATOL = 1e-4
NEAR_TIE = 1e-2
ENGINE = dict(batch_slots=2, max_new_tokens=6, max_cache_len=256, bucket_sizes=(8, 16),
              sync_every=2, block_size=4, max_tokens_per_request=64)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX int8 model, port model, port int8 model), all on the
    same weights; the int8 ones have ``matmul_precision="int8"`` in their
    configs."""
    base = JLlama(JConfig.tiny())
    base.init_params(jax.random.key(0))
    jm = JLlama(JConfig.tiny(matmul_precision="int8"))
    jm.params = base.params
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.params = llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, base.params),
                                        tm.config, device="cpu")
    tm8 = Llama(LlamaConfig.tiny(matmul_precision="int8"), device="cpu")
    tm8.params = tm.params
    return base, jm, tm, tm8


def _jit_apply(jm):
    return jax.jit(lambda p, ids, mask, cache, pos: jm.apply(
        p, input_ids=ids, attention_mask=mask, cache=cache, positions=pos))


def _batches():
    """The right-padded prompt batches of the logits and generate tests,
    drawn in this order from one seed."""
    rng = np.random.default_rng(SEED)
    ids = rng.integers(1, 256, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, -3:] = 0
    gen_ids = rng.integers(1, 256, (3, 7)).astype(np.int32)
    gen_mask = np.ones((3, 7), np.int32)
    gen_mask[1, 4:] = 0
    gen_mask[2, 6:] = 0
    return (ids, mask), (gen_ids, gen_mask)


def test_uncached_logits_match_jax(models):
    _, jm, _, tm8 = models
    (ids, mask), _ = _batches()
    ref = jax.jit(lambda p, i, m: jm.apply(p, input_ids=i, attention_mask=m)["logits"])(
        jm.params, ids, mask)
    got = tm8.apply(tm8.params, input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)


def _teacher_forced(jm, tm8, ids, mask, new_tokens):
    """Prefill the left-aligned batch, then feed ``new_tokens`` one column a
    step through both cached paths; yields (JAX logits, port logits) of the
    prefill and of every step, each (B, V)."""
    B, S = ids.shape
    steps = new_tokens.shape[1]
    j_apply = _jit_apply(jm)
    ji, jmk = j_left_align(jnp.asarray(ids), jnp.asarray(mask))
    ti, tmk = left_align(torch.tensor(ids), torch.tensor(mask))
    jo = j_apply(jm.params, ji, jmk, jm.init_cache(B, S + steps, dtype=jnp.float32),
                 j_mask_positions(jmk))
    to = tm8.apply(tm8.params, input_ids=ti, attention_mask=tmk, positions=mask_positions(tmk),
                   cache=tm8.init_cache(B, S + steps, dtype=torch.float32))
    yield np.asarray(jo["logits"][:, -1]), to["logits"][:, -1].numpy()
    pos = np.asarray(jnp.sum(jmk, -1)).astype(np.int32)
    for t in range(steps - 1):
        feed = new_tokens[:, t:t + 1]
        jo = j_apply(jm.params, jnp.asarray(feed), None, jo["cache"], jnp.asarray(pos[:, None] + t))
        to = tm8.apply(tm8.params, input_ids=torch.tensor(feed), cache=to["cache"],
                       positions=torch.tensor(pos[:, None] + t))
        yield np.asarray(jo["logits"][:, -1]), to["logits"][:, -1].numpy()


def test_cached_logits_match_jax_and_generate_parts_only_at_a_near_tie(models):
    base, jm, tm, tm8 = models
    _, (ids, mask) = _batches()
    steps = 8
    ref = np.asarray(jgenerate(base, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                               max_new_tokens=steps, cache_dtype=jnp.float32,
                               include_prompt=False, matmul_precision="int8"))
    got = generate(tm, ids, attention_mask=mask, max_new_tokens=steps, cache_dtype=torch.float32,
                   include_prompt=False, matmul_precision="int8", device="cpu").numpy()
    assert got.shape == ref.shape
    gaps = []
    for jl, tl in _teacher_forced(jm, tm8, ids, mask, ref):
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
    for b in range(ids.shape[0]):
        differ = np.nonzero(got[b] != ref[b])[0]
        if differ.size:
            t = differ[0]
            assert gaps[t][b] < NEAR_TIE, (b, t, gaps[t][b])


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp32-pool", "int8-pool"])
def test_int8_engine_token_identical_to_jax_engine(models, kv_quant):
    base, _, tm, _ = models
    rng = np.random.default_rng(SEED + 3)
    prefix = rng.integers(1, 256, (10,)).astype(np.int32)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (20, 5, 3, 12, 7)]
    je = JBatcher(base, paged=True, cache_dtype=jnp.float32, kv_quant=kv_quant,
                  matmul_precision="int8", **ENGINE)
    je.set_prefix(prefix)
    jr = [je.submit(p) for p in prompts]
    jout = je.run()
    te = ContinuousBatcher(tm, cache_dtype=torch.float32, kv_quant=kv_quant,
                           matmul_precision="int8", device="cpu", **ENGINE)
    assert te.module.config.matmul_precision == "int8" and te.module.params is tm.params
    te.set_prefix(prefix)
    tr = [te.submit(p) for p in prompts]
    registry.reset_launch_counts()
    tout = te.run()
    assert registry.launch_counts == {}  # the CPU engine runs the plain versions
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(tout[b], jout[a])
    assert te.pool_stats()["blocks_free"] == te.num_blocks


def test_precision_variant_is_memoized_and_validated(models):
    _, _, tm, _ = models
    v = _precision_variant(tm, "int8")
    assert v is _precision_variant(tm, "int8") and v is not tm
    assert v.config.matmul_precision == "int8" and tm.config.matmul_precision == "default"
    assert v.params is tm.params and _precision_variant(tm, "default") is tm
    with pytest.raises(ValueError, match="matmul precision"):
        _precision_variant(tm, "fp8")
    with pytest.raises(ValueError, match="matmul precision"):
        ContinuousBatcher(tm, batch_slots=2, max_new_tokens=2, max_cache_len=64,
                          matmul_precision="fp8", device="cpu")
    with pytest.raises(ValueError, match="matmul precision"):
        Llama(LlamaConfig.tiny(matmul_precision="fp8"), device="cpu")
