"""Parity of the port's classic-GPT decoders (``GPTX``: GPT-NeoX, GPT-J,
OPT; and ``GPT2``) with the JAX package's, in f32 on the CPU.

Each variant is the one ``tests/test_gptx.py`` builds (NeoX with partial
rotary and parallel residual, NeoX sequential, NeoX with linear rope
scaling, GPT-J, OPT) plus GPT-2, at tiny widths. Weights are the JAX
package's init from a fixed key with every leaf perturbed from a numpy seed
(so biases and norms are not constants), carried across with
``models/from_jax``; token ids come from numpy seeds. Tolerances, with
their reasons:

- logits, losses and gradients, uncached and cached: ``atol=rtol=1e-4``
  (f32 in both frameworks, sums in another order; the pin of
  ``tests/test_torch_llama.py``);
- the rotary lanes (half-split partial, interleaved pairs): ``1e-6``;
- greedy ``generate`` on ragged prompts, and the paged engine against
  ``generate``: token-identical;
- the int8 forward (``matmul_precision="int8"``) against JAX's jitted int8
  forward: ``atol=1e-4``, as ``tests/test_torch_int8_serving.py`` pins it;
- the imperative loop against the fused step, and the streamed model
  against the resident one: the same numbers (``1e-6`` for losses of two
  code paths in f32; bitwise for the streamed logits, the same ops on the
  same weights).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.generation import generate as jgenerate
from accelerate_tpu.models.gpt2 import GPT2 as JGPT2, GPT2Config as JGPT2Config
from accelerate_tpu.models.gptx import GPTX as JGPTX, GPTXConfig as JGPTXConfig
from accelerate_tpu.models.gptx import apply_rope_interleaved as j_rope_interleaved
from accelerate_tpu.models.llama import rope_tables as j_rope_tables
import accelerate_tpu_torch as T
from accelerate_tpu_torch.models.gptx import apply_rope_interleaved
from accelerate_tpu_torch.models.llama import rope_tables
from accelerate_tpu_torch.utils.tree import tree_leaves, tree_unflatten

torch.set_num_threads(2)

SEED = 13
ATOL = RTOL = 1e-4
VARIANTS = {
    "neox": dict(rotary_dim=4),
    "neox_sequential": dict(parallel_residual=False),
    "neox_linear_rope": dict(rotary_dim=8, rope_scaling={"rope_type": "linear", "factor": 2.0}),
    "gptj": dict(position_style="rotary_gptj", rotary_dim=8, shared_layernorm=True,
                 hidden_act="gelu_tanh", attention_bias=False, lm_head_bias=True),
    "opt": dict(position_style="learned", position_offset=2, parallel_residual=False,
                hidden_act="relu", tie_word_embeddings=True),
    "gpt2": None,
}


def build(name, **extra):
    """(JAX model, port model) of a variant on the same perturbed weights."""
    kw = VARIANTS[name]
    if kw is None:
        jm, tm = JGPT2(JGPT2Config.tiny(**extra)), T.GPT2(T.GPT2Config.tiny(**extra),
                                                           device="cpu")
        convert = T.gpt2_params_from_numpy
    else:
        jm = JGPTX(JGPTXConfig.tiny(**kw, **extra))
        tm = T.GPTX(T.GPTXConfig.tiny(**kw, **extra), device="cpu")
        convert = T.gptx_params_from_numpy
    jm.init_params(jax.random.key(0))
    rng = np.random.default_rng(SEED)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        jm.params)
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tm.params = convert(tree, tm.config, device="cpu")
    return jm, tm


def _batch(seed=SEED, shape=(2, 12)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, shape).astype(np.int32)
    mask = np.ones(shape, np.int32)
    mask[1, -4:] = 0  # right padding
    return ids, mask


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_logits_loss_and_gradients_match_jax(name):
    jm, tm = build(name)
    ids, mask = _batch()
    positions = np.clip(np.cumsum(mask, -1) - 1, 0, None).astype(np.int32)
    kw = dict(input_ids=ids, attention_mask=mask, labels=ids, positions=positions)

    def jloss(p):
        out = jm.apply(p, **{k: jnp.asarray(v) for k, v in kw.items()})
        return out["loss"], out["logits"]

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jm.params)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tm.params)]
    out = tm.apply(tree_unflatten(tm.params, leaves), **{k: _t(v) for k, v in kw.items()})
    grads = torch.autograd.grad(out["loss"], leaves)
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), atol=ATOL, rtol=RTOL)
    jflat = jax.tree_util.tree_leaves(jgrads)
    assert len(jflat) == len(grads)
    for g, jg in zip(grads, jflat):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_cached_decode_equals_full_forward_and_jax(name):
    """Prefill 6 tokens, then 4 decode steps, through the cache: the
    logits stitch to the full forward's and equal JAX's cached path."""
    jm, tm = build(name)
    ids = np.random.default_rng(SEED + 1).integers(1, 256, (2, 10)).astype(np.int32)
    full = tm.apply(tm.params, input_ids=_t(ids))["logits"].numpy()
    cache = tm.init_cache(2, 16, dtype=torch.float32)
    jcache = jm.init_cache(2, 16, dtype=jnp.float32)
    logits = []
    for lo, hi in [(0, 6)] + [(t, t + 1) for t in range(6, 10)]:
        out = tm.apply(tm.params, input_ids=_t(ids[:, lo:hi]), cache=cache)
        jout = jm.apply(jm.params, input_ids=jnp.asarray(ids[:, lo:hi]), cache=jcache)
        cache, jcache = out["cache"], jout["cache"]
        np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]),
                                   atol=ATOL, rtol=RTOL)
        logits.append(out["logits"].numpy())
    np.testing.assert_allclose(np.concatenate(logits, 1), full, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_greedy_generate_on_ragged_prompts_token_identical_to_jax(name):
    jm, tm = build(name)
    rng = np.random.default_rng(SEED + 2)
    ids = rng.integers(1, 256, (3, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 4:] = 0
    mask[2, 2:] = 0
    want = np.asarray(jgenerate(jm, ids, attention_mask=mask, max_new_tokens=6,
                                temperature=0.0, cache_dtype=jnp.float32))
    got = T.generate(tm, _t(ids), attention_mask=_t(mask), max_new_tokens=6,
                     cache_dtype=torch.float32, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["neox", "opt", "gptj"])
def test_paged_engine_equals_generate_at_large_pool_offsets(name):
    """The paged engine on one slot: the later requests are admitted at
    large offsets of the pool, and each request's tokens equal ``generate``
    of it alone (learned tables and rope read the token's own positions)."""
    _, tm = build(name)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (6, 3, 5, 7)]
    engine = T.ContinuousBatcher(tm, batch_slots=1, max_new_tokens=5, max_cache_len=96,
                                 cache_dtype=torch.float32, bucket_sizes=(8,), block_size=4,
                                 device="cpu")
    rids = [engine.submit(p) for p in prompts]
    outs = engine.run()
    for rid, p in zip(rids, prompts):
        solo = T.generate(tm, _t(p[None]), max_new_tokens=5, cache_dtype=torch.float32,
                          include_prompt=False, device="cpu").numpy()[0]
        np.testing.assert_array_equal(outs[rid], solo[:len(outs[rid])], err_msg=f"rid {rid}")


@pytest.mark.parametrize("name", ["neox", "opt"])
def test_int8_forward_matches_jax_int8(name):
    jm, tm = build(name)
    j8, _ = build(name, matmul_precision="int8")
    t8 = T.GPTX(T.GPTXConfig.tiny(**VARIANTS[name], matmul_precision="int8"), device="cpu")
    t8.params = tm.params
    ids, mask = _batch(SEED + 4)
    want = jax.jit(lambda p, i, m: j8.apply(p, input_ids=i, attention_mask=m)["logits"])(
        jm.params, jnp.asarray(ids), jnp.asarray(mask))
    got = t8.apply(t8.params, input_ids=_t(ids), attention_mask=_t(mask))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    plain = tm.apply(tm.params, input_ids=_t(ids), attention_mask=_t(mask))["logits"]
    assert not torch.equal(got, plain)  # the int8 path really ran


def test_rotary_lanes_match_jax():
    """Distinct per-lane values through GPT-J's interleaved pairs and NeoX's
    partial half-split rotary (4 of 16 lanes), against the JAX functions."""
    rng = np.random.default_rng(SEED + 5)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32) + np.arange(8) * 10.0
    pos = np.tile(np.arange(5, dtype=np.int32)[None] * 7, (2, 1))
    jcos, jsin = j_rope_tables(jnp.asarray(pos), 8, 10000.0)
    cos, sin = rope_tables(_t(pos), 8, 10000.0)
    np.testing.assert_allclose(
        apply_rope_interleaved(_t(x), cos, sin).numpy(),
        np.asarray(j_rope_interleaved(jnp.asarray(x), jcos, jsin)), atol=1e-6, rtol=1e-6)
    jm, tm = build("neox")
    x16 = rng.standard_normal((2, 5, 4, 16)).astype(np.float32) + np.arange(16)
    jctx = jm.embed(jm.params, jnp.asarray(pos), jnp.asarray(pos))[1]
    _, ctx = tm.embed(tm.params, _t(pos), _t(pos))
    got = tm._rope(_t(x16), ctx).numpy()
    np.testing.assert_allclose(got, np.asarray(jm._rope(jnp.asarray(x16), jctx)),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[..., 4:], x16[..., 4:])  # the lanes past rotary_dim


def test_config_validation_matches_jax():
    for kw, match in ((dict(position_style="alibi"), "position_style"),
                      (dict(position_style="learned", rotary_dim=8), "rotary_dim is meaningless"),
                      (dict(shared_layernorm=True, parallel_residual=False), "shared_layernorm"),
                      (dict(rotary_dim=7), "even"),
                      (dict(rope_scaling={"rope_type": "dynamic", "factor": 2.0}), "dynamic"),
                      (dict(hidden_act="silu"), "hidden_act")):
        for cls in (JGPTXConfig, T.GPTXConfig):
            with pytest.raises(ValueError, match=match):
                cls.tiny(**kw)
    assert T.GPTXConfig.tiny().rotary_dim == JGPTXConfig.tiny().rotary_dim == 16
    with pytest.raises(ValueError, match="matmul precision"):
        T.GPTXConfig.tiny(matmul_precision="fp8")
    for impl in ("ring", "ulysses"):  # sequence parallelism is refused by name
        with pytest.raises(NotImplementedError, match="sequence parallelism"):
            T.GPTXConfig.tiny(attention_impl=impl)
        with pytest.raises(NotImplementedError, match="sequence parallelism"):
            T.GPT2Config.tiny(attention_impl=impl)
    model = T.GPTX(T.GPTXConfig.tiny(), device="cpu")
    model.init_params(0)
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        T.Accelerator(device="cpu", sp_plugin=T.SequenceParallelPlugin(2),
                      loopback=T.LoopbackShards(2)).prepare(model)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_num_params_equals_jax_and_the_tree(name):
    jm, tm = build(name)
    assert tm.num_params() == jm.num_params() == sum(t.numel() for t in tree_leaves(tm.params))
    if name != "gpt2":
        assert tm.flops_per_token() == jm.flops_per_token()


@pytest.mark.parametrize("name", ["opt", "gptj"])
def test_imperative_loop_equals_fused_step(name):
    """``model(**batch)`` → ``backward`` → ``optimizer.step()`` trains the
    fused step's numbers (adamw, clip 1.0, 3 steps)."""
    rng = np.random.default_rng(SEED + 6)
    batches = [torch.as_tensor(rng.integers(1, 256, (2, 12))) for _ in range(3)]
    losses = {}
    for kind in ("fused", "imperative"):
        _, tm = build(name)
        acc = T.Accelerator(device="cpu")
        pm, po = acc.prepare(tm, T.adamw(3e-3, device="cpu"))
        step = acc.build_train_step(pm, po)
        out = []
        for ids in batches:
            if kind == "fused":
                out.append(float(step({"input_ids": ids, "labels": ids}, clip_norm=1.0)))
                continue
            loss = pm(input_ids=ids, labels=ids)["loss"]
            acc.backward(loss)
            acc.clip_grad_norm_(pm, 1.0)
            po.step()
            po.zero_grad()
            out.append(float(loss.detach()))
        losses[kind] = out
    np.testing.assert_allclose(losses["imperative"], losses["fused"], rtol=1e-6, atol=1e-6)
    assert losses["fused"][-1] < losses["fused"][0]


@pytest.mark.parametrize("name", ["neox", "gpt2"])
def test_streamed_layers_equal_the_resident_model(name, tmp_path):
    """Empty init, the checkpoint loaded with the stacked layers on the
    host (``dispatch_model`` streams them a layer at a time): the logits
    and greedy tokens equal the resident model's; a tied head reads ``wte``
    where the map put the embedding."""
    from accelerate_tpu_torch.utils.modeling import named_parameters
    from accelerate_tpu_torch.utils.safetensors_io import save_file

    _, tm = build(name)
    path = tmp_path / "model.safetensors"
    save_file({k: v.contiguous() for k, v in named_parameters(tm.params).items()}, str(path))
    with T.init_empty_weights():
        cls = T.GPT2 if name == "gpt2" else T.GPTX
        empty = cls(tm.config, device="cpu")
        empty.init_params()
    device_map = {k: ("cpu" if k == "layers" else "cuda:0") for k in tm.params}
    streamed = T.load_checkpoint_and_dispatch(empty, str(path), device_map=device_map,
                                              main_device="cpu")
    assert type(streamed).__name__ == "StreamedScanModel"
    ids = _t(np.random.default_rng(SEED + 7).integers(1, 256, (2, 9)))
    np.testing.assert_array_equal(streamed(input_ids=ids)["logits"].numpy(),
                                  tm.apply(tm.params, input_ids=ids)["logits"].numpy())
    np.testing.assert_array_equal(
        T.generate(streamed, ids, max_new_tokens=4, device="cpu").numpy(),
        T.generate(tm, ids, max_new_tokens=4, device="cpu").numpy())
    assert streamed.bytes_streamed > 0


def test_zero_and_remat_train_the_plain_numbers():
    """ZeRO over dp 2 on the loopback and remat: the plain step's losses."""
    rng = np.random.default_rng(SEED + 8)
    batches = [torch.as_tensor(rng.integers(1, 256, (4, 12))) for _ in range(2)]
    runs = {}
    for kind in ("plain", "zero", "remat"):
        _, tm = build("opt", remat=kind == "remat")
        acc = T.Accelerator(device="cpu", **(dict(
            parallelism_config=T.ParallelismConfig(dp_size=2), loopback=T.LoopbackShards(2))
            if kind == "zero" else {}))
        acc.zero_sharding = kind == "zero"
        pm, po = acc.prepare(tm, T.adamw(3e-3, device="cpu"))
        step = acc.build_train_step(pm, po)
        runs[kind] = [float(step({"input_ids": b, "labels": b}, clip_norm=1.0))
                      for b in batches]
        if kind == "zero":
            assert po.zero_active
    np.testing.assert_allclose(runs["zero"], runs["plain"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(runs["remat"], runs["plain"])


# The planner: the port's rules and plans against the JAX package's, leaf
# by leaf, on shape-only trees (the tiny variants and pythia-6.9b's widths).
PLAN_MESHES = {"tp2xfsdp2": dict(tp_size=2, fsdp_size=2, dp_size=1),
               "tp4": dict(tp_size=4, dp_size=1), "pp2xdp2": dict(pp_size=2, dp_size=2),
               "pp2xtp2": dict(pp_size=2, tp_size=2, dp_size=1),
               "fsdp4": dict(fsdp_size=4, dp_size=1)}
PYTHIA_WIDTHS = dict(vocab_size=50432, hidden_size=4096, intermediate_size=16384,
                     num_hidden_layers=32, num_attention_heads=32, rotary_dim=32)


@pytest.mark.parametrize("mesh_name", sorted(PLAN_MESHES))
@pytest.mark.parametrize("name", ["neox", "gptj", "opt", "gpt2", "pythia-6.9b"])
def test_sharding_plan_matches_jax_leaf_by_leaf(name, mesh_name):
    from jax.sharding import PartitionSpec as P

    from accelerate_tpu.parallel import sharding as jsh
    from accelerate_tpu.parallel.mesh import ParallelismConfig as JPC
    from accelerate_tpu_torch.parallel import sharding as tsh

    if name == "pythia-6.9b":
        jm, tm = JGPTX(JGPTXConfig(**PYTHIA_WIDTHS)), T.GPTX(T.GPTXConfig(**PYTHIA_WIDTHS),
                                                            device="cpu")
    elif VARIANTS[name] is None:
        jm, tm = JGPT2(JGPT2Config.tiny()), T.GPT2(T.GPT2Config.tiny(), device="cpu")
    else:
        jm = JGPTX(JGPTXConfig.tiny(**VARIANTS[name]))
        tm = T.GPTX(T.GPTXConfig.tiny(**VARIANTS[name]), device="cpu")
    rules = tm.sharding_rules()
    assert [(p, tuple(s)) for p, s in jm.sharding_rules()] == [(p, tuple(s)) for p, s in rules]
    tm.device = torch.device("meta")
    port = tm.init()
    jtree = jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                                   port)
    kw = PLAN_MESHES[mesh_name]
    mesh = JPC(**kw).build_mesh(jax.devices()[:int(np.prod(list(kw.values())))])
    sizes = {k: int(v) for k, v in mesh.shape.items()}
    want = jsh.plan_param_shardings(jtree, mesh, rules=[(p, P(*s)) for p, s in rules])
    got = tsh.plan_param_shardings(port, sizes, rules=rules)
    assert [s for _, s in tsh._walk(got)] == [
        tuple(s.spec) for s in jax.tree_util.tree_leaves(want, is_leaf=lambda s: hasattr(
            s, "spec"))]


def test_sharded_training_refuses_bert_by_name():
    model = T.BertForSequenceClassification(T.BertConfig.tiny(), device="cpu")
    model.init_params(0)
    acc = T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(fsdp_size=2),
                        loopback=T.LoopbackShards(2))
    with pytest.raises(NotImplementedError, match="BertForSequenceClassification lacks"):
        acc.prepare(model, T.adamw(1e-3, device="cpu"))
