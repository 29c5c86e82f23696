"""The port's mixture of experts (``ops/moe.py``, ``models/moe.py``) against
the JAX package's, f32 on the CPU, at ``MoELlamaConfig.tiny()`` sizes.

Inputs come from numpy with the seeds below; the JAX model's weights from a
fixed key, carried across with ``models/from_jax``. Tolerances, with their
reasons:

- routing (``top_k_routing``): the dispatch and combine one-hots exactly,
  the combine weights and the router loss at 1e-6 (one softmax, one
  renormalisation);
- the three dispatch back-ends, outputs and the gradients with respect to
  the input, the router and each expert stack: 1e-5 (f32 products summed
  in another order), with a capacity-drop case (cf 1.0: 32 claims a row for
  16 slots an expert), a drop-free case (cf E/k) and a tie case (logits
  with equal router probabilities, which ``lax.top_k`` breaks toward the
  lower expert);
- ``MoELlama``: logits, loss and ``aux_loss`` at 1e-5 and every leaf's
  gradient at 1e-5 (the model tests' pins); the cached decode's logits at
  1e-5;
- serving: ``generate`` and the paged ``ContinuousBatcher`` token-identical
  to the JAX package's where JAX's top-2 logit gap is above 1e-2, and
  teacher-forced below it (as ``tests/test_torch_int8_serving.py``);
- three ``build_train_step`` losses at 1e-5 against JAX's fused step on the
  8-device CPU mesh (batch 8, ``adamw(3e-4)``, clip 1.0);
- GPipe and 1F1B at pp 2 (JAX ``tests/test_pp_training.py:142,369``: the
  router loss per microbatch) against JAX's pipelined step on the same
  8-device mesh (pp 2 x dp 4, so the port's loopback of 8 ranks takes the
  router's top-1 fractions over the data ranks of each microbatch): losses
  at 1e-5;
- ``mixtral_config_from_hf`` field by field on Mixtral-8x7B's published
  config, ``num_params`` and ``flops_per_token`` exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models.moe import MoELlama as JMoE, MoELlamaConfig as JConfig
from accelerate_tpu.ops import moe as jmoe

import accelerate_tpu_torch as T
from accelerate_tpu_torch.ops import moe as tmoe

torch.set_num_threads(2)

SEED = 5
ROUTE_ATOL = 1e-6
ATOL = 1e-5
NEAR_TIE = 1e-2
MIXTRAL_8X7B = dict(architectures=["MixtralForCausalLM"], model_type="mixtral",
                    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    num_local_experts=8, num_experts_per_tok=2, rope_theta=1e6,
                    rms_norm_eps=1e-5, router_aux_loss_coef=0.02,
                    max_position_embeddings=32768, tie_word_embeddings=False, sliding_window=None)


def _layer(seed=SEED, B=2, S=16, h=8, i=16, E=4, tie=False):
    """x, router, w_gate, w_up, w_down as numpy f32; with ``tie`` the router
    sends every token two pairs of equal logits (columns 0 = 2, 1 = 3)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, h)).astype(np.float32)
    router = rng.standard_normal((h, E)).astype(np.float32)
    if tie:
        router[:, 2] = router[:, 0]
        router[:, 3] = router[:, 1]
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((E, h, i), (E, h, i), (E, i, h))]
    return [x, router, *ws]


def test_router_capacity_matches_jax():
    for args in ((128, 8, 2, 1.0), (8, 8, 1, 1.0), (100, 8, 2, 1.25), (2048, 8, 2, 4.0),
                 (1, 8, 2, 4.0), (16, 4, 2, 2.0)):
        assert tmoe.router_capacity(*args) == jmoe.router_capacity(*args)


@pytest.mark.parametrize("case", ["random", "tie", "drop"])
def test_top_k_routing_matches_jax(case):
    rng = np.random.default_rng(SEED)
    B, S, E, k, C = 2, 32, 4, 2, 8
    logits = rng.standard_normal((B, S, E)).astype(np.float32)
    if case == "tie":
        logits[..., 2] = logits[..., 0]
        logits[..., 3] = logits[..., 0]
    if case == "drop":  # every token wants expert 2 first: C slots, the rest dropped
        logits[..., 2] += 10.0
    jd, jc, ja = jmoe.top_k_routing(jnp.asarray(logits), k, C)
    td, tc, ta = tmoe.top_k_routing(torch.tensor(logits), k, C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy() != 0, np.asarray(jc) != 0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ROUTE_ATOL, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=ROUTE_ATOL, rtol=0)
    if case == "drop":
        assert float(td[..., 2, :].sum()) == B * C  # exactly C slots of expert 2 a row


def _grads(fn, arrays, framework):
    """Output, router loss, and the gradients of ``sum(out**2) + aux`` with
    respect to every input."""
    if framework == "jax":
        def loss(*a):
            out, aux = fn(*a)
            return jnp.sum(out ** 2) + aux, (out, aux)
        (_, (out, aux)), grads = jax.value_and_grad(loss, argnums=tuple(range(5)),
                                                    has_aux=True)(*map(jnp.asarray, arrays))
        return np.asarray(out), float(aux), [np.asarray(g) for g in grads]
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out, aux = fn(*leaves)
    (out.square().sum() + aux).backward()
    return out.detach().numpy(), float(aux.detach()), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("backend", ["sorted", "einsum", "indexed"])
@pytest.mark.parametrize("cf,tie", [(1.0, False), (2.0, False), (1.0, True)],
                         ids=["drop", "drop_free", "tie"])
def test_dispatch_backends_match_jax_with_gradients(backend, cf, tie):
    arrays = _layer(tie=tie)
    kw = dict(k=2, capacity_factor=cf)
    want = _grads(lambda *a: getattr(jmoe, f"moe_ffn_{backend}")(*a, **kw), arrays, "jax")
    got = _grads(lambda *a: getattr(tmoe, f"moe_ffn_{backend}")(*a, **kw), arrays, "torch")
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL, rtol=0)
    for name, g, w in zip(("x", "router", "w_gate", "w_up", "w_down"), got[2], want[2]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


def test_dispatch_rule_and_the_environment(monkeypatch):
    """The auto rule (ep > 1: einsum; S <= 2048 and cf <= 2: einsum; else
    sorted), the override, and an invalid value raising in both packages."""
    monkeypatch.delenv(tmoe.DISPATCH_ENV, raising=False)
    assert tmoe.dispatch_impl(2048, 2.0) == "einsum"
    assert tmoe.dispatch_impl(2049, 2.0) == "sorted"
    assert tmoe.dispatch_impl(16, 4.0) == "sorted"  # Mixtral's drop-free cf, even at decode
    assert tmoe.dispatch_impl(1, 4.0, ep=2) == "einsum"
    arrays = _layer()
    called = []
    for impl in ("sorted", "einsum", "indexed"):
        monkeypatch.setenv(tmoe.DISPATCH_ENV, impl)
        real = tmoe.BACKENDS[impl]
        monkeypatch.setitem(tmoe.BACKENDS, impl,
                            lambda *a, _r=real, _n=impl, **kw: called.append(_n) or _r(*a, **kw))
        out, _ = tmoe.moe_ffn(*map(torch.tensor, arrays), k=2, capacity_factor=1.0)
        jout, _ = jmoe.moe_ffn(*map(jnp.asarray, arrays), k=2, capacity_factor=1.0)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    assert called == ["sorted", "einsum", "indexed"]
    monkeypatch.setenv(tmoe.DISPATCH_ENV, "dense")
    with pytest.raises(ValueError, match="not a dispatch back-end"):
        tmoe.moe_ffn(*map(torch.tensor, arrays), k=2)
    with pytest.raises(ValueError, match="not a dispatch back-end"):
        jmoe.moe_ffn(*map(jnp.asarray, arrays), k=2)


# ------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def models():
    jm = JMoE(JConfig.tiny())
    jm.init_params(jax.random.key(0))
    tm = T.MoELlama(T.MoELlamaConfig.tiny(), device="cpu")
    tm.params = T.moe_llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                              tm.config, device="cpu")
    return jm, tm


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def test_moe_llama_matches_jax_with_gradients(models):
    jm, tm = models
    ids = np.random.default_rng(SEED).integers(0, 256, (2, 16)).astype(np.int32)
    jout = jm.apply(jm.params, input_ids=ids, labels=ids)
    tout = tm.apply(tm.params, input_ids=torch.tensor(ids), labels=torch.tensor(ids))
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]), atol=ATOL,
                               rtol=0)
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tout[key]), float(jout[key]), atol=ATOL, rtol=0)
    assert float(tout["aux_loss"]) >= 1.0 - 1e-3  # the Switch loss's lower bound
    jg = _flat(jax.grad(lambda p: jm.apply(p, input_ids=ids, labels=ids)["loss"])(jm.params))
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in _flat(tm.params).items()}
    tree = {}
    for key, leaf in leaves.items():
        node = tree
        *head, last = key.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = leaf
    tm.apply(tree, input_ids=torch.tensor(ids), labels=torch.tensor(ids))["loss"].backward()
    assert sorted(jg) == sorted(leaves)
    for key, leaf in leaves.items():
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg[key]), atol=ATOL, rtol=0,
                                   err_msg=key)


def test_cached_decode_matches_jax(models):
    """``tests/test_moe.py:125``'s counterpart: prefill 8 tokens into a
    16-slot cache, then two decode steps; the logits of each match."""
    jm, tm = models
    ids = np.random.default_rng(SEED + 1).integers(0, 256, (1, 8)).astype(np.int32)
    jout = jm.apply(jm.params, input_ids=ids, cache=jm.init_cache(1, 16, dtype=jnp.float32))
    tout = tm.apply(tm.params, input_ids=torch.tensor(ids),
                    cache=tm.init_cache(1, 16, dtype=torch.float32))
    assert int(tout["cache"]["pos"]) == int(jout["cache"]["pos"]) == 8
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]), atol=ATOL,
                               rtol=0)
    for tok in (3, 77):
        feed = np.asarray([[tok]], np.int32)
        jout = jm.apply(jm.params, input_ids=feed, cache=jout["cache"])
        tout = tm.apply(tm.params, input_ids=torch.tensor(feed), cache=tout["cache"])
        np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                                   atol=ATOL, rtol=0)


def test_generate_matches_jax_up_to_near_ties(models):
    from accelerate_tpu.generation import generate as jgenerate

    jm, tm = models
    rng = np.random.default_rng(SEED + 2)
    ids = rng.integers(1, 256, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 4:] = 0
    steps = 6
    ref = np.asarray(jgenerate(jm, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                               max_new_tokens=steps, cache_dtype=jnp.float32,
                               include_prompt=False))
    got = T.generate(tm, ids, attention_mask=mask, max_new_tokens=steps,
                     cache_dtype=torch.float32, include_prompt=False, device="cpu").numpy()
    assert got.shape == ref.shape
    # Teacher-forced: feed JAX's tokens through the port's uncached forward
    # and hold each position's JAX top-2 gap where the tokens part.
    full = np.concatenate([ids, ref], axis=1)
    fmask = np.concatenate([mask, np.ones_like(ref)], axis=1)
    jl = np.asarray(jm.apply(jm.params, input_ids=full, attention_mask=fmask)["logits"])
    for b in range(3):
        differ = np.nonzero(got[b] != ref[b])[0]
        if differ.size:
            t = differ[0]
            pos = int(mask[b].sum()) - 1 + t
            top2 = np.sort(jl[b, pos])[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, (b, t)


def test_paged_engine_matches_jax_engine(models):
    from accelerate_tpu.serving import ContinuousBatcher as JBatcher

    jm, tm = models
    engine = dict(batch_slots=2, max_new_tokens=5, max_cache_len=128, bucket_sizes=(8, 16),
                  sync_every=2, block_size=4, max_tokens_per_request=48)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (11, 4, 7, 3)]
    je = JBatcher(jm, paged=True, cache_dtype=jnp.float32, kernels="interpret", **engine)
    jr = [je.submit(p) for p in prompts]
    jout = je.run()
    te = T.ContinuousBatcher(tm, cache_dtype=torch.float32, device="cpu", **engine)
    tr = [te.submit(p) for p in prompts]
    tout = te.run()
    for a, b, p in zip(jr, tr, prompts):
        got, want = np.asarray(tout[b]), np.asarray(jout[a])
        if np.array_equal(got, want):
            continue
        t = int(np.nonzero(got != want)[0][0])
        seq = np.concatenate([p, want[:t]])[None].astype(np.int32)
        top2 = np.sort(np.asarray(jm.apply(jm.params, input_ids=seq)["logits"])[0, -1])[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (b, t)


# ---------------------------------------------------------------- training
def _jax_train(mesh_kw, plugin_kw=None, steps=3, cfg_kw=None, batch=8, lr=3e-4):
    import optax

    from accelerate_tpu import Accelerator as JAccelerator, ParallelismConfig as JPC
    from accelerate_tpu.state import AcceleratorState, GradientState
    from accelerate_tpu.utils.dataclasses import PipelineParallelPlugin as JPlugin

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        acc = JAccelerator(parallelism_config=JPC(**mesh_kw),
                           pp_plugin=JPlugin(**plugin_kw) if plugin_kw else None)
        jm = JMoE(JConfig.tiny(**(cfg_kw or {})))
        jm.init_params(jax.random.key(0))
        start = jax.tree_util.tree_map(np.asarray, jm.params)
        pm, po = acc.prepare(jm, optax.adamw(lr))
        step = acc.build_train_step(pm, po)
        losses = [float(step(b, clip_norm=1.0)) for b in _train_batches(steps, batch)]
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    return np.asarray(losses), start


def _train_batches(steps, batch):
    rng = np.random.default_rng(SEED + 4)
    return [{"input_ids": ids, "labels": ids}
            for ids in (rng.integers(0, 256, (batch, 16)).astype(np.int32)
                        for _ in range(steps))]


def _port_train(start, steps=3, cfg_kw=None, batch=8, lr=3e-4, **acc_kw):
    acc = T.Accelerator(device="cpu", **acc_kw)
    model = T.MoELlama(T.MoELlamaConfig.tiny(**(cfg_kw or {})), device="cpu")
    model.params = T.moe_llama_params_from_numpy(start, model.config, device="cpu")
    pm, po = acc.prepare(model, T.adamw(lr, device="cpu"))
    step = acc.build_train_step(pm, po)
    return np.asarray([float(step(b, clip_norm=1.0)) for b in _train_batches(steps, batch)]), pm


def test_train_step_matches_jax():
    want, start = _jax_train({})
    got, _ = _port_train(start)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_router_loss_through_the_pipeline_matches_jax(schedule):
    """pp 2 on the 8-device mesh (dp 4), 2 microbatches, the router loss per
    microbatch (coef 0.01): the port's loopback of 8 ranks against JAX."""
    plugin = dict(pp_size=2, num_microbatches=2, schedule=schedule)
    cfg_kw = dict(router_aux_coef=0.01, capacity_factor=2.0)
    want, start = _jax_train(dict(pp_size=2), plugin, steps=2, cfg_kw=cfg_kw, batch=8)
    got, pm = _port_train(start, steps=2, cfg_kw=cfg_kw, batch=8,
                          parallelism_config=T.ParallelismConfig(pp_size=2),
                          pp_plugin=T.PipelineParallelPlugin(**plugin),
                          loopback=T.LoopbackShards(8))
    assert pm.handle.pipeline_spec.schedule == schedule
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ----------------------------------------------------- converter, estimates
def test_mixtral_config_matches_jax_field_by_field():
    from accelerate_tpu.models.convert import mixtral_config_from_hf as jconvert

    for hf in (MIXTRAL_8X7B, dict(MIXTRAL_8X7B, router_aux_loss_coef=None, sliding_window=4096,
                                  rope_scaling={"rope_type": "linear", "factor": 2.0})):
        want = dataclasses.asdict(jconvert(hf))
        got = dataclasses.asdict(T.mixtral_config_from_hf(hf))
        for key, value in want.items():
            if key in got:
                assert got[key] == value, key
        assert got["capacity_factor"] == 4.0
    assert T.mixtral_config_from_hf(dict(MIXTRAL_8X7B, router_aux_loss_coef=None)
                                    ).router_aux_coef == 0.001
    with pytest.raises(ValueError, match="rope_type"):
        T.mixtral_config_from_hf(dict(MIXTRAL_8X7B, rope_scaling={"rope_type": "longrope"}))


def test_params_and_flops_match_jax():
    for hf in (MIXTRAL_8X7B, dict(MIXTRAL_8X7B, num_hidden_layers=2)):
        from accelerate_tpu.models.convert import mixtral_config_from_hf as jconvert

        jm = JMoE(jconvert(hf))
        tm = T.MoELlama(T.mixtral_config_from_hf(hf), device="cpu")
        assert tm.num_params() == jm.num_params()
        assert tm.flops_per_token() == jm.flops_per_token()
    assert T.MoELlama(T.mixtral_config_from_hf(MIXTRAL_8X7B),
                      device="cpu").num_params() == 46_702_792_704
