"""Ulysses sequence parallelism (``parallel/ulysses.py``) and the imperative
loop under sp, against the JAX package.

Single process: ``LoopbackUlysses`` (all sp ranks in one process) against
the port's dense attention (values and gradients, with padding, sp 2 and
4), against the JAX package's ``ulysses_attention`` on the virtual CPU mesh
(values), the JAX ``ValueError`` on heads that do not divide by sp, and the
``attention(impl="ulysses")`` entry with a loopback group.

Across 4 gloo ranks (one launch for the file, the case machinery of
``tests/test_torch_tp_dist.py``, the JAX references computed while the
ranks train): the fused step under Ulysses sp 4
(``SequenceParallelPlugin(ring_attention=False)``) and Ulysses sp 2 x tp 2
(``LlamaConfig(attention_impl="ulysses")``) against JAX's fused step on the
same 4-device mesh (losses rtol 1e-5; parameters rtol 1e-3, atol 1e-5;
every leaf's gradient rtol 1e-4, atol 1e-6), and the imperative loop under
dp 2 x sp 2 with the ring and with Ulysses, and under Ulysses sp 2 x tp 2
on shards (each rank passes its dp rows whole; the model call cuts its
sequence shard, and gathers the logits back into sequence order) against
JAX's fused step on that mesh; and
``utils/operations.all_to_all_along`` over the 4 ranks.
"""

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.ops.attention import attention, dense_attention
from accelerate_tpu_torch.parallel.ulysses import LoopbackUlysses, ulysses_attention

import test_torch_tp_dist as D

SP_FUSED = ("sp4_ulysses", "sp2xtp2_ulysses")
SP_IMPERATIVE = ("dp2xsp2_ring", "dp2xsp2_ulysses", "sp2xtp2_ulysses")
SP_CASES = tuple(("fused", n) for n in SP_FUSED) + tuple(
    ("imperative", n) for n in SP_IMPERATIVE) + (("collectives", None),)


def _qkv(B=2, S=32, H=4, D_=16, seed=0, padded=True):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((B, S, H, D_), generator=g) for _ in range(3))
    mask = None
    if padded:
        mask = torch.ones((B, S), dtype=torch.int32)
        mask[1, S - 5:] = 0
    return q, k, v, mask


@pytest.mark.parametrize("sp", [2, 4])
def test_loopback_ulysses_matches_dense_attention(sp):
    """The n ranks' shards through the two all-to-alls: the output shards
    concatenated are dense attention over the sequence, and so are the
    gradients of q, k and v (f32)."""
    q, k, v, mask = _qkv()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = dense_attention(*leaves, causal=True, mask=mask)
    do = torch.randn_like(want)
    want_grads = torch.autograd.grad(want, leaves, do)
    shards = [list(t.chunk(sp, dim=1)) for t in leaves]
    outs = ulysses_attention(*shards, causal=True, mask=list(mask.chunk(sp, dim=1)),
                             group=LoopbackUlysses(sp))
    got = torch.cat(outs, dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    got_grads = torch.autograd.grad(got, leaves, do)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    # The attention entry cuts a loopback group's whole sequence itself.
    via_entry = attention(q, k, v, causal=True, mask=mask, impl="ulysses",
                          group=LoopbackUlysses(sp))
    torch.testing.assert_close(via_entry, want.detach(), rtol=0, atol=1e-6)


def test_loopback_ulysses_matches_jax_ulysses_attention():
    """JAX's ``ulysses_attention`` on a 4-device sp mesh (shard_map and
    all-to-all) against the port's 4 loopback ranks, on the same inputs."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.parallel.mesh import ParallelismConfig as JParallelismConfig
    from accelerate_tpu.parallel.ulysses import ulysses_attention as jax_ulysses

    q, k, v, mask = _qkv(B=1, S=64, H=4, D_=16, seed=3, padded=False)
    mesh = JParallelismConfig(sp_size=4, dp_size=1).build_mesh(jax.devices()[:4])
    want = np.asarray(jax_ulysses(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True,
                                  mesh=mesh))
    outs = ulysses_attention(*(list(t.chunk(4, dim=1)) for t in (q, k, v)), causal=True,
                             group=LoopbackUlysses(4))
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), want, rtol=1e-5, atol=1e-6)


def test_ulysses_refuses_heads_that_do_not_divide_as_jax():
    """3 heads over sp 2: both packages raise the same ``ValueError``."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.parallel.mesh import ParallelismConfig as JParallelismConfig
    from accelerate_tpu.parallel.ulysses import ulysses_attention as jax_ulysses

    q, k, v, _ = _qkv(B=1, S=16, H=3, padded=False)
    mesh = JParallelismConfig(sp_size=2, dp_size=1).build_mesh(jax.devices()[:2])
    with pytest.raises(ValueError) as jax_error:
        jax_ulysses(*(jnp.asarray(t.numpy()) for t in (q, k, v)), mesh=mesh)
    with pytest.raises(ValueError) as port_error:
        ulysses_attention(*(list(t.chunk(2, dim=1)) for t in (q, k, v)),
                          group=LoopbackUlysses(2))
    assert str(port_error.value) == str(jax_error.value)
    assert "Ulysses needs heads divisible by sp" in str(port_error.value)


def test_ulysses_loopback_steps_as_the_unsharded_step():
    """Ulysses sp 4 on ``LoopbackShards(4)`` (the card's phase 15 arm E at
    a tiny size): three f32 steps against the unsharded step."""
    runs = []
    for kw in ({}, dict(sp_plugin=T.SequenceParallelPlugin(4, ring_attention=False),
                        loopback=T.LoopbackShards(4))):
        acc = T.Accelerator(device="cpu", **kw)
        model = T.Llama(T.LlamaConfig.tiny(**D.CFG), device="cpu")
        model.init_params(0)
        pm, po = acc.prepare(model, T.adamw(D.LR, device="cpu"))
        step = acc.build_train_step(pm, po)
        runs.append([float(step(b, clip_norm=1.0)) for b in D.step_batches()])
        if kw:
            assert pm.module.config.attention_impl == "ulysses"
    np.testing.assert_allclose(runs[1], runs[0], rtol=0, atol=1e-5)


# ------------------------------------------------------------- gloo ranks
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig

    jm = JLlama(JConfig.tiny(**D.CFG))
    jm.init_params(jax.random.key(0))
    start = jax.tree_util.tree_map(np.asarray, jm.params)
    out = tmp_path_factory.mktemp("sp_cases")
    join = D.launch_cases(start, out, SP_CASES)
    try:
        fused = {name: D.jax_fused_reference(name) for name in SP_FUSED}
        imperative = {}
        for name in SP_IMPERATIVE:
            if name in fused:  # dp 1: the mean of the data ranks' means is the global mean
                imperative[name] = fused[name]
                continue
            mesh, cfg_kw = D.IMPERATIVE[name]
            impl = cfg_kw["attention_impl"]
            imperative[name] = D._jax_run(mesh, D.step_batches(), attention_impl=impl,
                                          ring=impl == "ring")
        grads = D._jax_grads(start, D.step_batches()[0])
    finally:
        join()
    return {"out": out, "fused": fused, "imperative": imperative, "grads": grads}


@pytest.mark.parametrize("name", SP_FUSED)
def test_ulysses_step_matches_jax(runs, name):
    ranks = D.load_ranks(runs["out"], f"fused_{name}")
    want = runs["fused"][name]
    for saved in ranks:
        np.testing.assert_allclose(saved["losses"], want["losses"], rtol=D.LOSS_RTOL, atol=0)
        assert str(saved["impl"]) == "ulysses"
    D._assert_params(ranks, want["params"])


@pytest.mark.parametrize("name", SP_FUSED)
def test_ulysses_step_gradients_match_jax_leaf_by_leaf(runs, name):
    for saved in D.load_ranks(runs["out"], f"fused_{name}"):
        got = {k[2:]: v for k, v in saved.items() if k.startswith("g.")}
        assert sorted(got) == sorted(runs["grads"])
        for key, w in runs["grads"].items():
            np.testing.assert_allclose(got[key], w, rtol=D.GRAD_RTOL, atol=D.GRAD_ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("name", SP_IMPERATIVE)
def test_imperative_loop_under_sp_matches_jax(runs, name):
    """Each rank's loss reads as its dp rows' mean (the sp shares summed);
    the logits of an eval forward come back whole, in sequence order."""
    ranks = D.load_ranks(runs["out"], f"imperative_{name}")
    want = runs["imperative"][name]
    for saved in ranks:
        np.testing.assert_allclose(saved["losses"], want["losses"], rtol=D.LOSS_RTOL, atol=0)
        assert tuple(saved["logits_shape"]) == (2, 16, D.CFG["vocab_size"])
    D._assert_params(ranks, want["params"])


def test_all_to_all_along_over_four_ranks(runs):
    """Chunk j of each rank's tensor along the split dim reaches rank j, the
    received chunks concatenated along the other dim in rank order."""
    for r, saved in enumerate(D.load_ranks(runs["out"], "collectives_None")):
        x = np.arange(4 * 8 * 3).reshape(4, 8, 3)
        want = np.concatenate([(x + 1000 * i)[:, 2 * r:2 * r + 2] for i in range(4)], axis=0)
        assert np.array_equal(saved["all_to_all"], want)
