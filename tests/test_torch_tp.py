"""Tensor parallelism in one process: the planners on tp meshes, Megatron's
conjugate ops and the vocab-parallel parts on ``LoopbackTP``, the loopback
layouts against the unsharded step, and the entry points.

- The port's planners pick JAX's spec leaf by leaf on tp 2, tp 4, tp 2 x
  fsdp 2, dp 2 x tp 2 and dp 2 x fsdp 2 x tp 2, with and without the Llama
  rules (relaxed where a dim does not divide), and ZeRO's extension of a tp
  plan by dp.
- ``parallel/tensor.py`` on a loopback of 2 and 4 ranks: the vocab-parallel
  embedding, the plain and the fused (vocab-chunked) vocab-parallel losses
  against the unsharded ones, forward and gradients (f32, 1e-6), at vocab
  100 with chunks of 32 that cross the shards' boundaries in the unsharded
  layout; a column- then row-parallel MLP against the whole one.
- JAX's ``tests/test_fused_loss.py:195-225`` case on the port: tp 2 x fsdp 2
  x dp 2 (a loopback of 8 ranks), vocab 100, chunk 32, ``sgd(0.05)``, 3
  steps: the fused loss equals the dense one (rtol 1e-5), and both equal
  JAX's dense run on the same 8-device mesh.
- Loopback layouts (tp 2, tp 4, tp 2 x fsdp 2, dp 2 x tp 2 with ZeRO, tp 2
  with remat, Ulysses sp 2 x tp 2, the ring sp 4) train as the unsharded
  step (f32, losses 1e-5, parameters 5e-5: the remat tests' pins).
- ``ACCELERATE_MESH_SHAPE`` resolves as JAX's; the tp and Megatron plugins
  build the mesh; ep reaches it, and ep with pp or with sp raises.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from accelerate_tpu.parallel import sharding as jsh
from accelerate_tpu.parallel.mesh import ParallelismConfig as JParallelismConfig

import accelerate_tpu_torch as T
from accelerate_tpu_torch.ops.losses import (
    cross_entropy_loss,
    fused_cross_entropy_loss,
    vocab_parallel_cross_entropy,
    vocab_parallel_fused_cross_entropy,
)
from accelerate_tpu_torch.parallel import sharding as tsh
from accelerate_tpu_torch.parallel.tensor import LoopbackTP, vocab_parallel_embedding
from accelerate_tpu_torch.utils.tree import tree_leaves

MESHES = {
    "tp2": dict(tp_size=2, dp_size=1),
    "tp4": dict(tp_size=4, dp_size=1),
    "tp2xfsdp2": dict(tp_size=2, fsdp_size=2, dp_size=1),
    "dp2xtp2": dict(tp_size=2, dp_size=2),
    "dp2xfsdp2xtp2": dict(tp_size=2, fsdp_size=2, dp_size=2),
}
LLAMA_RULES = T.Llama(T.LlamaConfig.tiny(), device="cpu").sharding_rules()


def _mesh(name):
    kw = MESHES[name]
    n = int(np.prod([v for v in kw.values() if v > 0]))
    return JParallelismConfig(**kw).build_mesh(jax.devices()[:n])


def _trees(cfg):
    model = T.Llama(cfg, device="cpu")
    model.device = torch.device("meta")
    port = model.init()
    return port, jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32), port)


TREES = {"tiny": T.LlamaConfig.tiny(), "tiny_odd_vocab": T.LlamaConfig.tiny(vocab_size=102),
         "llama3_8b": T.LlamaConfig.llama3_8b()}


def _jax_specs(tree):
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda s: hasattr(s, "spec"))]


def _port_specs(tree):
    return [s for _, s in tsh._walk(tree)]


def _jax_rules(rules):
    from jax.sharding import PartitionSpec as P

    return None if rules is None else [(pat, P(*spec)) for pat, spec in rules]


@pytest.mark.parametrize("with_rules", [True, False], ids=["rules", "auto"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_tp_param_plan_matches_jax_leaf_by_leaf(tree, mesh_name, with_rules):
    port, jtree = _trees(TREES[tree])
    mesh = _mesh(mesh_name)
    rules = LLAMA_RULES if with_rules else None
    sizes = {k: int(v) for k, v in mesh.shape.items()}
    want = _jax_specs(jsh.plan_param_shardings(jtree, mesh, rules=_jax_rules(rules)))
    assert _port_specs(tsh.plan_param_shardings(port, sizes, rules=rules)) == want


@pytest.mark.parametrize("mesh_name", ["dp2xtp2", "dp2xfsdp2xtp2"])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_zero_extends_a_tp_plan_as_jax(tree, mesh_name):
    port, jtree = _trees(TREES[tree])
    mesh = _mesh(mesh_name)
    sizes = {k: int(v) for k, v in mesh.shape.items()}
    jbase = jsh.plan_param_shardings(jtree, mesh, rules=_jax_rules(LLAMA_RULES))
    want = _jax_specs(jsh.plan_zero_shardings(jtree, jbase, mesh))
    base = tsh.plan_param_shardings(port, sizes, rules=LLAMA_RULES)
    assert _port_specs(tsh.plan_zero_shardings(port, base, sizes)) == want


def test_llama3_8b_tp4_layout():
    """Phase 15's tp 4 cut: each rank's wq holds 8 of the 32 query heads,
    wk and wv 2 of the 8 KV heads, the vocab a quarter of 128256."""
    port, _ = _trees(T.LlamaConfig.llama3_8b())
    specs = dict(tsh._walk(tsh.plan_param_shardings(port, {"tp": 4}, rules=LLAMA_RULES)))
    shapes = dict(tsh._walk(port))
    local = {k: tsh.local_leaf_shape(shapes[k].shape, specs[k], {"tp": 4}) for k in specs}
    assert local["layers/attn/wq"] == (32, 4096, 8 * 128)
    assert local["layers/attn/wk"] == (32, 4096, 2 * 128)
    assert local["layers/attn/wo"] == (32, 8 * 128, 4096)
    assert local["embed/weight"] == (128256 // 4, 4096)
    assert local["lm_head/weight"] == (4096, 128256 // 4)
    assert local["layers/input_norm/weight"] == (32, 4096)


# ------------------------------------------------------ conjugate ops, vocab
def _pieces(t, n, dim):
    return [p.detach().clone().requires_grad_(True) for p in t.chunk(n, dim)]


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_embedding_matches_the_lookup(n):
    g = torch.Generator().manual_seed(0)
    table = torch.randn((100, 16), generator=g, requires_grad=True)
    ids = torch.randint(0, 100, (3, 7), generator=g)
    want = F.embedding(ids, table)
    do = torch.randn(want.shape, generator=g)
    (want_grad,) = torch.autograd.grad(want, table, do)
    pieces = _pieces(table, n, 0)
    got = vocab_parallel_embedding(LoopbackTP(n), pieces, ids)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got_grad = torch.cat(torch.autograd.grad(got, pieces, do), 0)
    torch.testing.assert_close(got_grad, want_grad, rtol=0, atol=0)


def _loss_inputs(cap=None):
    g = torch.Generator().manual_seed(1)
    hidden = torch.randn((2, 9, 16), generator=g, requires_grad=True)
    head = torch.randn((16, 100), generator=g, requires_grad=True)
    labels = torch.randint(0, 100, (2, 9), generator=g)
    labels[1, 4:] = -100
    return hidden, head, labels


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_cross_entropy_matches_the_dense_loss(n):
    hidden, head, labels = _loss_inputs()
    logits = hidden @ head
    want = cross_entropy_loss(logits, labels)
    want_grads = torch.autograd.grad(want, (hidden, head))
    pieces = _pieces(head, n, 1)
    tp = LoopbackTP(n)
    got = vocab_parallel_cross_entropy(tp, [x @ w for x, w in zip(tp.copy(hidden), pieces)],
                                       labels)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    dx, *dw = torch.autograd.grad(got, [hidden] + pieces)
    torch.testing.assert_close(dx, want_grads[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat(dw, 1), want_grads[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("custom_backward", [True, False], ids=["custom", "ad"])
@pytest.mark.parametrize("cap", [None, 5.0], ids=["nocap", "cap"])
@pytest.mark.parametrize("transposed", [False, True], ids=["hV", "Vh"])
@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_fused_loss_matches_the_fused_loss(n, transposed, cap, custom_backward):
    """Vocab 100 in chunks of 32: unsharded, the chunks cross the tp
    shards' boundaries (50 or 25 wide); each rank chunks its own slice."""
    hidden, head, labels = _loss_inputs()
    w = head.detach().T.contiguous().requires_grad_(True) if transposed else head
    kw = dict(vocab_chunk=32, logit_cap=cap, head_transposed=transposed,
              custom_backward=custom_backward)
    want = fused_cross_entropy_loss(hidden, w, labels, **kw)
    want_grads = torch.autograd.grad(want, (hidden, w))
    pieces = _pieces(w, n, 0 if transposed else 1)
    tp = LoopbackTP(n)
    got = vocab_parallel_fused_cross_entropy(tp, tp.copy(hidden), pieces, labels, **kw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    dx, *dw = torch.autograd.grad(got, [hidden] + pieces)
    torch.testing.assert_close(dx, want_grads[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat(dw, 0 if transposed else 1), want_grads[1],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_conjugate_ops_give_the_whole_mlp_and_its_gradients(n):
    """copy, column-parallel gate and up, row-parallel down, reduce: the
    whole MLP's output and the gradients of its input and weights."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((3, 5, 8), generator=g, requires_grad=True)
    wg, wu = (torch.randn((8, 12), generator=g, requires_grad=True) for _ in range(2))
    wd = torch.randn((12, 8), generator=g, requires_grad=True)
    want = (F.silu(x @ wg) * (x @ wu)) @ wd
    do = torch.randn(want.shape, generator=g)
    want_grads = torch.autograd.grad(want, (x, wg, wu, wd), do)
    tp = LoopbackTP(n)
    pg, pu, pd = _pieces(wg, n, 1), _pieces(wu, n, 1), _pieces(wd, n, 0)
    got = tp.reduce([(F.silu(xr @ a) * (xr @ b)) @ c
                     for xr, a, b, c in zip(tp.copy(x), pg, pu, pd)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    grads = torch.autograd.grad(got, [x] + pg + pu + pd, do)
    torch.testing.assert_close(grads[0], want_grads[0], rtol=1e-5, atol=1e-6)
    for k, (dim, want_g) in enumerate(zip((1, 1, 0), want_grads[1:])):
        torch.testing.assert_close(torch.cat(grads[1 + k * n:1 + (k + 1) * n], dim), want_g,
                                   rtol=1e-5, atol=1e-6)
    gathered = tp.gather([xr @ a for xr, a in zip(tp.copy(x), pg)], -1)
    torch.testing.assert_close(gathered, x @ wg, rtol=1e-6, atol=1e-6)


# ------------------------------------------------- the fused loss under tp
FUSED_LOSS_CFG = dict(vocab_size=100, hidden_size=64, intermediate_size=128,
                      num_attention_heads=2, num_key_value_heads=2, num_hidden_layers=2)
EIGHT = dict(tp_size=2, fsdp_size=2, dp_size=2)


def _fused_loss_losses(start, fused):
    acc = T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(**EIGHT),
                        loopback=T.LoopbackShards(8))
    model = T.Llama(T.LlamaConfig.tiny(**FUSED_LOSS_CFG, fused_loss=fused, fused_loss_chunk=32),
                    device="cpu")
    model.params = T.llama_params_from_numpy(start, model.config, device="cpu")
    pm, po = acc.prepare(model, T.sgd(0.05, device="cpu"))
    step = acc.build_train_step(pm, po)
    ids = np.random.default_rng(0).integers(0, 100, (8, 16)).astype(np.int32)
    return [float(step({"input_ids": ids, "labels": ids})) for _ in range(3)]


def test_fused_loss_trains_under_tp_fsdp_dp_as_jax():
    """``tests/test_fused_loss.py:195-225`` on the port: the fused and the
    dense loss agree at rtol 1e-5 over 3 ``sgd`` steps on tp 2 x fsdp 2 x
    dp 2, and equal JAX's dense run on that mesh."""
    import optax

    from accelerate_tpu import Accelerator as JAccelerator
    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
    from accelerate_tpu.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        jacc = JAccelerator(parallelism_config=JParallelismConfig(**EIGHT))
        jm = JLlama(JConfig.tiny(**FUSED_LOSS_CFG, fused_loss=False, fused_loss_chunk=32))
        jm.init_params(jax.random.key(0))
        start = jax.tree_util.tree_map(np.asarray, jm.params)
        pm, po = jacc.prepare(jm, optax.sgd(0.05))
        step = jacc.build_train_step(pm, po)
        ids = np.random.default_rng(0).integers(0, 100, (8, 16)).astype(np.int32)
        want = [float(step({"input_ids": ids, "labels": ids})) for _ in range(3)]
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    dense, fused = _fused_loss_losses(start, False), _fused_loss_losses(start, True)
    np.testing.assert_allclose(fused, dense, rtol=1e-5)
    np.testing.assert_allclose(dense, want, rtol=1e-5)


# --------------------------------------------------------- loopback layouts
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
           num_key_value_heads=2, num_hidden_layers=2)
LOOPBACKS = {
    "tp2": (dict(parallelism_config=T.ParallelismConfig(tp_size=2, dp_size=1)), 2, {}, False),
    "tp4": (dict(tp_plugin=T.TensorParallelPlugin(4)), 4, {}, False),
    "tp2xfsdp2": (dict(megatron_plugin=T.MegatronStylePlugin(tp_size=2, fsdp_size=2)), 4, {},
                  False),
    "dp2xtp2_zero": (dict(parallelism_config=T.ParallelismConfig(tp_size=2, dp_size=2)), 4, {},
                     True),
    "tp2_remat_tied": (dict(parallelism_config=T.ParallelismConfig(tp_size=2, dp_size=1)), 2,
                       dict(remat=True, tie_word_embeddings=True), False),
    "sp2xtp2_ulysses": (dict(parallelism_config=T.ParallelismConfig(tp_size=2, dp_size=1),
                             sp_plugin=T.SequenceParallelPlugin(2, ring_attention=False)), 4, {},
                        False),
    "sp4_ring": (dict(sp_plugin=T.SequenceParallelPlugin(4)), 4, {}, False),
}


def _train(kw, extra, zero=False):
    acc = T.Accelerator(device="cpu", **kw)
    acc.zero_sharding = zero
    model = T.Llama(T.LlamaConfig.tiny(**CFG, **extra), device="cpu")
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4, device="cpu"))
    step = acc.build_train_step(pm, po)
    rng = np.random.default_rng(3)
    losses = []
    for _ in range(3):
        ids = rng.integers(0, 128, (4, 16)).astype(np.int32)
        losses.append(float(step({"input_ids": ids, "labels": ids}, clip_norm=1.0)))
    engine = pm.handle.sharded
    params = ([p.detach().clone() for p in tree_leaves(pm.params)] if engine is None else
              [engine.full_leaf(i).clone() for i in range(len(engine.layouts))])
    return losses, params, po.zero_active


@pytest.mark.parametrize("name", sorted(LOOPBACKS))
def test_loopback_layouts_train_as_the_unsharded_step(name):
    kw, n, extra, zero = LOOPBACKS[name]
    want, ref, _ = _train({}, extra)
    got, params, zero_active = _train(dict(kw, loopback=T.LoopbackShards(n)), extra, zero)
    assert zero_active == zero
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for a, b in zip(params, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-5)


# ------------------------------------------------------------- entry points
@pytest.mark.parametrize("shape,n", [("dp:2,tp:2", 4), ("tp:4", 8), ("fsdp:0,tp:2", 8),
                                     ("dp:2,fsdp:2,tp:2", 8), ("sp:2,tp:2", 8),
                                     ("dp:0,sp:4", 8), ("tp:2,dcn:1", 8),
                                     ("dp:2,ep:2,tp:2", 8)])
def test_mesh_shape_env_resolves_as_jax(monkeypatch, shape, n):
    monkeypatch.setenv("ACCELERATE_MESH_SHAPE", shape)
    want = JParallelismConfig.from_env().resolved_sizes(n, dcn=1)
    got = T.ParallelismConfig.from_env().resolved_sizes(n)
    assert got == {a: want[a] for a in ("pp", "dp", "fsdp", "ep", "sp", "tp")}
    acc = T.Accelerator(device="cpu", loopback=T.LoopbackShards(n))
    assert acc.mesh_sizes == got


def test_plugins_build_the_mesh_and_unported_axes_raise(monkeypatch):
    acc = T.Accelerator(device="cpu", tp_plugin=T.TensorParallelPlugin(2),
                        loopback=T.LoopbackShards(4))
    assert acc.mesh_sizes == {"pp": 1, "dp": 2, "fsdp": 1, "ep": 1, "sp": 1, "tp": 2}
    acc = T.Accelerator(device="cpu", megatron_plugin=T.MegatronStylePlugin(
        tp_size=2, fsdp_size=2, sp_size=1), loopback=T.LoopbackShards(4))
    assert acc.mesh_sizes == {"pp": 1, "dp": 1, "fsdp": 2, "ep": 1, "sp": 1, "tp": 2}
    with pytest.raises(ValueError, match="tp_size"):
        T.TensorParallelPlugin(0)
    # pp is ported: the Megatron plugin's pp size reaches the mesh.
    acc = T.Accelerator(device="cpu", megatron_plugin=T.MegatronStylePlugin(pp_size=2),
                        loopback=T.LoopbackShards(4))
    assert acc.mesh_sizes == {"pp": 2, "dp": 2, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1}
    # ep is ported: the config and the env reach the mesh; ep with pp or sp raises.
    acc = T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(ep_size=2),
                        loopback=T.LoopbackShards(4))
    assert acc.mesh_sizes == {"pp": 1, "dp": 2, "fsdp": 1, "ep": 2, "sp": 1, "tp": 1}
    monkeypatch.setenv("ACCELERATE_MESH_SHAPE", "ep:2,dp:2")
    acc = T.Accelerator(device="cpu", loopback=T.LoopbackShards(4))
    assert acc.mesh_sizes == {"pp": 1, "dp": 2, "fsdp": 1, "ep": 2, "sp": 1, "tp": 1}
    monkeypatch.delenv("ACCELERATE_MESH_SHAPE")
    with pytest.raises(NotImplementedError, match="ep together with pp"):
        T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(ep_size=2, pp_size=2),
                      loopback=T.LoopbackShards(4))
    with pytest.raises(NotImplementedError, match="ep together with sp"):
        T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(ep_size=2, dp_size=1),
                      sp_plugin=T.SequenceParallelPlugin(2), loopback=T.LoopbackShards(4))
    monkeypatch.setenv("ACCELERATE_MESH_SHAPE", "dcn:2,tp:2")
    with pytest.raises(NotImplementedError, match="dcn"):
        T.Accelerator(device="cpu")
    monkeypatch.setenv("ACCELERATE_MESH_SHAPE", "xp:2")
    with pytest.raises(ValueError, match="Unknown mesh axis"):
        T.Accelerator(device="cpu")
    # One process with no loopback cannot make a tp 2 mesh.
    monkeypatch.delenv("ACCELERATE_MESH_SHAPE")
    with pytest.raises(ValueError, match="dp x sp mesh"):
        T.Accelerator(device="cpu", tp_plugin=T.TensorParallelPlugin(2))
