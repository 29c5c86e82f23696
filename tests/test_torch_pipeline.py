"""Pipeline parallelism in one process (``LoopbackShards``) against the JAX
package on the CPU.

The model is JAX's pipeline-test Llama (``tests/test_pp_training.py:19-36``:
vocab 128, hidden 64, intermediate 128, 4 layers, 2 heads, 2 KV heads;
sequence 16, f32), the port carrying the JAX model's initial weights
(``llama_params_from_numpy``). The JAX side runs on the conftest's 8 virtual
CPU devices, each reference once per module; the port's
``LoopbackShards(8)`` is the same mesh (pp 2 x dp 4 unless named), every
stage and data coordinate in one process. ``sgd``, the batch's ids as labels,
JAX's batches (8 rows for GPipe, 16 for 1F1B's 4 microbatches).

- GPipe (pp 2, 2 microbatches) and 1F1B (pp 2, 4 microbatches) against
  JAX's own pipelined runs on the same mesh: the loss and every parameter
  after one ``sgd(0.1)`` step (``PARAM_ATOL``), and every leaf's gradient of
  the batch (an accumulation-2 micro-step's buffer) against ``jax.grad``.
- pp 4 at 4 microbatches, remat, Gemma-2's mixed windows (both schedules),
  pp 2 x tp 2 (x dp 2), pp 2 x fsdp 2 (x dp 2): against JAX's unpipelined
  step, which JAX's own tests hold within 2e-4 of its pipelined runs
  (``PIPELINE_ATOL``); 1F1B with tp, fsdp and bf16 tracks JAX's GPipe run
  of that layout (rtol 3e-2, JAX's ``test_1f1b_composes_with_tp_fsdp_bf16``).
- The planners on pp meshes leaf by leaf, the indivisible-layers
  relaxation (pp dropped, tp kept, the pipeline off with JAX's warning), the
  microbatch layout, the mesh sizes and the entry points.
- Each error of the slice on its JAX message, the 1F1B liveness (at most
  2 x pp saved stage inputs a stage whatever the microbatches; GPipe keeps
  one graph a microbatch), and a checkpoint round trip between pp 2 and an
  unsharded run.
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import accelerate_tpu_torch as T
from accelerate_tpu_torch.models import llama_params_from_numpy
from accelerate_tpu_torch.parallel import pipeline as tpipe
from accelerate_tpu_torch.parallel import sharding as tsh
from accelerate_tpu_torch.utils.tree import flatten_with_paths

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=2,
           num_key_value_heads=2, num_hidden_layers=4)
GEMMA2 = dict(layer_windows=(4, None, 4, None), attn_logit_softcap=50.0,
              final_logit_softcap=30.0, query_pre_attn_scalar=32.0, sandwich_norms=True,
              hidden_act="gelu_tanh")
N_DEVICES = 8
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5       # the port against JAX's own run of the same schedule
PIPELINE_ATOL = 2e-4    # against JAX's unpipelined step (JAX's own pin, :322)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _cfg(cfg_kw=None):
    return {**CFG, **(cfg_kw or {})}


def _key(cfg_kw):
    return tuple(sorted((cfg_kw or {}).items()))


@functools.lru_cache(maxsize=None)
def _start(key):
    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig

    jm = JLlama(JConfig.tiny(**_cfg(dict(key))))
    jm.init_params(jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, jm.params)


def _ids(batch):
    return np.random.default_rng(0).integers(0, 128, (batch, 16)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(mesh_key, plugin_key=None, steps=1, lr=0.1, cfg_key=(), batch=8, mp="no"):
    """JAX's ``_run_training`` (``tests/test_pp_training.py:39-51``): the
    losses and the final parameters under dotted keys."""
    import optax

    from accelerate_tpu import Accelerator as JAccelerator, ParallelismConfig as JPC
    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
    from accelerate_tpu.parallel.sharding import path_str
    from accelerate_tpu.state import AcceleratorState, GradientState
    from accelerate_tpu.utils.dataclasses import PipelineParallelPlugin as JPlugin

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        acc = JAccelerator(mixed_precision=mp, parallelism_config=JPC(**dict(mesh_key)),
                           pp_plugin=JPlugin(**dict(plugin_key)) if plugin_key else None)
        jm = JLlama(JConfig.tiny(**_cfg(dict(cfg_key))))
        jm.init_params(jax.random.key(0))
        pm, po = acc.prepare(jm, optax.sgd(lr))
        step = acc.build_train_step(pm, po)
        ids = _ids(batch)
        losses = [float(step({"input_ids": ids, "labels": ids})) for _ in range(steps)]
        flat = jax.tree_util.tree_flatten_with_path(acc.get_state_dict(pm))[0]
        params = {path_str(p).replace("/", "."): np.asarray(v) for p, v in flat}
        spec = pm.handle.pipeline_spec
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    return np.asarray(losses), params, None if spec is None else spec.schedule


def _jax_grads(cfg_key, batch):
    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
    from accelerate_tpu.parallel.sharding import path_str

    jm = JLlama(JConfig.tiny(**_cfg(dict(cfg_key))))
    ids = _ids(batch)
    grads = jax.jit(jax.grad(lambda p: jm.apply(p, input_ids=ids, labels=ids)["loss"]))(
        _start(cfg_key))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return {path_str(p).replace("/", "."): np.asarray(v) for p, v in flat}


def _port_accelerator(mesh, plugin=None, n=N_DEVICES, **kw):
    return T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(**mesh),
                         pp_plugin=plugin, loopback=T.LoopbackShards(n) if n > 1 else None,
                         **kw)


def _port_model(cfg_kw=None):
    model = T.Llama(T.LlamaConfig.tiny(**_cfg(cfg_kw)), device="cpu")
    model.params = llama_params_from_numpy(_start(_key(cfg_kw)), model.config, device="cpu")
    return model


def _port_run(mesh, plugin=None, n=N_DEVICES, steps=1, lr=0.1, cfg_kw=None, batch=8,
              mp=None, accum=1):
    acc = _port_accelerator(mesh, plugin, n, mixed_precision=mp,
                            gradient_accumulation_steps=accum)
    pm, po = acc.prepare(_port_model(cfg_kw), T.sgd(lr, device="cpu"))
    step = acc.build_train_step(pm, po)
    ids = _ids(batch)
    losses = [float(step({"input_ids": ids, "labels": ids})) for _ in range(steps)]
    params = {k: v.numpy() for k, v in flatten_with_paths(acc.get_state_dict(pm))}
    return np.asarray(losses), params, pm, po


def _assert_params(got, want, atol):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol, err_msg=key)


def _plugin(pp, mb=0, schedule="gpipe"):
    return T.PipelineParallelPlugin(pp_size=pp, num_microbatches=mb, schedule=schedule)


# ------------------------------------------------- against JAX's pipelines
@pytest.mark.parametrize("schedule,batch,mb", [("gpipe", 8, 0), ("1f1b", 16, 4)])
def test_pipeline_matches_jax_pipeline(schedule, batch, mb):
    want_losses, want, want_schedule = _jax_run(
        (("pp_size", 2),), (("pp_size", 2), ("num_microbatches", mb), ("schedule", schedule)),
        batch=batch)
    assert want_schedule == schedule
    losses, params, pm, _ = _port_run(dict(pp_size=2), _plugin(2, mb, schedule), batch=batch)
    spec = pm.handle.pipeline_spec
    assert spec.schedule == schedule and spec.num_microbatches == (mb or 2)
    assert pm.handle.sharded.sizes == {"pp": 2, "dp": 4, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1}
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(params, want, PARAM_ATOL)


@pytest.mark.parametrize("schedule,batch,mb", [("gpipe", 8, 0), ("1f1b", 16, 4)])
def test_pipeline_gradients_match_jax_leaf_by_leaf(schedule, batch, mb):
    _, _, pm, po = _port_run(dict(pp_size=2), _plugin(2, mb, schedule), batch=batch, accum=2)
    engine = pm.handle.sharded
    want = _jax_grads((), batch)
    got = {layout.path.replace("/", "."): 2 * engine.full_leaf(i, shards=engine.accum[i]).numpy()
           for i, layout in enumerate(engine.layouts)}
    assert sorted(got) == sorted(want) and len(got) == 12
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=key)


# ------------------------------------------- against JAX's unpipelined step
CASES = {
    "pp4_m4": (dict(pp_size=4), _plugin(4, 4), None, 8),
    "pp4_m4_1f1b": (dict(pp_size=4), _plugin(4, 4, "1f1b"), None, 16),
    "pp2_remat": (dict(pp_size=2), None, dict(remat=True), 8),
    "pp2_gemma2": (dict(pp_size=2), None, GEMMA2, 8),
    "pp2_gemma2_1f1b": (dict(pp_size=2), _plugin(2, 4, "1f1b"), GEMMA2, 16),
    "pp2xtp2": (dict(pp_size=2, tp_size=2), None, None, 8),
    "pp2xtp2_1f1b": (dict(pp_size=2, tp_size=2), _plugin(2, 2, "1f1b"), None, 8),
    "pp2xfsdp2": (dict(pp_size=2, fsdp_size=2), None, None, 8),
    "pp2xfsdp2_1f1b_remat": (dict(pp_size=2, fsdp_size=2), _plugin(2, 2, "1f1b"),
                             dict(remat=True), 8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_layouts_match_jax_unpipelined(name):
    mesh, plugin, cfg_kw, batch = CASES[name]
    want_losses, want, _ = _jax_run((), cfg_key=_key(cfg_kw), batch=batch)
    losses, params, pm, _ = _port_run(mesh, plugin, cfg_kw=cfg_kw, batch=batch)
    assert pm.handle.pipeline_spec is not None
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(params, want, PIPELINE_ATOL)


def test_pipeline_with_remat_matches_plain_over_steps():
    """JAX ``test_pipeline_with_remat_matches``: two steps, remat or not."""
    plain, _, _, _ = _port_run(dict(pp_size=2), steps=2, lr=0.01)
    remat, _, _, _ = _port_run(dict(pp_size=2), steps=2, lr=0.01, cfg_kw=dict(remat=True))
    np.testing.assert_allclose(plain, remat, rtol=1e-5)
    want, _, _ = _jax_run((("pp_size", 2),), steps=2, lr=0.01)
    np.testing.assert_allclose(plain, want, rtol=LOSS_RTOL)


def test_1f1b_composes_with_tp_fsdp_bf16():
    """JAX ``test_1f1b_composes_with_tp_fsdp_bf16``: 1F1B over pp 2 x fsdp 2
    x tp 2 in bf16 tracks JAX's GPipe run of that layout."""
    mesh = dict(pp_size=2, fsdp_size=2, tp_size=2)
    got, _, _, _ = _port_run(mesh, _plugin(2, 4, "1f1b"), steps=2, lr=0.05, batch=16,
                             mp="bf16")
    want, _, _ = _jax_run(tuple(sorted(mesh.items())), (("num_microbatches", 4),
                                                        ("pp_size", 2), ("schedule", "gpipe")),
                          steps=2, lr=0.05, batch=16, mp="bf16")
    np.testing.assert_allclose(got, want, rtol=3e-2)


# ------------------------------------------------------------- the planner
MESHES = {"pp2": dict(pp_size=2), "pp4": dict(pp_size=4), "pp2xtp2": dict(pp_size=2, tp_size=2),
          "pp2xfsdp2": dict(pp_size=2, fsdp_size=2),
          "pp2xfsdp2xtp2": dict(pp_size=2, fsdp_size=2, tp_size=2)}


@pytest.mark.parametrize("layers", [4, 3])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_pp_param_plan_matches_jax_leaf_by_leaf(mesh_name, layers):
    from jax.sharding import PartitionSpec as P

    from accelerate_tpu.parallel import sharding as jsh
    from accelerate_tpu.parallel.mesh import ParallelismConfig as JPC

    model = T.Llama(T.LlamaConfig.tiny(**_cfg(dict(num_hidden_layers=layers))), device="cpu")
    model.device = torch.device("meta")
    port = model.init()
    jtree = jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                                   port)
    mesh = JPC(**MESHES[mesh_name]).build_mesh()
    rules = model.sharding_rules()
    want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        jsh.plan_param_shardings(jtree, mesh, rules=[(p, P(*s)) for p, s in rules]),
        is_leaf=lambda s: hasattr(s, "spec"))]
    sizes = {k: int(v) for k, v in mesh.shape.items()}
    got = [s for _, s in tsh._walk(tsh.plan_param_shardings(port, sizes, rules=rules))]
    assert got == want


def test_pp_indivisible_layers_relaxes_keeping_tp(caplog):
    """JAX ``test_pp_indivisible_layers_relaxes_keeping_tp``: 3 layers on pp 2
    drop only pp from the layer rules, keep tp, and run unpipelined (with
    JAX's warning) on every pp rank: the unsharded step's numbers."""
    cfg_kw = dict(num_hidden_layers=3)
    with caplog.at_level(logging.WARNING):
        losses, params, pm, _ = _port_run(dict(pp_size=2, tp_size=2), cfg_kw=cfg_kw)
    assert pm.handle.pipeline_spec is None
    assert "do not split evenly" in caplog.text
    engine = pm.handle.sharded
    wq = next(lay for lay in engine.layouts if lay.path == "layers/attn/wq")
    assert wq.pp_dim is None and "tp" in wq.splits
    assert np.isfinite(losses).all()
    want_losses, want, _ = _jax_run((), cfg_key=_key(cfg_kw))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(params, want, PIPELINE_ATOL)


def test_microbatch_roundtrip_matches_jax():
    from accelerate_tpu.parallel.mesh import ParallelismConfig as JPC
    from accelerate_tpu.parallel.pipeline import microbatch as jmicrobatch

    mesh = JPC(dp_size=2, fsdp_size=2, pp_size=2).build_mesh()
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    with mesh:
        want = np.asarray(jmicrobatch(jnp.asarray(x), mesh, 2))
    xs = tpipe.microbatch(torch.as_tensor(x), 2, data_degree=4)
    assert tuple(xs.shape) == (2, 8, 3)
    np.testing.assert_array_equal(xs.numpy(), want)
    np.testing.assert_array_equal(tpipe.unmicrobatch(xs, data_degree=4).numpy(), x)
    # A data coordinate's rows, split alone, are its part of each microbatch.
    shard = torch.as_tensor(x[4:8])
    np.testing.assert_array_equal(tpipe.microbatch(shard, 2).numpy(), want[:, 2:4])


@pytest.mark.parametrize("kw", [dict(pp_size=2), dict(pp_size=4), dict(pp_size=2, tp_size=2),
                                dict(pp_size=2, fsdp_size=-1), dict(pp_size=2, dp_size=2,
                                                                    tp_size=2)],
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_mesh_sizes_with_pp_resolve_as_jax(kw):
    from accelerate_tpu.parallel.mesh import ParallelismConfig as JPC

    want = JPC(**kw).resolved_sizes(8, dcn=1)
    got = T.ParallelismConfig(**kw).resolved_sizes(8)
    assert got == {a: want[a] for a in ("pp", "dp", "fsdp", "ep", "sp", "tp")}
    from accelerate_tpu_torch.parallel.fsdp import rank_coordinate

    # pp is the outermost axis: stage s holds ranks s * 8 / pp ...
    assert [rank_coordinate(r, got)["pp"] for r in range(8)] == [r * got["pp"] // 8
                                                                 for r in range(8)]


# ------------------------------------------------------------ entry points
def test_pp_entry_points_build_the_pipeline(monkeypatch):
    acc = T.Accelerator(device="cpu", megatron_plugin=T.MegatronStylePlugin(pp_size=2, tp_size=2),
                        loopback=T.LoopbackShards(4))
    assert acc.mesh_sizes == {"pp": 2, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 2}
    assert T.ParallelismConfig(pp_size=2).pp_size == 2
    monkeypatch.setenv("ACCELERATE_MESH_SHAPE", "pp:2,dp:2")
    monkeypatch.setenv("ACCELERATE_PP_SCHEDULE", "1f1b")
    monkeypatch.setenv("ACCELERATE_PP_MICROBATCHES", "4")
    acc = T.Accelerator(device="cpu", loopback=T.LoopbackShards(4))
    assert acc.pp_plugin.schedule == "1f1b" and acc.mesh_sizes["pp"] == 2
    pm, _ = acc.prepare(_port_model(), T.sgd(0.1, device="cpu"))
    spec = pm.handle.pipeline_spec
    assert (spec.stages, spec.num_microbatches, spec.schedule) == (2, 4, "1f1b")
    assert isinstance(spec.transport, tpipe.LoopbackStages)
    monkeypatch.setenv("ACCELERATE_PP_MICROBATCHES", "four")
    with pytest.raises(ValueError, match="ACCELERATE_PP_MICROBATCHES"):
        T.Accelerator(device="cpu", loopback=T.LoopbackShards(4)).prepare(
            _port_model(), T.sgd(0.1, device="cpu"))
    with pytest.raises(NotImplementedError, match="ep together with pp"):
        T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(ep_size=2, pp_size=2),
                      loopback=T.LoopbackShards(4))


def test_direct_apply_with_a_pipeline_spec_equals_the_plain_forward():
    """``Llama.apply(pipeline=spec)`` on an unsharded tree (every stage in
    this process): the plain forward's loss, and ``torch.autograd.grad``
    reaches every leaf."""
    from accelerate_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    model = _port_model()
    ids = torch.as_tensor(_ids(8))

    def loss_and_grads(spec):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(model.params)]
        out = model.apply(tree_unflatten(model.params, leaves), input_ids=ids, labels=ids,
                          pipeline=spec)
        return out["loss"], torch.autograd.grad(out["loss"], leaves)

    want, want_g = loss_and_grads(None)
    spec = tpipe.PipelineSpec(stages=4, num_microbatches=2)
    got, got_g = loss_and_grads(spec)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert spec.transport.messages == 2 * 3 * 2  # 2 microbatches x 3 boundaries, both ways


# ----------------------------------------------------------------- errors
def test_unknown_schedule_and_non_pipelined_model_errors(caplog):
    with pytest.raises(ValueError, match="Unknown pipeline schedule"):
        _port_accelerator(dict(pp_size=1), _plugin(1, 0, "interleaved"), n=1).prepare(
            _port_model(), T.sgd(0.1, device="cpu"))
    bert = T.BertForSequenceClassification(T.BertConfig.tiny(), device="cpu")
    bert.init_params(0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_accelerator(dict(pp_size=2), n=2).prepare(bert)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bert.apply(bert.params, input_ids=torch.zeros((1, 4), dtype=torch.int32),
                   pipeline=object())


def test_pipeline_batch_divisibility_error():
    acc = _port_accelerator(dict(pp_size=2), _plugin(2, 3))
    pm, po = acc.prepare(_port_model(), T.sgd(0.1, device="cpu"))
    step = acc.build_train_step(pm, po)
    ids = _ids(8)  # 8 % (4 * 3) != 0
    with pytest.raises(ValueError, match="num_microbatches"):
        step({"input_ids": ids, "labels": ids})


def test_1f1b_rejects_custom_loss_and_missing_labels():
    acc = _port_accelerator(dict(pp_size=2), _plugin(2, 4, "1f1b"))
    pm, po = acc.prepare(_port_model(), T.sgd(0.05, device="cpu"))
    with pytest.raises(ValueError, match="1f1b"):
        acc.build_train_step(pm, po, loss_fn=lambda outputs, batch: outputs["loss"])
    with pytest.raises(ValueError, match="1f1b"):
        pm.training_loss_fn()
    step = acc.build_train_step(pm, po)
    with pytest.raises(ValueError, match="labels"):
        step({"input_ids": np.zeros((16, 16), np.int32)})


def test_imperative_loop_under_pp_raises_naming_roadmap():
    acc = _port_accelerator(dict(pp_size=2), n=2)
    pm, _ = acc.prepare(_port_model(), T.sgd(0.1, device="cpu"))
    ids = torch.as_tensor(_ids(8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pm(input_ids=ids, labels=ids)


# --------------------------------------------------------------- liveness
@pytest.mark.parametrize("mb", [4, 8])
def test_1f1b_liveness_is_bounded_by_the_stages(mb):
    """JAX ``test_1f1b_memory_below_gpipe``, counted: a 1F1B stage keeps at
    most 2 x pp stage inputs whatever the microbatches; GPipe keeps every
    microbatch's graph."""
    ids = np.zeros((16, 16), np.int32)
    peaks = {}
    for schedule in ("gpipe", "1f1b"):
        acc = _port_accelerator(dict(pp_size=4), _plugin(4, mb, schedule), n=4)
        pm, po = acc.prepare(_port_model(dict(remat=True)), T.sgd(0.05, device="cpu"))
        acc.build_train_step(pm, po)({"input_ids": ids, "labels": ids})
        peaks[schedule] = pm.handle.pipeline_spec.peak_saved
    assert peaks["gpipe"] == {s: mb for s in range(4)}
    assert all(1 <= n <= 2 * 4 for n in peaks["1f1b"].values())
    # Stage s keeps 2(P - 1 - s) + 1 inputs (stage 0 none: it embeds again).
    assert peaks["1f1b"] == {0: 1, 1: min(5, mb), 2: 3, 3: 1}


# ------------------------------------------------------------- checkpoints
def test_checkpoint_round_trips_between_pp2_and_unsharded(tmp_path):
    ids = _ids(8)
    batch = {"input_ids": ids, "labels": ids}
    acc = _port_accelerator(dict(pp_size=2), _plugin(2, 2, "1f1b"))
    pm, po = acc.prepare(_port_model(), T.adamw(3e-3, device="cpu"))
    step = acc.build_train_step(pm, po)
    step(batch)
    acc.save_state(str(tmp_path / "pp2"))
    full = {k: v.numpy() for k, v in flatten_with_paths(acc.get_state_dict(pm))}
    after = float(step(batch))

    plain = T.Accelerator(device="cpu")
    qm, qo = plain.prepare(_port_model(), T.adamw(3e-3, device="cpu"))
    plain.load_state(str(tmp_path / "pp2"), reshard=True)
    got = {k: v.numpy() for k, v in flatten_with_paths(plain.get_state_dict(qm))}
    assert sorted(got) == sorted(full)
    for key in full:
        assert np.array_equal(got[key], full[key]), key
    plain_step = plain.build_train_step(qm, qo)
    np.testing.assert_allclose(float(plain_step(batch)), after, rtol=1e-5)
    plain.save_state(str(tmp_path / "plain"))

    again = _port_accelerator(dict(pp_size=2), _plugin(2, 2, "1f1b"))
    rm, ro = again.prepare(_port_model(), T.adamw(3e-3, device="cpu"))
    again.load_state(str(tmp_path / "plain"), reshard=True)
    back = {k: v.numpy() for k, v in flatten_with_paths(again.get_state_dict(rm))}
    want = {k: v.numpy() for k, v in flatten_with_paths(plain.get_state_dict(qm))}
    for key in want:
        assert np.array_equal(back[key], want[key]), key


def test_pipeline_training_example_runs_both_schedules():
    """``python -m accelerate_tpu_torch.examples.pipeline_training --cpu``:
    GPipe and 1F1B train the same numbers on the example's batches."""
    from accelerate_tpu_torch.examples import pipeline_training

    args = ["--cpu", "--num_steps", "2", "--layers", "2"]
    gpipe = pipeline_training.main(args + ["--schedule", "gpipe"])
    one_f_one_b = pipeline_training.main(args + ["--schedule", "1f1b"])
    assert np.isfinite(gpipe).all()
    np.testing.assert_allclose(one_f_one_b, gpipe, rtol=1e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_train_window_under_pp_is_the_steps(schedule):
    """``build_train_window`` routes through the same pipelined step: a
    window of 2 is bitwise 2 calls of ``build_train_step``."""
    ids = _ids(8)
    batch = {"input_ids": ids, "labels": ids}
    runs = []
    for window in (False, True):
        acc = _port_accelerator(dict(pp_size=2), _plugin(2, 2, schedule))
        pm, po = acc.prepare(_port_model(), T.adamw(3e-3, device="cpu"))
        if window:
            step = acc.build_train_window(pm, po, window=2)
            losses = step({k: np.stack([v, v]) for k, v in batch.items()}, clip_norm=1.0)
            losses = [float(x) for x in losses]
        else:
            step = acc.build_train_step(pm, po)
            losses = [float(step(batch, clip_norm=1.0)) for _ in range(2)]
        runs.append((losses, {k: v.numpy() for k, v in
                              flatten_with_paths(acc.get_state_dict(pm))}))
    assert runs[0][0] == runs[1][0]
    for key, value in runs[0][1].items():
        assert np.array_equal(runs[1][1][key], value), key
