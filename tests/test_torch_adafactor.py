"""``optim.adafactor`` against ``optax.adafactor`` (optax 0.2.6's chain).

- Four updates on a tree of a stacked factored leaf ``(4, 256, 384)`` (the
  two largest dims factored, its row and column means over one block of
  all 4 layers), a square factored leaf, a leaf with a dim under 128 (not
  factored) and a vector: with the defaults, with momentum and weight
  decay, without a learning rate, unfactored, and under
  ``inject_hyperparams``. The parameters after every update and the state
  (``v_row``, ``v_col``, ``v``, the momentum) agree to ``RTOL`` / ``ATOL``:
  the block RMS and the factored means are f32 sums whose order differs
  from XLA's. Where no reduction runs (unfactored, no clipping, no
  parameter scale) the update is elementwise and agrees to a few ulps
  (``ELEMENTWISE_RTOL``): it is not bitwise, as XLA's and torch's
  ``x ** -0.5`` differ in the last bit on about a quarter of the inputs.
- The fused step under pp 2 x fsdp 2 (x dp 2, ``LoopbackShards(8)``, 1F1B)
  with ``adafactor`` factored at dim 32 against JAX's fused step on the same
  mesh: every leaf is split over pp or fsdp, so statistics taken per slice
  would move the parameters by far more than ``PARAM_ATOL``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import accelerate_tpu_torch as T
from accelerate_tpu_torch import optim

SHAPES = {"stack": (4, 256, 384), "square": (160, 130), "narrow": (64, 200), "vec": (300,)}
RTOL, ATOL = 1e-5, 1e-5
ELEMENTWISE_RTOL, ELEMENTWISE_ATOL = 1e-6, 1e-8
STEPS = 4
PARAM_ATOL = 1e-5


def _draw(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


KWARGS = {
    "defaults": dict(learning_rate=1e-2),
    "momentum_decay": dict(learning_rate=1e-2, momentum=0.9, weight_decay_rate=1e-3),
    "no_lr": dict(learning_rate=None),
    "unfactored": dict(learning_rate=1e-2, factored=False),
}


def _run(kwargs, inject=False):
    if inject:  # optax reads a callable (its dtype) as a schedule unless static
        jtx = optax.inject_hyperparams(optax.adafactor, static_args=("dtype_momentum",))(
            **kwargs)
        ttx = optim.inject_hyperparams(optim.adafactor, static_args=("dtype_momentum",))(
            **kwargs, device="cpu")
    else:
        jtx, ttx = optax.adafactor(**kwargs), optim.adafactor(**kwargs, device="cpu")
    start = _draw(0)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    tp = {k: torch.as_tensor(v) for k, v in start.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    out = []
    for step in range(STEPS):
        g = _draw(step + 1)
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.as_tensor(v) for k, v in g.items()}, ts, tp)
        tp = optim.apply_updates(tp, tu)
        out.append(({k: np.asarray(v) for k, v in jp.items()},
                    {k: v.numpy() for k, v in tp.items()}))
    return out, js, ts


@pytest.mark.parametrize("name", sorted(KWARGS))
def test_adafactor_matches_optax(name):
    out, js, ts = _run(KWARGS[name])
    for want, got in out:
        for k in SHAPES:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    jf, tf = js[0], ts[0]  # FactoredState(count, v_row, v_col, v)
    assert int(tf.count) == int(jf.count) == STEPS
    for field in ("v_row", "v_col", "v"):
        for k in SHAPES:
            want = np.asarray(getattr(jf, field)[k])
            got = getattr(tf, field)[k].numpy()
            assert got.shape == want.shape, (field, k)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12, err_msg=f"{field} {k}")
    if KWARGS[name].get("momentum"):
        ema_j = next(s for s in js if hasattr(s, "ema"))
        ema_t = next(s for s in ts if hasattr(s, "ema"))
        for k in SHAPES:
            np.testing.assert_allclose(ema_t.ema[k].numpy(), np.asarray(ema_j.ema[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_adafactor_factors_as_optax():
    """Which leaves are factored, and over which dims: the stacked leaf's
    row statistics drop its largest dim, the column statistics the second
    largest; the narrow leaf and the vector keep a full ``v``."""
    ts = optim.adafactor(1e-2, device="cpu").init(
        {k: torch.zeros(s) for k, s in SHAPES.items()})[0]
    assert tuple(ts.v_row["stack"].shape) == (4, 256)
    assert tuple(ts.v_col["stack"].shape) == (4, 384)
    assert tuple(ts.v_row["square"].shape) == (130,) and tuple(ts.v_col["square"].shape) == (160,)
    assert tuple(ts.v["narrow"].shape) == (64, 200) and tuple(ts.v["vec"].shape) == (300,)
    assert tuple(ts.v["stack"].shape) == (1,)


def test_adafactor_without_reductions_agrees_to_ulps():
    kwargs = dict(learning_rate=1e-2, factored=False, clipping_threshold=None,
                  multiply_by_parameter_scale=False)
    out, _, _ = _run(kwargs)
    for want, got in out:
        for k in SHAPES:
            np.testing.assert_allclose(got[k], want[k], rtol=ELEMENTWISE_RTOL,
                                       atol=ELEMENTWISE_ATOL, err_msg=k)


def test_adafactor_under_inject_hyperparams():
    kwargs = dict(learning_rate=1e-2, momentum=0.9)
    out, js, ts = _run(kwargs, inject=True)
    for want, got in out:
        for k in SHAPES:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(ts.hyperparams["learning_rate"]) == pytest.approx(1e-2)
    assert optim.needs_global_stats(optim.inject_hyperparams(optim.adafactor)(
        learning_rate=1e-2, device="cpu"))
    assert not optim.needs_global_stats(T.adamw(1e-3, device="cpu"))


def test_adafactor_runs_the_reference_chain():
    from accelerate_tpu_torch.ops.fused_update import plan_fused_update

    assert plan_fused_update(optim.adafactor(1e-2, device="cpu")) is None


def test_adafactor_fused_step_on_pp_fsdp_shards_matches_jax():
    from test_torch_pipeline import _assert_params, _ids, _port_model

    from accelerate_tpu import Accelerator as JAccelerator, ParallelismConfig as JPC
    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
    from accelerate_tpu.parallel.sharding import path_str
    from accelerate_tpu.state import AcceleratorState, GradientState
    from accelerate_tpu.utils.dataclasses import PipelineParallelPlugin as JPlugin
    from accelerate_tpu_torch.utils.tree import flatten_with_paths
    from test_torch_pipeline import CFG

    kwargs = dict(learning_rate=1e-2, min_dim_size_to_factor=32)
    ids = _ids(16)
    batch = {"input_ids": ids, "labels": ids}
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        acc = JAccelerator(parallelism_config=JPC(pp_size=2, fsdp_size=2),
                           pp_plugin=JPlugin(pp_size=2, num_microbatches=4, schedule="1f1b"))
        jm = JLlama(JConfig.tiny(**CFG))
        jm.init_params(jax.random.key(0))
        pm, po = acc.prepare(jm, optax.adafactor(**kwargs))
        step = acc.build_train_step(pm, po)
        want_losses = [float(step(batch, clip_norm=1.0)) for _ in range(2)]
        flat = jax.tree_util.tree_flatten_with_path(acc.get_state_dict(pm))[0]
        want = {path_str(p).replace("/", "."): np.asarray(v) for p, v in flat}
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    tacc = T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(
        pp_size=2, fsdp_size=2), pp_plugin=T.PipelineParallelPlugin(2, 4, "1f1b"),
        loopback=T.LoopbackShards(8))
    tm, to = tacc.prepare(_port_model(), T.adafactor(**kwargs, device="cpu"))
    engine = tm.handle.sharded
    assert all(layout.splits for layout in engine.layouts if layout.path != "final_norm/weight")
    tstep = tacc.build_train_step(tm, to)
    losses = [float(tstep(batch, clip_norm=1.0)) for _ in range(2)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = {k: v.numpy() for k, v in flatten_with_paths(tacc.get_state_dict(tm))}
    _assert_params(got, want, PARAM_ATOL)
