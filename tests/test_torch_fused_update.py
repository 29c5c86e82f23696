"""Parity of the port's fused optimizer update with the JAX package's.

The same parameters, gradients, clip factor and optimizer state (advanced
two optax steps on the JAX side, then carried into the port with
``models/from_jax.optax_state_from_numpy``) go through:

- JAX ``reference_update_apply`` with the optax transform, run op by op
  (not jitted), and JAX ``fused_update_apply(..., interpret=True)`` (the
  Pallas kernel in interpret mode) under ``jit``, as the JAX package's own
  tests run it;
- the port's ``fused_update_apply`` (its plain per-leaf math on the CPU)
  and the port's ``reference_update_apply`` with its own ``optim`` chain.

Tolerances, with their reasons:

- **bitwise** between the port's fused pass, the port's reference chain and
  the JAX reference run op by op: every f32 operation rounds on its own,
  in the same order, and the bias correction ``1 - b**count`` rounds
  identically for the counts used here. It does not for every count: XLA's
  f32 ``pow`` and torch's differ now and then by up to 4 ulps (see
  ``test_bias_correction_against_xla``).
- ``rtol=1e-6, atol=1e-7`` against the jitted interpret-mode kernel: XLA
  fuses the elementwise chain and rounds some steps differently (up to 5
  ulps of a parameter seen here); this is the JAX package's own tolerance
  between its kernel and its reference (``tests/test_kernels.py``). The
  count and the zeroed buffer are exact.

The CUDA kernel itself is held bitwise against the plain version on the
card by the ``cuda``-marked tests of ``tests/test_torch_package.py`` (a file
without JAX, so they run there) and by ``chip_smoke.py`` at the Llama-3-8B
leaf sizes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import optax

from accelerate_tpu.ops.pallas.fused_update import (
    fused_update_apply as j_fused_update_apply,
    plan_fused_update as j_plan,
    reference_update_apply as j_reference_update_apply,
)
from accelerate_tpu_torch import optim
from accelerate_tpu_torch.models import optax_state_from_numpy
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.ops.fused_update import (
    fused_update_apply,
    leaf_update,
    plan_fused_update,
    reference_update_apply,
)
from accelerate_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

SEED = 3
FAMILIES = {
    "adamw": (lambda: optax.adamw(3e-4, weight_decay=0.01),
              lambda: optim.adamw(3e-4, weight_decay=0.01, device="cpu")),
    "adam": (lambda: optax.adam(0.1), lambda: optim.adam(0.1, device="cpu")),
    "sgd": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1, device="cpu")),
    "sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     lambda: optim.sgd(0.1, momentum=0.9, device="cpu")),
}


def _bits(x):
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want, what):
    got_t = [np.asarray(g.detach().numpy() if isinstance(g, torch.Tensor) else g) for g in got]
    want_t = [np.asarray(w) for w in want]
    assert len(got_t) == len(want_t), what
    for i, (g, w) in enumerate(zip(got_t, want_t)):
        assert g.shape == w.shape, f"{what}[{i}]: shape {g.shape} vs {w.shape}"
        assert np.array_equal(_bits(g), _bits(w)), (
            f"{what}[{i}]: max |diff| {np.max(np.abs(g.astype(np.float64) - w)) if g.size else 0}")


def _inputs(shapes):
    rng = np.random.default_rng(SEED)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    return params, grads


def _jax_state(jtx, params, grads):
    p = jtu.tree_map(jnp.asarray, params)
    g = jtu.tree_map(jnp.asarray, grads)
    state = jtx.init(p)
    for _ in range(2):  # advance so the count > 0 paths engage
        u, state = jax.jit(jtx.update)(g, state, p)
        p = optax.apply_updates(p, u)
    return p, g, state


def _moments(kind, state, index):
    if kind == "sgd":
        return []
    st = state[index]
    if kind == "sgd_momentum":
        return [st.trace]
    return [st.count, st.mu, st.nu]


SHAPES = {"a": (7, 13), "b": (3,), "c": (), "d": (2, 4, 16), "empty": (0,)}


def _assert_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        if g.dtype.kind == "i":
            assert np.array_equal(g, w), f"{what}[{i}]"
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fused_update_matches_jax(family):
    jtx, ttx = FAMILIES[family][0](), FAMILIES[family][1]()
    plan, jplan = plan_fused_update(ttx), j_plan(jtx)
    assert plan.kind == jplan.kind and plan.describe() == jplan.describe()
    assert plan.f32_constants()["step_size"] == float(np.float32(jplan.step_size))
    params_np, grads_np = _inputs(SHAPES)
    jp, jg, jstate = _jax_state(jtx, params_np, grads_np)
    factor = 0.7

    j_ref = j_reference_update_apply(jp, jstate, jg, tx=jtx, clip_factor=jnp.float32(factor))
    j_kernel = jax.jit(lambda p, s, g: j_fused_update_apply(
        p, s, g, plan=jplan, clip_factor=jnp.float32(factor), interpret=True))(jp, jstate, jg)

    def port_side():
        params = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
        grads = {k: torch.tensor(np.asarray(v)) for k, v in jg.items()}
        state = optax_state_from_numpy(ttx, jtu.tree_map(np.asarray, jstate), params,
                                       device="cpu")
        return params, grads, state

    # The port's fused pass: in place on params, moments and the buffer.
    params, grads, state = port_side()
    new_state = fused_update_apply(params, state, grads, plan=plan,
                                   clip_factor=torch.tensor(factor, dtype=torch.float32))
    # The port's reference chain: new trees.
    rp, rg, rstate = port_side()
    ref_p, ref_state, ref_zero = reference_update_apply(
        rp, rstate, rg, tx=ttx, clip_factor=torch.tensor(factor, dtype=torch.float32))

    _assert_bitwise(tree_leaves(params), jtu.tree_leaves(j_ref[0]), "params vs jax reference")
    _assert_bitwise(tree_leaves(ref_p), jtu.tree_leaves(j_ref[0]), "ref params vs jax reference")
    _assert_close(tree_leaves(params), jtu.tree_leaves(j_kernel[0]), "params vs jax interpret")
    for got_m, ref_m, want_m, kern_m in zip(
            _moments(plan.kind, new_state, plan.state_index),
            _moments(plan.kind, ref_state, plan.state_index),
            _moments(plan.kind, j_ref[1], jplan.state_index),
            _moments(plan.kind, j_kernel[1], jplan.state_index)):
        _assert_bitwise(tree_leaves(got_m), jtu.tree_leaves(want_m), "state vs jax reference")
        _assert_bitwise(tree_leaves(ref_m), jtu.tree_leaves(want_m), "ref state vs jax reference")
        _assert_close(tree_leaves(got_m), jtu.tree_leaves(kern_m), "state vs jax interpret")
    assert all(bool((g == 0).all()) for g in tree_leaves(grads))
    assert all(bool((g == 0).all()) for g in tree_leaves(ref_zero))
    assert all((np.asarray(z) == 0).all() for z in jtu.tree_leaves(j_kernel[2]))
    assert params["empty"].shape == (0,) and params["c"].shape == ()


def test_bias_correction_against_xla():
    """``1 - b**count`` in f32: torch's pow and XLA's round alike for the
    first five updates and then differ now and then by a few ulps (first at
    count 6 for b=0.95, 31 for 0.9, 168 for 0.999; at most 4 ulps over the
    first 5000 counts). So a long run agrees with the JAX package to ulps,
    not bits."""
    counts = np.arange(1, 5000, dtype=np.int32)
    for b in (0.9, 0.95, 0.99, 0.999):
        want = _bits(np.asarray(jax.jit(lambda c: 1 - b ** c)(jnp.asarray(counts))))
        got, _ = optim.ScaleByAdam(b, b).bias_corrections(torch.tensor(counts))
        ulps = np.abs(_bits(got.numpy()).astype(np.int64) - want)
        assert (ulps[:5] == 0).all(), b
        assert ulps.max() <= 4, b


def test_plan_reads_the_port_transforms_and_refuses_other_chains():
    plan = plan_fused_update(optim.adamw(3e-4, weight_decay=0.01, device="cpu"))
    assert plan.kind == "adam" and plan.describe() == "adamw" and plan.state_index == 0
    assert (plan.b1, plan.b2, plan.eps, plan.weight_decay, plan.step_size) == (
        0.9, 0.999, 1e-8, 0.01, -3e-4)
    assert plan_fused_update(optim.adamw(1e-3, device="cpu")).weight_decay == 1e-4
    assert plan_fused_update(optim.adam(0.1, device="cpu")).describe() == "adam"
    assert plan_fused_update(optim.sgd(0.1, device="cpu")).kind == "sgd"
    sgdm = plan_fused_update(optim.sgd(0.1, momentum=0.9, device="cpu"))
    assert sgdm.kind == "sgd_momentum" and sgdm.momentum == 0.9 and sgdm.state_index == 0
    refused = [
        # weight decay after the learning-rate scale
        optim.chain(optim.ScaleByAdam(), optim.Scale(-1e-3), optim.AddDecayedWeights(1e-4),
                    device="cpu"),
        # two learning-rate scales
        optim.chain(optim.ScaleByAdam(), optim.Scale(-1e-3), optim.Scale(0.5), device="cpu"),
        # no learning-rate scale at all
        optim.chain(optim.ScaleByAdam(), device="cpu"),
        # momentum on top of adam
        optim.chain(optim.ScaleByAdam(), optim.Trace(0.9), optim.Scale(-1e-3), device="cpu"),
        # a transform the plan does not know
        optim.chain(optim.Identity(), optim.Scale(-1e-3), object(), device="cpu"),
        object(),
        # a learning-rate schedule, and inject_hyperparams (as the JAX package refuses them)
        optim.adamw(lambda count: 1e-3, device="cpu"),
        optim.inject_hyperparams(optim.adamw)(learning_rate=1e-3, device="cpu"),
    ]
    for tx in refused:
        assert plan_fused_update(tx) is None, tx


def test_unsupported_chain_runs_the_reference_in_the_train_step():
    """A chain without a plan still trains: the step runs the reference
    chain (as the JAX package does) and launches no fused update."""
    import accelerate_tpu_torch as T

    model = T.Llama(T.LlamaConfig.tiny(), device="cpu")
    model.init_params(0)
    acc = T.Accelerator(device="cpu")
    tx = optim.chain(optim.ScaleByAdam(), optim.Scale(-1e-3), optim.Scale(0.5), device="cpu")
    pm, po = acc.prepare(model, tx)
    assert po.plan is None
    step = acc.build_train_step(pm, po)
    before = [p.clone() for p in tree_leaves(pm.params)]
    ids = np.random.default_rng(SEED).integers(0, 256, (2, 8)).astype(np.int32)
    registry.reset_launch_counts()
    loss = step({"input_ids": ids, "labels": ids}, clip_norm=1.0)
    assert torch.isfinite(loss) and registry.launch_counts == {}
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(pm.params)))
    assert int(po.opt_state[0].count) == 1


def test_zero_size_and_scalar_leaves_in_the_plain_version():
    plan = plan_fused_update(optim.adam(0.1, device="cpu"))
    p, g = torch.zeros((0,)), torch.zeros((0,))
    mu, nu = torch.zeros((0,)), torch.zeros((0,))
    one = torch.ones(())
    leaf_update(p, g, (mu, nu), one, one, one, plan=plan)
    assert p.shape == (0,)
    p, g = torch.tensor(2.0), torch.tensor(1.0)
    mu, nu = torch.tensor(0.0), torch.tensor(0.0)
    bc = torch.tensor(0.1)
    leaf_update(p, g, (mu, nu), one, bc, torch.tensor(0.001), plan=plan)
    assert float(g) == 0.0 and float(mu) == np.float32(0.1) and p.shape == ()
