"""The port's learning-rate schedules and ``inject_hyperparams`` against optax.

- Schedule values for steps 0..N+2, from a Python int (the scheduler's host
  read) and from an int32 count tensor (inside ``scale_by_schedule``):
  ``constant``, ``linear`` and ``polynomial`` bitwise (the same f32 ops in
  the same order); ``cosine_decay`` (exponent 1, the default) within
  ``init_value * 2**-23``: the port takes the cosine in f64 and rounds it
  once, XLA evaluates its own f32 cosine, and the two differ by one ulp
  (at most 2**-24 below 1) on some arguments; through
  ``0.5 * (1 + cos)`` and its roundings that is at most ``2**-23`` of
  ``init_value``. Counted in ulps of the value it would be unbounded near
  the end of the decay, where ``1 + cos`` is small.
- ``inject_hyperparams(adamw)`` updates against optax's over several steps,
  with a learning rate written into the state between steps: within 1e-6
  relative (optax runs eagerly op by op here too; the bias correction's
  ``b**count`` is torch's f32 pow against XLA's, which may differ in the
  last bits after the first counts, ``tests/test_torch_fused_update.py``).
- ``adamw(schedule)`` (``scale_by_schedule`` with its own count) against
  optax the same way.
- ``plan_fused_update`` picks the kernel or the reference chain exactly
  where the JAX package's does, for the same constructions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from accelerate_tpu.ops.pallas.fused_update import plan_fused_update as j_plan

from accelerate_tpu_torch import optim
from accelerate_tpu_torch.ops.fused_update import plan_fused_update
from accelerate_tpu_torch.utils.tree import tree_leaves

UPDATE_RTOL = 1e-6

SCHEDULES = {
    "constant": (lambda m: m.constant_schedule(3e-4), 10),
    "linear": (lambda m: m.linear_schedule(2e-5, 2e-6, 229), 229),
    "linear-begin": (lambda m: m.linear_schedule(1e-3, 0.0, 50, transition_begin=7), 57),
    "polynomial-2": (lambda m: m.polynomial_schedule(1e-3, 1e-5, 2, 100, 5), 105),
    "polynomial-1-up": (lambda m: m.polynomial_schedule(1e-5, 1e-3, 1, 64), 64),
    "polynomial-off": (lambda m: m.polynomial_schedule(1e-3, 1e-5, 2, 0), 4),
    "cosine": (lambda m: m.cosine_decay_schedule(1e-3, 100, 0.1), 100),
    "cosine-long": (lambda m: m.cosine_decay_schedule(2e-5, 2290), 2290),
}
COSINE_INIT = {"cosine": 1e-3, "cosine-long": 2e-5}


def _bits(x) -> int:
    return int(np.asarray(np.float32(x)).view(np.int32))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_values_match_optax(name):
    make, n = SCHEDULES[name]
    want_fn, got_fn = make(optax), make(optim)
    for step in range(n + 3):
        for want, got in ((want_fn(step), got_fn(step)),
                          (want_fn(jnp.int32(step)),
                           got_fn(torch.tensor(step, dtype=torch.int32)))):
            if name in COSINE_INIT:
                diff = abs(float(np.float32(want)) - float(np.float32(float(got))))
                assert diff <= COSINE_INIT[name] * 2**-23, (step, want, got)
            else:
                assert _bits(want) == _bits(float(got)), (step, want, got)


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"a": (4, 8), "b": (8,), "c": (3, 2, 5)}


def _run_both(jtx, ttx, steps=4, lr_writes=None):
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for i in range(steps):
        grads = _tree(rng, SHAPES)
        if lr_writes is not None:
            jstate.hyperparams["learning_rate"] = jnp.asarray(lr_writes[i], jnp.float32)
            tstate.hyperparams["learning_rate"].fill_(lr_writes[i])
        ju, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        tu, tstate = ttx.update({k: torch.tensor(v) for k, v in grads.items()}, tstate, tp)
        jp, tp = optax.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=UPDATE_RTOL,
                                       atol=0)
    return jstate, tstate


def test_inject_hyperparams_adamw_matches_optax():
    jtx = optax.inject_hyperparams(optax.adamw)(learning_rate=1e-2)
    ttx = optim.inject_hyperparams(optim.adamw)(learning_rate=1e-2, device="cpu")
    writes = [1e-2, 7e-3, 3e-3, 1e-3]
    jstate, tstate = _run_both(jtx, ttx, lr_writes=writes)
    assert set(tstate.hyperparams) == set(jstate.hyperparams) == {
        "learning_rate", "b1", "b2", "eps", "eps_root", "weight_decay"}
    for k, v in jstate.hyperparams.items():
        got = tstate.hyperparams[k]
        assert got.dtype == torch.float32 and got.dim() == 0
        assert _bits(float(got)) == _bits(np.asarray(v))
    assert int(tstate.count) == int(jstate.count) == 4
    assert int(tstate.inner_state[0].count) == 4


def test_inject_hyperparams_with_a_scheduled_learning_rate_matches_optax():
    jtx = optax.inject_hyperparams(optax.adamw)(
        learning_rate=optax.linear_schedule(1e-2, 1e-3, 3))
    ttx = optim.inject_hyperparams(optim.adamw)(
        learning_rate=optim.linear_schedule(1e-2, 1e-3, 3), device="cpu")
    jstate, tstate = _run_both(jtx, ttx)
    assert _bits(float(tstate.hyperparams["learning_rate"])) == _bits(
        np.asarray(jstate.hyperparams["learning_rate"]))


@pytest.mark.parametrize("family", ["adamw", "adam", "sgd"])
def test_schedule_inside_the_chain_matches_optax(family):
    jsched, tsched = optax.cosine_decay_schedule(1e-2, 5), optim.cosine_decay_schedule(1e-2, 5)
    jtx = getattr(optax, family)(jsched)
    ttx = getattr(optim, family)(tsched, device="cpu")
    jstate, tstate = _run_both(jtx, ttx, steps=6)
    assert int(tstate[-1].count) == int(jstate[-1].count) == 6


CONSTRUCTIONS = {
    "adamw": lambda m, kw: m.adamw(1e-3, **kw),
    "adam": lambda m, kw: m.adam(1e-3, **kw),
    "sgd": lambda m, kw: m.sgd(1e-1, **kw),
    "sgd-momentum": lambda m, kw: m.sgd(1e-1, momentum=0.9, **kw),
    "adamw-wd": lambda m, kw: m.adamw(3e-4, weight_decay=0.01, **kw),
    "adamw-linear-schedule": lambda m, kw: m.adamw(m.linear_schedule(2e-5, 2e-6, 100), **kw),
    "sgd-constant-schedule": lambda m, kw: m.sgd(m.constant_schedule(0.1), **kw),
    "inject-adamw": lambda m, kw: m.inject_hyperparams(m.adamw)(learning_rate=2e-5, **kw),
    "inject-sgd": lambda m, kw: m.inject_hyperparams(m.sgd)(learning_rate=0.1, **kw),
}


@pytest.mark.parametrize("name", list(CONSTRUCTIONS))
def test_plan_chooses_kernel_or_reference_as_jax_does(name):
    make = CONSTRUCTIONS[name]
    want, got = j_plan(make(optax, {})), plan_fused_update(make(optim, {"device": "cpu"}))
    assert (want is None) == (got is None)
    if want is not None:
        assert (got.kind, got.describe(), got.state_index) == (
            want.kind, want.describe(), want.state_index)
        for field in ("b1", "b2", "eps", "eps_root", "weight_decay", "momentum", "step_size"):
            assert getattr(got, field) == getattr(want, field), field


def test_schedule_state_is_a_count_on_the_transform_device():
    tx = optim.adamw(optim.linear_schedule(1e-3, 0.0, 10), device="cpu")
    params = {"w": torch.zeros(3)}
    state = tx.init(params)
    assert isinstance(state[-1], optim.ScaleByScheduleState)
    assert state[-1].count.dtype == torch.int32 and int(state[-1].count) == 0
    _, state = tx.update({"w": torch.ones(3)}, state, params)
    assert int(state[-1].count) == 1
    assert len(tree_leaves(params)) == 1
