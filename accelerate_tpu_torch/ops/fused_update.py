"""Fused optimizer update — clip + moments + apply + cast, one pass per leaf.

The counterpart of ``accelerate_tpu/ops/pallas/fused_update.py:63-190,
273-383``. The training step's update region is a chain of small
elementwise passes over every parameter leaf: scale by the clip factor, the
moment updates, bias correction, the update rule, weight decay, the
learning-rate scale, ``apply_updates``' cast, and the accumulation buffer's
reset. Op ``fused_update`` runs the whole chain per leaf: the hand-written
CUDA kernel of ``csrc/fused_update.cu`` for CUDA tensors, :func:`leaf_update`
(the per-leaf math :func:`_leaf_math`, the plain version) for CPU tensors or
``kernels="off"``. Both update the parameter, the moments and the buffer in
place, where the JAX kernel returns donated outputs, and the two are bitwise
equal on the card.

- :func:`plan_fused_update` reads the family and the hyperparameters from
  the port's own transform objects (``optim.py``): ``sgd`` (with or without
  momentum), ``adam`` and ``adamw`` with a constant learning rate. Anything
  else (a schedule, ``inject_hyperparams``) returns None and the caller runs
  the optax-order chain (:func:`reference_update_apply`), as the JAX package
  does.
- The clip factor and the bias corrections ``1 - b**count`` are f32 device
  scalars computed outside the per-leaf pass, as the JAX package computes
  them outside its kernel; nothing reads them back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..optim import (
    AddDecayedWeights,
    Identity,
    InjectHyperparams,
    Scale,
    ScaleByAdam,
    Trace,
    apply_updates,
    safe_int32_increment,
)
from ..utils.tree import tree_leaves, tree_map
from .kernels.fused_update import fused_update_cuda
from .registry import dispatch, register_op


@dataclass(frozen=True)
class FusedUpdatePlan:
    """The optimizer family, its hyperparameters, and where its state lives
    in the chain's state tuple. ``kind``: sgd | sgd_momentum | adam (adamw =
    adam with ``weight_decay`` not None)."""

    kind: str
    step_size: float
    b1: float = 0.0
    b2: float = 0.0
    eps: float = 0.0
    eps_root: float = 0.0
    weight_decay: float | None = None
    momentum: float = 0.0
    state_index: int | None = None  # chain position of the adam or trace state

    def describe(self) -> str:
        wd = self.weight_decay is not None
        return {"adam": "adamw" if wd else "adam"}.get(self.kind, self.kind)

    def f32_constants(self) -> dict:
        """The hyperparameters as the f32 values the arithmetic uses: each
        Python expression rounded to f32 once, as XLA rounds a weak-typed
        Python float against an f32 array."""
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        return dict(
            one_minus_b1=f32(1 - self.b1), b1=f32(self.b1), one_minus_b2=f32(1 - self.b2),
            b2=f32(self.b2), eps=f32(self.eps), eps_root=f32(self.eps_root),
            wd=f32(self.weight_decay or 0.0), step_size=f32(self.step_size),
            momentum=f32(self.momentum))


def plan_fused_update(tx) -> FusedUpdatePlan | None:
    """Match ``tx`` (a ``GradientTransformation`` of ``optim.py``) against
    the supported constructions; None means the reference chain runs. As in
    the JAX package (``ops/pallas/fused_update.py:103-155``), an
    ``inject_hyperparams`` transform and a chain with a schedule
    (``ScaleBySchedule``) get None."""
    if isinstance(tx, InjectHyperparams):
        return None
    transforms = getattr(tx, "transforms", None)
    if not transforms:
        return None
    kind, hp, state_index, saw_scale = "sgd", {}, None, False
    for i, t in enumerate(transforms):
        if isinstance(t, Identity):
            continue
        if isinstance(t, ScaleByAdam):
            if kind != "sgd" or saw_scale:
                return None
            kind, state_index = "adam", i
            hp.update(b1=float(t.b1), b2=float(t.b2), eps=float(t.eps), eps_root=float(t.eps_root))
        elif isinstance(t, Trace):
            if kind != "sgd" or saw_scale:
                return None
            kind, state_index = "sgd_momentum", i
            hp.update(momentum=float(t.decay))
        elif isinstance(t, AddDecayedWeights):
            if kind != "adam" or saw_scale or "weight_decay" in hp:
                return None
            hp.update(weight_decay=float(t.weight_decay))
        elif isinstance(t, Scale):
            if saw_scale or not isinstance(t.step_size, (int, float)):
                return None
            saw_scale = True
            hp.update(step_size=float(t.step_size))
        else:
            return None  # anything unrecognized
    if not saw_scale:
        return None
    return FusedUpdatePlan(kind=kind, state_index=state_index, **hp)


def _leaf_math(plan: FusedUpdatePlan):
    """The per-leaf elementwise chain in optax's op order — the plain
    version of the kernel. Returns a function of
    ``(p, g, factor, *extras) -> (p', *new_extras)``; each operation is its
    own correctly rounded f32 op."""
    c = plan.f32_constants()

    def adam(p, mu, nu, g, factor, bc1, bc2):
        g = g * factor
        new_mu = c["one_minus_b1"] * g + c["b1"] * mu
        new_nu = c["one_minus_b2"] * (g * g) + c["b2"] * nu
        mu_hat = new_mu / bc1
        nu_hat = new_nu / bc2
        u = mu_hat / (torch.sqrt(nu_hat + c["eps_root"]) + c["eps"])
        if plan.weight_decay is not None:
            u = u + c["wd"] * p
        u = c["step_size"] * u
        return (p + u).to(p.dtype), new_mu, new_nu

    def sgd(p, g, factor):
        g = g * factor
        u = c["step_size"] * g
        return ((p + u).to(p.dtype),)

    def sgd_momentum(p, trace, g, factor):
        g = g * factor
        new_trace = g + c["momentum"] * trace
        u = c["step_size"] * new_trace
        return (p + u).to(p.dtype), new_trace

    return {"adam": adam, "sgd": sgd, "sgd_momentum": sgd_momentum}[plan.kind]


def leaf_update(p, g, moments, factor, bc1=None, bc2=None, *, plan: FusedUpdatePlan):
    """Plain version of op ``fused_update`` on one leaf: the new parameter
    and moments are written into ``p`` and ``moments`` and the buffer ``g``
    is zeroed, as the kernel does."""
    math_fn = _leaf_math(plan)
    if plan.kind == "adam":
        new_p, new_mu, new_nu = math_fn(p, moments[0], moments[1], g, factor, bc1, bc2)
        moments[0].copy_(new_mu)
        moments[1].copy_(new_nu)
    elif plan.kind == "sgd_momentum":
        new_p, new_trace = math_fn(p, moments[0], g, factor)
        moments[0].copy_(new_trace)
    else:
        (new_p,) = math_fn(p, g, factor)
    p.copy_(new_p)
    g.zero_()


def fused_update_apply(params, opt_state, grads, *, plan: FusedUpdatePlan, clip_factor,
                       kernels=None):
    """One fused pass per leaf, in place: afterwards ``params`` hold
    ``apply_updates(params, tx.update(grads * clip_factor, ...))``, the
    moments their new values and ``grads`` zeros. Returns the new state
    tuple (the adam count is a new device scalar). ``clip_factor`` is an f32
    device scalar; ``kernels="off"`` runs the plain version on any device."""
    states = list(opt_state)
    p_leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
    if plan.kind == "adam":
        st = states[plan.state_index]
        count = safe_int32_increment(st.count)
        bc1, bc2 = ScaleByAdam(plan.b1, plan.b2).bias_corrections(count)
        for p, mu, nu, g in zip(p_leaves, tree_leaves(st.mu), tree_leaves(st.nu), g_leaves):
            dispatch("fused_update", p, g, (mu, nu), clip_factor, bc1, bc2, plan=plan,
                     kernels=kernels)
        states[plan.state_index] = st._replace(count=count)
    elif plan.kind == "sgd_momentum":
        st = states[plan.state_index]
        for p, tr, g in zip(p_leaves, tree_leaves(st.trace), g_leaves):
            dispatch("fused_update", p, g, (tr,), clip_factor, plan=plan, kernels=kernels)
    else:
        for p, g in zip(p_leaves, g_leaves):
            dispatch("fused_update", p, g, (), clip_factor, plan=plan, kernels=kernels)
    return tuple(states)


def reference_update_apply(params, opt_state, grads, *, tx, clip_factor):
    """The reference the fused pass must match: the op sequence of the JAX
    package's ``_fused_step_body._upd_math`` after the norm. Returns
    ``(new_params, new_opt_state, zeroed_grads)`` as new trees."""
    grads = tree_map(lambda g: g * clip_factor, grads)
    updates, new_opt = tx.update(grads, opt_state, params)
    new_params = apply_updates(params, updates)
    zero = tree_map(torch.zeros_like, grads)
    return new_params, new_opt, zero


# Clip + moments + apply + cast + buffer reset, per parameter leaf.
register_op("fused_update", leaf_update, fused_update_cuda)
