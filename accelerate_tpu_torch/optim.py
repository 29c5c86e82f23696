"""The port's own copy of the optax pieces the JAX package trains with.

``sgd`` (with or without classic momentum), ``adam``, ``adamw``,
``adafactor`` and ``apply_updates``, with optax's defaults, chain structure,
state names and op order, so the same gradients give the same updates:

- ``scale_by_adam``: ``(1-b)·g + b·m`` moments, bias correction
  ``1 - b**count`` taken in f32 on the device, ``m̂/(sqrt(v̂+eps_root)+eps)``;
- ``add_decayed_weights``: ``u + wd·p`` (adamw's default wd is 1e-4);
- ``scale``: ``step_size·u``, with ``step_size = -learning_rate``;
- ``apply_updates``: ``(p + u)`` cast back to the parameter's dtype.

``adafactor`` is optax 0.2.6's chain (``optax/_src/alias.py``):
``scale_by_factored_rms`` (the factored second moments of the two largest
dims of at least ``min_dim_size_to_factor``, ``factorized._factored_dims``,
decay ``1 - (count + 1)**-0.8``), ``clip_by_block_rms(1.0)``,
``scale_by_learning_rate`` without the sign flip, ``scale_by_param_block_rms``,
the optional ``ema`` momentum (not debiased) and ``add_decayed_weights``,
then ``scale(-1)``. Its statistics are sums over a whole leaf (a stacked
``(L, ...)`` leaf is one block over all L layers). A sharded step on a
process group runs the chain on its slices inside :func:`leaf_views`, which
names each leaf's global shape and the groups that split its dims: the
transforms then all-reduce their partial sums over those groups
(``parallel/fsdp.py``).

``torch.optim.AdamW`` is not used: it decays the weights before the moment
step and folds the learning rate in elsewhere, so its numbers differ.

Each constructor returns a :class:`GradientTransformation` whose
``transforms`` the fused update reads (``ops/fused_update.plan_fused_update``),
so no closure introspection is needed. Like every entry point of the port it
keeps its state on the card unless the caller passes ``device="cpu"``, and
raises without a GPU. Hyperparameters are Python floats;
applied to f32 tensors they round to f32 exactly as XLA rounds the JAX
package's weak-typed Python floats.

Learning-rate schedules, as optax computes them (f32, optax's op order):
``constant_schedule``, ``polynomial_schedule``, ``linear_schedule`` and
``cosine_decay_schedule``. A schedule takes a step count (a Python int, or an
int tensor on any device) and returns an f32 0-d tensor on the count's device
(the constant schedule returns its value). A callable ``learning_rate`` makes
the chain end in ``scale_by_schedule`` with its own count, as optax's
``scale_by_learning_rate`` does. :func:`inject_hyperparams` keeps every
numeric hyperparameter as an f32 0-d tensor in the transform's state
(``InjectHyperparamsState.hyperparams``) and rebuilds the inner chain from
the current values at each update, as optax does; a learning rate written
into that state (``AcceleratedOptimizer.set_learning_rate``) takes effect at
the next update. Nesterov and the other optax transforms are not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
import inspect
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .utils.device import resolve_device
from .utils.tree import tree_map

_MAX_INT32 = 2**31 - 1


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # int32 device scalar: updates applied so far


class InjectHyperparamsState(NamedTuple):
    count: torch.Tensor  # int32 device scalar: updates applied so far
    hyperparams: dict  # name -> f32 0-d tensor on the transform's device
    inner_state: tuple


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 device scalar: updates applied so far
    mu: dict
    nu: dict


class TraceState(NamedTuple):
    trace: dict


class EmptyState(NamedTuple):
    pass


class FactoredState(NamedTuple):
    count: torch.Tensor  # int32 device scalar: updates applied so far
    v_row: dict  # per leaf: the row statistics, or (1,) zeros where unfactored
    v_col: dict  # per leaf: the column statistics, or (1,) zeros where unfactored
    v: dict  # per leaf: the unfactored statistics, or (1,) zeros where factored


class EmaState(NamedTuple):
    count: torch.Tensor  # int32 device scalar
    ema: dict


# ------------------------------------------------------------ leaf views
@dataclass(frozen=True)
class LeafView:
    """How a rank's slice of a leaf lies in the global leaf: its global
    ``shape`` and, per split dim, the process groups whose ranks hold that
    dim's other pieces (``dims``: ``{dim: [group, ...]}``)."""

    shape: tuple
    dims: dict = field(default_factory=dict)

    def sum(self, t, over):
        """``t`` (already summed over the slice's dims ``over`` of the leaf)
        summed over the ranks that split those dims."""
        for d in over:
            for group in self.dims.get(d, ()):
                dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t


_LEAF_VIEWS = contextvars.ContextVar("accelerate_tpu_torch_leaf_views", default=None)


@contextlib.contextmanager
def leaf_views(views):
    """Within the block, transforms with global statistics read ``views``
    (a tree like the parameters of :class:`LeafView`; None: every tensor is
    its whole leaf)."""
    token = _LEAF_VIEWS.set(views)
    try:
        yield
    finally:
        _LEAF_VIEWS.reset(token)


def _views_like(tree):
    views = _LEAF_VIEWS.get()
    return views if views is not None else tree_map(lambda _: None, tree)


def _global_shape(t, view):
    return tuple(view.shape) if view is not None else tuple(t.shape)


def _global_sum(t, view, dims):
    """``t`` summed over its dims ``dims`` (``keepdim``) and over the ranks
    that split them."""
    out = t.sum(dim=tuple(dims), keepdim=True)
    return out if view is None else view.sum(out, dims)


def _global_mean(t, view, dims):
    shape = _global_shape(t, view)
    count = 1
    for d in dims:
        count *= shape[d]
    return _global_sum(t, view, dims) / count


def safe_int32_increment(count):
    """``count + 1``, saturating at the int32 maximum (optax's increment)."""
    return torch.where(count < _MAX_INT32, count + 1, torch.full_like(count, _MAX_INT32))


def _zeros(params, device):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype, device=device), params)


@dataclass(frozen=True)
class Identity:
    def init(self, params, device):
        return EmptyState()

    def update(self, updates, state, params=None):
        return updates, state


@dataclass(frozen=True)
class ScaleByAdam:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params, device):
        count = torch.zeros((), dtype=torch.int32, device=device)
        return ScaleByAdamState(count=count, mu=_zeros(params, device), nu=_zeros(params, device))

    def bias_corrections(self, count):
        """``(1 - b1**count, 1 - b2**count)`` as f32 device scalars."""
        c = count.to(torch.float32)
        b1 = torch.as_tensor(self.b1, dtype=torch.float32, device=count.device)
        b2 = torch.as_tensor(self.b2, dtype=torch.float32, device=count.device)
        return 1 - torch.pow(b1, c), 1 - torch.pow(b2, c)

    def update(self, updates, state, params=None):
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates, state.nu)
        count = safe_int32_increment(state.count)
        bc1, bc2 = self.bias_corrections(count)
        mu_hat = tree_map(lambda t: t / bc1, mu)
        nu_hat = tree_map(lambda t: t / bc2, nu)
        out = tree_map(lambda m, v: m / (torch.sqrt(v + self.eps_root) + self.eps), mu_hat, nu_hat)
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)


@dataclass(frozen=True)
class Trace:
    decay: float

    def init(self, params, device):
        return TraceState(trace=_zeros(params, device))

    def update(self, updates, state, params=None):
        trace = tree_map(lambda g, t: g + self.decay * t, updates, state.trace)
        return trace, TraceState(trace=trace)


@dataclass(frozen=True)
class AddDecayedWeights:
    weight_decay: float

    def init(self, params, device):
        return EmptyState()

    def update(self, updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the parameters")
        return tree_map(lambda g, p: g + self.weight_decay * p, updates, params), state


@dataclass(frozen=True)
class Scale:
    step_size: float  # or an f32 0-d tensor (a learning rate under inject_hyperparams)

    def init(self, params, device):
        return EmptyState()

    def update(self, updates, state, params=None):
        return tree_map(lambda g: self.step_size * g, updates), state


@dataclass(frozen=True)
class ScaleBySchedule:
    """``step_size_fn(count) · u``, the count advancing once an update
    (optax's ``scale_by_schedule``)."""

    step_size_fn: Callable

    def init(self, params, device):
        return ScaleByScheduleState(count=torch.zeros((), dtype=torch.int32, device=device))

    def update(self, updates, state, params=None):
        step_size = self.step_size_fn(state.count)

        def one(g):
            return torch.as_tensor(step_size, dtype=g.dtype, device=g.device) * g

        return tree_map(one, updates), ScaleByScheduleState(
            count=safe_int32_increment(state.count))


class GradientTransformation:
    """A chain of transforms, as ``optax.chain`` builds one: ``init`` gives
    one state per transform (a tuple) on ``device``, ``update`` runs them in
    order."""

    def __init__(self, *transforms, device=None):
        self.transforms = tuple(transforms)
        self.device = resolve_device(device)

    def init(self, params):
        return tuple(t.init(params, self.device) for t in self.transforms)

    def update(self, updates, state, params=None):
        new_state = []
        for t, s in zip(self.transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)


def chain(*transforms, device=None) -> GradientTransformation:
    return GradientTransformation(*transforms, device=device)


# ----------------------------------------------------------------- adafactor
def _factored_dims(shape, factored: bool, min_dim_size_to_factor: int):
    """optax's ``factorized._factored_dims``: the two largest dims ``(d1,
    d0)`` (d0 the largest; ties by numpy's argsort) when the second largest
    has at least ``min_dim_size_to_factor`` elements, else None."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


@dataclass(frozen=True)
class ScaleByFactoredRms:
    """optax's ``scale_by_factored_rms``: per leaf of global shape with
    factored dims ``(d1, d0)``, running means of ``g**2 + eps`` over d0
    (``v_row``) and over d1 (``v_col``), the update ``g * (v_row /
    mean(v_row))**-0.5 * v_col**-0.5``; an unfactored leaf keeps ``v`` of
    its shape and updates ``g * v**-0.5``."""

    factored: bool = True
    decay_rate: float = 0.8
    step_offset: int = 0
    min_dim_size_to_factor: int = 128
    epsilon: float = 1e-30
    block_stats = True

    def init(self, params, device):
        def one(p, view):
            shape = list(p.shape)
            dims = _factored_dims(_global_shape(p, view), self.factored,
                                  self.min_dim_size_to_factor)
            z1 = torch.zeros((1,), dtype=p.dtype, device=device)
            if dims is None:
                return z1, z1.clone(), torch.zeros(shape, dtype=p.dtype, device=device)
            d1, d0 = dims
            row = [n for d, n in enumerate(shape) if d != d0]
            col = [n for d, n in enumerate(shape) if d != d1]
            return (torch.zeros(row, dtype=p.dtype, device=device),
                    torch.zeros(col, dtype=p.dtype, device=device), z1)

        out = tree_map(one, params, _views_like(params))
        pick = lambda k: tree_map(lambda o: o[k], out)  # noqa: E731
        return FactoredState(count=torch.zeros((), dtype=torch.int32, device=device),
                             v_row=pick(0), v_col=pick(1), v=pick(2))

    def update(self, updates, state, params=None):
        if params is None:
            raise ValueError("scale_by_factored_rms needs the parameters")
        t = (state.count - self.step_offset).to(torch.float32) + 1
        decay = 1.0 - torch.pow(t, -self.decay_rate)

        def one(g, v_row, v_col, v, p, view):
            dims = _factored_dims(_global_shape(p, view), self.factored,
                                  self.min_dim_size_to_factor)
            grad_sqr = g * g + self.epsilon
            if dims is None:
                new_v = (decay * v + (1.0 - decay) * grad_sqr).to(p.dtype)
                return g * new_v ** -0.5, v_row, v_col, new_v
            d1, d0 = dims
            new_v_row = (decay * v_row + (1.0 - decay) * _global_mean(
                grad_sqr, view, (d0,)).squeeze(d0)).to(p.dtype)
            new_v_col = (decay * v_col + (1.0 - decay) * _global_mean(
                grad_sqr, view, (d1,)).squeeze(d1)).to(p.dtype)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_view = None if view is None else LeafView(
                tuple(n for d, n in enumerate(view.shape) if d != d0),
                {(d - (d > d0)): gs for d, gs in view.dims.items() if d != d0})
            row_col_mean = _global_mean(new_v_row, row_view, (reduced_d1,))
            row_factor = (new_v_row / row_col_mean) ** -0.5
            col_factor = new_v_col ** -0.5
            update = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            return update, new_v_row, new_v_col, v

        out = tree_map(one, updates, state.v_row, state.v_col, state.v, params,
                       _views_like(params))
        pick = lambda k: tree_map(lambda o: o[k], out)  # noqa: E731
        return pick(0), FactoredState(count=safe_int32_increment(state.count), v_row=pick(1),
                                      v_col=pick(2), v=pick(3))


def _all_dims(t):
    return tuple(range(t.dim()))


def _block_rms(t, view):
    """``sqrt(mean(t**2))`` over the whole global leaf."""
    return torch.sqrt(_global_mean(t * t, view, _all_dims(t))).reshape(())


@dataclass(frozen=True)
class ClipByBlockRms:
    """optax's ``clip_by_block_rms``: each leaf divided by ``max(1,
    rms / threshold)``."""

    threshold: float
    block_stats = True

    def init(self, params, device):
        return EmptyState()

    def update(self, updates, state, params=None):
        def one(u, view):
            denom = torch.clamp(_block_rms(u, view) / self.threshold, min=1.0)
            return u / denom

        return tree_map(one, updates, _views_like(updates)), state


@dataclass(frozen=True)
class ScaleByParamBlockRms:
    """optax's ``scale_by_param_block_rms``: each update times its
    parameter's RMS, or ``min_scale`` where that is at most ``min_scale``."""

    min_scale: float = 1e-3
    block_stats = True

    def init(self, params, device):
        return EmptyState()

    def update(self, updates, state, params=None):
        if params is None:
            raise ValueError("scale_by_param_block_rms needs the parameters")

        def one(u, p, view):
            rms = _block_rms(p, view)
            return u * torch.where(rms <= self.min_scale, torch.full_like(rms, self.min_scale),
                                   rms)

        return tree_map(one, updates, params, _views_like(params)), state


@dataclass(frozen=True)
class Ema:
    """optax's ``ema`` without debiasing: ``(1 - decay)·u + decay·ema``."""

    decay: float
    accumulator_dtype: torch.dtype = torch.float32

    def init(self, params, device):
        return EmaState(count=torch.zeros((), dtype=torch.int32, device=device),
                        ema=tree_map(lambda p: torch.zeros(p.shape, dtype=self.accumulator_dtype,
                                                           device=device), params))

    def update(self, updates, state, params=None):
        ema = tree_map(lambda g, t: (1 - self.decay) * g + self.decay * t, updates, state.ema)
        return ema, EmaState(count=safe_int32_increment(state.count),
                             ema=tree_map(lambda t: t.to(self.accumulator_dtype), ema))


def needs_global_stats(tx) -> bool:
    """Whether ``tx`` runs a transform whose statistics are sums over whole
    leaves (adafactor's), which a sharded update must reduce over the
    ranks."""
    if isinstance(tx, InjectHyperparams):
        tx = tx._inner({**tx.numeric, **{k: 0.0 for k in tx.scheduled}})
    return any(getattr(t, "block_stats", False) for t in getattr(tx, "transforms", ()))


def _scale_by_learning_rate(learning_rate):
    """optax's ``scale_by_learning_rate``: ``-learning_rate`` as a constant
    step, or a schedule of it."""
    if callable(learning_rate):
        return ScaleBySchedule(lambda count: -1 * learning_rate(count))
    if isinstance(learning_rate, torch.Tensor):
        return Scale(-1 * learning_rate)
    return Scale(-1 * float(learning_rate))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
         device=None) -> GradientTransformation:
    return chain(ScaleByAdam(b1, b2, eps, eps_root), _scale_by_learning_rate(learning_rate),
                 device=device)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4,
          device=None) -> GradientTransformation:
    return chain(ScaleByAdam(b1, b2, eps, eps_root), AddDecayedWeights(weight_decay),
                 _scale_by_learning_rate(learning_rate), device=device)


def sgd(learning_rate, momentum=None, device=None) -> GradientTransformation:
    first = Trace(momentum) if momentum is not None else Identity()
    return chain(first, _scale_by_learning_rate(learning_rate), device=device)


def adafactor(learning_rate=None, min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
              decay_offset: int = 0, multiply_by_parameter_scale: bool = True,
              clipping_threshold=1.0, momentum=None, dtype_momentum=torch.float32,
              weight_decay_rate=None, eps: float = 1e-30, factored: bool = True,
              device=None) -> GradientTransformation:
    """optax's ``adafactor`` (module docstring), with its defaults; a
    ``weight_decay_mask`` is not ported."""
    tx = [ScaleByFactoredRms(factored, decay_rate, decay_offset, min_dim_size_to_factor, eps)]
    if clipping_threshold is not None:
        tx.append(ClipByBlockRms(clipping_threshold))
    if learning_rate is not None:
        if callable(learning_rate):
            tx.append(ScaleBySchedule(learning_rate))
        else:
            tx.append(Scale(learning_rate if isinstance(learning_rate, torch.Tensor)
                            else float(learning_rate)))
    if multiply_by_parameter_scale:
        tx.append(ScaleByParamBlockRms())
    if momentum is not None:
        tx.append(Ema(momentum, dtype_momentum))
    if weight_decay_rate is not None:
        tx.append(AddDecayedWeights(weight_decay_rate))
    tx.append(Scale(-1))
    return chain(*tx, device=device)


def apply_updates(params, updates):
    """``(p + u)`` cast back to each parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ----------------------------------------------------------------- schedules
def _count_tensor(count):
    return count if isinstance(count, torch.Tensor) else torch.tensor(int(count))


def constant_schedule(value):
    """``value`` at every step."""
    return lambda count: value


def polynomial_schedule(init_value, end_value, power, transition_steps: int,
                        transition_begin: int = 0):
    """optax's ``polynomial_schedule``: ``(init - end)·(1 - t/T)**power +
    end`` with ``t`` clipped to ``[0, T]`` after ``transition_begin``;
    ``init_value`` throughout when ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        count = torch.clamp(_count_tensor(count) - transition_begin, 0, transition_steps)
        steps = torch.tensor(float(transition_steps), dtype=torch.float32, device=count.device)
        frac = 1 - count.to(torch.float32) / steps
        return (init_value - end_value) * (frac ** power) + end_value

    return schedule


def linear_schedule(init_value, end_value, transition_steps: int, transition_begin: int = 0):
    """optax's ``linear_schedule``: :func:`polynomial_schedule` of power 1."""
    return polynomial_schedule(init_value, end_value, 1, transition_steps, transition_begin)


def cosine_decay_schedule(init_value, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0):
    """optax's ``cosine_decay_schedule``: ``init·((1 - alpha)·(0.5·(1 +
    cos(pi·t/T)))**exponent + alpha)`` with ``t`` capped at ``T``."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")

    def schedule(count):
        count = _count_tensor(count).to(torch.float32)
        steps = torch.tensor(float(decay_steps), dtype=torch.float32, device=count.device)
        count = torch.minimum(count, steps)
        pi = torch.tensor(math.pi, dtype=torch.float32, device=count.device)
        # cos in f64, rounded once: closer to XLA's f32 cos than torch's.
        cosine_decay = 0.5 * (1 + torch.cos((pi * count / steps).double()).float())
        decayed = (1 - alpha) * cosine_decay ** exponent + alpha
        return init_value * decayed

    return schedule


# ----------------------------------------------------------- inject_hyperparams
class InjectHyperparams(GradientTransformation):
    """optax's ``inject_hyperparams(factory)(**hyperparams)``: every numeric
    argument of ``factory`` (defaults included, booleans excluded) is kept
    as an f32 0-d tensor in the state, a callable one is a schedule of the
    update count, and each update builds ``factory(**current values)`` and
    runs it on the inner state. The fused update does not cover it
    (``plan_fused_update`` returns None): the inner chain runs."""

    def __init__(self, factory, static_args=(), arguments=None, device=None):
        super().__init__(device=device)
        self.factory = factory
        self.numeric, self.scheduled, self.other = {}, {}, {}
        for name, value in arguments.items():
            if name == "device":
                continue
            if name in static_args or isinstance(value, bool):
                self.other[name] = value
            elif callable(value):
                self.scheduled[name] = value
            elif isinstance(value, (int, float, torch.Tensor)):
                self.numeric[name] = value
            else:
                self.other[name] = value

    def _hyperparam(self, value):
        return torch.as_tensor(value, dtype=torch.float32, device=self.device) if (
            isinstance(value, float) or (isinstance(value, torch.Tensor)
                                         and value.is_floating_point())) else value

    def _inner(self, hyperparams):
        return self.factory(**self.other, **hyperparams, device=self.device)

    def init(self, params):
        count = torch.zeros((), dtype=torch.int32, device=self.device)
        hyperparams = {k: self._hyperparam(v) for k, v in self.numeric.items()}
        hyperparams.update({k: self._hyperparam(f(count)) for k, f in self.scheduled.items()})
        return InjectHyperparamsState(count=count, hyperparams=hyperparams,
                                      inner_state=self._inner(hyperparams).init(params))

    def update(self, updates, state, params=None):
        hyperparams = dict(state.hyperparams)
        hyperparams.update({k: self._hyperparam(f(state.count))
                            for k, f in self.scheduled.items()})
        updates, inner_state = self._inner(hyperparams).update(updates, state.inner_state,
                                                               params)
        return updates, InjectHyperparamsState(count=safe_int32_increment(state.count),
                                               hyperparams=hyperparams, inner_state=inner_state)


def inject_hyperparams(factory, static_args=()):
    """``inject_hyperparams(adamw)(learning_rate=2e-5, device=...)``: see
    :class:`InjectHyperparams`."""
    static_args = {static_args} if isinstance(static_args, str) else set(static_args)
    signature = inspect.signature(factory)

    def wrapped(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        arguments = dict(bound.arguments)
        return InjectHyperparams(factory, static_args, arguments, device=arguments.get("device"))

    return wrapped
