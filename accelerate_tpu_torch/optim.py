"""The port's own copy of the optax pieces the JAX package trains with.

``sgd`` (with or without classic momentum), ``adam``, ``adamw`` and
``apply_updates``, with optax's defaults, chain structure and op order, so
the same gradients give the same updates:

- ``scale_by_adam``: ``(1-b)·g + b·m`` moments, bias correction
  ``1 - b**count`` taken in f32 on the device, ``m̂/(sqrt(v̂+eps_root)+eps)``;
- ``add_decayed_weights``: ``u + wd·p`` (adamw's default wd is 1e-4);
- ``scale``: ``step_size·u``, with ``step_size = -learning_rate``;
- ``apply_updates``: ``(p + u)`` cast back to the parameter's dtype.

``torch.optim.AdamW`` is not used: it decays the weights before the moment
step and folds the learning rate in elsewhere, so its numbers differ.

Each constructor returns a :class:`GradientTransformation` whose
``transforms`` the fused update reads (``ops/fused_update.plan_fused_update``),
so no closure introspection is needed. Like every entry point of the port it
keeps its state on the card unless the caller passes ``device="cpu"``, and
raises without a GPU. Hyperparameters are Python floats;
applied to f32 tensors they round to f32 exactly as XLA rounds the JAX
package's weak-typed Python floats. Schedules, nesterov and the other optax
transforms are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .utils.device import resolve_device
from .utils.tree import tree_map

_MAX_INT32 = 2**31 - 1


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 device scalar: updates applied so far
    mu: dict
    nu: dict


class TraceState(NamedTuple):
    trace: dict


class EmptyState(NamedTuple):
    pass


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
        b1 = torch.tensor(self.b1, dtype=torch.float32, device=count.device)
        b2 = torch.tensor(self.b2, dtype=torch.float32, device=count.device)
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
    step_size: float

    def init(self, params, device):
        return EmptyState()

    def update(self, updates, state, params=None):
        return tree_map(lambda g: self.step_size * g, updates), state


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


def _lr(learning_rate) -> float:
    if callable(learning_rate):
        raise NotImplementedError("learning-rate schedules are not ported yet (ROADMAP.md)")
    return -1 * float(learning_rate)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
         device=None) -> GradientTransformation:
    return chain(ScaleByAdam(b1, b2, eps, eps_root), Scale(_lr(learning_rate)), device=device)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4,
          device=None) -> GradientTransformation:
    return chain(ScaleByAdam(b1, b2, eps, eps_root), AddDecayedWeights(weight_decay),
                 Scale(_lr(learning_rate)), device=device)


def sgd(learning_rate, momentum=None, device=None) -> GradientTransformation:
    first = Trace(momentum) if momentum is not None else Identity()
    return chain(first, Scale(_lr(learning_rate)), device=device)


def apply_updates(params, updates):
    """``(p + u)`` cast back to each parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
