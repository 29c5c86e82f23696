"""Model protocol — the PyTorch counterpart of ``accelerate_tpu/modules.py``.

A model is a config object plus a parameter dictionary of tensors (the JAX
package's pytree, kept as nested dicts so parameters carry across from the
JAX reference by name), with ``init`` building the parameters and ``apply``
running the forward. HF-style convention: the forward returns a
:class:`ModelOutput` with a ``logits`` field (and ``cache`` on the decode
path).
"""

from __future__ import annotations

import contextlib

import torch

# The device ``init_params`` builds on while ``big_modeling.init_empty_weights``
# (``meta``) or ``init_on_device`` is open: a stack, innermost last.
_INIT_DEVICES: list = []


@contextlib.contextmanager
def init_device(device):
    """``Module.init_params`` builds on ``device`` inside this context."""
    _INIT_DEVICES.append(torch.device(device))
    try:
        yield
    finally:
        _INIT_DEVICES.pop()


class ModelOutput(dict):
    """Dict with attribute access (``out.logits``, ``out.cache``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value


class Module:
    """Base for the model zoo: a config object plus explicit parameters.

    Subclasses implement ``init(generator, **kwargs) -> params`` and
    ``apply(params, *args, **kwargs)``."""

    params = None

    def init(self, generator, **kwargs):
        raise NotImplementedError

    def apply(self, params, *args, **kwargs):
        raise NotImplementedError

    def sharding_rules(self):
        """``(path_regex, spec)`` rules for the sharding planner
        (``parallel/sharding.py``), or None: the auto plan."""
        return None

    def init_params(self, generator=None, **kwargs):
        """Materialize the parameter dictionary and remember it on the model.
        ``generator`` is a ``torch.Generator`` (or an int seed). Under
        ``init_empty_weights`` the tree is built on the ``meta`` device: its
        shapes and dtypes, no memory and no random numbers (the JAX
        package's ``jax.eval_shape``); under ``init_on_device(d)`` on ``d``,
        which the model then runs on."""
        if not _INIT_DEVICES:
            self.params = self.init(generator, **kwargs)
            return self.params
        dev, saved = _INIT_DEVICES[-1], self.device
        self.device = dev
        try:
            self.params = self.init(generator, **kwargs)
        finally:
            if dev.type == "meta":
                self.device = saved
        return self.params
