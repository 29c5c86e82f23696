"""Model protocol — the PyTorch counterpart of ``accelerate_tpu/modules.py``.

A model is a config object plus a parameter dictionary of tensors (the JAX
package's pytree, kept as nested dicts so parameters carry across from the
JAX reference by name), with ``init`` building the parameters and ``apply``
running the forward. HF-style convention: the forward returns a
:class:`ModelOutput` with a ``logits`` field (and ``cache`` on the decode
path).
"""

from __future__ import annotations


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
        ``generator`` is a ``torch.Generator`` (or an int seed)."""
        self.params = self.init(generator, **kwargs)
        return self.params
