"""Parity of the port's convnet (``models/vision.py``) and CV example
(``examples/cv_example.py``) with the JAX package's, on the CPU in f32.

- The forward's logits and loss within 1e-5 and the gradients within 1e-5
  (relative Frobenius; convolutions and means sum in other orders), on an
  even and an odd image width: XLA's ``"SAME"`` pads a stride-2 convolution
  of an even width 0 before and 1 after, an odd one 1 and 1, and a
  symmetric pad would miss the even case by whole units.
- Two steps of the example's ``training_function`` (64 training images,
  batch 32, one epoch) in both packages from the JAX package's initial
  weights: the two losses within 1e-5 relative, the parameters after the
  steps within 1e-6 (``inject_hyperparams(adam)`` under the cosine
  schedule: a step is near ``lr`` times the gradient's sign, and the
  gradients agree to ~1e-6).
"""

import importlib.util
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models.vision import (
    ConvNetConfig as JConfig,
    ConvNetForImageClassification as JConvNet,
)
from accelerate_tpu_torch.examples import cv_example
from accelerate_tpu_torch.models import (
    ConvNetConfig,
    ConvNetForImageClassification,
    convnet_params_from_numpy,
)
from accelerate_tpu_torch.models.vision import same_padding
from accelerate_tpu_torch.utils.tree import flatten_with_paths

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SEED = 3


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-30))


def _port_grads_as_jax(tree):
    """The port's gradient tree in the JAX layout (a stage list, HWIO)."""
    stages = [dict(s, kernel=s["kernel"].permute(2, 3, 1, 0)) for _, s in
              sorted(tree["stages"].items(), key=lambda kv: int(kv[0]))]
    return {"stages": stages, "head": tree["head"]}


def test_same_padding_matches_xla():
    assert same_padding(32, 3, 2) == (0, 1)
    assert same_padding(33, 3, 2) == (1, 1)
    assert same_padding(7, 3, 1) == (1, 1)


@pytest.mark.parametrize("width", [32, 33])
def test_convnet_logits_loss_and_gradients_match_jax(width):
    jm = JConvNet(JConfig.tiny(num_classes=4))
    jparams = jm.init(jax.random.key(0))
    tm = ConvNetForImageClassification(ConvNetConfig.tiny(num_classes=4), device="cpu")
    tm.params = convnet_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                          tm.config, device="cpu")
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((3, width, width, 3)).astype(np.float32)
    y = rng.integers(0, 4, (3,)).astype(np.int32)

    def jloss(p):
        out = jm.apply(p, pixel_values=x, labels=y)
        return out["loss"], out["logits"]

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten_with_paths(tm.params)}
    from accelerate_tpu_torch.utils.modeling import unflatten_names

    out = tm.apply(unflatten_names(leaves, tm.params), pixel_values=torch.from_numpy(x),
                   labels=torch.from_numpy(y))
    out["loss"].backward()
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-5)
    tgrads = _port_grads_as_jax(unflatten_names({k: v.grad for k, v in leaves.items()},
                                                tm.params))
    for (path, jg), tg in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                              jax.tree_util.tree_leaves(tgrads)):
        assert _rel(tg.numpy(), jg) < 1e-5, path


def test_bf16_parameters_compute_the_f32_function_of_their_values():
    """Under ``mixed_precision="bf16"`` the prepared model gets bf16
    parameters; the convnet computes in f32 (``compute_dtype``) on their
    values, as JAX promotes f32 @ bf16 to f32, so the forward equals the f32
    forward on the rounded weights bitwise."""
    tm = ConvNetForImageClassification(ConvNetConfig.tiny(num_classes=4), device="cpu")
    tm.init_params(SEED)
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal((2, 8, 8, 3))
                         .astype(np.float32))
    bf16 = {k: v for k, v in flatten_with_paths(tm.params)}
    from accelerate_tpu_torch.utils.modeling import unflatten_names

    low = unflatten_names({k: v.to(torch.bfloat16) for k, v in bf16.items()}, tm.params)
    rounded = unflatten_names({k: v.to(torch.bfloat16).float() for k, v in bf16.items()},
                              tm.params)
    got = tm.apply(low, pixel_values=x)["logits"]
    assert got.dtype == torch.float32
    assert torch.equal(got, tm.apply(rounded, pixel_values=x)["logits"])


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_cv_example",
                                                  ROOT / "examples" / "cv_example.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_two_example_steps_match_jax(monkeypatch):
    jex = _jax_example()
    runs = {}

    def recording(base, key):
        class Recording(base):
            def prepare(self, *args):
                out = super().prepare(*args)
                for obj in (out if isinstance(out, tuple) else (out,)):
                    if hasattr(obj, "params") and not hasattr(obj, "__iter__"):
                        runs[key]["model"] = obj
                return out

            def backward(self, loss, **kw):
                runs[key]["losses"].append(float(loss.detach() if key == "port" else loss))
                return super().backward(loss, **kw)
        return Recording

    for key, module in (("jax", jex), ("port", cv_example)):
        runs[key] = {"losses": []}
        small = lambda batch_size, f=module.get_dataloaders: f(  # noqa: E731
            batch_size, train_size=64, eval_size=32)
        monkeypatch.setattr(module, "get_dataloaders", small)
        monkeypatch.setattr(module, "Accelerator", recording(module.Accelerator, key))

    config = {"lr": 3e-3, "num_epochs": 1, "seed": 42, "batch_size": 32}
    jconfig = JConfig(num_classes=cv_example.NUM_CLASSES, widths=(32, 64))
    jinit = jax.tree_util.tree_map(np.asarray, JConvNet(jconfig).init(jax.random.key(42)))

    class FromJax(ConvNetForImageClassification):
        def init(self, generator=None, dtype=torch.float32):
            return convnet_params_from_numpy(jinit, self.config, device=self.device)

    monkeypatch.setattr(cv_example, "ConvNetForImageClassification", FromJax)
    jex.training_function(config, Namespace(mixed_precision="no"))
    cv_example.training_function(config, Namespace(mixed_precision="no", cpu=True))
    assert len(runs["port"]["losses"]) == len(runs["jax"]["losses"]) == 2
    np.testing.assert_allclose(runs["port"]["losses"], runs["jax"]["losses"], rtol=1e-5)
    jparams = jax.tree_util.tree_map(np.asarray, runs["jax"]["model"].params)
    tparams = _port_grads_as_jax(runs["port"]["model"].params)
    for jp, tp in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(tparams)):
        np.testing.assert_allclose(tp.detach().cpu().numpy(), jp, atol=1e-6)
