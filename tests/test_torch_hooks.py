"""The port's hooks (``hooks.py``) through the cases of ``tests/test_hooks.py``,
each run on the JAX package's hooks and the port's on the same model
(``y = a * x + b``, the JAX package's ``RegressionModel``, and its port
below) and inputs, the numbers compared: exactly where both compute in f32
(one multiply and one add), to bf16's resolution for the casting hook, and
to the int8 quantization's bound for the dequantizing one (its quantized
weights are bitwise equal in the two packages, ``tests/test_torch_quantization.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import hooks as jh
from accelerate_tpu.test_utils import RegressionModel as JRegression
from accelerate_tpu.utils.quantization import QuantizationConfig as JQConfig, quantize_tree as jqt
from accelerate_tpu_torch import hooks as th
from accelerate_tpu_torch.modules import ModelOutput, Module
from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize_tree

X = np.arange(4.0, dtype=np.float32)


class Regression(Module):
    """``y = a * x + b`` with scalar parameters (the JAX package's
    ``RegressionModel``)."""

    def __init__(self, a: float = 0.0, b: float = 0.0):
        self.a0, self.b0 = a, b
        self.device = torch.device("cpu")
        self.params = None

    def init(self, generator=None, **kwargs):
        return {"a": torch.tensor(self.a0), "b": torch.tensor(self.b0)}

    def apply(self, params, x=None, **kwargs):
        return ModelOutput(prediction=params["a"] * torch.as_tensor(x) + params["b"])


def _models():
    jm = JRegression(a=2.0, b=3.0)
    jm.params = jm.init(jax.random.key(0))
    tm = Regression(a=2.0, b=3.0)
    tm.init_params()
    return jm, tm


def _run(jm, tm, jparams=None, tparams=None):
    j = np.asarray(jm.apply(jm.params if jparams is None else jparams, x=X)["prediction"])
    t = tm.apply(tm.params if tparams is None else tparams, x=torch.from_numpy(X))["prediction"]
    return j, t.numpy()


class Doubler:
    """post_forward doubles the prediction (both packages' hook classes)."""

    @staticmethod
    def of(base):
        class _Doubler(base):
            def post_forward(self, module, output):
                output["prediction"] = output["prediction"] * 2
                return output
        return _Doubler()


def test_default_hook_is_identity_and_removal_restores():
    jm, tm = _models()
    jh.add_hook_to_module(jm, jh.ModelHook())
    th.add_hook_to_module(tm, th.ModelHook())
    j, t = _run(jm, tm)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, 2.0 * X + 3.0)
    jm, tm = _models()
    original = tm.apply
    jh.add_hook_to_module(jm, Doubler.of(jh.ModelHook))
    th.add_hook_to_module(tm, Doubler.of(th.ModelHook))
    assert tm.apply is not original
    j, t = _run(jm, tm)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, (2.0 * X + 3.0) * 2)
    jh.remove_hook_from_module(jm)
    th.remove_hook_from_module(tm)
    assert tm._at_hook is None
    j, t = _run(jm, tm)
    np.testing.assert_array_equal(t, j)
    # Without append a second hook replaces the first.
    th.add_hook_to_module(tm, Doubler.of(th.ModelHook))
    th.add_hook_to_module(tm, th.ModelHook())
    np.testing.assert_array_equal(_run(jm, tm)[1], 2.0 * X + 3.0)


def test_pre_forward_rewrites_params_and_inputs():
    jm, tm = _models()

    def zero_slope(base, zeros_like):
        class ZeroSlope(base):
            def pre_forward(self, module, params, args, kwargs):
                return dict(params, a=zeros_like(params["a"])), args, \
                    dict(kwargs, x=kwargs["x"] + 1.0)
        return ZeroSlope()

    jh.add_hook_to_module(jm, zero_slope(jh.ModelHook, jnp.zeros_like))
    th.add_hook_to_module(tm, zero_slope(th.ModelHook, torch.zeros_like))
    j, t = _run(jm, tm)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, np.full_like(X, 3.0))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_append_composes_in_order_and_sequential_hooks_run_all(package):
    hooks = jh if package == "jax" else th
    model = _models()[0 if package == "jax" else 1]
    trace = []

    class Tagger(hooks.ModelHook):
        def __init__(self, tag):
            self.tag = tag

        def init_hook(self, module):
            trace.append(f"init:{self.tag}")
            return module

        def pre_forward(self, module, params, args, kwargs):
            trace.append(f"pre:{self.tag}")
            return params, args, kwargs

        def post_forward(self, module, output):
            trace.append(f"post:{self.tag}")
            return output

        def detach_hook(self, module):
            trace.append(f"detach:{self.tag}")
            return module

    hooks.add_hook_to_module(model, Tagger("first"))
    hooks.add_hook_to_module(model, Tagger("second"), append=True)
    assert isinstance(model._at_hook, hooks.SequentialHook)
    trace.clear()
    model.apply(model.params, x=X if package == "jax" else torch.from_numpy(X))
    assert trace == ["pre:first", "pre:second", "post:first", "post:second"]
    hooks.remove_hook_from_module(model)
    assert trace[-2:] == ["detach:first", "detach:second"]
    trace.clear()
    model.apply(model.params, x=X if package == "jax" else torch.from_numpy(X))
    assert trace == []
    seq = hooks.SequentialHook(Tagger("a"), Tagger("b"))
    hooks.add_hook_to_module(model, seq)
    hooks.remove_hook_from_module(model)
    assert trace == ["init:a", "init:b", "detach:a", "detach:b"]


def test_align_devices_hook_places_loads_and_returns():
    jm, tm = _models()
    th.add_hook_to_module(tm, th.AlignDevicesHook(execution_device="cpu", io_same_device=True))
    out = tm.apply(tm.params, x=X)["prediction"]  # numpy in, a tensor on the device out
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), np.asarray(jm.apply(jm.params, x=X)["prediction"]))
    # Leaves that are not on a card come from the weights map by name.
    jm, tm = _models()
    jabstract = jax.tree_util.tree_map(lambda p: jax.ShapeDtypeStruct(np.shape(p), p.dtype),
                                       jm.params)
    jh.add_hook_to_module(jm, jh.AlignDevicesHook(
        weights_map={"a": np.float32(5.0), "b": np.float32(-1.0)}))
    th.add_hook_to_module(tm, th.AlignDevicesHook(
        weights_map={"a": torch.tensor(5.0), "b": torch.tensor(-1.0)}))
    meta = {k: torch.empty((), device="meta") for k in ("a", "b")}
    j, t = _run(jm, tm, jabstract, meta)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, 5.0 * X - 1.0)


def test_cpu_offload_hook_user_handle_and_eviction():
    jm, tm = _models()
    hook = th.CpuOffload(execution_device="cpu")
    th.add_hook_to_module(tm, hook)
    handle = th.UserCpuOffloadHook(tm, hook)
    jh.add_hook_to_module(jm, jh.CpuOffload(execution_device=jax.local_devices()[0]))
    j, t = _run(jm, tm)
    np.testing.assert_array_equal(t, j)
    handle.offload()
    assert tm.params["a"].device.type == "cpu"
    np.testing.assert_array_equal(_run(jm, tm)[1], j)
    handle.remove()
    assert tm._at_hook is None
    # A chain: the second model's forward evicts the first.
    first, second = _models()[1], _models()[1]
    evicted = []
    handle1 = th.UserCpuOffloadHook(first, th.CpuOffload(execution_device="cpu"))
    handle1.offload = lambda: evicted.append("first")
    th.add_hook_to_module(second, th.CpuOffload(execution_device="cpu",
                                                prev_module_hook=handle1))
    second.apply(second.params, x=torch.from_numpy(X))
    assert evicted == ["first"]


def test_layerwise_casting_hook_storage_and_compute():
    jm, tm = _models()
    jm.params = {"a": jnp.float32(2.3), "b": jnp.float32(3.1)}
    tm.params = {"a": torch.tensor(2.3), "b": torch.tensor(3.1)}
    jh.add_hook_to_module(jm, jh.LayerwiseCastingHook(storage_dtype=jnp.bfloat16,
                                                      compute_dtype=jnp.float32))
    th.add_hook_to_module(tm, th.LayerwiseCastingHook(storage_dtype=torch.bfloat16,
                                                      compute_dtype=torch.float32))
    assert tm.params["a"].dtype == torch.bfloat16  # stored narrow...
    j, t = _run(jm, tm)
    assert t.dtype == np.float32  # ...computed wide
    np.testing.assert_array_equal(t, j)  # the same bf16 values, then one f32 fma order
    np.testing.assert_allclose(t, 2.3 * X + 3.1, atol=0.05)


def test_dequantize_hook_matches_jax_and_dense():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 4)).astype(np.float32)
    x = rng.normal(size=(2, 4)).astype(np.float32)

    class JLinear:
        def apply(self, params, x):
            return x @ params["w"]

    class TLinear:
        def apply(self, params, x):
            return x @ params["w"]

    jm, tm = JLinear(), TLinear()
    jq = jqt({"w": jnp.asarray(w)}, JQConfig(load_in_8bit=True))
    tq = quantize_tree({"w": torch.from_numpy(w)}, QuantizationConfig(load_in_8bit=True))
    jh.add_hook_to_module(jm, jh.DequantizeHook(compute_dtype=jnp.float32))
    th.add_hook_to_module(tm, th.DequantizeHook(compute_dtype=torch.float32))
    j = np.asarray(jm.apply(jq, jnp.asarray(x)))
    t = tm.apply(tq, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)
    np.testing.assert_allclose(t, x @ w, atol=0.1)


def test_no_grad_flag_present_for_parity():
    assert th.ModelHook.no_grad is jh.ModelHook.no_grad is False
