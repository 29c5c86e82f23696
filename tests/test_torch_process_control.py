"""The process-control surface of the port's ``PartialState`` and
``Accelerator`` against the JAX package's, on the CPU:

- ``split_between_processes`` equals the JAX method slice for slice, for
  2, 3 and 4 processes at every index, on a list, an array, a tensor (held
  to JAX's array result) and a dict, with and without ``apply_padding``:
  both methods are called unbound on a stand-in ``self`` that carries
  ``num_processes`` and ``process_index``;
- the ``on_*`` decorators run on the ranks the JAX ones run on;
- the launch contract: ``ACCELERATE_MIXED_PRECISION``, ``ACCELERATE_USE_CPU``,
  ``ACCELERATE_DEBUG_MODE`` and ``ACCELERATE_GRADIENT_ACCUMULATION_STEPS``
  with the JAX package's precedence; ``GradientAccumulationPlugin``;
  ``autocast`` and ``AutocastKwargs``; ``join_uneven_inputs``;
- one ``debug_launcher`` spawn of 2 gloo ranks: ``set_trigger`` /
  ``check_trigger``, ``main_process_first`` and ``local_main_process_first``
  (the main rank's block ends before the other's starts), the debug-mode
  shape check, and ``notebook_launcher`` inline.
"""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import GradientAccumulationPlugin as JPlugin
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu_torch.state import ProcessView
from accelerate_tpu_torch.utils.constants import ENV_PREFIX

torch.set_num_threads(2)


@pytest.fixture
def clean_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith(ENV_PREFIX):
            monkeypatch.delenv(key)


def _split(cls, inputs, n, i, pad):
    stub = SimpleNamespace(num_processes=n, process_index=i)
    with cls.split_between_processes(stub, inputs, apply_padding=pad) as shard:
        return shard


def _same(port, jax_side):
    if isinstance(jax_side, dict):
        assert set(port) == set(jax_side)
        for k in jax_side:
            _same(port[k], jax_side[k])
    elif isinstance(jax_side, np.ndarray):
        got = port.numpy() if isinstance(port, torch.Tensor) else port
        assert isinstance(got, np.ndarray) and got.dtype == jax_side.dtype
        np.testing.assert_array_equal(got, jax_side)
    else:
        assert type(port) is type(jax_side) and port == jax_side


KINDS = {
    "list": lambda m: (list(range(m)), list(range(m))),
    "array": lambda m: (np.arange(2 * m, dtype=np.float32).reshape(m, 2),) * 2,
    "tensor": lambda m: (torch.arange(3 * m, dtype=torch.int64).reshape(m, 3),
                         np.arange(3 * m, dtype=np.int64).reshape(m, 3)),
    "dict": lambda m: ({"a": list(range(m)), "b": np.arange(m, dtype=np.int32) * 7},) * 2,
}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n", [2, 3, 4])
def test_split_between_processes_equals_jax(n, kind):
    for length in range(0, 2 * n + 2):
        port_in, jax_in = KINDS[kind](length)
        for pad in (False, True):
            for i in range(n):
                got = _split(ProcessView, port_in, n, i, pad)
                want = _split(JPartialState, jax_in, n, i, pad)
                _same(got, want)
                if kind == "tensor":
                    assert isinstance(got, torch.Tensor)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_on_process_decorators_run_where_jax_runs(n):
    for rank in range(n):
        for local in (0, 1):
            flags = dict(num_processes=n, process_index=rank, local_process_index=local,
                         is_main_process=rank == 0, is_local_main_process=local == 0,
                         is_last_process=rank == n - 1)
            port = ProcessView.__new__(ProcessView)
            port.process_index, port.num_processes = rank, n
            port.local_process_index = local
            jstub = SimpleNamespace(**flags)
            for name, extra in (("on_main_process", {}), ("on_local_main_process", {}),
                                ("on_last_process", {}), ("on_process", {"process_index": 1}),
                                ("on_local_process", {"local_process_index": 1})):
                got = getattr(port, name)(lambda: "ran", **extra)()
                want = getattr(JPartialState, name)(jstub, lambda: "ran", **extra)()
                assert got == want, (name, flags)
            assert port.is_last_process == flags["is_last_process"]


def test_contract_keys_reach_the_state(clean_env, monkeypatch):
    monkeypatch.setenv("ACCELERATE_USE_CPU", "1")  # no device argument: the CPU, gloo
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "bf16")
    monkeypatch.setenv("ACCELERATE_DEBUG_MODE", "1")
    acc = T.Accelerator()
    assert acc.device.type == "cpu" and acc.mixed_precision == "bf16"
    assert acc.state.partial.debug is True
    assert T.Accelerator(mixed_precision="no").mixed_precision == "no"  # an argument wins
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "fp4")
    with pytest.raises(ValueError, match="fp4"):
        T.Accelerator()


@pytest.mark.parametrize("env_steps", [None, "4"])
@pytest.mark.parametrize("kw", ["none", "steps1", "steps3", "plugin", "both"])
def test_gradient_accumulation_precedence_equals_jax(clean_env, monkeypatch, env_steps, kw):
    if env_steps is not None:
        monkeypatch.setenv("ACCELERATE_GRADIENT_ACCUMULATION_STEPS", env_steps)

    def args(plugin_cls):
        return {"none": {}, "steps1": dict(gradient_accumulation_steps=1),
                "steps3": dict(gradient_accumulation_steps=3),
                "plugin": dict(gradient_accumulation_plugin=plugin_cls(num_steps=2)),
                "both": dict(gradient_accumulation_steps=3,
                             gradient_accumulation_plugin=plugin_cls(num_steps=2))}[kw]

    def outcome(make):
        try:
            acc = make()
        except ValueError as err:
            return "raises" if "only pass one" in str(err) else err
        return acc.gradient_accumulation_steps, acc.gradient_state.sync_with_dataloader

    want = outcome(lambda: JAccelerator(cpu=True, **args(JPlugin)))
    got = outcome(lambda: T.Accelerator(device="cpu", **args(T.GradientAccumulationPlugin)))
    assert got == want


def test_plugin_sync_with_dataloader_and_autocast(clean_env):
    plugin = T.GradientAccumulationPlugin(num_steps=2, sync_with_dataloader=False)
    acc = T.Accelerator(device="cpu", mixed_precision="bf16",
                        gradient_accumulation_plugin=plugin)
    assert acc.gradient_state.sync_with_dataloader is False
    model = T.Llama(T.LlamaConfig.tiny(), device="cpu")
    model.init_params(0)
    assert acc.prepare(model).handle.compute_dtype == torch.bfloat16
    with acc.autocast(T.AutocastKwargs(enabled=False)):
        assert acc.prepare(model).handle.compute_dtype == torch.float32
    assert acc.autocast_handler is None
    acc2 = T.Accelerator(device="cpu", mixed_precision="bf16",
                         kwargs_handlers=[T.AutocastKwargs(enabled=False)])
    assert acc2.prepare(model).handle.compute_dtype == torch.float32
    with acc.join_uneven_inputs([model]):  # the loaders even the tail already
        pass


def test_notebook_launcher_inline_and_refusals(clean_env, monkeypatch):
    # Let monkeypatch restore the precision key that notebook_launcher sets.
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "no")
    monkeypatch.delenv("ACCELERATE_MIXED_PRECISION")
    seen = []
    T.notebook_launcher(lambda x: seen.append((x, os.environ["ACCELERATE_MIXED_PRECISION"])),
                        args=(7,), mixed_precision="bf16")
    assert seen == [(7, "bf16")]
    with pytest.raises(ValueError, match="fp4"):
        T.notebook_launcher(lambda: None, mixed_precision="fp4")


def process_control_ranks(out_dir: str):
    """Each gloo rank: triggers, the *_first controls, the debug-mode shape
    check and split_between_processes with the gathered result; writes its
    findings as JSON."""
    from accelerate_tpu_torch.utils.operations import DistributedOperationException, gather
    from accelerate_tpu_torch.utils.operations import gather_object

    os.environ["ACCELERATE_DEBUG_MODE"] = "1"  # the state turns debug mode on
    acc = T.Accelerator(device="cpu")
    rank = acc.process_index
    found = {"rank": rank, "n": acc.num_processes, "last": acc.is_last_process}
    # Nobody set a flag: nothing fires. Rank 1 sets one: it fires once, for all.
    found["quiet"] = acc.check_trigger()
    if rank == 1:
        acc.set_trigger()
    found["fired"] = acc.check_trigger()
    found["cleared"] = acc.check_trigger()
    # main_process_first: rank 0's block ends before rank 1's starts.
    for name, ctx in (("main", acc.main_process_first), ("local", acc.local_main_process_first)):
        with ctx():
            found[f"{name}_in"] = time.time()
            time.sleep(0.3 if rank == 0 else 0.0)
            found[f"{name}_out"] = time.time()
    with acc.split_between_processes(list(range(5)), apply_padding=True) as shard:
        found["split"] = gather_object(list(shard))
    try:
        gather(torch.zeros(rank + 1))
        found["debug"] = "no error"
    except DistributedOperationException as err:
        found["debug"] = str(err)
    found["after"] = gather(torch.full((2,), float(rank))).tolist()  # the group still works
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)


def test_process_control_over_two_gloo_ranks(tmp_path):
    T.debug_launcher(process_control_ranks, args=(str(tmp_path),), num_processes=2)
    r0, r1 = (json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2))
    for r in (r0, r1):
        assert (r["quiet"], r["fired"], r["cleared"]) == (False, True, False)
        assert r["split"] == [0, 1, 2, 3, 4, 4]  # 3 + 2, the short share padded
        assert "shapes/dtypes mismatch" in r["debug"] and "(1,)" in r["debug"]
        assert r["after"] == [0.0, 0.0, 1.0, 1.0]
    assert (r0["last"], r1["last"]) == (False, True)
    for name in ("main", "local"):
        assert r0[f"{name}_out"] <= r1[f"{name}_in"]
