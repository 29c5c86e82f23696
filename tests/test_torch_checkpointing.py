"""The port's checkpoints (``checkpointing.py``) against the JAX package's.

Inputs are seeded numpy arrays and the JAX package's random-init weights,
carried across with ``models/from_jax.py``; JAX runs on the 8-device CPU
mesh of ``tests/conftest.py`` (so its batches are 8 rows).

- ``save_model`` both ways: the JAX package's safetensors export loads into
  the port (``load_model_weights``) bitwise and the port's into the JAX
  package's, f32 and bf16 leaves, one file and sharded; the sharded index's
  ``weight_map`` and ``total_size`` are the JAX package's for the same
  ``max_shard_size``; the port's files read with ``safetensors.numpy``.
- Keys: the port's flattened keys of BERT's and Llama's parameters and of
  the ``adamw``, ``inject_hyperparams(adamw)`` and ``sgd(momentum)`` states
  equal the JAX package's ``_flatten_params`` keys, shapes and dtypes.
- Host files: the same prepared objects give the same folder (names),
  ``manifest.json`` items and mesh-record keys, and equal
  ``scheduler.bin``, ``sampler*.bin``, ``optimizer.meta.pkl`` and custom
  pickles after the same steps.
- Resume exactness on the port (tiny BERT with dropout on; a tiny Llama
  through ``build_train_step``): save, load into fresh objects from
  another seed, go on; losses, parameters and moments bitwise an
  uninterrupted run's. And the port's optimizer state after the same steps
  as the JAX package's, read back from both checkpoints: losses within
  ``atol=1e-5`` and parameters within ``5e-5`` (``tests/test_torch_loop.py``'s
  pins: f32 on the CPU, sums in another order, Adam's ``sqrt(v)`` magnifying
  a rounding difference near zero), each moment within 1e-4 of that
  moment's largest magnitude over all leaves (``tests/test_torch_train.py``'s
  pin, taken over the whole moment: the key biases' gradients are zero in
  exact arithmetic, so both sides hold rounding noise of about 1e-13
  there), ``count`` exact.
- The JAX package's checkpoint cases (``tests/test_checkpointing.py``),
  mirrored: round trip, automatic naming and rotation, custom objects, a
  non-blocking save followed by in-place steps, the incomplete-checkpoint
  fallback, a mesh mismatch.
- The ported ``complete_nlp_example``: a resumed run's final accuracy and
  logged ``train_loss`` equal an uninterrupted run's.
"""

import json
import os
import pickle
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import optax
from safetensors.numpy import load_file as st_load_file

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.checkpointing import _flatten_params as j_flatten
from accelerate_tpu.checkpointing import export_full_weights as j_export
from accelerate_tpu.checkpointing import load_model_weights as j_load
from accelerate_tpu.models.bert import BertConfig as JBertConfig
from accelerate_tpu.models.bert import BertForSequenceClassification as JBert
from accelerate_tpu.models.llama import Llama as JLlama
from accelerate_tpu.models.llama import LlamaConfig as JLlamaConfig

import accelerate_tpu_torch as T
from accelerate_tpu_torch import checkpointing as C
from accelerate_tpu_torch.examples import complete_nlp_example
from accelerate_tpu_torch.examples.nlp_example import get_dataloaders
from accelerate_tpu_torch.utils import other
from accelerate_tpu_torch.utils.constants import SAFE_WEIGHTS_INDEX_NAME
from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration
from accelerate_tpu_torch.utils.tree import flatten_with_paths, tree_leaves

torch.set_num_threads(2)

LOSS_ATOL, PARAM_ATOL, MOMENT_RTOL = 1e-5, 5e-5, 1e-4
VOCAB, BATCH, LR = 128, 8, 1e-3


def _jax_bert(dropout=0.0):
    jm = JBert(JBertConfig.tiny(vocab_size=VOCAB, max_position_embeddings=16,
                                hidden_dropout_prob=dropout))
    jm.init_params(jax.random.key(11))
    return jm


def _port_bert(jm=None, dropout=0.0, seed=0):
    tm = T.BertForSequenceClassification(
        T.BertConfig.tiny(vocab_size=VOCAB, max_position_embeddings=16,
                          hidden_dropout_prob=dropout), device="cpu")
    if jm is None:
        tm.init_params(seed)
    else:
        tm.params = T.bert_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                             tm.config, device="cpu")
    return tm


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    """Raw bits of an array or tensor, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _np_params(dtype):
    return jax.tree_util.tree_map(lambda x: np.asarray(x.astype(dtype)), _jax_bert().params)


SHARDS = {"one file": "10GB", "sharded": "20KB"}


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_export_loads_into_the_port_bitwise(tmp_path, dtype, shard):
    params = _np_params(dtype)
    j_export(params, str(tmp_path), max_shard_size=SHARDS[shard])
    assert (tmp_path / SAFE_WEIGHTS_INDEX_NAME).is_file() == (shard == "sharded")
    template = jax.tree_util.tree_map(lambda a: torch.zeros(a.shape, dtype=_to_torch(a).dtype),
                                      params)
    got = C.load_model_weights(tmp_path, template)
    want = j_flatten(params)
    got_flat = dict(flatten_with_paths(got))
    assert list(got_flat) == list(want)
    for k in want:
        assert np.array_equal(_bits(got_flat[k]), _bits(want[k])), k


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_export_loads_into_jax_bitwise(tmp_path, dtype, shard):
    params = _np_params(dtype)
    port_params = jax.tree_util.tree_map(_to_torch, params)
    C.export_full_weights(port_params, str(tmp_path / "port"), max_shard_size=SHARDS[shard])
    j_export(params, str(tmp_path / "jax"), max_shard_size=SHARDS[shard])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    got = j_flatten(j_load(tmp_path / "port", params))
    for k, v in j_flatten(params).items():
        assert np.array_equal(_bits(got[k]), _bits(v)), k
    if shard == "sharded":
        index = {p: json.loads((tmp_path / p / SAFE_WEIGHTS_INDEX_NAME).read_text())
                 for p in ("port", "jax")}
        assert index["port"] == index["jax"]
        assert len(set(index["port"]["weight_map"].values())) > 1
    for name in os.listdir(tmp_path / "port"):
        if name.endswith(".safetensors"):
            for k, v in st_load_file(str(tmp_path / "port" / name)).items():
                assert np.array_equal(_bits(v), _bits(j_flatten(params)[k])), k


def test_save_model_through_both_accelerators(tmp_path):
    """``Accelerator.save_model`` on each side writes the same files, and
    each side's export reads back into the other's model bitwise."""
    jm = _jax_bert()
    tm = _port_bert(jm)
    jacc, acc = JAccelerator(), T.Accelerator(cpu=True)
    jpm, pm = jacc.prepare_model(jm), acc.prepare_model(tm)
    jacc.save_model(jpm, str(tmp_path / "jax"), max_shard_size="50KB")
    acc.save_model(pm, str(tmp_path / "port"), max_shard_size="50KB")
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
    from_jax = C.load_model_weights(tmp_path / "jax", pm.params)
    for a, b in zip(tree_leaves(from_jax), tree_leaves(pm.params)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    from_port = j_load(tmp_path / "port", jacc.get_state_dict(jpm))
    for a, b in zip(jax.tree_util.tree_leaves(from_port), tree_leaves(pm.params)):
        assert np.array_equal(_bits(a), _bits(b))


def test_parameter_keys_match_jax():
    jm = _jax_bert()
    got = [(k, tuple(v.shape)) for k, v in flatten_with_paths(_port_bert(jm).params)]
    assert got == [(k, v.shape) for k, v in j_flatten(jm.params).items()]
    jl = JLlama(JLlamaConfig.tiny())
    jl.init_params(jax.random.key(0))
    tl = T.Llama(T.LlamaConfig.tiny(), device="cpu")
    tl.init_params(0)
    got = [(k, tuple(v.shape)) for k, v in flatten_with_paths(tl.params)]
    assert got == [(k, v.shape) for k, v in j_flatten(jl.params).items()]
    assert len(got) > 8


OPTIMIZERS = {
    "adamw": (lambda: optax.adamw(LR), lambda: T.adamw(LR, device="cpu")),
    "inject_hyperparams(adamw)": (lambda: optax.inject_hyperparams(optax.adamw)(learning_rate=LR),
                                  lambda: T.inject_hyperparams(T.adamw)(learning_rate=LR,
                                                                        device="cpu")),
    "sgd(momentum)": (lambda: optax.sgd(LR, momentum=0.9),
                      lambda: T.sgd(LR, momentum=0.9, device="cpu")),
}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_state_keys_match_jax(name):
    make_jax, make_port = OPTIMIZERS[name]
    jm = _jax_bert()
    tm = _port_bert(jm)
    jstate = j_flatten(make_jax().init(jm.params))
    pstate = [(k, v) for k, v in flatten_with_paths(make_port().init(tm.params))]
    assert [k for k, _ in pstate] == list(jstate)
    for k, v in pstate:
        assert tuple(v.shape) == jstate[k].shape, k
        assert str(v.dtype).replace("torch.", "") == str(jstate[k].dtype), k
    if name == "adamw":
        assert "0.count" in jstate and "0.mu.layers.attn.wq" in jstate


class Counter:
    def __init__(self, n=0):
        self.n = n

    def state_dict(self):
        return {"n": self.n}

    def load_state_dict(self, sd):
        self.n = sd["n"]


def _steps(acc, pm, po, sched, it, n, clip=True):
    """``n`` steps of the canonical loop; returns the losses as floats."""
    losses = []
    for _ in range(n):
        batch = next(it)
        with acc.accumulate(pm):
            out = pm(**batch)
            acc.backward(out["loss"])
            if clip and acc.sync_gradients:
                acc.clip_grad_norm_(pm, 1.0)
            po.step()
            if sched is not None:
                sched.step()
            po.zero_grad()
        loss = out["loss"]
        losses.append(float(loss.detach() if isinstance(loss, torch.Tensor) else loss))
    return losses


def _host(value):
    """A pickle's value for comparison across the packages: a ``jax.Array``
    (none is expected: both packages pickle Python and numpy values) is
    compared as a float."""
    if isinstance(value, jax.Array):
        return float(value)
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    return value


def test_checkpoint_folder_and_host_files_match_jax(tmp_path):
    """The same prepared objects (a model, ``inject_hyperparams(adamw)``, two
    loaders, a linear schedule, a custom object), 3 steps from the same
    weights, batches and torch stream, then ``save_state`` on each side."""
    jm = _jax_bert()
    tm = _port_bert(jm)
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            acc, model, m = JAccelerator(), jm, optax
            tx = optax.inject_hyperparams(optax.adamw)(learning_rate=LR)
        else:
            acc, model, m = T.Accelerator(cpu=True), tm, T
            tx = T.inject_hyperparams(T.adamw)(learning_rate=LR, device="cpu")
        train_dl, eval_dl = get_dataloaders(BATCH, VOCAB, train_size=64, eval_size=16)
        train_dl, eval_dl = acc.prepare(train_dl, eval_dl)
        pm, po, sched = acc.prepare(model, tx, m.linear_schedule(LR, 0.1 * LR, len(train_dl)))
        acc.register_for_checkpointing(Counter(7))
        train_dl.set_epoch(0)
        torch.manual_seed(500)
        _steps(acc, pm, po, sched, iter(train_dl), 3)
        out[pkg] = acc.save_state(str(tmp_path / pkg))
        acc.end_training()
    jdir, pdir = out["jax"], out["port"]
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == sorted([
        "custom_checkpoint_0.pkl", "manifest.json", "model", "optimizer", "optimizer.meta.pkl",
        "random_states_0.pkl", "sampler.bin", "sampler_1.bin", "scheduler.bin"])
    manifests = [json.loads(open(os.path.join(d, "manifest.json")).read()) for d in (jdir, pdir)]
    assert manifests[0]["items"] == manifests[1]["items"] == ["model", "optimizer"]
    assert sorted(manifests[0]["mesh"]) == sorted(manifests[1]["mesh"])
    for name in ("scheduler.bin", "sampler.bin", "sampler_1.bin", "optimizer.meta.pkl",
                 "custom_checkpoint_0.pkl"):
        j, p = (pickle.load(open(os.path.join(d, name), "rb")) for d in (jdir, pdir))
        assert _host(p) == _host(j), name
    sampler = pickle.load(open(os.path.join(pdir, "sampler.bin"), "rb"))
    assert sampler["num_batches_fetched"] == 3 and sampler["sampler_rng"][0] == "torch_global"
    rng = pickle.load(open(os.path.join(pdir, "random_states_0.pkl"), "rb"))
    assert set(rng) == {"python", "numpy", "step", "model_0_generator"}
    assert os.listdir(os.path.join(pdir, "model")) == [C.PAYLOAD_NAME]


def test_optimizer_state_after_k_steps_matches_jax(tmp_path):
    """Constant adamw, 3 steps from the same weights and batches; each
    side's optimizer state read back from its own checkpoint."""
    jm = _jax_bert()
    tm = _port_bert(jm)
    losses, states = {}, {}
    for pkg in ("jax", "port"):
        acc = JAccelerator() if pkg == "jax" else T.Accelerator(cpu=True)
        tx = optax.adamw(LR) if pkg == "jax" else T.adamw(LR, device="cpu")
        train_dl, _ = get_dataloaders(BATCH, VOCAB, train_size=64, eval_size=8)
        train_dl = acc.prepare(train_dl)
        pm, po = acc.prepare(jm if pkg == "jax" else tm, tx)
        train_dl.set_epoch(0)
        torch.manual_seed(501)
        losses[pkg] = _steps(acc, pm, po, None, iter(train_dl), 3)
        path = acc.save_state(str(tmp_path / pkg))
        if pkg == "jax":
            states[pkg] = {k: np.asarray(v) for k, v in j_flatten(po.opt_state).items()}
            states["jax_params"] = {k: np.asarray(v)
                                    for k, v in j_flatten(acc.get_state_dict(pm)).items()}
        else:
            states[pkg] = {k: v.numpy() for k, v in
                           other.load(os.path.join(path, "optimizer",
                                                           C.PAYLOAD_NAME)).items()}
            states["port_params"] = {k: v.numpy() for k, v in other.load(
                os.path.join(path, "model", C.PAYLOAD_NAME)).items()}
        acc.end_training()
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=LOSS_ATOL, rtol=0)
    assert list(states["port"]) == list(states["jax"])
    assert int(states["port"]["0.count"]) == int(states["jax"]["0.count"]) == 3
    scale = {m: max(float(np.abs(v).max()) for k, v in states["jax"].items()
                    if k.startswith(f"0.{m}.")) for m in ("mu", "nu")}
    for k, want in states["jax"].items():
        tol = MOMENT_RTOL * scale[k.split(".")[1]] if want.ndim else 0
        np.testing.assert_allclose(states["port"][k], want, atol=tol, rtol=0, err_msg=k)
    for k, want in states["jax_params"].items():
        np.testing.assert_allclose(states["port_params"][k], want, atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)


# ------------------------------------------------------------ resume exactness
def _bert_run(seed, kind, project=None):
    """Fresh objects for a resume case on a tiny BERT with dropout 0.1."""
    accum = 2 if kind == "accumulation 2" else 1
    acc = T.Accelerator(cpu=True, gradient_accumulation_steps=accum, project_config=project)
    T.set_seed(0, device="cpu")
    model = _port_bert(dropout=0.1, seed=seed)
    train_dl, _ = get_dataloaders(BATCH, VOCAB, train_size=96, eval_size=8)
    train_dl = acc.prepare(train_dl)
    if kind == "inject_hyperparams(adamw) + linear_schedule":
        pm, po, sched = acc.prepare(model, T.inject_hyperparams(T.adamw)(learning_rate=LR,
                                                                       device="cpu"),
                                    T.linear_schedule(LR, 0.1 * LR, len(train_dl)))
    else:
        (pm, po), sched = acc.prepare(model, T.adamw(LR, device="cpu")), None
    train_dl.set_epoch(0)
    return acc, pm, po, sched, train_dl


def _state(pm, po):
    return [t.clone() for t in tree_leaves(pm.params)] + [
        v.clone() for _, v in flatten_with_paths(po.opt_state) if isinstance(v, torch.Tensor)]


def _llama_run(seed):
    acc = T.Accelerator(cpu=True)
    model = T.Llama(T.LlamaConfig.tiny(), device="cpu")
    model.init_params(seed)
    pm, po = acc.prepare(model, T.adamw(LR, device="cpu"))
    return acc, pm, po, acc.build_train_step(pm, po)


RESUME_CASES = ("adamw", "inject_hyperparams(adamw) + linear_schedule", "accumulation 2",
                "build_train_step (Llama)")


@pytest.mark.parametrize("kind", RESUME_CASES)
def test_save_load_and_continue_is_bitwise_an_uninterrupted_run(tmp_path, kind):
    total, at = 8, 4  # at a sync boundary under accumulation 2
    if kind.startswith("build_train_step"):
        rng = np.random.default_rng(3)
        batches = [rng.integers(1, 256, (2, 16)).astype(np.int32) for _ in range(total)]

        def go(step, lo, hi):
            return [float(step({"input_ids": b, "labels": b}, clip_norm=1.0))
                    for b in batches[lo:hi]]

        acc, pm, po, step = _llama_run(0)
        want = go(step, 0, total)
        want_state = _state(pm, po)
        acc, pm, po, step = _llama_run(0)
        first = go(step, 0, at)
        acc.save_state(str(tmp_path / "ck"))
        acc, pm, po, step = _llama_run(1)  # built before the load: it sees the loaded state
        acc.load_state(str(tmp_path / "ck"))
        got = first + go(step, at, total)
    else:
        acc, pm, po, sched, dl = _bert_run(0, kind)
        want = _steps(acc, pm, po, sched, iter(dl), total)
        want_state = _state(pm, po)
        acc, pm, po, sched, dl = _bert_run(0, kind)
        first = _steps(acc, pm, po, sched, iter(dl), at)
        acc.save_state(str(tmp_path / "ck"))
        saved = _state(pm, po)
        acc, pm, po, sched, dl = _bert_run(1, kind)
        acc.load_state(str(tmp_path / "ck"))
        assert all(torch.equal(a, b) for a, b in zip(_state(pm, po), saved))
        got = first + _steps(acc, pm, po, sched, iter(dl), total - at)
        if sched is not None:
            assert sched.step_count == total and po.learning_rate == sched.get_last_lr()[0]
    assert got == want
    got_state = _state(pm, po)
    assert len(got_state) == len(want_state)
    assert all(torch.equal(a, b) for a, b in zip(got_state, want_state))


# ------------------------------------------------ the JAX package's cases
def test_save_load_state_roundtrip(tmp_path):
    acc, pm, po, sched, dl = _bert_run(0, "inject_hyperparams(adamw) + linear_schedule")
    _steps(acc, pm, po, sched, iter(dl), 3)
    saved = acc.get_state_dict(pm)
    saved_opt = _state(pm, po)
    out = acc.save_state(str(tmp_path / "ckpt"))
    assert os.path.isdir(out)
    with torch.no_grad():
        for p in tree_leaves(pm.params):
            p.fill_(123.0)
        for v in tree_leaves(po.opt_state.inner_state[0].mu):
            v.zero_()
    sched.step_count, acc.step = 0, 99
    acc.load_state(str(tmp_path / "ckpt"))
    for a, b in zip(tree_leaves(acc.get_state_dict(pm)), tree_leaves(saved)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(_state(pm, po), saved_opt))
    assert sched.step_count == 3 and acc.step == 3


def test_automatic_checkpoint_naming_and_rotation(tmp_path):
    cfg = ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True,
                               total_limit=2)
    acc = T.Accelerator(cpu=True, project_config=cfg)
    acc.prepare(_port_bert(), T.sgd(0.1, device="cpu"))
    for _ in range(3):
        acc.save_state()
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_1", "checkpoint_2"]
    assert acc.iteration == 3
    with pytest.raises(ValueError, match="output_dir required"):
        T.Accelerator(cpu=True).save_state()


def test_register_for_checkpointing_custom_object(tmp_path):
    acc = T.Accelerator(cpu=True)
    acc.prepare_model(_port_bert())
    c = Counter(7)
    acc.register_for_checkpointing(c)
    acc.save_state(str(tmp_path / "ck"))
    c.n = 0
    acc.load_state(str(tmp_path / "ck"))
    assert c.n == 7
    with pytest.raises(ValueError, match="state_dict"):
        acc.register_for_checkpointing(object())


def test_nonblocking_save_holds_the_save_time_values(tmp_path):
    """``blocking=False`` returns before the files are written; the fused
    update's plain version then changes the parameters and moments in place,
    and the checkpoint still holds the values of the save."""
    acc, pm, po, sched, dl = _bert_run(0, "adamw")
    it = iter(dl)
    _steps(acc, pm, po, sched, it, 2)
    saved = _state(pm, po)
    acc.save_state(str(tmp_path / "ck"), blocking=False)
    _steps(acc, pm, po, sched, it, 2)
    assert not all(torch.equal(a, b) for a, b in zip(_state(pm, po), saved))
    acc.finish_pending_saves()
    acc, pm, po, sched, dl = _bert_run(1, "adamw")
    acc.load_state(str(tmp_path / "ck"))
    assert all(torch.equal(a, b) for a, b in zip(_state(pm, po), saved))


def test_partial_checkpoint_fallback(tmp_path):
    """The newest ``checkpoint_<i>`` left incomplete (an item missing, a
    temporary directory left): ``load_state()`` resumes the one before,
    deletes the incomplete one and names the next save after the one it
    loaded."""
    cfg = ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True)
    acc, pm, po, sched, dl = _bert_run(0, "adamw", project=cfg)
    it = iter(dl)
    _steps(acc, pm, po, sched, it, 1)
    acc.save_state()
    good = _state(pm, po)
    _steps(acc, pm, po, sched, it, 1)
    acc.save_state()
    ckpt1 = tmp_path / "checkpoints" / "checkpoint_1"
    shutil.rmtree(ckpt1 / "model")
    (ckpt1 / f"model.{C.TMP_MARK}-123").mkdir()
    with torch.no_grad():
        for p in tree_leaves(pm.params):
            p.fill_(7.0)
    assert acc.load_state().endswith("checkpoint_0")
    assert all(torch.equal(a, b) for a, b in zip(_state(pm, po), good))
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_0"]
    assert acc.iteration == 1


def test_mesh_mismatch_raises_without_reshard(tmp_path):
    acc = T.Accelerator(cpu=True, gradient_accumulation_steps=2)
    pm, po = acc.prepare(_port_bert(), T.adamw(LR, device="cpu"))
    step = acc.build_train_step(pm, po)
    path = acc.save_state(str(tmp_path / "ck"))
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert manifest["mesh"] == {"axes": {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1},
                                "process_count": 1,
                                "data_parallel": 1, "gradient_accumulation_steps": 2,
                                "zero_sharding": False}
    manifest["mesh"].update(axes={"dp": 2, "sp": 1}, process_count=2, data_parallel=2)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(RuntimeError, match="resharding is required"):
        acc.load_state(path)
    acc.load_state(path, reshard=True)
    assert acc.gradient_accumulation_steps == 4  # 2 x dp 2 / dp 1: the global batch kept
    with pytest.raises(RuntimeError, match="build the step again"):
        step({"input_ids": np.ones((1, 4), np.int32), "labels": np.zeros((1,), np.int32)})


def test_fp16_scale_in_a_checkpoint_raises(tmp_path):
    """The fp16 scaler is ported: a checkpoint's scale no longer raises. An
    fp16 accelerator writes its scale to ``optimizer.meta.pkl`` and loads it
    back; one without the scaler ignores it, as the JAX package does."""
    acc = T.Accelerator(cpu=True, mixed_precision="fp16")
    _, po = acc.prepare(_port_bert(), T.adamw(LR, device="cpu"))
    po.scaler.scale = 1024.0
    path = acc.save_state(str(tmp_path / "ck"))
    with open(os.path.join(path, "optimizer.meta.pkl"), "rb") as f:
        assert pickle.load(f) == {"step_count": 0, "scale": 1024.0}
    with open(os.path.join(path, "optimizer.meta.pkl"), "wb") as f:
        pickle.dump({"step_count": 0, "scale": 65536.0}, f)
    acc.load_state(path)
    assert po.scaler.scale == 65536.0
    plain = T.Accelerator(cpu=True)
    _, po_plain = plain.prepare(_port_bert(), T.adamw(LR, device="cpu"))
    plain.load_state(path)
    assert po_plain.scaler is None and po_plain.state_dict()["scale"] is None


# ------------------------------------------------------ the complete example
def test_complete_example_resumes_mid_epoch_as_an_uninterrupted_run(tmp_path):
    """``--checkpointing_steps 4`` on one run; a second run resumes from
    step 20 (mid-epoch 0 of 32 steps) and reaches the same final accuracy
    and the same logged records of the epochs after the resumed one."""
    common = ["--cpu", "--num_epochs", "2", "--batch_size", "64", "--with_tracking"]
    full = tmp_path / "full"
    acc_full = complete_nlp_example.main(common + ["--checkpointing_steps", "4",
                                                   "--output_dir", str(full)])
    assert sorted(os.listdir(full))[:3] == ["logs", "step_12", "step_16"]
    resumed = tmp_path / "resumed"
    shutil.copytree(full / "step_20", resumed / "step_20")
    acc_resumed = complete_nlp_example.main(common + ["--resume_from_checkpoint",
                                                      str(resumed / "step_20"),
                                                      "--output_dir", str(resumed)])
    assert acc_resumed == acc_full

    def records(root):
        path = root / "logs" / "complete_nlp_example" / "metrics.jsonl"
        return [{k: v for k, v in json.loads(line).items() if k != "_time"}
                for line in path.read_text().splitlines()]

    want, got = records(full), records(resumed)
    assert [r["_step"] for r in got] == [r["_step"] for r in want] == [32, 64]
    assert got[-1] == want[-1]  # epoch 1: every step after the resume
    assert got[0]["accuracy"] == want[0]["accuracy"]


# --------------------------------------------------------------- utils/other
def test_other_helpers_match_jax(tmp_path):
    from accelerate_tpu.utils import other as J

    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "b": np.array([1, 2], np.int32)}
    J.save(tree, str(tmp_path / "jax.safetensors"), safe_serialization=True)
    other.save(jax.tree_util.tree_map(torch.from_numpy, tree), str(tmp_path / "port.safetensors"),
               safe_serialization=True)
    for name in ("jax", "port"):
        for load in (J.load, other.load):
            got = load(str(tmp_path / f"{name}.safetensors"))
            assert sorted(got) == ["a.w", "b"]
            assert np.array_equal(np.asarray(got["a.w"]), tree["a"]["w"])
    other.save({"x": torch.ones(2)}, str(tmp_path / "obj.pkl"))
    assert torch.equal(other.load(tmp_path / "obj.pkl")["x"], torch.ones(2))
    assert other.merge_dicts({"a": {"b": 1}, "c": 2}, {"a": {"d": 3}}) == \
        J.merge_dicts({"a": {"b": 1}, "c": 2}, {"a": {"d": 3}})
    for n in (0, 1023, 1024, 5 * 2**20, 3 * 2**50):
        assert other.convert_bytes(n) == J.convert_bytes(n)
    assert other.get_pretty_name(Counter) == J.get_pretty_name(Counter) == "Counter"
    assert other.get_pretty_name(Counter()) == J.get_pretty_name(Counter())
    other.save_json({"b": 1, "a": [2]}, tmp_path / "p.json")
    J.save_json({"b": 1, "a": [2]}, tmp_path / "j.json")
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    assert other.load_json(tmp_path / "j.json") == {"a": [2], "b": 1}
    path = other.write_basic_config("bf16", save_location=str(tmp_path / "cfg.yaml"))
    assert json.loads(path.read_text())["mixed_precision"] == "bf16"
    assert other.write_basic_config(save_location=str(tmp_path / "cfg.yaml")) is False
    acc = T.Accelerator(cpu=True)
    model = _port_bert()
    assert other.extract_model_from_parallel(acc.prepare_model(model)) is model
    assert isinstance(other.is_port_in_use(0), bool)
    other.check_os_kernel()
