"""``prepare_pippy`` on the CPU against the JAX package's: the counterparts
of ``tests/test_inference.py``'s 10 tests. The port's model carries the
JAX model's weights (``llama_params_from_numpy``); the JAX side runs on the
conftest's 8 virtual CPU devices, one stage a device, and the port's stages
all lie on the CPU (a model on ``device="cpu"``). Outputs at the same
``split_points`` agree to 2e-5 (f32, the layers in another order of
summation)."""

import numpy as np
import pytest
import torch

import jax

from accelerate_tpu.inference import prepare_pippy as j_prepare_pippy
from accelerate_tpu.models import Llama as JLlama, LlamaConfig as JConfig

import accelerate_tpu_torch as T
from accelerate_tpu_torch.inference import generate_device_map
from accelerate_tpu_torch.models import llama_params_from_numpy

ATOL = 2e-5


def _models(num_layers=4):
    jm = JLlama(JConfig.tiny(num_hidden_layers=num_layers))
    jm.init_params(jax.random.key(0))
    tm = T.Llama(T.LlamaConfig.tiny(num_hidden_layers=num_layers), device="cpu")
    tm.params = llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                        tm.config, device="cpu")
    return jm, tm


def _ids(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_generate_device_map_even():
    assert generate_device_map(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]


def test_generate_device_map_uneven():
    assert generate_device_map(7, 3) == [(0, 3), (3, 5), (5, 7)]


def test_generate_device_map_errors():
    with pytest.raises(ValueError):
        generate_device_map(2, 4)
    with pytest.raises(ValueError):
        generate_device_map(4, 0)


def test_pippy_matches_unpipelined_and_jax():
    jm, tm = _models()
    ids = _ids(0, (4, 8), tm.config.vocab_size)
    want = tm.apply(tm.params, input_ids=torch.as_tensor(ids))["logits"]
    piped = T.prepare_pippy(tm, split_points=2, num_chunks=2)
    got = piped(input_ids=torch.as_tensor(ids))["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    jgot = j_prepare_pippy(jm, split_points=2, num_chunks=2)(input_ids=ids)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0, atol=ATOL)


def test_pippy_auto_split_uses_devices():
    """``"auto"`` makes one stage a local device: the cards of a CUDA model,
    the CPU (one stage) for a CPU model; the JAX package's, one a virtual
    device."""
    jm, tm = _models(num_layers=8)
    piped = T.prepare_pippy(tm)
    assert len(piped.stage_layers) == 1 and piped.stage_ranges == [(0, 8)]
    jpiped = j_prepare_pippy(jm)
    assert len(jpiped.stage_layers) == min(len(jax.local_devices()), 8)
    ids = _ids(3, (2, 8), tm.config.vocab_size)
    np.testing.assert_allclose(piped(input_ids=torch.as_tensor(ids))["logits"].numpy(),
                               np.asarray(jpiped(input_ids=ids)["logits"]), rtol=0, atol=ATOL)


def test_pippy_explicit_split_points():
    jm, tm = _models(num_layers=4)
    piped = T.prepare_pippy(tm, split_points=[1, 3])
    assert piped.stage_ranges == [(0, 1), (1, 3), (3, 4)]
    assert [tuple(t.shape[0] for t in [s["attn"]["wq"]]) for s in piped.stage_layers] == \
        [(1,), (2,), (1,)]
    ids = _ids(1, (2, 8), tm.config.vocab_size)
    want = tm.apply(tm.params, input_ids=torch.as_tensor(ids))["logits"]
    got = piped(input_ids=torch.as_tensor(ids))["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    jgot = j_prepare_pippy(jm, split_points=[1, 3])(input_ids=ids)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0, atol=ATOL)


def test_pippy_loss_microbatching():
    """With labels each chunk's loss is its own mean and the output their
    mean, as in the JAX package."""
    jm, tm = _models()
    ids = _ids(2, (4, 8), tm.config.vocab_size)
    want = float(tm.apply(tm.params, input_ids=torch.as_tensor(ids),
                          labels=torch.as_tensor(ids))["loss"])
    piped = T.prepare_pippy(tm, split_points=2, num_chunks=2)
    got = float(piped(input_ids=torch.as_tensor(ids), labels=torch.as_tensor(ids))["loss"])
    assert abs(got - want) < 1e-3, (got, want)
    jgot = float(j_prepare_pippy(jm, split_points=2, num_chunks=2)(input_ids=ids,
                                                                    labels=ids)["loss"])
    assert abs(got - jgot) < ATOL, (got, jgot)


def test_pippy_batch_divisibility_error():
    _, tm = _models()
    piped = T.prepare_pippy(tm, split_points=2, num_chunks=4)
    with pytest.raises(ValueError, match="divisible"):
        piped(input_ids=torch.zeros((6, 8), dtype=torch.int32))


def test_pippy_train_mode_rejected():
    _, tm = _models()
    piped = T.prepare_pippy(tm, split_points=2)
    with pytest.raises(RuntimeError):
        piped.train()
    assert piped.eval() is piped
    with pytest.raises(ValueError, match="staged"):
        piped.apply({"other": None}, input_ids=torch.zeros((2, 8), dtype=torch.int32))


def test_pippy_gather_output():
    """``gather_output=True`` puts the output on the first stage's device;
    without it, it stays on the last stage's. More stages than cards raise
    for a CUDA model, as the JAX package's do for its devices."""
    jm, tm = _models()
    ids = _ids(4, (2, 8), tm.config.vocab_size)
    piped = T.prepare_pippy(tm, split_points=2, gather_output=True)
    out = piped(input_ids=torch.as_tensor(ids))["logits"]
    assert out.device == piped.devices[0]
    jout = j_prepare_pippy(jm, split_points=2, gather_output=True)(input_ids=ids)["logits"]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    from accelerate_tpu_torch.inference import PipelinedModel

    cards = [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="stages"):
        PipelinedModel(tm, 2, cards, 2, False)
