"""Parity of the port's big-model loading and offloaded inference
(``big_modeling.py``, ``utils/modeling.py``, ``utils/offload.py``) with the
JAX package's, on the CPU at ``LlamaConfig.tiny()`` (weights and ids from
numpy, seed ``SEED``).

- Empty init: every leaf on ``meta``, sizes equal to JAX's abstract tree's,
  at Llama-3-8B widths.
- Size helpers, ``infer_auto_device_map`` and ``get_balanced_memory``:
  exactly JAX's on the same tree and budgets (``tpu:i`` read as
  ``cuda:i``).
- Offload folders: written by either package, read by the other bitwise
  (f32, bf16, int8, a 0-d leaf), with the same ``index.json``.
- Checkpoints: a safetensors file written by the JAX package's
  ``safetensors.numpy`` loads bitwise; the port's sharded export loads
  through its index; no ``meta`` leaf is left.
- Dispatch: layers streamed from ``cpu`` and from ``disk``, and spread over
  two card targets: logits within 1e-5 of JAX's ``StreamedScanModel`` (f32;
  other sum orders) and bitwise the port's resident forward (the same ops);
  greedy streamed ``generate`` token-identical to JAX's streamed one and to
  the port's resident one.
- ``cpu_offload``, ``cpu_offload_with_hook``, ``disk_offload``:
  bitwise the resident forward.
- Entry points: ``cuda`` by default, raising here without
  ``main_device="cpu"`` (or ``execution_device="cpu"``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import big_modeling as jbm
from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
from accelerate_tpu.utils import modeling as jmod
from accelerate_tpu.utils import offload as joff
import accelerate_tpu_torch as T
from accelerate_tpu_torch import big_modeling as tbm
from accelerate_tpu_torch.checkpointing import export_full_weights
from accelerate_tpu_torch.models import Llama, LlamaConfig, llama_params_from_numpy
from accelerate_tpu_torch.utils import modeling as tmod
from accelerate_tpu_torch.utils import offload as toff
from accelerate_tpu_torch.utils.tree import flatten_with_paths, map_with_paths, tree_leaves

torch.set_num_threads(2)

SEED = 5
LAYERS_ON = {"cpu": {"embed": "cuda:0", "layers": "cpu", "final_norm": "cuda:0",
                     "lm_head": "cuda:0"},
             "disk": {"embed": "cuda:0", "layers": "disk", "final_norm": "cuda:0",
                      "lm_head": "cuda:0"}}
LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                 rope_theta=500000.0, max_position_embeddings=8192)


def _rename(d, old, new):
    """A map's targets (values) or a budget's targets (keys) renamed."""
    return {k.replace(old, new): v.replace(old, new) if isinstance(v, str) else v
            for k, v in d.items()}


def _jax_map(dmap):
    return _rename(dmap, "cuda", "tpu")


def _port_map(dmap):
    return _rename(dmap, "tpu", "cuda")


def numpy_llama_params(seed: int) -> dict:
    """Tiny Llama weights drawn with numpy (std 1/sqrt(fan-in), norms ones)
    in the tree both packages share, shaped by the port's meta init."""
    with tbm.init_empty_weights():
        meta = Llama(LlamaConfig.tiny(), device="cpu").init_params()
    rng = np.random.default_rng(seed)

    def draw(name, leaf):
        if "norm" in name:
            return np.ones(tuple(leaf.shape), np.float32)
        fan_in = leaf.shape[-2] if leaf.dim() > 1 else 1
        return (rng.standard_normal(tuple(leaf.shape)) / np.sqrt(fan_in)).astype(np.float32)

    return map_with_paths(draw, meta)


@pytest.fixture(scope="module")
def pair():
    numpy_params = numpy_llama_params(SEED)
    jm = JLlama(JConfig.tiny())
    jm.params = jax.tree_util.tree_map(jnp.asarray, numpy_params)
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.params = llama_params_from_numpy(numpy_params, tm.config, device="cpu")
    return jm, tm, numpy_params


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(SEED).integers(1, 256, (2, 10)).astype(np.int32)


@pytest.fixture(scope="module")
def checkpoint(pair, tmp_path_factory):
    """The JAX model written by the JAX package's own safetensors writer."""
    from safetensors.numpy import save_file

    _, _, numpy_params = pair
    path = tmp_path_factory.mktemp("ckpt") / "model.safetensors"
    save_file({k: np.asarray(v) for k, v in jmod.named_parameters(numpy_params).items()},
              str(path), metadata={"format": "np"})
    return path


@pytest.fixture(scope="module")
def jax_streamed(pair, ids):
    """JAX's StreamedScanModel (layers on the host): its logits and its
    greedy streamed tokens, computed once."""
    jm, _, numpy_params = pair
    model = JLlama(jm.config)
    model.params = jax.tree_util.tree_map(jnp.asarray, numpy_params)
    streamed = jbm.dispatch_model(model, _jax_map(LAYERS_ON["cpu"]))
    assert isinstance(streamed, jbm.StreamedScanModel)
    logits = np.asarray(streamed(input_ids=jnp.asarray(ids))["logits"])
    from accelerate_tpu.generation import generate as jgenerate

    tokens = np.asarray(jgenerate(streamed, jnp.asarray(ids), max_new_tokens=6,
                                  cache_dtype=jnp.float32))
    return logits, tokens


def _fresh_empty():
    with tbm.init_empty_weights():
        model = Llama(LlamaConfig.tiny(), device="cpu")
        model.init_params()
    return model


def _resident_logits(tm, ids):
    return tm.apply(tm.params, input_ids=torch.as_tensor(ids))["logits"]


# --------------------------------------------------------------------- empty init
def test_empty_init_is_meta_with_jax_sizes():
    with tbm.init_empty_weights():
        with tbm.init_empty_weights():
            pass
        model = Llama(LlamaConfig(**LLAMA3_8B), device="cpu")
        before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
        params = model.init_params()
    assert {leaf.device.type for leaf in tree_leaves(params)} == {"meta"}
    assert model.device.type == "cpu"  # the model still runs where it was built
    with jbm.init_empty_weights():
        jparams = JLlama(JConfig(**LLAMA3_8B)).init_params()
    assert tmod.compute_module_sizes(params) == jmod.compute_module_sizes(jparams)
    assert tmod.compute_module_sizes(params)[""] == 8030261248 * 4  # 8.03B f32 parameters
    assert tmod.compute_module_sizes(params, dtype=torch.bfloat16) == \
        jmod.compute_module_sizes(jparams, dtype=jnp.bfloat16)
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before
    # Outside the context init is real again; init_on_device builds where asked.
    small = Llama(LlamaConfig.tiny(), device="cpu")
    assert small.init_params(0)["embed"]["weight"].device.type == "cpu"
    with tbm.init_on_device("cpu"):
        assert small.init_params(0)["embed"]["weight"].device.type == "cpu"


# -------------------------------------------------------------------------- sizes
def test_size_helpers_match_jax(pair):
    jm, tm, _ = pair
    for tdtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                           (torch.int8, jnp.int8), ("bool", "bool"), ("int4", "int4")):
        assert tmod.dtype_byte_size(tdtype) == jmod.dtype_byte_size(jdtype)
    for size in ("1KB", "1KiB", "10GB", "6GiB", 512, "2048"):
        assert tmod.convert_file_size_to_int(size) == jmod.convert_file_size_to_int(size)
    with pytest.raises(ValueError):
        tmod.convert_file_size_to_int("notasize")
    assert tmod.compute_module_sizes(tm.params) == jmod.compute_module_sizes(jm.params)
    assert tmod.calculate_maximum_sizes(tm.params) == jmod.calculate_maximum_sizes(jm.params)
    assert tmod.get_top_level_blocks(tm.params) == jmod.get_top_level_blocks(jm.params)
    assert list(tmod.named_parameters(tm.params)) == list(jmod.named_parameters(jm.params))
    w, jw = torch.ones(4, 4), np.ones((4, 4), np.float32)
    tied = {"embed": {"weight": w}, "lm_head": {"weight": w}, "other": torch.zeros(3),
            "view": {"weight": w[:2]}}
    jtied = {"embed": {"weight": jw}, "lm_head": {"weight": jw}, "other": np.zeros(3),
             "view": {"weight": np.ones((2, 4), np.float32)}}
    assert tmod.find_tied_parameters(tied) == jmod.find_tied_parameters(jtied) == \
        [["embed.weight", "lm_head.weight"]]


BUDGETS = {
    "fits": lambda total: {"tpu:0": 10 << 30, "cpu": 10 << 30},
    "spills": lambda total: {"tpu:0": total // 2, "cpu": total // 4},
    "cpu-and-disk": lambda total: {"tpu:0": total // 8, "cpu": total // 8},
    "two-chips": lambda total: {"tpu:0": total // 2, "tpu:1": total, "cpu": 1 << 30},
    "strings": lambda total: {"tpu:0": "200KiB", "cpu": "1MB"},
}


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_device_maps_and_budgets_match_jax(pair, budget):
    jm, tm, _ = pair
    jmem = BUDGETS[budget](jmod.compute_module_sizes(jm.params)[""])
    tmem = _port_map(jmem)
    for kw in ({}, {"dtype": "bfloat16"}, {"special_dtypes": {"embed.weight": "int8"}}):
        jkw = {k: (jnp.bfloat16 if v == "bfloat16" else v) for k, v in kw.items()}
        tkw = {k: (torch.bfloat16 if v == "bfloat16" else v) for k, v in kw.items()}
        jmap = jmod.infer_auto_device_map(jm.params, max_memory=jmem, **jkw)
        tmap = tmod.infer_auto_device_map(tm.params, max_memory=tmem, **tkw)
        assert tmap == _port_map(jmap), (budget, kw)
        tmod.check_device_map(tm.params, tmap)
        for low_zero in (False, True):
            assert tmod.get_balanced_memory(tm.params, max_memory=tmem, low_zero=low_zero,
                                             **tkw) == \
                _port_map(jmod.get_balanced_memory(jm.params, max_memory=jmem,
                                                   low_zero=low_zero, **jkw))
    assert tmod.check_tied_parameters_in_config(tm.params, tmap) == []


def test_tied_blocks_colocate_like_jax():
    w, jw = torch.ones(64, 64), np.ones((64, 64), np.float32)
    params = {"embed": {"weight": w}, "middle": {"w": torch.ones(128, 128)},
              "head": {"weight": w}}
    jparams = {"embed": {"weight": jw}, "middle": {"w": np.ones((128, 128), np.float32)},
               "head": {"weight": jw}}
    nbytes = 64 * 64 * 4 + 128 * 128 * 4
    tmap = tmod.infer_auto_device_map(params, max_memory={"cuda:0": nbytes + 100, "cpu": 1 << 30})
    jmap = jmod.infer_auto_device_map(jparams, max_memory={"tpu:0": nbytes + 100,
                                                           "cpu": 1 << 30})
    assert tmap == _port_map(jmap) and tmap["head"] == tmap["embed"]


def test_max_memory_without_a_card_lists_the_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert list(tmod.get_max_memory()) == ["cpu"]


# ---------------------------------------------------------------------- offload io
def _offload_cases():
    rng = np.random.default_rng(SEED)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {"a.f32": f32, "a.bf16": np.asarray(jnp.asarray(f32, jnp.bfloat16)),
            "b.int8": rng.integers(-128, 127, (4, 2)).astype(np.int8),
            "b.scalar": np.asarray(np.float32(2.5))}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_offload_folders_cross_between_packages(tmp_path):
    cases = _offload_cases()
    joff.offload_state_dict(str(tmp_path / "from_jax"), cases)
    loader = toff.OffloadedWeightsLoader(save_folder=str(tmp_path / "from_jax"))
    assert set(loader) == set(cases)
    for name, value in cases.items():
        np.testing.assert_array_equal(_bits(loader[name]), _bits(value), name)
    tcases = {k: (torch.from_numpy(np.array(v).view(np.int16)).view(torch.bfloat16)
                  if v.dtype.name == "bfloat16" else torch.from_numpy(np.array(v)))
              for k, v in cases.items()}
    toff.offload_state_dict(str(tmp_path / "from_port"), tcases)
    with open(tmp_path / "from_jax" / "index.json") as a, \
            open(tmp_path / "from_port" / "index.json") as b:
        assert json.load(a) == json.load(b)
    jloader = joff.OffloadedWeightsLoader(save_folder=str(tmp_path / "from_port"))
    for name, value in cases.items():
        np.testing.assert_array_equal(_bits(jloader[name]), _bits(value), name)
    prefixed = toff.PrefixedDataset(loader, "a.")
    assert len(prefixed) == 2 and torch.equal(prefixed["f32"], torch.from_numpy(cases["a.f32"]))
    assert set(toff.extract_submodules_state_dict(tcases, ["b"])) == {"b.int8", "b.scalar"}


# --------------------------------------------------------------- checkpoint loading
def test_checkpoints_load_bitwise_without_meta_leaves(pair, checkpoint, tmp_path):
    _, tm, numpy_params = pair
    want = dict(flatten_with_paths(tm.params))
    loaded = tmod.load_checkpoint_in_model(_fresh_empty().params, str(checkpoint), strict=True)
    assert {leaf.device.type for leaf in tree_leaves(loaded)} == {"cpu"}
    for name, leaf in flatten_with_paths(loaded):
        assert torch.equal(leaf, want[name]), name
    # The port's sharded export, read through its index.
    export_full_weights(tm.params, tmp_path / "sharded", max_shard_size="40KB")
    assert (tmp_path / "sharded" / "model.safetensors.index.json").is_file()
    assert len(tmod._resolve_checkpoint_files(str(tmp_path / "sharded"))) > 1
    loaded = tmod.load_checkpoint_in_model(_fresh_empty().params, str(tmp_path / "sharded"))
    for name, leaf in flatten_with_paths(loaded):
        assert torch.equal(leaf, want[name]), name
    # Disk targets are written to the offload folder and left as placeholders.
    loaded = tmod.load_checkpoint_in_model(
        _fresh_empty().params, str(checkpoint), device_map=LAYERS_ON["disk"],
        offload_folder=str(tmp_path / "off"))
    assert loaded["layers"]["attn"]["wq"].device.type == "meta"
    assert loaded["embed"]["weight"].device.type == "cpu"
    loader = toff.OffloadedWeightsLoader(save_folder=str(tmp_path / "off"))
    assert torch.equal(loader["layers.attn.wq"], want["layers.attn.wq"])
    (tmp_path / "model.msgpack").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="msgpack"):
        tmod.load_checkpoint_in_model(_fresh_empty().params, str(tmp_path / "model.msgpack"))


# ------------------------------------------------------------------------ dispatch
@pytest.mark.parametrize("where", ["cpu", "disk"])
def test_streamed_layers_match_jax_and_the_resident_forward(pair, ids, jax_streamed, where,
                                                            tmp_path):
    _, tm, _ = pair
    model = Llama(tm.config, device="cpu")
    model.params = dict(tm.params)
    streamed = T.dispatch_model(model, LAYERS_ON[where], main_device="cpu",
                                offload_dir=str(tmp_path))
    assert isinstance(streamed, tbm.StreamedScanModel)
    got = streamed(input_ids=torch.as_tensor(ids))["logits"]
    np.testing.assert_allclose(got.numpy(), jax_streamed[0], atol=1e-5, rtol=1e-5)
    assert torch.equal(got, _resident_logits(tm, ids))
    layer_bytes = tmod.compute_module_sizes(tm.params)["layers"]
    assert streamed.bytes_streamed == layer_bytes
    out = streamed(input_ids=torch.as_tensor(ids), labels=torch.as_tensor(ids))
    assert torch.isfinite(out["loss"])


def test_streamed_generate_token_identical_to_jax(pair, ids, jax_streamed, tmp_path):
    _, tm, _ = pair
    resident = T.generate(tm, ids, max_new_tokens=6, cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(resident.numpy(), jax_streamed[1])
    for where in ("cpu", "disk"):
        model = Llama(tm.config, device="cpu")
        model.params = dict(tm.params)
        streamed = T.dispatch_model(model, LAYERS_ON[where], main_device="cpu",
                                    offload_dir=str(tmp_path / where))
        toks = T.generate(streamed, ids, max_new_tokens=6, cache_dtype=torch.float32,
                          device="cpu")
        assert torch.equal(toks, resident), where
    with pytest.raises(ValueError, match="matmul_precision"):
        T.generate(streamed, ids, max_new_tokens=2, matmul_precision="int8", device="cpu")
    with pytest.raises(ValueError, match="beam search"):
        T.generate(streamed, ids, max_new_tokens=2, num_beams=2, device="cpu")
    with pytest.raises(ValueError, match="assisted"):
        T.generate(streamed, ids, max_new_tokens=2, assistant_model=tm, device="cpu")


def test_layers_spread_over_two_card_targets(pair, ids):
    """Two card targets: the layers split 1 + 1 over them, the residual
    stream moving between (both resolve to the CPU here)."""
    _, tm, _ = pair
    model = Llama(tm.config, device="cpu")
    model.params = dict(tm.params)
    dmap = {"embed": "cuda:0", "layers": "cuda:0", "final_norm": "cuda:1", "lm_head": "cuda:1"}
    spread = T.dispatch_model(model, dmap, main_device="cpu")
    assert isinstance(spread, tbm.StreamedScanModel)
    assert [s[0] for s in spread.stages] == [(0, 1), (1, 2)]
    assert torch.equal(spread(input_ids=torch.as_tensor(ids))["logits"], _resident_logits(tm, ids))
    toks = T.generate(spread, ids, max_new_tokens=4, cache_dtype=torch.float32, device="cpu")
    assert torch.equal(toks, T.generate(tm, ids, max_new_tokens=4, cache_dtype=torch.float32,
                                        device="cpu"))


def test_load_checkpoint_and_dispatch(pair, ids, checkpoint, tmp_path):
    _, tm, _ = pair
    ref = _resident_logits(tm, ids)
    # "auto" with room on the card: everything resident, no meta leaf left.
    loaded = T.load_checkpoint_and_dispatch(_fresh_empty(), str(checkpoint), device_map="auto",
                                            max_memory={"cuda:0": 1 << 30, "cpu": 1 << 30},
                                            main_device="cpu")
    assert isinstance(loaded, Llama)
    assert set(loaded._at_device_map.values()) == {"cuda:0"}
    assert {leaf.device.type for leaf in tree_leaves(loaded.params)} == {"cpu"}
    assert torch.equal(loaded.apply(loaded.params, input_ids=torch.as_tensor(ids))["logits"], ref)
    # "auto" under the default budget with no card: all host offload, one hook.
    auto = T.load_checkpoint_and_dispatch(_fresh_empty(), str(checkpoint), device_map="auto",
                                          main_device="cpu")
    assert set(auto._at_device_map.values()) == {"cpu"}
    assert torch.equal(auto.apply(auto.params, input_ids=torch.as_tensor(ids))["logits"], ref)
    # A disk map: layers streamed from the offload folder; the only meta
    # leaves are theirs, each in the folder's index.
    streamed = T.load_checkpoint_and_dispatch(_fresh_empty(), str(checkpoint),
                                              device_map=LAYERS_ON["disk"],
                                              offload_folder=str(tmp_path / "off"),
                                              main_device="cpu")
    assert isinstance(streamed, tbm.StreamedScanModel)
    meta = [n for n, leaf in flatten_with_paths(streamed.params) if leaf.device.type == "meta"]
    assert meta and all(n.startswith("layers.") and n in streamed.weights_map for n in meta)
    assert torch.equal(streamed(input_ids=torch.as_tensor(ids))["logits"], ref)


def test_cpu_offload_disk_offload_and_hook_chains(pair, ids, tmp_path):
    _, tm, _ = pair
    ref = _resident_logits(tm, ids)

    def fresh():
        model = Llama(tm.config, device="cpu")
        model.params = dict(tm.params)
        return model

    model = T.cpu_offload(fresh(), execution_device="cpu")
    assert torch.equal(model.apply(model.params, input_ids=torch.as_tensor(ids))["logits"], ref)
    model = T.disk_offload(fresh(), str(tmp_path), execution_device="cpu")
    assert {leaf.device.type for leaf in tree_leaves(model.params)} == {"meta"}
    assert torch.equal(model.apply(model.params, input_ids=torch.as_tensor(ids))["logits"], ref)
    toks = T.generate(model, ids, max_new_tokens=3, cache_dtype=torch.float32, device="cpu")
    assert torch.equal(toks, T.generate(tm, ids, max_new_tokens=3, cache_dtype=torch.float32,
                                        device="cpu"))
    m1, h1 = tbm.cpu_offload_with_hook(fresh(), execution_device="cpu")
    m2, h2 = tbm.cpu_offload_with_hook(fresh(), execution_device="cpu", prev_module_hook=h1)
    out1 = m1.apply(m1.params, input_ids=torch.as_tensor(ids))["logits"]
    out2 = m2.apply(m2.params, input_ids=torch.as_tensor(ids))["logits"]
    assert torch.equal(out1, ref) and torch.equal(out2, ref)
    h2.remove()
    assert m2._at_hook is None


def test_entry_points_default_to_the_card(pair, checkpoint, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the defaults would run on it")
    _, tm, _ = pair
    for build in (
            lambda: T.dispatch_model(_fresh_empty(), LAYERS_ON["cpu"]),
            lambda: T.dispatch_model(_fresh_empty(), {"": "cpu"}),
            lambda: T.load_checkpoint_and_dispatch(_fresh_empty(), str(checkpoint),
                                                   device_map="auto"),
            lambda: T.load_checkpoint_and_dispatch(_fresh_empty(), str(checkpoint)),
            lambda: T.cpu_offload(Llama(tm.config, device="cpu")),
            lambda: T.disk_offload(_fresh_empty(), str(tmp_path)),
            lambda: tbm.cpu_offload_with_hook(Llama(tm.config, device="cpu")),
            lambda: T.init_on_device("cuda").__enter__(),
            lambda: T.Llama(T.LlamaConfig.tiny()),
            lambda: T.ConvNetForImageClassification(T.ConvNetConfig.tiny()),
            # The launcher's entry points (slice 18): a notebook gang and a
            # process of a launched gang (the contract without --cpu).
            lambda: T.notebook_launcher(_noop, num_processes=2),
            lambda: _contract_state()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    from accelerate_tpu_torch.commands import launch

    with pytest.raises(RuntimeError, match="pass --cpu"):  # one process per card: none here
        launch.launch(launch._merge_config(launch.launch_command_parser().parse_args(
            ["script.py"])), ["true"])


def _noop():
    pass


def _contract_state():
    """``PartialState()`` as a launched process makes it: rank 0 of 2, no
    ``ACCELERATE_USE_CPU``."""
    from accelerate_tpu_torch.utils.environment import patch_environment

    with patch_environment(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT="1"):
        saved = os.environ.pop("ACCELERATE_USE_CPU", None)
        try:
            return T.PartialState()
        finally:
            if saved is not None:
                os.environ["ACCELERATE_USE_CPU"] = saved
