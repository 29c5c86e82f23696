"""The port's CLI (``accelerate_tpu_torch/commands/``) against the JAX
package's (``accelerate_tpu/commands/``), on the CPU:

- config files: a file written by either package's ``ClusterConfig`` loads
  into the other's with the same fields (yaml and json; a yaml file without
  ``pyyaml`` raises);
- the launch contract: for the same configuration the ``ACCELERATE_*`` keys
  the port reads equal those of the JAX ``prepare_launch_env``, bitwise; the
  rank keys of 2 machines x 2 processes; flags over the config; every field
  and flag the port cannot honour raises by name; ``ep_size`` in a config
  and ``--ep_size`` reach ``ACCELERATE_MESH_SHAPE`` as JAX's;
- ``estimate-memory``: the bytes equal the JAX package's
  ``abstract_param_bytes`` exactly (presets and config.json files, Mixtral
  among them, with Mixtral-8x7B's 46,702,792,704 parameters), and the
  families not ported raise;
- ``merge-weights`` of a ``save_state`` folder: bitwise the model's state
  dict, in the JAX ``export_full_weights`` file names and index;
- one launched gang of 2 gloo ranks running the bundled test script, and
  one gang whose failing rank's exit code comes back within 30 s.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu.checkpointing import export_full_weights as j_export
from accelerate_tpu.commands import config_args as jconfig
from accelerate_tpu.commands.estimate import abstract_param_bytes as j_bytes
from accelerate_tpu.commands.launch import prepare_launch_env as j_env
from accelerate_tpu_torch.commands import config as tconfig
from accelerate_tpu_torch.commands import config_args as tconfig_args
from accelerate_tpu_torch.commands import estimate as testimate
from accelerate_tpu_torch.commands import launch as tlaunch
from accelerate_tpu_torch.commands.env import env_command
from accelerate_tpu_torch.commands.merge import merge_weights
from accelerate_tpu_torch.utils.constants import ENV_PREFIX, HONOURED_ENV
from accelerate_tpu_torch.utils.safetensors_io import load_file
from accelerate_tpu_torch.utils.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
PYTHON_ENV = dict(os.environ, PYTHONPATH=str(ROOT))

# Every field the port honours set away from its default, and some of the
# tri-state ones the port raises for, so a round trip moves real values.
FIELDS = dict(num_machines=2, machine_rank=1, num_processes=4, main_process_ip="10.1.2.3",
              main_process_port=1234, mixed_precision="bf16", use_cpu=True, debug=True,
              dp_size=2, fsdp_size=2, tp_size=2, pp_size=2, sp_size=1, max_restarts=2,
              gradient_accumulation_steps=4, fsdp_min_shard_size=4096, fsdp_cpu_offload=True,
              pp_schedule="1f1b", pp_microbatches=8, project_dir="/tmp/proj",
              checkpoint_total_limit=3, checkpoint_auto_naming=True, log_with="json,csv",
              train_window=4, zero_sharding=False, elastic=True, telemetry=False,
              xla_preset="latency", spike_zscore=5.5, kernels="off")


@pytest.fixture
def clean_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith(ENV_PREFIX):
            monkeypatch.delenv(key)


def _fields(cfg) -> dict:
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__ if f != "extra"}


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_config_files_cross_between_the_packages(tmp_path, fmt):
    jcfg = jconfig.ClusterConfig(distributed_type="MULTI_GPU", **FIELDS)
    path = str(tmp_path / f"jax.{fmt}")
    getattr(jcfg, f"to_{fmt}_file")(path)
    port = tconfig_args.load_config_from_file(path)
    assert port.extra == {} and _fields(port) == _fields(jcfg)
    tcfg = tconfig_args.ClusterConfig(**FIELDS)
    path = str(tmp_path / f"port.{fmt}")
    getattr(tcfg, f"to_{fmt}_file")(path)
    back = jconfig.load_config_from_file(path)
    assert back.extra == {} and _fields(back) == _fields(tcfg)
    assert set(_fields(tcfg)) == set(_fields(jcfg))  # the same fields, by name


def test_yaml_config_without_pyyaml_raises_and_json_still_works(tmp_path, monkeypatch):
    cfg = tconfig_args.ClusterConfig(**FIELDS)
    cfg.to_yaml_file(str(tmp_path / "cfg.yaml"))
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    with pytest.raises(ImportError, match="pyyaml"):
        tconfig_args.load_config_from_file(str(tmp_path / "cfg.yaml"))
    with pytest.raises(ImportError, match="pyyaml"):
        cfg.to_yaml_file(str(tmp_path / "new.yaml"))
    assert not (tmp_path / "new.yaml").exists()
    cfg.to_json_file(str(tmp_path / "cfg.json"))
    assert _fields(tconfig_args.load_config_from_file(str(tmp_path / "cfg.json"))) == _fields(cfg)


def test_default_config_and_the_wizard(tmp_path, monkeypatch):
    path = tconfig.write_default_config(str(tmp_path / "default.yaml"))
    cfg = tconfig_args.load_config_from_file(path)
    assert _fields(cfg) == _fields(tconfig_args.ClusterConfig())
    # The wizard's plain prompts (no terminal): CPU, 1 machine, 2 ranks, dp 0,
    # fsdp 2, tp, pp, sp and ep 1, fsdp options, then defaults, accumulation
    # 2, bf16.
    answers = iter(["yes", "1", "2", "0", "2", "1", "1", "1", "1", "yes", "4096", "yes", "2",
                    "no", "no", "no", "bf16"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    got = tconfig.get_user_input()
    assert (got.use_cpu, got.num_processes, got.fsdp_size, got.fsdp_min_shard_size,
            got.fsdp_cpu_offload, got.gradient_accumulation_steps, got.mixed_precision,
            got.distributed_type) == (True, 2, 2, 4096, True, 2, "bf16", "MULTI_CPU")
    tconfig_args.check_ported(got)  # the wizard asks only what the port honours


CONTRACT_CASES = {
    "default": {},
    "cpu_bf16_debug_mesh": dict(use_cpu=True, mixed_precision="bf16", debug=True, dp_size=2,
                                fsdp_size=2, tp_size=2, pp_size=2),
    "features": dict(mixed_precision="fp16", gradient_accumulation_steps=4,
                     fsdp_min_shard_size=4096, fsdp_cpu_offload=True, pp_schedule="1f1b",
                     pp_microbatches=8, project_dir="/tmp/p", checkpoint_total_limit=2,
                     checkpoint_auto_naming=True, log_with="json", train_window=4,
                     zero_sharding=True),
    "explicit_defaults": dict(train_window=1, zero_sharding=False, mixed_precision="fp8"),
    "ep_mesh": dict(use_cpu=True, dp_size=2, ep_size=2, tp_size=2),
}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
@pytest.mark.parametrize("attempt", [0, 2])
def test_launch_env_keys_equal_jax_prepare_launch_env(clean_env, monkeypatch, case, attempt):
    monkeypatch.setenv("ACCELERATE_TRAIN_WINDOW", "9")  # an inherited value, scrubbed by 1
    kw = dict(CONTRACT_CASES[case], num_processes=2)
    jenv = j_env(jconfig.ClusterConfig(**kw), process_id=1, attempt=attempt)
    tenv = tlaunch.prepare_launch_env(tconfig_args.ClusterConfig(**kw), local_rank=1,
                                      attempt=attempt)
    ours = {k: v for k, v in tenv.items() if k.startswith(ENV_PREFIX)}
    assert set(ours) <= set(HONOURED_ENV)
    assert ours == {k: jenv[k] for k in HONOURED_ENV if k in jenv}
    assert str(ROOT) in tenv["PYTHONPATH"].split(os.pathsep)


@pytest.mark.parametrize("machine_rank", [0, 1])
def test_rank_keys_of_two_machines_of_two_processes(clean_env, machine_rank):
    cfg = tconfig_args.ClusterConfig(num_machines=2, machine_rank=machine_rank, num_processes=2,
                                     main_process_ip="10.0.0.1", main_process_port=1234)
    for local in range(2):
        env = tlaunch.prepare_launch_env(cfg, local_rank=local)
        assert {k: env[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
                                    "MASTER_ADDR", "MASTER_PORT")} == {
            "RANK": str(2 * machine_rank + local), "LOCAL_RANK": str(local), "WORLD_SIZE": "4",
            "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234"}


def test_flags_override_the_config(tmp_path):
    path = tmp_path / "cfg.yaml"
    tconfig_args.ClusterConfig(mixed_precision="no", tp_size=1, num_processes=3,
                               use_cpu=True).to_yaml_file(str(path))
    args = tlaunch.launch_command_parser().parse_args(
        ["--config_file", str(path), "--mixed_precision", "bf16", "--tp_size", "2",
         "--no-zero_sharding", "script.py", "--lr", "1"])
    cfg = tlaunch._merge_config(args)
    assert (cfg.mixed_precision, cfg.tp_size, cfg.num_processes, cfg.use_cpu,
            cfg.zero_sharding) == ("bf16", 2, 3, True, False)
    assert tlaunch.script_command(args)[1:] == [tlaunch.RANK_SCRIPT, "script.py", "--lr", "1"]
    args = tlaunch.launch_command_parser().parse_args(["--cpu", "-m", "pkg.mod"])
    assert tlaunch._merge_config(args).num_processes is None  # every card, or 1 on the CPU
    assert tlaunch.script_command(args)[1:] == [tlaunch.RANK_SCRIPT, "-m", "pkg.mod"]


UNPORTED_VALUES = {
    "compute_environment": "TPU_POD", "cpu_virtual_devices": 8, "downcast_bf16": True,
    "compile_cache_dir": "/tmp/c", "xla_preset": "off", "dcn_size": 2,
    "handle_preemption": True, "fault_plan": "step:3=kill", "elastic": False,
    "min_data_parallel": 2, "guard_numerics": True, "spike_zscore": 0.0, "hang_timeout": 5.0,
    "telemetry": True, "metrics_port": 9000, "straggler_threshold": 2.0,
    "fleet_metrics": False, "slo_step_time": 0.0, "journal_dir": "", "trace_ring": 0,
    "flight_ring": 8, "profile_steps": "off", "profile_slow_zscore": 3.0, "slo_ttft": 1.0,
    "slo_tpot": 0.1, "speculative_k": 0, "draft_model": "tiny", "kv_quant": "int8",
    "serving_role": "unified", "router_endpoint": "", "serving_retry_budget": 1.0,
    "serving_lease_ttl": 2.0, "drain_grace_s": 3.0, "tune_budget": 0, "kernels": "off",
}


def test_every_unported_field_has_a_case():
    assert set(UNPORTED_VALUES) == set(tconfig_args.UNPORTED_FIELDS)


@pytest.mark.parametrize("field", sorted(UNPORTED_VALUES))
def test_unported_config_fields_raise_by_name(tmp_path, field):
    path = tmp_path / "cfg.json"
    jconfig.ClusterConfig(**{field: UNPORTED_VALUES[field]}).to_json_file(str(path))
    args = tlaunch.launch_command_parser().parse_args(
        ["--config_file", str(path), "--cpu", "script.py"])
    with pytest.raises(NotImplementedError, match=f"`{field}`.*ROADMAP.md|`{field}`.*kernels"):
        tlaunch.launch(tlaunch._merge_config(args), ["true"])


@pytest.mark.parametrize("flags", [["--xla_preset", "latency"], ["--telemetry"],
                                   ["--no-elastic"], ["--handle_preemption"],
                                   ["--kernels", "off"], ["--metrics_port", "9000"],
                                   ["--dcn_size", "4"],
                                   ["--cpu_virtual_devices", "8"]])
def test_unported_flags_raise_by_name(flags):
    args = tlaunch.launch_command_parser().parse_args(["--cpu", *flags, "script.py"])
    name = flags[0].lstrip("-").removeprefix("no-")
    with pytest.raises(NotImplementedError, match=f"`{name}`"):
        tlaunch.launch(tlaunch._merge_config(args), ["true"])


def test_unknown_keys_and_bad_values_raise(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("mixed_precision: bf16\nfuture_knob: 7\n")
    args = tlaunch.launch_command_parser().parse_args(["--config_file", str(path), "x.py"])
    with pytest.raises(NotImplementedError, match="future_knob"):
        tlaunch.launch(tlaunch._merge_config(args), ["true"])
    for bad, match in ((dict(max_restarts=1, num_machines=2), "single-machine"),
                       (dict(mixed_precision="fp4"), "mixed_precision"),
                       (dict(max_restarts=-1), "max_restarts")):
        with pytest.raises(ValueError, match=match):
            tlaunch.launch(tconfig_args.ClusterConfig(use_cpu=True, **bad), ["true"])


SHARED_PRESETS = ["tiny", "llama-7b", "llama-13b", "llama-70b", "bert-base", "bert-large",
                  "gpt-j-6b", "gpt-neox-20b", "opt-30b"]


@pytest.mark.parametrize("preset", SHARED_PRESETS)
def test_estimate_bytes_equal_jax_presets(preset):
    assert testimate.abstract_param_bytes(preset) == j_bytes(preset)


# The port's own presets, as the config.json the JAX package reads.
CONFIG_FILES = {
    "llama-3-8b": dict(model_type="llama", **testimate.PRESETS["llama-3-8b"][1]),
    "gemma-2-9b": dict(model_type="gemma2", **testimate.PRESETS["gemma-2-9b"][1]),
    "qwen2-small": dict(model_type="qwen2", vocab_size=1000, hidden_size=128,
                        intermediate_size=344, num_hidden_layers=3, num_attention_heads=4,
                        num_key_value_heads=2, tie_word_embeddings=True),
    "mistral-by-architecture": dict(architectures=["MistralForCausalLM"], vocab_size=512,
                                    hidden_size=64, intermediate_size=160,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    num_key_value_heads=1, sliding_window=32),
    "bert-small": dict(model_type="bert", vocab_size=500, hidden_size=64,
                       num_hidden_layers=2, num_attention_heads=4, intermediate_size=128),
    # mistralai/Mixtral-8x7B-v0.1's published config.json (its size keys).
    "mixtral-8x7b": dict(architectures=["MixtralForCausalLM"], model_type="mixtral",
                         vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                         num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                         num_local_experts=8, num_experts_per_tok=2, rope_theta=1e6,
                         rms_norm_eps=1e-5, router_aux_loss_coef=0.02,
                         max_position_embeddings=32768, tie_word_embeddings=False,
                         sliding_window=None),
    "mixtral-small": dict(model_type="mixtral", vocab_size=300, hidden_size=64,
                          intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2),
    # openai-community/gpt2-xl's published config.json (its size keys).
    "gpt2-xl": dict(model_type="gpt2", vocab_size=50257, n_embd=1600, n_layer=48, n_head=25,
                    n_positions=1024),
    # EleutherAI/pythia-6.9b's published config.json (its size keys).
    "pythia-6.9b": dict(architectures=["GPTNeoXForCausalLM"], vocab_size=50432,
                        hidden_size=4096, intermediate_size=16384, num_hidden_layers=32,
                        num_attention_heads=32, rotary_pct=0.25, max_position_embeddings=2048,
                        use_parallel_residual=True, tie_word_embeddings=False),
    "gptj-small": dict(model_type="gptj", vocab_size=400, n_embd=64, n_layer=2, n_head=4,
                       rotary_dim=8),
    "opt-small": dict(architectures=["OPTForCausalLM"], vocab_size=400, hidden_size=64,
                      ffn_dim=128, num_hidden_layers=2, num_attention_heads=4,
                      max_position_embeddings=64),
    "phi3-small": dict(model_type="phi3", vocab_size=400, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2),
}


@pytest.mark.parametrize("name", sorted(CONFIG_FILES))
def test_estimate_bytes_equal_jax_config_files(tmp_path, name):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(CONFIG_FILES[name]))
    want = j_bytes(str(path))
    assert testimate.abstract_param_bytes(str(path)) == want
    if name in testimate.PRESETS:
        assert testimate.abstract_param_bytes(name) == want


def test_estimate_table_and_the_families_not_ported(tmp_path, monkeypatch, capsys):
    n = T.Llama(T.LlamaConfig.llama3_8b(), device="cpu").num_params()
    args = testimate.estimate_command_parser().parse_args(["llama-3-8b", "--dtypes", "bf16"])
    rows, largest = testimate.gather_data(args)
    assert rows[0][2] == 2 * n and largest[1] == "layers"
    testimate.estimate_command(args)
    assert "bf16" in capsys.readouterr().out
    for preset in testimate.UNPORTED_PRESETS:
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            testimate.abstract_param_bytes(preset)
    path = tmp_path / "config.json"
    for model_type in ("t5", "whisper", "vit"):
        path.write_text(json.dumps({"model_type": model_type, "d_model": 64}))
        with pytest.raises(NotImplementedError, match=f"{model_type}.*Queue 1 item 8"):
            testimate.abstract_param_bytes(str(path))
    # A Hub id resolves from the local cache only.
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    with pytest.raises(ValueError, match="pass its path instead"):
        testimate.abstract_param_bytes("org/model")
    snapshot = tmp_path / "hub" / "models--org--model" / "snapshots" / "abc123"
    snapshot.mkdir(parents=True)
    (snapshot / "config.json").write_text(json.dumps(CONFIG_FILES["qwen2-small"]))
    (tmp_path / "hub" / "models--org--model" / "refs").mkdir()
    (tmp_path / "hub" / "models--org--model" / "refs" / "main").write_text("abc123")
    assert testimate.abstract_param_bytes("org/model") == testimate.abstract_param_bytes(
        str(snapshot / "config.json"))


def test_ep_size_in_the_config_and_the_launch_flag(clean_env, tmp_path):
    """``ep_size`` is a config field the wizard writes and a launch flag;
    both export JAX's ``ACCELERATE_MESH_SHAPE``."""
    path = tmp_path / "cfg.yaml"
    tconfig_args.ClusterConfig(use_cpu=True, num_processes=4, ep_size=2).to_yaml_file(str(path))
    cfg = tconfig_args.load_config_from_file(str(path))
    assert cfg.ep_size == 2
    tconfig_args.check_ported(cfg)
    args = tlaunch.launch_command_parser().parse_args(
        ["--config_file", str(path), "--ep_size", "4", "--dp_size", "1", "script.py"])
    merged = tlaunch._merge_config(args)
    assert (merged.ep_size, merged.dp_size) == (4, 1)
    tenv = tlaunch.prepare_launch_env(merged, local_rank=0)
    jenv = j_env(jconfig.ClusterConfig(**{k: getattr(merged, k) for k in (
        "use_cpu", "num_processes", "ep_size", "dp_size")}), process_id=0)
    assert tenv["ACCELERATE_MESH_SHAPE"] == jenv["ACCELERATE_MESH_SHAPE"]
    assert "ep:4" in tenv["ACCELERATE_MESH_SHAPE"].split(",")


# The JAX package's classic-GPT presets: parameters, and bf16 bytes = 2 x
# parameters (counted by the JAX package's GPTX.num_params).
CLASSIC_GPT_PARAMS = {"gpt-j-6b": 6_050_882_784, "gpt-neox-20b": 20_554_567_680,
                      "opt-30b": 29_974_540_288}


@pytest.mark.parametrize("preset", sorted(CLASSIC_GPT_PARAMS))
def test_estimate_of_the_classic_gpt_presets(preset):
    from accelerate_tpu.commands import estimate as jestimate
    from accelerate_tpu.models import GPTX as JGPTX, GPTXConfig as JGPTXConfig

    family, kw = testimate.PRESETS[preset]
    n = T.GPTX(T.GPTXConfig(**kw), device="cpu").num_params()
    assert family == "gptx" and jestimate.PRESETS[preset] == (family, kw)
    assert n == JGPTX(JGPTXConfig(**kw)).num_params() == CLASSIC_GPT_PARAMS[preset]
    args = testimate.estimate_command_parser().parse_args([preset, "--dtypes", "bf16"])
    rows, _ = testimate.gather_data(args)
    assert rows[0][2] == 2 * n


def test_estimate_of_mixtral_8x7b(tmp_path, capsys):
    """Mixtral-8x7B: ``MoELlama.num_params``' 46,702,792,704 parameters,
    93.41 GB in bf16, the JAX package's count."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps(CONFIG_FILES["mixtral-8x7b"]))
    n = T.MoELlama(T.mixtral_config_from_hf(CONFIG_FILES["mixtral-8x7b"]),
                   device="cpu").num_params()
    assert n == 46_702_792_704
    args = testimate.estimate_command_parser().parse_args([str(path), "--dtypes", "bf16"])
    rows, _ = testimate.gather_data(args)
    assert rows[0][2] == 2 * n == j_bytes(str(path)) // 2
    testimate.estimate_command(args)
    assert "bf16" in capsys.readouterr().out


@pytest.mark.parametrize("shard", ["10GB", "40KB"])
def test_merge_weights_of_save_state_is_the_state_dict(tmp_path, shard):
    cfg = T.LlamaConfig.tiny()
    acc = T.Accelerator(device="cpu")
    model = T.Llama(cfg, device="cpu")
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(1e-2, device="cpu"))
    step = acc.build_train_step(pm, po)
    ids = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    step({"input_ids": ids, "labels": ids})
    acc.save_state(str(tmp_path / "ckpt"))
    merge_weights(str(tmp_path / "ckpt"), str(tmp_path / "out"), max_shard_size=shard)
    state = dict(flatten_with_paths(acc.get_state_dict(pm)))
    jax_dir = tmp_path / "jax"
    j_export(_nested({k: v.numpy() for k, v in state.items()}), str(jax_dir),
             max_shard_size=shard)
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == sorted(os.listdir(jax_dir)) and (len(names) > 1) == (shard == "40KB")
    merged = {}
    for name in names:
        if name.endswith(".safetensors"):
            merged.update(load_file(tmp_path / "out" / name))
        else:
            assert json.loads((tmp_path / "out" / name).read_text()) == json.loads(
                (jax_dir / name).read_text())
    assert sorted(merged) == sorted(state)
    for key, value in state.items():
        assert merged[key].dtype == value.dtype and torch.equal(merged[key], value), key
    with pytest.raises(NotImplementedError, match="msgpack"):
        merge_weights(str(tmp_path / "ckpt" / "model"), str(tmp_path / "x"),
                      safe_serialization=False)


def _nested(flat: dict) -> dict:
    out = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def test_env_command_reports_torch_and_the_config(tmp_path, capsys):
    path = tmp_path / "cfg.yaml"
    tconfig_args.ClusterConfig(mixed_precision="bf16").to_yaml_file(str(path))
    env_command(type("Args", (), {"config_file": str(path)})())
    out = capsys.readouterr().out
    assert f"PyTorch version: {torch.__version__}" in out and "mixed_precision: bf16" in out
    assert "nvcc:" in out and "Cards (nvidia-smi name, power limit):" in out


def _cli(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli",
                           *args], cwd=ROOT, env=PYTHON_ENV, capture_output=True, text=True,
                          timeout=timeout)


def test_launch_cpu_gang_runs_the_test_script():
    out = _cli("launch", "--cpu", "--num_processes", "2", "-m",
               "accelerate_tpu_torch.test_utils.test_script")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "state ok: 2 processes" in out.stdout
    assert "All distributed asserts passed." in out.stdout


def test_launch_fails_fast_with_the_failing_rank_code(tmp_path):
    # Rank 1 joins the group through PartialState and exits 3 while rank 0
    # waits for it in a collective: rank 1 must leave at once (no wait for
    # its peers at exit), and its code must come back.
    script = tmp_path / "gang.py"
    script.write_text("import os, sys\n"
                      "import torch.distributed as dist\n"
                      "from accelerate_tpu_torch.state import PartialState\n"
                      "PartialState()\n"
                      "if os.environ['RANK'] == '1':\n    sys.exit(3)\n"
                      "dist.barrier()\n")
    t0 = time.monotonic()
    out = _cli("launch", "--cpu", "--num_processes", "2", str(script), timeout=120)
    assert out.returncode == 3 and time.monotonic() - t0 < 30, out.stderr[-2000:]
