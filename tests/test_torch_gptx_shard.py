"""Sharded training of the classic-GPT decoders (GPTX: OPT, GPT-J; GPT-2)
across processes, against the JAX package's step on the same layout.

This file imports JAX only inside the fixtures: the ranks that
``debug_launcher`` spawns import their worker from here.

ONE launch of 4 gloo ranks (once a session, in a thread) runs the cases
in turn from the JAX package's tiny weights (vocab 128, hidden 64, 4
heads, 2 layers; ``sgd(0.1, momentum=0.9)``, clip 1.0; two batches of 4 x
16, the second right-padded with as many tokens in each half of the
rows), while
this process computes the JAX references and runs every case again on
``LoopbackShards(4)``:

- tp 2 x fsdp 2 on OPT (the tied ``wte`` vocab-parallel as embedding and
  head, the learned table at offset 2), GPT-J (the head's bias split over
  tp) and GPT-2; the fused ``w_qkv`` is split by contiguous columns over
  tp, as JAX's plan splits it;
- pp 2 x dp 2 on OPT under 1F1B (the tied ``wte`` on the first and the
  last stage, its gradients summed over pp) and on GPT-2 under GPipe;
- the checkpoint round trip on OPT under tp 2 x fsdp 2: the ranks load an
  unsharded run's checkpoint with ``reshard=True``, train a step and save;
  an unsharded process loads that back.

The optimizer is SGD with momentum, whose update is linear in the
gradient: a sharded gradient counted twice or not at all (a bias added on
every tp rank, the tied ``wte`` summed over pp) moves the parameters by
its size. Adam's first steps are sign-like, so they hide a gradient's
scale, and they turn rounding noise into whole steps where a gradient is 0
in exact arithmetic, as the key bias's is (a constant added to every key
of a query row cancels in the softmax). Pins: the losses of each step and
the parameters after each step within ``1e-5`` of JAX's (f32; the sums
meet in another order on each layout); the loopback's at the same pins
against the ranks'; every rank's parameter bytes those of its own shard
(``state_bytes``); a checkpoint in the full layout, loaded bitwise.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.utils.tree import flatten_with_paths

N_RANKS = 4
LAUNCH_TIMEOUT = 600.0
LR, MOMENTUM = 0.1, 0.9
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-5
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64)
MODELS = {
    "opt": dict(position_style="learned", position_offset=2, parallel_residual=False,
                hidden_act="relu", tie_word_embeddings=True),
    "gptj": dict(position_style="rotary_gptj", rotary_dim=8, shared_layernorm=True,
                 hidden_act="gelu_tanh", attention_bias=False, lm_head_bias=True),
    "gpt2": None,
}
# name: (model, mesh, pipeline schedule or None)
CASES = {
    "opt_tp2xfsdp2": ("opt", dict(tp_size=2, fsdp_size=2, dp_size=1), None),
    "gptj_tp2xfsdp2": ("gptj", dict(tp_size=2, fsdp_size=2, dp_size=1), None),
    "gpt2_tp2xfsdp2": ("gpt2", dict(tp_size=2, fsdp_size=2, dp_size=1), None),
    "opt_pp2xdp2_1f1b": ("opt", dict(pp_size=2, dp_size=2), "1f1b"),
    "gpt2_pp2xdp2_gpipe": ("gpt2", dict(pp_size=2, dp_size=2), "gpipe"),
}


def step_batches():
    rng = np.random.default_rng(17)
    out = []
    for step in range(2):
        ids = rng.integers(0, TINY["vocab_size"], (4, 16)).astype(np.int32)
        batch = {"input_ids": ids, "labels": ids}
        if step == 1:
            mask = np.ones(ids.shape, np.int32)
            mask[1, 10:] = 0
            mask[3, 10:] = 0
            batch["attention_mask"] = mask
        out.append(batch)
    return out


def port_model(kind, params):
    kw = MODELS[kind]
    if kw is None:
        model = T.GPT2(T.GPT2Config(**TINY), device="cpu")
        model.params = T.gpt2_params_from_numpy(params, model.config, device="cpu")
    else:
        model = T.GPTX(T.GPTXConfig(**TINY, **kw), device="cpu")
        model.params = T.gptx_params_from_numpy(params, model.config, device="cpu")
    return model


def port_accelerator(mesh, schedule, loopback=False):
    kw = dict(loopback=T.LoopbackShards(N_RANKS)) if loopback else {}
    if schedule is not None:
        kw["pp_plugin"] = T.PipelineParallelPlugin(mesh["pp_size"], 2, schedule)
    return T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(**mesh), **kw)


def full_params(pm):
    engine = pm.handle.sharded
    if engine is None:
        return {k: v.detach().numpy().copy() for k, v in flatten_with_paths(pm.params)}
    return {layout.path.replace("/", "."): engine.full_leaf(i).numpy().copy()
            for i, layout in enumerate(engine.layouts)}


def run_case(name, params, loopback=False):
    """The case's 2 steps: the losses, the full parameters after each step,
    and this rank's parameter bytes."""
    kind, mesh, schedule = CASES[name]
    acc = port_accelerator(mesh, schedule, loopback)
    pm, po = acc.prepare(port_model(kind, params[kind]), T.sgd(LR, MOMENTUM, device="cpu"))
    step = acc.build_train_step(pm, po)
    saved = {}
    losses = []
    for s, batch in enumerate(step_batches()):
        losses.append(float(step(batch, clip_norm=1.0)))
        saved.update({f"p{s}.{k}": v for k, v in full_params(pm).items()})
    engine = pm.handle.sharded
    saved["losses"] = np.asarray(losses)
    saved["bytes"] = np.asarray(engine.state_bytes(engine.ranks[0])["params"])
    saved["keys"] = np.asarray(repr([layout.key(engine.coord(engine.ranks[0]))
                                     for layout in engine.layouts]))
    return saved


def checkpoint_case(params, load_dir, save_dir):
    kind, mesh, schedule = CASES["opt_tp2xfsdp2"]
    acc = port_accelerator(mesh, schedule)
    pm, po = acc.prepare(port_model(kind, params[kind]), T.sgd(LR, MOMENTUM, device="cpu"))
    step = acc.build_train_step(pm, po)
    acc.load_state(load_dir, reshard=True)
    loaded = full_params(pm)
    step(step_batches()[1], clip_norm=1.0)
    acc.save_state(save_dir)
    return {**{f"l.{k}": v for k, v in loaded.items()},
            **{f"p.{k}": v for k, v in full_params(pm).items()}}


def cases_worker(out_dir: str, params, load_dir: str):
    """One rank: every case, then the checkpoint round trip; one ``.npz`` a
    case and rank."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = Path(out_dir)
    for name in CASES:
        np.savez(out / f"{name}.rank{rank}.npz", **run_case(name, params))
    np.savez(out / f"checkpoint.rank{rank}.npz",
             **checkpoint_case(params, load_dir, str(out / "sharded_ckpt")))


def load_ranks(out_dir, name):
    return [dict(np.load(Path(out_dir) / f"{name}.rank{r}.npz")) for r in range(N_RANKS)]


# --------------------------------------------------------- the JAX reference
def jax_start_params():
    import jax

    from accelerate_tpu.models.gpt2 import GPT2, GPT2Config
    from accelerate_tpu.models.gptx import GPTX, GPTXConfig

    out = {}
    for kind, kw in MODELS.items():
        jm = GPT2(GPT2Config(**TINY)) if kw is None else GPTX(GPTXConfig(**TINY, **kw))
        jm.init_params(jax.random.key(0))
        out[kind] = jax.tree_util.tree_map(np.asarray, jm.params)
    return out


def jax_run(name, params):
    """JAX's fused step on a 4-device mesh of the case's layout: the losses
    and the parameters after each step."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JAccelerator
    from accelerate_tpu.models.gpt2 import GPT2, GPT2Config
    from accelerate_tpu.models.gptx import GPTX, GPTXConfig
    from accelerate_tpu.parallel.mesh import ParallelismConfig as JPC
    from accelerate_tpu.parallel.sharding import path_str
    from accelerate_tpu.state import AcceleratorState, GradientState
    from accelerate_tpu.utils.dataclasses import PipelineParallelPlugin as JPlugin

    class FourDevices(JPC):
        def build_mesh(self, devices=None):
            return super().build_mesh(jax.devices()[:N_RANKS])

    kind, mesh, schedule = CASES[name]
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        acc = JAccelerator(parallelism_config=FourDevices(**mesh), pp_plugin=JPlugin(
            mesh["pp_size"], 2, schedule) if schedule else None)
        kw = MODELS[kind]
        jm = GPT2(GPT2Config(**TINY)) if kw is None else GPTX(GPTXConfig(**TINY, **kw))
        jm.params = jax.tree_util.tree_map(jnp.asarray, params[kind])
        pm, po = acc.prepare(jm, optax.sgd(LR, MOMENTUM))
        step = acc.build_train_step(pm, po)
        record = {"losses": []}
        for s, batch in enumerate(step_batches()):
            record["losses"].append(float(step(batch, clip_norm=1.0)))
            flat = jax.tree_util.tree_flatten_with_path(acc.get_state_dict(pm))[0]
            record.update({f"p{s}.{path_str(p).replace('/', '.')}": np.asarray(v)
                           for p, v in flat})
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    return record


def _launch_and_references(out: Path, params):
    """The launch of the ranks, and meanwhile the unsharded checkpoint they
    load first, JAX's references and the loopback's runs, saved under
    ``out`` (``done`` marks them complete)."""
    # The unsharded run whose checkpoint the ranks load first: accumulation
    # 2 at dp 1 keeps the global batch at the ranks' data degree 2.
    acc = T.Accelerator(device="cpu", gradient_accumulation_steps=2)
    pm, po = acc.prepare(port_model("opt", params["opt"]), T.sgd(LR, MOMENTUM, device="cpu"))
    step = acc.build_train_step(pm, po)
    for batch in step_batches():
        step(batch, clip_norm=1.0)
    acc.save_state(str(out / "unsharded_ckpt"))
    np.savez(out / "unsharded.npz", **full_params(pm))
    failure = []

    def launch():
        try:
            T.debug_launcher(cases_worker, args=(str(out), params, str(out / "unsharded_ckpt")),
                             num_processes=N_RANKS, timeout=LAUNCH_TIMEOUT)
        except Exception as exc:  # re-raised below
            failure.append(exc)

    thread = threading.Thread(target=launch)
    thread.start()
    try:
        for name in CASES:
            np.savez(out / f"jax_{name}.npz", **jax_run(name, params))
            np.savez(out / f"loopback_{name}.npz", **run_case(name, params, loopback=True))
    finally:
        thread.join(timeout=LAUNCH_TIMEOUT + 60)
    assert not thread.is_alive(), "the gloo launch did not return"
    if failure:
        raise failure[0]
    (out / "done").touch()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launch and the references, made once a session: pytest-xdist's
    workers share the parent of their base temp directories, and the first
    to take the lock makes them while the others wait and read them."""
    import fcntl
    import os

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out = root / "gptx_shard"
    params = jax_start_params()
    with open(root / "gptx_shard.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            _launch_and_references(out, params)
    full = {k: np.concatenate([np.ravel(a) for _, a in sorted(flatten_with_paths(t))])
            for k, t in params.items()}
    return {"out": out, "params": params, "full": full,
            "unsharded": dict(np.load(out / "unsharded.npz")),
            "jax": {name: dict(np.load(out / f"jax_{name}.npz")) for name in CASES},
            "loopback": {name: dict(np.load(out / f"loopback_{name}.npz")) for name in CASES}}


def _assert_params(got, want, prefix):
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and sorted(k for k in got if k.startswith(prefix)) == keys
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_train_jaxs_step_on_the_same_layout(runs, name):
    want = runs["jax"][name]
    for rank in load_ranks(runs["out"], name):
        np.testing.assert_allclose(rank["losses"], want["losses"], rtol=LOSS_RTOL)
        for s in range(2):
            _assert_params(rank, want, f"p{s}.")


@pytest.mark.parametrize("name", list(CASES))
def test_loopback_equals_the_gloo_ranks(runs, name):
    want = runs["loopback"][name]
    ranks = load_ranks(runs["out"], name)
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"], rtol=LOSS_RTOL)
    for s in range(2):
        _assert_params(ranks[0], want, f"p{s}.")


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_planned_shard(runs, name):
    """A rank's parameter bytes are its shard's; the distinct shards (one
    per key) add up to the unsharded model's bytes."""
    kind = CASES[name][0]
    ranks = load_ranks(runs["out"], name)
    total = 4 * runs["full"][kind].size
    assert all(int(r["bytes"]) < total for r in ranks)
    if CASES[name][2] is None:  # tp 2 x fsdp 2: every rank holds distinct shards
        assert len({str(r["keys"]) for r in ranks}) == N_RANKS


def test_tp_checkpoint_round_trip_in_the_full_layout(runs):
    """The ranks load the unsharded checkpoint bitwise with
    ``reshard=True``; their checkpoint holds the full layout (the fused
    ``w_qkv`` whole, ``[q | k | v]``), and an unsharded process loads it
    back bitwise."""
    from accelerate_tpu_torch.utils.safetensors_io import load_file

    ranks = load_ranks(runs["out"], "checkpoint")
    for key, value in runs["unsharded"].items():
        for rank in ranks:
            np.testing.assert_array_equal(rank[f"l.{key}"], value, err_msg=key)
    saved = load_file(str(runs["out"] / "sharded_ckpt" / "model" / "arrays.safetensors"))
    assert tuple(saved["layers.attn.w_qkv"].shape) == (2, 64, 192)
    acc = T.Accelerator(device="cpu")
    pm, po = acc.prepare(port_model("opt", runs["params"]["opt"]),
                         T.sgd(LR, MOMENTUM, device="cpu"))
    po._ensure_initialized()
    acc.load_state(str(runs["out"] / "sharded_ckpt"), reshard=True)
    assert acc.gradient_accumulation_steps == 2  # 1 x data 2 becomes 2 x 1
    for key, value in full_params(pm).items():
        np.testing.assert_array_equal(value, ranks[0][f"p.{key}"], err_msg=key)
