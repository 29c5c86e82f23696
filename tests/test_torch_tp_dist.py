"""The port's tensor parallelism (the tp axis, alone and with dp, fsdp and
ZeRO) across processes, and on four cards; the case machinery that
``tests/test_torch_ulysses.py`` also runs its Ulysses cases through.

This file imports JAX only inside the CPU tests' fixtures: the ranks that
``debug_launcher`` spawns import their worker function from here, and the
card's machine, which has no JAX, runs its ``cuda`` tests
(``python -m pytest tests/test_torch_tp_dist.py -m cuda --noconftest``).

On the CPU, ONE launch of 4 gloo ranks (a module fixture, in a thread) runs
the cases in turn, each from the JAX package's tiny Llama weights (4
heads, 2 KV heads, head width 16; ``adamw(3e-4)``, clip 1.0; the second
batch padded with as many tokens in each half of the rows), while this
process computes the JAX references:

- the fused step, 3 steps, on tp 2 (dp 2, from ``ACCELERATE_MESH_SHAPE``),
  tp 4 (``TensorParallelPlugin``: the KV projection's columns end in the
  middle of a head), tp 2 x fsdp 2 (``MegatronStylePlugin``) and dp 2 x
  tp 2 with ZeRO, against JAX's fused step on a 4-device mesh of the same
  layout: the losses (rtol 1e-5) and every parameter after 3 steps (rtol
  1e-3, atol 1e-5), the pins of ``tests/test_torch_fsdp_dist.py``; and
  every leaf's gradient of the first batch (the buffer of an accumulation-2
  micro-step) against ``jax.grad`` of the JAX model's loss (rtol 1e-4, atol
  1e-6);
- the imperative loop (``model(**rows)``, ``backward``,
  ``clip_grad_norm_``, ``step``) under tp 2 x fsdp 2, each rank passing its
  data rank's rows, against JAX's fused step on that mesh (the halves of
  the padded batch hold as many targets, so the mean of the data ranks'
  means is the global mean);
- fp16 in the fused step on tp 2 x fsdp 2 with step 2 poisoned (the scale
  set to 2**60 on both sides, so every fp16 gradient overflows), against
  JAX's fp16 imperative loop on the same mesh: the same skips and scales on
  every rank, the losses within ``FP16_LOSS_ATOL``, the parameters at
  ``tests/test_torch_grad_scaler.py``'s pins, and no update on the skipped
  step on any rank (the optimizer's count stays);
- the checkpoint round trip: an unsharded run saves, the tp 2 x fsdp 2
  ranks load it with ``reshard=True`` bitwise, train and save, and an
  unsharded process loads that back bitwise.

``cuda``-marked, skipped on hosts with fewer than four cards: Llama-3-8B
with all 32 layers under NCCL tp 4 with remat (1 x 4096 tokens: step time,
MFU, memory a card), NCCL tp 2 x fsdp 2 against ``LoopbackShards(4)`` at 4
layers, Ulysses sp 4 over NCCL against its loopback, the imperative loop
under sp 4 (ring) over NCCL against the fused sp step, and fp16 in the
fused step under NCCL fsdp 4 against its loopback.
"""

import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.parallel.fsdp import LoopbackShards
from accelerate_tpu_torch.utils.tree import flatten_with_paths, tree_leaves

N_RANKS = 4
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
           num_key_value_heads=2, num_hidden_layers=2)
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LR = 3e-4
# fp16: tests/test_torch_grad_scaler.py's parameter pins and reasons; the
# losses at 5e-4, since JAX's own fp16 loops on dp 4 and on tp 2 x fsdp 2
# differ by 2.9e-4 on the third step of these batches (fp16 partial sums
# meet in another order on each layout).
FP16_LOSS_ATOL = 5e-4
FP16_SCALES = (2.0**10, 2.0**60, 2.0**10)  # set before each step: step 2 overflows
LAUNCH_TIMEOUT = 600.0  # seconds for a file's one launch of gloo ranks

# name: (the JAX mesh, how the port's Accelerator is built, model config, ZeRO)
FUSED = {
    "tp2": (dict(tp_size=2, dp_size=2), "env", {}, False),
    "tp4": (dict(tp_size=4, dp_size=1), "tp_plugin", {}, False),
    "tp2xfsdp2": (dict(tp_size=2, fsdp_size=2, dp_size=1), "megatron", {}, False),
    "dp2xtp2_zero": (dict(tp_size=2, dp_size=2), "config", {}, True),
    "sp4_ulysses": (dict(sp_size=4, dp_size=1), "ulysses_plugin", {}, False),
    "sp2xtp2_ulysses": (dict(sp_size=2, tp_size=2, dp_size=1), "config",
                        dict(attention_impl="ulysses"), False),
}
# name: (the mesh, model config); each held to JAX's fused step on the mesh.
IMPERATIVE = {
    "tp2xfsdp2": (dict(tp_size=2, fsdp_size=2, dp_size=1), {}),
    "dp2xsp2_ring": (dict(sp_size=2, dp_size=2), dict(attention_impl="ring")),
    "dp2xsp2_ulysses": (dict(sp_size=2, dp_size=2), dict(attention_impl="ulysses")),
    "sp2xtp2_ulysses": (dict(sp_size=2, tp_size=2, dp_size=1), dict(attention_impl="ulysses")),
}
# This file's cases; tests/test_torch_ulysses.py runs the sp ones.
TP_FUSED = ("tp2", "tp4", "tp2xfsdp2", "dp2xtp2_zero")
TP_CASES = tuple(("fused", n) for n in TP_FUSED) + (("imperative", "tp2xfsdp2"), ("fp16", None),
                                                   ("checkpoint", None), ("loader", "tp2xfsdp2"),
                                                   ("loader", "dp2xsp2_ring"))


def step_batches():
    """Three global batches of 4 x 16 ids; the second has right padding in
    rows 1 and 3, as many tokens in each half, so that under dp 2 the mean
    of the two data ranks' means is the global mean (the imperative loop
    averages the ranks' means, the fused step takes the global one)."""
    rng = np.random.default_rng(11)
    out = []
    for step in range(3):
        ids = rng.integers(0, CFG["vocab_size"], (4, 16)).astype(np.int32)
        batch = {"input_ids": ids, "labels": ids}
        if step == 1:
            mask = np.ones(ids.shape, np.int32)
            mask[1, 9:] = 0
            mask[3, 9:] = 0
            batch["attention_mask"] = mask
        out.append(batch)
    return out


def _port_accelerator(mesh: dict, how: str, **kw):
    """The Accelerator of ``mesh`` through one of the entry points."""
    if how == "env":
        os.environ["ACCELERATE_MESH_SHAPE"] = ",".join(
            f"{a[:-5]}:{n}" for a, n in mesh.items())
        try:
            return T.Accelerator(device="cpu", **kw)
        finally:
            del os.environ["ACCELERATE_MESH_SHAPE"]
    if how == "tp_plugin":
        return T.Accelerator(device="cpu", tp_plugin=T.TensorParallelPlugin(mesh["tp_size"]),
                             **kw)
    if how == "megatron":
        return T.Accelerator(device="cpu", megatron_plugin=T.MegatronStylePlugin(
            tp_size=mesh["tp_size"], fsdp_size=mesh["fsdp_size"]), **kw)
    if how == "ulysses_plugin":
        return T.Accelerator(device="cpu", sp_plugin=T.SequenceParallelPlugin(
            mesh["sp_size"], ring_attention=False), **kw)
    sp = mesh.get("sp_size", 1)
    rest = {k: v for k, v in mesh.items() if k != "sp_size"}
    return T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(**rest),
                         sp_plugin=T.SequenceParallelPlugin(sp) if sp > 1 else None, **kw)


def _model(params, rank, **cfg_kw):
    model = T.Llama(T.LlamaConfig.tiny(**CFG, **cfg_kw), device="cpu")
    model.params = T.llama_params_from_numpy(params, model.config, device="cpu")
    if rank:  # prepare hands every rank rank 0's parameters
        for leaf in tree_leaves(model.params):
            leaf.add_(float(rank))
    return model


def _full(pm, po=None):
    """The full parameters on every rank, and the optimizer state on rank 0
    (``checkpointing.full_host_opt_state``), in the checkpoint's keys, on
    the host (every rank joins the gathers)."""
    from accelerate_tpu_torch.checkpointing import full_host_opt_state

    engine = pm.handle.sharded
    if engine is None:
        params = {k: v.detach().numpy().copy() for k, v in flatten_with_paths(pm.params)}
        opt = {} if po is None else {k: v.numpy().copy() for k, v in flatten_with_paths(
            po.opt_state) if isinstance(v, torch.Tensor)}
        return params, opt
    params = {layout.path.replace("/", "."): engine.full_leaf(i).numpy().copy()
              for i, layout in enumerate(engine.layouts)}
    opt = {} if po is None else {k: v.numpy() for k, v in full_host_opt_state(engine, po).items()}
    return params, opt


def _grads(pm, po):
    """The buffer of one accumulation-2 micro-step, times 2: the gradient."""
    engine = pm.handle.sharded
    if engine is None:
        return {k: (2 * v).numpy() for k, v in flatten_with_paths(po.grads)}
    out = {}
    for i, layout in enumerate(engine.layouts):
        g = engine.full_leaf(i, shards=engine.accum[i])
        out[layout.path.replace("/", ".")] = (2 * g).numpy()
    return out


def _fused_case(name, params, rank, batches):
    mesh, how, cfg_kw, zero = FUSED[name]
    acc = _port_accelerator(mesh, how)
    acc.zero_sharding = zero
    pm, po = acc.prepare(_model(params, rank, **cfg_kw), T.adamw(LR, device="cpu"))
    step = acc.build_train_step(pm, po)
    saved = {"losses": np.asarray([float(step(b, clip_norm=1.0)) for b in batches]),
             "coordinate": np.asarray(acc.mesh.get_coordinate()),
             "zero_active": np.asarray(po.zero_active),
             "bytes": np.asarray(list(pm.handle.sharded.state_bytes(
                 pm.handle.sharded.ranks[0]).values()) if pm.handle.sharded else [0, 0]),
             "impl": np.asarray(pm.module.config.attention_impl)}
    full, _ = _full(pm)
    saved.update({f"p.{k}": v for k, v in full.items()})
    acc = _port_accelerator(mesh, how, gradient_accumulation_steps=2)
    acc.zero_sharding = zero
    pm, po = acc.prepare(_model(params, rank, **cfg_kw), T.adamw(LR, device="cpu"))
    acc.build_train_step(pm, po)(batches[0], clip_norm=1.0)
    saved.update({f"g.{k}": v for k, v in _grads(pm, po).items()})
    return saved


def _imperative_case(name, params, rank, batches):
    mesh, cfg_kw = IMPERATIVE[name]
    acc = _port_accelerator(mesh, "config")
    pm, po = acc.prepare(_model(params, rank, **cfg_kw), T.adamw(LR, device="cpu"))
    n_data, d = acc._dp_size_index()
    losses = []
    for b in batches:
        per = b["input_ids"].shape[0] // n_data
        out = pm(**{k: v[d * per:(d + 1) * per] for k, v in b.items()})
        acc.backward(out["loss"])
        acc.clip_grad_norm_(pm, 1.0)
        po.step()
        po.zero_grad()
        losses.append(float(T.reduce(out["loss"].detach().clone(), reduction="mean",
                                     group=acc._dp_group())))
    pm.eval()
    with torch.no_grad():
        logits = pm(input_ids=batches[0]["input_ids"][:2])["logits"]
    full, _ = _full(pm)
    return {"losses": np.asarray(losses), "logits_shape": np.asarray(logits.shape),
            **{f"p.{k}": v for k, v in full.items()}}


def _fp16_case(params, rank, batches):
    acc = _port_accelerator(FUSED["tp2xfsdp2"][0], "config", mixed_precision="fp16")
    pm, po = acc.prepare(_model(params, rank), T.adamw(LR, device="cpu"))
    step = acc.build_train_step(pm, po)
    losses, skipped, scales, counts = [], [], [], []
    for scale, b in zip(FP16_SCALES, batches):
        acc.scaler.scale = scale
        losses.append(float(step(b, clip_norm=1.0)))
        skipped.append(po.step_was_skipped)
        scales.append(acc.scaler.scale)
        counts.append(int(po.rank_states[0][0].count))
    full, _ = _full(pm)
    return {"losses": np.asarray(losses), "skipped": np.asarray(skipped),
            "scales": np.asarray(scales), "counts": np.asarray(counts),
            **{f"p.{k}": v for k, v in full.items()}}


def _checkpoint_case(params, rank, batches, load_dir, save_dir):
    acc = _port_accelerator(FUSED["tp2xfsdp2"][0], "config")
    pm, po = acc.prepare(_model(params, rank), T.adamw(LR, device="cpu"))
    step = acc.build_train_step(pm, po)
    acc.load_state(load_dir, reshard=True)
    loaded, loaded_opt = _full(pm, po)
    for b in batches[:2]:
        step(b, clip_norm=1.0)
    acc.save_state(save_dir)
    full, opt = _full(pm, po)
    return {"accum": np.asarray(acc.gradient_accumulation_steps),
            **{f"l.{k}": v for k, v in loaded.items()},
            **{f"lo.{k}": v for k, v in loaded_opt.items()},
            **{f"p.{k}": v for k, v in full.items()}, **{f"o.{k}": v for k, v in opt.items()}}


def cases_worker(out_dir: str, params, cases, load_dir: str | None):
    """One rank: each ``(kind, name)`` of ``cases`` in turn; one ``.npz`` a
    case and rank."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = Path(out_dir)
    for kind, name in cases:
        if kind == "fused":
            saved = _fused_case(name, params, rank, step_batches())
        elif kind == "imperative":
            saved = _imperative_case(name, params, rank, step_batches())
        elif kind == "fp16":
            saved = _fp16_case(params, rank, step_batches())
        elif kind == "loader":
            acc = _port_accelerator(IMPERATIVE[name][0], "config")
            T.set_seed(0, device="cpu")  # as a training script seeds every rank
            dl = acc.prepare(torch.utils.data.DataLoader(list(range(40)), batch_size=4,
                                                         shuffle=True))
            n_data, d = acc._dp_size_index()
            saved = {"batches": np.stack([b.numpy() for b in dl]), "data": np.asarray([n_data, d]),
                     "state": np.asarray(repr(sorted(dl.state_dict().items())))}
        elif kind == "collectives":
            from accelerate_tpu_torch.utils.operations import all_to_all_along

            x = torch.arange(4 * 8 * 3).reshape(4, 8, 3) + 1000 * rank
            saved = {"all_to_all": all_to_all_along(x, 1, 0).numpy()}
        else:
            saved = _checkpoint_case(params, rank, step_batches(), load_dir,
                                     str(out / "tp_ckpt"))
        np.savez(out / f"{kind}_{name}.rank{rank}.npz", **saved)


def load_ranks(out_dir, name, n=N_RANKS):
    return [dict(np.load(Path(out_dir) / f"{name}.rank{r}.npz")) for r in range(n)]


# --------------------------------------------------------- the JAX reference
def _jax_run(mesh, batches, *, zero=False, attention_impl="auto", ring=True, fp16=False):
    """JAX on a 4-device mesh of ``mesh``: the fused step, or with ``fp16``
    the fp16 imperative loop (the JAX package's fused step has no scaler)
    with the scales of ``FP16_SCALES``; the losses and final parameters
    (and for fp16 the skips and scales)."""
    import jax
    import optax

    from accelerate_tpu import Accelerator as JAccelerator
    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
    from accelerate_tpu.parallel.mesh import ParallelismConfig as JParallelismConfig
    from accelerate_tpu.parallel.sharding import path_str
    from accelerate_tpu.state import AcceleratorState, GradientState
    from accelerate_tpu.utils.dataclasses import SequenceParallelPlugin as JSP

    class FourDevices(JParallelismConfig):
        def build_mesh(self, devices=None):
            return super().build_mesh(jax.devices()[:N_RANKS])

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        sp = mesh.get("sp_size", 1)
        acc = JAccelerator(mixed_precision="fp16" if fp16 else "no",
                           parallelism_config=FourDevices(**mesh),
                           sp_plugin=JSP(sp, ring_attention=ring) if sp > 1 else None)
        acc.zero_sharding = zero
        jm = JLlama(JConfig.tiny(**CFG, attention_impl=attention_impl))
        jm.init_params(jax.random.key(0))
        pm, po = acc.prepare(jm, optax.adamw(LR))
        record = {"losses": [], "skipped": [], "scales": []}
        if fp16:
            for scale, b in zip(FP16_SCALES, batches):
                acc.scaler.scale = scale
                out = pm(**b)
                acc.backward(out["loss"])
                acc.clip_grad_norm_(pm, 1.0)
                po.step()
                po.zero_grad()
                record["losses"].append(float(out["loss"]))
                record["skipped"].append(bool(po.step_was_skipped))
                record["scales"].append(acc.scaler.scale)
        else:
            step = acc.build_train_step(pm, po)
            record["losses"] = [float(step(b, clip_norm=1.0)) for b in batches]
            assert po.zero_active == zero
        flat = jax.tree_util.tree_flatten_with_path(pm.handle.params)[0]
        record["params"] = {path_str(p).replace("/", "."): np.asarray(v) for p, v in flat}
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    return record


def _jax_grads(params, batch):
    """``jax.grad`` of the JAX model's loss at the start weights."""
    import jax

    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
    from accelerate_tpu.parallel.sharding import path_str

    jm = JLlama(JConfig.tiny(**CFG))
    grads = jax.jit(jax.grad(lambda p, b: jm.apply(p, **b)["loss"]))(params, batch)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return {path_str(p).replace("/", "."): np.asarray(v) for p, v in flat}


@pytest.fixture(scope="module")
def start_params():
    import jax

    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig

    jm = JLlama(JConfig.tiny(**CFG))
    jm.init_params(jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, jm.params)


def launch_cases(start_params, out: Path, cases, load_dir=None):
    """Start the one launch of 4 gloo ranks over ``cases`` in a thread;
    returns ``join()``, which waits for it and raises a rank's error."""
    failure = []

    def launch():
        try:
            T.debug_launcher(cases_worker, args=(str(out), start_params, cases, load_dir),
                             num_processes=N_RANKS, timeout=LAUNCH_TIMEOUT)
        except Exception as exc:  # re-raised by join()
            failure.append(exc)

    thread = threading.Thread(target=launch)
    thread.start()

    def join():
        thread.join(timeout=LAUNCH_TIMEOUT + 60)
        assert not thread.is_alive(), "the gloo launch did not return"
        if failure:
            raise failure[0]

    return join


def jax_fused_reference(name):
    mesh, how, cfg_kw, zero = FUSED[name]
    return _jax_run(mesh, step_batches(), zero=zero,
                    attention_impl=cfg_kw.get("attention_impl", "auto"),
                    ring=how != "ulysses_plugin")


@pytest.fixture(scope="module")
def runs(start_params, tmp_path_factory):
    """This file's launch and, while the ranks train, the JAX references
    and the unsharded checkpoint the ranks load first."""
    out = tmp_path_factory.mktemp("tp_cases")
    # Accumulation 2 at dp 1 keeps the global batch at the ranks' dp 2.
    acc = T.Accelerator(device="cpu", gradient_accumulation_steps=2)
    pm, po = acc.prepare(_model(start_params, 0), T.adamw(LR, device="cpu"))
    step = acc.build_train_step(pm, po)
    for b in step_batches()[:2]:
        step(b, clip_norm=1.0)
    acc.save_state(str(out / "unsharded_ckpt"))
    unsharded = _full(pm, po)
    join = launch_cases(start_params, out, TP_CASES, str(out / "unsharded_ckpt"))
    try:
        fused = {name: jax_fused_reference(name) for name in TP_FUSED}
        fp16 = _jax_run(FUSED["tp2xfsdp2"][0], step_batches(), fp16=True)
        grads = _jax_grads(start_params, step_batches()[0])
    finally:
        join()
    # The imperative loop's rows of equal length give JAX's fused numbers.
    return {"out": out, "fused": fused, "imperative": {"tp2xfsdp2": fused["tp2xfsdp2"]},
            "fp16": fp16, "grads": grads, "unsharded": unsharded}


def _assert_params(got_ranks, want):
    got = {k[2:]: v for k, v in got_ranks[0].items() if k.startswith("p.")}
    assert sorted(got) == sorted(want) and len(want) == 12
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)
    for saved in got_ranks[1:]:  # every rank gathers the same full parameters
        for key in got:
            assert np.array_equal(saved[f"p.{key}"], got[key]), key


@pytest.mark.parametrize("name", TP_FUSED)
def test_tp_step_losses_match_jax(runs, name):
    ranks = load_ranks(runs["out"], f"fused_{name}")
    want = runs["fused"][name]["losses"]
    for saved in ranks:
        np.testing.assert_allclose(saved["losses"], want, rtol=LOSS_RTOL, atol=0)
        assert np.array_equal(saved["losses"], ranks[0]["losses"])
    impl = "ulysses" if "ulysses" in name else "auto"
    assert all(str(s["impl"]) == impl for s in ranks)


@pytest.mark.parametrize("name", TP_FUSED)
def test_tp_step_params_match_jax(runs, name):
    _assert_params(load_ranks(runs["out"], f"fused_{name}"), runs["fused"][name]["params"])


@pytest.mark.parametrize("name", TP_FUSED)
def test_tp_step_gradients_match_jax_leaf_by_leaf(runs, name):
    """Every leaf's gradient of the first batch, norms and biases included:
    a missing or doubled conjugate op shows here as a factor of tp or a
    rank's partial."""
    want = runs["grads"]
    for saved in load_ranks(runs["out"], f"fused_{name}"):
        got = {k[2:]: v for k, v in saved.items() if k.startswith("g.")}
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=key)


@pytest.mark.parametrize("name", TP_FUSED)
def test_each_rank_holds_its_share(runs, name):
    """Rank = ((dp * fsdp + fsdp_i) * sp + sp_i) * tp + tp_i; each rank's
    parameter and buffer bytes are its base shards' (the JAX planner's
    local shapes), and ZeRO engages where asked."""
    from accelerate_tpu_torch.parallel.sharding import local_leaf_shape, plan_param_shardings

    mesh, _, _, zero = FUSED[name]
    sizes = T.ParallelismConfig(**mesh).resolved_sizes(N_RANKS)
    model = T.Llama(T.LlamaConfig.tiny(**CFG), device="cpu")
    model.device = torch.device("meta")
    shapes = tree_leaves(model.init())
    specs = tree_leaves(plan_param_shardings(model.init(), sizes, rules=model.sharding_rules()))
    local = sum(4 * int(np.prod(local_leaf_shape(t.shape, s, sizes)))
                for t, s in zip(shapes, specs))
    ranks = load_ranks(runs["out"], f"fused_{name}")
    from accelerate_tpu_torch.parallel.fsdp import rank_coordinate

    for r, saved in enumerate(ranks):
        assert tuple(saved["coordinate"]) == tuple(rank_coordinate(r, sizes).values())
        assert bool(saved["zero_active"]) == zero
        if sizes["tp"] > 1:
            params, buf = (int(x) for x in saved["bytes"])
            assert params == buf == local


@pytest.mark.parametrize("name", ["tp2xfsdp2"])
def test_imperative_loop_matches_jax(runs, name):
    ranks = load_ranks(runs["out"], f"imperative_{name}")
    want = runs["imperative"][name]
    for saved in ranks:
        np.testing.assert_allclose(saved["losses"], want["losses"], rtol=LOSS_RTOL, atol=0)
        assert tuple(saved["logits_shape"]) == (2, 16, CFG["vocab_size"])
    _assert_params(ranks, want["params"])


def test_fp16_on_tp_shards_skips_as_jax(runs):
    ranks = load_ranks(runs["out"], "fp16_None")
    want = runs["fp16"]
    applied = want["skipped"].count(False)
    assert want["skipped"] == [False, True, False]
    for saved in ranks:
        assert saved["skipped"].tolist() == want["skipped"]
        assert saved["scales"].tolist() == want["scales"]
        assert saved["counts"].tolist() == [1, 1, 2]  # the skipped step updates nothing
        np.testing.assert_allclose(saved["losses"], want["losses"], atol=FP16_LOSS_ATOL, rtol=0)
    got = {k[2:]: v for k, v in ranks[0].items() if k.startswith("p.")}
    diffs = np.concatenate([np.abs(got[k] - w).ravel() for k, w in want["params"].items()])
    assert diffs.max() <= 2 * LR * applied
    assert np.quantile(diffs, 0.99) <= 1e-5


@pytest.mark.parametrize("name", ["tp2xfsdp2", "dp2xsp2_ring"])
def test_prepared_loader_gives_a_data_coordinate_its_rows(runs, name):
    """The tp and sp ranks of one data coordinate read the same rows: a
    shuffled loader prepared over the 2 data ranks gives every rank of a
    data coordinate the same batches and sampler state, and the two data
    coordinates disjoint rows that cover the data."""
    ranks = load_ranks(runs["out"], f"loader_{name}")
    by_data = {}
    for saved in ranks:
        assert int(saved["data"][0]) == 2 and saved["batches"].shape == (5, 4)
        by_data.setdefault(int(saved["data"][1]), []).append(saved)
    assert sorted(by_data) == [0, 1] and all(len(v) == 2 for v in by_data.values())
    for same in by_data.values():
        assert np.array_equal(same[0]["batches"], same[1]["batches"])
        assert np.array_equal(same[0]["state"], same[1]["state"])
    rows = np.concatenate([same[0]["batches"].ravel() for same in by_data.values()])
    assert sorted(rows.tolist()) == list(range(40))


def test_tp_checkpoint_round_trips_through_an_unsharded_run(runs):
    """An unsharded run's checkpoint loads into tp 2 x fsdp 2 bitwise
    (``reshard=True``: accumulation 2 x dp 1 becomes 1 x dp 2); the ranks
    train and save; an unsharded process loads that back bitwise (1 x 2
    becomes 2 x 1)."""
    ranks = load_ranks(runs["out"], "checkpoint_None")
    params, opt = runs["unsharded"]
    for saved in ranks:
        assert int(saved["accum"]) == 1
        for key, value in params.items():
            assert np.array_equal(saved[f"l.{key}"], value), key
    for key, value in opt.items():  # rank 0 gathers the optimizer state
        assert np.array_equal(ranks[0][f"lo.{key}"], value), key
    acc = T.Accelerator(device="cpu")
    model = T.Llama(T.LlamaConfig.tiny(**CFG), device="cpu")
    model.init_params(1)
    pm, po = acc.prepare(model, T.adamw(LR, device="cpu"))
    po._ensure_initialized()
    acc.load_state(str(runs["out"] / "tp_ckpt"), reshard=True)
    assert acc.gradient_accumulation_steps == 2
    back, back_opt = _full(pm, po)
    for key, value in back.items():
        assert np.array_equal(ranks[0][f"p.{key}"], value), key
    for key, value in back_opt.items():
        assert np.array_equal(ranks[0][f"o.{key}"], value), key


# ------------------------------------------------------- across four cards
FULL_DEPTH_TOKENS, FULL_DEPTH_WARMUP, FULL_DEPTH_TIMED = 4096, 2, 3
NCCL_LOSS_ATOL = 1e-2  # bf16 NCCL against the loopback, 3 steps at 4 layers


def _four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < N_RANKS:
        pytest.skip(f"needs {N_RANKS} NVIDIA GPUs (one NCCL rank a card)")


def _spawn(fn, *args, timeout: float = 900.0):
    from test_torch_fsdp_dist import _spawn as spawn

    return spawn(fn, *args, timeout=timeout)


def _nccl_batches(rows=N_RANKS, seq=2048, seed=9):
    rng = np.random.default_rng(seed)
    return [{"input_ids": ids, "labels": ids} for ids in
            (rng.integers(0, 128256, (rows, seq)).astype(np.int32) for _ in range(3))]


def _save(out_dir, **arrays):
    import torch.distributed as dist

    np.savez(Path(out_dir) / f"rank{dist.get_rank()}.npz", **arrays)


def _card_ranks(out_dir, n=N_RANKS):
    return [dict(np.load(Path(out_dir) / f"rank{r}.npz")) for r in range(n)]


def full_depth_tp_ranks(out_dir: str):
    """One rank of Llama-3-8B (32 layers) under tp 4 with remat,
    ``adamw(3e-4)``, one 1 x 4096 batch (every tp rank reads it), clip 1.0:
    2 warm-up and 3 timed steps."""
    import time

    acc = T.Accelerator(mixed_precision="bf16", tp_plugin=T.TensorParallelPlugin(N_RANKS))
    model = T.Llama(T.LlamaConfig.llama3_8b(max_position_embeddings=FULL_DEPTH_TOKENS,
                                            remat=True))
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4))
    del model
    step = acc.build_train_step(pm, po)
    ids = np.random.default_rng(5).integers(0, 128256, (1, FULL_DEPTH_TOKENS)).astype(np.int32)
    losses, times = [], []
    registry.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FULL_DEPTH_WARMUP + FULL_DEPTH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step({"input_ids": ids, "labels": ids}, clip_norm=1.0)))
        times.append(time.perf_counter() - t0)
    _save(out_dir, losses=np.asarray(losses), times=np.asarray(times),
          peak=np.asarray(torch.cuda.max_memory_allocated()),
          launches=np.asarray(registry.launch_counts.get("fused_adamw_update", 0)),
          flash=np.asarray(registry.launch_counts.get("flash_attention_fwd", 0)),
          flops=np.asarray(pm.module.flops_per_token()))


@pytest.mark.cuda
def test_full_depth_tp4_on_four_cards(tmp_path):
    """All 32 layers of Llama-3-8B train under NCCL tp 4: finite, falling
    losses; flash on 8 of the 32 query heads a card (32 layers, twice under
    remat); the update once per leaf a step; each card's peak memory, step
    time and MFU printed."""
    _four_cards()
    _spawn(full_depth_tp_ranks, str(tmp_path))
    for saved in _card_ranks(tmp_path):
        losses = saved["losses"]
        steps = FULL_DEPTH_WARMUP + FULL_DEPTH_TIMED
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert int(saved["launches"]) == 12 * steps
        assert int(saved["flash"]) == 2 * 32 * steps
        step_s = float(np.median(saved["times"][FULL_DEPTH_WARMUP:]))
        # One 4096-token batch trains on all four cards together.
        mfu = float(saved["flops"]) * FULL_DEPTH_TOKENS / step_s / (N_RANKS * 989e12)
        print(f"full depth tp4: peak {int(saved['peak']) / 1e9:.2f} GB, step {step_s:.4f} s, "
              f"{FULL_DEPTH_TOKENS / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}%, losses "
              f"{losses.tolist()}")
        assert int(saved["peak"]) < 80e9


def _layout_accelerator(kind: str, loopback: bool, **kw):
    lb = dict(loopback=LoopbackShards(N_RANKS)) if loopback else {}
    if kind == "tp2xfsdp2":
        return T.Accelerator(mixed_precision="bf16", parallelism_config=T.ParallelismConfig(
            tp_size=2, fsdp_size=2, dp_size=1), **lb, **kw)
    if kind == "sp4_ulysses":
        return T.Accelerator(mixed_precision="bf16", sp_plugin=T.SequenceParallelPlugin(
            N_RANKS, ring_attention=False), **lb, **kw)
    if kind == "sp4_ring":
        return T.Accelerator(mixed_precision="bf16", sp_plugin=T.SequenceParallelPlugin(
            N_RANKS), **lb, **kw)
    if kind == "fsdp4_fp16":
        return T.Accelerator(mixed_precision="fp16", parallelism_config=T.ParallelismConfig(
            fsdp_size=N_RANKS), **lb, **kw)
    raise ValueError(kind)


def _layout_losses(kind: str, loopback: bool, batches, imperative: bool = False,
                   device: str = "cuda", cfg: dict | None = None):
    """Three steps on ``kind`` of Llama-3-8B widths cut to 4 layers (or the
    config of ``cfg``, to rehearse on the CPU): the losses (and, fp16, the
    skips)."""
    acc = _layout_accelerator(kind, loopback, device=device)
    model = T.Llama(T.LlamaConfig.llama3_8b(**(cfg or dict(
        num_hidden_layers=4, max_position_embeddings=8192))), device=device)
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4, device=device))
    del model
    losses, skipped = [], []
    if imperative:  # the prepared loader's rows: every sp rank reads the whole batch
        for b in batches:
            out = pm(**b)
            acc.backward(out["loss"])
            acc.clip_grad_norm_(pm, 1.0)
            po.step()
            po.zero_grad()
            losses.append(float(out["loss"].detach()))
    else:
        step = acc.build_train_step(pm, po)
        for i, b in enumerate(batches):
            if acc.scaler is not None:
                acc.scaler.scale = 2.0**60 if i == 1 else 2.0**10
            losses.append(float(step(b, clip_norm=1.0)))
            skipped.append(po.step_was_skipped)
    return np.asarray(losses), np.asarray(skipped)


def nccl_layout_ranks(out_dir: str, kind: str, batches, imperative: bool, device="cuda",
                      cfg=None):
    """One rank of ``kind`` over a process group (NCCL on cards; gloo with
    ``device="cpu"``, the rehearsal)."""
    losses, skipped = _layout_losses(kind, False, batches, imperative, device, cfg)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    _save(out_dir, losses=losses, skipped=skipped, peak=np.asarray(peak))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,imperative,reference", [
    ("tp2xfsdp2", False, "loopback"), ("sp4_ulysses", False, "loopback"),
    ("sp4_ring", True, "fused"), ("fsdp4_fp16", False, "loopback")])
def test_layouts_over_nccl_on_four_cards(tmp_path, kind, imperative, reference):
    """NCCL (one process a card) against the same layout on one card: the
    loopback (tp 2 x fsdp 2; Ulysses sp 4; fp16 under fsdp 4 with step 2
    poisoned by the scale), or the fused sp step for the imperative loop
    under sp 4 (ring); losses within NCCL_LOSS_ATOL, skips equal."""
    _four_cards()
    seq = 8192 if kind.startswith("sp") else 2048
    rows = 1 if kind.startswith("sp") else N_RANKS
    batches = _nccl_batches(rows, seq)
    _spawn(nccl_layout_ranks, str(tmp_path), kind, batches, imperative)
    if reference == "loopback":
        want, want_skipped = _layout_losses(kind, True, batches)
    else:
        want, want_skipped = None, None
    for saved in _card_ranks(tmp_path):
        assert np.isfinite(saved["losses"]).all()
        if want is not None:
            assert float(np.abs(saved["losses"] - want).max()) <= NCCL_LOSS_ATOL
            assert saved["skipped"].tolist() == want_skipped.tolist()
    if reference == "fused":
        fused = tmp_path / "fused"
        fused.mkdir()
        _spawn(nccl_layout_ranks, str(fused), kind, batches, False)
        want = _card_ranks(fused)[0]["losses"]
        for saved in _card_ranks(tmp_path):
            assert float(np.abs(saved["losses"] - want).max()) <= NCCL_LOSS_ATOL
    peaks = [int(saved["peak"]) / 1e9 for saved in _card_ranks(tmp_path)]
    print(f"nccl {kind} ({'imperative' if imperative else 'fused'}) losses "
          f"{_card_ranks(tmp_path)[0]['losses'].tolist()}, {reference} {want.tolist()}, "
          f"peak GB a card {peaks}")
