"""The port's sharded training (fsdp, ZeRO over dp) across processes, and on
four cards.

This file imports JAX only inside the CPU tests' fixtures: the ranks that
``debug_launcher`` spawns import their worker functions from here, and the
card's machine, which has no JAX, runs its ``cuda`` tests
(``python -m pytest tests/test_torch_fsdp_dist.py -m cuda --noconftest``).

On the CPU, 4 gloo ranks (``debug_launcher``: a file store, no port) run the
tiny Llama from the JAX package's weights for 3 steps of ``adamw(3e-4)`` at
clip 1.0 under fsdp 4, dp 2 x fsdp 2 and dp 4 with ZeRO, and the losses and
final parameters are held to JAX's step on a 4-device mesh of the same
layout and flag (losses rtol 1e-5; parameters rtol 1e-3, atol 1e-5). Those
are the pins of ``tests/test_zero.py:258-276``, so the model (``CFG``) and
the batches are that test's too, the second batch padded. (On other data an
element whose gradient is near 0 can make Adam's update swing with the
order of an f32 sum: with ``LlamaConfig.tiny()`` and other batches one
element of ``w_down`` differs by 1.4e-4 between JAX's own fsdp 4 and dp 4
ZeRO layouts, and by 3.5e-5 between JAX and the port's unsharded step.) Each rank holds 1/n of the sharded
leaves' parameters, moments and buffer. The imperative loop runs under fsdp
4, and a sharded ``save_state`` loads bitwise into an unsharded process with
``reshard=True``, and back.

``cuda``-marked, skipped on hosts with fewer than four cards: Llama-3-8B
with all 32 layers under fsdp 4 with remat over NCCL (one process a card,
as ``torchrun --nproc_per_node=4`` runs it), NCCL fsdp 4 at 4 layers
against ``LoopbackShards(4)`` on one card, the dispatcher over NCCL (each
card's slices against the one-process split), and ``cpu_offload=True``
under NCCL fsdp 4 at 4 layers, bitwise the same run without offload.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.parallel.fsdp import LoopbackShards
from accelerate_tpu_torch.utils.tree import flatten_with_paths, tree_leaves

N_RANKS = 4
LAYOUTS = {
    "fsdp4": (dict(fsdp_size=4, dp_size=1), False),
    "dp2xfsdp2": (dict(fsdp_size=2, dp_size=2), False),
    "dp4_zero": (dict(fsdp_size=1, dp_size=4), True),
}
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
# tests/test_zero.py's model and batches, the data its pins were set on.
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=2,
           num_key_value_heads=2, num_hidden_layers=2)


def step_batches(padded: bool = True):
    """tests/test_zero.py's global batches 1-3 (8 x 16); with ``padded`` the
    second has right padding in rows 6 and 7 (rank 3's rows under fsdp 4)."""
    out = []
    for step in range(1, 4):
        ids = np.random.default_rng(100 + step).integers(0, CFG["vocab_size"], (8, 16))
        ids = ids.astype(np.int32)
        batch = {"input_ids": ids, "labels": ids}
        if padded and step == 2:
            mask = np.ones(ids.shape, np.int32)
            mask[7, 9:] = 0
            mask[6, 3:] = 0
            batch["attention_mask"] = mask
        out.append(batch)
    return out


def _full_state(pm, po):
    """Full parameters and optimizer state on the host, in the
    checkpoint's keys (every rank joins the gathers)."""
    from accelerate_tpu_torch.checkpointing import full_host_opt_state, full_host_params

    engine = pm.handle.sharded
    params = {k: v.numpy() for k, v in flatten_with_paths(full_host_params(engine))
              if v is not None}
    opt = {k: v.numpy() for k, v in full_host_opt_state(engine, po).items()}
    return params, opt


def _state_bytes(pm, po):
    """This rank's bytes of parameters, moments and buffer."""
    engine = pm.handle.sharded
    nbytes = engine.state_bytes(engine.ranks[0])
    moments = sum(t.numel() * t.element_size() for _, t in flatten_with_paths(po.opt_state)
                  if isinstance(t, torch.Tensor) and t.dim() > 0)
    return np.asarray([nbytes["params"], moments, nbytes["buffer"]])


def _prepared(layout, params, rank, device="cpu", mixed_precision="no", **cfg_kw):
    mesh, zero = LAYOUTS[layout]
    acc = T.Accelerator(mixed_precision=mixed_precision, device=device,
                        parallelism_config=T.ParallelismConfig(**mesh))
    acc.zero_sharding = zero
    model = T.Llama(T.LlamaConfig.tiny(**CFG, **cfg_kw), device=device)
    model.params = T.llama_params_from_numpy(params, model.config, device=device)
    if rank:  # prepare hands every rank rank 0's parameters
        for leaf in tree_leaves(model.params):
            leaf.add_(float(rank))
    pm, po = acc.prepare(model, T.adamw(3e-4, device=device))
    return acc, pm, po


def fused_worker(out_dir: str, layout: str, params, batches):
    """One rank: three sharded steps; saves the losses, the full state, the
    rank's bytes and its coordinate."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    acc, pm, po = _prepared(layout, params, rank)
    step = acc.build_train_step(pm, po)
    saved = {"losses": np.asarray([float(step(b, clip_norm=1.0)) for b in batches]),
             "coordinate": np.asarray(acc.mesh.get_coordinate()),
             "bytes": _state_bytes(pm, po), "zero_active": np.asarray(po.zero_active)}
    full, opt = _full_state(pm, po)
    saved.update({f"p.{k}": v for k, v in full.items()})
    saved.update({f"o.{k}": v for k, v in opt.items()})
    try:
        step({k: v[:6] for k, v in batches[0].items()})
        saved["refused_rows"] = np.asarray(False)
    except ValueError:
        saved["refused_rows"] = np.asarray(True)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **saved)


def imperative_worker(out_dir: str, params, batches):
    """One rank of the imperative loop under fsdp 4: its rows of each
    global batch through the model call, ``backward``, ``clip_grad_norm_``,
    ``step`` and ``zero_grad``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    acc, pm, po = _prepared("fsdp4", params, rank)
    losses, norms = [], []
    for b in batches:
        rows = {k: v[2 * rank:2 * rank + 2] for k, v in b.items()}
        out = pm(**rows)
        acc.backward(out["loss"])
        norms.append(float(acc.clip_grad_norm_(pm, 1.0)))
        po.step()
        po.zero_grad()
        losses.append(float(T.reduce(out["loss"].detach().clone(), reduction="mean")))
    pm.eval()
    with torch.no_grad():
        logits = pm(input_ids=batches[0]["input_ids"][:2])["logits"]
    full, _ = _full_state(pm, po)
    np.savez(Path(out_dir) / f"rank{rank}.npz", losses=np.asarray(losses),
             norms=np.asarray(norms), logits=logits.numpy(),
             **{f"p.{k}": v for k, v in full.items()})


def checkpoint_worker(out_dir: str, params, batches, load_dir):
    """fsdp 4: with no ``load_dir``, two steps and a ``save_state``; else a
    ``load_state(load_dir, reshard=True)``. Saves the full state either way."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    acc, pm, po = _prepared("fsdp4", params, rank)
    step = acc.build_train_step(pm, po)
    if load_dir is None:
        for b in batches[:2]:
            step(b, clip_norm=1.0)
        acc.save_state(str(Path(out_dir) / "ckpt"))
    else:
        acc.load_state(load_dir, reshard=True)
    full, opt = _full_state(pm, po)
    np.savez(Path(out_dir) / f"rank{rank}.npz", accum=np.asarray(acc.gradient_accumulation_steps),
             **{f"p.{k}": v for k, v in full.items()}, **{f"o.{k}": v for k, v in opt.items()})


def load_ranks(out_dir, n=N_RANKS):
    return [dict(np.load(Path(out_dir) / f"rank{r}.npz")) for r in range(n)]


# --------------------------------------------------------- the JAX reference
def _jax_step(layout, batches, steps=3):
    """JAX's fused step on a 4-device mesh of ``layout``: the losses and the
    final parameters, keyed as the checkpoint keys them."""
    import jax
    import optax

    from accelerate_tpu import Accelerator as JAccelerator
    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
    from accelerate_tpu.parallel.mesh import ParallelismConfig as JParallelismConfig
    from accelerate_tpu.parallel.sharding import path_str
    from accelerate_tpu.state import AcceleratorState, GradientState

    class FourDevices(JParallelismConfig):
        def build_mesh(self, devices=None):
            return super().build_mesh(jax.devices()[:N_RANKS])

    mesh, zero = LAYOUTS[layout]
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        acc = JAccelerator(mixed_precision="no", parallelism_config=FourDevices(**mesh))
        acc.zero_sharding = zero
        jm = JLlama(JConfig.tiny(**CFG))
        jm.init_params(jax.random.key(0))  # the start_params fixture's weights
        pm, po = acc.prepare(jm, optax.adamw(3e-4))
        step = acc.build_train_step(pm, po)
        losses = np.asarray([float(step(b, clip_norm=1.0)) for b in batches[:steps]])
        assert po.zero_active == zero
        flat = jax.tree_util.tree_flatten_with_path(pm.handle.params)[0]
        params = {path_str(p).replace("/", "."): np.asarray(v) for p, v in flat}
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    return losses, params


@pytest.fixture(scope="module")
def start_params():
    import jax

    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig

    jm = JLlama(JConfig.tiny(**CFG))
    jm.init_params(jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, jm.params)


@pytest.fixture(scope="module")
def fused_runs(start_params, tmp_path_factory):
    """``run(layout)``: the port's four ranks and JAX's reference."""
    cache = {}

    def run(layout):
        if layout not in cache:
            out = tmp_path_factory.mktemp(layout)
            T.debug_launcher(fused_worker, args=(str(out), layout, start_params,
                                                 step_batches()), num_processes=N_RANKS)
            cache[layout] = load_ranks(out), _jax_step(layout, step_batches())
        return cache[layout]

    return run


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_step_losses_match_jax(fused_runs, layout):
    ranks, (want, _) = fused_runs(layout)
    for saved in ranks:
        np.testing.assert_allclose(saved["losses"], want, rtol=LOSS_RTOL, atol=0)
        assert np.array_equal(saved["losses"], ranks[0]["losses"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_step_params_match_jax(fused_runs, layout):
    ranks, (_, want) = fused_runs(layout)
    got = {k[2:]: v for k, v in ranks[0].items() if k.startswith("p.")}
    assert sorted(got) == sorted(want) and len(want) == 12
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_each_rank_holds_its_share_of_the_state(fused_runs, layout):
    """Rank = (dp * fsdp + fsdp_index), the JAX axis order. Under fsdp each
    rank holds 1/fsdp of every sharded leaf's parameter, moments and buffer
    (plus the replicated norms); under ZeRO the moments are 1/dp."""
    ranks, _ = fused_runs(layout)
    mesh, zero = LAYOUTS[layout]
    fsdp, dp = mesh["fsdp_size"], mesh["dp_size"]
    assert [tuple(r["coordinate"]) for r in ranks] == [(0, i // fsdp, i % fsdp, 0, 0, 0)
                                                        for i in range(N_RANKS)]
    model = T.Llama(T.LlamaConfig.tiny(**CFG), device="cpu")
    model.device = torch.device("meta")
    from accelerate_tpu_torch.parallel.sharding import local_leaf_shape, plan_param_shardings

    shapes = tree_leaves(model.init())
    sizes = {"dp": dp, "fsdp": fsdp}
    specs = tree_leaves(plan_param_shardings(model.init(), sizes, rules=model.sharding_rules()))
    local = sum(4 * int(np.prod(local_leaf_shape(t.shape, s, sizes))) for t, s in zip(shapes, specs))
    total = sum(4 * int(np.prod(t.shape)) for t in shapes)
    for saved in ranks:
        params, moments, buf = (int(x) for x in saved["bytes"])
        assert params == buf == local
        assert bool(saved["zero_active"]) == zero
        if zero:
            assert params == total and moments < 2 * total / dp + 2 * 4 * 2 * 64 * 2
        else:
            assert moments == 2 * local
        if fsdp == 4:  # every leaf but the norms (320 floats) split four ways
            assert local == (total - 4 * 320) // 4 + 4 * 320


def test_sharded_step_refuses_rows_that_do_not_split(fused_runs):
    for saved in fused_runs("fsdp4")[0]:
        assert bool(saved["refused_rows"])


@pytest.fixture(scope="module")
def imperative_run(start_params, tmp_path_factory):
    out = tmp_path_factory.mktemp("imperative")
    batches = step_batches(padded=False)
    T.debug_launcher(imperative_worker, args=(str(out), start_params, batches),
                     num_processes=N_RANKS)
    return load_ranks(out), _jax_step("fsdp4", batches)


def test_imperative_loop_under_fsdp_matches_jax(imperative_run):
    """Rows of equal length, so the mean of the ranks' means is the global
    mean: the losses and the final parameters agree with JAX's fused step;
    the eval forward on the gathered layers gives logits on every rank."""
    ranks, (want_losses, want) = imperative_run
    for saved in ranks:
        np.testing.assert_allclose(saved["losses"], want_losses, rtol=LOSS_RTOL, atol=0)
        assert saved["logits"].shape == (2, 16, CFG["vocab_size"]) and np.isfinite(saved["logits"]).all()
    got = {k[2:]: v for k, v in ranks[0].items() if k.startswith("p.")}
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)


def test_sharded_checkpoint_round_trips_through_an_unsharded_run(start_params, tmp_path):
    """fsdp 4 saves; one unsharded process loads it with ``reshard=True``
    bitwise (accumulation 1 x dp 4 -> 4) and saves; fsdp 4 loads that back
    bitwise (4 x 1 -> 1)."""
    batches = step_batches()
    first, second = tmp_path / "sharded", tmp_path / "back"
    first.mkdir()
    second.mkdir()
    T.debug_launcher(checkpoint_worker, args=(str(first), start_params, batches, None),
                     num_processes=N_RANKS)
    saved = load_ranks(first)[0]
    acc = T.Accelerator(device="cpu")
    model = T.Llama(T.LlamaConfig.tiny(**CFG), device="cpu")
    model.params = T.llama_params_from_numpy(start_params, model.config, device="cpu")
    pm, po = acc.prepare(model, T.adamw(3e-4, device="cpu"))
    po._ensure_initialized()
    acc.load_state(str(first / "ckpt"), reshard=True)
    assert acc.gradient_accumulation_steps == 4
    for key, leaf in flatten_with_paths(pm.params):
        assert np.array_equal(leaf.numpy(), saved[f"p.{key}"]), key
    for key, leaf in flatten_with_paths(po.opt_state):
        if isinstance(leaf, torch.Tensor):
            assert np.array_equal(leaf.numpy(), saved[f"o.{key}"]), key
    acc.save_state(str(tmp_path / "unsharded"))
    T.debug_launcher(checkpoint_worker, args=(str(second), start_params, batches,
                                              str(tmp_path / "unsharded")),
                     num_processes=N_RANKS)
    back_ranks = load_ranks(second)
    assert [int(r["accum"]) for r in back_ranks] == [1] * N_RANKS
    for key, value in saved.items():  # rank 0 holds the gathered state
        if key.startswith(("p.", "o.")):
            assert np.array_equal(back_ranks[0][key], value), key


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_reference_chain_runs_on_the_shards(start_params, layout):
    """A transform the fused update does not cover (``inject_hyperparams``)
    runs its reference chain on each rank's update slices: 4 loopback ranks
    agree with the unsharded step (f32, the remat tests' pins), also after
    ``set_learning_rate``."""
    mesh, zero = LAYOUTS[layout]
    runs = []
    for kw in ({}, dict(parallelism_config=T.ParallelismConfig(**mesh),
                        loopback=LoopbackShards(N_RANKS))):
        acc = T.Accelerator(device="cpu", **kw)
        acc.zero_sharding = zero
        model = T.Llama(T.LlamaConfig.tiny(**CFG), device="cpu")
        model.params = T.llama_params_from_numpy(start_params, model.config, device="cpu")
        pm, po = acc.prepare(model, T.inject_hyperparams(T.adamw)(learning_rate=3e-4,
                                                                  device="cpu"))
        assert po.plan is None
        step = acc.build_train_step(pm, po)
        losses = []
        for b in step_batches():
            losses.append(float(step(b, clip_norm=1.0)))
            assert po.set_learning_rate(1e-4)  # every held rank's state takes it
        engine = pm.handle.sharded
        runs.append((losses, [p.clone() for p in tree_leaves(pm.params)] if engine is None
                     else [engine.full_leaf(i) for i in range(len(engine.layouts))]))
        assert po.zero_active == (zero and engine is not None)
    (want, ref), (got, params) = runs
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for a, b in zip(params, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5, rtol=0)


# ------------------------------------------------- configuration and refusals
@pytest.mark.parametrize("kw", [dict(fsdp_size=4), dict(fsdp_size=-1), dict(fsdp_size=0),
                                dict(dp_size=2, fsdp_size=-1), dict(fsdp_size=2),
                                dict(sp_size=2, fsdp_size=2), dict(dp_size=8),
                                dict(tp_size=2, fsdp_size=-1), dict(tp_size=4, dp_size=2),
                                dict(tp_size=2, sp_size=2, dp_size=-1)],
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_mesh_sizes_resolve_as_jax(kw):
    from accelerate_tpu.parallel.mesh import ParallelismConfig as JParallelismConfig

    want = JParallelismConfig(**kw).resolved_sizes(8, dcn=1)
    got = T.ParallelismConfig(**kw).resolved_sizes(8)
    assert got == {a: want[a] for a in ("pp", "dp", "fsdp", "ep", "sp", "tp")}


def test_zero_sharding_env_default_and_setter(monkeypatch):
    monkeypatch.setenv("ACCELERATE_ZERO_SHARDING", "1")
    assert T.Accelerator(device="cpu").zero_sharding is True
    monkeypatch.setenv("ACCELERATE_ZERO_SHARDING", "maybe")
    with pytest.raises(ValueError, match="ACCELERATE_ZERO_SHARDING"):
        T.Accelerator(device="cpu").zero_sharding
    monkeypatch.delenv("ACCELERATE_ZERO_SHARDING")
    acc = T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(dp_size=4),
                        loopback=LoopbackShards(4))
    assert acc.zero_sharding is False
    model = T.Llama(T.LlamaConfig.tiny(**CFG), device="cpu")
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4, device="cpu"))
    assert not po.zero_sharding
    acc.zero_sharding = True  # reaches the optimizer: its state does not exist yet
    assert po.zero_sharding
    po._ensure_initialized()
    assert po.zero_active
    acc.zero_sharding = False  # too late: the state exists on the ZeRO plan
    assert po.zero_sharding and po.zero_active


def test_unported_sharding_options_raise():
    assert T.ParallelismConfig(ep_size=2).ep_size == 2  # ep is ported
    assert T.ParallelismConfig(pp_size=2).pp_size == 2  # pp is ported
    # The tp axis is ported: a tp 2 x fsdp 2 loopback builds.
    tp = T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(
        tp_size=2, fsdp_size=2), loopback=LoopbackShards(4))
    assert tp.mesh_sizes == {"pp": 1, "dp": 1, "fsdp": 2, "ep": 1, "sp": 1, "tp": 2} and \
        tp.num_data_ranks == 2
    # cpu_offload is ported (the optimizer state in pinned host memory).
    offload = T.Accelerator(device="cpu", fsdp_plugin=T.FullyShardedDataParallelPlugin(
        fsdp_size=2, cpu_offload=True), loopback=LoopbackShards(2))
    assert offload._offload_opt_state
    with pytest.raises(NotImplementedError, match="sp"):  # fsdp x sp stays unported
        T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(
            sp_size=2, fsdp_size=2), loopback=LoopbackShards(4))
    acc = T.Accelerator(device="cpu", fsdp_plugin=T.FullyShardedDataParallelPlugin(fsdp_size=2),
                        loopback=LoopbackShards(2))
    assert acc.mesh_sizes == {"pp": 1, "dp": 1, "fsdp": 2, "ep": 1, "sp": 1, "tp": 1} and \
        acc.num_data_ranks == 2
    bert = T.BertForSequenceClassification(T.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=32), device="cpu")
    bert.init_params(0)
    with pytest.raises(NotImplementedError, match="stacked"):
        acc.prepare(bert)
    with pytest.raises(ValueError, match="dp x sp mesh"):
        T.Accelerator(device="cpu", parallelism_config=T.ParallelismConfig(fsdp_size=3),
                      loopback=LoopbackShards(4))


# ------------------------------------------------------- across four cards
FULL_DEPTH_TOKENS, FULL_DEPTH_WARMUP, FULL_DEPTH_TIMED = 4096, 2, 3
NCCL_LOSS_ATOL = 1e-2  # bf16 NCCL fsdp 4 against LoopbackShards(4), 3 steps at 4 layers


def _four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < N_RANKS:
        pytest.skip(f"needs {N_RANKS} NVIDIA GPUs (one NCCL rank a card)")


def _spawn(fn, *args, timeout: float = 900.0):
    """``fn(*args)`` in one process a card over NCCL; a rank that raises
    fails the launch (the others are stopped), and ranks still running
    after ``timeout`` seconds are killed. This process's cached card memory
    (a loopback reference run here before) is handed back first: rank 0
    shares card 0 with it."""
    import gc
    import socket
    import time

    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(_nccl_entry, args=(port, fn, args), nprocs=N_RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"NCCL ranks still running after {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


def _nccl_entry(rank: int, port: int, fn, args):
    import os
    import sys
    import traceback

    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(N_RANKS), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        fn(*args)
    except BaseException:
        # The other ranks may wait in a collective this rank never joins,
        # and destroy_process_group would wait with them: print the error
        # and leave now, so that the launch fails at once.
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()


def full_depth_ranks(out_dir: str):
    """One rank of Llama-3-8B (32 layers) under fsdp 4 with remat,
    ``adamw(3e-4)``, 1 x 4096 tokens a rank, clip 1.0: 2 warm-up and 3 timed
    steps."""
    import time

    import torch.distributed as dist

    acc = T.Accelerator(mixed_precision="bf16", fsdp_plugin=T.FullyShardedDataParallelPlugin(
        fsdp_size=N_RANKS, activation_checkpointing=True))
    rank = dist.get_rank()
    model = T.Llama(T.LlamaConfig.llama3_8b(max_position_embeddings=FULL_DEPTH_TOKENS))
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4))
    del model
    step = acc.build_train_step(pm, po)
    # One batch every step, as phase 7 trains: the losses fall as it is learned.
    ids = np.random.default_rng(5).integers(0, 128256, (N_RANKS, FULL_DEPTH_TOKENS))
    ids = ids.astype(np.int32)
    losses, times = [], []
    registry.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FULL_DEPTH_WARMUP + FULL_DEPTH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step({"input_ids": ids, "labels": ids}, clip_norm=1.0)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    engine = pm.handle.sharded
    shard_elems = sorted({t.numel() for shards in engine.local for t in shards.values()})
    np.savez(Path(out_dir) / f"rank{rank}.npz", losses=np.asarray(losses),
             times=np.asarray(times), peak=np.asarray(torch.cuda.max_memory_allocated()),
             launches=np.asarray(registry.launch_counts.get("fused_adamw_update", 0)),
             flash=np.asarray(registry.launch_counts.get("flash_attention_fwd", 0)),
             shard_elems=np.asarray(shard_elems),
             full_elems=np.asarray(sorted(int(np.prod(lay.shape)) for lay in engine.layouts)),
             flops=np.asarray(pm.module.flops_per_token()))


@pytest.mark.cuda
def test_full_depth_fsdp_on_four_cards(tmp_path):
    """All 32 layers of Llama-3-8B train on four cards: finite, falling
    losses, the update launched once per leaf a step on shards only, and each
    card's peak memory, step time, tokens/s and MFU printed."""
    _four_cards()
    _spawn(full_depth_ranks, str(tmp_path))
    ranks = load_ranks(tmp_path)
    for saved in ranks:
        losses = saved["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        steps = FULL_DEPTH_WARMUP + FULL_DEPTH_TIMED
        assert int(saved["launches"]) == 12 * steps
        assert int(saved["flash"]) == 2 * 32 * steps  # remat runs each forward twice
        # The update ran on shards: the sharded leaves' tensors are 1/4 of the leaf.
        big = [e for e in saved["full_elems"] if e > 32 * 4096]
        assert all(e // N_RANKS in saved["shard_elems"] for e in big)
        step_s = float(np.median(saved["times"][FULL_DEPTH_WARMUP:]))
        tokens = N_RANKS * FULL_DEPTH_TOKENS
        mfu = float(saved["flops"]) * tokens / step_s / (N_RANKS * 989e12)
        print(f"full depth fsdp4: peak {int(saved['peak']) / 1e9:.2f} GB, step {step_s:.4f} s, "
              f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}%, losses "
              f"{losses.tolist()}")
        assert int(saved["peak"]) < 80e9


def nccl_vs_loopback_ranks(out_dir: str, batches):
    """NCCL fsdp 4 at Llama-3-8B widths cut to 4 layers, bf16, 3 steps, 1 x
    2048 tokens a rank, on this rank's card."""
    import torch.distributed as dist

    acc = T.Accelerator(mixed_precision="bf16",
                        parallelism_config=T.ParallelismConfig(fsdp_size=N_RANKS))
    rank = dist.get_rank()
    model = T.Llama(T.LlamaConfig.llama3_8b(num_hidden_layers=4, max_position_embeddings=2048))
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4))
    step = acc.build_train_step(pm, po)
    losses = [float(step(b, clip_norm=1.0)) for b in batches]
    np.savez(Path(out_dir) / f"rank{rank}.npz", losses=np.asarray(losses))


def _nccl_batches():
    rng = np.random.default_rng(9)
    return [{"input_ids": ids, "labels": ids} for ids in
            (rng.integers(0, 128256, (N_RANKS, 2048)).astype(np.int32) for _ in range(3))]


@pytest.mark.cuda
def test_fsdp_over_nccl_matches_loopback_on_four_cards(tmp_path):
    """The same model, seed and batches: NCCL fsdp 4 (one process a card)
    against LoopbackShards(4) on one card, losses within NCCL_LOSS_ATOL (NCCL
    sums in its own order, the loopback in rank order)."""
    _four_cards()
    batches = _nccl_batches()
    _spawn(nccl_vs_loopback_ranks, str(tmp_path), batches)
    acc = T.Accelerator(mixed_precision="bf16",
                        parallelism_config=T.ParallelismConfig(fsdp_size=N_RANKS),
                        loopback=LoopbackShards(N_RANKS))
    model = T.Llama(T.LlamaConfig.llama3_8b(num_hidden_layers=4, max_position_embeddings=2048))
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4))
    step = acc.build_train_step(pm, po)
    want = np.asarray([float(step(b, clip_norm=1.0)) for b in batches])
    for saved in load_ranks(tmp_path):
        assert np.isfinite(saved["losses"]).all()
        assert float(np.abs(saved["losses"] - want).max()) <= NCCL_LOSS_ATOL
    print(f"nccl fsdp4 losses {load_ranks(tmp_path)[0]['losses'].tolist()}, loopback "
          f"{want.tolist()}")



class _NcclStream(torch.utils.data.IterableDataset):
    """A stream of 30 samples, each a (5,) int row: an iterable dataset, so
    ``prepare`` dispatches it over several ranks."""

    def __iter__(self):
        for i in range(30):
            yield {"x": np.arange(5, dtype=np.int64) + 100 * i}


def nccl_dispatch_ranks(out_dir: str):
    """One rank of the dispatcher over NCCL: rank 0 reads, every rank
    receives its rows of each batch of 8 on its card."""
    import torch.distributed as dist

    acc = T.Accelerator()
    rank = dist.get_rank()
    dl = acc.prepare(torch.utils.data.DataLoader(_NcclStream(), batch_size=8))
    saved = {"kind": np.asarray(type(dl).__name__)}
    for i, b in enumerate(dl):
        saved[f"x{i}"] = b["x"].cpu().numpy()
        saved[f"cuda{i}"] = np.asarray(b["x"].device.type == "cuda")
    np.savez(Path(out_dir) / f"rank{rank}.npz", **saved)


@pytest.mark.cuda
def test_dispatcher_over_nccl_matches_the_one_process_split(tmp_path):
    """Each card's slices of every dispatched batch equal rows
    ``[r·B/4, (r+1)·B/4)`` of the one-process stream (4 full batches and a
    tail of 6 rows, which splits 1 a rank)."""
    _four_cards()
    _spawn(nccl_dispatch_ranks, str(tmp_path))
    whole = [b["x"].numpy() for b in T.data_loader.DataLoaderDispatcher(
        torch.utils.data.DataLoader(_NcclStream(), batch_size=8), device="cpu")]
    for r, saved in enumerate(load_ranks(tmp_path)):
        assert str(saved["kind"]) == "DataLoaderDispatcher"
        assert sum(k.startswith("x") for k in saved) == len(whole) == 4
        for i, x in enumerate(whole):
            per = x.shape[0] // N_RANKS
            assert np.array_equal(saved[f"x{i}"], x[r * per:(r + 1) * per])
            assert bool(saved[f"cuda{i}"])


def offload_fsdp_ranks(out_dir: str, batches):
    """One rank of NCCL fsdp 4 at Llama-3-8B widths cut to 4 layers, bf16:
    the imperative loop on this rank's row of each batch, without and with
    ``cpu_offload``; saves the offloaded run's losses, whether the two runs'
    losses, parameter shards and state agree bitwise, and where the
    offloaded state lay between steps."""
    import gc

    import torch.distributed as dist

    runs = []
    for offload in (False, True):
        acc = T.Accelerator(mixed_precision="bf16", fsdp_plugin=T.FullyShardedDataParallelPlugin(
            fsdp_size=N_RANKS, cpu_offload=offload))
        rank = dist.get_rank()  # the first Accelerator joined the process group
        model = T.Llama(T.LlamaConfig.llama3_8b(num_hidden_layers=4, max_position_embeddings=2048))
        model.init_params(0)
        pm, po = acc.prepare(model, T.adamw(3e-4))
        del model
        losses, placed = [], []
        for b in batches:
            out = pm(**{k: v[rank:rank + 1] for k, v in b.items()})
            acc.backward(out["loss"])
            acc.clip_grad_norm_(pm, 1.0)
            po.step()
            po.zero_grad()
            losses.append(out["loss"].detach().float().cpu())
            state = [t for s in po.rank_states for _, t in flatten_with_paths(s)
                     if isinstance(t, torch.Tensor)]
            placed.append(all(t.device.type == "cpu" and t.is_pinned() for t in state))
        runs.append((torch.stack(losses), [t.cpu() for t in tree_leaves(pm.params)],
                     [t.cpu() for t in state], placed))
        del acc, pm, po, out, state
        gc.collect()
        torch.cuda.empty_cache()
    (l0, p0, s0, h0), (l1, p1, s1, h1) = runs
    same = torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(p0 + s0, p1 + s1))
    np.savez(Path(out_dir) / f"rank{rank}.npz", losses=l1.numpy(), same=np.asarray(same),
             placed=np.asarray([any(h0), all(h1)]))


@pytest.mark.cuda
def test_cpu_offload_under_fsdp_on_four_cards_is_bitwise(tmp_path):
    """``cpu_offload=True`` under NCCL fsdp 4 at 4 layers: the imperative
    loop's losses, parameter shards and optimizer state bitwise the same run
    without offload, with the shards' state in pinned host memory between
    steps."""
    _four_cards()
    _spawn(offload_fsdp_ranks, str(tmp_path), _nccl_batches())
    for saved in load_ranks(tmp_path):
        assert bool(saved["same"]) and saved["placed"].tolist() == [False, True]
        assert np.isfinite(saved["losses"]).all()
    print(f"fsdp4 offload losses {load_ranks(tmp_path)[0]['losses'].tolist()}")
