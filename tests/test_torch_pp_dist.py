"""The port's pipeline parallelism across processes, and on four cards.

JAX-free: the ranks that ``debug_launcher`` spawns import their worker
from here, and the card's machine, which has no JAX, runs the ``cuda``
tests (``python -m pytest tests/test_torch_pp_dist.py -m cuda
--noconftest``).

On the CPU, ONE launch of 4 gloo ranks (a module fixture, in a thread)
trains each case for 2 steps from one seed (the tiny Llama of the JAX
package's pipeline tests: vocab 128, hidden 64, 4 layers, 2 heads; batch 8
x 16, f32, clip 1.0), the activations and their gradients crossing
between the ranks through ``ProcessGroupStages`` (``batch_isend_irecv``),
while this process runs the same case on ``LoopbackShards(4)``:

- pp 4 and pp 2 x dp 2, each under GPipe and 1F1B (4 microbatches),
  ``adamw(3e-3)``;
- pp 2 x fsdp 2 under 1F1B with ``adafactor`` (factored at dim 32), whose
  row and column means and block RMS all-reduce over the fsdp and pp groups
  on the ranks and run on the whole leaves in the loopback.

Each case's losses and parameters after 2 steps equal the loopback's within
``LOSS_RTOL`` / ``PARAM_RTOL``, ``PARAM_ATOL``, and the stage-to-stage messages and bytes
the ranks sent, summed, equal the loopback's hand-overs.

``cuda``-marked, skipped with fewer than four cards: Llama-3-8B at all 32
layers under NCCL pp 4 with 1F1B (8 layers a card, 8 microbatches of 1 x
4096 tokens, ``adamw``), NCCL pp 2 x tp 2 (1F1B) against its loopback at 4
layers, and ``prepare_pippy`` in 4 stages on ``cuda:0-3`` against the
one-card forward.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.utils.tree import flatten_with_paths

N_RANKS = 4
LAUNCH_TIMEOUT = 240.0
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=2,
           num_key_value_heads=2, num_hidden_layers=4)
STEPS, BATCH, SEQ, MICRO = 2, 8, 16, 4
# The ranks and the loopback run the same ops in another order only where
# gloo sums a gradient or a statistic over ranks (f32): the losses to 1e-5;
# the parameters at tests/test_torch_fsdp_dist.py's pins, as Adam's step on
# an element whose gradient is near 0 swings with the sum order.
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-3, 1e-5
CASES = {
    "pp4_gpipe": (dict(pp_size=4), "gpipe", "adamw"),
    "pp4_1f1b": (dict(pp_size=4), "1f1b", "adamw"),
    "pp2xdp2_gpipe": (dict(pp_size=2, dp_size=2), "gpipe", "adamw"),
    "pp2xdp2_1f1b": (dict(pp_size=2, dp_size=2), "1f1b", "adamw"),
    "pp2xfsdp2_adafactor": (dict(pp_size=2, fsdp_size=2, dp_size=1), "1f1b", "adafactor"),
}


def _batches(rows=BATCH, seq=SEQ, vocab=CFG["vocab_size"], seed=3, n=STEPS):
    rng = np.random.default_rng(seed)
    return [{"input_ids": ids, "labels": ids} for ids in
            (rng.integers(0, vocab, (rows, seq)).astype(np.int32) for _ in range(n))]


def _tx(name, device):
    if name == "adafactor":
        return T.adafactor(1e-2, min_dim_size_to_factor=32, device=device)
    return T.adamw(3e-3, device=device)


def run_case(name, loopback: bool, device="cpu"):
    """``name`` of CASES for STEPS steps: the losses, the full parameters
    (the main process's; None elsewhere) and the transport's counts."""
    mesh, schedule, tx = CASES[name]
    acc = T.Accelerator(device=device, parallelism_config=T.ParallelismConfig(**mesh),
                        pp_plugin=T.PipelineParallelPlugin(mesh["pp_size"], MICRO, schedule),
                        loopback=T.LoopbackShards(N_RANKS) if loopback else None)
    model = T.Llama(T.LlamaConfig.tiny(**CFG), device=device)
    model.init_params(0)
    pm, po = acc.prepare(model, _tx(tx, device))
    spec = pm.handle.pipeline_spec
    assert spec is not None and spec.schedule == schedule
    step = acc.build_train_step(pm, po)
    losses = [float(step(b, clip_norm=1.0)) for b in _batches()]
    full = acc.get_state_dict(pm)
    params = {k: v.numpy() for k, v in flatten_with_paths(full)} \
        if acc.is_main_process else None
    return {"losses": np.asarray(losses), "params": params,
            "messages": spec.transport.messages, "bytes": spec.transport.sent_bytes}


def cases_worker(out_dir: str, names):
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    for name in names:
        got = run_case(name, loopback=False)
        saved = {"losses": got["losses"], "messages": np.asarray(got["messages"]),
                 "bytes": np.asarray(got["bytes"])}
        if got["params"] is not None:
            saved.update({f"p.{k}": v for k, v in got["params"].items()})
        np.savez(Path(out_dir) / f"{name}.rank{rank}.npz", **saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp_cases")
    failure = []

    def launch():
        try:
            T.debug_launcher(cases_worker, args=(str(out), list(CASES)),
                             num_processes=N_RANKS, timeout=LAUNCH_TIMEOUT)
        except Exception as exc:  # re-raised below
            failure.append(exc)

    thread = threading.Thread(target=launch)
    thread.start()
    try:
        loopback = {name: run_case(name, loopback=True) for name in CASES}
    finally:
        thread.join(timeout=LAUNCH_TIMEOUT + 60)
    assert not thread.is_alive(), "the gloo launch did not return"
    if failure:
        raise failure[0]
    ranks = {name: [dict(np.load(out / f"{name}.rank{r}.npz")) for r in range(N_RANKS)]
             for name in CASES}
    return {"loopback": loopback, "ranks": ranks}


@pytest.mark.parametrize("name", sorted(CASES))
def test_process_group_pipeline_equals_the_loopback(runs, name):
    want = runs["loopback"][name]
    ranks = runs["ranks"][name]
    for saved in ranks:
        np.testing.assert_allclose(saved["losses"], want["losses"], rtol=LOSS_RTOL, atol=0)
    got = {k[2:]: v for k, v in ranks[0].items() if k.startswith("p.")}
    assert sorted(got) == sorted(want["params"]) and len(got) == 12
    for key, value in want["params"].items():
        np.testing.assert_allclose(got[key], value, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_send_what_the_loopback_hands_over(runs, name):
    """The loopback runs the ranks' tick loop: the same messages, the same
    bytes, none of them skipped."""
    want = runs["loopback"][name]
    ranks = runs["ranks"][name]
    mesh, schedule, _ = CASES[name]
    P, data = mesh["pp_size"], N_RANKS // mesh["pp_size"]
    # Each microbatch crosses every stage boundary once forward and, in the
    # backward, once back; a loopback holds every data coordinate's pipeline.
    assert want["messages"] == STEPS * 2 * (P - 1) * MICRO * data
    rows = BATCH // data // MICRO
    assert want["bytes"] == want["messages"] * rows * SEQ * CFG["hidden_size"] * 4
    assert sum(int(r["messages"]) for r in ranks) == want["messages"]
    assert sum(int(r["bytes"]) for r in ranks) == want["bytes"]


# ------------------------------------------------------- across four cards
FULL_DEPTH_MICRO, FULL_DEPTH_ROWS, FULL_DEPTH_SEQ = 8, 8, 4096
FULL_DEPTH_WARMUP, FULL_DEPTH_TIMED = 1, 2
NCCL_LOSS_ATOL = 1e-2  # bf16 NCCL against the loopback at 4 layers (the tp file's pin)
# bf16 logits of a few units from the same ops, a chunk of rows at a time
# (chip_smoke.py's PIPPY_LOGITS_ATOL); a wrong stage or a dropped layer
# moves them by whole units.
PIPPY_LOGITS_ATOL = 5e-2


def _four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < N_RANKS:
        pytest.skip(f"needs {N_RANKS} NVIDIA GPUs (one NCCL rank a card)")
    import subprocess

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    print(f"cards: {cards}")


def _spawn(fn, *args, timeout: float = 900.0):
    from test_torch_fsdp_dist import _spawn as spawn

    return spawn(fn, *args, timeout=timeout)


def _save(out_dir, **arrays):
    import torch.distributed as dist

    np.savez(Path(out_dir) / f"rank{dist.get_rank()}.npz", **arrays)


def _card_ranks(out_dir, n=N_RANKS):
    return [dict(np.load(Path(out_dir) / f"rank{r}.npz")) for r in range(n)]


def full_depth_pp_ranks(out_dir: str, device="cuda", cfg=None, seq=FULL_DEPTH_SEQ):
    """One stage of Llama-3-8B (32 layers, 8 a card) under NCCL pp 4 with
    1F1B, 8 microbatches of one 4096-token row, ``adamw(3e-4)``, clip 1.0
    (gloo on the CPU with ``device="cpu"`` and a small ``cfg``, the
    rehearsal)."""
    import time

    from accelerate_tpu_torch.ops import registry

    cuda = device == "cuda"
    acc = T.Accelerator(mixed_precision="bf16", device=device, pp_plugin=T.PipelineParallelPlugin(
        N_RANKS, FULL_DEPTH_MICRO, "1f1b"))
    model = T.Llama(T.LlamaConfig.llama3_8b(**(cfg or dict(max_position_embeddings=seq))),
                    device=device)
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4, device=device))
    del model
    step = acc.build_train_step(pm, po)
    batch = _batches(FULL_DEPTH_ROWS, seq, pm.module.config.vocab_size, seed=5, n=1)[0]
    losses, times = [], []
    registry.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for _ in range(FULL_DEPTH_WARMUP + FULL_DEPTH_TIMED):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch, clip_norm=1.0)))
        times.append(time.perf_counter() - t0)
    spec = pm.handle.pipeline_spec
    _save(out_dir, losses=np.asarray(losses), times=np.asarray(times),
          peak=np.asarray(torch.cuda.max_memory_allocated() if cuda else 0),
          fwd=np.asarray(registry.launch_counts.get("flash_attention_fwd", 0)),
          bwd=np.asarray(registry.launch_counts.get("flash_attention_bwd", 0)),
          saved=np.asarray(max(spec.peak_saved.values())),
          flops=np.asarray(pm.module.flops_per_token()))


@pytest.mark.cuda
def test_full_depth_pp4_1f1b_on_four_cards(tmp_path):
    """All 32 layers of Llama-3-8B train under NCCL pp 4 (1F1B): finite,
    falling losses; each card runs flash on its 8 layers, twice forward
    (the forward unit and the backward unit's recompute) and once backward
    a microbatch; at most 2 x pp stage inputs kept; peak memory, step time
    and MFU printed."""
    _four_cards()
    _spawn(full_depth_pp_ranks, str(tmp_path), timeout=1200.0)
    steps = FULL_DEPTH_WARMUP + FULL_DEPTH_TIMED
    tokens = FULL_DEPTH_ROWS * FULL_DEPTH_SEQ
    for r, saved in enumerate(_card_ranks(tmp_path)):
        losses = saved["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert int(saved["fwd"]) == 2 * 8 * FULL_DEPTH_MICRO * steps
        assert int(saved["bwd"]) == 8 * FULL_DEPTH_MICRO * steps
        assert int(saved["saved"]) <= 2 * N_RANKS
        step_s = float(np.median(saved["times"][FULL_DEPTH_WARMUP:]))
        mfu = float(saved["flops"]) * tokens / step_s / (N_RANKS * 989e12)
        print(f"full depth pp4 1f1b rank {r}: peak {int(saved['peak']) / 1e9:.2f} GB, step "
              f"{step_s:.4f} s, {tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% "
              f"(recompute not counted), losses {losses.tolist()}")
        assert int(saved["peak"]) < 80e9


def _pp_tp_losses(loopback: bool, batches, device="cuda", cfg=None):
    acc = T.Accelerator(mixed_precision="bf16", device=device,
                        parallelism_config=T.ParallelismConfig(pp_size=2, tp_size=2),
                        pp_plugin=T.PipelineParallelPlugin(2, 4, "1f1b"),
                        loopback=T.LoopbackShards(N_RANKS) if loopback else None)
    model = T.Llama(T.LlamaConfig.llama3_8b(**(cfg or dict(
        num_hidden_layers=4, max_position_embeddings=2048))), device=device)
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4, device=device))
    del model
    step = acc.build_train_step(pm, po)
    return np.asarray([float(step(b, clip_norm=1.0)) for b in batches])


def nccl_pp_tp_ranks(out_dir: str, batches, device="cuda", cfg=None):
    losses = _pp_tp_losses(False, batches, device, cfg)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    _save(out_dir, losses=losses, peak=np.asarray(peak))


@pytest.mark.cuda
def test_pp2_tp2_over_nccl_equals_its_loopback(tmp_path):
    _four_cards()
    batches = _batches(4, 2048, 128256, seed=9, n=3)
    _spawn(nccl_pp_tp_ranks, str(tmp_path), batches)
    want = _pp_tp_losses(True, batches)
    for saved in _card_ranks(tmp_path):
        assert np.isfinite(saved["losses"]).all()
        assert float(np.abs(saved["losses"] - want).max()) <= NCCL_LOSS_ATOL
    print(f"pp2 x tp2 NCCL losses {_card_ranks(tmp_path)[0]['losses'].tolist()}, loopback "
          f"{want.tolist()}, peaks "
          f"{[int(s['peak']) / 1e9 for s in _card_ranks(tmp_path)]} GB")


@pytest.mark.cuda
def test_prepare_pippy_on_four_cards_equals_one_card():
    """``prepare_pippy`` over ``cuda:0-3`` (8 of Llama-3-8B's 32 layers a
    card, bf16) gives the one-card forward's logits."""
    _four_cards()
    import time

    model = T.Llama(T.LlamaConfig.llama3_8b(max_position_embeddings=2048))
    model.init_params(0, dtype=torch.bfloat16)
    ids = torch.as_tensor(_batches(4, 2048, 128256, seed=11, n=1)[0]["input_ids"],
                          device="cuda")
    with torch.no_grad():
        want = model.apply(model.params, input_ids=ids)["logits"].float().cpu()
    piped = T.prepare_pippy(model, split_points="auto", num_chunks=4)
    assert len(piped.stage_ranges) == N_RANKS
    got = piped(input_ids=ids)["logits"]
    assert got.device == torch.device("cuda", N_RANKS - 1)
    diff = float((got.float().cpu() - want).abs().max())
    print(f"prepare_pippy 4 stages vs one card: logits max |diff| {diff}")
    assert diff <= PIPPY_LOGITS_ATOL
    for d in range(N_RANKS):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    piped(input_ids=ids)
    for d in range(N_RANKS):
        torch.cuda.synchronize(d)
    print(f"prepare_pippy 4 stages: {time.perf_counter() - t0:.4f} s a 4 x 2048 forward, "
          f"{[torch.cuda.max_memory_allocated(d) / 1e9 for d in range(N_RANKS)]} GB a card")
