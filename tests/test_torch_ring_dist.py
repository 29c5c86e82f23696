"""The port's ring attention across processes, and its kernels on the card.

This file imports no JAX, for two reasons: the ranks that
``debug_launcher`` spawns import their worker functions from here, and the
card's machine, which has no JAX, runs its ``cuda`` tests
(``python -m pytest tests/test_torch_package.py tests/test_torch_ring_dist.py
-m cuda --noconftest``). The JAX parity tests are in
``tests/test_torch_ring.py``, which drives the workers below.

- ``ProcessGroupRing`` over gloo in 4 CPU processes is BITWISE equal to
  ``LoopbackRing(4)`` run in each process on the same inputs: the two make
  the same block calls in the same order (forward outputs and q/k/v
  gradients; dense and flash blocks; causal, non-causal and padded). Each
  rank uses one thread, so the CPU matmuls sum in one order in both.
- Options that are not ported raise.
- ``cuda``-marked: each ring-block kernel against its plain twin, and the
  whole 4-rank ring with kernels against ``kernels="off"``; on hosts with
  four cards, the sp step over NCCL (one process a card, as ``torchrun``
  runs it) against the single-card step, with the NCCL ring bitwise equal
  to ``LoopbackRing`` on every card.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.parallel.ring import (
    LoopbackRing,
    _lse_to_m,
    ring_attention,
    ring_block_bwd_reference,
    ring_block_fwd_reference,
)
from accelerate_tpu_torch.utils.tree import tree_leaves, tree_map
from chip_smoke import FLASH_BWD_REL, FLASH_FWD_TILE_REL, RING_STATS_ATOL, tile_rel_err

torch.set_num_threads(2)

N_RANKS = 4
RING_CASES = [(impl, causal, masked) for impl in ("flash", "dense")
              for causal, masked in ((True, False), (False, False), (True, True))]


def ring_inputs(B=2, S=64, H=4, D=16, seed=0):
    """q, k, v (B, S, H, D) f32 and a (B, S) mask with right padding in
    row 0 and left padding in row 1 (its first rows see no real key)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal((B, S, H, D)).astype(np.float32))
               for _ in range(3))
    mask = np.ones((B, S), np.int32)
    mask[0, S - S // 4:] = 0
    mask[1, :S // 8 + 3] = 0
    return q, k, v, torch.as_tensor(mask)


def ring_worker(out_dir: str):
    """One rank: every case of RING_CASES through ProcessGroupRing on this
    rank's shards and through LoopbackRing(4) on all shards; saves both."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, n = dist.get_rank(), dist.get_world_size()
    q, k, v, mask = ring_inputs()
    saved = {}
    for c, (impl, causal, masked) in enumerate(RING_CASES):
        shards = [list(t.chunk(n, dim=1)) for t in (q, k, v)]
        mask_shards = list(mask.chunk(n, dim=1)) if masked else None
        mine = [s[rank].clone().requires_grad_() for s in shards]
        out = ring_attention(*mine, causal=causal, mask=None if mask_shards is None
                             else mask_shards[rank], block_impl=impl)
        (out ** 2).sum().backward()
        loop = [[s[r].clone().requires_grad_() for s in shards] for r in range(n)]
        outs = ring_attention(*zip(*loop), causal=causal, mask=mask_shards,
                              group=LoopbackRing(n), block_impl=impl)
        sum((o ** 2).sum() for o in outs).backward()
        for name, a, b in [("out", out, outs[rank])] + [
                (f"d{x}", t.grad, u.grad) for x, t, u in zip("qkv", mine, loop[rank])]:
            saved[f"{c}_{name}_pg"] = a.detach().numpy()
            saved[f"{c}_{name}_loop"] = b.detach().numpy()
    from accelerate_tpu_torch.utils.operations import broadcast, reduce

    saved["reduced"] = np.asarray([float(reduce(torch.tensor([float(rank)]), "sum")),
                                   float(reduce(torch.tensor([float(rank)]), "mean")),
                                   float(broadcast(torch.tensor([float(rank)]), src=2))])
    np.savez(Path(out_dir) / f"rank{rank}.npz", **saved)


def sp_step_worker(out_dir: str, sp_size: int, dp_size: int, jax_params, batches,
                   check_refusals: bool):
    """One rank of the sequence-parallel training step: the tiny Llama with
    ``attention_impl="ring"`` from the JAX package's weights, adamw(3e-4),
    three steps at clip_norm=1.0 on the GLOBAL batches; saves the losses and
    the final parameters (and, with ``check_refusals``, which prepare-time
    refusals raised). Ranks other than 0 start from shifted weights, which
    ``prepare`` must replace by rank 0's."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    acc = T.Accelerator(mixed_precision="no", device="cpu",
                        parallelism_config=T.ParallelismConfig(sp_size=sp_size, dp_size=dp_size))
    saved = {"coordinate": np.asarray(acc.mesh.get_coordinate())}
    if check_refusals:
        for name, kw in (("window", dict(sliding_window=8)),
                         ("layer_windows", dict(layer_windows=(8, None))),
                         ("softcap", dict(attn_logit_softcap=50.0)),
                         ("query_scale", dict(query_pre_attn_scalar=16.0)),
                         ("flash_impl", dict(attention_impl="flash"))):
            model = T.Llama(T.LlamaConfig.tiny(**kw), device="cpu")
            model.init_params(0)
            try:
                acc.prepare(model)
                saved[f"refused_{name}"] = np.asarray(False)
            except ValueError:
                saved[f"refused_{name}"] = np.asarray(True)
    model = T.Llama(T.LlamaConfig.tiny(attention_impl="ring"), device="cpu")
    model.params = T.llama_params_from_numpy(jax_params, model.config, device="cpu")
    if rank:  # prepare hands every rank rank 0's parameters
        for leaf in tree_leaves(model.params):
            leaf.add_(float(rank))
    pm, po = acc.prepare(model, T.adamw(3e-4, device="cpu"))
    step = acc.build_train_step(pm, po)
    saved["losses"] = np.asarray([float(step(b, clip_norm=1.0)) for b in batches])
    for i, leaf in enumerate(tree_leaves(pm.params)):
        saved[f"param{i}"] = leaf.numpy()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **saved)


def load_ranks(out_dir, n=N_RANKS):
    return [dict(np.load(Path(out_dir) / f"rank{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    T.debug_launcher(ring_worker, args=(str(out),), num_processes=N_RANKS)
    return load_ranks(out)


@pytest.mark.parametrize("case", range(len(RING_CASES)),
                         ids=[f"{i}-{'causal' if c else 'full'}{'-padded' if m else ''}"
                              for i, c, m in RING_CASES])
def test_process_group_ring_bitwise_equals_loopback(ring_run, case):
    """Exact equality, every rank, output and the three gradients."""
    for rank, saved in enumerate(ring_run):
        for name in ("out", "dq", "dk", "dv"):
            a, b = saved[f"{case}_{name}_pg"], saved[f"{case}_{name}_loop"]
            assert a.shape == b.shape and np.isfinite(a).all()
            assert np.array_equal(a, b), (rank, name, float(np.abs(a - b).max()))


def test_collectives_over_the_ring_ranks(ring_run):
    """reduce sums and averages over the ranks; broadcast hands out rank 2's
    value."""
    for saved in ring_run:
        assert saved["reduced"].tolist() == [6.0, 1.5, 2.0]


def test_unported_sequence_parallel_options_raise():
    with pytest.raises(NotImplementedError, match="Ulysses"):
        T.Accelerator(device="cpu", sp_plugin=T.SequenceParallelPlugin(4, ring_attention=False))
    for axis in ("fsdp_size", "tp_size", "pp_size", "ep_size"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.ParallelismConfig(**{axis: 2})
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="ulysses"):
        T.ops.attention.attention(x, x, x, impl="ulysses")
    with pytest.raises(ValueError, match="window"):
        T.ops.attention.attention(x, x, x, impl="ring", window=4)
    # One process cannot make an sp = 4 mesh.
    with pytest.raises(ValueError, match="dp x sp mesh"):
        T.Accelerator(device="cpu", sp_plugin=T.SequenceParallelPlugin(4))


def test_single_process_keeps_no_mesh():
    """World size 1 without an sp axis is the single-process step: no mesh,
    no process group, and attention_impl='ring' runs dense attention."""
    import torch.distributed as dist

    acc = T.Accelerator(device="cpu")
    assert acc.mesh is None and not dist.is_initialized()
    q, k, v, mask = ring_inputs(S=16)
    out = ring_attention(q, k, v, causal=True, mask=mask)
    ref = T.ops.attention.dense_attention(q, k, v, causal=True, mask=mask)
    assert torch.equal(out, ref)


def test_shard_batch_shifts_labels_on_the_global_sequence():
    """A rank's shard: its dp rows and sp tokens, global positions, and
    targets shifted before sharding, so a shard's last token targets the
    next shard's first; a pad, and a token whose target is a pad, is -100."""
    from accelerate_tpu_torch.utils.transfer import shard_batch

    ids = np.arange(2 * 16, dtype=np.int32).reshape(2, 16)
    mask = np.ones((2, 16), np.int32)
    mask[1, 13:] = 0
    batch = {"input_ids": ids, "labels": ids, "attention_mask": mask}
    shift = T.Llama._shift_labels
    for dp_index, sp_index in ((0, 0), (1, 2), (1, 3)):
        got = shard_batch(batch, "cpu", dp_index=dp_index, dp_size=2, sp_index=sp_index,
                          sp_size=4, shift_labels=shift)
        cols = slice(4 * sp_index, 4 * sp_index + 4)
        assert torch.equal(got["input_ids"], torch.as_tensor(ids[dp_index:dp_index + 1, cols]))
        assert got["positions"].tolist() == [list(range(4 * sp_index, 4 * sp_index + 4))]
        want = shift(torch.as_tensor(ids), torch.as_tensor(mask))[dp_index:dp_index + 1, cols]
        assert torch.equal(got["targets"], want)
    last = shard_batch(batch, "cpu", dp_index=0, dp_size=2, sp_index=1, sp_size=4,
                       shift_labels=shift)["targets"]
    assert int(last[0, -1]) == int(ids[0, 8])  # the next shard's first token
    tail = shard_batch(batch, "cpu", dp_index=1, dp_size=2, sp_index=3, sp_size=4,
                       shift_labels=shift)["targets"]
    assert tail[0].tolist() == [-100] * 4  # 12's target (13) is a pad; 13-15 are pads
    with pytest.raises(ValueError, match="equal shards"):
        shard_batch({"input_ids": ids[:, :15]}, "cpu", dp_index=0, dp_size=2, sp_index=0,
                    sp_size=4, shift_labels=shift)


# --------------------------------------------------------------- on the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this comparison on the card")


def _card_block(S=256, H=4, D=64, seed=0, pad=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((1, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    mask = None
    if pad is not None:
        mask = torch.ones((1, S), dtype=torch.int32, device="cuda")
        mask[:, pad] = 0
    return q, k, v, do, mask


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("mode,pad,S", [(0, None, 256), (1, None, 256), (1, slice(-80, None), 256),
                                        (1, slice(None, None), 256), (2, None, 256),
                                        (0, None, 192), (1, slice(100, 150), 320),
                                        (0, slice(0, 100), 192)],
                         ids=["diagonal", "full", "full-padded", "full-all-pads", "skip",
                              "diagonal-ragged-192", "full-pads-inside-tiles-320",
                              "diagonal-rows-see-no-key-192"])
def test_ring_block_kernels_match_twins_on_the_card(mode, pad, S, D):
    """Forward: o per 64-row query tile within FLASH_FWD_TILE_REL of the
    twin on rows that see a key, l and m within RING_STATS_ATOL relative,
    and rows with no visible key exactly (0, 0, -1e30). Backward from a
    global lse and delta: dq, dk, dv within FLASH_BWD_REL (relative
    Frobenius), accumulated into nonzero f32 buffers. A shard of 192 or 320
    leaves the kernels' last 128-row tile half past the end; left pads on
    the diagonal block leave the first 100 rows with no key at all."""
    _needs_card()
    q, k, v, do, mask = _card_block(S=S, D=D, pad=pad)
    registry.reset_launch_counts()
    o, l, m = registry.dispatch("ring_block_fwd", q, k, v, mask, mode)
    o_ref, l_ref, m_ref = ring_block_fwd_reference(q, k, v, mask, mode)
    torch.cuda.synchronize()
    launched = {} if mode == 2 else {"ring_block_fwd": 1}
    assert registry.launch_counts == launched
    seen = l_ref > 0
    assert torch.equal(l[~seen], l_ref[~seen]) and torch.equal(m[~seen], m_ref[~seen])
    if bool(seen.any()):
        real = seen[:, 0]
        assert tile_rel_err(o, o_ref, real) <= FLASH_FWD_TILE_REL
        assert float(((l - l_ref).abs() / l_ref.clamp(min=1))[seen].max()) <= RING_STATS_ATOL
        assert float((m - m_ref)[seen].abs().max()) <= RING_STATS_ATOL
    assert bool((o.float()[~seen.transpose(1, 2)[..., None].expand_as(o)] == 0).all())
    # Backward against a global lse and delta (as the ring passes them).
    lse = _lse_to_m(torch.where(seen, m_ref + torch.log(l_ref.clamp(min=1e-30)), torch.inf))
    delta = (o_ref.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    start = [torch.randn(q.shape, device="cuda") for _ in range(3)]
    got = [s.clone() for s in start]
    want = [s.clone() for s in start]
    registry.reset_launch_counts()
    registry.dispatch("ring_block_bwd", q, k, v, mask, mode, lse, do, delta, *got)
    ring_block_bwd_reference(q, k, v, mask, mode, lse, do, delta, *want)
    torch.cuda.synchronize()
    assert registry.launch_counts == ({} if mode == 2 else {"ring_block_bwd": 1})
    for a, b, s in zip(got, want, start):
        da, db = a - s, b - s
        if float(db.norm()) == 0:
            assert float(da.abs().max()) == 0
            continue
        assert float((da - db).norm() / db.norm()) <= FLASH_BWD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_whole_ring_kernels_match_kernels_off_on_the_card(masked):
    """LoopbackRing(4) at s_loc = 256, bf16: forward per query tile and
    gradients within flash's pins; 4 + 6 launches each way when causal."""
    _needs_card()
    n, S, H, D = 4, 1024, 4, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn((1, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    mask = None
    if masked:
        mask = torch.ones((1, S), dtype=torch.int32, device="cuda")
        mask[:, 600:700] = 0
    results = []
    for kernels in (None, "off"):
        leaves = [[t.clone().requires_grad_() for t in s] for s in
                  zip(*(x.chunk(n, dim=1) for x in (q, k, v)))]
        registry.reset_launch_counts()
        outs = ring_attention(*zip(*leaves), causal=True, group=LoopbackRing(n),
                              mask=None if mask is None else list(mask.chunk(n, dim=1)),
                              kernels=kernels)
        torch.autograd.backward(outs, list(do.chunk(n, dim=1)))
        torch.cuda.synchronize()
        counts = dict(registry.launch_counts)
        results.append((torch.cat(outs, 1).detach(),
                        [torch.cat([lv[i].grad for lv in leaves], 1) for i in range(3)], counts))
    (out, grads, counts), (out_ref, grads_ref, counts_ref) = results
    assert counts == {"ring_block_fwd": 10, "ring_block_bwd": 10} and counts_ref == {}
    real = torch.ones((1, S), dtype=torch.bool, device="cuda")
    assert tile_rel_err(out, out_ref, real) <= FLASH_FWD_TILE_REL
    for a, b in zip(grads, grads_ref):
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= FLASH_BWD_REL



# ------------------------------------------------------- across four cards
# The sp step over NCCL, one process per card: the path `torchrun
# --nproc_per_node=4` runs. Marked `cuda` and skipped on hosts with fewer
# than four cards (the one-card runs of the `cuda` tests skip it).
NCCL_CFG = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
NCCL_BATCH, NCCL_SEQ, NCCL_STEPS = 2, 1024, 3


def nccl_batches():
    rng = np.random.default_rng(3)
    out = []
    for i in range(NCCL_STEPS):
        ids = rng.integers(0, 256, (NCCL_BATCH, NCCL_SEQ)).astype(np.int32)
        batch = {"input_ids": ids, "labels": ids}
        if i == 1:  # right padding that ends inside the third shard of row 1
            mask = np.ones(ids.shape, np.int32)
            mask[1, 600:] = 0
            batch["attention_mask"] = mask
        out.append(batch)
    return out


def nccl_ranks(out_dir: str, params, device=None):
    """One rank: ProcessGroupRing against LoopbackRing on the rank's device
    (bf16, bitwise), then three sp steps of a small Llama in bf16. On cards
    this rank's process joins NCCL here (``Accelerator``); ``device="cpu"``
    joins a gloo group that a launcher made (the rehearsal on the CPU)."""
    import torch.distributed as dist

    acc = T.Accelerator(mixed_precision="bf16", device=device,
                        sp_plugin=T.SequenceParallelPlugin(N_RANKS))
    rank, dev = dist.get_rank(), acc.device
    q, k, v, mask = (t.to(dev) for t in ring_inputs(S=256 * N_RANKS, D=64))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    saved = {"device": np.asarray(torch.cuda.current_device() if dev.type == "cuda" else rank)}
    for masked in (False, True):
        shards = [list(t.chunk(N_RANKS, dim=1)) for t in (q, k, v)]
        mask_shards = list(mask.chunk(N_RANKS, dim=1)) if masked else None
        mine = [s[rank].clone().requires_grad_() for s in shards]
        out = ring_attention(*mine, causal=True, group=acc.mesh.get_group("sp"),
                             mask=None if mask_shards is None else mask_shards[rank])
        (out.float() ** 2).sum().backward()
        loop = [[s[r].clone().requires_grad_() for s in shards] for r in range(N_RANKS)]
        outs = ring_attention(*zip(*loop), causal=True, group=LoopbackRing(N_RANKS),
                              mask=mask_shards)
        sum((o.float() ** 2).sum() for o in outs).backward()
        for name, a, b in [("out", out, outs[rank])] + [
                (f"d{x}", t.grad, u.grad) for x, t, u in zip("qkv", mine, loop[rank])]:
            saved[f"{masked}_{name}_equal"] = np.asarray(torch.equal(a, b))
    model = T.Llama(T.LlamaConfig.tiny(**NCCL_CFG), device=dev)
    model.params = T.llama_params_from_numpy(params, model.config, device=dev)
    pm, po = acc.prepare(model, T.adamw(3e-4, device=dev))
    step = acc.build_train_step(pm, po)
    registry.reset_launch_counts()
    saved["losses"] = np.asarray([float(step(b, clip_norm=1.0)) for b in nccl_batches()])
    saved["launches"] = np.asarray([registry.launch_counts.get("ring_block_fwd", 0),
                                    registry.launch_counts.get("ring_block_bwd", 0)])
    for i, leaf in enumerate(tree_leaves(pm.params)):
        saved[f"param{i}"] = leaf.cpu().numpy()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **saved)


def nccl_worker(rank: int, port: int, out_dir: str, params):
    """A spawned rank on card ``rank``: torchrun's environment, then
    :func:`nccl_ranks`."""
    import os

    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(N_RANKS), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        nccl_ranks(out_dir, params)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def nccl_run(tmp_path_factory):
    import socket

    import torch.multiprocessing as mp

    if torch.cuda.device_count() < N_RANKS:
        pytest.skip(f"needs {N_RANKS} NVIDIA GPUs (one NCCL rank a card)")
    model = T.Llama(T.LlamaConfig.tiny(**NCCL_CFG), device="cpu")
    params = tree_map(lambda t: t.numpy(), model.init_params(0))
    # The single-card reference: the same model and batches, flash on the
    # whole sequence.
    ref = T.Llama(T.LlamaConfig.tiny(attention_impl="flash", **NCCL_CFG))
    ref.params = T.llama_params_from_numpy(params, ref.config)
    acc = T.Accelerator(mixed_precision="bf16")
    pm, po = acc.prepare(ref, T.adamw(3e-4))
    step = acc.build_train_step(pm, po)
    ref_losses = np.asarray([float(step(b, clip_norm=1.0)) for b in nccl_batches()])
    del ref, pm, po, step, acc
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = tmp_path_factory.mktemp("nccl")
    mp.start_processes(nccl_worker, args=(port, str(out), params), nprocs=N_RANKS, join=True,
                       start_method="spawn")
    return load_ranks(out), ref_losses


@pytest.mark.cuda
def test_ring_over_nccl_bitwise_equals_loopback_on_four_cards(nccl_run):
    """Each rank on its own card: the NCCL ring's output and gradients equal
    LoopbackRing's on that card bit for bit (the same kernels in the same
    order), unpadded and padded."""
    ranks, _ = nccl_run
    for rank, saved in enumerate(ranks):
        assert int(saved["device"]) == rank
        for key in (k for k in saved if k.endswith("_equal")):
            assert bool(saved[key]), (rank, key)


@pytest.mark.cuda
def test_sp_step_over_nccl_on_four_cards(nccl_run):
    """Three bf16 sp steps over NCCL: rank r launches r + 1 blocks a layer
    each way (its diagonal and the r blocks before it; 4 + 6 over the ring),
    identical parameters on every rank, and losses within chip_smoke's
    TRAIN_LOSS_ATOL of the single-card step (flash on the whole sequence)."""
    from chip_smoke import TRAIN_LOSS_ATOL

    ranks, ref_losses = nccl_run
    for rank, saved in enumerate(ranks):
        assert saved["launches"].tolist() == [NCCL_STEPS * 2 * (rank + 1)] * 2
        assert np.isfinite(saved["losses"]).all()
        assert float(np.abs(saved["losses"] - ref_losses).max()) <= TRAIN_LOSS_ATOL
        for key in (k for k in saved if k.startswith("param")):
            assert np.array_equal(saved[key], ranks[0][key]), key
