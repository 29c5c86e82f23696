"""The classic-GPT decoders over NCCL on four cards (``cuda``-marked,
skipped on hosts with fewer than four NVIDIA GPUs); JAX-free, so the card's
machine runs it:

    python -m pytest tests/test_torch_gptx_dist.py -m cuda --noconftest -s

Published ``config.json`` values through the port's converters, bf16,
``adamw(3e-4)``, clip 1.0, seeded tokens:

- facebook/opt-30b's widths at 2 layers (1.61B parameters; relu, learned
  positions at offset 2, the head tied to ``wte``), 4 x 2048: NCCL tp 2 x
  fsdp 2 and pp 2 x dp 2 (1F1B), 3 steps each, every loss within
  ``NCCL_LOSS_ATOL`` of the same layout on ``LoopbackShards(4)`` on one
  card (the gradients meet in another order over NCCL);
- EleutherAI/pythia-6.9b at all 32 layers (6.86B parameters) under NCCL
  fsdp 4 with remat, one 2048-token row a card: finite, falling losses;
  each card's peak memory under 80 GB; the step time and the MFU against
  989 TFLOP/s a card printed, beside Llama-3-8B's fsdp 4 (26.2%, PR 13).

Rehearse a body on the CPU first: ``T.debug_launcher(layout_ranks,
args=(out, "tp2xfsdp2", "cpu", SMALL), num_processes=4)``.
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T

N_RANKS = 4
NCCL_LOSS_ATOL = 1e-2  # bf16 over NCCL against the loopback (the tp and ep files' pin)
STEPS, WARMUP = 3, 1
# facebook/opt-30b and EleutherAI/pythia-6.9b on the Hugging Face hub,
# config.json (chip_smoke.py's OPT_30B and PYTHIA_6_9B).
OPT_30B = dict(model_type="opt", vocab_size=50272, hidden_size=7168, ffn_dim=28672,
               num_hidden_layers=48, num_attention_heads=56, max_position_embeddings=2048,
               word_embed_proj_dim=7168, do_layer_norm_before=True, activation_function="relu",
               enable_bias=True)
PYTHIA_6_9B = dict(model_type="gpt_neox", vocab_size=50432, hidden_size=4096,
                   intermediate_size=16384, num_hidden_layers=32, num_attention_heads=32,
                   rotary_pct=0.25, rotary_emb_base=10000, max_position_embeddings=2048,
                   use_parallel_residual=True, hidden_act="gelu", tie_word_embeddings=False)
LAYOUTS = {
    "tp2xfsdp2": dict(parallelism_config=dict(tp_size=2, fsdp_size=2)),
    "pp2xdp2_1f1b": dict(parallelism_config=dict(pp_size=2, dp_size=2), schedule="1f1b"),
}
SEQ = 2048
# A rehearsal's widths on the CPU (gloo, f32), as config.json keys.
SMALL = dict(vocab_size=512, hidden_size=64, intermediate_size=128, ffn_dim=128,
             word_embed_proj_dim=64, num_attention_heads=4)


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


def _config(hf, family, layers, cut=None):
    """The port's config of ``hf`` (with ``cut``'s keys over it) at
    ``layers`` layers."""
    from accelerate_tpu_torch.models.convert import _get_family

    return _get_family(family)[1](dict(hf, **(cut or {}), num_hidden_layers=layers))


def _accelerator(layout, device, loopback=False, remat_fsdp=None):
    spec = LAYOUTS.get(layout, {})
    kw = {}
    if "parallelism_config" in spec:
        kw["parallelism_config"] = T.ParallelismConfig(**spec["parallelism_config"])
    if "schedule" in spec:
        kw["pp_plugin"] = T.PipelineParallelPlugin(2, 2, spec["schedule"])
    if remat_fsdp:
        kw["fsdp_plugin"] = T.FullyShardedDataParallelPlugin(fsdp_size=remat_fsdp,
                                                             activation_checkpointing=True)
    if loopback:
        kw["loopback"] = T.LoopbackShards(N_RANKS)
    return T.Accelerator(mixed_precision="bf16" if device == "cuda" else "no", device=device,
                         **kw)


def _train(cfg, acc, rows, device, steps=STEPS):
    """``steps`` fused steps of seeded ``rows`` x seq tokens on a model from
    the seed: losses, step seconds, this card's peak memory."""
    model = T.GPTX(cfg, device=device)
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4, device=device))
    del model
    step = acc.build_train_step(pm, po)
    seq = min(SEQ, cfg.max_position_embeddings)
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step({"input_ids": ids, "labels": ids}, clip_norm=1.0)))
        times.append(time.perf_counter() - t0)
    out = {"losses": np.asarray(losses), "times": np.asarray(times),
           "peak": np.asarray(torch.cuda.max_memory_allocated() if cuda else 0),
           "flops": np.asarray(pm.module.flops_per_token()), "tokens": np.asarray(rows * seq)}
    del acc, pm, po, step
    if cuda:
        torch.cuda.empty_cache()
    return out


def _save(out_dir, saved):
    import torch.distributed as dist

    np.savez(Path(out_dir) / f"rank{dist.get_rank()}.npz", **saved)


def _ranks(out_dir):
    return [dict(np.load(Path(out_dir) / f"rank{r}.npz")) for r in range(N_RANKS)]


def layout_ranks(out_dir: str, layout: str, device="cuda", cut=None):
    """One rank of ``layout`` at OPT-30B's widths, 2 layers, 4 x 2048 (NCCL
    on cards; gloo with ``device="cpu"`` and ``cut``, the rehearsal)."""
    cfg = _config(OPT_30B, "opt", 2, cut)
    _save(out_dir, _train(cfg, _accelerator(layout, device), N_RANKS, device))


def fsdp4_ranks(out_dir: str, device="cuda", cut=None, layers=32):
    """One rank of pythia-6.9b under fsdp 4 with remat, one 2048-token row
    a card (gloo with ``device="cpu"``, ``cut`` and fewer ``layers``, the
    rehearsal)."""
    cfg = _config(PYTHIA_6_9B, "gpt_neox", layers, cut)
    _save(out_dir, _train(cfg, _accelerator(None, device, remat_fsdp=N_RANKS), N_RANKS,
                          device))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layouts_over_nccl_hold_their_loopback(tmp_path, layout):
    _four_cards()
    _spawn(layout_ranks, str(tmp_path), layout)
    cfg = _config(OPT_30B, "opt", 2)
    want = _train(cfg, _accelerator(layout, "cuda", loopback=True), N_RANKS, "cuda")
    ranks = _ranks(tmp_path)
    for saved in ranks:
        assert np.isfinite(saved["losses"]).all()
        assert float(np.abs(saved["losses"] - want["losses"]).max()) <= NCCL_LOSS_ATOL, (
            saved["losses"], want["losses"])
    print(f"nccl {layout} (OPT-30B widths, 2 layers, 4 x {SEQ}): losses "
          f"{ranks[0]['losses'].tolist()}, loopback {want['losses'].tolist()}, step s "
          f"{float(np.median(ranks[0]['times'][WARMUP:])):.4f} (loopback "
          f"{float(np.median(want['times'][WARMUP:])):.4f}), peak GB a card "
          f"{[round(int(s['peak']) / 1e9, 2) for s in ranks]}")


@pytest.mark.cuda
def test_pythia_full_depth_fsdp4_on_four_cards(tmp_path):
    """All 32 layers of pythia-6.9b under NCCL fsdp 4 with remat: each card
    holds a quarter of the f32 masters, moments and buffer (27.4 GB) and
    fits 80 GB; step time and MFU printed."""
    _four_cards()
    _spawn(fsdp4_ranks, str(tmp_path), timeout=1200.0)
    for r, saved in enumerate(_ranks(tmp_path)):
        losses = saved["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert int(saved["peak"]) < 80e9
        step_s = float(np.median(saved["times"][WARMUP:]))
        tokens = int(saved["tokens"])
        mfu = float(saved["flops"]) * tokens / step_s / (N_RANKS * 989e12)
        print(f"pythia-6.9b fsdp 4, rank {r}: losses {losses.tolist()}, step {step_s:.4f} s, "
              f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of 4 x 989 TFLOP/s "
              f"(remat not counted), peak {int(saved['peak']) / 1e9:.2f} GB")
