"""The ep axis over NCCL on four cards (``cuda``-marked, skipped on hosts
with fewer than four NVIDIA GPUs); JAX-free, so the card's machine runs it:

    python -m pytest tests/test_torch_ep_dist.py -m cuda --noconftest

``mixtral_config_from_hf`` of the published Mixtral-8x7B config, depth cut,
2 x 2048 seeded tokens, bf16, ``adamw(3e-4)``, clip 1.0:

- NCCL ep 4 and ep 2 x dp 2 at 2 layers: each of 3 steps' losses within
  ``NCCL_LOSS_ATOL`` of the unsharded loss on the parameters the ranks hold
  at that step (``test_utils.training.unsharded_loss``: in bf16 two
  free-running trajectories of the routed model part within three steps,
  so a layout is held step by step on its own parameters, as
  ``chip_smoke.py`` phase 20 does); ep 2 x dp 2 also within
  ``NCCL_LOSS_ATOL`` of its loopback (``LoopbackShards(4)`` on one card);
- NCCL ep 4 at 8 layers (3,416,592,384 parameters a card): finite losses,
  each card's peak memory under 80 GB, the step time and the active MFU
  against 989 TFLOP/s a card printed.
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.test_utils.training import unsharded_loss

N_RANKS = 4
NCCL_LOSS_ATOL = 1e-2  # bf16: the expert products and the combine sum in another order
STEPS, WARMUP = 3, 1
MIXTRAL_8X7B = dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, num_local_experts=8, num_experts_per_tok=2,
                    rope_theta=1e6, rms_norm_eps=1e-5, router_aux_loss_coef=0.02,
                    max_position_embeddings=32768, tie_word_embeddings=False,
                    sliding_window=None)
BATCH, SEQ = 2, 2048


def _four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < N_RANKS:
        pytest.skip(f"needs {N_RANKS} NVIDIA GPUs (one NCCL rank a card)")


def _spawn(fn, *args, timeout: float = 900.0):
    from test_torch_fsdp_dist import _spawn as spawn

    return spawn(fn, *args, timeout=timeout)


def _config(layers: int):
    import dataclasses

    return dataclasses.replace(T.mixtral_config_from_hf(MIXTRAL_8X7B),
                               num_hidden_layers=layers, max_position_embeddings=SEQ)


def _batch():
    ids = np.random.default_rng(9).integers(0, 32000, (BATCH, SEQ)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _train(layers: int, mesh: dict | None, loopback: bool = False,
           reference: bool = False) -> dict:
    """``STEPS`` fused steps on one model from the seed: losses, step
    seconds after ``WARMUP``, the peak memory of this card and, with
    ``reference``, ``unsharded_loss`` before each step."""
    kw = {}
    if mesh is not None:
        kw["parallelism_config"] = T.ParallelismConfig(**mesh)
        if loopback:
            kw["loopback"] = T.LoopbackShards(N_RANKS)
    acc = T.Accelerator(mixed_precision="bf16", **kw)
    model = T.MoELlama(_config(layers))
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4))
    del model
    step = acc.build_train_step(pm, po)
    torch.cuda.reset_peak_memory_stats()
    losses, times, refs = [], [], []
    for _ in range(STEPS):
        if reference:
            refs.append(unsharded_loss(pm, _batch()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(_batch(), clip_norm=1.0)))
        times.append(time.perf_counter() - t0)
    out = {"losses": np.asarray(losses), "times": np.asarray(times), "refs": np.asarray(refs),
           "peak": np.asarray(torch.cuda.max_memory_allocated()),
           "flops": np.asarray(pm.module.flops_per_token())}
    del acc, pm, po, step
    torch.cuda.empty_cache()
    return out


def ep_ranks(out_dir: str, layers: int, mesh: dict, reference: bool = False):
    import torch.distributed as dist

    saved = _train(layers, mesh, reference=reference)
    np.savez(Path(out_dir) / f"rank{dist.get_rank()}.npz", **saved)


def _ranks(out_dir):
    return [dict(np.load(Path(out_dir) / f"rank{r}.npz")) for r in range(N_RANKS)]


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [dict(ep_size=4, dp_size=1), dict(ep_size=2, dp_size=2)],
                         ids=["ep4", "ep2xdp2"])
def test_ep_over_nccl_holds_the_unsharded_function(tmp_path, mesh):
    _four_cards()
    _spawn(ep_ranks, str(tmp_path), 2, mesh, True)
    loopback = _train(2, mesh, loopback=True)["losses"] if mesh["dp_size"] > 1 else None
    for saved in _ranks(tmp_path):
        assert np.isfinite(saved["losses"]).all()
        assert float(np.abs(saved["losses"] - saved["refs"]).max()) <= NCCL_LOSS_ATOL, (
            saved["losses"], saved["refs"])
        if loopback is not None:
            assert float(np.abs(saved["losses"] - loopback).max()) <= NCCL_LOSS_ATOL, (
                saved["losses"], loopback)
    first = _ranks(tmp_path)[0]
    print(f"nccl {mesh}: losses {first['losses'].tolist()}, the unsharded loss on the same "
          f"parameters {first['refs'].tolist()}, loopback "
          f"{None if loopback is None else loopback.tolist()}, peak GB a card "
          f"{[int(s['peak']) / 1e9 for s in _ranks(tmp_path)]}")


@pytest.mark.cuda
def test_ep4_at_eight_layers_on_four_cards(tmp_path):
    """8 layers under NCCL ep 4: each card holds 2 of the 8 experts of
    every layer (3.42B parameters, 54.7 GB of f32 masters, moments and
    buffer) and fits 80 GB; step time and active MFU printed."""
    _four_cards()
    _spawn(ep_ranks, str(tmp_path), 8, dict(ep_size=4, dp_size=1))
    for r, saved in enumerate(_ranks(tmp_path)):
        assert np.isfinite(saved["losses"]).all()
        assert int(saved["peak"]) < 80e9
        step_s = float(np.median(saved["times"][WARMUP:]))
        # The ep ranks train one 2 x 2048 batch together.
        mfu = float(saved["flops"]) * BATCH * SEQ / step_s / (N_RANKS * 989e12)
        print(f"ep4 8 layers rank {r}: peak {int(saved['peak']) / 1e9:.2f} GB, step "
              f"{step_s:.4f} s, {BATCH * SEQ / step_s:.0f} tokens/s, active MFU "
              f"{100 * mfu:.2f}% of 4 x 989 TFLOP/s, losses {saved['losses'].tolist()}")
