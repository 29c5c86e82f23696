"""The port's ``dispatch_model`` over several cards in one process.

JAX-free: the card's machine, which has no JAX, runs it with ``python -m
pytest tests/test_torch_big_modeling_dist.py -m cuda --noconftest -s``.
Skipped below two cards.

Llama-3-8B widths, all 32 layers, bf16, random weights from a seed: the
resident model on ``cuda:0`` is the reference; ``dispatch_model`` with a map
that names ``cuda:0`` .. ``cuda:{n-1}`` spreads the stacked layers over the
n cards in contiguous ranges (``big_modeling``'s docstring). Its logits on a
4 x 64 batch are held to the one-card logits (relative Frobenius
``LOGITS_REL``; the same bf16 ops on the same weights, so bitwise unless a
card picks another cuBLAS algorithm), its greedy tokens to the one-card
ones, and each card's memory and the seconds a token are printed.
"""

import subprocess
import time

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.big_modeling import StreamedScanModel
from accelerate_tpu_torch.inference import generate_device_map
from accelerate_tpu_torch.utils.tree import flatten_with_paths

SEED = 0
BATCH, PROMPT, NEW_TOKENS = 4, 64, 16
LOGITS_REL = 1e-2


def _cards() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    print(f"cards: {cards}")
    return torch.cuda.device_count()


def map_naming(n: int) -> dict:
    """A device map that names ``cuda:0`` .. ``cuda:{n-1}`` (n <= 4): the
    embedding on the first card, the head on the last, the layers' leaf
    groups on the cards in turn (which card holds which group does not
    matter: the stacked layers spread over every named card)."""
    groups = ["layers.attn", "layers.mlp", "layers.input_norm", "layers.post_attn_norm"]
    dmap = {"embed": "cuda:0", "final_norm": f"cuda:{n - 1}", "lm_head": f"cuda:{n - 1}"}
    dmap.update({g: f"cuda:{(i + 1) % n}" for i, g in enumerate(groups)})
    return dmap


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return out, time.perf_counter() - t0


@pytest.mark.cuda
def test_llama3_8b_spread_over_every_card():
    n = _cards()
    assert n <= 4
    cfg = T.LlamaConfig.llama3_8b(max_position_embeddings=2048)
    model = T.Llama(cfg, device="cuda:0")
    model.init_params(SEED, dtype=torch.bfloat16)
    ids = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                               (BATCH, PROMPT)),
                          dtype=torch.int32, device="cuda:0")
    with torch.no_grad():
        want = model.apply(model.params, input_ids=ids)["logits"]
    T.generate(model, ids, max_new_tokens=2, device="cuda:0")  # warm-up, not timed
    want_tokens, one_s = _timed(lambda: T.generate(model, ids, max_new_tokens=NEW_TOKENS,
                                                   device="cuda:0"))

    dmap = map_naming(n)
    spread = T.dispatch_model(model, dmap, main_device="cuda:0")
    assert isinstance(spread, StreamedScanModel)
    ranges = [s[0] for s in spread.stages]
    devices = [s[1] for s in spread.stages]
    assert devices == [torch.device("cuda", i) for i in range(n)]
    assert ranges == generate_device_map(cfg.num_hidden_layers, n)
    torch.cuda.empty_cache()
    memory = [torch.cuda.memory_allocated(i) for i in range(n)]
    # Each card holds its range of layers, the first also the embedding, the
    # last the head, and little else (the 4 x 64 logits, the tokens).
    nbytes = lambda tree: sum(t.numel() * t.element_size()  # noqa: E731
                              for _, t in flatten_with_paths(tree))
    held = [nbytes(layers) for _, _, layers in spread.stages]
    held[0] += nbytes(spread.params["embed"])
    held[-1] += nbytes(spread.params["final_norm"]) + nbytes(spread.params["lm_head"])
    assert all(m <= h + 2**30 for m, h in zip(memory, held)), (memory, held)
    got, fwd_s = _timed(lambda: spread(input_ids=ids)["logits"])
    T.generate(spread, ids, max_new_tokens=2, device="cuda:0")  # warm-up, not timed
    got, want = got.float().cpu(), want.float().cpu()
    rel = float((got - want).norm() / want.norm())
    bitwise = torch.equal(got, want)
    tokens, spread_s = _timed(lambda: T.generate(spread, ids, max_new_tokens=NEW_TOKENS,
                                                 device="cuda:0"))
    print(f"dispatch_model over {n} cards, map {dmap}: layer ranges {ranges}; memory a card "
          f"{[round(m / 1e9, 2) for m in memory]} GB; logits rel Frobenius {rel:.3e} vs one "
          f"card ({'bitwise' if bitwise else 'not bitwise'}); forward {fwd_s:.3f} s; "
          f"{spread_s / NEW_TOKENS * 1e3:.1f} ms a token ({one_s / NEW_TOKENS * 1e3:.1f} on "
          f"one card)")
    assert rel <= LOGITS_REL
    assert torch.equal(tokens.cpu(), want_tokens.cpu())
