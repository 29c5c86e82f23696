"""Autoregressive generation over the KV-cache decode path.

The PyTorch counterpart of ``accelerate_tpu/generation.py`` for decoder-only
greedy and sampled decoding: prefill once, then one cached forward per new
token. PyTorch runs eagerly, so the JAX ``lax.scan`` over decode steps is a
Python loop; shapes stay static (the cache is pre-allocated to prompt +
``max_new_tokens``, finished rows keep stepping and emit ``pad_token_id``).
Ragged batches are left-aligned so one cache write offset serves every row,
with token positions taken from the attention mask.

``matmul_precision="int8"`` runs the model's block projections through the
int8 matmul (``ops/int8.py``) on a memoized config variant of the module
(:func:`_precision_variant`); the parameters are shared. Beam search,
assisted (speculative) decoding and streamed (offloaded) models are not
ported yet and raise.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from .utils.device import resolve_device


def _warp_scores(scores, temperature: float = 1.0, top_k: int | None = None,
                 top_p: float | None = None):
    """The logits-warper chain (temperature → top-k → nucleus) on (..., V) rows."""
    scores = scores.float()
    if temperature and temperature != 1.0:
        scores = scores / temperature
    if top_k is not None and top_k > 0:
        kth = torch.sort(scores, dim=-1).values[..., -top_k][..., None]
        scores = torch.where(scores < kth, float("-inf"), scores)
    if top_p is not None and 0.0 < top_p < 1.0:
        srt = torch.flip(torch.sort(scores, dim=-1).values, dims=(-1,))
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Smallest score value still inside the nucleus, per row.
        inside = cum - probs < top_p
        cutoff = torch.where(inside, srt, float("inf")).amin(dim=-1, keepdim=True)
        scores = torch.where(scores < cutoff, float("-inf"), scores)
    return scores


def sample_logits(logits, generator=None, temperature: float = 1.0, top_k: int | None = None,
                  top_p: float | None = None):
    """Sample token ids from (B, V) logits with ``generator`` (a
    ``torch.Generator`` on the logits' device). temperature<=0 means greedy."""
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_warp_scores(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(torch.int32)


def left_align(input_ids, attention_mask):
    """Roll each right-padded row so its last real token lands at index S-1."""
    S = input_ids.shape[1]
    shifts = S - attention_mask.sum(dim=-1).long()  # pad count per row
    idx = (torch.arange(S, device=input_ids.device)[None] - shifts[:, None]) % S
    return input_ids.gather(1, idx), attention_mask.gather(1, idx)


def mask_positions(attention_mask):
    """Token positions from the attention mask: the count of real tokens
    before each one (cumsum - 1, clipped at 0)."""
    return torch.clamp(torch.cumsum(attention_mask.to(torch.int32), dim=-1) - 1, min=0).to(
        torch.int32)


def _unwrap(model):
    """(module, params) from a Module or a raw module with ``.params``."""
    return model, getattr(model, "params", None)


def _precision_variant(module, precision: str):
    """A shallow copy of ``module`` whose config has ``matmul_precision`` set,
    memoized on the module; the counterpart of the JAX package's
    ``_precision_variant``. The model routes its block projections through
    ``ops.int8.matmul(precision=config.matmul_precision)``, so the config
    field is the whole switch, and the parameters (quantized dynamically
    inside the matmul) are shared with the original module."""
    from .ops.int8 import PRECISIONS

    cfg = getattr(module, "config", None)
    if cfg is None or not hasattr(cfg, "matmul_precision"):
        raise ValueError(f"model {type(module).__name__} has no matmul_precision config field; "
                         "int8 serving needs a model routed through ops.int8.matmul")
    if precision not in PRECISIONS:
        raise ValueError(f"matmul precision must be 'default' or 'int8', got {precision!r}")
    if precision == cfg.matmul_precision:
        return module
    variants = module.__dict__.setdefault("_precision_variants", {})
    if precision not in variants:
        clone = copy.copy(module)
        clone.config = dataclasses.replace(cfg, matmul_precision=precision)
        clone.__dict__.pop("_precision_variants", None)
        variants[precision] = clone
    return variants[precision]


def generate(
    model,
    input_ids,
    *,
    max_new_tokens: int,
    params=None,
    attention_mask=None,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    generator: torch.Generator | None = None,
    eos_token_id: int | None = None,
    pad_token_id: int = 0,
    cache_dtype=torch.bfloat16,
    include_prompt: bool = True,
    num_beams: int = 1,
    num_return_sequences: int = 1,
    do_sample: bool = False,
    assistant_model=None,
    matmul_precision: str | None = None,
    device=None,
):
    """Generate ``max_new_tokens`` continuations for a batch of right-padded
    prompts (``attention_mask`` 1 = real for ragged batches).

    Runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``), where
    the model's parameters must live. Returns int32 ids of shape
    (B, prompt_len + max_new_tokens) when ``include_prompt`` else
    (B, max_new_tokens). Sampling draws from ``generator``.
    ``matmul_precision="int8"`` quantizes the block projections' operands
    dynamically (``ops/int8.py``); ``"default"`` or None leaves them exact."""
    if assistant_model is not None:
        raise NotImplementedError("assisted (speculative) generation is not ported yet (ROADMAP.md)")
    if num_beams > 1:
        raise NotImplementedError("beam search is not ported yet (ROADMAP.md)")
    module, mparams = _unwrap(model)
    if hasattr(module, "encode"):
        raise NotImplementedError("encoder-decoder generation is not ported yet (ROADMAP.md)")
    if matmul_precision not in (None, ""):
        module = _precision_variant(module, matmul_precision)
    params = mparams if params is None else params
    if params is None:
        raise ValueError("Model has no params; pass params= or init the model first.")
    dev = resolve_device(device)
    if module.device != dev:
        raise ValueError(f"model lives on {module.device}, generate was asked for {dev}")
    if do_sample and not (temperature and temperature > 0.0):
        temperature = 1.0  # HF do_sample semantics: sample at T=1 by default
    input_ids = torch.as_tensor(input_ids, device=dev).to(torch.int32)
    mask = (torch.as_tensor(attention_mask, device=dev).to(torch.int32)
            if attention_mask is not None else torch.ones_like(input_ids))
    if num_return_sequences != 1:
        if not (temperature and temperature > 0.0):
            raise ValueError("num_return_sequences > 1 needs sampling (do_sample/temperature > 0)")
        input_ids = input_ids.repeat_interleave(num_return_sequences, dim=0)
        mask = mask.repeat_interleave(num_return_sequences, dim=0)
    eos = -1 if eos_token_id is None else eos_token_id
    B, S = input_ids.shape
    cache = module.init_cache(B, S + max_new_tokens, dtype=cache_dtype)
    ids, amask = left_align(input_ids, mask)
    out = module.apply(params, input_ids=ids, attention_mask=amask, cache=cache,
                       positions=mask_positions(amask))
    pos = amask.sum(dim=-1).to(torch.int32)  # each row's next token position
    tok = sample_logits(out["logits"][:, -1], generator, temperature, top_k, top_p)
    # HF convention: the eos itself is emitted; only tokens AFTER it are pad.
    finished = tok == eos
    tokens = [tok]
    cache = out["cache"]
    for _ in range(max_new_tokens - 1):
        feed = torch.where(finished, pad_token_id, tok)
        out = module.apply(params, input_ids=feed[:, None], cache=cache, positions=pos[:, None])
        nxt = sample_logits(out["logits"][:, -1], generator, temperature, top_k, top_p)
        nxt = torch.where(finished, pad_token_id, nxt).to(torch.int32)
        cache, pos = out["cache"], pos + 1
        finished = finished | (nxt == eos)
        tokens.append(nxt)
        tok = nxt
    new_tokens = torch.stack(tokens, dim=1)
    if include_prompt:
        return torch.cat([input_ids, new_tokens], dim=1)
    return new_tokens
