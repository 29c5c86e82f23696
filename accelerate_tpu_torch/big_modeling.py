"""Big-model loading and offloaded inference — the counterpart of
``accelerate_tpu/big_modeling.py``.

- **Empty init**: under ``init_empty_weights`` a model's ``init_params``
  builds its tree on the ``meta`` device (shapes and dtypes, no memory, no
  random numbers), as ``jax.eval_shape`` does in the JAX package; the
  planner (``utils/modeling.py``) sizes and places it from that.
- **Loading**: ``load_checkpoint_and_dispatch`` reads a safetensors
  checkpoint (sharded or not) as memory maps and places each leaf on its
  target straight from the file. A ``meta`` leaf is never moved (PyTorch
  cannot copy out of one): each is replaced by its checkpoint tensor, or by
  a placeholder of a weight written to the offload folder.
- **Dispatch**: a device map's ``cuda:i`` entries are cards, ``"cpu"`` is
  host offload and ``"disk"`` an offload folder (``utils/offload.py``). When
  the stacked layers are offloaded and the rest stays on cards, the returned
  :class:`StreamedScanModel` runs each layer on the execution device, its
  weights copied in just before it (host layers from pinned memory on a side
  stream, layer ``i + 1``'s copy issued before layer ``i`` runs); otherwise
  an offloaded model runs under one whole-tree ``AlignDevicesHook``.
- **Several cards in one process**: the JAX package runs a map that names
  several chips as GSPMD sharding over a mesh of them. PyTorch in one process
  has no such compiler, so the port spreads the stacked layers over the
  named cards in contiguous ranges (``inference.generate_device_map``'s
  split, the first ranges the longest) and moves the residual stream from
  card to card, as ``prepare_pippy`` does; each non-layer block stays where
  the map puts it. The function and the set of cards are the map's, and the
  weights' memory spreads over the cards as under the JAX package's
  sharding; which card a map gives the layers does not matter (as under the
  sharding).

A CPU run names its execution device ``main_device="cpu"`` (or
``execution_device="cpu"``): a map's ``"cpu"`` means offload, and its card
targets then resolve to the CPU. Without a card and without that argument
every entry point raises.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
from typing import Mapping

import torch

from .hooks import (
    AlignDevicesHook,
    CpuOffload,
    LayerwiseCastingHook,
    UserCpuOffloadHook,
    _to,
    add_hook_to_module,
)
from .inference import generate_device_map
from .modules import init_device
from .utils.device import resolve_device
from .utils.modeling import (
    OFFLOAD_TARGETS,
    check_device_map,
    device_for_target,
    get_balanced_memory,
    infer_auto_device_map,
    load_checkpoint_in_model,
    meta_like,
    named_parameters,
    param_target,
    unflatten_names,
)
from .utils.offload import OffloadedWeightsLoader, offload_state_dict
from .utils.tree import tree_map


@contextlib.contextmanager
def init_empty_weights(include_buffers: bool = False):
    """Inside, ``model.init_params()`` builds the tree on the ``meta``
    device: zero bytes, for planning and loading models of any size."""
    with init_device("meta"):
        yield


@contextlib.contextmanager
def init_on_device(device):
    """Inside, ``model.init_params()`` builds straight on ``device`` (which
    raises without a card unless it is the CPU or ``meta``)."""
    dev = torch.device(device)
    with init_device(dev if dev.type == "meta" else resolve_device(dev)):
        yield


# ------------------------------------------------------------------ offload APIs
def cpu_offload(model, execution_device=None, offload_buffers: bool = False, state_dict=None):
    """The whole tree kept on the host, moved to ``execution_device``
    (``cuda`` unless given) for each forward."""
    dev = resolve_device(execution_device)
    if getattr(model, "params", None) is not None:
        model.params = _to(model.params, "cpu")
    add_hook_to_module(model, AlignDevicesHook(execution_device=dev, io_same_device=True))
    return model


def cpu_offload_with_hook(model, execution_device=None, prev_module_hook=None):
    """Host offload with a handle that moves the model back to the host
    (``handle.offload()``), for chains of models; ``prev_module_hook``
    offloads the previous model when this one runs."""
    hook = CpuOffload(execution_device=execution_device, prev_module_hook=prev_module_hook)
    add_hook_to_module(model, hook)
    return model, UserCpuOffloadHook(model, hook)


def disk_offload(model, offload_dir: str, execution_device=None, offload_buffers: bool = False):
    """The whole tree written to ``offload_dir`` and replaced by ``meta``
    placeholders; each forward reads it back onto ``execution_device``."""
    params = getattr(model, "params", None)
    if params is None:
        raise ValueError("Model has no params to offload; call model.init_params() first.")
    dev = resolve_device(execution_device)
    offload_state_dict(offload_dir, {k: v for k, v in named_parameters(params).items()
                                     if v.device.type != "meta"})
    model.params = tree_map(meta_like, params)
    add_hook_to_module(model, AlignDevicesHook(
        execution_device=dev, weights_map=OffloadedWeightsLoader(save_folder=offload_dir),
        io_same_device=True))
    return model


def attach_layerwise_casting_hooks(module, storage_dtype=None, compute_dtype=torch.bfloat16,
                                   skip_modules_pattern=None, skip_modules_classes=None,
                                   non_blocking: bool = False):
    """Parameters stored in ``storage_dtype`` (bf16 unless given), cast to
    ``compute_dtype`` inside each forward."""
    add_hook_to_module(module, LayerwiseCastingHook(storage_dtype or torch.bfloat16,
                                                    compute_dtype))
    return module


# ---------------------------------------------------------------------- dispatch
def _supports_streaming(model, targets) -> bool:
    """Layer streaming needs the embed / block / head protocol with stacked
    ``layers``, and nothing but ``layers`` offloaded."""
    if not all(hasattr(model, m) for m in ("embed", "block", "head")):
        return False
    params = getattr(model, "params", None)
    if not isinstance(params, dict) or "layers" not in params:
        return False
    return not [n for n, t in targets.items()
                if t in OFFLOAD_TARGETS and not n.startswith("layers.")]


def dispatch_model(model, device_map: Mapping[str, str], main_device=None, state_dict=None,
                   offload_dir: str | None = None, offload_index: Mapping | None = None,
                   offload_buffers: bool = False, skip_keys=None, preload_module_classes=None,
                   force_hooks: bool = False):
    """Execute a placement plan: card leaves go to their cards, ``"cpu"``
    leaves stay on the host, ``"disk"`` leaves are written to
    ``offload_dir``. Returns the model itself when everything is on one
    card; a :class:`StreamedScanModel` when only the stacked layers are
    offloaded, or when the map names several cards (module docstring); else
    the model under a whole-tree ``AlignDevicesHook``. ``main_device`` is
    the execution device (``cuda`` unless given)."""
    params = getattr(model, "params", None)
    if params is None:
        raise ValueError("Model has no params; call model.init_params() (possibly under "
                         "init_empty_weights).")
    device_map = dict(device_map)
    check_device_map(params, device_map)
    flat = named_parameters(params)
    targets = {name: param_target(name, device_map) for name in flat}
    has_offload = any(t in OFFLOAD_TARGETS for t in targets.values())
    has_disk = any(t == "disk" for t in targets.values())
    if has_disk and offload_dir is None and offload_index is None:
        raise ValueError("Disk offload requested in device_map but no offload_dir was given.")
    execution_device = resolve_device(main_device)
    cards = {t: device_for_target(t, main_device) for t in sorted(set(targets.values()))
             if t not in OFFLOAD_TARGETS}
    layer_offloaded = any(t in OFFLOAD_TARGETS for n, t in targets.items()
                          if n.startswith("layers."))
    spread = len(cards) > 1 and not layer_offloaded
    streaming = _supports_streaming(model, targets)
    if spread and not streaming:
        raise NotImplementedError(
            f"a device_map over several cards spreads stacked layers (the embed / block / head "
            f"protocol); {type(model).__name__} does not have it")
    pin = execution_device.type == "cuda" and streaming

    new_flat, disk_spill = {}, {}
    for name, leaf in flat.items():
        t = targets[name]
        on_meta = leaf.device.type == "meta"
        if t == "disk":
            if not on_meta:
                disk_spill[name] = leaf
            new_flat[name] = meta_like(leaf)
        elif t == "cpu":
            host = leaf if on_meta else leaf.to("cpu")
            new_flat[name] = host.pin_memory() if pin and not on_meta else host
        elif on_meta or (spread and name.startswith("layers.")):
            new_flat[name] = leaf  # left for the checkpoint, or spread below
        else:
            new_flat[name] = leaf.to(cards[t])
    if disk_spill:
        if offload_dir is None:
            raise ValueError("device_map sends live weights to 'disk' but no offload_dir was "
                             "given; pass offload_dir= (offload_index alone only covers "
                             "weights already on disk).")
        offload_state_dict(offload_dir, disk_spill)

    if spread:
        devices = [cards[t] for t in sorted(cards, key=lambda t: (cards[t].index or 0, t))]
        ranges = generate_device_map(_num_layers(model), len(devices))
        layers = unflatten_names({n[len("layers."):]: v for n, v in new_flat.items()
                                  if n.startswith("layers.")}, params["layers"])
        # A copy even on the same card: a view would keep the whole stack alive.
        stage_layers = [tree_map(lambda t, a=a, b=b, d=d: t[a:b].to(d, copy=True), layers)
                        for (a, b), d in zip(ranges, devices)]
        new_flat.update({n: meta_like(v) for n, v in new_flat.items()
                         if n.startswith("layers.")})
    model.params = unflatten_names(new_flat, params)
    model._at_device_map = device_map
    if spread:
        return StreamedScanModel(model, None, execution_device,
                                 stages=list(zip(ranges, devices, stage_layers)))
    if not has_offload and not force_hooks:
        return model

    weights_map = OffloadedWeightsLoader(
        state_dict={k: v for k, v in new_flat.items()
                    if targets[k] == "cpu" and v.device.type != "meta"},
        save_folder=offload_dir if has_disk else None, index=offload_index)
    if streaming:
        return StreamedScanModel(model, weights_map, execution_device)
    add_hook_to_module(model, AlignDevicesHook(
        execution_device=execution_device, weights_map=weights_map, io_same_device=True))
    return model


def _num_layers(model) -> int:
    cfg = getattr(model, "config", None)
    n = getattr(cfg, "num_hidden_layers", None) or getattr(cfg, "num_layers", None)
    if n is None:  # the leading dim of any stacked leaf
        n = next(iter(named_parameters(model.params["layers"]).values())).shape[0]
    return n


class StreamedScanModel:
    """Layer-by-layer execution of a stacked decoder whose layers do not sit
    whole on one card.

    Streamed (``stages=None``): every layer runs on ``execution_device``,
    its weights read from ``weights_map`` (the host's pinned tensors, or an
    offload folder's memory maps) one layer at a time; on a card the copy of
    layer ``i + 1`` is issued on a side stream before layer ``i`` runs, and
    the compute stream waits on its event (the JAX package's double buffer
    of ``device_put``). ``bytes_streamed`` counts the bytes copied in.

    Spread (``stages`` of ``((start, stop), device, layers)``): each layer
    runs on its stage's card from the slice held there, the residual stream
    moving between cards; the embedding runs where its weight is and the
    head where the final norm (``final_norm``, GPT's ``ln_f``) is; a tied
    head reads the embedding's table there.

    The decode cache is a list of per-layer K/V tensors, each on its layer's
    device."""

    def __init__(self, model, weights_map, execution_device, stages=None):
        self.model = model
        self.weights_map = weights_map
        self.execution_device = torch.device(execution_device)
        self.num_layers = _num_layers(model)
        self.stages = stages or [((0, self.num_layers), self.execution_device, None)]
        self._rope_seq_len = "rope_seq_len" in inspect.signature(model.embed).parameters
        self._stream = (torch.cuda.Stream(self.execution_device)
                        if self.execution_device.type == "cuda" and stages is None else None)
        self.bytes_streamed = 0
        if stages is not None:  # the spread model's resident non-layer weights
            nonlayer = {k: v for k, v in model.params.items() if k != "layers"}
            tied = getattr(model.config, "tie_word_embeddings", False)
            self._embed_device = _leaf_device(nonlayer.get("embed"), self.stages[0][1])
            final_norm = nonlayer.get("final_norm", nonlayer.get("ln_f"))  # Llama's, GPT's
            self._head_device = _leaf_device(final_norm, self.stages[-1][1])
            self._head_params = _to({k: v for k, v in nonlayer.items() if k != "embed" or tied},
                                    self._head_device)

    @property
    def config(self):
        return self.model.config

    @property
    def device(self) -> torch.device:
        """Where the model takes its inputs and ``generate`` decodes."""
        return self.execution_device

    @property
    def params(self):
        return self.model.params

    def _layer_device(self, i: int):
        for (a, b), dev, _ in self.stages:
            if a <= i < b:
                return dev
        raise IndexError(i)

    def _nonlayer(self):
        """(embed params, head params, embed device, head device)."""
        if self.stages[0][2] is None:
            nonlayer = _to({k: v for k, v in self.model.params.items() if k != "layers"},
                           self.execution_device)
            return nonlayer, nonlayer, self.execution_device, self.execution_device
        embed = {"embed": self.model.params["embed"]}
        return embed, self._head_params, self._embed_device, self._head_device

    # ------------------------------------------------------------- the weights
    def _layer_sources(self):
        """Per layer-leaf name: the stacked tensor a layer is sliced from
        (the weights map's host or disk copy, else the resident leaf)."""
        out = {}
        for name, leaf in named_parameters(self.model.params["layers"]).items():
            full = f"layers.{name}"
            if self.weights_map is not None and full in self.weights_map:
                out[name] = self.weights_map[full]
            elif leaf.device.type != "meta":
                out[name] = leaf
            else:
                raise KeyError(f"No weights available for {full}")
        return out

    def _fetch(self, sources, i: int):
        """Start layer ``i``'s copy to the execution device."""
        dev, out = self.execution_device, {}
        for src in sources.values():
            if src.device.type == "cpu":
                self.bytes_streamed += src[i].numel() * src.element_size()
        if self._stream is None:
            for name, src in sources.items():
                out[name] = src[i].to(dev)
            return out, None
        with torch.cuda.stream(self._stream):
            for name, src in sources.items():
                host = src[i]
                if host.device.type == "cpu" and not host.is_pinned():
                    host = host.pin_memory()  # a memory-mapped (disk) slice
                out[name] = host.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _ready(self, fetched):
        """The fetched layer's tree, once the compute stream has waited for
        its copy."""
        out, done = fetched
        if done is not None:
            current = torch.cuda.current_stream(self.execution_device)
            current.wait_event(done)
            for t in out.values():
                t.record_stream(current)
        return unflatten_names(out, self.model.params["layers"])

    def _run_layers(self, x, ctx, cache=None):
        model = self.model
        streamed = self.stages[0][2] is None
        sources = self._layer_sources() if streamed else None
        pending = self._fetch(sources, 0) if streamed else None
        ctx_on = {}
        for i in range(self.num_layers):
            dev = self._layer_device(i)
            if dev not in ctx_on:
                ctx_on[dev] = _to(ctx, dev)
            x = x.to(dev)
            if streamed:
                layer = self._ready(pending)
                if i + 1 < self.num_layers:
                    pending = self._fetch(sources, i + 1)
            else:
                (a, _), _, stage = next(s for s in self.stages if s[0][0] <= i < s[0][1])
                layer = tree_map(lambda t, j=i - a: t[j], stage)
            kw = {"window": model._layer_window(i)} if hasattr(model, "_layer_window") else {}
            if cache is None:
                x = model.block(layer, x, ctx_on[dev], **kw)
            else:
                x, _ = model.block(layer, x, ctx_on[dev],
                                   cache_layer={"k": cache["k"][i], "v": cache["v"][i]}, **kw)
        return x

    # ------------------------------------------------------------- the forward
    def init_cache(self, batch_size: int, max_len: int, dtype=torch.bfloat16):
        """The decode cache: per-layer K/V tensors, each allocated on its
        layer's device (a stacked cache would be copied whole per layer),
        the write offset and the key mask."""
        if not hasattr(self.model, "init_cache"):
            raise TypeError(f"{type(self.model).__name__} does not support KV caching")
        saved = self.model.device
        self.model.device = torch.device("meta")
        try:  # the stacked layout's shapes, without its memory
            spec = self.model.init_cache(batch_size, max_len, dtype=dtype)
        finally:
            self.model.device = saved
        embed_device = self._nonlayer()[2]
        return {
            "k": [torch.zeros(spec["k"].shape[1:], dtype=dtype, device=self._layer_device(i))
                  for i in range(self.num_layers)],
            "v": [torch.zeros(spec["v"].shape[1:], dtype=dtype, device=self._layer_device(i))
                  for i in range(self.num_layers)],
            "pos": 0,
            "kv_mask": torch.zeros((batch_size, max_len), dtype=torch.int32,
                                   device=embed_device),
        }

    @torch.no_grad()
    def __call__(self, input_ids=None, labels=None, attention_mask=None, positions=None,
                 cache=None, **kw):
        embed_params, head_params, embed_dev, head_dev = self._nonlayer()
        move = lambda t, d: None if t is None else torch.as_tensor(t).to(d)  # noqa: E731
        input_ids, positions = move(input_ids, embed_dev), move(positions, embed_dev)
        mask = move(attention_mask, embed_dev)
        if cache is not None:
            return self._call_cached(embed_params, head_params, head_dev, input_ids, labels,
                                     mask, cache, positions)
        x, ctx = self.model.embed(embed_params, input_ids, positions, mask)
        x = self._run_layers(x, ctx)
        return self.model.head(head_params, x.to(head_dev), labels=move(labels, head_dev),
                               attention_mask=move(mask, head_dev))

    def _call_cached(self, embed_params, head_params, head_dev, input_ids, labels,
                     attention_mask, cache, positions=None):
        """A prefill or decode chunk through the per-layer cache, written in
        place at ``cache["pos"]``; slot indices drive the causal mask,
        ``positions`` (from the mask, for ragged rows) the rotary tables."""
        B, S = input_ids.shape
        dev = input_ids.device
        pos = int(cache["pos"])
        q_positions = (pos + torch.arange(S, dtype=torch.int32, device=dev))[None].expand(B, S)
        embed_positions = q_positions if positions is None else positions
        chunk_mask = (attention_mask.to(torch.int32) if attention_mask is not None
                      else torch.ones((B, S), dtype=torch.int32, device=dev))
        kv_mask = cache["kv_mask"]
        kv_mask[:, pos:pos + S] = chunk_mask
        kw = {"rope_seq_len": cache["k"][0].shape[1]} if self._rope_seq_len else {}
        x, ctx = self.model.embed(embed_params, input_ids, embed_positions, attention_mask, **kw)
        ctx = dict(ctx, positions=q_positions, kv_mask=kv_mask, cache_pos=pos)
        x = self._run_layers(x, ctx, cache)
        out = self.model.head(head_params, x.to(head_dev),
                              labels=None if labels is None else labels.to(head_dev),
                              attention_mask=None if attention_mask is None
                              else attention_mask.to(head_dev))
        out["cache"] = {"k": cache["k"], "v": cache["v"], "pos": pos + S, "kv_mask": kv_mask}
        return out

    def apply(self, params, *args, **kwargs):
        """The ``Module.apply`` contract: with another tree than the model's,
        the streamed layers come from that tree (slice by slice)."""
        if params is not None and params is not self.model.params:
            if self.stages[0][2] is not None:
                raise ValueError("a model spread over cards holds its layers on them; "
                                 "dispatch again to run other weights")
            saved = self.model.params
            self.model.params = params
            try:
                return self(*args, **kwargs)
            finally:
                self.model.params = saved
        return self(*args, **kwargs)

    def eval(self):
        return self

    def train(self, mode: bool = True):
        if mode:
            raise RuntimeError("StreamedScanModel is inference-only (offloaded dispatch).")
        return self


def _leaf_device(tree, default):
    leaves = list(named_parameters(tree).values()) if tree is not None else []
    return leaves[0].device if leaves and leaves[0].device.type != "meta" else default


# --------------------------------------------------------- load-and-dispatch
def load_checkpoint_and_dispatch(model, checkpoint: str,
                                 device_map: Mapping[str, str] | str | None = None,
                                 max_memory: Mapping | None = None, no_split_module_classes=None,
                                 offload_folder: str | None = None, offload_buffers: bool = False,
                                 dtype=None, offload_state_dict: bool | None = None,
                                 skip_keys=None, preload_module_classes=None,
                                 force_hooks: bool = False, strict: bool = False,
                                 main_device=None):
    """Plan, load and dispatch. ``device_map`` is a map, or ``"auto"``,
    ``"balanced"``, ``"balanced_low_0"`` (balanced budgets, then the
    planner) or ``"sequential"`` (the planner on the raw budgets); None
    loads everything onto ``main_device``. Each leaf is read from the
    checkpoint's memory maps and placed on its target; ``main_device`` is the
    execution device (``cuda`` unless given)."""
    params = getattr(model, "params", None)
    if params is None:
        raise ValueError("Call model.init_params() (ideally under init_empty_weights()) first.")
    if isinstance(device_map, str):
        if device_map not in ("auto", "balanced", "balanced_low_0", "sequential"):
            raise ValueError("If passing a string for `device_map`, please choose 'auto', "
                             "'balanced', 'balanced_low_0' or 'sequential'.")
        if device_map != "sequential":
            max_memory = get_balanced_memory(params, max_memory=max_memory, dtype=dtype,
                                             low_zero=(device_map == "balanced_low_0"))
        device_map = infer_auto_device_map(params, max_memory=max_memory, dtype=dtype)
    loaded = load_checkpoint_in_model(params, checkpoint, device_map=device_map,
                                      offload_folder=offload_folder, dtype=dtype, strict=strict)
    if device_map is None:
        model.params = _to(loaded, resolve_device(main_device))
        return model
    model.params = loaded
    offload_index = None
    index_file = None if offload_folder is None else os.path.join(offload_folder, "index.json")
    if index_file is not None and os.path.isfile(index_file):
        with open(index_file) as fh:
            offload_index = json.load(fh)
    return dispatch_model(model, device_map=device_map, main_device=main_device,
                          offload_dir=offload_folder, offload_index=offload_index,
                          offload_buffers=offload_buffers, skip_keys=skip_keys,
                          force_hooks=force_hooks)
