"""Pipeline-parallel inference, ``prepare_pippy`` — the counterpart of
``accelerate_tpu/inference.py``.

The model's stacked layers are cut into contiguous stages
(:func:`generate_device_map`), stage ``s`` on card ``cuda:s``, the
embedding with the first stage and the head with the last. A batch splits
into ``num_chunks`` microbatches; each runs the stages in order, its
activations moving to the next card with ``.to()`` (a device-to-device copy
on the stream, no host sync), so while one card computes microbatch ``m``
the card before it already runs microbatch ``m + 1``: the GPipe overlap of
the JAX package's asynchronous dispatch, with no scheduler thread. A model
on ``device="cpu"`` holds every stage on the CPU.

Models must expose the ``embed(params, ...)`` / ``block(layer, x, ctx)`` /
``head(params, x, ...)`` stage protocol with stacked layers
(``models/llama.py``).
"""

from __future__ import annotations

import torch

from .utils.tree import tree_map


def generate_device_map(num_layers: int, num_stages: int) -> list[tuple[int, int]]:
    """Even contiguous ``[start, stop)`` layer ranges per stage, the extra
    layers to the earliest stages (JAX ``inference.py:37-52``)."""
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    if num_stages > num_layers:
        raise ValueError(f"Cannot split {num_layers} layers into {num_stages} stages")
    base, extra = divmod(num_layers, num_stages)
    ranges, start = [], 0
    for s in range(num_stages):
        stop = start + base + (1 if s < extra else 0)
        ranges.append((start, stop))
        start = stop
    return ranges


def _local_devices(model) -> list:
    """The cards of this process for a CUDA model (one stage a card), or
    the CPU for a CPU model (any number of stages)."""
    dev = torch.device(model.device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


class PipelinedModel:
    """Stage-placed, microbatched forward (what ``prepare_pippy`` returns;
    JAX ``inference.py:55-165``)."""

    def __init__(self, model, num_stages: int, devices, num_chunks: int, gather_output: bool,
                 stage_ranges: list[tuple[int, int]] | None = None):
        self.model = model
        self.num_chunks = num_chunks
        self.gather_output = gather_output
        devices = list(devices)
        if devices and devices[0].type == "cpu":
            devices = devices[:1] * num_stages
        self.devices = devices[:num_stages]
        if num_stages > len(self.devices):
            raise ValueError(f"{num_stages} stages > {len(self.devices)} local devices")
        cfg = model.config
        num_layers = getattr(cfg, "num_hidden_layers", None) or getattr(cfg, "num_layers", None)
        self.stage_ranges = stage_ranges or generate_device_map(num_layers, num_stages)
        params = model.params
        if params is None:
            raise ValueError("Model has no params; call init_params / load weights first")
        # Stage s owns layers[start:stop] on devices[s]; the embedding lives
        # with stage 0, the head with the last stage.
        self.stage_layers = [
            tree_map(lambda leaf, a=a, b=b, s=s: leaf[a:b].to(self.devices[s]), params["layers"])
            for s, (a, b) in enumerate(self.stage_ranges)]
        nonlayer = {k: v for k, v in params.items() if k != "layers"}
        self.first_params = tree_map(lambda t: t.to(self.devices[0]), nonlayer)
        self.last_params = self.first_params if self.devices[-1] == self.devices[0] else \
            tree_map(lambda t: t.to(self.devices[-1]), nonlayer)

    @property
    def config(self):
        return self.model.config

    def _forward_chunk(self, input_ids, positions, attention_mask, labels):
        model = self.model
        dev0 = self.devices[0]
        move = lambda t, d: None if t is None else t.to(d, non_blocking=True)  # noqa: E731
        x, ctx = model.embed(self.first_params, move(input_ids, dev0), move(positions, dev0),
                             move(attention_mask, dev0))
        for s, layers in enumerate(self.stage_layers):
            dev = self.devices[s]
            x = x.to(dev, non_blocking=True)  # the hop to the stage's card
            ctx_s = {k: move(v, dev) if isinstance(v, torch.Tensor) else v
                     for k, v in ctx.items()}
            start, stop = self.stage_ranges[s]
            for i in range(stop - start):
                layer = tree_map(lambda t, i=i: t[i], layers)
                x = model.block(layer, x, ctx_s, window=model._layer_window(start + i))
        last = self.devices[-1]
        return model.head(self.last_params, x, labels=move(labels, last),
                          attention_mask=move(attention_mask, last))

    @torch.no_grad()
    def __call__(self, input_ids=None, labels=None, attention_mask=None, positions=None, **kw):
        n = input_ids.shape[0]
        chunks = min(self.num_chunks, n)
        if n % chunks != 0:
            raise ValueError(f"Batch size {n} must be divisible by num_chunks {chunks} "
                             "(reference pipelining has the same constraint)")

        def split(t):
            return [None] * chunks if t is None else list(torch.as_tensor(t).chunk(chunks))

        outs = [self._forward_chunk(ids, pos, am, lab) for ids, pos, am, lab in zip(
            split(input_ids), split(positions), split(attention_mask), split(labels))]
        out = _concat_outputs(outs)
        if self.gather_output:
            out = type(out)({k: v.to(self.devices[0]) if isinstance(v, torch.Tensor) else v
                             for k, v in out.items()}) if isinstance(out, dict) else \
                out.to(self.devices[0])
        return out

    def apply(self, params, *args, **kwargs):
        if params is not None and params is not self.model.params:
            raise ValueError("PipelinedModel weights are staged at prepare_pippy() time; "
                             "re-prepare to run with different params.")
        return self(*args, **kwargs)

    def eval(self):
        return self

    def train(self, mode: bool = True):
        if mode:
            raise RuntimeError("prepare_pippy is inference-only (reference inference.py:124)")
        return self


def _concat_outputs(outs):
    first = outs[0]
    if isinstance(first, dict):
        merged = type(first)()
        for key in first:
            vals = [o[key] for o in outs]
            if vals[0] is None:
                merged[key] = None
            elif vals[0].dim() == 0:
                merged[key] = torch.stack(vals).mean()  # per-chunk scalar losses
            else:
                merged[key] = torch.cat(vals)
        return merged
    if first.dim() == 0:
        return torch.stack(outs).mean()
    return torch.cat(outs)


def prepare_pippy(model, split_points="auto", no_split_module_classes=None, example_args=(),
                  example_kwargs=None, num_chunks: int | None = None,
                  gather_output: bool = False):
    """``model`` split into pipeline stages over this process's cards and
    wrapped for microbatched inference (JAX ``inference.py:168-229``).
    ``split_points="auto"`` makes one stage a card (one stage on the CPU),
    an int that many stages, a list of layer indices the boundaries.
    ``num_chunks`` defaults to the number of stages."""
    devices = _local_devices(model)
    cfg = getattr(model, "config", None)
    num_layers = getattr(cfg, "num_hidden_layers", None) or getattr(cfg, "num_layers", None)
    if num_layers is None or not hasattr(model, "block"):
        raise ValueError("prepare_pippy requires a stage-protocol model (embed/block/head with "
                         "stacked layers); got " + type(model).__name__)
    if split_points == "auto":
        num_stages = min(len(devices), num_layers)
    elif isinstance(split_points, int):
        num_stages = split_points
    elif isinstance(split_points, (list, tuple)):
        bounds = sorted(split_points)
        if any(b <= 0 or b >= num_layers for b in bounds):
            raise ValueError(f"split points {split_points} out of range (0, {num_layers})")
        num_stages = len(bounds) + 1
        edges = [0] + bounds + [num_layers]
        return PipelinedModel(model, num_stages, devices, num_chunks or num_stages,
                              gather_output,
                              stage_ranges=[(edges[i], edges[i + 1]) for i in range(num_stages)])
    else:
        raise ValueError(f"Unsupported split_points: {split_points!r}")
    return PipelinedModel(model, num_stages, devices, num_chunks or num_stages, gather_output)
