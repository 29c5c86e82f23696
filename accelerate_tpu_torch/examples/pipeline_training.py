"""Pipeline-parallel training (GPipe or 1F1B) — the port's
``examples/by_feature/pipeline_training.py``.

The ``pp`` mesh axis runs a real pipeline (``parallel/pipeline.py``): each
stage keeps its block of layers stationary and the microbatches' activations
move stage to stage, forward, and their gradients back. Raise
``--microbatches`` to amortize the ``(P-1)/(M+P-1)`` bubble; ``--schedule
1f1b`` interleaves forwards and backwards, so a stage keeps at most ``2P``
stage inputs whatever the microbatches.

Run::

    # every stage in this process (LoopbackShards), on the card or the CPU
    python -m accelerate_tpu_torch.examples.pipeline_training --pp 2 --microbatches 4
    python -m accelerate_tpu_torch.examples.pipeline_training --cpu --schedule 1f1b
    # one process a stage (and data rank), NCCL between the cards
    accelerate-tpu-torch launch --num_processes 4 -m accelerate_tpu_torch.examples.pipeline_training --pp 2
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from accelerate_tpu_torch import (
    Accelerator,
    Llama,
    LlamaConfig,
    LoopbackShards,
    ParallelismConfig,
    PipelineParallelPlugin,
    adamw,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--num_steps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--schedule", choices=["gpipe", "1f1b"], default="gpipe")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    accelerator = Accelerator(
        device=device,
        parallelism_config=ParallelismConfig(pp_size=args.pp),
        pp_plugin=PipelineParallelPlugin(pp_size=args.pp, num_microbatches=args.microbatches,
                                         schedule=args.schedule),
        loopback=LoopbackShards(args.pp) if world == 1 else None)
    cfg = LlamaConfig.tiny(num_hidden_layers=args.layers)
    model = Llama(cfg, device=device)
    model.init_params(0)
    pmodel, popt = accelerator.prepare(model, adamw(1e-2, device=device))
    spec = pmodel.handle.pipeline_spec
    assert spec is not None, "pipeline schedule did not engage"
    accelerator.print(f"{spec.schedule} engaged: {args.pp} stages x {spec.num_microbatches} "
                      f"microbatches (bubble "
                      f"{(args.pp - 1) / (args.pp - 1 + spec.num_microbatches):.0%})")

    batch = accelerator.num_data_ranks * args.microbatches  # data shards x microbatches
    rng = np.random.default_rng(0)
    step = accelerator.build_train_step(pmodel, popt)
    losses = []
    for i in range(args.num_steps):
        ids = rng.integers(0, cfg.vocab_size, (batch, 32)).astype(np.int32)
        losses.append(float(step({"input_ids": ids, "labels": ids})))
        accelerator.print(f"step {i}: loss {losses[-1]:.4f}")
    accelerator.print("pipeline training done")
    return losses


if __name__ == "__main__":
    main()
