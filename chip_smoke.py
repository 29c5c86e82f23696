#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # what the checks need; a few minutes
    python3 chip_smoke.py --profile  # adds torch.profiler passes over a
                                     # serving wave with bf16 weights and
                                     # one with int8 weights, one Llama and
                                     # one Gemma-2 training step, one step
                                     # of the canonical BERT loop
    python3 chip_smoke.py --paged-decode  # only phase 2b, the paged decode
                                     # kernel's cells (the same use)
    python3 chip_smoke.py --loop     # only phase 11, the canonical BERT loop
                                     # (with --profile: one profiled step)
    python3 chip_smoke.py --checkpoint  # only phase 12, checkpoints and
                                     # mid-epoch resume of that loop
    python3 chip_smoke.py --fsdp     # only phase 13, sharded training
                                     # (fsdp, ZeRO, remat) on one card
    python3 chip_smoke.py --precision  # only phase 14: fp16, fp8 (int8
                                     # QAT), the train window and its
                                     # prefetcher, host offload
    python3 chip_smoke.py --tp       # only phase 15: tensor parallelism
                                     # (tp, with fsdp, dp and ZeRO), Ulysses
                                     # and fp16 on shards, on one card
    python3 chip_smoke.py --pp       # only phase 16: pipeline parallelism
                                     # (GPipe, 1F1B, with tp and fsdp),
                                     # adafactor and prepare_pippy
    python3 chip_smoke.py --big-model  # only phase 17: big-model loading and
                                     # offloaded inference at 8B widths
    python3 chip_smoke.py --cv       # only phase 18: the CV examples
    python3 chip_smoke.py --launch   # only phase 19: the launcher and the CLI
    python3 chip_smoke.py --moe      # only phase 20: mixture of experts at
                                     # Mixtral-8x7B widths, the ep axis
    python3 chip_smoke.py --gptx     # only phase 21: a Hugging Face GPT-NeoX
                                     # checkpoint served and streamed, OPT and
                                     # GPT-2 trained, sharded, sized
    python3 chip_smoke.py --splash-times  # only the splash kernels' times at
                                     # Gemma-2-9B's layers (to set two trees
                                     # side by side in one run: copy this
                                     # script beside the other tree's package)

Phases, in order; any failure exits non-zero and nothing is caught:

1. Build every CUDA source of ``accelerate_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, all started together), log each flash,
   splash, int8 matmul and paged decode kernel's registers and spills (``-Xptxas -v``; any
   spill fails the phase) and the highest register each uses (``cuobjdump
   -sass``: the consumers' share under ``setmaxnreg``), and print the card's
   name and power limit.
2. Op phase at the engine's shapes: the paged gather kernel, bf16 and
   int8-dequant-to-bf16, against its plain PyTorch version (bitwise on
   active slots, zeros on inactive ones), with times for the kernel, the
   plain version and one library call, beside the bytes-moved bound.
2a. Op phase of the int8 matmul at the 7 Llama-3-8B projection shapes
   ((K, N) of 4096x4096, 4096x1024, 4096x14336, 14336x4096) for M = 8
   (a decode step over 8 slots) and M = 128 (a prefill chunk), bf16:
   bitwise against its plain version; times for the kernel (CUDA events,
   and device time from the profiler's raw records), the plain version,
   ``torch._int_mm`` on pre-quantized operands (the contraction only) and
   the bf16 ``x @ w`` (cuBLAS, which reads the same weight bytes), beside
   the bound, with each cell's partition.
2b. Op phase of the fused paged decode attention at the engine's geometry
   (8 slots, block 16, 32 heads over 8 KV heads of 128, M = 26 blocks a
   slot), on 4096-token chains (M = 256) and for one slot with a 4096-token
   chain: bf16 and int8 pools, ragged chains with trash-block tails, holes
   in the mask, two inactive slots (of 8). The op face ``paged_attention``
   is driven for one decode step over all 32 layers (the launches counted),
   then the kernel is held to its plain version per (slot, head) row, with
   the kernel's plan (splits, CTAs, stages, shared memory), its time by CUDA
   events and its device time (the profiler's records of both of a call's
   kernels), TB/s and share of the bound, and times for the plain version,
   the gather kernel plus ``cached_attention`` (what the engine runs), and
   ``scaled_dot_product_attention`` on the gathered view.
3. Engine phase: ``ContinuousBatcher(paged=True)`` on Llama-3-8B widths
   (all 32 layers, bf16, random weights from a seed) answers a wave of
   greedy requests behind a shared prefix, with chunked prefill engaged.
   Every request finishes, the pool's blocks all return, the kernel was
   launched, and the tokens equal those of an engine built with
   ``kernels="off"`` (the plain gather).
4. The same with an int8 KV pool (the dequant variant of the kernel).
4a. Int8-weight serving: ``ContinuousBatcher(matmul_precision="int8",
   kv_quant="int8")`` on the same model and wave: every block projection
   through the int8 matmul kernel (224 launches a forward), tokens equal
   to a ``kernels="off"`` arm's; tokens/s and TTFT beside phase 3's.
5. Small-input reference check: on ``LlamaConfig.tiny()`` in fp32 the engine's
   output equals per-request ``generate()``, and the 8B forward's logits are
   finite with the expected shape. The 16 GB serving model is then freed.
6. Training-kernel op phase: causal flash attention (forward, and backward
   through autograd) against its plain version at the training shape
   (B2, S2048, H32, D128, bf16), with a right-padding mask, at S=1024
   (the crossover), at a ragged S=1088 (an odd multiple of 64, so the last
   128-row tile is half past the end) with padding, and at D=64, held to
   pinned tolerances; the fused optimizer update,
   every family, bitwise against its plain version on the largest leaf of
   the training cell (the embedding or LM head, 128256 x 4096 = 525M f32)
   and on 1- and 0-element leaves. Times for kernel, plain version and the library call
   (``scaled_dot_product_attention``; ``torch.optim.AdamW``/``SGD`` with
   ``fused=True``, another op order) beside the bound.
7. Training phase: ``Accelerator(mixed_precision="bf16").prepare(model,
   adamw(3e-4))`` → ``build_train_step`` on Llama-3-8B widths cut to 4
   layers, batch 2 x 2048 seeded tokens, ``clip_norm=1.0``: 2 warm-up and 5
   timed steps with finite, falling losses and the flash and update kernels
   launched every step; a ``kernels="off"`` arm whose first 3 losses agree
   with the kernel arm's; and an accumulation-2 build whose update launches
   only at the 2 boundaries of 4 micro-steps. Prints step time, tokens/s,
   MFU against 989 TFLOP/s and each arm's peak memory.
8. Splash-kernel op phase: causal splash attention (window, logit softcap,
   pre-scaled q, segment ids; forward, and backward through autograd)
   against its plain version at Gemma-2-9B's local layer (B1, S8192, H16,
   D256, window 4096, softcap 50, scale 1/16), its global layer, the local
   layer with right padding, Mistral-7B-v0.1's attention (32 heads over 8 KV
   heads of 128, window 4096), S=1024 (the crossover), a ragged S=1088
   (an odd multiple of 64: the last 128-row query tile is half past the
   end) padded with a window of 300, and the padded local
   layer on logits of standard deviation 16, which reach the cap, under
   flash's pins; on that last case the kernel without the softcap and the
   plain version without the cap's derivative must both miss the pins. Times for kernel, plain version and the library call
   (``flex_attention`` with a sliding-window block mask and a softcap
   ``score_mod``) beside the bound.
9. Gemma-2 training: ``gemma2_config_from_hf`` of the published
   google/gemma-2-9b config cut to 4 layers (two local, two global; 1.710B
   parameters), ``fused_loss=True``, ``Accelerator(mixed_precision="bf16")``,
   ``adamw(3e-4)``, batch 1 x 8192, ``clip_norm=1.0``: 2 warm-up and 5 timed
   steps with finite, falling losses, splash launched 4 + 4 times a step
   and flash never; then one local and one global layer trained by a
   kernel arm and a ``kernels="off"`` arm whose first 3 losses agree.
10. Ring attention (sequence parallelism) at Llama-3-8B's attention widths
   (32 query heads over 8 KV heads of 128, the KV heads repeated to 32
   before the ring as the model does), B1, a 32768-token sequence over
   sp = 4 ranks (8192 tokens a shard), bf16, all four ranks driven in this
   process by ``parallel.ring.LoopbackRing(4)``, through the same block
   calls a ring of four cards makes. Each ring-block kernel (forward and
   backward) against its plain twin at a shard of 8192 in modes 0
   (diagonal), 1 (full), 1 with right padding in the KV block and 2
   (skipped: no launch); the whole ring, forward and backward (10 + 10
   launches), against single-card ``flash_attention_cuda`` of the
   unsharded sequence (which phase 6 holds to its plain version); and the
   whole ring at S=4096 against ``kernels="off"`` with padding in a KV
   shard other than the query's own and a left-padded row (rows that see
   no key come out 0). Times for each block kernel, its twin and
   ``scaled_dot_product_attention`` on the same block, and for the whole
   ring against single-card flash, beside the bounds.
11. The canonical Accelerate loop of ``examples/nlp_example.py`` (the port's
   ``accelerate_tpu_torch/examples/nlp_example.py``) at bert-base-cased's
   published widths (``bert_config_from_hf`` of its config: 12 layers of
   768, vocabulary 28996; random weights from the seed, dropout off):
   ``Accelerator(mixed_precision="bf16")``, the example's key-match data at
   MRPC's split sizes (3668 train, 408 eval), sequences of 128, batch 16.
   Arm A, the example as written: ``inject_hyperparams(adamw)(2e-5)`` and
   ``linear_schedule(2e-5, 2e-6, 229)``, ``clip_grad_norm_(model, 1.0)``,
   one epoch and the eval: finite losses, the reference chain (no fused
   update launched), the learning rate after the last step equal to the
   schedule's, ``gather_for_metrics`` returning exactly 408 rows (the tail
   of 25 x 16 + 8 padded and trimmed); accuracy printed. Arm B, a constant
   ``adamw(2e-5)``: 40 steps with the fused update launched from
   ``optimizer.step()`` 25 times a step (one per BERT parameter leaf), the
   first 3 losses against a ``kernels="off"`` arm within phase 7's pin,
   and an accumulation-2 build launching the update only at the
   boundaries. Steps/s and tokens/s (host clock over 30 steps after 5
   warm-up, ending in ``synchronize()``) and peak memory of both arms;
   ``--profile`` adds one profiled step of arm B.

12. Checkpoint phase: the complete example's loop (phase 11's, with
   dropout at bert-base-cased's published 0.1) through ``save_state``,
   ``load_state`` and ``save_model``, everything written under a temporary
   folder removed at the end. Arm A: a constant ``adamw``, 40 steps. Arm B:
   20 steps, a blocking ``save_state``, every object dropped and built again
   (the model from another seed), ``prepare``, ``load_state``, 20 more
   steps: the loaded parameters, moments and counts bitwise equal to a host
   copy taken at the save, steps 21-40 bitwise A's (losses, batches, final
   state), the fused update launched 25 times in every step after the load.
   Arm C: ``save_state(blocking=False)`` at step 20, 2 more steps at once,
   ``finish_pending_saves()``: fresh objects load step 20's state bitwise,
   not step 22's. Arm D, the example as written (``inject_hyperparams(adamw)``
   and ``linear_schedule``) under ``ProjectConfiguration(
   automatic_checkpoint_naming=True, total_limit=2)``, a save every 10 steps
   over 30: two ``checkpoint_<i>`` folders left; the newest one's
   ``optimizer/`` deleted (a crash mid-save); ``load_state()`` falls back to
   the one before, the iteration and the learning rate line up, and steps
   21-30 repeat the first run's bitwise. Arm E: ``save_model`` of arm A's
   model in 200 MB shards, read back bitwise, each tensor once in the
   index. One log line gives the save, load, non-blocking return and join,
   and export seconds and GB/s, the checkpoint's bytes, and arms A and B's
   steps/s beside the card's name and power limit.

13. Sharded training on one card: Llama-3-8B widths cut to 4 layers (phase
   7's ``TRAIN_CUT``), global batch 4 x 2048 (one row a rank), bf16,
   ``adamw(3e-4)``, clip 1.0, 4 steps a arm. Arm A: the unsharded
   ``build_train_step``. Arm B: ``FullyShardedDataParallelPlugin(fsdp_size=4,
   activation_checkpointing=True)`` (remat ``nothing_saveable``) with all
   four ranks on this card (``LoopbackShards(4)``): each layer gathered in
   bf16 from the four shards inside the remat region, its gradient banked
   in f32 and scattered into the shards, the fused update once per
   distinct slice (the replicated norms once, not once a rank). Arm C: dp 4
   with ``zero_sharding=True`` on the loopback: the update on each rank's 1/4 slice of every leaf, the new
   slices gathered back. Arm D: arm A with remat, bitwise arm A (losses and
   final parameters). Arms B and C hold their first 3 losses to arm A's
   within ``SHARD_LOSS_ATOL``; each arm's flash and update launches are
   counted, every update launch is on a shard (B, C) or a whole leaf (A, D),
   each rank's parameter, moment and buffer bytes are printed with the
   sharded leaves' bytes summing over the ranks to the unsharded total, and
   each arm's step time, tokens/s, MFU against 989 TFLOP/s (JAX's
   ``flops_per_token``, not counting the recompute) and peak memory are
   logged. The kernels' table adds these launches to rows 4, 5 and 5b.

14. The rest of single-card training, on phase 7's model (Llama-3-8B widths
   cut to 4 layers, 2 x 2048 seeded ids, ``adamw(3e-4)``, clip 1.0). E: the
   flash kernel in fp16 at B2 S2048 H32 D128, forward and backward, against
   its plain version under flash's pins, timed beside
   ``scaled_dot_product_attention`` in fp16 (rows 5c and 5d). The int8
   matmul at M = 4096 (a training step's rows) on the four projection
   shapes, bitwise its plain version with ``plan()``'s partition logged,
   and the 4096 -> 14336 product timed as the kernel, the bf16 ``x @ w`` and
   ``torch._int_mm`` on operands already quantized (row 3c). A:
   ``mixed_precision="fp16"``, 8 ``build_train_step`` steps and the same
   with ``kernels="off"``, both with a ``loss_fn`` that poisons step 3 (its
   loss times +inf): the same scales and skipped steps (step 3 among
   them, the scale halving there), losses on the
   applied steps within ``TRAIN_LOSS_ATOL``, the fp16 flash kernels
   launched 4 + 4 a step and the update 12 times on each applied step and
   never on a skipped one; the scale trajectory, step time, tokens/s, MFU
   and peak memory. B: ``mixed_precision="fp8"`` (int8 QAT), 5 steps with
   the int8 matmul launched 28 times a step, the first 3 losses within the
   pin of a ``kernels="off"`` arm. C: bf16 ``build_train_window(window=4)``
   fed by ``DeviceBatchPrefetcher(window=4)``, 2 windows: losses and final
   parameters bitwise 8 ``build_train_step`` calls, 2 uploads and no
   blocking input wait. D: the imperative loop under
   ``FullyShardedDataParallelPlugin(fsdp_size=1, cpu_offload=True)``, 4
   steps: losses and final parameters bitwise the loop without offload,
   the optimizer state in pinned host memory between steps and the device
   holding at least its bytes less; step time and peak memory of both. The
   kernels' table gains rows 3c, 5c and 5d (launches in arms B and A), and
   this phase's bf16 flash and update launches are added to rows 4, 5, 5b.

15. Tensor parallelism and Ulysses on one card, on phase 13's model and
   batch (Llama-3-8B widths cut to 4 layers, 4 x 2048 seeded ids, bf16,
   ``adamw(3e-4)``, clip 1.0, 4 steps an arm, all ranks on this card
   through ``LoopbackShards(4)``). First the flash kernel at a tp rank's
   shape (B2 S2048, 8 query heads, 2 KV heads repeated, D128) against its
   plain version under flash's pins. A: unsharded. B: tp 4
   (``TensorParallelPlugin``): each rank's 8 query heads and quarter of
   the MLP and the vocab, the all-reduces after wo and w_down summed over
   the ranks in lockstep (``parallel/tensor.LoopbackTP``). C: tp 2 x fsdp
   2 with remat. D: dp 2 x tp 2 with ZeRO. B, C and D hold their first 3
   losses within ``SHARD_LOSS_ATOL`` of A's. E: Ulysses sp 4
   (``SequenceParallelPlugin(ring_attention=False)``) on 1 x 8192 tokens,
   2048 a rank, against the unsharded step on that batch (E0), the same
   pin; the all-to-all bytes a rank moves a layer are computed from the
   shapes. F: fp16 on C's mesh with step 3 poisoned through ``loss_fn``,
   against the unsharded fp16 step (F0): the same scales and skips, applied
   losses within ``TRAIN_LOSS_ATOL``. Every arm's flash and update
   launches are checked per step (flash forward ranks x layers, twice under
   remat; the update once per distinct update slice of a leaf on applied
   steps (ranks that hold the same slice share it), never on a
   skipped one), and so is the bytes' sum: each distinct shard over the
   ranks (a base shard, a ZeRO slice of the moments) adds up to the
   unsharded model's parameters, moments and buffer; each rank's bytes,
   step time, tokens/s, MFU and peak memory are logged. The kernels'
   table adds these launches to rows 4, 5, 5b, 5c and 5d.
16. Pipeline parallelism, adafactor and ``prepare_pippy`` on one card, on
   phase 13's model and batch (Llama-3-8B widths cut to 4 layers, 4 x 2048
   seeded ids, bf16, clip 1.0, 3 steps an arm, the stages on this card
   through ``LoopbackShards``: the tick loop of the process-group path
   with the loopback transport handing each stage's output to the next).
   A: unsharded, ``adamw(3e-4)``. B: pp 4 GPipe, 4 microbatches (one layer
   a stage). C: pp 4 1F1B. D: pp 2 x tp 2 1F1B. E: pp 2 x fsdp 2 GPipe with
   remat (2 microbatches a data coordinate). F0: ``adafactor(1e-2)``
   unsharded; F: F0 under pp 2 1F1B. B-E hold their first 3 losses within
   ``SHARD_LOSS_ATOL`` of A's, F of F0's. Per step the flash forward and
   backward and the fused update launches equal counts from the schedule
   (a layer's forward once a microbatch and tp rank, twice under 1F1B,
   whose backward unit runs the block again, and under remat; the update
   once per distinct update slice of the plan, none under adafactor, which
   runs the reference chain); the stage-to-stage messages and bytes equal
   2 (P - 1) M a data coordinate of one microbatch's bf16 residual stream;
   each arm's step time, tokens/s, MFU, peak memory and its stages' most
   saved inputs are logged. G: ``prepare_pippy`` of the full 32-layer model
   in bf16 (one stage on one card, 4 chunks of a 4 x 2048 batch): its
   logits against the unpipelined forward's (``PIPPY_LOGITS_ATOL``), its
   flash launches 32 x 4. The kernels' table adds B-F's launches to rows
   4, 5 and 5b.
17. Big-model loading and offloaded inference at Llama-3-8B widths (32
   layers, bf16, seeded), in a temporary folder removed at the end; the
   depth (never the width) is cut when free disk or host memory is short of
   the checkpoint plus one offloaded copy of the layers. A:
   ``init_empty_weights`` → every leaf on ``meta``, no card memory taken,
   16.06 GB planned. B: the seeded weights written as sharded safetensors
   with an index. C: ``load_checkpoint_and_dispatch(device_map="auto")``
   resident on the card, no meta leaf left; 16 greedy tokens of a 4 x 64
   batch (the reference tokens, timed after a 2-token warm-up, as in D) and
   a 1 x 2048 scoring forward with labels, 32 flash launches. D: the layers pinned on the host, a
   ``StreamedScanModel``: the same 16 tokens, the layers' bytes streamed a
   token, the scoring forward's 32 flash launches and its logits within
   1e-2 (relative Frobenius) of C's. E: the layers in an offload folder: 4
   tokens equal to C's first 4. F: ``"auto"`` under 6 GiB on the card: the
   planner's map and the runtime that ran it, logits within 1e-2 of C's.
   G: ``load_and_quantize_model`` in int8 and int4: bytes at rest, the
   peak in a forward, the logits' correlation with C's above 0.99 (int8) and
   0.5 (int4), 16 greedy tokens logged. Each arm's seconds are logged. The
   kernels' table adds C and D's flash launches to row 5.
18. The CV examples: ``examples/cv_example.py`` in bf16 at its own
   settings (3 epochs, batch 32, 1024 train and 256 eval images): the
   final accuracy above 0.9, steps/s, step 1's loss against the same
   example in f32 on the CPU (within 2e-2), no kernel launched
   (``inject_hyperparams(adam)`` runs the reference chain);
   ``complete_cv_example.py --checkpointing_steps 16`` uninterrupted and
   resumed from ``step_48`` (mid-epoch): the last checkpoint's model and
   optimizer bitwise equal, cuDNN held deterministic.
19. The launcher and the CLI, through ``python -m
   accelerate_tpu_torch.commands.accelerate_cli`` (the
   ``accelerate-tpu-torch`` entry point). A: ``launch --num_processes 1
   --mixed_precision bf16 chip_smoke.py --launched-worker`` runs phase 11's
   arm B loop (bert-base-cased widths, a constant ``adamw``) for 10 steps in
   a child whose ``Accelerator()`` takes no precision: it must report bf16
   from the contract, ``cuda:0`` with ``RANK=0``, ``WORLD_SIZE=1``,
   ``LOCAL_RANK=0``, 25 fused-update launches a step, and losses bitwise
   the same 10 steps run in this process. B: ``accelerate-tpu-torch test``
   passes ("All distributed asserts passed.") and its script reports the
   sgd update's launches (row 4b) above 0. C: a 2-rank ``--cpu`` gang whose
   rank 1 exits 3 returns 3 within 30 s, its other rank stopped; on the
   card, with ``--max_restarts 1``, a script that exits 3 only on attempt 0
   (it reads ``ACCELERATE_RESTART_ATTEMPT``) is seen to fail with 3, runs
   again and passes. D: ``estimate-memory
   llama-3-8b`` in bf16 equals ``num_params`` x 2 to the byte (phase 17's
   16.06 GB). The kernels' table adds the launched children's launches to
   rows 4 and 4b.

20. Mixture of experts: ``mixtral_config_from_hf`` of the published
   mistralai/Mixtral-8x7B-v0.1 config (8 experts, top-2, drop-free capacity
   factor 4, router loss coefficient 0.02, no sliding window: flash), depth
   cut. A: ``ContinuousBatcher(paged=True)`` on 8 layers in bf16 (11.87B
   parameters), phase 3's wave: tokens equal a ``kernels="off"`` engine's,
   the gather kernel launched, tokens/s and TTFT logged with the dispatch
   back-end the layers ran (sorted: cf 4 > 2); ``generate`` on a ragged
   batch equals its ``kernels="off"`` run. B: ``build_train_step`` on 2
   layers (3.16B parameters), 2 x 2048, bf16, ``adamw(3e-4)``, clip 1.0, 5
   steps: every loss within ``TRAIN_LOSS_ATOL`` of the ``kernels="off"``
   loss on the same parameters, ``aux_loss`` finite and >= 1 - 1e-3 on every
   step, flash 2 + 2 launches and the update once a leaf (13) a step; step
   ms, tokens/s, active MFU against 989 TFLOP/s, peak memory. C: the
   imperative loop, 3 steps on B's model and batch. D: ep on one card
   through ``LoopbackShards(4)``: ep 4, ep 2 x dp 2 (ZeRO off), ep 2 x tp 2,
   ep 2 x fsdp 2, 3 steps each; the distinct shards over the ranks hold the
   unsharded bytes; the back-end is einsum; the update launches once per
   distinct update slice of the plan. E: pp 2 with 1F1B on the loopback
   (the router loss through the schedule), 3 steps. Every step of C, D and E
   within ``MOE_LOSS_ATOL`` of the unsharded ``kernels="off"`` loss on the
   parameters the arm holds (``MOE_LOSS_ATOL`` says why), and its
   free-running distance from arm B logged. F: the sorted, einsum and indexed back-ends at the layer's
   shapes (B 2, S 2048, h 4096, i 14336, E 8, k 2; cf 4 and 1.25, bf16)
   agree within ``MOE_OP_TILE_REL``; each one's forward and backward ms,
   and the sorted path's device-to-host read of the group sizes. G:
   ``estimate-memory`` on the literal: exactly 46,702,792,704 parameters,
   93.41 GB in bf16.

21. Hugging Face checkpoints and the classic-GPT decoders, on published
   config.json values. A: a random bf16 checkpoint in the Hugging Face
   GPT-NeoX layout of EleutherAI/pythia-6.9b (32 layers, hidden 4096, 32
   heads of 128, rotary over 32 lanes, parallel residual; 13.7 GB in two
   safetensors shards and an index) loaded by ``from_hf_checkpoint`` with
   the config as a dict; sampled leaves of every kind, first and last layer,
   bitwise the source rearranged by numpy (the per-head de-interleave of
   ``query_key_value``); phase 3's wave through ``ContinuousBatcher(paged=
   True)`` identical to ``kernels="off"``; ``generate`` on 4 of the wave's
   prompts against the engine's tokens (``greedy_agreement``: equal, or
   parted only at a near tie). B: A's model with ``matmul_precision=
   "int8"``, 4 int8 launches a layer a forward, tokens identical to the
   ``kernels="off"`` int8 engine's. E: the checkpoint converted onto the
   host, ``infer_auto_device_map`` under a 6 GiB card budget (logged), the
   layers dispatched to pinned host memory and streamed: 16 greedy tokens
   of 4 prompts identical to A's resident model, s and bytes a token. C:
   facebook/opt-30b's widths at 2 layers (1.61B parameters; relu, learned
   positions at offset 2, tied), ``build_train_step`` at 2 x 2048, bf16,
   ``adamw(3e-4)``, clip 1.0, 3 steps: flash 2 + 2 and the update once a
   leaf a step, the losses within ``TRAIN_LOSS_ATOL`` of a ``kernels="off"``
   arm's, the imperative loop within ``GPTX_IMPERATIVE_ATOL`` of the fused
   step; step ms, tokens/s, MFU, peak memory. F: C's widths at 4 x 2048 on
   ``LoopbackShards(4)``: tp 2 x fsdp 2, tp 4, pp 2 x dp 2 under 1F1B, each
   within ``SHARD_LOSS_ATOL`` of the unsharded step, flash once per rank
   and layer (1F1B: twice forward a microbatch), the update once per
   distinct slice of the plan, the distinct shards the unsharded bytes. D:
   openai-community/gpt2-xl at all 48 layers (1.56B parameters, flash at D
   = 64), 3 steps at 4 x 1024 under C's pins (its ``kernels="off"`` arm
   with remat, to fit), then greedy ``generate`` of 4 left-padded prompts
   against the uncached ``kernels="off"`` greedy decode. G:
   ``estimate-memory`` of gpt-j-6b, gpt-neox-20b and opt-30b equals the JAX
   package's parameter count x 2 bytes in bf16.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12    # H100 SXM int8 tensor cores, dense
SEED = 0
# Flash kernel vs its plain version, bf16 in and out: the kernel rounds P to
# bf16 before P.V (as the TPU library does) and the plain version does not,
# and both round the output to bf16, each a relative error of about 2^-9 an
# element. A causal output row i mixes i+1 values and shrinks as
# sqrt(e / (i + 1)), so the forward is held per 64-row query tile against
# that tile's own size: a dropped or wrong KV tile moves its query tile's
# output by tens of percent.
FLASH_FWD_TILE_REL = 1e-2  # forward: max over (batch, head, 64-row tile) of
                           # ||kernel - plain||_F / ||plain||_F, real-token rows
FLASH_BWD_REL = 2e-2       # dq, dk, dv: ||kernel - plain||_F / ||plain||_F
# Ring-block row stats vs the plain twin: both are f32 maxima and sums of the
# same bf16 products, summed in another order (and the kernel's exp is
# __expf), so l is held relative to max(l, 1) and m absolutely.
RING_STATS_ATOL = 1e-3
# Paged decode attention vs its plain version: the kernel sums the scores,
# the softmax and P.V in another order (f32), rounding the bf16 dot and the
# probabilities as the plain version does, so the pin is the largest
# ||kernel - plain|| / ||plain|| over the (slot, query, head) rows of active
# slots; a dropped or wrong block moves its row by far more.
PAGED_DECODE_ROW_REL = 1e-2
# (K, N) of the Llama-3-8B block projections: wq and wo, wk and wv, w_gate
# and w_up, w_down.
INT8_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# Training: losses of the kernel arm vs the kernels="off" arm, first 3 steps.
TRAIN_LOSS_ATOL = 3e-2
TRAIN_CUT = dict(num_hidden_layers=4, max_position_embeddings=2048)
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
# google/gemma-2-9b on the Hugging Face hub, config.json: the published
# widths; only the depth is cut (GEMMA2_LAYERS, and GEMMA2_PAIR_LAYERS for
# the comparison with kernels="off").
GEMMA2_9B = dict(vocab_size=256000, hidden_size=3584, intermediate_size=14336,
                 num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8,
                 head_dim=256, max_position_embeddings=8192, rms_norm_eps=1e-6,
                 rope_theta=10000.0, sliding_window=4096, query_pre_attn_scalar=256,
                 attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                 hidden_activation="gelu_pytorch_tanh")
GEMMA2_LAYERS, GEMMA2_PAIR_LAYERS = 4, 2
GEMMA2_BATCH, GEMMA2_SEQ = 1, 8192
# Phase 8: the attention of one Gemma-2-9B layer at the training shape.
GEMMA2_ATTENTION = dict(B=GEMMA2_BATCH, S=GEMMA2_SEQ, H=16, Hkv=8, D=256, scale=256 ** -0.5,
                        softcap=50.0)
# Phase 10: Llama-3-8B attention widths over a 4-rank ring.
RING_RANKS, RING_SEQ, RING_SMALL_SEQ = 4, 32768, 4096
RING_HEADS, RING_KV_HEADS, RING_HEAD_DIM = 32, 8, 128
# bert-base-cased on the Hugging Face hub, config.json: the published widths
# (phase 11, the canonical loop; random weights, dropout off).
BERT_BASE_CASED = dict(vocab_size=28996, hidden_size=768, num_hidden_layers=12,
                       num_attention_heads=12, intermediate_size=3072, hidden_act="gelu",
                       hidden_dropout_prob=0.1, max_position_embeddings=512, type_vocab_size=2,
                       layer_norm_eps=1e-12, position_embedding_type="absolute",
                       model_type="bert")
# MRPC's split sizes, the reference example's batch, sequences of 128 tokens.
LOOP_TRAIN, LOOP_EVAL, LOOP_BATCH, LOOP_SEQ = 3668, 408, 16, 128
LOOP_LR, LOOP_END_LR = 2e-5, 2e-6
LOOP_B_STEPS, LOOP_WARMUP, LOOP_TIMED = 40, 5, 30
# Phase 12: save at step CKPT_AT of CKPT_STEPS; the non-blocking arm steps
# CKPT_AFTER more before the join; the example arm saves every CKPT_EVERY
# of CKPT_D_STEPS steps, keeping CKPT_LIMIT; the export's shard size.
CKPT_STEPS, CKPT_AT, CKPT_AFTER = 40, 20, 2
CKPT_D_STEPS, CKPT_EVERY, CKPT_LIMIT = 30, 10, 2
CKPT_SHARD = "200MB"
# Phase 13: sharded training on one card through LoopbackShards.
SHARD_RANKS, SHARD_BATCH, SHARD_SEQ = 4, 4, 2048
SHARD_STEPS, SHARD_WARMUP = 4, 1
# Arms B and C vs arm A, first 3 losses: the ranks' rows run as 1 x 2048
# products where arm A runs 4 x 2048 ones, and the gradients sum over the
# ranks in f32, so the bf16 losses move in the third decimal at most; no
# looser than phase 7's kernels-off pin (TRAIN_LOSS_ATOL).
SHARD_LOSS_ATOL = 1e-2
# The fused update's launches a step, from the sharding plan of Llama's 12
# leaves (9 that the rules split, the 3 norms kept whole): one launch per
# distinct update slice of a leaf over the ranks. A and D unsharded: 12; B
# fsdp 4: 9 x 4 + 3 = 39 (the norms' slice is the same on every rank); C
# ZeRO dp 4: 12 x 4 = 48 (every leaf's update, the norms' too, split over dp).
SHARD_UPDATE_LAUNCHES = {"A": 12, "B": 39, "C": 48, "D": 12}
# Phase 14: the rest of single-card training at phase 7's cut.
PREC_FP16_STEPS, PREC_FP8_STEPS, PREC_FP8_OFF_STEPS = 8, 5, 3
PREC_FP16_POISON = 3  # the fp16 arms' step whose loss_fn returns +inf
PREC_WINDOW, PREC_WINDOWS, PREC_OFFLOAD_STEPS = 4, 2, 4
INT8_TRAIN_M = TRAIN_BATCH * TRAIN_SEQ  # rows of every block projection of a step
# Phase 15: tensor parallelism and Ulysses on one card, on phase 13's model
# and batch; arm E trains 1 x 8192 tokens (2048 a rank) under Ulysses sp 4.
TP_RANKS, TP_STEPS, TP_WARMUP = 4, 4, 1
TP_ULYSSES_SEQ = 8192
TP_FP16_POISON = 2  # arm F's third step: its loss_fn returns +inf
# Update launches a step on an applied step, as SHARD_UPDATE_LAUNCHES counts
# them: B tp 4 and C (F) tp 2 x fsdp 2: 9 x 4 + 3 = 39; D dp 2 x tp 2 under
# ZeRO: 9 x (2 x 2) + 3 x 2 = 42 (the norms split over dp only); E Ulysses
# sp 4: the parameters are whole on every sp rank, 12; the unsharded arms 12.
TP_UPDATE_LAUNCHES = {"A": 12, "B": 39, "C": 39, "D": 42, "E0": 12, "E": 12, "F0": 12,
                      "F": 39}
# One tp rank's flash at tp 4: 8 of the 32 query heads, 2 of the 8 KV heads.
TP_FLASH_CASE = ("tp rank B2 S2048 H8 KV2", 2, 2048, 8, 128, False, 2)
# Phase 16: pipeline parallelism on phase 13's model and batch, and
# prepare_pippy of the full model; PP_MICRO microbatches unless named (E:
# 2 a data coordinate, its 2 rows of the 4).
PP_STEPS, PP_WARMUP, PP_MICRO = 3, 1, 4
PP_PIPPY_CHUNKS = 4
# prepare_pippy on one card runs the forward's ops on the same inputs as
# the unpipelined forward, a chunk of rows at a time: bf16 logits of a few
# units; a dropped or misplaced layer moves them by whole units.
PIPPY_LOGITS_ATOL = 5e-2
# Phase 17: big-model loading and offloaded inference at Llama-3-8B widths:
# greedy generation of BIG_NEW_TOKENS from a BIG_BATCH x BIG_PROMPT batch
# (BIG_DISK_TOKENS from disk), a scoring forward of one BIG_SCORE_SEQ row,
# the checkpoint in shards of BIG_SHARD, the tight card budget of arm F.
BIG_BATCH, BIG_PROMPT, BIG_NEW_TOKENS, BIG_DISK_TOKENS = 4, 64, 16, 4
BIG_SCORE_SEQ, BIG_SHARD, BIG_TIGHT_CARD = 2048, "5GB", "6GiB"
BIG_LAYERS_ON_HOST = {"embed": "cuda:0", "layers": "cpu", "final_norm": "cuda:0",
                      "lm_head": "cuda:0"}
BIG_LAYERS_ON_DISK = dict(BIG_LAYERS_ON_HOST, layers="disk")
# A streamed or hooked forward runs the resident forward's bf16 ops on the
# same weights, one layer at a time: relative Frobenius of the logits.
BIG_LOGITS_REL = 1e-2
# Weight-only quantized logits against the resident bf16 ones, correlation:
# int8 at the JAX package's bar (tests/test_quantization.py:92-94, its int8
# case); int4's step (absmax / 7) is a third of a random weight's std, which
# leaves its logits far below 0.99 on random weights (the CPU test
# tests/test_torch_quantization.py::test_int4_on_random_weights_correlates_
# below_int8 holds it between 0.5 and 0.99 at 2 layers), so its floor only
# tells a working int4 path from a broken one.
QUANT_CORR_FLOOR = {8: 0.99, 4: 0.5}
# Phase 18: the CV example at its own settings; complete_cv_example saves
# every CV_CKPT_EVERY steps and resumes from step CV_RESUME_AT (mid-epoch:
# 32 steps an epoch). Step 1's loss in bf16 on the card vs f32 on the CPU
# (the same weights from the seed; bf16 rounds the parameters only).
CV_CKPT_EVERY, CV_RESUME_AT, CV_LOSS_REL, CV_MIN_ACCURACY = 16, 48, 2e-2, 0.9
# Phase 19: the launcher and the CLI. A launched child runs LAUNCH_STEPS
# steps of phase 11's loop (arm B: a constant adamw, one fused update launch
# a BERT leaf a step); a gang whose rank exits nonzero must come back within
# FAIL_FAST_S seconds.
LAUNCH_STEPS, BERT_LEAVES, FAIL_FAST_S = 10, 25, 30.0
# Phase 20: mistralai/Mixtral-8x7B-v0.1 on the Hugging Face hub, config.json:
# the published widths; only the depth is cut (MOE_SERVE_LAYERS for arm A,
# MOE_TRAIN_LAYERS for arms B-E), and the attention FLOPs count the step's
# sequence (TRAIN_CUT's max_position_embeddings), not the 32768 window.
MIXTRAL_8X7B = dict(architectures=["MixtralForCausalLM"], model_type="mixtral",
                    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    num_local_experts=8, num_experts_per_tok=2, rope_theta=1e6,
                    rms_norm_eps=1e-5, router_aux_loss_coef=0.02,
                    max_position_embeddings=32768, tie_word_embeddings=False,
                    sliding_window=None, hidden_act="silu")
MIXTRAL_8X7B_PARAMS = 46_702_792_704
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 8, 2
MOE_BATCH, MOE_SEQ, MOE_STEPS, MOE_SHARD_STEPS = 2, 2048, 5, 3
MOE_LEAVES = 13  # the update's leaves: Llama's 12 with the MLP's 3 as router + 3 stacks
# Arms C (the imperative loop), D (ep on one card) and E (pp 2, 1F1B): each
# step's loss against the unsharded kernels="off" loss on the parameters the
# arm holds at that step (the products split over ranks or microbatches, the
# router loss per microbatch under pp): phase 13's pin. Two free-running bf16
# trajectories of this model part within three adamw steps on a repeated
# batch (a top-2 choice that flips changes a token's experts, and adamw's
# first steps move every parameter by about the learning rate whatever its
# gradient's size), so phase 20 logs them and holds each step to its own
# parameters; arm B's kernels against kernels="off" the same way, at
# TRAIN_LOSS_ATOL.
MOE_LOSS_ATOL = SHARD_LOSS_ATOL
# Arm F: the three dispatch back-ends against each other in bf16, the
# output's relative Frobenius error per 64-token block (the expert products
# and the combine sum in another order; a dropped or misrouted token moves
# its block by far more) and the router loss's relative error.
MOE_OP_TILE_REL = 1e-2
# Phase 21: Hugging Face checkpoints and the classic-GPT decoders, on the
# published config.json values of EleutherAI/pythia-6.9b (arms A, B, E: all
# 32 layers), facebook/opt-30b (C, F: depth cut to GPTX_TRAIN_LAYERS) and
# openai-community/gpt2-xl (D: all 48 layers), from the Hugging Face hub.
PYTHIA_6_9B = dict(architectures=["GPTNeoXForCausalLM"], model_type="gpt_neox",
                   vocab_size=50432, hidden_size=4096, intermediate_size=16384,
                   num_hidden_layers=32, num_attention_heads=32, rotary_pct=0.25,
                   rotary_emb_base=10000, max_position_embeddings=2048, layer_norm_eps=1e-5,
                   use_parallel_residual=True, hidden_act="gelu", tie_word_embeddings=False,
                   bos_token_id=0, eos_token_id=0)
OPT_30B = dict(architectures=["OPTForCausalLM"], model_type="opt", vocab_size=50272,
               hidden_size=7168, ffn_dim=28672, num_hidden_layers=48, num_attention_heads=56,
               max_position_embeddings=2048, word_embed_proj_dim=7168, do_layer_norm_before=True,
               activation_function="relu", enable_bias=True, layer_norm_elementwise_affine=True,
               pad_token_id=1, bos_token_id=2, eos_token_id=2)
GPT2_XL = dict(architectures=["GPT2LMHeadModel"], model_type="gpt2", vocab_size=50257,
               n_embd=1600, n_layer=48, n_head=25, n_positions=1024, n_ctx=1024, n_inner=None,
               activation_function="gelu_new", layer_norm_epsilon=1e-5, scale_attn_weights=True,
               bos_token_id=50256, eos_token_id=50256)
# A and E: greedy tokens of GPTX_BATCH x GPTX_PROMPT seeded prompts; A's
# generate repeats the wave's requests GPTX_ENGINE_ROWS (prompts of 51-88
# tokens, none chunked); E streams under a card budget of GPTX_STREAM_CARD.
GPTX_BATCH, GPTX_PROMPT, GPTX_NEW_TOKENS = 4, 64, 16
GPTX_ENGINE_ROWS = (1, 2, 3, 4)
GPTX_STREAM_CARD = "6GiB"
GPTX_TRAIN_LAYERS, GPTX_TRAIN_BATCH, GPTX_SEQ, GPTX_STEPS = 2, 2, 2048, 3
GPTX_SHARD_BATCH = 4
GPT2_BATCH, GPT2_SEQ = 4, 1024
# C: the imperative loop against the fused step on the same model and batch
# (the same ops in another grouping; phase 20's MoE loop was bitwise).
GPTX_IMPERATIVE_ATOL = 1e-3
# Two greedy decodes of one bf16 model by different routes (chunked or not,
# another batch shape) may part only at a near tie: a top-2 gap within 2^-6
# of the top logit, four bf16 steps of a logit the head rounds to bf16.
GREEDY_TIE_REL = 2 ** -6
# estimate-memory's presets: parameters by the JAX package's GPTX.num_params.
CLASSIC_GPT_PARAMS = {"gpt-j-6b": 6_050_882_784, "gpt-neox-20b": 20_554_567_680,
                      "opt-30b": 29_974_540_288}
T_START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, stamped with seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}")


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text: str) -> list:
    """One line per kernel entry of an ``nvcc -Xptxas -v`` log: its
    (mangled) name, registers, static shared memory and spills."""
    import re

    out, entry, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out.append(f"{entry}: {m.group(1)} registers, static shared memory "
                       f"{smem.group(1) if smem else 0} B, {spill}")
            entry, spill = None, ""
    return out


def check_no_spills(summary: list, name: str) -> None:
    """Fails the run if ptxas spilled in any kernel of ``name``."""
    for line in summary:
        if "spill" in line and not line.endswith("spill stores 0 B, loads 0 B"):
            raise SystemExit(f"build[{name}]: a kernel spills registers: {line}")


def sass_registers(path) -> dict:
    """The highest register each kernel of a built library uses, from
    ``cuobjdump -sass`` (``Used N registers`` from ptxas is the launch
    bound's share; code after ``setmaxnreg`` may use more)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = -1
            continue
        if fn is not None:
            for r in re.findall(r"\bR(\d+)\b", line):
                out[fn] = max(out[fn], int(r))
    return out


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(event) -> float:
    """Self device time of one ``torch.profiler`` key average, in us."""
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0))


def device_records(prof) -> list:
    """The profiler's raw device records, ``(name, kind, us)`` with kind
    "kernel" or "copy" (memcpy, memset): what CUPTI reported, one record a
    launch, before ``key_averages`` nests events into a tree and subtracts
    the time of an event's children from its self time."""
    import torch

    return [(e.name(), "copy" if e.name().startswith(("Memcpy", "Memset")) else "kernel",
             e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]


def profile_calls(fn, iters: int = 10, warmup: bool = True) -> list:
    """The raw device records (``device_records``) of ``iters`` calls of
    ``fn`` (after one outside) under ``torch.profiler``. With ``warmup``
    the profiler first traces one call in a cycle it discards
    (``torch.profiler.schedule``), so the measured calls run under a trace
    that is already recording."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    got = []
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=int(warmup), active=1),
                 on_trace_ready=lambda prof: got.append(device_records(prof))) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return got[0]


def profiled_ms(fn, kernels: int, iters: int = 10, label: str = "") -> float:
    """Device time of the CUDA kernels ``fn()`` launches, per call, summed
    from the raw records of ``torch.profiler`` over ``iters`` calls.
    ``cuda_ms`` times back-to-back calls between two events, so for a kernel
    of tens of microseconds it counts the gaps in which the card waits for
    the host's per-call work; this leaves them out. ``kernels`` is the
    number of kernels one call launches. The profiler now and then drops
    records (PERF.md section 7): a trace with fewer than ``iters * kernels``
    kernel records is taken again, and after three such traces the time is
    ``synced_ms``'s (CUDA events around single synchronised calls, launch
    included: never shorter than the device time), logged as such, so a
    lost record never passes as a shorter time."""
    for _ in range(3):
        records = profile_calls(fn, iters)
        n_kernels = sum(a == "kernel" for _, a, _ in records)
        if n_kernels >= iters * kernels:
            break
    else:
        ms = synced_ms(fn, iters)
        log(f"profiled_ms {label}: the profiler kept {n_kernels} kernel records of "
            f"{iters * kernels} in three traces; {ms:.4f} ms a call by CUDA events around "
            f"single synchronised calls instead (an upper bound)")
        return ms
    ms = sum(us for _, _, us in records) / 1e3 / iters
    per_kernel = {}
    for name, _, us in records:
        per_kernel[name[:60]] = per_kernel.get(name[:60], 0.0) + us / 1e3 / iters
    log(f"profiled_ms {label}: {n_kernels} kernel records, {ms:.4f} ms a call ("
        + ", ".join(f"{n} {t:.4f}" for n, t in sorted(per_kernel.items(), key=lambda kv: -kv[1]))
        + ")")
    return ms


def synced_ms(fn, iters: int = 10) -> float:
    """Mean CUDA-event time of single calls of ``fn``, each between two
    synchronizes: the card's time for a call, its launch included, with no
    other work queued around it."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def engine_geometry(model):
    """The pool's blocks and a slot's table length of the serving engine
    built with ``engine_kwargs()``."""
    from accelerate_tpu_torch import ContinuousBatcher

    probe = ContinuousBatcher(model, **engine_kwargs())
    return probe.num_blocks, probe.max_blocks_per_slot


def engine_kwargs():
    import torch

    # 8 slots x 26 blocks of 16 tokens: every slot can hold its worst-case chain.
    return dict(batch_slots=8, block_size=16, bucket_sizes=(16, 32, 64, 128),
                max_new_tokens=32, sync_every=8, max_tokens_per_request=256,
                max_cache_len=8 * 26 * 16, cache_dtype=torch.bfloat16, device="cuda")


def make_traffic(vocab: int):
    import numpy as np

    rng = np.random.default_rng(SEED)
    prefix = rng.integers(1, vocab, (48,)).astype(np.int32)
    # The first suffix makes a 198-token prompt: longer than prefill_chunk
    # (128), so its prefill runs in two chunks and registers shareable blocks.
    lengths = (150, 5, 17, 40, 3, 90, 12, 60, 8, 25)
    return prefix, [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lengths]


def run_wave(engine, prefix, suffixes):
    import torch

    engine.set_prefix(prefix)
    rids = [engine.submit(s) for s in suffixes]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [out[r] for r in rids], wall


def op_phase(model_cfg, kw, engine_blocks: int, max_blocks: int):
    """Kernel vs plain version at the engine's shapes; returns kernel rows."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.ops.kernels.paged_gather import paged_gather
    from accelerate_tpu_torch.ops.paged_attention import gather_block_view

    L, Hkv, D = model_cfg.num_hidden_layers, model_cfg.num_key_value_heads, model_cfg.head_dim
    bs, B, M, N = kw["block_size"], kw["batch_slots"], max_blocks, engine_blocks + 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    tables = np.zeros((B, M), np.int32)
    active = np.ones((B,), bool)
    active[[2, 5]] = False  # two slots between requests
    free = rng.permutation(np.arange(1, N))
    for b in np.nonzero(active)[0]:
        n = int(rng.integers(M // 2, M + 1))
        tables[b, :n], free = free[:n], free[n:]
    tables_t = torch.tensor(tables, device=dev)
    active_t = torch.tensor(active, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    pools = {
        "paged_gather": dict(
            pool=torch.randn((L, N, bs, Hkv, D), generator=g, device=dev, dtype=torch.bfloat16),
            scales=None, out_dtype=None),
        "paged_gather_dequant": dict(
            pool=torch.randint(-127, 128, (L, N, bs, Hkv, D), generator=g, device=dev,
                               dtype=torch.int8),
            scales=torch.rand((L, N, bs), generator=g, device=dev) * 0.05 + 1e-3,
            out_dtype=torch.bfloat16),
    }
    used = np.unique(tables[active])  # distinct pool blocks the active slots read
    rows = []
    for name, case in pools.items():
        pool, scales, out_dtype = case["pool"], case["scales"], case["out_dtype"]
        kernel = lambda: paged_gather(pool, tables_t, active=active_t, scales=scales,
                                      out_dtype=out_dtype)
        plain = lambda: gather_block_view(pool, tables_t, active=active_t, scales=scales,
                                          out_dtype=out_dtype)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise SystemExit(f"{name}: kernel gave {got.shape}/{got.dtype}, "
                             f"plain {ref.shape}/{ref.dtype}")
        act = torch.tensor(active, device=dev)
        same = torch.equal(got[:, act].view(torch.int16 if got.element_size() == 2 else torch.int32),
                           ref[:, act].view(torch.int16 if ref.element_size() == 2 else torch.int32))
        zeros = bool((got[:, ~act] == 0).all())
        err = float((got[:, act].float() - ref[:, act].float()).abs().max())
        if not (same and zeros):
            raise SystemExit(f"{name}: kernel disagrees with the plain version "
                             f"(bitwise={same}, inactive zeros={zeros}, max_abs_err={err})")
        flat = tables_t.reshape(-1).long()
        library = None
        if scales is None:
            shape = (L, B, M * bs, Hkv, D)
            library = lambda: pool.index_select(1, flat).reshape(shape)
        out_bytes = got.numel() * got.element_size()
        in_bytes = L * len(used) * bs * Hkv * D * pool.element_size()
        if scales is not None:
            in_bytes += L * len(used) * bs * 4
        moved = in_bytes + out_bytes + tables.nbytes + active.nbytes
        ops = L * int(active.sum()) * M * bs * Hkv * D if scales is not None else 0
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": "accelerate_tpu_torch/csrc/paged_gather.cu",
            "replaces": "accelerate_tpu/ops/pallas/paged_decode.py:204",
            "launches": 0, "max_abs_err": err,
            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(library) if library is not None else None,
        }
        log(f"op {name}: shape {tuple(got.shape)} {got.dtype}, bitwise equal on active "
              f"slots, zeros on inactive; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library "
              f"{'n/a' if row['library_ms'] is None else format(row['library_ms'], '.4f') + ' ms'}, "
              f"bound {row['bound_ms']:.4f} ms ({moved / 1e6:.1f} MB)")
        rows.append(row)
    del pools
    torch.cuda.empty_cache()
    return rows


def engine_forwards(engine) -> int:
    """Model forwards the engine ran: one per prefill chunk, ``sync_every``
    per decode window."""
    log_ = engine._dispatch_log
    return sum(e.startswith("chunk") for e in log_) + engine.sync_every * log_.count("decode")


def engine_phase(model, kv_quant, kernel_names, card: str, matmul_precision=None):
    """Both arms on one wave; returns the kernel arm's launch counts, its
    forwards, tokens/s, TTFT p50 (s) and tokens."""
    import numpy as np

    from accelerate_tpu_torch import ContinuousBatcher
    from accelerate_tpu_torch.ops import registry

    kw = dict(engine_kwargs(), kv_quant=kv_quant, matmul_precision=matmul_precision)
    prefix, suffixes = make_traffic(model.config.vocab_size)
    off = ContinuousBatcher(model, kernels="off", **kw)
    ref_tokens, off_wall = run_wave(off, prefix, suffixes)
    del off
    engine = ContinuousBatcher(model, **kw)
    registry.reset_launch_counts()
    tokens, wall = run_wave(engine, prefix, suffixes)
    launches = dict(registry.launch_counts)
    stats, slo = engine.pool_stats(), engine.slo_report()
    label = f"engine[kv_quant={kv_quant}, matmul_precision={matmul_precision}]"
    if len(tokens) != len(suffixes) or any(t.size == 0 for t in tokens):
        raise SystemExit(f"{label}: not every request finished")
    if stats["blocks_free"] != stats["num_blocks"]:
        raise SystemExit(f"{label}: {stats['blocks_free']} of {stats['num_blocks']} blocks free")
    for name in kernel_names:
        if launches.get(name, 0) <= 0:
            raise SystemExit(f"{label}: {name} was never launched ({launches})")
    if slo["decisions"]["chunked_prefills"] < 1:
        raise SystemExit(f"{label}: chunked prefill did not engage")
    for i, (a, b) in enumerate(zip(tokens, ref_tokens)):
        if not np.array_equal(a, b):
            raise SystemExit(f"{label}: request {i} differs from kernels='off': {a} vs {b}")
    vocab = model.config.vocab_size
    if any(((t < 0) | (t >= vocab)).any() for t in tokens):
        raise SystemExit(f"{label}: token id outside the vocabulary")
    forwards = engine_forwards(engine)
    n_tok = int(sum(t.size for t in tokens))
    ttft = float(np.median(slo["ttft_s"]))
    log(f"{label}: {len(tokens)} requests, {n_tok} tokens generated, wall {wall:.3f} s "
        f"(kernels='off' arm {off_wall:.3f} s), {n_tok / wall:.1f} tokens/s, TTFT p50 "
        f"{ttft * 1e3:.1f} ms, {forwards} forwards, launches {launches}, decisions "
        f"{slo['decisions']}, pool {stats['pool_bytes'] / 2**20:.0f} MiB; identical to "
        f"kernels='off' [{card}]")
    for i, (suffix, toks) in enumerate(zip(suffixes, tokens)):
        log(f"{label}: request {i}: prompt {prefix.size}+{suffix.size} tokens -> "
            f"{toks.size} tokens {toks.tolist()}")
    return dict(launches=launches, forwards=forwards, tokens_per_s=n_tok / wall, ttft_s=ttft,
                tokens=tokens)


def int8_engine_phase(model, card: str, bf16_run: dict):
    """Int8-weight serving on the int8 pool; returns its run."""
    L = model.config.num_hidden_layers
    run = engine_phase(model, "int8", ("int8_matmul", "paged_gather_dequant"), card,
                       matmul_precision="int8")
    want = 7 * L * run["forwards"]
    got = run["launches"]["int8_matmul"]
    if got != want:
        raise SystemExit(f"int8 engine: int8_matmul launched {got} times over "
                         f"{run['forwards']} forwards, expected {want} (7 projections x {L} layers)")
    log(f"int8 engine: int8_matmul {got} launches = {got // run['forwards']} per forward over "
        f"{run['forwards']} forwards; {run['tokens_per_s']:.1f} tokens/s and TTFT p50 "
        f"{run['ttft_s'] * 1e3:.1f} ms, against {bf16_run['tokens_per_s']:.1f} tokens/s and "
        f"{bf16_run['ttft_s'] * 1e3:.1f} ms with bf16 weights and pool in this process")
    return run


def reference_phase(model):
    """Engine == per-request generate() on a tiny fp32 model; 8B logits finite."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import ContinuousBatcher, Llama, LlamaConfig, generate

    ids = torch.arange(1, 9, device="cuda", dtype=torch.int32)[None]
    logits = model.apply(model.params, input_ids=ids)["logits"]
    if tuple(logits.shape) != (1, 8, model.config.vocab_size) or not torch.isfinite(logits).all():
        raise SystemExit(f"8B forward: logits {tuple(logits.shape)}, finite "
                         f"{bool(torch.isfinite(logits).all())}")
    tiny = Llama(LlamaConfig.tiny(), device="cuda")
    tiny.init_params(SEED)
    prefix, suffixes = make_traffic(tiny.config.vocab_size)
    engine = ContinuousBatcher(tiny, batch_slots=2, block_size=4, bucket_sizes=(8, 16, 32),
                               max_new_tokens=6, sync_every=2, max_tokens_per_request=256,
                               max_cache_len=2048, cache_dtype=torch.float32, device="cuda")
    engine.set_prefix(prefix[:10])
    rids = [engine.submit(s) for s in suffixes[:4]]
    out = engine.run()
    for rid, s in zip(rids, suffixes[:4]):
        full = np.concatenate([prefix[:10], s])[None]
        ref = generate(tiny, full, max_new_tokens=6, cache_dtype=torch.float32,
                       include_prompt=False, device="cuda")[0].cpu().numpy()
        if not np.array_equal(out[rid], ref):
            raise SystemExit(f"tiny engine differs from generate(): {out[rid]} vs {ref}")
    log("reference: 8B logits finite (1, 8, 128256); tiny fp32 engine == generate() "
          "for 4 requests")


def row_rel_err(got, ref, active) -> float:
    """Largest ``||got - ref|| / ||ref||`` over the (slot, query, head) rows
    of (B, S, H, D) outputs, on the slots ``active`` marks (the absolute
    error where a row of ``ref`` is all zeros)."""
    import torch

    g, r = got[active].float(), ref[active].float()
    num, den = (g - r).square().sum(-1), r.square().sum(-1)
    return float(torch.where(den > 0, num / den.clamp_min(1e-30), num).sqrt().max())


def int8_op_phase():
    """Int8 matmul kernel vs its plain version at the projection shapes;
    returns the kernel-table row (M = 8, the gate projection)."""
    import torch

    from accelerate_tpu_torch.ops.int8 import int8_matmul_reference, quantize_rowwise
    from accelerate_tpu_torch.ops.kernels.int8_matmul import (
        int8_matmul_cuda,
        plan,
        quotient_disagreements,
    )

    t0 = time.perf_counter()
    bad, pairs = quotient_disagreements(stride=1)
    if bad or pairs != (1 << 23) * 11 * 128:
        raise SystemExit(f"int8_matmul self-check: the bf16 division disagrees with __fdiv_rn "
                         f"for {bad} of {pairs} pairs")
    log(f"op int8_matmul self-check: the bf16 division equals __fdiv_rn for all {pairs} pairs of "
        f"a scale significand and a bf16 value with a quotient in [2^-3, 2^7] "
        f"({time.perf_counter() - t0:.2f} s)")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row, cells = None, []
    for M in (8, 128):
        for K, N in INT8_SHAPES:
            x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.bfloat16)
            w = (torch.randn((K, N), generator=g, device="cuda") / math.sqrt(K)).to(torch.bfloat16)
            got, ref = int8_matmul_cuda(x, w), int8_matmul_reference(x, w)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            if got.dtype != ref.dtype or not torch.equal(got.view(torch.int16),
                                                         ref.view(torch.int16)):
                raise SystemExit(f"int8_matmul M={M} K={K} N={N}: kernel disagrees with the "
                                 f"plain version (max_abs_err={err})")
            qx, _ = quantize_rowwise(x, -1)
            qw, _ = quantize_rowwise(w, 0)
            # torch._int_mm takes more than 16 rows: decode rows are padded
            # with zeros; the weight is column-major, cuBLASLt's int8 layout.
            qa = qx if M > 16 else torch.cat([qx, qx.new_zeros((32 - M, K))])
            qb = qw.t().contiguous().t()
            t_kernel = cuda_ms(lambda: int8_matmul_cuda(x, w), 20)
            t_device = profiled_ms(lambda: int8_matmul_cuda(x, w), kernels=2,
                                   label=f"int8_matmul M={M} K={K} N={N}")
            t_plain = cuda_ms(lambda: int8_matmul_reference(x, w), 5)
            t_lib = cuda_ms(lambda: torch._int_mm(qa, qb), 20)
            t_bf16 = cuda_ms(lambda: x @ w, 20)  # cuBLAS: reads the same weight bytes
            moved = 2 * (M * K + K * N + M * N)  # bf16 x and w in, bf16 out
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * M * N * K / INT8_OPS_PER_S * 1e3
            bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            pl = plan(M, N, K, 2, sms)
            log(f"op int8_matmul M={M} K={K} N={N} bf16: bitwise equal; kernel "
                f"{t_kernel:.4f} ms ({t_device:.4f} ms of device time, profiler), plain "
                f"{t_plain:.4f} ms, library {t_lib:.4f} ms "
                f"(torch._int_mm on pre-quantized operands{'' if M > 16 else ', 32 rows'}: the "
                f"contraction only), bf16 x @ w (cuBLAS) {t_bf16:.4f} ms, bound {bound:.4f} ms "
                f"({by}, {moved / 1e6:.1f} MB, {moved / t_kernel / 1e9:.2f} TB/s achieved, "
                f"{bound / t_kernel:.1%} of the bound); panels of {pl.nt} columns, clusters of "
                f"{pl.cluster} CTAs x {pl.per} k blocks, tiles of {pl.mt} rows, {pl.ctas} CTAs "
                f"of {pl.smem} B shared memory")
            cells.append(dict(M=M, K=K, N=N, ms=round(t_kernel, 4), device_ms=round(t_device, 4),
                              bound_ms=round(bound, 4), tb_s=round(moved / t_kernel / 1e9, 3),
                              int_mm_ms=round(t_lib, 4), bf16_ms=round(t_bf16, 4),
                              plain_ms=round(t_plain, 4)))
            if (M, K, N) == (8, 4096, 14336):
                row = {"name": "int8_matmul", "route": "cuda",
                       "source": "accelerate_tpu_torch/csrc/int8_matmul.cu",
                       "replaces": "accelerate_tpu/ops/pallas/int8_mm.py:36", "launches": 0,
                       "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
                       "bound_ms": bound, "bound_by": by, "library_ms": t_lib}
            del x, w, got, ref, qx, qw, qa, qb
    log(f"op int8_matmul cells: {json.dumps(cells)}")
    free_cuda()
    return row


def paged_decode_inputs(model_cfg, bs: int, slots: int, M: int, N: int, quant: bool, layers=None):
    """Pools (one layer, or ``layers`` stacked), tables of ``slots`` slots
    with ragged chains and trash-block tails, a mask with holes, slots 2 and
    5 inactive (where there are that many), one query per slot at its
    chain's last token; made on the card from the seed."""
    import numpy as np
    import torch

    Hkv, D, H = model_cfg.num_key_value_heads, model_cfg.head_dim, model_cfg.num_attention_heads
    B = slots
    rng = np.random.default_rng(SEED + M)
    tables = np.zeros((B, M), np.int32)
    active = np.ones((B,), bool)
    active[[i for i in (2, 5) if i < B]] = False
    free = rng.permutation(np.arange(1, N))
    pos = np.zeros((B, 1), np.int32)
    for b in np.nonzero(active)[0]:
        n = int(rng.integers(M // 2, M + 1)) if B > 1 else M
        tables[b, :n], free = free[:n], free[n:]
        pos[b, 0] = n * bs - 1 - int(rng.integers(0, bs))  # the frontier inside the last block
    mask = (rng.random((N, bs)) > 0.1).astype(np.int32)
    mask[0] = 0  # the trash block
    g = torch.Generator(device="cuda").manual_seed(SEED + M)
    lead = () if layers is None else (layers,)
    shape = lead + (N, bs, Hkv, D)
    if quant:
        k, v = (torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
                for _ in range(2))
        scales = [torch.rand(lead + (N, bs), generator=g, device="cuda") * 0.05 + 1e-3
                  for _ in range(2)]
    else:
        k, v = (torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        scales = [None, None]
    q = torch.randn((B, 1, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    dev = torch.device("cuda")
    return dict(q=q, k=k, v=v, k_scale=scales[0], v_scale=scales[1],
                tables=torch.tensor(tables, device=dev), pos=torch.tensor(pos, device=dev),
                mask=torch.tensor(mask, device=dev), active=torch.tensor(active, device=dev),
                used=np.unique(tables[active]))


def paged_decode_phase(model_cfg, kw, engine_blocks: int, max_blocks: int):
    """Drive the op face over one decode step of all layers at the engine's
    geometry (launches counted), then hold the kernel to its plain version
    at the engine's geometry, on 4096-token chains (M = 256) and for one
    slot with a 4096-token chain; returns the kernel-table rows (bf16 and
    int8 pools, engine geometry)."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.ops.kernels import paged_decode as decode_kernel
    from accelerate_tpu_torch.ops.kernels.paged_decode import paged_decode_cuda
    from accelerate_tpu_torch.ops.paged_attention import (
        gather_block_mask,
        gather_block_view,
        paged_attention,
        paged_attention_plain,
        paged_attention_reference,
    )

    L, bs, B = model_cfg.num_hidden_layers, kw["block_size"], kw["batch_slots"]
    H, Hkv, D = model_cfg.num_attention_heads, model_cfg.num_key_value_heads, model_cfg.head_dim
    launches = {}
    for quant in (False, True):
        c = paged_decode_inputs(model_cfg, bs, B, max_blocks, engine_blocks + 1, quant, layers=L)
        registry.reset_launch_counts()
        for layer in range(L):
            scales = {} if not quant else dict(k_scale=c["k_scale"][layer],
                                               v_scale=c["v_scale"][layer])
            paged_attention(c["q"], c["k"][layer], c["v"][layer], c["tables"],
                            q_positions=c["pos"], pool_mask=c["mask"], active=c["active"],
                            **scales)
        torch.cuda.synchronize()
        launches[quant] = dict(registry.launch_counts)
        if launches[quant] != {"paged_decode": L}:
            raise SystemExit(f"paged_attention over {L} layers ({'int8' if quant else 'bf16'} "
                             f"pool): launches {launches[quant]}, expected paged_decode {L}")
        del c
    log(f"paged_attention driven over one decode step of {L} layers at the engine's geometry "
        f"(B={B}, M={max_blocks}, bs={bs}): launches {launches[False]} (bf16 pool), "
        f"{launches[True]} (int8 pool)")
    rows, cells = [], []
    for label, slots, M, N in (("engine M=%d" % max_blocks, B, max_blocks, engine_blocks + 1),
                               ("long M=256", B, 256, 6 * 256 + 1),
                               ("one slot M=256", 1, 256, 256 + 1)):
        for quant in (False, True):
            c = paged_decode_inputs(model_cfg, bs, slots, M, N, quant)
            kwargs = dict(q_positions=c["pos"], pool_mask=c["mask"], active=c["active"],
                          k_scale=c["k_scale"], v_scale=c["v_scale"])
            args = (c["q"], c["k"], c["v"], c["tables"])
            # (a tree from before the split kernel has no plan(): one kernel a call)
            part = (decode_kernel.plan(slots, 1, H, Hkv, D, bs, M, q_dtype=c["q"].dtype,
                                       kv_dtype=c["k"].dtype)
                    if hasattr(decode_kernel, "plan") else
                    {"splits": 1, "split_blocks": M, "ctas": slots * H, "stages": 0, "smem": 0,
                     "launches": 1})
            got, ref = paged_decode_cuda(*args, **kwargs), paged_attention_plain(*args, **kwargs)
            torch.cuda.synchronize()
            act = c["active"]
            rel = row_rel_err(got, ref, act)
            zeros = bool((got[~act] == 0).all())
            err = float((got[act].float() - ref[act].float()).abs().max())
            name = "paged_decode_int8" if quant else "paged_decode"
            if got.dtype != ref.dtype or not zeros or not math.isfinite(rel) \
                    or rel > PAGED_DECODE_ROW_REL:
                raise SystemExit(f"{name} {label}: kernel disagrees with the plain version "
                                 f"(row rel err {rel}, pin {PAGED_DECODE_ROW_REL}; inactive zeros "
                                 f"{zeros}; dtypes {got.dtype}/{ref.dtype})")
            # The library yardstick: sdpa on the already-gathered bf16 view
            # (attention only), with the causal and validity mask.
            k_view = gather_block_view(c["k"], c["tables"], scales=c["k_scale"],
                                       out_dtype=torch.bfloat16 if quant else None)
            v_view = gather_block_view(c["v"], c["tables"], scales=c["v_scale"],
                                       out_dtype=torch.bfloat16 if quant else None)
            T = M * bs
            keep = gather_block_mask(c["mask"], c["tables"]).bool() & (
                torch.arange(T, device="cuda")[None] <= c["pos"])
            qt, kt, vt = c["q"].transpose(1, 2), k_view.transpose(1, 2), v_view.transpose(1, 2)
            attn_mask = keep[:, None, None, :]
            t_kernel = cuda_ms(lambda: paged_decode_cuda(*args, **kwargs), 20)
            t_device = profiled_ms(lambda: paged_decode_cuda(*args, **kwargs),
                                   kernels=part["launches"], label=f"{name} {label}")
            t_plain = cuda_ms(lambda: paged_attention_plain(*args, **kwargs), 5)
            t_status = cuda_ms(lambda: paged_attention_reference(*args, **kwargs), 10)
            t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=attn_mask, enable_gqa=True), 20)
            el = c["k"].element_size()
            per_block = 2 * bs * Hkv * D * el + bs * 4 + (2 * bs * 4 if quant else 0)
            moved = (len(c["used"]) * per_block + c["q"].numel() * 2
                     + got.numel() * got.element_size() + c["tables"].numel() * 4)
            n_keys = int(act.sum()) * T
            ops = 4 * H * D * n_keys  # q.k and p.v, a multiply and an add each
            t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
            bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            log(f"op {name} {label}: out {tuple(got.shape)} {got.dtype}, row rel err {rel:.3e} "
                f"(pin {PAGED_DECODE_ROW_REL}), max|err| {err:.3e}, inactive slots zero; plan "
                f"{part['splits']} splits of {part['split_blocks']} blocks, {part['ctas']} CTAs, "
                f"{part['stages']} stages, {part['smem']} B shared memory, {part['launches']} "
                f"kernels a call; kernel {t_kernel:.4f} ms ({t_device:.4f} ms of device time, "
                f"profiler: {moved / t_device / 1e9:.2f} TB/s, {bound / t_device:.1%} of the "
                f"bound), plain {t_plain:.4f} ms, gather kernel + cached_attention "
                f"{t_status:.4f} ms, library {t_lib:.4f} ms (scaled_dot_product_attention on "
                f"the gathered view: attention only), bound {bound:.4f} ms ({by}, "
                f"{moved / 1e6:.2f} MB)")
            cells.append({"cell": f"{name} {label}", "slots": slots, "M": M,
                          "splits": part["splits"], "ctas": part["ctas"],
                          "stages": part["stages"], "smem": part["smem"], "ms": t_kernel,
                          "device_ms": t_device, "bound_ms": bound,
                          "share": bound / t_device, "tb_s": moved / t_device / 1e9,
                          "plain_ms": t_plain, "library_ms": t_lib, "max_abs_err": err,
                          "row_rel_err": rel})
            if M == max_blocks:
                rows.append({"name": name, "route": "cuda",
                             "source": "accelerate_tpu_torch/csrc/paged_decode.cu",
                             "replaces": "accelerate_tpu/ops/pallas/paged_decode.py:64",
                             "launches": launches[quant]["paged_decode"], "max_abs_err": err,
                             "ms": t_kernel, "plain_ms": t_plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": t_lib})
            del c, got, ref, k_view, v_view, qt, kt, vt
    log(f"op paged_decode cells: {json.dumps(cells)}")
    free_cuda()
    return rows


def profile_wave(model, label: str, **engine_kw):
    """torch.profiler over one wave: device time by kernel, busy share, and
    the int8 matmul's kernels a forward (from the raw device records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import ContinuousBatcher

    prefix, suffixes = make_traffic(model.config.vocab_size)
    engine = ContinuousBatcher(model, **dict(engine_kwargs(), **engine_kw))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_wave(engine, prefix, suffixes)
    by_name = {}
    for name, _, us in device_records(prof):
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + us / 1e3, n + 1)
    total = sum(ms for ms, _ in by_name.values())
    launches = sum(n for _, n in by_name.values())
    forwards = engine_forwards(engine)
    int8_ms = sum(ms for name, (ms, _) in by_name.items()
                  if "int8_matmul_cluster" in name or "quantize_rows" in name)
    int8_n = sum(n for name, (_, n) in by_name.items() if "int8_matmul_cluster" in name)
    log(f"profile {label} wave: wall {wall * 1e3:.1f} ms, device busy {total:.1f} ms "
        f"({100 * total / (wall * 1e3):.1f}%), {launches} device records over {forwards} "
        f"forwards ({launches / forwards:.0f} per forward, "
        f"{wall * 1e3 / forwards:.1f} ms wall and {total / forwards:.2f} ms device per forward); "
        f"int8 matmul kernels {int8_ms:.2f} ms ({int8_n} calls, {int8_ms / forwards:.2f} ms a "
        f"forward, {100 * int8_ms / max(total, 1e-9):.1f}% of device time)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"profile {label}:   {ms:9.2f} ms  {n:6d}x  {name[:90]}")
    del engine
    free_cuda()


def free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def bound_row(flops: float, moved: float):
    t_ops, t_bytes = flops / BF16_OPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def speed_note(flops: float, ms: float, library_ms: float, bound_ms: float) -> str:
    """A kernel row's rate, its time over the library call's and its share
    of the bound (bound time over kernel time)."""
    return (f"{flops / ms / 1e9:.1f} TFLOP/s, {ms / library_ms:.2f}x the library call, "
            f"{bound_ms / ms:.1%} of the bound")


def tile_rel_err(got, ref, real, tile: int = 64) -> float:
    """Largest ``||got - ref||_F / ||ref||_F`` over the (batch, head,
    ``tile``-row query tile) blocks of (B, S, H, D) outputs, on the rows
    ``real`` (B, S) marks; a tile with no such row is skipped."""
    B, S, H, D = ref.shape
    keep = real[:, :, None, None].float()
    diff = ((got.float() - ref.float()) * keep).reshape(B, S // tile, tile, H, D)
    base = (ref.float() * keep).reshape(B, S // tile, tile, H, D)
    num, den = diff.square().sum((2, 4)), base.square().sum((2, 4))
    return float((num[den > 0] / den[den > 0]).sqrt().max())


def flash_case(B, S, H, D, padded: bool, dtype=None, kv_heads=None):
    """Inputs of one flash case (bf16 unless ``dtype``), made on the card
    from the seed; with ``kv_heads`` k and v hold that many heads, each
    repeated to H (the model repeats them before attention)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device="cuda",
                               dtype=dtype or torch.bfloat16) for _ in range(4))
    if kv_heads is not None:
        k, v = (t[:, :, :kv_heads].repeat_interleave(H // kv_heads, dim=2).contiguous()
                for t in (k, v))
    seg = None
    if padded:  # right padding: the last quarter of row 1 is pads
        seg = torch.full((B, S), 2, dtype=torch.int32, device="cuda")
        seg[1, -S // 4:] = 1
    return q, k, v, do, seg


FLASH_CASES = [("causal S2048", 2, 2048, 32, 128, False),
               ("padded S2048", 2, 2048, 32, 128, True),
               ("crossover S1024", 2, 1024, 32, 128, False),
               ("ragged S1088", 2, 1088, 32, 128, True), ("D64 S2048", 2, 2048, 32, 64, False)]


def flash_op_phase(dtype=None, cases=None):
    """Flash kernel vs its plain version, bf16 unless ``dtype`` (fp16:
    phase 14's cell); returns the fwd and bwd rows at the training shape
    (the first case), named as the wrapper counts that dtype's launches."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops.attention import flash_attention_reference
    from accelerate_tpu_torch.ops.kernels import flash_attention as fk

    dtype = dtype or torch.bfloat16
    fwd_name, bwd_name = fk.LAUNCH_NAMES[dtype]
    rows = []
    for label, B, S, H, D, padded, *kv in cases or FLASH_CASES:
        q, k, v, do, seg = flash_case(B, S, H, D, padded, dtype, *kv)
        label = f"{label} {str(dtype).split('.')[-1]}"
        scale = 1.0 / math.sqrt(D)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fk.flash_attention_cuda(*leaves, segment_ids=seg, causal=True, sm_scale=scale)
        out.backward(do)
        ref = flash_attention_reference(*ref_leaves, segment_ids=seg, causal=True,
                                        sm_scale=scale)
        ref.backward(do)
        torch.cuda.synchronize()
        out, ref = out.detach(), ref.detach()
        real = torch.ones((B, S), dtype=torch.bool, device="cuda") if seg is None else seg == 2
        fwd_err = float((out.float() - ref.float())[real].abs().max())
        fwd_rel = tile_rel_err(out, ref, real)
        if not math.isfinite(fwd_rel) or fwd_rel > FLASH_FWD_TILE_REL:
            raise SystemExit(f"flash {label}: forward relative error of a query tile "
                             f"{fwd_rel} > {FLASH_FWD_TILE_REL}")
        bwd_err = {}
        for name, a, b in zip("qkv", leaves, ref_leaves):
            rel = float((a.grad.float() - b.grad.float()).norm() / b.grad.float().norm())
            if not math.isfinite(rel) or rel > FLASH_BWD_REL:
                raise SystemExit(f"flash {label}: d{name} relative error {rel} > {FLASH_BWD_REL}")
            bwd_err[f"d{name}"] = rel
        # Work this run's data needs: kept (query, key) pairs.
        keep = torch.tril(torch.ones((S, S), dtype=torch.bool, device="cuda"))
        if seg is None:
            pairs = H * B * int(keep.sum())
        else:
            same = seg[:, :, None] == seg[:, None, :]
            pairs = H * int((same & keep).sum())
        el = 2  # bf16 bytes
        fwd_flops, bwd_flops = 4 * D * pairs, 10 * D * pairs
        fwd_bytes = 4 * B * S * H * D * el + B * H * S * 4          # q,k,v in; o, lse out
        bwd_bytes = 8 * B * S * H * D * el + 2 * B * H * S * 4      # q,k,v,o,dO in; dq,dk,dv out
        mask = None
        if seg is not None:
            mask = (same & keep)[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library_fwd():
            if mask is None:
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        with torch.no_grad():
            t_fwd = cuda_ms(lambda: fk.flash_attention_cuda(q, k, v, segment_ids=seg,
                                                            causal=True, sm_scale=scale), 20)
            t_plain_fwd = cuda_ms(lambda: flash_attention_reference(
                q, k, v, segment_ids=seg, causal=True, sm_scale=scale), 5)
            t_lib_fwd = cuda_ms(library_fwd, 20)
        o, lse = fk._forward(q, k, v, seg, True, scale)
        t_bwd = cuda_ms(lambda: fk._backward(q, k, v, seg, o, lse, do, True, scale), 20)
        ref_out = flash_attention_reference(*ref_leaves, segment_ids=seg, causal=True,
                                            sm_scale=scale)
        t_plain_bwd = cuda_ms(lambda: torch.autograd.grad(ref_out, ref_leaves, do,
                                                          retain_graph=True), 5)
        lib_leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
        qt, kt, vt = lib_leaves
        lib_out = library_fwd()
        t_lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do.transpose(1, 2),
                                                        retain_graph=True), 20)
        fb, fby = bound_row(fwd_flops, fwd_bytes)
        bb, bby = bound_row(bwd_flops, bwd_bytes)
        log(f"op flash {label} (B{B} S{S} H{H} D{D}): fwd rel per query tile {fwd_rel:.3e} "
            f"(pin {FLASH_FWD_TILE_REL}; max|err| {fwd_err:.3e}), bwd rel "
            f"{', '.join(f'{n} {e:.3e}' for n, e in bwd_err.items())} (pin {FLASH_BWD_REL}); "
            f"fwd kernel {t_fwd:.4f} ms, plain {t_plain_fwd:.4f}, library {t_lib_fwd:.4f}, "
            f"bound {fb:.4f} ({fby}, {fwd_flops / 1e9:.1f} GFLOP); "
            f"{speed_note(fwd_flops, t_fwd, t_lib_fwd, fb)}; bwd kernel {t_bwd:.4f} ms, plain "
            f"{t_plain_bwd:.4f}, library {t_lib_bwd:.4f}, bound {bb:.4f} ({bby}); "
            f"{speed_note(bwd_flops, t_bwd, t_lib_bwd, bb)}")
        if not rows:  # the training shape: the rows of the kernel table
            base = {"route": "cuda", "source": "accelerate_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "accelerate_tpu/ops/attention.py:144", "launches": 0}
            rows = [dict(base, name=fwd_name, max_abs_err=fwd_err, ms=t_fwd,
                         plain_ms=t_plain_fwd, bound_ms=fb, bound_by=fby, library_ms=t_lib_fwd),
                    dict(base, name=bwd_name,
                         max_abs_err=float(max((a.grad.float() - b.grad.float()).abs().max()
                                               for a, b in zip(leaves, ref_leaves))),
                         ms=t_bwd, plain_ms=t_plain_bwd, bound_ms=bb, bound_by=bby,
                         library_ms=t_lib_bwd)]
        del q, k, v, do, leaves, ref_leaves, out, ref, o, lse, ref_out, lib_out, lib_leaves
        free_cuda()
    return rows


def update_op_phase(cfg):
    """Fused update kernel vs its plain version, bitwise, every family;
    returns one row per family at the largest leaf."""
    import torch

    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.ops.fused_update import leaf_update, plan_fused_update
    from accelerate_tpu_torch.ops.kernels.fused_update import fused_update_cuda

    big = cfg.vocab_size * cfg.hidden_size  # embed and lm_head, the largest leaves
    families = {"adamw": optim.adamw(3e-4), "adam": optim.adam(3e-4), "sgd": optim.sgd(3e-4),
                "sgd_momentum": optim.sgd(3e-4, momentum=0.9)}
    streams = {"adam": 8, "sgd_momentum": 6, "sgd": 4}  # f32 reads + writes per element
    ops_per_elem = {"adam": 16, "sgd_momentum": 5, "sgd": 4}
    factor = torch.tensor(0.7, device="cuda")
    bc1, bc2 = torch.tensor(0.271, device="cuda"), torch.tensor(0.002997, device="cuda")
    rows = []
    for name, tx in families.items():
        plan = plan_fused_update(tx)
        n_mom = {"adam": 2, "sgd_momentum": 1, "sgd": 0}[plan.kind]
        for n in (big, 1, 0):
            g = torch.Generator(device="cuda").manual_seed(SEED)
            p = torch.randn(n, generator=g, device="cuda")
            grad = torch.randn(n, generator=g, device="cuda")
            moments = tuple(torch.rand(n, generator=g, device="cuda") for _ in range(n_mom))
            p2, grad2, moments2 = p.clone(), grad.clone(), tuple(m.clone() for m in moments)
            fused_update_cuda(p, grad, moments, factor, bc1, bc2, plan=plan)
            leaf_update(p2, grad2, moments2, factor, bc1, bc2, plan=plan)
            torch.cuda.synchronize()
            same = torch.equal(p.view(torch.int32), p2.view(torch.int32)) and all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(moments, moments2))
            zeroed = bool((grad == 0).all()) and bool((grad2 == 0).all())
            if not (same and zeroed):
                raise SystemExit(f"fused_{plan.describe()}_update n={n}: kernel disagrees "
                                 f"with the plain version (bitwise={same}, zeroed={zeroed})")
            if n != big:
                continue
            err = float((p - p2).abs().max())
            t_kernel = cuda_ms(lambda: fused_update_cuda(p, grad, moments, factor, bc1, bc2,
                                                         plan=plan), 20)
            t_plain = cuda_ms(lambda: leaf_update(p2, grad2, moments2, factor, bc1, bc2,
                                                  plan=plan), 5)
            del p2, grad2, moments2
            leaf = torch.nn.Parameter(p)
            leaf.grad = grad
            if plan.kind == "adam":
                lib = torch.optim.AdamW([leaf], lr=3e-4, weight_decay=plan.weight_decay or 0.0,
                                        fused=True)
            else:
                lib = torch.optim.SGD([leaf], lr=3e-4, momentum=plan.momentum, fused=True)
            t_lib = cuda_ms(lib.step, 20)
            bound, by = bound_row(0, streams[plan.kind] * 4 * n)
            t_ops = ops_per_elem[plan.kind] * n / FP32_OPS_PER_S * 1e3
            if t_ops > bound:
                bound, by = t_ops, "operations"
            rows.append({"name": f"fused_{plan.describe()}_update", "route": "cuda",
                         "source": "accelerate_tpu_torch/csrc/fused_update.cu",
                         "replaces": "accelerate_tpu/ops/pallas/fused_update.py:200",
                         "launches": 0, "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
                         "bound_ms": bound, "bound_by": by, "library_ms": t_lib})
            log(f"op fused_{plan.describe()}_update: {n} f32 elements, bitwise equal (also at "
                f"1 and 0 elements), buffer zeroed; kernel {t_kernel:.4f} ms, plain "
                f"{t_plain:.4f} ms, library {t_lib:.4f} ms (torch.optim "
                f"{type(lib).__name__}(fused=True), another op order), bound {bound:.4f} ms "
                f"({by}, {streams[plan.kind] * 4 * n / 1e9:.2f} GB, "
                f"{streams[plan.kind] * 4 * n / t_kernel / 1e9:.2f} TB/s)")
            del leaf, lib
        del p, grad, moments
        free_cuda()
    return rows


def train_arm(cfg, steps: int, kernels=None, accum: int = 1, warmup: int = 0,
              per_step_counts: bool = False, shape=(TRAIN_BATCH, TRAIN_SEQ)):
    """Build the training step on a fresh model from the seed and run it;
    returns (loss values, wall seconds of the steps after warm-up, launch
    counts of all steps, per-step counts, peak bytes)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, Llama, adamw
    from accelerate_tpu_torch.ops import registry

    torch.cuda.reset_peak_memory_stats()
    model = Llama(cfg)
    model.init_params(SEED)
    acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=accum, kernels=kernels)
    pm, po = acc.prepare(model, adamw(3e-4))
    step = acc.build_train_step(pm, po)
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    registry.reset_launch_counts()
    losses, per_step = [], []
    for _ in range(warmup):
        losses.append(step(batch, clip_norm=1.0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - warmup):
        losses.append(step(batch, clip_norm=1.0))
        if per_step_counts:
            per_step.append(dict(registry.launch_counts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(registry.launch_counts)
    values = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    del model, acc, pm, po, step, losses
    free_cuda()
    return values, wall, counts, per_step, peak


def train_phase(card):
    """Phase 7; returns the kernel arm's launch counts."""
    from accelerate_tpu_torch import Llama, LlamaConfig

    cfg = LlamaConfig.llama3_8b(**TRAIN_CUT)
    probe = Llama(cfg, device="cpu")
    n_params, fpt = probe.num_params(), probe.flops_per_token()
    layers, tokens = cfg.num_hidden_layers, TRAIN_BATCH * TRAIN_SEQ
    losses, wall, counts, _, peak = train_arm(cfg, steps=7, warmup=2)
    want = {"flash_attention_fwd": 7 * layers, "flash_attention_bwd": 7 * layers,
            "fused_adamw_update": 7 * 12}
    if counts != want:
        raise SystemExit(f"train: launch counts {counts}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"train: losses not finite and falling: {losses}")
    step_s = wall / 5
    mfu = fpt * tokens / step_s / BF16_OPS_PER_S
    log(f"train: Llama-3-8B widths, {layers} layers, {n_params / 1e9:.3f}B params, bf16 "
        f"compute on f32 masters, adamw(3e-4), clip 1.0, batch {TRAIN_BATCH}x{TRAIN_SEQ}; "
        f"losses {[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} ms, "
        f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s "
        f"({fpt:.4g} FLOP/token); launches over 7 steps {counts}; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    off, _, off_counts, _, off_peak = train_arm(cfg, steps=3, kernels="off")
    diff = max(abs(a - b) for a, b in zip(off, losses[:3]))
    if off_counts or diff > TRAIN_LOSS_ATOL:
        raise SystemExit(f"train kernels='off': losses {off} vs {losses[:3]} (max |diff| "
                         f"{diff}, pin {TRAIN_LOSS_ATOL}), launches {off_counts}")
    log(f"train kernels='off': losses {[round(x, 4) for x in off]}, max |diff| {diff:.3e} "
        f"vs the kernel arm (pin {TRAIN_LOSS_ATOL}); no launches; peak memory "
        f"{off_peak / 2**30:.2f} GiB")
    acc_losses, _, _, per_step, acc_peak = train_arm(cfg, steps=4, accum=2,
                                                     per_step_counts=True)
    updates = [c.get("fused_adamw_update", 0) for c in per_step]
    if updates != [0, 12, 12, 24] or not all(math.isfinite(x) for x in acc_losses):
        raise SystemExit(f"train accumulation 2: update launches after each micro-step "
                         f"{updates}, expected [0, 12, 12, 24]; losses {acc_losses}")
    log(f"train accumulation 2: 4 micro-steps, update launches after each {updates}, "
        f"losses {[round(x, 4) for x in acc_losses]}; peak memory {acc_peak / 2**30:.2f} GiB")
    return counts


def log_profile(prof, wall: float, label: str) -> None:
    """Device time of a profiled step by kernel family and by kernel, and
    the busy share of its wall time."""
    import torch

    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(device_us(e) for e in events) / 1e3
    log(f"profile {label} step: wall {wall * 1e3:.1f} ms, device busy {total:.1f} ms "
        f"({100 * total / (wall * 1e3):.1f}%), {sum(e.count for e in events)} kernel launches")

    def group(key):
        if "splash_" in key:
            return "splash attention (csrc/splash_attention.cu)"
        if "flash_" in key:
            return "flash attention (csrc/flash_attention.cu)"
        if "fused_update" in key:
            return "fused update (csrc/fused_update.cu)"
        if "nvjet" in key or "gemm" in key.lower() or "splitKreduce" in key:
            return "cuBLAS GEMMs"
        return "other PyTorch kernels"

    groups = {}
    for e in events:
        ms, n = groups.get(group(e.key), (0.0, 0))
        groups[group(e.key)] = (ms + device_us(e) / 1e3, n + e.count)
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"profile {label}: {ms:9.2f} ms ({100 * ms / total:5.1f}%) {n:5d}x  {name}")
    for e in sorted(events, key=lambda e: -device_us(e))[:20]:
        log(f"profile {label}:   {device_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")


def profile_train_step(cfg, shape, label: str):
    """torch.profiler over one training step: device time by kernel, busy
    share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import Accelerator, Llama, adamw

    model = Llama(cfg)
    model.init_params(SEED)
    acc = Accelerator(mixed_precision="bf16")
    pm, po = acc.prepare(model, adamw(3e-4))
    step = acc.build_train_step(pm, po)
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    step(batch, clip_norm=1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, clip_norm=1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    log_profile(prof, wall, label)
    del model, acc, pm, po, step
    free_cuda()


def gemma2_config(layers: int):
    """The published Gemma-2-9B config through the port's converter, cut to
    ``layers`` (layer 0 local, then alternating), with the fused loss."""
    import dataclasses

    from accelerate_tpu_torch import gemma2_config_from_hf

    cfg = gemma2_config_from_hf(dict(GEMMA2_9B, num_hidden_layers=layers))
    return dataclasses.replace(cfg, fused_loss=True)


_FLEX = None


def library_attention(q, k, v, seg, window, softcap):
    """One PyTorch call computing the splash function on (B, S, H, D)
    inputs (q pre-scaled): compiled ``flex_attention`` with a block mask
    (causal, the window, segment ids) and a softcap ``score_mod``. Returns
    (call, leaves): ``call()`` runs it on the leaves, (B, H, S, D) views
    that require grad. A yardstick only, never used by the port."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    global _FLEX
    if _FLEX is None:
        # The backward is timed on one retained graph: compiled backwards
        # donate their buffers unless told not to.
        torch._functorch.config.donated_buffer = False
        _FLEX = torch.compile(flex_attention, dynamic=False)
    B, S = q.shape[:2]
    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        if window:
            keep = keep & (qi - ki < window)
        if seg is not None:
            keep = keep & (seg[b, qi] == seg[b, ki])
        return keep

    def score_mod(score, b, h, qi, ki):
        return torch.tanh(score / softcap) * softcap

    block_mask = create_block_mask(mask_mod, B if seg is not None else None, None, S, S,
                                   device="cuda")
    return (lambda: _FLEX(*leaves, score_mod=score_mod if softcap else None,
                          block_mask=block_mask, scale=1.0)), leaves


def splash_case(B, S, H, Hkv, D, scale, padded: bool, q_std: float = 1.0):
    """Inputs of one splash case, made on the card from the seed: q of
    standard deviation ``q_std`` scaled in bf16 as the wrapper scales it
    (the logits' standard deviation is ``q_std * scale * sqrt(D)``), GQA
    heads repeated as the wrapper repeats them, right padding on the last
    quarter of row 0."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16) * q_std
    q = (q * torch.tensor(scale, dtype=torch.bfloat16).item()).to(torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda", dtype=torch.bfloat16)
            .repeat_interleave(H // Hkv, dim=2).contiguous() for _ in range(2))
    do = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    seg = None
    if padded:
        seg = torch.full((B, S), 2, dtype=torch.int32, device="cuda")
        seg[0, -S // 4:] = 1
    return q, k, v, do, seg


def plain_without_cap_derivative(q, k, v, **kw):
    """The splash plain version with the softcap's derivative left out of
    its backward (``tanh`` passes its cotangent through unchanged; the
    forward is the same): the gradients of a backward that dropped the
    factor ``1 - tanh^2``. A control only, never used by the port."""
    import torch
    from torch.overrides import TorchFunctionMode

    from accelerate_tpu_torch.ops.attention import splash_attention_reference

    class TanhWithoutDerivative(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.tanh:
                x = args[0]
                return x + (torch.tanh(x) - x).detach()
            return func(*args, **(kwargs or {}))

    with TanhWithoutDerivative():
        return splash_attention_reference(q, k, v, **kw)


def splash_grad_rel(leaves, ref_leaves) -> dict:
    """``||grad - ref grad||_F / ||ref grad||_F`` for q, k and v."""
    return {f"d{n}": float((a.grad.float() - b.grad.float()).norm() / b.grad.float().norm())
            for n, a, b in zip("qkv", leaves, ref_leaves)}


def softcap_controls(q, k, v, do, out_ref, ref_leaves, kw, real, label):
    """On a case whose logits reach the cap: the kernel run without the
    softcap, and the plain version without the cap's derivative, must each
    miss the capped plain version by more than the pins. The phase fails
    if they do not (its inputs could then not tell a kernel that drops the
    cap, or its backward factor, from a right one)."""
    from accelerate_tpu_torch.ops.kernels import splash_attention as sk

    uncapped = dict(kw, softcap=None)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sk.splash_attention_cuda(*leaves, **uncapped)
    out.backward(do)
    fwd_rel, bwd_rel = tile_rel_err(out.detach(), out_ref, real), splash_grad_rel(leaves, ref_leaves)
    st_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_without_cap_derivative(*st_leaves, **kw).backward(do)
    st_rel = splash_grad_rel(st_leaves, ref_leaves)
    log(f"op splash {label}: controls against the capped plain version: the kernel "
        f"without the softcap, fwd rel per query tile {fwd_rel:.3e}, bwd rel "
        f"{', '.join(f'{n} {e:.3e}' for n, e in bwd_rel.items())}; the plain version "
        f"without the cap's derivative, bwd rel "
        f"{', '.join(f'{n} {e:.3e}' for n, e in st_rel.items())} (each must exceed its pin, "
        f"{FLASH_FWD_TILE_REL} and {FLASH_BWD_REL}; dv does not see the derivative)")
    if (not fwd_rel > FLASH_FWD_TILE_REL
            or not all(bwd_rel[g] > FLASH_BWD_REL and st_rel[g] > FLASH_BWD_REL
                       for g in ("dq", "dk"))):
        raise SystemExit(f"splash {label}: the inputs do not reach the softcap: a kernel "
                         f"without it would pass the pins")


def visible_pairs(S, window, seg, B) -> int:
    """(query, key) pairs the mask keeps, summed over the batch: the work
    this run's data needs."""
    import torch

    i = torch.arange(S, device="cuda")
    d = i[:, None] - i[None, :]
    keep = d >= 0
    if window:
        keep = keep & (d < window)
    if seg is None:
        return B * int(keep.sum())
    return int((keep[None] & (seg[:, :, None] == seg[:, None, :])).sum())


def splash_op_phase():
    """Splash kernel vs its plain version; returns the fwd and bwd rows at
    Gemma-2-9B's local layer (the first case)."""
    import torch

    from accelerate_tpu_torch.ops.attention import splash_attention_reference
    from accelerate_tpu_torch.ops.kernels import splash_attention as sk

    gemma = GEMMA2_ATTENTION
    cases = [("gemma2-9b local", dict(gemma, window=4096, padded=False)),
             ("gemma2-9b global", dict(gemma, window=None, padded=False)),
             ("gemma2-9b local padded", dict(gemma, window=4096, padded=True)),
             ("mistral-7b", dict(B=1, S=8192, H=32, Hkv=8, D=128, scale=128 ** -0.5,
                                 softcap=None, window=4096, padded=False)),
             ("crossover S1024", dict(gemma, S=1024, window=4096, padded=False)),
             # An odd multiple of 64: the last 128-row query tile is half
             # past the end; a window that cuts tiles, and padding.
             ("ragged S1088", dict(gemma, S=1088, window=300, padded=True, timed=False)),
             # Logits of standard deviation 16 against Gemma-2's cap of 50:
             # with unit logits the cap moves them by about l^3 / (3 cap^2),
             # below the pins, so only this case sees the softcap.
             ("gemma2-9b local, logits at the cap", dict(gemma, window=4096, padded=True,
                                                          q_std=16.0, controls=True,
                                                          timed=False))]
    rows = []
    for label, c in cases:
        B, S, H, D, window, softcap = c["B"], c["S"], c["H"], c["D"], c["window"], c["softcap"]
        q, k, v, do, seg = splash_case(B, S, H, c["Hkv"], D, c["scale"], c["padded"],
                                       c.get("q_std", 1.0))
        kw = dict(segment_ids=seg, window=window, softcap=softcap)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = sk.splash_attention_cuda(*leaves, **kw)
        out.backward(do)
        ref = splash_attention_reference(*ref_leaves, **kw)
        ref.backward(do)
        torch.cuda.synchronize()
        out, ref = out.detach(), ref.detach()
        real = torch.ones((B, S), dtype=torch.bool, device="cuda") if seg is None else seg == 2
        fwd_err = float((out.float() - ref.float())[real].abs().max())
        fwd_rel = tile_rel_err(out, ref, real)
        if not math.isfinite(fwd_rel) or fwd_rel > FLASH_FWD_TILE_REL:
            raise SystemExit(f"splash {label}: forward relative error of a query tile "
                             f"{fwd_rel} > {FLASH_FWD_TILE_REL}")
        bwd_rel = splash_grad_rel(leaves, ref_leaves)
        for name, rel in bwd_rel.items():
            if not math.isfinite(rel) or rel > FLASH_BWD_REL:
                raise SystemExit(f"splash {label}: {name} relative error {rel} > {FLASH_BWD_REL}")
        bwd_err = float(max((a.grad.float() - b.grad.float()).abs().max()
                            for a, b in zip(leaves, ref_leaves)))
        if not c.get("timed", True):  # checked, not timed
            log(f"op splash {label} (B{B} S{S} H{H} D{D}, window {window}, softcap {softcap}, "
                f"{'padded' if seg is not None else 'unpadded'}, logit std "
                f"{c.get('q_std', 1.0) * c['scale'] * math.sqrt(D):g}): fwd rel per query tile "
                f"{fwd_rel:.3e} (pin {FLASH_FWD_TILE_REL}; max|err| {fwd_err:.3e}), bwd rel "
                f"{', '.join(f'{n} {e:.3e}' for n, e in bwd_rel.items())} (pin {FLASH_BWD_REL})")
            del leaves
            free_cuda()
            if c.get("controls"):
                softcap_controls(q, k, v, do, ref, ref_leaves, kw, real, label)
            del q, k, v, do, seg, out, ref, ref_leaves
            free_cuda()
            continue
        del leaves, ref_leaves, ref
        free_cuda()

        pairs = H * visible_pairs(S, window, seg, B)
        fwd_flops, bwd_flops = 4 * D * pairs, 10 * D * pairs
        el = 2  # bf16 bytes
        fwd_bytes = 4 * B * S * H * D * el + B * H * S * 4          # q,k,v in; o, lse out
        bwd_bytes = 8 * B * S * H * D * el + 2 * B * H * S * 4      # q,k,v,o,dO in; dq,dk,dv out
        win = 0 if window is None else min(window, S)
        cap = 0.0 if softcap is None else softcap
        # Device times from single synchronised calls: torch.profiler lost
        # splash's kernel records in this phase (PERF.md section 7); its
        # record count is logged beside them.

        def fwd_call():
            return sk._forward(q, k, v, seg, win, cap)

        with torch.no_grad():
            t_fwd = cuda_ms(fwd_call, 20)
            dev_fwd = synced_ms(fwd_call)
            prof_fwd = [profile_calls(fwd_call, warmup=w) for w in (False, True)]
            t_plain_fwd = cuda_ms(lambda: splash_attention_reference(q, k, v, **kw), 3)
        o, lse = sk._forward(q, k, v, seg, win, cap)

        def bwd_call():
            return sk._backward(q, k, v, seg, o, lse, do, win, cap)

        t_bwd = cuda_ms(bwd_call, 20)
        dev_bwd = synced_ms(bwd_call)
        prof_bwd = [profile_calls(bwd_call, warmup=w) for w in (False, True)]
        for what, profiles, want in (("forward", prof_fwd, 10), ("backward", prof_bwd, 30)):
            for records, how in zip(profiles, ("without", "with")):
                kernels = [us for _, kind, us in records if kind == "kernel"]
                log(f"op splash {label} {what}: the profiler {how} a warm-up cycle kept "
                    f"{len(kernels)} of {want} kernel records ({sum(kernels) / 1e3 / 10:.4f} ms a "
                    f"call from them)")
        plain_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        plain_out = splash_attention_reference(*plain_leaves, **kw)
        t_plain_bwd = cuda_ms(lambda: torch.autograd.grad(plain_out, plain_leaves, do,
                                                          retain_graph=True), 3)
        del plain_out, plain_leaves
        free_cuda()
        call, lib_leaves = library_attention(q, k, v, seg, window, softcap)
        t_lib_fwd = cuda_ms(call, 10)  # with grad on, as compiled: no second compile
        lib_out = call()
        do_t = do.transpose(1, 2)
        t_lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do_t,
                                                        retain_graph=True), 10)
        fb, fby = bound_row(fwd_flops, fwd_bytes)
        bb, bby = bound_row(bwd_flops, bwd_bytes)
        log(f"op splash {label} (B{B} S{S} H{H} D{D}, window {window}, softcap {softcap}, "
            f"{'padded' if seg is not None else 'unpadded'}): fwd rel per query tile "
            f"{fwd_rel:.3e} (pin {FLASH_FWD_TILE_REL}; max|err| {fwd_err:.3e}), bwd rel "
            f"{', '.join(f'{n} {e:.3e}' for n, e in bwd_rel.items())} (pin {FLASH_BWD_REL}); "
            f"fwd kernel {t_fwd:.4f} ms ({dev_fwd:.4f} ms a single synchronised call), plain "
            f"{t_plain_fwd:.4f}, library {t_lib_fwd:.4f}, bound {fb:.4f} ({fby}, "
            f"{fwd_flops / 1e9:.1f} GFLOP, {pairs / H / 1e6:.2f}M visible pairs a head, "
            f"{fwd_flops / t_fwd / 1e9:.1f} TFLOP/s); bwd kernel {t_bwd:.4f} ms (a single "
            f"synchronised call {dev_bwd:.4f}), plain {t_plain_bwd:.4f}, library {t_lib_bwd:.4f}, bound {bb:.4f} "
            f"({bby}, {bwd_flops / t_bwd / 1e9:.1f} TFLOP/s); library: compiled "
            f"flex_attention, block mask and softcap score_mod")
        if not rows:  # Gemma-2-9B's local layer: the rows of the kernel table
            base = {"route": "cuda", "source": "accelerate_tpu_torch/csrc/splash_attention.cu",
                    "replaces": "accelerate_tpu/ops/attention.py:180", "launches": 0}
            rows = [dict(base, name="splash_attention_fwd", max_abs_err=fwd_err, ms=t_fwd,
                         plain_ms=t_plain_fwd, bound_ms=fb, bound_by=fby, library_ms=t_lib_fwd),
                    dict(base, name="splash_attention_bwd", max_abs_err=bwd_err, ms=t_bwd,
                         plain_ms=t_plain_bwd, bound_ms=bb, bound_by=bby, library_ms=t_lib_bwd)]
        del q, k, v, do, seg, out, o, lse, lib_out, lib_leaves, call, fwd_call, bwd_call
        free_cuda()
    return rows


def splash_times() -> dict:
    """``--splash-times``: the splash kernels' forward and backward times
    (CUDA events, 20 calls) at Gemma-2-9B's local and global layers, from
    phase 8's inputs, and nothing else."""
    import torch

    from accelerate_tpu_torch.ops.kernels import splash_attention as sk

    c = GEMMA2_ATTENTION
    times = {}
    for label, window in (("local", 4096), ("global", 0)):
        q, k, v, do, _ = splash_case(c["B"], c["S"], c["H"], c["Hkv"], c["D"], c["scale"], False)
        with torch.no_grad():
            fwd = cuda_ms(lambda: sk._forward(q, k, v, None, window, c["softcap"]), 20)
        o, lse = sk._forward(q, k, v, None, window, c["softcap"])
        bwd = cuda_ms(lambda: sk._backward(q, k, v, None, o, lse, do, window, c["softcap"]), 20)
        times[label] = {"fwd_ms": fwd, "bwd_ms": bwd}
        # The profiler here, early in a process, against phase 8 (PERF.md section 7).
        with torch.no_grad():
            kept_fwd = profile_calls(lambda: sk._forward(q, k, v, None, window, c["softcap"]),
                                     warmup=False)
        kept_bwd = profile_calls(lambda: sk._backward(q, k, v, None, o, lse, do, window,
                                                      c["softcap"]), warmup=False)
        log(f"splash times {label}: the profiler without a warm-up cycle kept "
            f"{sum(k == 'kernel' for _, k, _ in kept_fwd)} of 10 forward and "
            f"{sum(k == 'kernel' for _, k, _ in kept_bwd)} of 30 backward kernel records")
        log(f"splash times {label} (B{c['B']} S{c['S']} H{c['H']} D{c['D']}, window "
            f"{window or None}, softcap {c['softcap']}): fwd {fwd:.4f} ms, bwd {bwd:.4f} ms")
        del q, k, v, do, o, lse
        free_cuda()
    return times


def gemma2_train_phase(card):
    """Phase 9; returns the kernel arm's launch counts."""
    from accelerate_tpu_torch import Llama

    cfg = gemma2_config(GEMMA2_LAYERS)
    probe = Llama(cfg, device="cpu")
    n_params, fpt = probe.num_params(), probe.flops_per_token()
    layers, shape = cfg.num_hidden_layers, (GEMMA2_BATCH, GEMMA2_SEQ)
    tokens = GEMMA2_BATCH * GEMMA2_SEQ
    losses, wall, counts, _, peak = train_arm(cfg, steps=7, warmup=2, shape=shape)
    want = {"splash_attention_fwd": 7 * layers, "splash_attention_bwd": 7 * layers,
            "fused_adamw_update": 7 * 13}
    if counts != want:
        raise SystemExit(f"gemma2 train: launch counts {counts}, expected {want} (no flash)")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"gemma2 train: losses not finite and falling: {losses}")
    step_s = wall / 5
    mfu = fpt * tokens / step_s / BF16_OPS_PER_S
    log(f"gemma2 train: Gemma-2-9B widths, {layers} layers (windows {cfg.layer_windows}), "
        f"{n_params / 1e9:.3f}B params, bf16 compute on f32 masters, fused loss (chunk "
        f"{cfg.fused_loss_chunk}), adamw(3e-4), clip 1.0, batch {GEMMA2_BATCH}x{GEMMA2_SEQ}; "
        f"losses {[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} ms, "
        f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s "
        f"({fpt:.4g} FLOP/token); launches over 7 steps {counts}; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    pair = gemma2_config(GEMMA2_PAIR_LAYERS)
    kern, _, kern_counts, _, kern_peak = train_arm(pair, steps=3, shape=shape)
    off, _, off_counts, _, off_peak = train_arm(pair, steps=3, kernels="off", shape=shape)
    diff = max(abs(a - b) for a, b in zip(off, kern))
    want = {"splash_attention_fwd": 3 * GEMMA2_PAIR_LAYERS,
            "splash_attention_bwd": 3 * GEMMA2_PAIR_LAYERS, "fused_adamw_update": 3 * 13}
    if kern_counts != want or off_counts or diff > TRAIN_LOSS_ATOL:
        raise SystemExit(f"gemma2 train, {GEMMA2_PAIR_LAYERS} layers: kernel arm {kern} "
                         f"(launches {kern_counts}), kernels='off' arm {off} (launches "
                         f"{off_counts}); max |diff| {diff}, pin {TRAIN_LOSS_ATOL}")
    log(f"gemma2 train, {GEMMA2_PAIR_LAYERS} layers (windows {pair.layer_windows}): kernel arm "
        f"losses {[round(x, 4) for x in kern]}, kernels='off' arm {[round(x, 4) for x in off]}, "
        f"max |diff| {diff:.3e} (pin {TRAIN_LOSS_ATOL}); peak memory {kern_peak / 2**30:.2f} "
        f"GiB and {off_peak / 2**30:.2f} GiB")
    return counts


def ring_case(B: int, S: int, seed: int = SEED):
    """q, k, v (KV heads repeated to the query heads, as the Llama block
    does before the ring) and dO, (B, S, 32, 128) bf16, made on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(heads):
        return torch.randn((B, S, heads, RING_HEAD_DIM), generator=g, device="cuda",
                           dtype=torch.bfloat16)

    q = randn(RING_HEADS)
    k, v = (randn(RING_KV_HEADS).repeat_interleave(RING_HEADS // RING_KV_HEADS, dim=2)
            for _ in range(2))
    return q, k, v, randn(RING_HEADS)


def rel_fro(got, ref) -> float:
    return float((got.float() - ref.float()).norm() / ref.float().norm())


def check_ring_block(label, q, k, v, do, mask, mode):
    """One block kernel, forward and backward, against its plain twin at
    the cell's shard; returns (forward max|err|, backward max|err|)."""
    import torch

    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.ops.kernels import ring_block as rk
    from accelerate_tpu_torch.parallel import ring

    registry.reset_launch_counts()
    o, l, m = rk.ring_block_fwd_cuda(q, k, v, mask, mode)
    torch.cuda.synchronize()
    o_ref, l_ref, m_ref = ring.ring_block_fwd_reference(q, k, v, mask, mode)
    seen = l_ref > 0
    errs = {}
    if bool(((l > 0) != seen).any()) or not bool((m[~seen] == ring.NEG_INF).all()):
        raise SystemExit(f"ring block {label}: rows with no visible key differ from the twin's")
    if mode != ring.SKIP:
        errs["o tile"] = tile_rel_err(o, o_ref, seen[:, 0])
        errs["l"] = float(((l - l_ref).abs() / l_ref.clamp(min=1))[seen].max())
        errs["m"] = float((m - m_ref)[seen].abs().max())
    fwd_err = float((o.float() - o_ref.float()).abs().max())
    lse = ring._lse_to_m(torch.where(seen, m_ref + torch.log(l_ref.clamp(min=1e-30)),
                                     torch.inf))
    delta = (o_ref.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    del o, l, m, o_ref, l_ref, m_ref
    free_cuda()
    got = [torch.zeros(q.shape, device="cuda") for _ in range(3)]
    rk.ring_block_bwd_cuda(q, k, v, mask, mode, lse, do, delta, *got)
    torch.cuda.synchronize()
    want = [torch.zeros(q.shape, device="cuda") for _ in range(3)]
    ring.ring_block_bwd_reference(q, k, v, mask, mode, lse, do, delta, *want)
    counts = dict(registry.launch_counts)
    expect = {} if mode == ring.SKIP else {"ring_block_fwd": 1, "ring_block_bwd": 1}
    if counts != expect:
        raise SystemExit(f"ring block {label}: launches {counts}, expected {expect}")
    bwd_err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        bwd_err = max(bwd_err, float((a - b).abs().max()))
        errs[name] = 0.0 if float(b.norm()) == 0 and float(a.norm()) == 0 else rel_fro(a, b)
    for name, err in errs.items():
        pin = (FLASH_FWD_TILE_REL if name == "o tile" else
               RING_STATS_ATOL if name in ("l", "m") else FLASH_BWD_REL)
        if not math.isfinite(err) or err > pin:
            raise SystemExit(f"ring block {label}: {name} error {err} > {pin}")
    log(f"op ring block {label}: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (pins: o per query tile {FLASH_FWD_TILE_REL}, l/m {RING_STATS_ATOL}, "
        f"gradients {FLASH_BWD_REL}); launches {counts}")
    del got, want, lse, delta
    free_cuda()
    return fwd_err, bwd_err


def time_ring_block(q, k, v, do, mode: int):
    """(kernel, twin, sdpa) ms forward and backward on one block."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops.kernels import ring_block as rk
    from accelerate_tpu_torch.parallel import ring

    o, l, m = rk.ring_block_fwd_cuda(q, k, v, None, mode)
    lse = ring._lse_to_m(m + torch.log(l))
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    acc = [torch.zeros(q.shape, device="cuda") for _ in range(3)]
    t = {"fwd": cuda_ms(lambda: rk.ring_block_fwd_cuda(q, k, v, None, mode), 10),
         "bwd": cuda_ms(lambda: rk.ring_block_bwd_cuda(q, k, v, None, mode, lse, do, delta,
                                                       *acc), 10),
         "plain_fwd": cuda_ms(lambda: ring.ring_block_fwd_reference(q, k, v, None, mode), 3, 1),
         "plain_bwd": cuda_ms(lambda: ring.ring_block_bwd_reference(q, k, v, None, mode, lse, do,
                                                                    delta, *acc), 3, 1)}
    del acc, o, l, m
    free_cuda()
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    causal = mode == ring.DIAGONAL
    with torch.no_grad():
        t["library_fwd"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            *leaves, is_causal=causal), 10)
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    t["library_bwd"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                                           retain_graph=True), 10)
    del out, leaves
    free_cuda()
    return t


def ring_shards(x, n=RING_RANKS):
    return list(x.chunk(n, dim=1))


def ring_phase():
    """Phase 10; returns the rows of the two ring-block kernels."""
    import torch

    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.ops.kernels.flash_attention import flash_attention_cuda
    from accelerate_tpu_torch.parallel.ring import LoopbackRing, ring_attention

    n, S, H, D = RING_RANKS, RING_SEQ, RING_HEADS, RING_HEAD_DIM
    s_loc = S // n
    q, k, v, do = ring_case(1, S)
    qs, ks, vs, dos = (ring_shards(x) for x in (q, k, v, do))
    # Each block kernel against its twin: rank 3's queries against its own
    # block (diagonal), rank 1's block (full), rank 1's with right padding,
    # and a skipped block.
    pad = torch.ones((1, s_loc), dtype=torch.int32, device="cuda")
    pad[:, -1000:] = 0
    errs = {}
    torch.cuda.reset_peak_memory_stats()
    for label, kv, mask, mode in (("diagonal", 3, None, 0), ("full", 1, None, 1),
                                  ("full, right-padded KV", 1, pad, 1), ("skipped", 3, None, 2)):
        errs[label] = check_ring_block(f"{label} (s_loc {s_loc}, mode {mode})", qs[3], ks[kv],
                                       vs[kv], dos[3], mask, mode)
    peak_blocks = torch.cuda.max_memory_allocated() / 2**30
    times = {label: time_ring_block(qs[3], ks[kv], vs[kv], dos[3], mode)
             for label, kv, mode in (("full", 1, 1), ("diagonal", 3, 0))}

    # The main path: the whole ring, forward and backward, counted.
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    outs = ring_attention(*(ring_shards(x) for x in leaves), causal=True, group=LoopbackRing(n))
    torch.autograd.backward(outs, dos)
    torch.cuda.synchronize()
    counts = dict(registry.launch_counts)
    peak_ring = torch.cuda.max_memory_allocated() / 2**30
    want = {"ring_block_fwd": n * (n + 1) // 2, "ring_block_bwd": n * (n + 1) // 2}
    if counts != want:
        raise SystemExit(f"ring S{S}: launches {counts}, expected {want}")
    out = torch.cat(outs, 1).detach()
    del outs
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = flash_attention_cuda(*ref_leaves, causal=True)
    ref.backward(do)
    torch.cuda.synchronize()
    real = torch.ones((1, S), dtype=torch.bool, device="cuda")
    ring_errs = {"o tile": tile_rel_err(out, ref.detach(), real)}
    ring_errs.update({f"d{x}": rel_fro(a.grad, b.grad)
                      for x, a, b in zip("qkv", leaves, ref_leaves)})
    for name, err in ring_errs.items():
        pin = FLASH_FWD_TILE_REL if name == "o tile" else FLASH_BWD_REL
        if not math.isfinite(err) or err > pin:
            raise SystemExit(f"ring S{S} vs single-card flash: {name} error {err} > {pin}")
    del ref, ref_leaves, out
    free_cuda()
    t_ring_fwd = cuda_ms(lambda: ring_attention(*(ring_shards(x) for x in (q, k, v)),
                                                causal=True, group=LoopbackRing(n)), 3, 1)
    outs = ring_attention(*(ring_shards(x) for x in leaves), causal=True, group=LoopbackRing(n))
    t_ring_bwd = cuda_ms(lambda: torch.autograd.grad(outs, leaves, dos, retain_graph=True), 3, 1)
    del outs, leaves
    free_cuda()
    t_flash_fwd = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True), 3, 1)
    flash_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_out = flash_attention_cuda(*flash_leaves, causal=True)
    t_flash_bwd = cuda_ms(lambda: torch.autograd.grad(flash_out, flash_leaves, do,
                                                      retain_graph=True), 3, 1)
    del flash_out, flash_leaves, q, k, v, do, qs, ks, vs, dos
    free_cuda()

    # The ring at S=4096 against kernels="off": right padding in row 0 that
    # sits in KV shards 2-3, a left-padded row 1 whose first 1500 queries
    # see no key at all (the -1e30 start, and zero rows out).
    small = RING_SMALL_SEQ
    q, k, v, do = ring_case(2, small, seed=SEED + 1)
    mask = torch.ones((2, small), dtype=torch.int32, device="cuda")
    mask[0, 2500:] = 0
    mask[1, :1500] = 0
    arms = []
    for kernels in (None, "off"):
        arm_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        registry.reset_launch_counts()
        outs = ring_attention(*(ring_shards(x) for x in arm_leaves), causal=True,
                              mask=ring_shards(mask), group=LoopbackRing(n), kernels=kernels)
        torch.autograd.backward(outs, ring_shards(do))
        torch.cuda.synchronize()
        arms.append((torch.cat(outs, 1).detach(), [x.grad for x in arm_leaves],
                     dict(registry.launch_counts)))
    (o_k, g_k, c_k), (o_off, g_off, c_off) = arms
    sees = mask.cumsum(1) > 0
    small_errs = {"o tile": tile_rel_err(o_k, o_off, sees)}
    small_errs.update({f"d{x}": rel_fro(a, b) for x, a, b in zip("qkv", g_k, g_off)})
    if c_k != want or c_off != {}:
        raise SystemExit(f"ring S{small} padded: launches {c_k} / {c_off}")
    if not (bool((o_k[~sees] == 0).all()) and bool((o_off[~sees] == 0).all())):
        raise SystemExit(f"ring S{small} padded: rows that see no key are not 0")
    for name, err in small_errs.items():
        pin = FLASH_FWD_TILE_REL if name == "o tile" else FLASH_BWD_REL
        if not math.isfinite(err) or err > pin:
            raise SystemExit(f"ring S{small} padded vs kernels='off': {name} error {err} > {pin}")
    del arms, o_k, o_off, g_k, g_off, q, k, v, do
    free_cuda()

    # Bounds: a full block is 4 s_loc^2 H D flops forward and 2.5 times that
    # backward (five products, as rows 5b and 6b); the whole causal ring is
    # causal attention at S.
    el = 2
    full_fwd = 4 * s_loc * s_loc * H * D
    block_bytes_fwd = 4 * s_loc * H * D * el + 2 * H * s_loc * 4     # q,k,v in; o, l, m out
    block_bytes_bwd = (4 * s_loc * H * D * el + 2 * H * s_loc * 4    # q,k,v,dO, lse, delta in
                       + 2 * 3 * s_loc * H * D * 4)                  # dq,dk,dv f32 read + written
    fb, fby = bound_row(full_fwd, block_bytes_fwd)
    bb, bby = bound_row(2.5 * full_fwd, block_bytes_bwd)
    db, _ = bound_row(full_fwd * (s_loc + 1) / (2 * s_loc), block_bytes_fwd)
    causal_fwd = 4 * D * H * S * (S + 1) / 2
    rb, _ = bound_row(causal_fwd, 4 * S * H * D * el)
    rbb, _ = bound_row(2.5 * causal_fwd, 8 * S * H * D * el)
    for label, t in times.items():
        part = 1.0 if label == "full" else (s_loc + 1) / (2 * s_loc)  # kept pairs
        f_bound = fb if label == "full" else db
        b_bound = bb * part
        fwd_note = speed_note(full_fwd * part, t["fwd"], t["library_fwd"], f_bound)
        bwd_note = speed_note(2.5 * full_fwd * part, t["bwd"], t["library_bwd"], b_bound)
        log(f"op ring block {label} (B1 s_loc {s_loc} H{H} D{D}): fwd kernel {t['fwd']:.4f} ms, "
            f"plain {t['plain_fwd']:.4f}, sdpa {t['library_fwd']:.4f}, bound {f_bound:.4f}; "
            f"{fwd_note}; bwd kernel {t['bwd']:.4f} ms, plain {t['plain_bwd']:.4f}, sdpa "
            f"{t['library_bwd']:.4f}, bound {b_bound:.4f}; {bwd_note}")
    log(f"ring S{S} over {n} ranks (LoopbackRing): launches {counts}; vs single-card flash "
        + ", ".join(f"{name} {e:.3e}" for name, e in ring_errs.items())
        + f"; S{small} padded vs kernels='off' "
        + ", ".join(f"{name} {e:.3e}" for name, e in small_errs.items())
        + f"; ring fwd {t_ring_fwd:.3f} ms, bwd {t_ring_bwd:.3f} ms (bounds {rb:.3f} / "
        f"{rbb:.3f}); single-card flash fwd {t_flash_fwd:.3f} ms, bwd {t_flash_bwd:.3f} ms; "
        f"peak memory {peak_blocks:.2f} GiB in the block checks, {peak_ring:.2f} GiB in the "
        f"ring's forward and backward")
    full = times["full"]
    base = {"route": "cuda", "source": "accelerate_tpu_torch/csrc/flash_attention.cu"}
    return [dict(base, name="ring_block_fwd", replaces="accelerate_tpu/parallel/ring.py:93",
                 launches=counts["ring_block_fwd"], max_abs_err=errs["full"][0], ms=full["fwd"],
                 plain_ms=full["plain_fwd"], bound_ms=fb, bound_by=fby,
                 library_ms=full["library_fwd"]),
            dict(base, name="ring_block_bwd", replaces="accelerate_tpu/parallel/ring.py:209",
                 launches=counts["ring_block_bwd"], max_abs_err=errs["full"][1], ms=full["bwd"],
                 plain_ms=full["plain_bwd"], bound_ms=bb, bound_by=bby,
                 library_ms=full["library_bwd"])]


def bert_base_config():
    """bert-base-cased's published config through the port's converter,
    dropout off (parity with ``kernels="off"`` needs the same draws)."""
    import dataclasses

    from accelerate_tpu_torch import bert_config_from_hf

    return dataclasses.replace(bert_config_from_hf(BERT_BASE_CASED), hidden_dropout_prob=0.0)


def loop_arm(cfg, inject: bool, steps=None, kernels=None, accum: int = 1, evaluate=False,
             profile=False, acc=None):
    """The canonical loop on a fresh model from the seed; returns a dict of
    the losses, launch counts (all steps, and after each step), the wall
    seconds of steps [LOOP_WARMUP, LOOP_WARMUP + LOOP_TIMED), the peak
    bytes, the learning rates and, with ``evaluate``, the eval's rows and
    accuracy. ``acc``: an ``Accelerator`` made by the caller (phase 19's
    launched child), else ``Accelerator(mixed_precision="bf16")``."""
    import torch

    from accelerate_tpu_torch import (
        Accelerator,
        BertForSequenceClassification,
        adamw,
        inject_hyperparams,
        linear_schedule,
        set_seed,
    )
    from accelerate_tpu_torch.examples.nlp_example import get_dataloaders
    from accelerate_tpu_torch.ops import registry

    torch.cuda.reset_peak_memory_stats()
    if acc is None:
        acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=accum,
                          kernels=kernels)
    set_seed(SEED)
    model = BertForSequenceClassification(cfg)
    model.init_params(SEED)
    train_dl, eval_dl = get_dataloaders(LOOP_BATCH, cfg.vocab_size, train_size=LOOP_TRAIN,
                                        eval_size=LOOP_EVAL, seq_len=LOOP_SEQ,
                                        eval_drop_last=False)
    train_dl, eval_dl = acc.prepare(train_dl, eval_dl)
    schedule = None
    if inject:
        schedule = linear_schedule(LOOP_LR, LOOP_END_LR, len(train_dl) // accum)
        model, opt, sched = acc.prepare(model, inject_hyperparams(adamw)(learning_rate=LOOP_LR),
                                        schedule)
    else:
        (model, opt), sched = acc.prepare(model, adamw(LOOP_LR)), None
    out = {"losses": [], "per_step": [], "wall": None, "schedule": schedule, "opt": opt,
           "sched": sched}
    model.train()
    train_dl.set_epoch(0)
    registry.reset_launch_counts()
    for i, batch in enumerate(train_dl):
        if steps is not None and i == steps:
            break
        if i == LOOP_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        prof = None
        if profile and i == LOOP_WARMUP + LOOP_TIMED:  # after the timed steps
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        with acc.accumulate(model):
            loss = model(**batch)["loss"]
            acc.backward(loss)
            if acc.sync_gradients:
                acc.clip_grad_norm_(model, 1.0)
            opt.step()
            if sched is not None:
                sched.step()
            opt.zero_grad()
        out["losses"].append(loss.detach())
        out["per_step"].append(dict(registry.launch_counts))
        if prof is not None:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
            log_profile(prof, wall, "loop arm B")
        if i == LOOP_WARMUP + LOOP_TIMED - 1:
            torch.cuda.synchronize()
            out["wall"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["counts"] = dict(registry.launch_counts)
    out["losses"] = [float(x) for x in out["losses"]]
    out["lr"] = opt.learning_rate
    out["peak"] = torch.cuda.max_memory_allocated()
    if evaluate:
        model.eval()
        correct = rows = 0
        for batch in eval_dl:
            labels = batch.pop("labels")
            preds, refs = acc.gather_for_metrics((model(**batch)["logits"].argmax(-1), labels))
            correct += int((preds == refs).sum())
            rows += len(refs)
        out["rows"], out["accuracy"] = rows, correct / rows
    acc.end_training()
    del acc, model, opt, sched, train_dl, eval_dl
    free_cuda()
    return out


def loop_phase(card, profile: bool = False) -> dict:
    """Phase 11; returns arm B's launch counts."""
    from accelerate_tpu_torch import BertForSequenceClassification

    cfg = bert_base_config()
    probe = BertForSequenceClassification(cfg, device="cpu")
    n_params, fpt = probe.num_params(), probe.flops_per_token(LOOP_SEQ)
    tokens = LOOP_BATCH * LOOP_SEQ
    n_steps = LOOP_TRAIN // LOOP_BATCH
    shape = (f"bert-base-cased widths ({cfg.num_hidden_layers} layers of {cfg.hidden_size}, "
             f"vocabulary {cfg.vocab_size}, {n_params / 1e6:.1f}M params), bf16 compute on f32 "
             f"masters, batch {LOOP_BATCH}x{LOOP_SEQ}, clip 1.0")

    def speed(run, label):
        step_s = run["wall"] / LOOP_TIMED
        log(f"loop {label}: {1 / step_s:.2f} steps/s, {tokens / step_s:.0f} tokens/s "
            f"(host clock over steps {LOOP_WARMUP}-{LOOP_WARMUP + LOOP_TIMED - 1}, ending in "
            f"synchronize(); {step_s * 1e3:.2f} ms a step, MFU "
            f"{100 * fpt * tokens / step_s / BF16_OPS_PER_S:.2f}% of 989 TFLOP/s at "
            f"{fpt:.4g} FLOP/token); peak memory {run['peak'] / 2**30:.2f} GiB "
            f"[finding, not a limit; {card}]")
        return step_s

    a = loop_arm(cfg, inject=True, evaluate=True)
    want_lr = float(a["schedule"](n_steps))
    if (a["counts"] or len(a["losses"]) != n_steps
            or not all(math.isfinite(x) for x in a["losses"])):
        raise SystemExit(f"loop arm A: {len(a['losses'])} steps (want {n_steps}), launches "
                         f"{a['counts']} (want none: the reference chain), losses finite: "
                         f"{all(math.isfinite(x) for x in a['losses'])}")
    if not (a["lr"] == want_lr == a["sched"].get_last_lr()[0]):
        raise SystemExit(f"loop arm A: learning rate after the last step {a['lr']}, the "
                         f"schedule's {want_lr}, the scheduler's {a['sched'].get_last_lr()}")
    if a["rows"] != LOOP_EVAL:
        raise SystemExit(f"loop arm A: gather_for_metrics gave {a['rows']} rows, the eval set "
                         f"has {LOOP_EVAL}")
    log(f"loop arm A (inject_hyperparams(adamw) + linear_schedule, the reference chain): "
        f"{shape}; {n_steps} steps, losses first {[round(x, 4) for x in a['losses'][:3]]} "
        f"last {[round(x, 4) for x in a['losses'][-3:]]}; no fused update launched; lr after "
        f"the last step {a['lr']:.6g} (the schedule's); eval rows {a['rows']}, accuracy "
        f"{a['accuracy']:.4f} (random init, one epoch at 2e-5; a finding, not a check)")
    speed(a, "arm A")

    b = loop_arm(cfg, inject=False, steps=LOOP_B_STEPS, profile=profile)
    per_step = [c.get("fused_adamw_update", 0) for c in b["per_step"]]
    leaves = BERT_LEAVES
    if (b["counts"] != {"fused_adamw_update": leaves * LOOP_B_STEPS}
            or per_step != [leaves * (i + 1) for i in range(LOOP_B_STEPS)]
            or not all(math.isfinite(x) for x in b["losses"])):
        raise SystemExit(f"loop arm B: launches {b['counts']} (want fused_adamw_update "
                         f"{leaves} a step over {LOOP_B_STEPS} steps), after each step "
                         f"{per_step[:5]}..., losses {b['losses'][:5]}...")
    log(f"loop arm B (constant adamw(2e-5), the fused update from optimizer.step()): "
        f"{LOOP_B_STEPS} steps, fused_adamw_update launched {leaves} times a step "
        f"({b['counts']}); losses first {[round(x, 4) for x in b['losses'][:3]]} last "
        f"{[round(x, 4) for x in b['losses'][-3:]]}")
    speed(b, "arm B")
    off = loop_arm(cfg, inject=False, steps=3, kernels="off")
    diff = max(abs(x - y) for x, y in zip(off["losses"], b["losses"][:3]))
    if off["counts"] or diff > TRAIN_LOSS_ATOL:
        raise SystemExit(f"loop kernels='off': losses {off['losses']} vs {b['losses'][:3]} "
                         f"(max |diff| {diff}, pin {TRAIN_LOSS_ATOL}), launches {off['counts']}")
    log(f"loop kernels='off': losses {[round(x, 6) for x in off['losses']]}, max |diff| "
        f"{diff:.3e} vs arm B (pin {TRAIN_LOSS_ATOL}); no launches")
    acc2 = loop_arm(cfg, inject=False, steps=4, accum=2)
    updates = [c.get("fused_adamw_update", 0) for c in acc2["per_step"]]
    if updates != [0, leaves, leaves, 2 * leaves]:
        raise SystemExit(f"loop accumulation 2: update launches after each micro-step "
                         f"{updates}, expected [0, {leaves}, {leaves}, {2 * leaves}]")
    log(f"loop accumulation 2: 4 micro-steps, update launches after each {updates}")
    return b["counts"]


def ckpt_build(cfg, seed: int, inject: bool, project_config=None) -> dict:
    """Phase 12's objects, built and prepared as the complete example builds
    them: a fresh Accelerator, the model from ``seed``, the loaders, and a
    constant adamw (``inject=False``) or ``inject_hyperparams(adamw)`` with
    the example's linear schedule."""
    from accelerate_tpu_torch import (
        Accelerator,
        BertForSequenceClassification,
        adamw,
        inject_hyperparams,
        linear_schedule,
        set_seed,
    )
    from accelerate_tpu_torch.examples.nlp_example import get_dataloaders

    acc = Accelerator(mixed_precision="bf16", project_config=project_config)
    set_seed(SEED)  # python, numpy and torch: the shuffle draws from torch's stream
    model = BertForSequenceClassification(cfg)
    model.init_params(seed)
    train_dl, eval_dl = get_dataloaders(LOOP_BATCH, cfg.vocab_size, train_size=LOOP_TRAIN,
                                        eval_size=LOOP_EVAL, seq_len=LOOP_SEQ,
                                        eval_drop_last=False)
    train_dl, eval_dl = acc.prepare(train_dl, eval_dl)
    sched = None
    if inject:
        model, opt, sched = acc.prepare(model, inject_hyperparams(adamw)(learning_rate=LOOP_LR),
                                        linear_schedule(LOOP_LR, LOOP_END_LR, len(train_dl)))
    else:
        model, opt = acc.prepare(model, adamw(LOOP_LR))
    model.train()
    train_dl.set_epoch(0)
    return dict(acc=acc, model=model, opt=opt, sched=sched, train_dl=train_dl, eval_dl=eval_dl,
                it=None, losses=[], ids=[], launches=[], lrs=[])


def ckpt_steps(run: dict, n: int) -> None:
    """``n`` steps of the loop, dropout on; records each step's loss, input
    ids, fused-update launches and learning rate."""
    import torch

    from accelerate_tpu_torch.ops import registry

    acc, model, opt, sched = run["acc"], run["model"], run["opt"], run["sched"]
    if run["it"] is None:
        run["it"] = iter(run["train_dl"])
    for _ in range(n):
        batch = next(run["it"])
        before = registry.launch_counts.get("fused_adamw_update", 0)
        with acc.accumulate(model):
            loss = model(**batch)["loss"]
            acc.backward(loss)
            acc.clip_grad_norm_(model, 1.0)
            opt.step()
            if sched is not None:
                sched.step()
            opt.zero_grad()
        run["losses"].append(loss.detach())
        run["ids"].append(batch["input_ids"].clone())
        run["launches"].append(registry.launch_counts.get("fused_adamw_update", 0) - before)
        run["lrs"].append(opt.learning_rate if sched is not None else None)
    torch.cuda.synchronize()


def ckpt_state(run: dict) -> dict:
    """A host copy of the run's parameters and optimizer state, by the
    checkpoint's keys."""
    from accelerate_tpu_torch.utils.tree import flatten_with_paths

    out = {f"model.{k}": v.detach().cpu().clone()
           for k, v in flatten_with_paths(run["model"].params)}
    out.update({f"optimizer.{k}": v.detach().cpu().clone()
                for k, v in flatten_with_paths(run["opt"].opt_state) if hasattr(v, "cpu")})
    return out


def ckpt_diff(got: dict, want: dict) -> list:
    """The keys whose tensors are not bitwise equal (bits, not values)."""
    import torch

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
            t.view(torch.int32) if t.dtype == torch.float32 else t)

    if set(got) != set(want):
        return sorted(set(got) ^ set(want))
    return [k for k in want if got[k].shape != want[k].shape or got[k].dtype != want[k].dtype
            or not torch.equal(bits(got[k]), bits(want[k]))]


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def checkpoint_phase(card: str) -> dict:
    """Phase 12; returns the fused update's launches over its runs."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from accelerate_tpu_torch import BertForSequenceClassification, bert_config_from_hf
    from accelerate_tpu_torch import checkpointing
    from accelerate_tpu_torch.checkpointing import load_model_weights
    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.utils.constants import SAFE_WEIGHTS_INDEX_NAME
    from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration
    from accelerate_tpu_torch.utils.tree import flatten_with_paths

    cfg = bert_config_from_hf(BERT_BASE_CASED)
    if cfg.hidden_dropout_prob != 0.1:
        raise SystemExit(f"checkpoint phase: dropout {cfg.hidden_dropout_prob}, the published "
                         "config's is 0.1")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    leaves, total = 25, {}
    times = {}

    def count(run):
        for k, v in registry.launch_counts.items():
            total[k] = total.get(k, 0) + v
        registry.reset_launch_counts()

    def timed_steps(run, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt_steps(run, n)
        return n / (time.perf_counter() - t0)

    def fail(msg):
        raise SystemExit(f"checkpoint phase: {msg}")

    try:
        # Arm A: uninterrupted.
        registry.reset_launch_counts()
        a = ckpt_build(cfg, SEED, inject=False)
        ckpt_steps(a, CKPT_AT)
        a_sps = timed_steps(a, CKPT_STEPS - CKPT_AT)
        count(a)
        if a["launches"] != [leaves] * CKPT_STEPS:
            fail(f"arm A: fused update launches a step {a['launches']}, want {leaves}")
        a_losses = [float(x) for x in a["losses"]]
        if not all(math.isfinite(x) for x in a_losses):
            fail(f"arm A: losses {a_losses}")
        a_final, a_ids = ckpt_state(a), a["ids"]

        # Arm E: export arm A's model, read it back into a fresh model.
        export = os.path.join(root, "export")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a["acc"].save_model(a["model"], export, max_shard_size=CKPT_SHARD)
        times["export"] = time.perf_counter() - t0
        export_bytes = dir_bytes(export)
        fresh = BertForSequenceClassification(cfg)
        fresh.init_params(SEED + 2)
        t0 = time.perf_counter()
        fresh.params = load_model_weights(export, fresh.params)
        torch.cuda.synchronize()
        times["export_load"] = time.perf_counter() - t0
        with open(os.path.join(export, SAFE_WEIGHTS_INDEX_NAME)) as f:
            index = json.load(f)
        keys = [k for k, _ in flatten_with_paths(a["model"].params)]
        shards = sorted(set(index["weight_map"].values()))
        if sorted(index["weight_map"]) != sorted(keys) or len(keys) != len(set(keys)):
            fail(f"arm E: the index lists {len(index['weight_map'])} tensors, the model has "
                 f"{len(keys)}")
        got = {f"model.{k}": v.cpu() for k, v in flatten_with_paths(fresh.params)}
        bad = ckpt_diff(got, {k: v for k, v in a_final.items() if k.startswith("model.")})
        if bad or len(shards) < 2:
            fail(f"arm E: {len(shards)} shards; tensors not bitwise after the reload: {bad[:5]}")
        log(f"checkpoint arm E: save_model in {len(shards)} shards of <= {CKPT_SHARD} "
            f"({export_bytes} bytes, {len(keys)} tensors, each once in the index), read back "
            f"bitwise")
        shutil.rmtree(export)
        del a, fresh
        free_cuda()

        # Arm B: save at step 20, drop everything, load into fresh objects.
        registry.reset_launch_counts()
        b = ckpt_build(cfg, SEED, inject=False)
        ckpt_steps(b, CKPT_AT)
        count(b)
        at_save = ckpt_state(b)
        b_dir = os.path.join(root, "b")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b["acc"].save_state(b_dir)
        times["save"] = time.perf_counter() - t0
        ckpt_bytes = dir_bytes(b_dir)
        first = dict(losses=b["losses"], ids=b["ids"])
        b["acc"].end_training()
        del b
        free_cuda()
        b = ckpt_build(cfg, SEED + 1, inject=False)
        if not ckpt_diff(ckpt_state(b), at_save):
            fail("arm B: the model from another seed already equals the saved state")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b["acc"].load_state(b_dir)
        torch.cuda.synchronize()
        times["load"] = time.perf_counter() - t0
        bad = ckpt_diff(ckpt_state(b), at_save)
        if bad:
            fail(f"arm B: after load_state not bitwise the state at the save: {bad[:5]}")
        b_sps = timed_steps(b, CKPT_STEPS - CKPT_AT)
        count(b)
        b_losses = [float(x) for x in first["losses"] + b["losses"]]
        if b_losses != a_losses:
            diffs = [i + 1 for i, (x, y) in enumerate(zip(a_losses, b_losses)) if x != y]
            fail(f"arm B: losses differ from arm A's at steps {diffs[:10]}")
        ids = first["ids"] + b["ids"]
        if len(ids) != CKPT_STEPS or not all(torch.equal(x, y) for x, y in zip(ids, a_ids)):
            fail("arm B: the batches of steps 21-40 are not arm A's")
        bad = ckpt_diff(ckpt_state(b), a_final)
        if bad:
            fail(f"arm B: final state not bitwise arm A's: {bad[:5]}")
        if b["launches"] != [leaves] * (CKPT_STEPS - CKPT_AT):
            fail(f"arm B: fused update launches a step after load_state {b['launches']}, "
                 f"want {leaves}")
        checksums = [int((x.long() * torch.arange(1, x.numel() + 1, device=x.device).view(
            x.shape)).sum()) for x in ids[CKPT_AT:CKPT_AT + 3]]
        log(f"checkpoint arm B: saved at step {CKPT_AT} ({ckpt_bytes} bytes), loaded into "
            f"fresh objects (model from seed {SEED + 1}) bitwise; steps {CKPT_AT + 1}-"
            f"{CKPT_STEPS}: losses bitwise arm A's (step {CKPT_AT + 1}: {b_losses[CKPT_AT]:.6f},"
            f" last {b_losses[-1]:.6f}), input_ids arm A's (checksums of steps "
            f"{CKPT_AT + 1}-{CKPT_AT + 3}: {checksums}), final state bitwise; "
            f"fused_adamw_update {leaves} launches in every step after the load")
        b["acc"].end_training()
        shutil.rmtree(b_dir)
        del b
        free_cuda()

        # Arm C: non-blocking save, two in-place steps, then the join.
        registry.reset_launch_counts()
        c = ckpt_build(cfg, SEED, inject=False)
        ckpt_steps(c, CKPT_AT)
        at_save = ckpt_state(c)
        c_dir = os.path.join(root, "c")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c["acc"].save_state(c_dir, blocking=False)
        times["return"] = time.perf_counter() - t0
        writer = checkpointing._PENDING_SAVES[-1]
        ckpt_steps(c, CKPT_AFTER)
        count(c)
        t0 = time.perf_counter()
        c["acc"].finish_pending_saves()
        times["join"] = time.perf_counter() - t0
        times["write"] = writer.seconds
        after = ckpt_state(c)
        c["acc"].end_training()
        del c
        free_cuda()
        c = ckpt_build(cfg, SEED + 1, inject=False)
        c["acc"].load_state(c_dir)
        loaded = ckpt_state(c)
        bad, moved = ckpt_diff(loaded, at_save), ckpt_diff(after, at_save)
        if bad or not moved:
            fail(f"arm C: loaded state differs from step {CKPT_AT}'s at {bad[:5]}; the "
                 f"{CKPT_AFTER} later steps changed {len(moved)} tensors")
        log(f"checkpoint arm C: save_state(blocking=False) returned in {times['return']:.3f} s,"
            f" {CKPT_AFTER} in-place steps ran before the join ({times['join']:.3f} s; the "
            f"background write took {times['write']:.3f} s); the "
            f"loaded state is step {CKPT_AT}'s bitwise, not step "
            f"{CKPT_AT + CKPT_AFTER}'s ({len(moved)} of {len(at_save)} tensors differ)")
        c["acc"].end_training()
        shutil.rmtree(c_dir)
        del c
        free_cuda()

        # Arm D: the example as written, automatic naming and rotation.
        registry.reset_launch_counts()
        project = os.path.join(root, "d")

        def d_config():
            return ProjectConfiguration(project_dir=project, automatic_checkpoint_naming=True,
                                        total_limit=CKPT_LIMIT)

        d = ckpt_build(cfg, SEED, inject=True, project_config=d_config())
        for _ in range(CKPT_D_STEPS // CKPT_EVERY):
            ckpt_steps(d, CKPT_EVERY)
            d["acc"].save_state()
        count(d)
        base = os.path.join(project, "checkpoints")
        folders = sorted(os.listdir(base))
        newest = f"checkpoint_{CKPT_D_STEPS // CKPT_EVERY - 1}"
        want = [f"checkpoint_{i}" for i in range(CKPT_D_STEPS // CKPT_EVERY - CKPT_LIMIT,
                                                  CKPT_D_STEPS // CKPT_EVERY)]
        if folders != want or any(d["launches"]):
            fail(f"arm D: folders {folders}, want {want}; fused update launches "
                 f"{sum(d['launches'])} (want 0: the reference chain)")
        d_losses, d_lrs = [float(x) for x in d["losses"]], d["lrs"]
        d["acc"].end_training()
        del d
        free_cuda()
        shutil.rmtree(os.path.join(base, newest, "optimizer"))  # a crash mid-save
        d = ckpt_build(cfg, SEED + 1, inject=True, project_config=d_config())
        resumed = d["acc"].load_state()
        resumed_at = CKPT_D_STEPS - CKPT_EVERY
        if (os.path.basename(resumed) != want[0] or d["acc"].iteration != len(want)
                or sorted(os.listdir(base)) != want[:1]):
            fail(f"arm D: load_state() took {resumed}, iteration {d['acc'].iteration}, "
                 f"folders left {sorted(os.listdir(base))}")
        lr_loaded = d["opt"].learning_rate
        ckpt_steps(d, CKPT_D_STEPS - resumed_at)
        count(d)
        got = [float(x) for x in d["losses"]]
        if (lr_loaded != d_lrs[resumed_at - 1] or d["lrs"] != d_lrs[resumed_at:]
                or got != d_losses[resumed_at:]):
            fail(f"arm D: after the load lr {lr_loaded} vs {d_lrs[resumed_at - 1]}, then "
                 f"{d['lrs'][:3]} vs {d_lrs[resumed_at:resumed_at + 3]}; losses {got[:3]} vs "
                 f"{d_losses[resumed_at:resumed_at + 3]}")
        d["acc"].save_state()
        if sorted(os.listdir(base)) != want:
            fail(f"arm D: after the next save the folders are {sorted(os.listdir(base))}")
        log(f"checkpoint arm D (inject_hyperparams(adamw) + linear_schedule, automatic naming, "
            f"total_limit {CKPT_LIMIT}): saves every {CKPT_EVERY} of {CKPT_D_STEPS} steps left "
            f"{want}; with {newest}/optimizer deleted, load_state() skipped it and resumed "
            f"{want[0]} (iteration {len(want)}), lr {lr_loaded:.6g} = the run's after step "
            f"{resumed_at}; steps {resumed_at + 1}-{CKPT_D_STEPS} bitwise the run's (losses "
            f"and learning rates); the next save wrote {newest} again")
        d["acc"].end_training()
        del d
        free_cuda()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    gb = 1e9

    def rate(nbytes, key):
        return f"{times[key]:.3f} s ({nbytes / gb / times[key]:.2f} GB/s)"

    log(f"checkpoint phase: bert-base-cased widths, dropout 0.1, batch {LOOP_BATCH}x{LOOP_SEQ}; "
        f"checkpoint {ckpt_bytes} bytes; blocking save {rate(ckpt_bytes, 'save')}, load "
        f"{rate(ckpt_bytes, 'load')}, non-blocking return {times['return']:.3f} s, "
        f"join {times['join']:.3f} s and background write {rate(ckpt_bytes, 'write')}, export {rate(export_bytes, 'export')} and its reload "
        f"{rate(export_bytes, 'export_load')}; steps/s arm A {a_sps:.2f}, arm B after the load "
        f"{b_sps:.2f} (host clock over steps {CKPT_AT + 1}-{CKPT_STEPS}, ending in "
        f"synchronize()) [{card}]")
    return total


def shard_arm(cfg, label: str, *, fsdp: bool = False, zero: bool = False,
              remat: bool = False, keep_params: bool = False, device: str = "cuda"):
    """One arm of phase 13 on a fresh model from the seed: its losses, step
    seconds, launch counts, the sizes of the leaves the update launched on,
    per rank the parameter, moment and buffer bytes (sharded leaves and
    replicated ones apart), peak memory, and (``keep_params``) the final
    parameters on the host."""
    import dataclasses

    import numpy as np
    import torch

    from accelerate_tpu_torch import (Accelerator, FullyShardedDataParallelPlugin, Llama,
                                      LoopbackShards, ParallelismConfig, adamw)
    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.utils.tree import flatten_with_paths, tree_leaves

    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = Llama(dataclasses.replace(cfg, remat=remat and not fsdp), device=device)
    model.init_params(SEED)
    if fsdp:
        acc = Accelerator(mixed_precision="bf16", device=device, loopback=LoopbackShards(
            SHARD_RANKS), fsdp_plugin=FullyShardedDataParallelPlugin(
                fsdp_size=SHARD_RANKS, activation_checkpointing=remat))
    elif zero:
        acc = Accelerator(mixed_precision="bf16", device=device,
                          parallelism_config=ParallelismConfig(dp_size=SHARD_RANKS),
                          loopback=LoopbackShards(SHARD_RANKS))
        acc.zero_sharding = True
    else:
        acc = Accelerator(mixed_precision="bf16", device=device)
    pm, po = acc.prepare(model, adamw(3e-4, device=device))
    step = acc.build_train_step(pm, po)
    if (fsdp or zero) != (pm.handle.sharded is not None) or po.zero_active != zero:
        raise SystemExit(f"shard {label}: sharded={pm.handle.sharded is not None}, "
                         f"zero_active={po.zero_active}")
    update_op = registry._OPS["fused_update"]
    real_kernel, sizes = update_op.kernel, []

    def counted(p, *args, **kwargs):  # the leaf each launch covers
        sizes.append(p.numel())
        return real_kernel(p, *args, **kwargs)

    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                               (SHARD_BATCH, SHARD_SEQ)).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    registry.reset_launch_counts()
    update_op.kernel = counted
    losses, times = [], []
    try:
        for _ in range(SHARD_STEPS):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(batch, clip_norm=1.0)))
            times.append(time.perf_counter() - t0)
    finally:
        update_op.kernel = real_kernel
    counts = dict(registry.launch_counts)
    engine = pm.handle.sharded
    ranks = []
    for j, r in enumerate(engine.ranks if engine is not None else (0,)):
        states = po.rank_states[j] if engine is not None else po.opt_state
        moments = {k: t for k, t in flatten_with_paths(states)
                   if isinstance(t, torch.Tensor) and t.dim() > 0}
        # [bytes of leaves split over the ranks, bytes held whole]
        row = {"params": [0, 0], "moments": [0, 0], "buffer": [0, 0]}
        leaves = (zip(engine.layouts, tree_leaves(engine.param_tree(r)),
                      tree_leaves(engine.accum_tree(r))) if engine is not None else
                  ((None, p, g) for p, g in zip(tree_leaves(pm.params), tree_leaves(po.grads))))
        for layout, p, g in leaves:
            split = layout is not None and bool(layout.splits)
            row["params"][0 if split else 1] += p.numel() * 4
            row["buffer"][0 if split else 1] += g.numel() * 4
        for k, t in moments.items():  # "0.mu.layers.attn.wq"
            layout = None if engine is None else next(
                lay for lay in engine.layouts if lay.path.replace("/", ".") == k.split(".", 2)[2])
            split = layout is not None and (bool(layout.splits) or layout.zero_dim is not None)
            row["moments"][0 if split else 1] += t.numel() * 4
        ranks.append(row)
    params = None
    if keep_params:
        params = [p.detach().cpu().clone() for p in tree_leaves(pm.params)]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model, acc, pm, po, step, engine
    if cuda:
        free_cuda()
    return {"losses": losses, "times": times, "counts": counts, "sizes": sizes, "ranks": ranks,
            "peak": peak, "params": params}


def shard_phase(card: str) -> dict:
    """Phase 13; returns the launch counts of its four arms."""
    import torch

    from accelerate_tpu_torch import Llama, LlamaConfig

    cfg = LlamaConfig.llama3_8b(**TRAIN_CUT)
    probe = Llama(cfg, device="cpu")
    n_params, fpt = probe.num_params(), probe.flops_per_token()
    layers, tokens = cfg.num_hidden_layers, SHARD_BATCH * SHARD_SEQ
    full_sizes = [int(math.prod(t.shape)) for t in _leaf_shapes(probe)]
    arms = {}
    for name, kw in (("A", dict(keep_params=True)), ("B", dict(fsdp=True, remat=True)),
                     ("C", dict(zero=True)), ("D", dict(remat=True, keep_params=True))):
        arms[name] = shard_arm(cfg, name, **kw)
        run = arms[name]
        if not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"shard {name}: losses not finite: {run['losses']}")
        sharded = name in "BC"
        fwd_per_rank = layers * (2 if kw.get("remat") else 1)
        n_ranks = SHARD_RANKS if sharded else 1
        mesh = ({"fsdp": SHARD_RANKS} if name == "B" else {"dp": SHARD_RANKS} if name == "C"
                else {})
        plan = planned_update_slices(probe, mesh, zero=name == "C")
        if sum(n for n, _ in plan) != SHARD_UPDATE_LAUNCHES[name]:
            raise SystemExit(f"shard {name}: the plan's update slices {plan}, expected "
                             f"{SHARD_UPDATE_LAUNCHES[name]} launches a step")
        want = {"flash_attention_fwd": SHARD_STEPS * n_ranks * fwd_per_rank,
                "flash_attention_bwd": SHARD_STEPS * n_ranks * layers,
                "fused_adamw_update": SHARD_STEPS * SHARD_UPDATE_LAUNCHES[name]}
        step_s = sum(run["times"][SHARD_WARMUP:]) / (SHARD_STEPS - SHARD_WARMUP)
        mfu = fpt * tokens / step_s / BF16_OPS_PER_S
        per_rank = "; ".join(
            f"rank {r}: params {row['params'][0] / 1e9:.3f} + {row['params'][1] / 1e6:.3f} MB "
            f"replicated, moments {row['moments'][0] / 1e9:.3f} GB + "
            f"{row['moments'][1] / 1e6:.3f} MB, buffer {row['buffer'][0] / 1e9:.3f} GB + "
            f"{row['buffer'][1] / 1e6:.3f} MB" for r, row in enumerate(run["ranks"]))
        log(f"shard {name} ({kw}): losses {[round(x, 4) for x in run['losses']]}; step "
            f"{step_s * 1e3:.1f} ms, {tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of "
            f"989 TFLOP/s ({fpt:.4g} FLOP/token, recompute not counted); peak memory "
            f"{run['peak'] / 2**30:.2f} GiB; launches {run['counts']}; {per_rank} [{card}]")
        arms[name]["step_s"], arms[name]["mfu"] = step_s, mfu
        if run["counts"] != want:
            raise SystemExit(f"shard {name}: launch counts {run['counts']}, expected {want}")
        # Every update launch covers one distinct slice of the plan, and a leaf
        # the plan splits (B: 9 of 12, the norms replicated; C: all 12) is
        # cut into SHARD_RANKS equal slices that make up the leaf.
        slices = [elements for n, elements in plan for _ in range(n)]
        split = [(n, n * elements, full) for (n, elements), full in zip(plan, full_sizes)
                 if n > 1]
        split_ok = all(n == SHARD_RANKS and got == full for n, got, full in split) and len(
            split) == ((9 if name == "B" else 12) if sharded else 0)
        if sorted(run["sizes"]) != sorted(slices * SHARD_STEPS) or not split_ok or (
                not sharded and sorted(slices) != sorted(full_sizes)):
            raise SystemExit(f"shard {name}: update launch sizes {sorted(set(run['sizes']))}, "
                             f"the plan's slices {sorted(set(slices))}, split leaves {split}")
        log(f"shard {name}: {len(run['sizes'])} update launches, each on a distinct slice: "
            f"{len(split)} leaves split {SHARD_RANKS} ways"
            + (" (the norms replicated, as the plan keeps them)" if name == "B" else ""))
    total = n_params * 4
    want = {"params": total, "moments": 2 * total, "buffer": total}
    for name in "BC":
        # The split parts summed over the ranks plus the parts every rank
        # holds whole, counted once: the unsharded model's bytes.
        ranks = arms[name]["ranks"]
        whole = {k: {r[k][1] for r in ranks} for k in want}
        got = {k: sum(r[k][0] for r in ranks) + min(whole[k]) for k in want}
        if got != want or any(len(v) != 1 for v in whole.values()):
            raise SystemExit(f"shard {name}: split bytes over the ranks plus whole bytes "
                             f"{got} (whole per rank {whole}) != the unsharded {want}")
        log(f"shard {name}: split over the {SHARD_RANKS} ranks + held whole by each = {got} B, "
            f"the unsharded model's ({n_params} parameters)")
    a, d = arms["A"], arms["D"]
    same = a["losses"] == d["losses"] and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a["params"], d["params"]))
    if not same:
        raise SystemExit(f"shard D (remat) is not bitwise arm A: losses {d['losses']} vs "
                         f"{a['losses']}")
    for name in "BC":
        diff = max(abs(x - y) for x, y in zip(arms[name]["losses"][:3], a["losses"][:3]))
        if diff > SHARD_LOSS_ATOL:
            raise SystemExit(f"shard {name}: losses {arms[name]['losses'][:3]} vs arm A's "
                             f"{a['losses'][:3]} (max |diff| {diff}, pin {SHARD_LOSS_ATOL})")
        log(f"shard {name} vs A: first 3 losses max |diff| {diff:.3e} (pin {SHARD_LOSS_ATOL}); "
            f"step {arms[name]['step_s'] / a['step_s']:.2f}x arm A's")
    log(f"shard D vs A: remat bitwise (losses and {len(a['params'])} parameter leaves); step "
        f"{d['step_s'] / a['step_s']:.2f}x arm A's, peak {d['peak'] / 2**30:.2f} vs "
        f"{a['peak'] / 2**30:.2f} GiB")
    counts = {}
    for run in arms.values():
        for k, v in run["counts"].items():
            counts[k] = counts.get(k, 0) + v
    return counts


# ------------------------------------------------------------------ phase 14
def _train_batches(cfg, n: int, seed: int = SEED):
    """``n`` seeded host batches of phase 7's shape (the ids as labels)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids})
    return out


def _count_delta(now: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


def precision_arm(cfg, mixed_precision: str, steps: int, kernels=None, warmup: int = 1,
                  poison=None):
    """``build_train_step`` under ``mixed_precision`` on a fresh model from
    the seed, ``steps`` steps of phase 7's batch with clip 1.0: per-step
    losses, scales and skip flags, per-step and total launch counts, step
    seconds after ``warmup`` steps and peak bytes. At step ``poison`` the
    step's ``loss_fn`` multiplies the loss by +inf (a poisoned batch), so
    its gradients are not finite."""
    import torch

    from accelerate_tpu_torch import Accelerator, Llama, adamw
    from accelerate_tpu_torch.ops import registry

    torch.cuda.reset_peak_memory_stats()
    model = Llama(cfg)
    model.init_params(SEED)
    acc = Accelerator(mixed_precision=mixed_precision, kernels=kernels)
    pm, po = acc.prepare(model, adamw(3e-4))
    now_at = [0]

    def loss_fn(outputs, batch):
        return outputs["loss"] * (math.inf if now_at[0] == poison else 1.0)

    step = acc.build_train_step(pm, po, loss_fn=loss_fn)
    batch = _train_batches(cfg, 1)[0]
    registry.reset_launch_counts()
    losses, scales, skipped, per_step, before, t0 = [], [], [], [], {}, None
    for i in range(steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        now_at[0] = i
        losses.append(step(batch, clip_norm=1.0))
        scales.append(None if po.scaler is None else po.scaler.scale)
        skipped.append(po.step_was_skipped)
        now = dict(registry.launch_counts)
        per_step.append(_count_delta(now, before))
        before = now
    torch.cuda.synchronize()
    out = dict(losses=[float(x) for x in losses], scales=scales, skipped=skipped,
               per_step=per_step, counts=dict(registry.launch_counts),
               step_s=(time.perf_counter() - t0) / (steps - warmup),
               peak=torch.cuda.max_memory_allocated(), skipped_steps=po.skipped_steps)
    del model, acc, pm, po, step, losses
    free_cuda()
    return out


def int8_train_cells() -> dict:
    """The int8 matmul at M = 4096 rows (2 x 2048 tokens: a training step's
    block projections) on the four Llama-3-8B shapes, bitwise against its
    plain version; the 4096 -> 14336 product timed as the kernel (CUDA
    events and the profiler's device time), the bf16 ``x @ w`` (cuBLAS) and
    ``torch._int_mm`` on operands already quantized. Returns row 3c."""
    import torch

    from accelerate_tpu_torch.ops.int8 import int8_matmul_reference, quantize_rowwise
    from accelerate_tpu_torch.ops.kernels.int8_matmul import int8_matmul_cuda, plan

    g = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    M, row = INT8_TRAIN_M, None
    for K, N in INT8_SHAPES:
        pl = plan(M, N, K, 2, sms)
        if pl is None:
            raise SystemExit(f"int8_matmul M={M} K={K} N={N}: plan() finds no partition")
        x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, K), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        w = (torch.randn((K, N), generator=g, device="cuda") / math.sqrt(K)).to(torch.bfloat16)
        got, ref = int8_matmul_cuda(x, w), int8_matmul_reference(x, w)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        if got.dtype != ref.dtype or not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
            raise SystemExit(f"int8_matmul M={M} K={K} N={N}: kernel disagrees with the plain "
                             f"version (max_abs_err={err})")
        log(f"op int8_matmul M={M} K={K} N={N} bf16: bitwise equal; panels of {pl.nt} columns, "
            f"clusters of {pl.cluster} CTAs x {pl.per} k blocks, tiles of {pl.mt} rows "
            f"({-(-M // pl.mt)} a CTA in turn), {pl.ctas} CTAs of {pl.smem} B")
        if (K, N) == (4096, 14336):
            qx, _ = quantize_rowwise(x.reshape(M, K), -1)
            qw, _ = quantize_rowwise(w, 0)
            qb = qw.t().contiguous().t()  # column-major: cuBLASLt's int8 layout
            t_kernel = cuda_ms(lambda: int8_matmul_cuda(x, w), 20)
            t_device = profiled_ms(lambda: int8_matmul_cuda(x, w), kernels=2,
                                   label=f"int8_matmul M={M} K={K} N={N}")
            t_plain = cuda_ms(lambda: int8_matmul_reference(x, w), 3)
            t_lib = cuda_ms(lambda: torch._int_mm(qx, qb), 20)
            t_bf16 = cuda_ms(lambda: x @ w, 20)
            ops = 2 * M * N * K
            moved = 2 * (M * K + K * N + M * N)  # bf16 x and w in, bf16 out
            t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
            bound, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
            log(f"op int8_matmul M={M} K={K} N={N}: kernel {t_kernel:.4f} ms ({t_device:.4f} ms "
                f"of device time, profiler), plain {t_plain:.4f} ms, torch._int_mm on "
                f"pre-quantized operands {t_lib:.4f} ms (the contraction only), bf16 x @ w "
                f"(cuBLAS) {t_bf16:.4f} ms; bound {bound:.4f} ms ({by}: {ops / 1e9:.0f} GOP at "
                f"1979 TOP/s, {moved / 1e6:.0f} MB at 3.35 TB/s is {t_bytes:.4f} ms); "
                f"{ops / t_kernel / 1e9:.1f} TOP/s, {bound / t_kernel:.1%} of the bound")
            row = {"name": "int8_matmul_train", "route": "cuda",
                   "source": "accelerate_tpu_torch/csrc/int8_matmul.cu",
                   "replaces": "accelerate_tpu/ops/pallas/int8_mm.py:36", "launches": 0,
                   "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain, "bound_ms": bound,
                   "bound_by": by, "library_ms": t_lib}
            del qx, qw, qb
        del x, w, got, ref
        free_cuda()
    return row


def window_phase(cfg, card: str) -> dict:
    """Arm C: ``build_train_window(window=4)`` fed by
    ``DeviceBatchPrefetcher(window=4)`` over 2 windows, then 8
    ``build_train_step`` calls on a fresh model over the same batches:
    losses and final parameters bitwise; no blocking input wait after the
    first window. Returns the window arm's launch counts."""
    import torch

    from accelerate_tpu_torch import (Accelerator, DeviceBatchPrefetcher, Llama, adamw,
                                      prepare_data_loader, reset_transfer_stats, transfer_stats)
    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.utils.tree import tree_leaves

    batches = _train_batches(cfg, PREC_WINDOW * PREC_WINDOWS, seed=SEED + 14)

    def fresh():
        model = Llama(cfg)
        model.init_params(SEED)
        acc = Accelerator(mixed_precision="bf16")
        return (acc,) + acc.prepare(model, adamw(3e-4))

    torch.cuda.reset_peak_memory_stats()
    acc, pm, po = fresh()
    window = acc.build_train_window(pm, po, window=PREC_WINDOW)
    feed = DeviceBatchPrefetcher(prepare_data_loader(batches), prefetch=2, window=PREC_WINDOW)
    reset_transfer_stats()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    out = [window(wb, clip_norm=1.0) for wb in feed]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats, counts = transfer_stats(), dict(registry.launch_counts)
    w_losses = torch.cat(out).cpu()
    w_params = [p.detach().cpu() for p in tree_leaves(pm.params)]
    peak = torch.cuda.max_memory_allocated()
    del acc, pm, po, window, feed, out
    free_cuda()
    acc, pm, po = fresh()
    step = acc.build_train_step(pm, po)
    s_losses = torch.stack([step(b, clip_norm=1.0) for b in batches]).cpu()
    same_loss = torch.equal(w_losses.view(torch.int32), s_losses.view(torch.int32))
    same_params = all(torch.equal(p.view(torch.int32), h.to(p.device).view(torch.int32))
                      for p, h in zip(tree_leaves(pm.params), w_params))
    del acc, pm, po, step, w_params
    free_cuda()
    layers, n = cfg.num_hidden_layers, PREC_WINDOW * PREC_WINDOWS
    want = {"flash_attention_fwd": n * layers, "flash_attention_bwd": n * layers,
            "fused_adamw_update": n * 12}
    if not (same_loss and same_params):
        raise SystemExit(f"window: not bitwise {n} build_train_step calls (losses equal "
                         f"{same_loss}, parameters equal {same_params}): {w_losses.tolist()} vs "
                         f"{s_losses.tolist()}")
    if counts != want or stats["h2d_puts"] != PREC_WINDOWS or stats["h2d_blocking"] != 0:
        raise SystemExit(f"window: launches {counts} (expected {want}), transfers {stats} "
                         f"(expected {PREC_WINDOWS} uploads, no blocking wait)")
    tokens = n * TRAIN_BATCH * TRAIN_SEQ
    rounded = [round(x, 4) for x in w_losses.tolist()]
    log(f"window: {PREC_WINDOWS} windows of {PREC_WINDOW} bf16 steps fed by "
        f"DeviceBatchPrefetcher(window={PREC_WINDOW}): losses {rounded} bitwise {n} "
        f"build_train_step calls, final parameters bitwise; "
        f"transfers {stats}; {wall / n * 1e3:.1f} ms a step ({tokens / wall:.0f} tokens/s, the "
        f"first window included); launches {counts}; peak memory {peak / 2**30:.2f} GiB [{card}]")
    return counts


def offload_arm(cfg, offload: bool, batches) -> dict:
    """The imperative loop (forward, ``backward``, ``clip_grad_norm_(1.0)``,
    ``step``, ``zero_grad``) under ``FullyShardedDataParallelPlugin(
    fsdp_size=1, cpu_offload=offload)`` over ``batches``: losses, final
    parameters (on the host), the device bytes allocated between steps, the
    state's host bytes and placement, step seconds after the first step and
    peak bytes."""
    import torch

    from accelerate_tpu_torch import Accelerator, FullyShardedDataParallelPlugin, Llama, adamw
    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.utils.tree import flatten_with_paths, tree_leaves

    torch.cuda.reset_peak_memory_stats()
    model = Llama(cfg)
    model.init_params(SEED)
    acc = Accelerator(mixed_precision="bf16", fsdp_plugin=FullyShardedDataParallelPlugin(
        fsdp_size=1, cpu_offload=offload))
    pm, po = acc.prepare(model, adamw(3e-4))
    registry.reset_launch_counts()
    losses, between, placed, t0 = [], [], [], None
    for i, batch in enumerate(batches):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = pm(**batch)
        acc.backward(out["loss"])
        acc.clip_grad_norm_(pm, 1.0)
        po.step()
        po.zero_grad()
        losses.append(out["loss"].detach())
        state = [t for _, t in flatten_with_paths(po.opt_state) if isinstance(t, torch.Tensor)]
        torch.cuda.synchronize()
        between.append(torch.cuda.memory_allocated())
        placed.append(all(t.device.type == "cpu" and t.is_pinned() for t in state))
    torch.cuda.synchronize()
    run = dict(losses=torch.stack(losses).cpu(), step_s=(time.perf_counter() - t0) /
               (len(batches) - 1), between=between, placed=placed,
               state_bytes=sum(t.numel() * t.element_size() for t in state),
               params=[p.detach().cpu() for p in tree_leaves(pm.params)],
               counts=dict(registry.launch_counts), peak=torch.cuda.max_memory_allocated())
    del model, acc, pm, po, out, state
    free_cuda()
    return run


def offload_phase(cfg, card: str) -> dict:
    """Arm D: the imperative loop with the optimizer state offloaded to
    pinned host memory, bitwise the same loop without offload; between
    steps the state lies in pinned host memory and the device holds none
    of it. Returns the offload arm's launch counts."""
    import torch

    batches = _train_batches(cfg, PREC_OFFLOAD_STEPS, seed=SEED + 15)
    keep = offload_arm(cfg, False, batches)
    off = offload_arm(cfg, True, batches)
    same = torch.equal(keep["losses"].view(torch.int32), off["losses"].view(torch.int32)) and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(keep["params"], off["params"]))
    freed = [a - b for a, b in zip(keep["between"], off["between"])]
    leaves = 12
    want = {"flash_attention_fwd": PREC_OFFLOAD_STEPS * cfg.num_hidden_layers,
            "flash_attention_bwd": PREC_OFFLOAD_STEPS * cfg.num_hidden_layers,
            "fused_adamw_update": PREC_OFFLOAD_STEPS * leaves}
    if not same:
        raise SystemExit(f"offload: not bitwise the loop without offload: losses "
                         f"{off['losses'].tolist()} vs {keep['losses'].tolist()}")
    if not all(off["placed"]) or any(keep["placed"]) or min(freed) < off["state_bytes"]:
        raise SystemExit(f"offload: state in pinned host memory after each step "
                         f"{off['placed']}, device bytes freed {freed} < the state's "
                         f"{off['state_bytes']}")
    if off["counts"] != want or keep["counts"] != want:
        raise SystemExit(f"offload: launches {off['counts']} and {keep['counts']}, expected "
                         f"{want}")
    log(f"offload: {PREC_OFFLOAD_STEPS} imperative bf16 steps, losses "
        f"{[round(x, 4) for x in off['losses'].tolist()]} and {len(off['params'])} parameter "
        f"leaves bitwise the loop without offload; between steps the state "
        f"({off['state_bytes'] / 1e9:.2f} GB) lies in pinned host memory and the device holds "
        f"{min(freed) / 1e9:.2f} GB less; step {off['step_s'] * 1e3:.1f} ms vs "
        f"{keep['step_s'] * 1e3:.1f} ms without offload, peak memory "
        f"{off['peak'] / 2**30:.2f} vs {keep['peak'] / 2**30:.2f} GiB; launches {off['counts']} "
        f"[{card}]")
    return off["counts"]


def precision_phase(card: str):
    """Phase 14; returns its kernel-table rows (3c, 5c, 5d) and the launch
    counts of its arms, rows 5c and 5d counted in arm A, row 3c in arm B."""
    import torch

    from accelerate_tpu_torch import Llama, LlamaConfig

    cfg = LlamaConfig.llama3_8b(**TRAIN_CUT)
    probe = Llama(cfg, device="cpu")
    fpt, layers = probe.flops_per_token(), cfg.num_hidden_layers
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flash_rows = flash_op_phase(torch.float16, FLASH_CASES[:1])  # E: the fp16 cell
    int8_row = int8_train_cells()
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    # A: fp16 with its loss scaler, against kernels="off"; step PREC_FP16_POISON
    # is poisoned, so at least that step must be skipped in both arms.
    a = precision_arm(cfg, "fp16", PREC_FP16_STEPS, poison=PREC_FP16_POISON)
    a_off = precision_arm(cfg, "fp16", PREC_FP16_STEPS, kernels="off", poison=PREC_FP16_POISON)
    applied = [i for i, s in enumerate(a["skipped"]) if not s]
    if a["scales"] != a_off["scales"] or a["skipped"] != a_off["skipped"] or not applied or \
            not a["skipped"][PREC_FP16_POISON]:
        raise SystemExit(f"fp16: scales {a['scales']} / skipped {a['skipped']} vs kernels='off' "
                         f"{a_off['scales']} / {a_off['skipped']} (at least one applied step, "
                         f"step {PREC_FP16_POISON} skipped)")
    diff = max(abs(a["losses"][i] - a_off["losses"][i]) for i in applied)
    finite = all(math.isfinite(a["losses"][i]) for i in applied)
    for i, counts in enumerate(a["per_step"]):
        want = {"flash_attention_fp16_fwd": layers, "flash_attention_fp16_bwd": layers}
        if i in applied:
            want["fused_adamw_update"] = 12
        if counts != want:
            raise SystemExit(f"fp16 step {i}: launches {counts}, expected {want}")
    if diff > TRAIN_LOSS_ATOL or not finite or a_off["counts"]:
        raise SystemExit(f"fp16: losses {a['losses']} vs kernels='off' {a_off['losses']} on "
                         f"applied steps {applied} (max |diff| {diff}, pin {TRAIN_LOSS_ATOL}); "
                         f"kernels='off' launches {a_off['counts']}")
    mfu = fpt * tokens / a["step_s"] / BF16_OPS_PER_S
    log(f"fp16: {PREC_FP16_STEPS} build_train_step steps, scales {a['scales']}, skipped "
        f"{a['skipped']} ({a['skipped_steps']} skipped), both as kernels='off'; losses "
        f"{[round(x, 4) for x in a['losses']]}, max |diff| on applied steps {diff:.3e} (pin "
        f"{TRAIN_LOSS_ATOL}); step {a['step_s'] * 1e3:.1f} ms, {tokens / a['step_s']:.0f} "
        f"tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s; launches {a['counts']}; peak memory "
        f"{a['peak'] / 2**30:.2f} GiB (kernels='off' {a_off['peak'] / 2**30:.2f} GiB) [{card}]")
    add(a["counts"])
    flash_rows[0]["launches"] = a["counts"].get("flash_attention_fp16_fwd", 0)
    flash_rows[1]["launches"] = a["counts"].get("flash_attention_fp16_bwd", 0)

    # B: fp8 as int8 QAT, against kernels="off".
    b = precision_arm(cfg, "fp8", PREC_FP8_STEPS)
    b_off = precision_arm(cfg, "fp8", PREC_FP8_OFF_STEPS, kernels="off")
    per_int8 = [c.get("int8_matmul", 0) for c in b["per_step"]]
    diff = max(abs(x - y) for x, y in zip(b["losses"], b_off["losses"]))
    if per_int8 != [7 * layers] * PREC_FP8_STEPS or b_off["counts"] or diff > TRAIN_LOSS_ATOL \
            or not all(math.isfinite(x) for x in b["losses"]):
        raise SystemExit(f"fp8: int8 launches a step {per_int8} (expected {7 * layers}), losses "
                         f"{b['losses']} vs kernels='off' {b_off['losses']} (max |diff| {diff}, "
                         f"pin {TRAIN_LOSS_ATOL}), kernels='off' launches {b_off['counts']}")
    mfu = fpt * tokens / b["step_s"] / BF16_OPS_PER_S
    log(f"fp8 (int8 QAT): {PREC_FP8_STEPS} steps, int8 launches a step {per_int8}; losses "
        f"{[round(x, 4) for x in b['losses']]}, first {PREC_FP8_OFF_STEPS} within {diff:.3e} of "
        f"kernels='off' (pin {TRAIN_LOSS_ATOL}); step {b['step_s'] * 1e3:.1f} ms, "
        f"{tokens / b['step_s']:.0f} tokens/s, MFU {100 * mfu:.2f}% of the bf16 989 TFLOP/s; "
        f"launches {b['counts']}; peak memory {b['peak'] / 2**30:.2f} GiB [{card}]")
    add(b["counts"])
    int8_row["launches"] = b["counts"].get("int8_matmul", 0)

    add(window_phase(cfg, card))   # C
    add(offload_phase(cfg, card))  # D
    totals.pop("int8_matmul", None)  # row 3c's, not the serving row's
    return [int8_row] + flash_rows, totals


# ------------------------------------------------------------------ phase 15
def _tp_arm(cfg, label: str, accelerator_kw: dict, *, batch, mixed_precision: str = "bf16",
           remat: bool = False, zero: bool = False, poison=None, device: str = "cuda",
           steps: int = None, kernels=None, record_aux: bool = False, reference=None):
    """One arm of phase 15 (and 20, 21) on a fresh model from the seed (the
    config's model, ``_model_class``): ``steps`` (``TP_STEPS``)
    ``build_train_step`` steps of ``batch`` with clip 1.0 on the
    Accelerator of ``accelerator_kw`` (and ``kernels``). Returns the losses,
    step seconds after ``TP_WARMUP``, the launch counts (total and per
    step), the fp16 scales and skips, each rank's bytes (split and whole),
    the distinct shards' bytes summed over the ranks, the peak memory and,
    with ``record_aux``, each step's ``aux_loss``; ``reference(pm)`` runs
    before each step, outside its time, and its values are returned
    (``refs``). At step ``poison`` the ``loss_fn`` multiplies the loss by
    +inf."""
    import dataclasses

    import torch

    from accelerate_tpu_torch import Accelerator, adamw
    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.utils.tree import flatten_with_paths, tree_leaves

    steps = TP_STEPS if steps is None else steps
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = _model_class(cfg)(dataclasses.replace(cfg, remat=remat), device=device)
    model.init_params(SEED)
    acc = Accelerator(mixed_precision=mixed_precision, device=device, kernels=kernels,
                      **accelerator_kw)
    acc.zero_sharding = zero
    pm, po = acc.prepare(model, adamw(3e-4, device=device))
    del model
    now_at, aux = [0], []

    def loss_fn(outputs, batch):
        if record_aux:
            aux.append(outputs["aux_loss"].detach())
        return outputs["loss"] * (math.inf if now_at[0] == poison else 1.0)

    step = acc.build_train_step(pm, po, loss_fn=loss_fn if poison is not None or record_aux
                                else None)
    engine = pm.handle.sharded
    if zero != po.zero_active:
        raise SystemExit(f"tp {label}: zero_active={po.zero_active}, asked {zero}")
    registry.reset_launch_counts()
    losses, times, per_step, scales, skipped, before, refs = [], [], [], [], [], {}, []
    for i in range(steps):
        now_at[0] = i
        if reference is not None:
            refs.append(reference(pm))
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch, clip_norm=1.0)))
        times.append(time.perf_counter() - t0)
        now = dict(registry.launch_counts)
        per_step.append(_count_delta(now, before))
        before = now
        scales.append(None if acc.scaler is None else acc.scaler.scale)
        skipped.append(po.step_was_skipped)
    # Per rank [bytes of leaves split over ranks, bytes held whole]; and the
    # bytes of the distinct tensors all the held ranks hold (each memory
    # region once, by its address: the storage itself, not the engine's
    # bookkeeping, says what is shared).
    ranks, distinct = [], {"params": {}, "moments": {}, "buffer": {}}
    held = engine.ranks if engine is not None else (0,)
    for j, r in enumerate(held):
        row = {"params": [0, 0], "moments": [0, 0], "buffer": [0, 0]}
        states = po.rank_states[j] if engine is not None else po.opt_state
        if engine is None:  # the step's gradient: one tensor a leaf, as the parameters
            layouts = [None] * len(tree_leaves(pm.params))
            trees = {"params": tree_leaves(pm.params)}
            row["buffer"][1] = sum(p.numel() * 4 for p in tree_leaves(pm.params))
        else:
            layouts = engine.layouts
            trees = {"params": tree_leaves(engine.param_tree(r)),
                     "buffer": tree_leaves(engine.accum_tree(r))}
        for kind, leaves in trees.items():
            for layout, t in zip(layouts, leaves):
                row[kind][0 if layout is not None and layout.splits else 1] += t.numel() * 4
                distinct[kind][(t.data_ptr(), t.numel())] = t.numel() * 4
        for k, t in flatten_with_paths(states):
            if not isinstance(t, torch.Tensor) or t.dim() == 0:
                continue
            layout = None if engine is None else next(
                lay for lay in engine.layouts if lay.path.replace("/", ".") == k.split(".", 2)[2])
            split = layout is not None and (bool(layout.splits) or layout.zero_dim is not None)
            row["moments"][0 if split else 1] += t.numel() * 4
            distinct["moments"][(t.data_ptr(), t.numel())] = t.numel() * 4
        ranks.append(row)
    distinct = {kind: sum(regions.values()) for kind, regions in distinct.items()}
    if engine is None:
        distinct["buffer"] = distinct["params"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    step_s = sum(times[TP_WARMUP:]) / (steps - TP_WARMUP)
    out = dict(losses=losses, step_s=step_s, counts=dict(registry.launch_counts),
               per_step=per_step, scales=scales, skipped=skipped, ranks=ranks,
               distinct=distinct, peak=peak, sizes=acc.mesh_sizes,
               aux=[float(a) for a in aux], refs=refs)
    del acc, pm, po, step, engine
    if cuda:
        free_cuda()
    return out


def tp_phase(card: str, device: str = "cuda", cut=None) -> dict:
    """Phase 15; returns the launch counts of its arms (bf16 flash and
    update for rows 4, 5, 5b; fp16 flash for rows 5c, 5d). ``device="cpu"``
    with ``cut`` (LlamaConfig fields over the 8B's) rehearses the phase's
    logic at a small size: the CPU runs no kernel, so no launch is
    checked there."""
    import numpy as np

    from accelerate_tpu_torch import (FullyShardedDataParallelPlugin, Llama, LlamaConfig,
                                      LoopbackShards, ParallelismConfig, SequenceParallelPlugin,
                                      TensorParallelPlugin)

    cuda = device == "cuda"
    if cuda:
        flash_op_phase(cases=[TP_FLASH_CASE])  # a tp rank's flash, under flash's pins
    cfg = LlamaConfig.llama3_8b(**{**TRAIN_CUT, **(cut or {})})
    e_cfg = LlamaConfig.llama3_8b(**{**TRAIN_CUT, **(cut or {}),
                                     "max_position_embeddings": TP_ULYSSES_SEQ})
    probe = Llama(cfg, device="cpu")
    n_params, fpt = probe.num_params(), probe.flops_per_token()
    layers = cfg.num_hidden_layers
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (SHARD_BATCH, SHARD_SEQ)).astype(np.int32)
    e_ids = rng.integers(0, cfg.vocab_size, (1, TP_ULYSSES_SEQ)).astype(np.int32)
    batch, e_batch = {"input_ids": ids, "labels": ids}, {"input_ids": e_ids, "labels": e_ids}

    def loop():
        return {"loopback": LoopbackShards(TP_RANKS)}

    def tp_arm(*args, **kw):
        return _tp_arm(*args, device=device, **kw)

    tp2xfsdp2 = dict(parallelism_config=ParallelismConfig(tp_size=2),
                     fsdp_plugin=FullyShardedDataParallelPlugin(
                         fsdp_size=2, activation_checkpointing=True))
    arms = {
        "A": tp_arm(cfg, "A", {}, batch=batch),
        "B": tp_arm(cfg, "B", dict(tp_plugin=TensorParallelPlugin(TP_RANKS), **loop()),
                    batch=batch),
        "C": tp_arm(cfg, "C", dict(tp2xfsdp2, **loop()), batch=batch),
        "D": tp_arm(cfg, "D", dict(parallelism_config=ParallelismConfig(tp_size=2, dp_size=2),
                                   **loop()), batch=batch, zero=True),
        "E0": tp_arm(e_cfg, "E0", {}, batch=e_batch),
        "E": tp_arm(e_cfg, "E", dict(sp_plugin=SequenceParallelPlugin(
            TP_RANKS, ring_attention=False), **loop()), batch=e_batch),
        "F0": tp_arm(cfg, "F0", {}, batch=batch, mixed_precision="fp16", poison=TP_FP16_POISON),
        "F": tp_arm(cfg, "F", dict(tp2xfsdp2, **loop()), batch=batch, mixed_precision="fp16",
                    poison=TP_FP16_POISON),
    }
    want_sizes = {"B": dict(pp=1, dp=1, fsdp=1, ep=1, sp=1, tp=4),
                  "C": dict(pp=1, dp=1, fsdp=2, ep=1, sp=1, tp=2),
                  "D": dict(pp=1, dp=2, fsdp=1, ep=1, sp=1, tp=2),
                  "E": dict(pp=1, dp=1, fsdp=1, ep=1, sp=4, tp=1),
                  "F": dict(pp=1, dp=1, fsdp=2, ep=1, sp=1, tp=2)}
    remat = {"C", "F"}
    total = n_params * 4
    want_bytes = {"params": total, "moments": 2 * total, "buffer": total}
    for name, run in arms.items():
        sharded = name in want_sizes
        if sharded and run["sizes"] != want_sizes[name]:
            raise SystemExit(f"tp {name}: mesh {run['sizes']}, expected {want_sizes[name]}")
        fp16 = name.startswith("F")
        prefix = "flash_attention_fp16" if fp16 else "flash_attention"
        n_ranks = TP_RANKS if sharded else 1
        fwd = n_ranks * layers * (2 if name in remat else 1)
        # At a rehearsal's cut the plan differs (small leaves stay whole).
        plan = planned_update_slices(probe, run["sizes"], zero=name == "D")
        updates = sum(n for n, _ in plan)
        if cut is None and updates != TP_UPDATE_LAUNCHES[name]:
            raise SystemExit(f"tp {name}: the plan's update slices {plan}, expected "
                             f"{TP_UPDATE_LAUNCHES[name]} launches a step")
        for i, counts in enumerate(run["per_step"]):
            want = {f"{prefix}_fwd": fwd, f"{prefix}_bwd": n_ranks * layers}
            if not run["skipped"][i]:  # once per distinct update slice of a leaf
                want["fused_adamw_update"] = updates
            if cuda and counts != want:
                raise SystemExit(f"tp {name} step {i}: launches {counts}, expected {want}")
        applied = [i for i, s in enumerate(run["skipped"]) if not s]
        if not all(math.isfinite(run["losses"][i]) for i in applied):
            raise SystemExit(f"tp {name}: losses {run['losses']} not finite on applied steps")
        if run["distinct"] != want_bytes:
            raise SystemExit(f"tp {name}: the distinct shards over the ranks hold "
                             f"{run['distinct']}, the unsharded model {want_bytes}")
        tokens = (TP_ULYSSES_SEQ if name.startswith("E") else SHARD_BATCH * SHARD_SEQ)
        mfu = fpt * tokens / run["step_s"] / BF16_OPS_PER_S
        per_rank = "; ".join(
            f"rank {r}: params {row['params'][0] / 1e9:.3f} GB split + {row['params'][1] / 1e6:.1f}"
            f" MB whole, moments {row['moments'][0] / 1e9:.3f} GB + "
            f"{row['moments'][1] / 1e6:.1f} MB, buffer {row['buffer'][0] / 1e9:.3f} GB + "
            f"{row['buffer'][1] / 1e6:.1f} MB" for r, row in enumerate(run["ranks"]))
        log(f"tp {name}: mesh {run['sizes']}; losses {[round(x, 4) for x in run['losses']]}"
            + (f", scales {run['scales']}, skipped {run['skipped']}" if fp16 else "")
            + f"; step {run['step_s'] * 1e3:.1f} ms, {tokens / run['step_s']:.0f} tokens/s, "
            f"MFU {100 * mfu:.2f}% of 989 TFLOP/s (recompute not counted); peak memory "
            f"{run['peak'] / 2**30:.2f} GiB; launches {run['counts']}; distinct shards "
            f"{run['distinct']} = the unsharded bytes; {per_rank} [{card}]")
    for name, ref in (("B", "A"), ("C", "A"), ("D", "A"), ("E", "E0")):
        diff = max(abs(x - y) for x, y in zip(arms[name]["losses"][:3], arms[ref]["losses"][:3]))
        if diff > SHARD_LOSS_ATOL:
            raise SystemExit(f"tp {name}: losses {arms[name]['losses'][:3]} vs arm {ref}'s "
                             f"{arms[ref]['losses'][:3]} (max |diff| {diff}, pin "
                             f"{SHARD_LOSS_ATOL})")
        log(f"tp {name} vs {ref}: first 3 losses max |diff| {diff:.3e} (pin {SHARD_LOSS_ATOL}); "
            f"step {arms[name]['step_s'] / arms[ref]['step_s']:.2f}x arm {ref}'s, peak "
            f"{arms[name]['peak'] / 2**30:.2f} vs {arms[ref]['peak'] / 2**30:.2f} GiB")
    f, f0 = arms["F"], arms["F0"]
    applied = [i for i, s in enumerate(f["skipped"]) if not s]
    if f["scales"] != f0["scales"] or f["skipped"] != f0["skipped"] or \
            not f["skipped"][TP_FP16_POISON] or not applied:
        raise SystemExit(f"tp F: scales {f['scales']} / skipped {f['skipped']} vs the unsharded "
                         f"fp16 arm's {f0['scales']} / {f0['skipped']}")
    diff = max(abs(f["losses"][i] - f0["losses"][i]) for i in applied)
    if diff > TRAIN_LOSS_ATOL:
        raise SystemExit(f"tp F: losses {f['losses']} vs {f0['losses']} on applied steps "
                         f"{applied} (max |diff| {diff}, pin {TRAIN_LOSS_ATOL})")
    log(f"tp F vs F0 (fp16, step {TP_FP16_POISON + 1} poisoned): scales {f['scales']} and skips "
        f"{f['skipped']} equal; no update launch on the skipped step on any rank; applied "
        f"losses max |diff| {diff:.3e} (pin {TRAIN_LOSS_ATOL})")
    # Ulysses' all-to-alls a layer, per rank: q, k and v (k and v repeated to
    # the 32 query heads, as the model sends them) in and the output back,
    # then their gradients; a rank keeps 1/sp of each tensor.
    heads, hd, sp = cfg.num_attention_heads, cfg.head_dim, TP_RANKS
    tensor = TP_ULYSSES_SEQ // sp * heads * hd * 2
    moved = 4 * tensor * (sp - 1) // sp
    log(f"tp E: Ulysses all-to-all bytes a rank moves a layer: forward {moved / 1e6:.1f} MB "
        f"(4 all-to-alls of a {tensor / 1e6:.1f} MB bf16 (1, {TP_ULYSSES_SEQ // sp}, {heads}, "
        f"{hd}) shard, {sp - 1}/{sp} of each leaving), backward {moved / 1e6:.1f} MB")
    totals = {}
    for run in arms.values():
        for k, v in run["counts"].items():
            totals[k] = totals.get(k, 0) + v
    return totals


# ------------------------------------------------------------------ phase 16
def _pp_arm(cfg, label: str, accelerator_kw: dict, *, batch, tx: str = "adamw",
            remat: bool = False, device: str = "cuda"):
    """One arm of phase 16 on a fresh model from the seed: ``PP_STEPS``
    ``build_train_step`` steps of ``batch`` with clip 1.0. Returns the
    losses, step seconds after ``PP_WARMUP``, the launch counts per step,
    the peak memory, the mesh and, under pp, the schedule's most saved
    stage inputs and the stage-to-stage messages and bytes of one step."""
    import dataclasses

    import torch

    from accelerate_tpu_torch import Accelerator, Llama, adafactor, adamw
    from accelerate_tpu_torch.ops import registry

    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = Llama(dataclasses.replace(cfg, remat=remat), device=device)
    model.init_params(SEED)
    acc = Accelerator(mixed_precision="bf16", device=device, **accelerator_kw)
    opt = adafactor(1e-2, device=device) if tx == "adafactor" else adamw(3e-4, device=device)
    pm, po = acc.prepare(model, opt)
    del model
    step = acc.build_train_step(pm, po)
    spec = pm.handle.pipeline_spec
    registry.reset_launch_counts()
    losses, times, per_step, before, sent = [], [], [], {}, None
    for i in range(PP_STEPS):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch, clip_norm=1.0)))
        times.append(time.perf_counter() - t0)
        now = dict(registry.launch_counts)
        per_step.append(_count_delta(now, before))
        before = now
        if spec is not None and i == 0:
            sent = (spec.transport.messages, spec.transport.sent_bytes)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = dict(losses=losses, step_s=sum(times[PP_WARMUP:]) / (PP_STEPS - PP_WARMUP),
               per_step=per_step, counts=dict(registry.launch_counts), peak=peak,
               sizes=acc.mesh_sizes, spec=None if spec is None else (
                   spec.stages, spec.num_microbatches, spec.schedule),
               saved=None if spec is None else dict(spec.peak_saved), sent=sent)
    del acc, pm, po, step, spec
    if cuda:
        free_cuda()
    return out


def pippy_arm(card: str, device: str = "cuda", cut=None) -> dict:
    """Arm G of phase 16: ``prepare_pippy`` of Llama-3-8B (all 32 layers,
    bf16) on this card against the unpipelined forward; the flash
    launches of the pipelined forward."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Llama, LlamaConfig, prepare_pippy
    from accelerate_tpu_torch.ops import registry

    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama3_8b(**{"max_position_embeddings": SHARD_SEQ, **(cut or {})})
    model = Llama(cfg, device=device)
    model.init_params(SEED, dtype=torch.bfloat16)
    ids = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SHARD_BATCH, SHARD_SEQ)).astype(np.int32), device=device)
    piped = prepare_pippy(model, split_points="auto", num_chunks=PP_PIPPY_CHUNKS)
    if len(piped.stage_ranges) != 1 or piped.stage_ranges[0] != (0, cfg.num_hidden_layers):
        raise SystemExit(f"pippy G: stages {piped.stage_ranges} on one card")
    registry.reset_launch_counts()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = piped(input_ids=ids)["logits"]
    if cuda:
        torch.cuda.synchronize()
    piped_s = time.perf_counter() - t0
    counts = dict(registry.launch_counts)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = model.apply(model.params, input_ids=ids)["logits"]
    if cuda:
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    diff = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    scale = float(want.float().abs().max())
    layers = cfg.num_hidden_layers
    want_counts = {"flash_attention_fwd": layers * PP_PIPPY_CHUNKS}
    if cuda and counts != want_counts:
        raise SystemExit(f"pippy G: launches {counts}, expected {want_counts}")
    if not diff <= PIPPY_LOGITS_ATOL:
        raise SystemExit(f"pippy G: logits max |diff| {diff} vs the unpipelined forward "
                         f"(pin {PIPPY_LOGITS_ATOL})")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"pp G: prepare_pippy of {layers} layers ({model.num_params() / 1e9:.2f}B parameters, "
        f"bf16), 1 stage, {PP_PIPPY_CHUNKS} chunks of a {SHARD_BATCH} x {SHARD_SEQ} batch: "
        f"logits max |diff| {diff:.3e} vs the unpipelined forward (max |logit| {scale:.2f}, "
        f"pin {PIPPY_LOGITS_ATOL}); {piped_s * 1e3:.1f} ms vs {plain_s * 1e3:.1f} ms "
        f"unpipelined (first calls); launches {counts}; peak {peak / 2**30:.2f} GiB [{card}]")
    del model, piped, got, want
    if cuda:
        free_cuda()
    return counts


def pp_phase(card: str, device: str = "cuda", cut=None) -> dict:
    """Phase 16; returns the launch counts of its training arms (bf16 flash
    and the adamw update, rows 4, 5 and 5b). ``device="cpu"`` with ``cut``
    (LlamaConfig fields over the 8B's) rehearses the phase's logic at a
    small size; the CPU runs no kernel, so no launch is checked there."""
    import numpy as np

    from accelerate_tpu_torch import (Llama, LlamaConfig, LoopbackShards, ParallelismConfig,
                                      PipelineParallelPlugin)

    cuda = device == "cuda"
    cfg = LlamaConfig.llama3_8b(**{**TRAIN_CUT, **(cut or {})})
    probe = Llama(cfg, device="cpu")
    fpt = probe.flops_per_token()
    layers, hidden = cfg.num_hidden_layers, cfg.hidden_size
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                               (SHARD_BATCH, SHARD_SEQ)).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    tokens = SHARD_BATCH * SHARD_SEQ

    def piped(n, mesh, mb, schedule):
        return dict(parallelism_config=ParallelismConfig(**mesh),
                    pp_plugin=PipelineParallelPlugin(mesh["pp_size"], mb, schedule),
                    loopback=LoopbackShards(n))

    # name: (accelerator kwargs, tx, remat, (P, M, data coordinates, tp) or None)
    plan = {
        "A": ({}, "adamw", False, None),
        "B": (piped(4, dict(pp_size=4), PP_MICRO, "gpipe"), "adamw", False, (4, PP_MICRO, 1, 1)),
        "C": (piped(4, dict(pp_size=4), PP_MICRO, "1f1b"), "adamw", False, (4, PP_MICRO, 1, 1)),
        "D": (piped(4, dict(pp_size=2, tp_size=2), PP_MICRO, "1f1b"), "adamw", False,
              (2, PP_MICRO, 1, 2)),
        "E": (piped(4, dict(pp_size=2, fsdp_size=2), 2, "gpipe"), "adamw", True, (2, 2, 2, 1)),
        "F0": ({}, "adafactor", False, None),
        "F": (piped(2, dict(pp_size=2), PP_MICRO, "1f1b"), "adafactor", False,
              (2, PP_MICRO, 1, 1)),
    }
    arms = {}
    for name, (kw, tx, remat, shape) in plan.items():
        run = arms[name] = _pp_arm(cfg, name, kw, batch=batch, tx=tx, remat=remat,
                                   device=device)
        if not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"pp {name}: losses not finite: {run['losses']}")
        if shape is None:
            fwd = bwd = layers
            units = 1
        else:
            P, M, units, tp = shape
            if run["spec"] is None or run["spec"][:2] != (P, M):
                raise SystemExit(f"pp {name}: pipeline {run['spec']}, expected {P} stages x "
                                 f"{M} microbatches")
            # Every layer once a microbatch, data coordinate and tp rank; 1F1B's
            # backward unit and remat run each block's forward again.
            again = run["spec"][2] == "1f1b" or remat
            fwd = layers * M * units * tp * (2 if again else 1)
            bwd = layers * M * units * tp
            mb_rows = SHARD_BATCH // units // M
            want_msgs = 2 * (P - 1) * M * units
            want_bytes = want_msgs * mb_rows * SHARD_SEQ * hidden * 2
            if run["sent"] != (want_msgs, want_bytes):
                raise SystemExit(f"pp {name}: one step's stage-to-stage (messages, bytes) "
                                 f"{run['sent']}, the schedule's {(want_msgs, want_bytes)}")
            if run["spec"][2] == "1f1b" and max(run["saved"].values()) > 2 * P:
                raise SystemExit(f"pp {name}: saved stage inputs {run['saved']} > 2P")
        slices = planned_update_slices(probe, run["sizes"])
        updates = 0 if tx == "adafactor" else sum(n for n, _ in slices)
        for i, counts in enumerate(run["per_step"]):
            want = {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd}
            if updates:
                want["fused_adamw_update"] = updates
            if cuda and counts != want:
                raise SystemExit(f"pp {name} step {i}: launches {counts}, expected {want}")
        mfu = fpt * tokens / run["step_s"] / BF16_OPS_PER_S
        log(f"pp {name}: mesh {run['sizes']}, pipeline {run['spec']}, {tx}"
            + (", remat" if remat else "") + f"; losses {[round(x, 4) for x in run['losses']]}; "
            f"step {run['step_s'] * 1e3:.1f} ms, {tokens / run['step_s']:.0f} tokens/s, MFU "
            f"{100 * mfu:.2f}% of 989 TFLOP/s (recompute not counted); peak memory "
            f"{run['peak'] / 2**30:.2f} GiB; launches a step {run['per_step'][-1]} (the "
            f"schedule's: flash fwd {fwd}, bwd {bwd}, update {updates}); saved stage inputs "
            f"{run['saved']}; stage-to-stage messages, bytes a step {run['sent']} [{card}]")
    for name, ref in (("B", "A"), ("C", "A"), ("D", "A"), ("E", "A"), ("F", "F0")):
        diff = max(abs(x - y) for x, y in zip(arms[name]["losses"], arms[ref]["losses"]))
        if diff > SHARD_LOSS_ATOL:
            raise SystemExit(f"pp {name}: losses {arms[name]['losses']} vs arm {ref}'s "
                             f"{arms[ref]['losses']} (max |diff| {diff}, pin "
                             f"{SHARD_LOSS_ATOL})")
        log(f"pp {name} vs {ref}: {PP_STEPS} losses max |diff| {diff:.3e} (pin "
            f"{SHARD_LOSS_ATOL}); step {arms[name]['step_s'] / arms[ref]['step_s']:.2f}x arm "
            f"{ref}'s, peak {arms[name]['peak'] / 2**30:.2f} vs {arms[ref]['peak'] / 2**30:.2f} "
            "GiB")
    pippy = pippy_arm(card, device=device, cut=cut)
    totals = {}
    for run in arms.values():
        for k, v in run["counts"].items():
            totals[k] = totals.get(k, 0) + v
    for k, v in pippy.items():
        totals[k] = totals.get(k, 0) + v
    return totals


def _available_host_bytes() -> int:
    """Host memory a phase may take: MemAvailable (free plus reclaimable
    cache), or the free pages where /proc/meminfo is missing."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _timed(fn, cuda: bool):
    import torch

    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def big_model_phase(card: str, device: str = "cuda", cut=None) -> dict:
    """Phase 17: big-model loading and offloaded inference at Llama-3-8B
    widths (module docstring); returns the flash launches of its scoring
    forwards (row 5). ``device="cpu"`` with ``cut`` (LlamaConfig fields
    over the 8B's) rehearses the phase at a small size: card targets then
    resolve to the CPU (``main_device="cpu"``) and no launch is checked."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    import accelerate_tpu_torch as T
    from accelerate_tpu_torch.big_modeling import StreamedScanModel
    from accelerate_tpu_torch.checkpointing import export_full_weights
    from accelerate_tpu_torch.ops import registry
    from accelerate_tpu_torch.utils.modeling import compute_module_sizes, convert_file_size_to_int
    from accelerate_tpu_torch.utils.quantization import quantized_nbytes
    from accelerate_tpu_torch.utils.tree import tree_leaves

    cuda = device == "cuda"
    main = None if cuda else "cpu"
    cfg = T.LlamaConfig.llama3_8b(**{"max_position_embeddings": BIG_SCORE_SEQ,
                                     **(cut or {})})
    t_phase = time.perf_counter()

    def empty(config):
        with T.init_empty_weights():
            model = T.Llama(config, device=device)
            model.init_params(dtype=torch.bfloat16)
        return model

    def no_meta(model, label):
        left = [leaf for leaf in tree_leaves(model.params) if leaf.device.type == "meta"]
        if left:
            raise SystemExit(f"big {label}: {len(left)} meta leaves left after loading")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_big_")
    try:
        # Resources: the checkpoint and one offloaded copy of the layers on
        # disk, the layers pinned on the host; depth is cut to fit, never width.
        sizes = compute_module_sizes(empty(cfg).params)
        layers = cfg.num_hidden_layers
        per_layer, nonlayer = sizes["layers"] // layers, sizes[""] - sizes["layers"]
        disk, ram = shutil.disk_usage(tmp).free, _available_host_bytes()
        fit = min(layers, int((0.9 * disk - nonlayer) // (2 * per_layer)),
                  int((0.9 * ram - nonlayer) // per_layer))
        log(f"big: {disk / 1e9:.1f} GB free on disk under {tmp}, {ram / 1e9:.1f} GB of host "
            f"memory available; the phase needs {(nonlayer + 2 * layers * per_layer) / 1e9:.2f} "
            f"GB of disk and {(nonlayer + layers * per_layer) / 1e9:.2f} GB of host memory")
        if fit < 1:
            raise SystemExit("big: not enough disk or host memory for one layer")
        if fit < layers:
            log(f"big: depth cut {layers} -> {fit} layers to fit (widths kept)")
            cfg = dataclasses.replace(cfg, num_hidden_layers=fit)
            layers = fit
        rng = np.random.default_rng(SEED)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BIG_BATCH, BIG_PROMPT)),
                              dtype=torch.int32, device=device)
        long = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, BIG_SCORE_SEQ)),
                               dtype=torch.int32, device=device)
        secs = {}

        # A: empty init.
        before = torch.cuda.memory_allocated() if cuda else 0
        model, secs["A"] = _timed(lambda: empty(cfg), cuda)
        after = torch.cuda.memory_allocated() if cuda else 0
        kinds = {leaf.device.type for leaf in tree_leaves(model.params)}
        sizes = compute_module_sizes(model.params)
        if kinds != {"meta"} or after != before or sizes[""] != 2 * model.num_params():
            raise SystemExit(f"big A: leaves on {kinds}, memory_allocated {before} -> {after}, "
                             f"{sizes['']} B for {model.num_params()} bf16 parameters")
        log(f"big A: init_empty_weights + init_params of {layers} layers: "
            f"{len(tree_leaves(model.params))} leaves, all on meta; memory_allocated {before} -> "
            f"{after} B; compute_module_sizes {sizes[''] / 1e9:.2f} GB "
            f"({model.num_params() / 1e9:.2f}B bf16 parameters; layers "
            f"{sizes['layers'] / 1e9:.2f} GB) in {secs['A']:.3f} s [{card}]")

        # B: the checkpoint, seeded weights written as sharded safetensors.
        ckpt = os.path.join(tmp, "checkpoint")
        src = T.Llama(cfg, device=device)
        src.init_params(SEED, dtype=torch.bfloat16)
        _, secs["B"] = _timed(lambda: export_full_weights(src.params, ckpt,
                                                           max_shard_size=BIG_SHARD), cuda)
        del src
        free_cuda()
        ckpt_bytes = dir_bytes(ckpt)
        log(f"big B: checkpoint of {ckpt_bytes / 1e9:.2f} GB in "
            f"{len([f for f in os.listdir(ckpt) if f.endswith('.safetensors')])} shards of "
            f"<= {BIG_SHARD} written in {secs['B']:.2f} s ({ckpt_bytes / 1e9 / secs['B']:.2f} "
            f"GB/s, from the card)")

        # C: resident, "auto" under the default budget (a CPU rehearsal names a
        # card budget: without a card the default lists only the host).
        budget = None if cuda else {"cuda:0": 2 * sizes[""], "cpu": sizes[""]}
        c, secs["C load"] = _timed(lambda: T.load_checkpoint_and_dispatch(
            empty(cfg), ckpt, device_map="auto", max_memory=budget, main_device=main), cuda)
        if not isinstance(c, T.Llama) or set(c._at_device_map.values()) != {"cuda:0"}:
            raise SystemExit(f"big C: 'auto' gave {type(c).__name__} with map "
                             f"{c._at_device_map}, not all on cuda:0")
        no_meta(c, "C")
        T.generate(c, ids, max_new_tokens=2, device=device)  # the first call's costs, untimed
        tokens_c, secs["C gen"] = _timed(lambda: T.generate(
            c, ids, max_new_tokens=BIG_NEW_TOKENS, device=device), cuda)
        with torch.no_grad():
            logits_c = c.apply(c.params, input_ids=ids)["logits"]
            registry.reset_launch_counts()
            score_c, secs["C score"] = _timed(
                lambda: c.apply(c.params, input_ids=long, labels=long), cuda)
        counts_c = dict(registry.launch_counts)
        if cuda and counts_c != {"flash_attention_fwd": layers}:
            raise SystemExit(f"big C: scoring forward launches {counts_c}, expected "
                             f"{layers} flash forwards")
        log(f"big C: load_checkpoint_and_dispatch(device_map='auto') -> {c._at_device_map}, "
            f"resident on the card, no meta leaf: load {secs['C load']:.2f} s "
            f"({ckpt_bytes / 1e9 / secs['C load']:.2f} GB/s); generate {BIG_NEW_TOKENS} tokens "
            f"of {BIG_BATCH} x {BIG_PROMPT}: {secs['C gen'] / BIG_NEW_TOKENS * 1e3:.1f} ms a "
            f"token; scoring 1 x {BIG_SCORE_SEQ} with labels: loss {float(score_c['loss']):.4f}, "
            f"{secs['C score'] * 1e3:.1f} ms, launches {counts_c} [{card}]")
        del c
        free_cuda()

        # D: the layers streamed from pinned host memory.
        d, secs["D load"] = _timed(lambda: T.load_checkpoint_and_dispatch(
            empty(cfg), ckpt, device_map=BIG_LAYERS_ON_HOST, main_device=main), cuda)
        if not isinstance(d, StreamedScanModel):
            raise SystemExit(f"big D: dispatch gave {type(d).__name__}, not a StreamedScanModel")
        T.generate(d, ids, max_new_tokens=2, device=device)  # the first call's costs, untimed
        streamed_before = d.bytes_streamed
        tokens_d, secs["D gen"] = _timed(lambda: T.generate(
            d, ids, max_new_tokens=BIG_NEW_TOKENS, device=device), cuda)
        per_forward = (d.bytes_streamed - streamed_before) / BIG_NEW_TOKENS
        if not torch.equal(tokens_d, tokens_c):
            raise SystemExit(f"big D: streamed tokens differ from the resident ones:\n"
                             f"{tokens_d[:, BIG_PROMPT:]}\n{tokens_c[:, BIG_PROMPT:]}")
        if per_forward != sizes["layers"]:
            raise SystemExit(f"big D: {per_forward} B streamed a forward, the layers hold "
                             f"{sizes['layers']} B")
        registry.reset_launch_counts()
        score_d, secs["D score"] = _timed(lambda: d(input_ids=long, labels=long), cuda)
        counts_d = dict(registry.launch_counts)
        if cuda and counts_d != {"flash_attention_fwd": layers}:
            raise SystemExit(f"big D: scoring forward launches {counts_d}, expected "
                             f"{layers} flash forwards")
        rel_d = rel_fro(score_d["logits"], score_c["logits"])
        bitwise_d = torch.equal(score_d["logits"], score_c["logits"])
        if not rel_d <= BIG_LOGITS_REL:
            raise SystemExit(f"big D: scoring logits rel Frobenius {rel_d} vs resident (pin "
                             f"{BIG_LOGITS_REL})")
        token_s = secs["D gen"] / BIG_NEW_TOKENS
        log(f"big D: layers on the host (pinned), StreamedScanModel: load {secs['D load']:.2f} s; "
            f"{BIG_NEW_TOKENS} tokens identical to C's, {token_s * 1e3:.1f} ms a token "
            f"({token_s / (secs['C gen'] / BIG_NEW_TOKENS):.1f}x C), {per_forward / 1e9:.2f} GB "
            f"streamed a token, {per_forward / 1e9 / token_s:.2f} GB/s; scoring "
            f"{secs['D score'] * 1e3:.1f} ms, launches {counts_d}, logits rel Frobenius "
            f"{rel_d:.3e} vs C ({'bitwise' if bitwise_d else 'not bitwise'}) [{card}]")
        del d, score_d
        free_cuda()

        # E: the layers streamed from an offload folder on disk.
        offload = os.path.join(tmp, "offload")
        e, secs["E load"] = _timed(lambda: T.load_checkpoint_and_dispatch(
            empty(cfg), ckpt, device_map=BIG_LAYERS_ON_DISK, offload_folder=offload,
            main_device=main), cuda)
        if not isinstance(e, StreamedScanModel):
            raise SystemExit(f"big E: dispatch gave {type(e).__name__}")
        tokens_e, secs["E gen"] = _timed(lambda: T.generate(
            e, ids, max_new_tokens=BIG_DISK_TOKENS, device=device), cuda)
        if not torch.equal(tokens_e, tokens_c[:, :BIG_PROMPT + BIG_DISK_TOKENS]):
            raise SystemExit(f"big E: disk-streamed tokens differ from C's first "
                             f"{BIG_DISK_TOKENS}")
        token_s = secs["E gen"] / BIG_DISK_TOKENS
        log(f"big E: layers on disk ({dir_bytes(offload) / 1e9:.2f} GB offload folder written "
            f"in the {secs['E load']:.2f} s load): {BIG_DISK_TOKENS} tokens identical to C's, "
            f"{token_s * 1e3:.1f} ms a token, {sizes['layers'] / 1e9 / token_s:.2f} GB/s "
            f"(the folder was just written: warm page cache) [{card}]")
        del e
        shutil.rmtree(offload)
        free_cuda()

        # F: "auto" under a tight card budget.
        tight = convert_file_size_to_int(BIG_TIGHT_CARD) if cut is None else sizes["embed"] * 3 // 2
        f, secs["F load"] = _timed(lambda: T.load_checkpoint_and_dispatch(
            empty(cfg), ckpt, device_map="auto", max_memory={"cuda:0": tight, "cpu": sizes[""]},
            main_device=main), cuda)
        fmap = (f.model if isinstance(f, StreamedScanModel) else f)._at_device_map
        runtime = type(f).__name__ + ("" if isinstance(f, StreamedScanModel) else
                                      f" under {type(f._at_hook).__name__}")
        with torch.no_grad():
            logits_f, secs["F fwd"] = _timed(
                lambda: (f(input_ids=ids) if isinstance(f, StreamedScanModel)
                         else f.apply(f.params, input_ids=ids))["logits"], cuda)
        rel_f = rel_fro(logits_f, logits_c)
        if not rel_f <= BIG_LOGITS_REL:
            raise SystemExit(f"big F: logits rel Frobenius {rel_f} vs C (pin {BIG_LOGITS_REL})")
        log(f"big F: 'auto' with max_memory cuda:0 {tight / 2**30:.2f} GiB: map {fmap}, run by "
            f"{runtime}; load {secs['F load']:.2f} s, a {BIG_BATCH} x {BIG_PROMPT} forward "
            f"{secs['F fwd']:.2f} s, logits rel Frobenius {rel_f:.3e} vs C [{card}]")
        del f, logits_f
        free_cuda()

        # G: weight-only int8 and int4.
        for bits in (8, 4):
            flag = {"load_in_8bit": True} if bits == 8 else {"load_in_4bit": True}
            if cuda:
                base = torch.cuda.memory_allocated()
            q, secs[f"G{bits} load"] = _timed(lambda: T.load_and_quantize_model(
                empty(cfg), weights_location=ckpt,
                quantization_config=T.QuantizationConfig(**flag)), cuda)
            at_rest = quantized_nbytes(q.params)
            if cuda:
                held = torch.cuda.memory_allocated() - base
                torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                logits_q = q.apply(q.params, input_ids=ids)["logits"]
            peak = torch.cuda.max_memory_allocated() - base if cuda else 0
            corr = float(np.corrcoef(logits_q.float().cpu().numpy().ravel(),
                                     logits_c.float().cpu().numpy().ravel())[0, 1])
            tokens_q, secs[f"G{bits} gen"] = _timed(lambda: T.generate(
                q, ids, max_new_tokens=BIG_NEW_TOKENS, device=device), cuda)
            same = float((tokens_q[:, BIG_PROMPT:] == tokens_c[:, BIG_PROMPT:]).float().mean())
            if not corr > QUANT_CORR_FLOOR[bits]:
                raise SystemExit(f"big G int{bits}: logits correlation {corr} vs C (floor "
                                 f"{QUANT_CORR_FLOOR[bits]})")
            log(f"big G int{bits}: load_and_quantize_model {secs[f'G{bits} load']:.2f} s; "
                f"{at_rest / 1e9:.2f} GB at rest (quantized_nbytes; bf16 {sizes[''] / 1e9:.2f}), "
                + (f"{held / 1e9:.2f} GB held on the card, peak {peak / 1e9:.2f} GB during a "
                   f"{BIG_BATCH} x {BIG_PROMPT} forward (the whole tree dequantized); " if cuda
                   else "")
                + f"logits correlation {corr:.5f} vs C (floor {QUANT_CORR_FLOOR[bits]}); "
                f"{BIG_NEW_TOKENS} greedy tokens, {same:.1%} equal to C's, "
                f"{secs[f'G{bits} gen'] / BIG_NEW_TOKENS * 1e3:.1f} ms a token [{card}]")
            del q, logits_q
            free_cuda()
        log(f"big: phase 17 in {time.perf_counter() - t_phase:.1f} s; arms (s): "
            + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
        return {"flash_attention_fwd": sum(n.get("flash_attention_fwd", 0)
                                           for n in (counts_c, counts_d))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cv_phase(card: str, device: str = "cuda") -> dict:
    """Phase 18: the port's CV examples (module docstring); returns the
    registry's launches (none: the convolutions are cuDNN's and
    ``inject_hyperparams(adam)`` runs the reference chain)."""
    import tempfile
    from argparse import Namespace

    import numpy as np
    import torch

    from accelerate_tpu_torch.examples import complete_cv_example, cv_example
    from accelerate_tpu_torch.ops import registry

    cuda = device == "cuda"
    # A resumed run is bitwise an uninterrupted one only on deterministic kernels.
    saved_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    original = cv_example.Accelerator

    def recording(key):
        class Recording(original):
            def backward(self, loss, **kw):
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
                runs[key]["stamps"].append(time.perf_counter())
                runs[key]["losses"].append(loss.detach())
                return super().backward(loss, **kw)
        return Recording

    config = {"lr": 3e-3, "num_epochs": 3, "seed": 42, "batch_size": 32}
    try:
        runs["card"] = {"stamps": [], "losses": []}
        cv_example.Accelerator = recording("card")
        registry.reset_launch_counts()
        accuracy = cv_example.training_function(config, Namespace(
            mixed_precision="bf16" if cuda else "no", cpu=not cuda))
        counts = dict(registry.launch_counts)
        runs["cpu"] = {"stamps": [], "losses": []}
        cv_example.Accelerator = recording("cpu")
        cv_example.training_function(dict(config, num_epochs=1),
                                     Namespace(mixed_precision="no", cpu=True))
    finally:
        cv_example.Accelerator = original
    card_run = runs["card"]
    step_s = float(np.median(np.diff(card_run["stamps"])))
    first, first_cpu = float(card_run["losses"][0]), float(runs["cpu"]["losses"][0])
    rel = abs(first - first_cpu) / abs(first_cpu)
    if counts:
        raise SystemExit(f"cv: the example launched {counts}; inject_hyperparams runs the "
                         "reference chain")
    if not accuracy > CV_MIN_ACCURACY or not rel <= CV_LOSS_REL:
        raise SystemExit(f"cv: accuracy {accuracy} (floor {CV_MIN_ACCURACY}), step-1 loss "
                         f"{first} vs {first_cpu} on the CPU in f32 (rel {rel}, pin "
                         f"{CV_LOSS_REL})")
    log(f"cv: cv_example, {'bf16 on the card' if cuda else 'f32 on the CPU'}, "
        f"{config['num_epochs']} epochs of {len(card_run['losses']) // config['num_epochs']} "
        f"steps (batch 32, 1024 train and 256 eval images): final accuracy {accuracy:.4f}; "
        f"{1 / step_s:.1f} steps/s (median step, host clock, synchronised at each backward); "
        f"losses {float(card_run['losses'][0]):.4f} -> {float(card_run['losses'][-1]):.4f}; "
        f"step 1's loss {first:.6f} vs {first_cpu:.6f} in f32 on the CPU (rel {rel:.2e}); "
        f"launches {counts} [{card}]")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cv_") as tmp:
        flags = ["--mixed_precision", "bf16"] if cuda else ["--cpu"]
        whole, resumed = os.path.join(tmp, "whole"), os.path.join(tmp, "resumed")
        _, whole_s = _timed(lambda: complete_cv_example.main(flags + [
            "--checkpointing_steps", str(CV_CKPT_EVERY), "--output_dir", whole]), cuda)
        _, resumed_s = _timed(lambda: complete_cv_example.main(flags + [
            "--checkpointing_steps", str(CV_CKPT_EVERY), "--output_dir", resumed,
            "--resume_from_checkpoint", os.path.join(whole, f"step_{CV_RESUME_AT}")]), cuda)
        last = f"step_{config['num_epochs'] * 32}"
        files = [os.path.join(last, item, "arrays.safetensors") for item in ("model", "optimizer")]
        differ = [f for f in files if open(os.path.join(whole, f), "rb").read()
                  != open(os.path.join(resumed, f), "rb").read()]
        if differ:
            raise SystemExit(f"cv: resumed from step {CV_RESUME_AT}, {differ} differ from the "
                             "uninterrupted run's")
    log(f"cv: complete_cv_example --checkpointing_steps {CV_CKPT_EVERY}: the run resumed from "
        f"step_{CV_RESUME_AT} (mid-epoch) ends bitwise the uninterrupted run ({last}'s model "
        f"and optimizer); {whole_s:.2f} s and {resumed_s:.2f} s [{card}]")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags
    return counts


def cli(args: list, cwd: str | None = None, timeout: float = 600.0):
    """``python -m accelerate_tpu_torch.commands.accelerate_cli <args>``, the
    ``accelerate-tpu-torch`` entry point, with the repository on
    ``PYTHONPATH``; returns the finished process (output captured)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    return subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli",
                           *args], cwd=cwd or root, env=env, capture_output=True, text=True,
                          timeout=timeout)


def json_line(text: str, key: str):
    """The value under ``key`` of the first JSON line of ``text`` that has it."""
    for line in text.splitlines():
        if line.startswith("{") and f'"{key}"' in line:
            return json.loads(line)[key]
    return None


def _cli_failed(label: str, out) -> SystemExit:
    return SystemExit(f"{label}: rc {out.returncode}\n--- stdout\n{out.stdout[-6000:]}\n"
                      f"--- stderr\n{out.stderr[-6000:]}")


def launched_worker() -> int:
    """Phase 19 A's child, started by ``accelerate-tpu-torch launch
    --num_processes 1 --mixed_precision bf16 chip_smoke.py --launched-worker``:
    its ``Accelerator()`` takes no precision argument, so bf16 comes from the
    launch contract. Runs phase 11's arm B loop for LAUNCH_STEPS steps and
    prints one JSON line: the precision, the device, the rank keys, the
    losses and the kernel launches."""
    import torch

    from accelerate_tpu_torch import Accelerator

    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "ACCELERATE_MIXED_PRECISION")
    env = {k: os.environ.get(k) for k in keys}
    acc = Accelerator()
    precision, device = acc.mixed_precision, str(acc.device)
    run = loop_arm(bert_base_config(), inject=False, steps=LAUNCH_STEPS, acc=acc)
    print(json.dumps({"launched_worker": {
        "mixed_precision": precision, "device": device,
        "current_device": torch.cuda.current_device(), "env": env, "losses": run["losses"],
        "launches": run["counts"], "wall": run["wall"]}}), flush=True)
    return 0


def launch_phase(card: str) -> dict:
    """Phase 19: the launcher and the CLI (module docstring); returns the
    launched children's kernel launches (rows 4 and 4b)."""
    import contextlib
    import io
    import tempfile

    from accelerate_tpu_torch import Llama, LlamaConfig
    from accelerate_tpu_torch.commands import estimate

    t_phase = time.perf_counter()
    counts = {}

    # A: phase 11's loop in a launched child, bf16 from the contract.
    t0 = time.perf_counter()
    out = cli(["launch", "--num_processes", "1", "--mixed_precision", "bf16", "chip_smoke.py",
               "--launched-worker"])
    a_s = time.perf_counter() - t0
    child = json_line(out.stdout, "launched_worker")
    if out.returncode != 0 or child is None:
        raise _cli_failed("launch A", out)
    want_launches = {"fused_adamw_update": BERT_LEAVES * LAUNCH_STEPS}
    want_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                "ACCELERATE_MIXED_PRECISION": "bf16"}
    if (child["mixed_precision"] != "bf16" or not child["device"].startswith("cuda")
            or child["current_device"] != 0 or child["env"] != want_env
            or child["launches"] != want_launches):
        raise SystemExit(f"launch A: the child reports {child} (want bf16 on cuda:0, "
                         f"{want_env}, launches {want_launches})")
    ref = loop_arm(bert_base_config(), inject=False, steps=LAUNCH_STEPS)
    if child["losses"] != ref["losses"] or ref["counts"] != want_launches:
        raise SystemExit(f"launch A: the launched losses {child['losses']} are not bitwise the "
                         f"in-process run's {ref['losses']} (in-process launches "
                         f"{ref['counts']})")
    counts["fused_adamw_update"] = child["launches"]["fused_adamw_update"]
    log(f"launch A: `launch --num_processes 1 --mixed_precision bf16 chip_smoke.py "
        f"--launched-worker`: the child's Accelerator() read bf16 from the contract, ran on "
        f"cuda:{child['current_device']} with {child['env']}; {LAUNCH_STEPS} steps of phase "
        f"11's loop (bert-base-cased widths, constant adamw), losses bitwise the in-process "
        f"run's ({child['losses'][0]:.6f} -> {child['losses'][-1]:.6f}), fused_adamw_update "
        f"{child['launches']['fused_adamw_update']} launches ({BERT_LEAVES} a step); the "
        f"launch took {a_s:.1f} s [{card}]")

    # B: the test command on the card.
    t0 = time.perf_counter()
    out = cli(["test"])
    b_s = time.perf_counter() - t0
    launches = json_line(out.stdout, "test_script_launches")
    if (out.returncode != 0 or "All distributed asserts passed." not in out.stdout
            or launches is None or not launches.get("fused_sgd_update", 0) > 0):
        raise _cli_failed(f"launch B (accelerate-tpu-torch test; launches {launches})", out)
    counts["fused_sgd_update"] = launches["fused_sgd_update"]
    log(f"launch B: `accelerate-tpu-torch test` passed in {b_s:.1f} s (\"All distributed "
        f"asserts passed.\"); the script's launches {launches} (the sgd update, row 4b) "
        f"[{card}]")

    # C: fail fast, and one restart on the card.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        def script(name, body):
            path = os.path.join(tmp, name)
            with open(path, "w") as f:
                f.write(body)
            return path

        gang = script("gang.py", "import os, sys, time\n"
                                 "if os.environ['RANK'] == '1':\n    sys.exit(3)\n"
                                 "time.sleep(600)\n")
        flaky = script("flaky.py", "import json, os, sys\n"
                                   "attempt = int(os.environ['ACCELERATE_RESTART_ATTEMPT'])\n"
                                   "print(json.dumps({'attempt': attempt, 'cpu': os.environ.get("
                                   "'ACCELERATE_USE_CPU'), 'rank': os.environ['RANK']}), "
                                   "flush=True)\n"
                                   "sys.exit(3 if attempt == 0 else 0)\n")
        t0 = time.perf_counter()
        out = cli(["launch", "--cpu", "--num_processes", "2", gang])
        gang_s = time.perf_counter() - t0
        if out.returncode != 3 or gang_s > FAIL_FAST_S:
            raise _cli_failed(f"launch C (rank 1 of 2 exits 3, rank 0 sleeps; want rc 3 within "
                              f"{FAIL_FAST_S} s, took {gang_s:.1f} s)", out)
        out = cli(["launch", "--num_processes", "1", "--max_restarts", "1", flaky])
        attempts = [json.loads(line) for line in out.stdout.splitlines()
                    if line.startswith('{"attempt"')]
        if (out.returncode != 0 or attempts != [{"attempt": a, "cpu": None, "rank": "0"}
                                                for a in (0, 1)]
                or "failed (rc=3)" not in out.stderr):
            raise _cli_failed(f"launch C (--max_restarts 1, attempt 0 exits 3; attempts "
                              f"{attempts})", out)
    log(f"launch C: a 2-rank --cpu gang whose rank 1 exits 3 returned 3 in {gang_s:.1f} s "
        f"(rank 0 stopped); on the card, --max_restarts 1 saw attempt 0 exit 3, ran attempt "
        f"1 and passed")

    # D: the memory estimate of the Llama-3-8B preset.
    n_params = Llama(LlamaConfig.llama3_8b(), device="cpu").num_params()
    args = estimate.estimate_command_parser().parse_args(["llama-3-8b", "--dtypes", "bf16"])
    rows, largest = estimate.gather_data(args)
    if rows[0][2] != 2 * n_params:
        raise SystemExit(f"launch D: estimate bf16 {rows[0][2]} B vs num_params x 2 = "
                         f"{2 * n_params} B")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        estimate.estimate_command(args)
    log(f"launch D: estimate-memory llama-3-8b: bf16 {rows[0][2]} B ({rows[0][2] / 1e9:.2f} "
        f"GB) = {n_params} parameters x 2, largest block {largest[1]!r}; the command prints "
        f"{printed.getvalue().strip().splitlines()[-1].split()}")
    log(f"launch: phase 19 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return counts


# ------------------------------------------------------------------ phase 20
def mixtral_config(layers: int, cut=None):
    """The published Mixtral-8x7B config through ``mixtral_config_from_hf``
    at ``layers`` layers, the attention FLOPs at the step's sequence;
    ``cut`` (config fields) shrinks it for a rehearsal on the CPU."""
    import dataclasses

    from accelerate_tpu_torch import mixtral_config_from_hf

    return dataclasses.replace(mixtral_config_from_hf(MIXTRAL_8X7B), num_hidden_layers=layers,
                               max_position_embeddings=MOE_SEQ, **(cut or {}))


class counted_dispatch:
    """The dispatch back-ends (``ops/moe.BACKENDS``) the layers run inside
    the block, counted by name (``self.counts``); not while ``paused``."""

    paused = False

    def __enter__(self):
        from accelerate_tpu_torch.ops import moe

        self.saved, self.counts = dict(moe.BACKENDS), {}

        def wrap(name, fn):
            def run(*args, **kwargs):
                if not counted_dispatch.paused:
                    self.counts[name] = self.counts.get(name, 0) + 1
                return fn(*args, **kwargs)
            return run

        moe.BACKENDS.update({n: wrap(n, f) for n, f in self.saved.items()})
        return self

    def __exit__(self, *exc):
        from accelerate_tpu_torch.ops import moe

        moe.BACKENDS.update(self.saved)


def moe_serving_arm(card: str, device: str, cut) -> dict:
    """Phase 20 A: the paged engine (phase 3's wave, against a
    ``kernels="off"`` engine) and ``generate`` on 8 layers in bf16; returns
    the engine's launch counts."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import MoELlama, generate

    cfg = mixtral_config(MOE_SERVE_LAYERS, cut)
    model = MoELlama(cfg, device=device)
    t0 = time.perf_counter()
    model.init_params(SEED, dtype=torch.bfloat16)
    log(f"moe A: Mixtral-8x7B widths, {cfg.num_hidden_layers} layers, bf16, "
        f"{model.num_params() / 1e9:.3f}B parameters, random init (seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    if device == "cuda":
        with counted_dispatch() as impls:
            run = engine_phase(model, None, ("paged_gather",), card)
        launches = run["launches"]
        log(f"moe A: engine {run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{run['ttft_s'] * 1e3:.1f} ms over {run['forwards']} forwards; dispatch back-end "
            f"calls {impls.counts} ({cfg.num_hidden_layers} a forward) [{card}]")
        if set(impls.counts) != {"sorted"}:
            raise SystemExit(f"moe A: the engine's layers ran {impls.counts}; Mixtral's "
                             "drop-free cf 4 picks sorted on one card")
    rng = np.random.default_rng(SEED)
    lengths = (12, 7, 20)
    ids = np.zeros((len(lengths), max(lengths)), np.int32)
    mask = np.zeros_like(ids)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(1, cfg.vocab_size, (n,))
        mask[b, :n] = 1
    new = 16
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = generate(model, ids, attention_mask=mask, max_new_tokens=new, include_prompt=False,
                   device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    again = generate(model, ids, attention_mask=mask, max_new_tokens=new, include_prompt=False,
                     device=device)
    tokens = got.cpu().numpy()
    if tokens.shape != (len(lengths), new) or ((tokens < 0) | (tokens >= cfg.vocab_size)).any() \
            or not torch.equal(got, again):
        raise SystemExit(f"moe A generate: tokens {tokens.tolist()} (shape {tokens.shape}), "
                         "or a second run differs")
    with torch.no_grad():  # each row's first new token: the uncached forward's argmax
        logits = model.apply(model.params, input_ids=torch.tensor(ids, device=device),
                             attention_mask=torch.tensor(mask, device=device))["logits"].float()
    for b, n in enumerate(lengths):
        row = logits[b, n - 1]
        top2 = torch.topk(row, 2).values
        if int(row.argmax()) != int(tokens[b, 0]) and float(top2[0] - top2[1]) > 0.5:
            raise SystemExit(f"moe A generate: row {b}'s first token {tokens[b, 0]} is not the "
                             f"uncached forward's {int(row.argmax())} (top-2 gap "
                             f"{float(top2[0] - top2[1]):.3f})")
    log(f"moe A: generate of a ragged batch {lengths} -> {new} greedy tokens a row in "
        f"{wall:.3f} s ({len(lengths) * new / wall:.1f} tokens/s), the first tokens the uncached "
        f"forward's argmax; tokens {tokens.tolist()}")
    del model, logits
    if device == "cuda":
        free_cuda()
    return launches


def moe_reference_loss(pm, batch, microbatches: int = 0) -> float:
    """``test_utils.training.unsharded_loss``: the function a step of every
    arm of phase 20 must compute on the parameters it holds (its dispatch
    calls not counted)."""
    from accelerate_tpu_torch.test_utils.training import unsharded_loss

    counted_dispatch.paused = True
    try:
        return unsharded_loss(pm, batch, microbatches)
    finally:
        counted_dispatch.paused = False


def moe_op_arm(cf: float, device: str, cut) -> dict:
    """Phase 20 F at one capacity factor: the three back-ends' outputs and
    router losses against einsum's, and each one's forward and backward
    ms."""
    import torch

    from accelerate_tpu_torch.ops import moe

    cfg = mixtral_config(1, cut)
    h, i, E, k = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.moe_top_k
    B, S = MOE_BATCH, MOE_SEQ if cut is None else 64
    g = torch.Generator(device=device)
    g.manual_seed(SEED)

    def randn(*shape, scale=1.0):
        t = torch.randn(shape, generator=g, device=device) * scale
        return t.to(torch.bfloat16).requires_grad_(True)

    x = randn(B, S, h)
    router, wg, wu = randn(h, E, scale=h ** -0.5), randn(E, h, i, scale=h ** -0.5), \
        randn(E, h, i, scale=h ** -0.5)
    wd = randn(E, i, h, scale=i ** -0.5)
    dout = torch.randn((B, S, h), generator=g, device=device).to(torch.bfloat16)
    args = (x, router, wg, wu, wd)
    kw = dict(k=k, capacity_factor=cf)
    outs, times = {}, {}
    cuda = device == "cuda"
    for name, fn in moe.BACKENDS.items():
        with torch.no_grad():
            out, aux = fn(*args, **kw)
        outs[name] = (out.float(), float(aux))
        if cuda:
            with torch.no_grad():
                fwd = cuda_ms(lambda: fn(*args, **kw), iters=5, warmup=1)
            both = cuda_ms(lambda: torch.autograd.backward(fn(*args, **kw)[0], dout), iters=5,
                           warmup=1)
            times[name] = (fwd, both - fwd)
        for t in args:
            t.grad = None
    ref, ref_aux = outs["einsum"]
    real = torch.ones((B, S), device=device)
    errs = {}
    for name, (out, aux) in outs.items():
        errs[name] = (tile_rel_err(out[:, :, None], ref[:, :, None], real),
                      abs(aux - ref_aux) / abs(ref_aux))
        if errs[name][0] > MOE_OP_TILE_REL or errs[name][1] > MOE_OP_TILE_REL:
            raise SystemExit(f"moe F cf {cf}: {name} vs einsum: output tile rel "
                             f"{errs[name][0]:.3e}, aux rel {errs[name][1]:.3e} (pin "
                             f"{MOE_OP_TILE_REL})")
    C = moe.router_capacity(S, E, k, cf)
    log(f"moe F cf {cf}: B{B} S{S} h{h} i{i} E{E} k{k}, capacity {C} a row, bf16; vs einsum "
        f"(output rel per 64-token block, aux rel): "
        + ", ".join(f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in errs.items())
        + ("; ms forward / backward: " + ", ".join(
            f"{n} {t[0]:.3f} / {t[1]:.3f}" for n, t in times.items()) if cuda else ""))
    if cuda:  # the sorted layer's one device-to-host read, on an idle stream
        sizes = torch.zeros((E,), dtype=torch.long, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            sizes.tolist()
        sync_us = (time.perf_counter() - t0) / 100 * 1e6
        log(f"moe F cf {cf}: the sorted layer's group-size read (E={E} int64 to the host) "
            f"takes {sync_us:.1f} us on an idle stream, once a layer; the layer's forward "
            f"{times['sorted'][0]:.3f} ms")
    del args, x, router, wg, wu, wd, outs, ref
    if cuda:
        free_cuda()
    return {"times": times, "errs": errs}


def moe_phase(card: str, device: str = "cuda", cut=None) -> dict:
    """Phase 20; returns the launch counts of its arms (the gather for row
    1, flash for rows 5 and 5b, the fused update for row 4). ``device=
    "cpu"`` with ``cut`` (config fields over Mixtral's) rehearses the
    phase's logic at a small size: the CPU runs no kernel, so no launch is
    checked there, and arm A's engine needs the card."""
    import numpy as np

    from accelerate_tpu_torch import (LoopbackShards, MoELlama, ParallelismConfig,
                                      PipelineParallelPlugin)
    from accelerate_tpu_torch.commands import estimate

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    add(moe_serving_arm(card, device, cut))

    cfg = mixtral_config(MOE_TRAIN_LAYERS, cut)
    probe = MoELlama(cfg, device="cpu")
    n_params, fpt, layers = probe.num_params(), probe.flops_per_token(), cfg.num_hidden_layers
    rng = np.random.default_rng(SEED)
    seq = MOE_SEQ if cut is None else 512
    ids = rng.integers(0, cfg.vocab_size, (MOE_BATCH, seq)).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    tokens = MOE_BATCH * seq

    # The rehearsal computes in f32: at its tiny widths a bf16 step's
    # rounding moves the losses by more than the pins within three steps.
    precision = "bf16" if cut is None else "no"

    def arm(label, kw, steps, **extra):
        with counted_dispatch() as impls:
            run = _tp_arm(cfg, label, kw, batch=batch, steps=steps, device=device,
                          mixed_precision=precision, **extra)
        run["impls"] = impls.counts
        return run

    def reference(pm):
        return moe_reference_loss(pm, batch)

    def held(label, run, pin):
        """Each step's loss against ``moe_reference_loss`` on the
        parameters the arm held at that step (the free-running losses of
        two arms part within a few steps: module docstring, phase 20)."""
        diff = max(abs(x - y) for x, y in zip(run["losses"], run["refs"]))
        if diff > pin or not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"moe {label}: losses {run['losses']} vs the unsharded "
                             f"kernels='off' loss on the same parameters {run['refs']} (max "
                             f"|diff| {diff}, pin {pin})")
        return diff

    # B: the fused step.
    b = arm("B", {}, MOE_STEPS, record_aux=True, reference=reference)
    b_diff = held("B", b, TRAIN_LOSS_ATOL)
    if len(b["aux"]) != MOE_STEPS or not all(math.isfinite(a) and a >= 1 - 1e-3
                                             for a in b["aux"]):
        raise SystemExit(f"moe B: aux_loss {b['aux']}, expected finite and >= 1 - 1e-3 on "
                         f"each of {MOE_STEPS} steps")
    for i, counts in enumerate(b["per_step"]):
        want = {"flash_attention_fwd": layers, "flash_attention_bwd": layers,
                "fused_adamw_update": MOE_LEAVES}
        if cuda and counts != want:
            raise SystemExit(f"moe B step {i}: launches {counts}, expected {want}")
    add(b["counts"])
    mfu = fpt * tokens / b["step_s"] / BF16_OPS_PER_S
    log(f"moe B: Mixtral-8x7B widths, {layers} layers, {n_params / 1e9:.3f}B parameters, bf16 "
        f"compute on f32 masters, adamw(3e-4), clip 1.0, batch {MOE_BATCH}x{seq}; losses "
        f"{[round(x, 4) for x in b['losses']]}, aux_loss {[round(a, 4) for a in b['aux']]}; "
        f"kernels='off' on the same parameters {[round(x, 4) for x in b['refs']]} (max |diff| "
        f"{b_diff:.3e}, pin {TRAIN_LOSS_ATOL}); step {b['step_s'] * 1e3:.1f} ms, "
        f"{tokens / b['step_s']:.0f} tokens/s, active MFU {100 * mfu:.2f}% of 989 TFLOP/s "
        f"({fpt:.4g} FLOP/token, {fpt * tokens / 1e12:.2f} TFLOP a step); back-end calls "
        f"{b['impls']}; launches {b['counts']}; peak memory {b['peak'] / 2**30:.2f} GiB "
        f"[{card}]")

    def apart(run):  # the free-running losses against arm B's, logged, not held
        return max(abs(x - y) for x, y in zip(run["losses"], b["losses"]))

    # C: the imperative loop on B's model and batch.
    c = _imperative_arm(cfg, batch, MOE_SHARD_STEPS, device, precision)
    c_diff = held("C", c, MOE_LOSS_ATOL)
    if cuda and c["counts"].get("fused_adamw_update") != MOE_LEAVES * MOE_SHARD_STEPS:
        raise SystemExit(f"moe C: launches {c['counts']}, expected the update "
                         f"{MOE_LEAVES * MOE_SHARD_STEPS} times")
    add(c["counts"])
    log(f"moe C: imperative loop losses {[round(x, 4) for x in c['losses']]}, aux_loss "
        f"{[round(a, 4) for a in c['aux']]}; the unsharded loss on the same parameters max "
        f"|diff| {c_diff:.3e} (pin {MOE_LOSS_ATOL}); free-running against arm B's max |diff| "
        f"{apart(c):.3e}; launches {c['counts']}")

    # D: ep on one card; E: the router loss through 1F1B at pp 2.
    loop = LoopbackShards(SHARD_RANKS)
    plans = {
        "ep4": dict(parallelism_config=ParallelismConfig(ep_size=4, dp_size=1), loopback=loop),
        "ep2xdp2": dict(parallelism_config=ParallelismConfig(ep_size=2, dp_size=2),
                        loopback=loop),
        "ep2xtp2": dict(parallelism_config=ParallelismConfig(ep_size=2, tp_size=2, dp_size=1),
                        loopback=loop),
        "ep2xfsdp2": dict(parallelism_config=ParallelismConfig(ep_size=2, fsdp_size=2,
                                                               dp_size=1), loopback=loop),
        "E-pp2-1f1b": dict(parallelism_config=ParallelismConfig(pp_size=2, dp_size=1),
                           pp_plugin=PipelineParallelPlugin(2, 2, "1f1b"),
                           loopback=LoopbackShards(2)),
    }
    total = n_params * 4
    want_bytes = {"params": total, "moments": 2 * total, "buffer": total}
    whole = []  # E's unpipelined reference: the router loss of the whole batch

    def piped_reference(pm):
        whole.append(reference(pm))
        return moe_reference_loss(pm, batch, microbatches=2)

    for name, kw in plans.items():
        piped = "pp_plugin" in kw  # the reference's router loss per microbatch too
        run = arm(name, kw, MOE_SHARD_STEPS, reference=piped_reference if piped else reference)
        diff = held(name, run, MOE_LOSS_ATOL)
        sizes = run["sizes"]
        n_data, tp = sizes["dp"] * sizes["fsdp"], sizes["tp"]
        if sizes["pp"] > 1:  # 1F1B: each microbatch's blocks forward, again, and backward
            M = 2
            fwd, bwd = 2 * layers * M, layers * M
        else:  # the loopback's first forward of every data coordinate when rows split
            fwd, bwd = layers * n_data * tp * (2 if n_data > 1 else 1), layers * n_data * tp
        updates = sum(n for n, _ in planned_update_slices(probe, sizes))
        for i, counts in enumerate(run["per_step"]):
            want = {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd,
                    "fused_adamw_update": updates}
            if cuda and counts != want:
                raise SystemExit(f"moe {name} step {i}: launches {counts}, expected {want}")
        if run["distinct"] != want_bytes:
            raise SystemExit(f"moe {name}: the distinct shards over the ranks hold "
                             f"{run['distinct']}, the unsharded model {want_bytes}")
        want_impl = "einsum" if sizes["ep"] > 1 else "sorted"
        if set(run["impls"]) != {want_impl}:
            raise SystemExit(f"moe {name}: back-end calls {run['impls']}, expected "
                             f"{want_impl} only")
        add(run["counts"])
        log(f"moe {name}: mesh {sizes}; losses {[round(x, 4) for x in run['losses']]}; the "
            f"unsharded loss{' of 2 microbatches' if piped else ''} on the same parameters "
            f"{[round(x, 4) for x in run['refs']]} (max "
            f"|diff| {diff:.3e}, pin {MOE_LOSS_ATOL}); free-running against arm B's max |diff| "
            f"{apart(run):.3e}; back-end calls {run['impls']}; update launches {updates} a "
            f"step (the plan's distinct slices); distinct shards {run['distinct']} = the "
            f"unsharded bytes; step {run['step_s'] * 1e3:.1f} ms; peak memory "
            f"{run['peak'] / 2**30:.2f} GiB [{card}]")
        if piped:
            log(f"moe {name}: the unpipelined loss (the router loss of the whole batch) on "
                f"the same parameters {[round(x, 4) for x in whole]}, max |diff| "
                f"{max(abs(x - y) for x, y in zip(run['losses'], whole)):.3e}")

    # F: the dispatch back-ends at the layer's shapes.
    for cf in (4.0, 1.25):
        moe_op_arm(cf, device, cut)

    # G: the memory estimate of the published config.
    import tempfile

    with tempfile.TemporaryDirectory(prefix="moe_estimate_") as tmp:
        path = os.path.join(tmp, "config.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(MIXTRAL_8X7B, f)
        args = estimate.estimate_command_parser().parse_args([path, "--dtypes", "bf16"])
        rows, largest = estimate.gather_data(args)
        out = cli(["estimate-memory", path, "--dtypes", "bf16"])
    if rows[0][2] != 2 * MIXTRAL_8X7B_PARAMS or out.returncode != 0:
        raise SystemExit(f"moe G: estimate bf16 {rows[0][2]} B, expected "
                         f"{2 * MIXTRAL_8X7B_PARAMS} B (rc {out.returncode}: {out.stderr[-2000:]})")
    log(f"moe G: estimate-memory of the Mixtral-8x7B config.json: {MIXTRAL_8X7B_PARAMS} "
        f"parameters, bf16 {rows[0][2]} B ({rows[0][2] / 1e9:.2f} GB), largest block "
        f"{largest[1]!r}; the command prints {out.stdout.strip().splitlines()[-1].split()}")
    log(f"moe: phase 20 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return totals


# ------------------------------------------------------------------ phase 21
def _model_class(cfg):
    """The port's model class of a config: MoELlama, GPTX, GPT2, else
    Llama."""
    import accelerate_tpu_torch as T

    for config_cls, model_cls in ((T.MoELlamaConfig, T.MoELlama), (T.GPTXConfig, T.GPTX),
                                  (T.GPT2Config, T.GPT2)):
        if isinstance(cfg, config_cls):
            return model_cls
    return T.Llama


def write_neox_checkpoint(hf: dict, folder: str, device: str) -> int:
    """Random bf16 weights from the seed in the Hugging Face GPT-NeoX
    layout (its names, its ``(out, in)`` shapes, the per-head interleaved
    ``query_key_value``), as two safetensors shards and their index, written
    a shard at a time; returns the bytes written. Projections are normal
    with std 1/sqrt(fan_in), norm scales about 1, biases about 0."""
    import torch

    from accelerate_tpu_torch.utils.safetensors_io import save_file

    h, inter, L, V = (hf["hidden_size"], hf["intermediate_size"], hf["num_hidden_layers"],
                      hf["vocab_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def normal(shape, scale, center=0.0):
        t = torch.randn(shape, generator=gen, device=device) * scale + center
        return t.to(torch.bfloat16).cpu()

    def layer(i):
        p = f"gpt_neox.layers.{i}."
        out = {}
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[p + norm + ".weight"] = normal((h,), 0.1, 1.0)
            out[p + norm + ".bias"] = normal((h,), 0.1)
        for name, rows, cols in (("attention.query_key_value", 3 * h, h),
                                 ("attention.dense", h, h), ("mlp.dense_h_to_4h", inter, h),
                                 ("mlp.dense_4h_to_h", h, inter)):
            out[p + name + ".weight"] = normal((rows, cols), cols ** -0.5)
            out[p + name + ".bias"] = normal((rows,), 0.02)
        return out

    shards = [(range(0, L // 2), {"gpt_neox.embed_in.weight": None}),
              (range(L // 2, L), {"gpt_neox.final_layer_norm.weight": None,
                                  "gpt_neox.final_layer_norm.bias": None,
                                  "embed_out.weight": None})]
    weight_map, total = {}, 0
    for n, (layers, extra) in enumerate(shards, 1):
        name = f"model-{n:05d}-of-{len(shards):05d}.safetensors"
        tensors = {}
        if "gpt_neox.embed_in.weight" in extra:
            tensors["gpt_neox.embed_in.weight"] = normal((V, h), h ** -0.5)
        for i in layers:
            tensors.update(layer(i))
        if "embed_out.weight" in extra:
            tensors["gpt_neox.final_layer_norm.weight"] = normal((h,), 0.1, 1.0)
            tensors["gpt_neox.final_layer_norm.bias"] = normal((h,), 0.1)
            tensors["embed_out.weight"] = normal((V, h), h ** -0.5)
        save_file(tensors, os.path.join(folder, name), metadata={"format": "pt"})
        total += sum(t.numel() * 2 for t in tensors.values())
        weight_map.update({k: name for k in tensors})
        del tensors
    with open(os.path.join(folder, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(hf, f)
    return total


def check_neox_leaves(params, folder: str, hf: dict) -> int:
    """Sampled leaves of the converted tree (every kind, the first and the
    last layer) against the source tensors rearranged by numpy (the
    de-interleave of ``query_key_value``, the transposes), bitwise; returns
    the leaves checked."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.utils.modeling import _resolve_checkpoint_files, load_state_dict

    sd = {}
    for f in _resolve_checkpoint_files(folder):
        sd.update(load_state_dict(f))
    h, nh, L = hf["hidden_size"], hf["num_attention_heads"], hf["num_hidden_layers"]
    hd = h // nh

    def bits(t):
        return t.detach().cpu().contiguous().view(torch.int16).numpy()

    pairs = [(params["embed"]["wte"], bits(sd["gpt_neox.embed_in.weight"]), "embed/wte"),
             (params["lm_head"]["weight"], bits(sd["embed_out.weight"]).T, "lm_head/weight"),
             (params["ln_f"]["scale"], bits(sd["gpt_neox.final_layer_norm.weight"]), "ln_f"),
             (params["ln_f"]["bias"], bits(sd["gpt_neox.final_layer_norm.bias"]), "ln_f/bias")]
    lay = params["layers"]
    for i in (0, L - 1):
        src = f"gpt_neox.layers.{i}."
        w = bits(sd[src + "attention.query_key_value.weight"])
        b = bits(sd[src + "attention.query_key_value.bias"])
        pairs += [
            (lay["attn"]["w_qkv"][i], w.reshape(nh, 3, hd, h).transpose(1, 0, 2, 3)
             .reshape(3 * h, h).T, f"w_qkv[{i}]"),
            (lay["attn"]["b_qkv"][i], b.reshape(nh, 3, hd).transpose(1, 0, 2).reshape(-1),
             f"b_qkv[{i}]"),
            (lay["attn"]["wo"][i], bits(sd[src + "attention.dense.weight"]).T, f"wo[{i}]"),
            (lay["attn"]["bo"][i], bits(sd[src + "attention.dense.bias"]), f"bo[{i}]"),
            (lay["mlp"]["w_in"][i], bits(sd[src + "mlp.dense_h_to_4h.weight"]).T, f"w_in[{i}]"),
            (lay["mlp"]["b_in"][i], bits(sd[src + "mlp.dense_h_to_4h.bias"]), f"b_in[{i}]"),
            (lay["mlp"]["w_out"][i], bits(sd[src + "mlp.dense_4h_to_h.weight"]).T,
             f"w_out[{i}]"),
            (lay["mlp"]["b_out"][i], bits(sd[src + "mlp.dense_4h_to_h.bias"]), f"b_out[{i}]"),
            (lay["ln_1"]["scale"][i], bits(sd[src + "input_layernorm.weight"]), f"ln_1[{i}]"),
            (lay["ln_1"]["bias"][i], bits(sd[src + "input_layernorm.bias"]), f"ln_1/bias[{i}]"),
            (lay["ln_2"]["scale"][i], bits(sd[src + "post_attention_layernorm.weight"]),
             f"ln_2[{i}]"),
            (lay["ln_2"]["bias"][i], bits(sd[src + "post_attention_layernorm.bias"]),
             f"ln_2/bias[{i}]")]
    for got, want, name in pairs:
        if got.dtype != torch.bfloat16 or not np.array_equal(bits(got), want):
            raise SystemExit(f"gptx A: converted leaf {name} ({got.dtype}) is not the source "
                             "rearranged by numpy, bitwise")
    return len(pairs)


def greedy_agreement(model, prompts, got, want, label: str) -> str:
    """Rows of two greedy continuations of ``prompts``: equal, or parted
    only where the uncached ``kernels="off"`` forward, teacher-forced on the
    common prefix, has a near tie (top-2 gap within ``GREEDY_TIE_REL`` of
    the top logit: a few bf16 steps of a logit the model rounds to bf16).
    Raises otherwise; returns a summary."""
    import torch

    parted = []
    for r, (p, a, b) in enumerate(zip(prompts, got, want)):
        a, b = list(map(int, a)), list(map(int, b))
        if a == b:
            continue
        at = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        ids = torch.tensor([list(map(int, p)) + a[:at]], device=model.device)
        with torch.no_grad():
            row = model.apply(model.params, input_ids=ids, kernels="off")["logits"][0, -1]
        top = torch.topk(row.float(), 2).values
        gap, tie = float(top[0] - top[1]), abs(float(top[0])) * GREEDY_TIE_REL
        if gap > tie:
            raise SystemExit(f"{label}: row {r} parts at new token {at} ({a[at]} vs {b[at]}) "
                             f"where the top-2 gap is {gap:.4f} > {tie:.4f}")
        parted.append(f"row {r} at token {at} (gap {gap:.4f} <= {tie:.4f})")
    return "token-identical" if not parted else "parted at near ties: " + "; ".join(parted)


def _imperative_arm(cfg, batch, steps: int, device: str, precision: str) -> dict:
    """``model(**batch)``, ``backward``, ``clip_grad_norm_``,
    ``optimizer.step()`` on a fresh model from the seed; before each step,
    ``moe_reference_loss`` on its parameters (phase 20 C, phase 21 C)."""
    from accelerate_tpu_torch import Accelerator, adamw
    from accelerate_tpu_torch.ops import registry

    model = _model_class(cfg)(cfg, device=device)
    model.init_params(SEED)
    acc = Accelerator(mixed_precision=precision, device=device)
    pm, po = acc.prepare(model, adamw(3e-4, device=device))
    del model
    registry.reset_launch_counts()
    losses, aux, refs = [], [], []
    for _ in range(steps):
        refs.append(moe_reference_loss(pm, batch))
        out = pm(**batch)
        acc.backward(out["loss"])
        acc.clip_grad_norm_(pm, 1.0)
        po.step()
        po.zero_grad()
        losses.append(float(out["loss"].detach()))
        if "aux_loss" in out:
            aux.append(float(out["aux_loss"].detach()))
    counts = dict(registry.launch_counts)
    del acc, pm, po, out
    if device == "cuda":
        free_cuda()
    return dict(losses=losses, aux=aux, counts=counts, refs=refs)


def gptx_config(hf: dict, family: str, layers: int = None, cut=None):
    """The port's config of a published ``config.json`` through its
    converter, depth cut to ``layers``; ``cut`` (config fields) shrinks it
    for a rehearsal on the CPU."""
    import dataclasses

    from accelerate_tpu_torch.models.convert import _get_converter

    cfg = _get_converter(family)(hf)
    kw = dict(cut or {})
    if layers is not None:
        kw.setdefault("num_hidden_layers", layers)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _launch_check(label, run, want_step, cuda):
    for i, counts in enumerate(run["per_step"]):
        if cuda and counts != want_step:
            raise SystemExit(f"gptx {label} step {i}: launches {counts}, expected {want_step}")


def gptx_serving_arms(card: str, tmp: str, device: str, cut) -> dict:
    """Phase 21 A, B and E on the GPT-NeoX checkpoint; returns the launch
    counts of the engines."""
    import shutil

    import numpy as np
    import torch

    import accelerate_tpu_torch as T
    from accelerate_tpu_torch.big_modeling import StreamedScanModel
    from accelerate_tpu_torch.utils.modeling import (compute_module_sizes,
                                                     convert_file_size_to_int, named_parameters)
    from accelerate_tpu_torch.utils.tree import tree_map

    cuda = device == "cuda"
    hf = dict(PYTHIA_6_9B, **(cut or {}))
    per_layer = 2 * (4 * hf["hidden_size"] ** 2 + 2 * hf["hidden_size"] * hf["intermediate_size"])
    free = min(shutil.disk_usage(tmp).free, _available_host_bytes() // 3)
    fit = min(hf["num_hidden_layers"], int(0.8 * free // per_layer))
    if fit < hf["num_hidden_layers"]:
        log(f"gptx A: depth cut {hf['num_hidden_layers']} -> {fit} layers to fit the disk and "
            "host memory (widths kept)")
        hf["num_hidden_layers"] = fit
    L = hf["num_hidden_layers"]
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    # A: the checkpoint, written here, loaded through the converter.
    ckpt = os.path.join(tmp, "pythia")
    os.makedirs(ckpt)
    nbytes, t_write = _timed(lambda: write_neox_checkpoint(hf, ckpt, device), cuda)
    log(f"gptx A: a random bf16 checkpoint in the Hugging Face GPT-NeoX layout "
        f"(EleutherAI/pythia-6.9b's config.json, {L} layers): {nbytes / 1e9:.2f} GB in 2 "
        f"safetensors shards and an index, written in {t_write:.1f} s")
    (model, params), t_load = _timed(lambda: T.from_hf_checkpoint(
        "gpt_neox", ckpt, hf, dtype=torch.bfloat16, device=device), cuda)
    cfg = model.config
    n_leaves = check_neox_leaves(params, ckpt, hf)
    if (cfg.rotary_dim, cfg.parallel_residual, cfg.hidden_act) != (
            cfg.head_dim // 4, True, "gelu") or model.num_params() * 2 != nbytes:
        raise SystemExit(f"gptx A: converted config {cfg} ({model.num_params()} parameters) "
                         f"does not match the checkpoint's {nbytes} bytes")
    log(f"gptx A: from_hf_checkpoint('gpt_neox', dir, config dict, dtype=bf16) in {t_load:.2f} s "
        f"({nbytes / 1e9 / t_load:.2f} GB/s from the page cache: the shards were just written); "
        f"{model.num_params() / 1e9:.3f}B parameters, rotary_dim {cfg.rotary_dim} of "
        f"{cfg.head_dim}; {n_leaves} sampled leaves bitwise the source rearranged by numpy "
        f"[{card}]")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(1, cfg.vocab_size, (GPTX_BATCH, GPTX_PROMPT)).astype(np.int32)
    ids = torch.as_tensor(prompts, device=device)
    if cuda:
        run = engine_phase(model, None, ("paged_gather",), card)
        add(run["launches"])
        # generate on 4 of the wave's prompts (shared prefix + suffix, none
        # chunked), right-padded, against the engine's tokens for them.
        prefix, suffixes = make_traffic(cfg.vocab_size)
        rows = list(GPTX_ENGINE_ROWS)
        full = [np.concatenate([prefix, suffixes[r]]) for r in rows]
        width = max(p.size for p in full)
        batch = np.zeros((len(rows), width), np.int32)
        mask = np.zeros_like(batch)
        for j, p in enumerate(full):
            batch[j, :p.size], mask[j, :p.size] = p, 1
        new = engine_kwargs()["max_new_tokens"]
        got = T.generate(model, batch, attention_mask=mask, max_new_tokens=new,
                         include_prompt=False).cpu().numpy()
        agree = greedy_agreement(model, full, got, [run["tokens"][r] for r in rows],
                                 "gptx A generate vs engine")
        log(f"gptx A: generate on the wave's requests {rows} ({[p.size for p in full]}-token "
            f"prompts, right-padded) -> {new} tokens: {agree} with the engine's [{card}]")
        # B: int8 weights on A's model.
        run8 = engine_phase(model, None, ("int8_matmul", "paged_gather"), card,
                            matmul_precision="int8")
        want = 4 * L * run8["forwards"]
        if run8["launches"]["int8_matmul"] != want:
            raise SystemExit(f"gptx B: int8_matmul launched {run8['launches']['int8_matmul']} "
                             f"times over {run8['forwards']} forwards, expected {want} (4 "
                             f"projections x {L} layers)")
        add(run8["launches"])
        log(f"gptx B: int8 weights, int8_matmul {want // run8['forwards']} launches a forward "
            f"(4 x {L} layers), tokens identical to the kernels='off' int8 engine's; "
            f"{run8['tokens_per_s']:.1f} tokens/s, TTFT p50 {run8['ttft_s'] * 1e3:.1f} ms "
            f"against {run['tokens_per_s']:.1f} tokens/s, {run['ttft_s'] * 1e3:.1f} ms in bf16 "
            f"[{card}]")
    resident, t_res = _timed(lambda: T.generate(model, ids, max_new_tokens=GPTX_NEW_TOKENS,
                                                include_prompt=False, device=device), cuda)

    # E: the checkpoint's layers streamed from pinned host memory. The tree
    # is A's conversion moved to the host (converting again on the host
    # spends about 28 s on its transposes).
    host = T.GPTX(cfg, device=device)
    host.params, t_host = _timed(lambda: tree_map(lambda t: t.cpu(), params), cuda)
    hparams = host.params
    del model, params
    if cuda:
        free_cuda()
    sizes = compute_module_sizes(hparams)
    card_budget = (convert_file_size_to_int(GPTX_STREAM_CARD) if cut is None
                   else sizes[""] - sizes["layers"] + sizes["layers"] // 4)
    planned = T.infer_auto_device_map(hparams, max_memory={"cuda:0": card_budget,
                                                           "cpu": 2 * sizes[""]})
    if planned.get("layers") != "cpu" or planned.get("embed") != "cuda:0":
        raise SystemExit(f"gptx E: the planner under {card_budget} B gave {planned}")
    # The planner never returns to the card after a block it sent to the
    # host (JAX's behaviour), so the final norm and the head follow the
    # layers there; the streaming runtime takes them on the card, which the
    # budget holds.
    rest = sizes[""] - sizes["layers"]
    if rest > card_budget:
        raise SystemExit(f"gptx E: the blocks beside the layers ({rest} B) exceed the card "
                         f"budget {card_budget}")
    device_map = {k: ("cpu" if k == "layers" else "cuda:0") for k in hparams}
    streamed = T.dispatch_model(host, device_map, main_device=None if cuda else "cpu")
    if not isinstance(streamed, StreamedScanModel):
        raise SystemExit(f"gptx E: dispatch gave {type(streamed).__name__}")
    pinned = all(leaf.is_pinned() for k, leaf in named_parameters(streamed.params).items()
                 if k.startswith("layers."))
    if cuda and not pinned:
        raise SystemExit("gptx E: the host layers are not pinned")
    T.generate(streamed, ids, max_new_tokens=2, device=device)  # first-call costs, untimed
    before = streamed.bytes_streamed
    tokens, t_gen = _timed(lambda: T.generate(streamed, ids, max_new_tokens=GPTX_NEW_TOKENS,
                                              include_prompt=False, device=device), cuda)
    per_token = (streamed.bytes_streamed - before) / GPTX_NEW_TOKENS
    if not torch.equal(tokens.cpu(), resident.cpu()):
        raise SystemExit(f"gptx E: streamed tokens {tokens.tolist()} differ from the resident "
                         f"model's {resident.tolist()}")
    if per_token != sizes["layers"]:
        raise SystemExit(f"gptx E: {per_token} B streamed a token, the layers hold "
                         f"{sizes['layers']} B")
    log(f"gptx E: infer_auto_device_map under {card_budget / 2**30:.2f} GiB for cuda:0 -> "
        f"{planned}; dispatched with the layers on the host (pinned: {pinned}), the rest on "
        f"the card: {type(streamed).__name__}; A's tree copied to the host in {t_host:.2f} s; "
        f"{GPTX_NEW_TOKENS} greedy tokens of {GPTX_BATCH} x {GPTX_PROMPT} prompts identical to "
        f"the resident model's, {t_gen / GPTX_NEW_TOKENS:.3f} s a token (resident "
        f"{t_res / GPTX_NEW_TOKENS:.4f} s), {per_token / 1e9:.2f} GB streamed a token, "
        f"{per_token / 1e9 / (t_gen / GPTX_NEW_TOKENS):.2f} GB/s [{card}]")
    del streamed, host, hparams
    if cuda:
        free_cuda()
    return totals


def gptx_phase(card: str, device: str = "cuda", cut=None) -> dict:
    """Phase 21; returns the launch counts of its arms (the gather for row
    1, the int8 matmul for row 3, flash for rows 5 and 5b, the fused update
    for row 4). ``device="cpu"`` with ``cut`` (config fields over the
    published ones) rehearses the phase's logic at a small size: the CPU
    runs no kernel, so no launch is checked there, and the engines of arms
    A and B need the card."""
    import shutil
    import tempfile

    import numpy as np

    from accelerate_tpu_torch import (GPTX, GPTXConfig, LoopbackShards, ParallelismConfig,
                                      PipelineParallelPlugin, TensorParallelPlugin)
    from accelerate_tpu_torch.commands import estimate

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    precision = "bf16" if cut is None else "no"  # as phase 20's rehearsal
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    tmp = tempfile.mkdtemp(prefix="chip_smoke_gptx_")
    try:
        add(gptx_serving_arms(card, tmp, device, cut))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # C: OPT-30B's widths at 2 layers, the fused step and the imperative loop.
    cfg = gptx_config(OPT_30B, "opt", GPTX_TRAIN_LAYERS, cut)
    probe = _model_class(cfg)(cfg, device="cpu")
    n_params, fpt, layers = probe.num_params(), probe.flops_per_token(), cfg.num_hidden_layers
    leaves = len(_leaf_shapes(probe))
    seq = GPTX_SEQ if cut is None else 64
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (GPTX_TRAIN_BATCH, seq)).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    tokens = GPTX_TRAIN_BATCH * seq
    # f32 masters, the buffer and adamw's two moments (16 B a parameter),
    # the bf16 copies of the step (2 B), activations beside.
    log(f"gptx C: predicted peak {18 * n_params / 2**30:.1f} GiB of parameter state "
        f"({n_params / 1e9:.3f}B parameters x 18 B) plus activations")
    steps = GPTX_STEPS

    def arm(label, kw, cfg_=cfg, batch_=batch, **extra):
        return _tp_arm(cfg_, label, kw, batch=batch_, steps=steps, device=device,
                       mixed_precision=precision, **extra)

    c = arm("C", {})
    c_off = arm("C off", {}, kernels="off")
    want = {"flash_attention_fwd": layers, "flash_attention_bwd": layers,
            "fused_adamw_update": leaves}
    _launch_check("C", c, want, cuda)
    if c_off["counts"] and cuda:
        raise SystemExit(f"gptx C off: launches {c_off['counts']}")
    diff = max(abs(x - y) for x, y in zip(c["losses"], c_off["losses"]))
    if diff > TRAIN_LOSS_ATOL or not all(math.isfinite(x) for x in c["losses"]):
        raise SystemExit(f"gptx C: losses {c['losses']} vs kernels='off' {c_off['losses']} "
                         f"(max |diff| {diff}, pin {TRAIN_LOSS_ATOL})")
    ci = _imperative_arm(cfg, batch, steps, device, precision)
    i_diff = max(abs(x - y) for x, y in zip(ci["losses"], c["losses"]))
    if i_diff > GPTX_IMPERATIVE_ATOL:
        raise SystemExit(f"gptx C imperative: losses {ci['losses']} vs the fused step's "
                         f"{c['losses']} (max |diff| {i_diff}, pin {GPTX_IMPERATIVE_ATOL})")
    if cuda and ci["counts"].get("fused_adamw_update") != leaves * steps:
        raise SystemExit(f"gptx C imperative: launches {ci['counts']}")
    add(c["counts"])
    add(ci["counts"])
    mfu = fpt * tokens / c["step_s"] / BF16_OPS_PER_S
    log(f"gptx C: facebook/opt-30b's widths (hidden {cfg.hidden_size}, {cfg.num_attention_heads} "
        f"heads of {cfg.head_dim}, ffn {cfg.intermediate_size}, relu, learned positions at "
        f"offset {cfg.position_offset}, tied), {layers} layers, {n_params / 1e9:.3f}B "
        f"parameters; batch {GPTX_TRAIN_BATCH}x{seq}, bf16 compute on f32 masters, "
        f"adamw(3e-4), clip 1.0: losses {[round(x, 4) for x in c['losses']]}, kernels='off' "
        f"{[round(x, 4) for x in c_off['losses']]} (max |diff| {diff:.3e}, pin "
        f"{TRAIN_LOSS_ATOL}); imperative loop {[round(x, 4) for x in ci['losses']]} (max "
        f"|diff| {i_diff:.3e} from the fused step's, pin {GPTX_IMPERATIVE_ATOL}); step "
        f"{c['step_s'] * 1e3:.1f} ms, {tokens / c['step_s']:.0f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of 989 TFLOP/s; launches a step {c['per_step'][-1]}; peak memory "
        f"{c['peak'] / 2**30:.2f} GiB (kernels='off' {c_off['peak'] / 2**30:.2f} GiB) [{card}]")

    # F: C's widths on LoopbackShards(4), 4 x 2048.
    f_ids = rng.integers(0, cfg.vocab_size, (GPTX_SHARD_BATCH, seq)).astype(np.int32)
    f_batch = {"input_ids": f_ids, "labels": f_ids}
    f_tokens = GPTX_SHARD_BATCH * seq
    loop = LoopbackShards(4)
    plan = {
        "F0": ({}, None),
        "F tp2xfsdp2": (dict(parallelism_config=ParallelismConfig(tp_size=2, fsdp_size=2),
                             loopback=loop), (4, 1)),
        "F tp4": (dict(tp_plugin=TensorParallelPlugin(4), loopback=loop), (4, 1)),
        "F pp2xdp2 1f1b": (dict(parallelism_config=ParallelismConfig(pp_size=2, dp_size=2),
                                pp_plugin=PipelineParallelPlugin(2, 2, "1f1b"),
                                loopback=loop), (2, 2)),
    }
    f_runs = {}
    total = n_params * 4
    want_bytes = {"params": total, "moments": 2 * total, "buffer": total}
    for name, (kw, shape) in plan.items():
        run = f_runs[name] = arm(name, kw, batch_=f_batch)
        if shape is None:
            fwd = bwd = layers
        elif name.startswith("F pp"):
            units, micro = shape  # 1F1B runs each block's forward again in its backward unit
            fwd, bwd = 2 * layers * micro * units, layers * micro * units
        else:
            fwd = bwd = shape[0] * layers  # once per rank and layer
        updates = sum(n for n, _ in planned_update_slices(probe, run["sizes"]))
        _launch_check(name, run, {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd,
                                  "fused_adamw_update": updates}, cuda)
        if run["distinct"] != want_bytes:
            raise SystemExit(f"gptx {name}: the distinct shards over the ranks hold "
                             f"{run['distinct']}, the unsharded model {want_bytes}")
        add(run["counts"])
        if name == "F0":
            continue
        diff = max(abs(x - y) for x, y in zip(run["losses"], f_runs["F0"]["losses"]))
        if diff > SHARD_LOSS_ATOL:
            raise SystemExit(f"gptx {name}: losses {run['losses']} vs the unsharded step's "
                             f"{f_runs['F0']['losses']} (max |diff| {diff}, pin "
                             f"{SHARD_LOSS_ATOL})")
        mfu = fpt * f_tokens / run["step_s"] / BF16_OPS_PER_S
        log(f"gptx {name}: mesh {run['sizes']}; losses {[round(x, 4) for x in run['losses']]} "
            f"vs unsharded {[round(x, 4) for x in f_runs['F0']['losses']]} (max |diff| "
            f"{diff:.3e}, pin {SHARD_LOSS_ATOL}); step {run['step_s'] * 1e3:.1f} ms (unsharded "
            f"{f_runs['F0']['step_s'] * 1e3:.1f} ms), MFU {100 * mfu:.2f}%; launches a step "
            f"{run['per_step'][-1]} (flash {fwd} + {bwd}, update {updates} distinct slices); "
            f"distinct shards {run['distinct']} = the unsharded bytes; peak "
            f"{run['peak'] / 2**30:.2f} GiB [{card}]")

    # D: GPT-2 XL at full depth, 3 fused steps, then generate.
    g_cfg = gptx_config(GPT2_XL, "gpt2", None, cut)
    g_probe = _model_class(g_cfg)(g_cfg, device="cpu")
    g_layers, g_leaves = g_cfg.num_hidden_layers, len(_leaf_shapes(g_probe))
    g_seq = GPT2_SEQ if cut is None else 64
    g_ids = rng.integers(0, g_cfg.vocab_size, (GPT2_BATCH, g_seq)).astype(np.int32)
    g_batch = {"input_ids": g_ids, "labels": g_ids}
    d = arm("D", {}, cfg_=g_cfg, batch_=g_batch)
    # The plain attention keeps (B, H, S, S) f32 scores for 48 layers; the
    # kernels='off' arm runs with remat (the same numbers, JAX's and the
    # port's remat being exact) to fit beside the optimizer state.
    d_off = arm("D off", {}, cfg_=g_cfg, batch_=g_batch, kernels="off", remat=True)
    _launch_check("D", d, {"flash_attention_fwd": g_layers, "flash_attention_bwd": g_layers,
                           "fused_adamw_update": g_leaves}, cuda)
    diff = max(abs(x - y) for x, y in zip(d["losses"], d_off["losses"]))
    if diff > TRAIN_LOSS_ATOL or not all(math.isfinite(x) for x in d["losses"]):
        raise SystemExit(f"gptx D: losses {d['losses']} vs kernels='off' {d_off['losses']} "
                         f"(max |diff| {diff}, pin {TRAIN_LOSS_ATOL})")
    add(d["counts"])
    g_tokens = GPT2_BATCH * g_seq
    mfu = g_probe.flops_per_token() * g_tokens / d["step_s"] / BF16_OPS_PER_S
    log(f"gptx D: openai-community/gpt2-xl ({g_layers} layers, hidden {g_cfg.hidden_size}, "
        f"{g_cfg.num_attention_heads} heads of {g_cfg.head_dim}), "
        f"{g_probe.num_params() / 1e9:.3f}B parameters; batch {GPT2_BATCH}x{g_seq}: losses "
        f"{[round(x, 4) for x in d['losses']]}, kernels='off' (remat) "
        f"{[round(x, 4) for x in d_off['losses']]} (max |diff| {diff:.3e}, pin "
        f"{TRAIN_LOSS_ATOL}); step {d['step_s'] * 1e3:.1f} ms, {g_tokens / d['step_s']:.0f} "
        f"tokens/s, MFU {100 * mfu:.2f}%; launches a step {d['per_step'][-1]}; peak "
        f"{d['peak'] / 2**30:.2f} GiB [{card}]")
    add(gpt2_generate_arm(g_cfg, card, device))

    # G: sizes.
    for preset, n in CLASSIC_GPT_PARAMS.items():
        family, kw = estimate.PRESETS[preset]
        counted = GPTX(GPTXConfig(**kw), device="cpu").num_params()
        args = estimate.estimate_command_parser().parse_args([preset, "--dtypes", "bf16"])
        rows, largest = estimate.gather_data(args)
        if family != "gptx" or counted != n or rows[0][2] != 2 * n:
            raise SystemExit(f"gptx G: {preset}: {counted} parameters, {rows[0][2]} B in bf16; "
                             f"the JAX package counts {n} ({2 * n} B)")
        log(f"gptx G: estimate-memory {preset}: {n:,} parameters, {rows[0][2] / 1e9:.2f} GB in "
            f"bf16 = num_params x 2 (largest block {largest[1]})")
    log(f"gptx: phase 21 in {time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals


def gpt2_generate_arm(cfg, card: str, device: str) -> dict:
    """Phase 21 D's generation: GPT-2 XL from the seed in bf16, greedy
    ``generate`` of ``GPTX_NEW_TOKENS`` from 4 ragged prompts (passed
    right-padded, as ``generate`` takes them; it rolls them to left padding,
    so each row's positions start at 0 in a shared cache).
    Its cached path launches no kernel (the plain cached attention), so the
    kernels='off' reference is the uncached forward with ``kernels="off"``,
    teacher-forced on the tokens (``greedy_agreement``)."""
    import numpy as np
    import torch

    import accelerate_tpu_torch as T

    cuda = device == "cuda"
    model = T.GPT2(cfg, device=device)
    model.init_params(SEED, dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED + 1)
    lengths = (24, 9, 40, 17)
    width = max(lengths)
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros_like(ids)
    prompts = []
    for b, n in enumerate(lengths):  # right-padded in, rolled to left padding by generate
        p = rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
        ids[b, :n], mask[b, :n] = p, 1
        prompts.append(p)
    from accelerate_tpu_torch.ops import registry

    registry.reset_launch_counts()
    out, t_gen = _timed(lambda: T.generate(model, ids, attention_mask=mask,
                                           max_new_tokens=GPTX_NEW_TOKENS,
                                           include_prompt=False, device=device), cuda)
    counts = dict(registry.launch_counts)
    out = out.cpu().numpy()
    # The reference tokens: greedy decoding by the uncached kernels='off'
    # forward, one token at a time.
    ref = []
    for p in prompts:
        seq = list(map(int, p))
        for _ in range(GPTX_NEW_TOKENS):
            with torch.no_grad():
                logits = model.apply(model.params, input_ids=torch.tensor([seq], device=device),
                                     kernels="off")["logits"][0, -1]
            seq.append(int(logits.float().argmax()))
        ref.append(seq[p.size:])
    agree = greedy_agreement(model, prompts, out, ref, "gptx D generate")
    log(f"gptx D: generate of {len(lengths)} ragged prompts {lengths} (left-aligned in the "
        f"cache) -> {GPTX_NEW_TOKENS} greedy tokens in {t_gen:.3f} s, launches {counts}; "
        f"{agree} with the uncached kernels='off' greedy decode [{card}]")
    del model
    if cuda:
        free_cuda()
    return counts


def _leaf_shapes(model):
    """The parameter leaves of ``model`` as meta tensors (shapes only)."""
    import torch

    from accelerate_tpu_torch.utils.tree import tree_leaves

    probe = type(model)(model.config, device="cpu")
    probe.device = torch.device("meta")
    return tree_leaves(probe.init())


def planned_update_slices(model, sizes: dict, zero: bool = False) -> list:
    """Per leaf of ``model`` on the mesh ``sizes``: ``(slices, elements)``,
    the distinct update slices over the ranks and the elements of one, from
    the sharding plan alone (``parallel/sharding.py``'s planners, which the
    CPU tests hold to the JAX package's), not from the engine under test: a
    leaf's update spec (its ZeRO spec under ``zero``) cuts it into one
    slice per combination of the indices of the axes it names."""
    import torch

    from accelerate_tpu_torch.parallel.sharding import (axes_size, local_leaf_shape,
                                                        plan_param_shardings,
                                                        plan_zero_shardings, spec_axes)
    from accelerate_tpu_torch.utils.tree import tree_leaves

    probe = type(model)(model.config, device="cpu")
    probe.device = torch.device("meta")
    params = probe.init()
    leaves = tree_leaves(params)
    specs = plan_param_shardings(params, sizes, rules=model.sharding_rules())
    if zero:
        specs = plan_zero_shardings(params, specs, sizes)
    return [(axes_size(sizes, tuple(spec_axes(spec))),
             int(math.prod(local_leaf_shape(leaf.shape, spec, sizes))))
            for leaf, spec in zip(leaves, tree_leaves(specs))]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from accelerate_tpu_torch import Llama, LlamaConfig
    from accelerate_tpu_torch.ops.kernels import _build

    if "--launched-worker" in argv:  # phase 19 A's child, under the launcher
        return launched_worker()

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    if "--paged-decode" in argv:
        _build.build(["paged_decode", "paged_gather"])
        card = card_info()
        log(f"build: paged_decode, paged_gather in {time.perf_counter() - t0:.1f} s; device: "
            f"{card}")
        probe = Llama(LlamaConfig.tiny(), device="cuda")  # the geometry needs no 8B weights
        probe.init_params(SEED, dtype=torch.bfloat16)
        paged_decode_phase(LlamaConfig.llama3_8b(), engine_kwargs(), *engine_geometry(probe))
        print(card)
        return 0
    if "--loop" in argv:
        _build.build(["fused_update"])
        card = card_info()
        log(f"build: fused_update in {time.perf_counter() - t0:.1f} s; device: {card}")
        loop_phase(card, profile="--profile" in argv)
        print(card)
        return 0
    if "--checkpoint" in argv:
        _build.build(["fused_update"])
        card = card_info()
        log(f"build: fused_update in {time.perf_counter() - t0:.1f} s; device: {card}")
        checkpoint_phase(card)
        print(card)
        return 0
    if "--fsdp" in argv:
        _build.build(["flash_attention", "fused_update"])
        card = card_info()
        log(f"build: flash_attention, fused_update in {time.perf_counter() - t0:.1f} s; "
            f"device: {card}")
        shard_phase(card)
        print(card)
        return 0
    if "--precision" in argv:
        _build.build(["flash_attention", "fused_update", "int8_matmul"])
        card = card_info()
        log(f"build: flash_attention, fused_update, int8_matmul in "
            f"{time.perf_counter() - t0:.1f} s; device: {card}")
        precision_rows, _ = precision_phase(card)
        log(f"phase 14 rows: {json.dumps(precision_rows)}")
        print(card)
        return 0
    if "--tp" in argv:
        _build.build(["flash_attention", "fused_update"])
        card = card_info()
        log(f"build: flash_attention, fused_update in {time.perf_counter() - t0:.1f} s; "
            f"device: {card}")
        log(f"phase 15 launches: {tp_phase(card)}")
        print(card)
        return 0
    if "--pp" in argv:
        _build.build(["flash_attention", "fused_update"])
        card = card_info()
        log(f"build: flash_attention, fused_update in {time.perf_counter() - t0:.1f} s; "
            f"device: {card}")
        log(f"phase 16 launches: {pp_phase(card)}")
        print(card)
        return 0
    if "--big-model" in argv:
        _build.build(["flash_attention"])
        card = card_info()
        log(f"build: flash_attention in {time.perf_counter() - t0:.1f} s; device: {card}")
        log(f"phase 17 launches: {big_model_phase(card)}")
        print(card)
        return 0
    if "--cv" in argv:
        card = card_info()
        log(f"device: {card} (the CV examples launch no kernel of the port)")
        cv_phase(card)
        print(card)
        return 0
    if "--launch" in argv:
        _build.build(["fused_update"])
        card = card_info()
        log(f"build: fused_update in {time.perf_counter() - t0:.1f} s; device: {card}")
        log(f"phase 19 launches: {launch_phase(card)}")
        print(card)
        return 0
    if "--moe" in argv:
        _build.build(["flash_attention", "fused_update", "paged_gather"])
        card = card_info()
        log(f"build: flash_attention, fused_update, paged_gather in "
            f"{time.perf_counter() - t0:.1f} s; device: {card}")
        log(f"phase 20 launches: {moe_phase(card)}")
        print(card)
        return 0
    if "--gptx" in argv:
        _build.build(["flash_attention", "fused_update", "paged_gather", "int8_matmul"])
        card = card_info()
        log(f"build: flash_attention, fused_update, paged_gather, int8_matmul in "
            f"{time.perf_counter() - t0:.1f} s; device: {card}")
        log(f"phase 21 launches: {gptx_phase(card)}")
        print(card)
        return 0
    if "--splash-times" in argv:
        _build.build(["splash_attention"])
        card = card_info()
        log(f"build: splash_attention in {time.perf_counter() - t0:.1f} s; device: {card}")
        print(json.dumps({"splash_times": splash_times(), "card": card}))
        return 0
    logs = _build.build(ptxas_info=True)
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"build[{name}]: {line}")
    for name in ("flash_attention", "splash_attention", "int8_matmul", "paged_decode"):
        summary = ptxas_summary(logs.get(name, ""))
        for line in summary:
            log(f"build[{name}] summary: {line}")
        check_no_spills(summary, name)
        for fn, reg in sass_registers(_build.library_path(name)).items():
            log(f"build[{name}] sass: {fn}: highest register R{reg}")
    card = card_info()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    cfg = LlamaConfig.llama3_8b()
    model = Llama(cfg, device="cuda")
    t0 = time.perf_counter()
    model.init_params(SEED, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"model: Llama-3-8B widths, {cfg.num_hidden_layers} layers, bf16, "
          f"{model.num_params() / 1e9:.2f}B params, random init (seed {SEED}) in "
          f"{time.perf_counter() - t0:.1f} s")

    blocks, max_blocks = engine_geometry(model)
    rows = op_phase(cfg, engine_kwargs(), blocks, max_blocks)
    int8_row = int8_op_phase()
    rows += paged_decode_phase(cfg, engine_kwargs(), blocks, max_blocks)
    bf16_run = engine_phase(model, None, ("paged_gather",), card)
    rows[0]["launches"] = bf16_run["launches"]["paged_gather"]
    rows[1]["launches"] = engine_phase(model, "int8", ("paged_gather_dequant",),
                                       card)["launches"]["paged_gather_dequant"]
    int8_run = int8_engine_phase(model, card, bf16_run)
    int8_row["launches"] = int8_run["launches"]["int8_matmul"]
    rows.append(int8_row)
    reference_phase(model)
    if "--profile" in argv:
        profile_wave(model, "bf16")
        profile_wave(model, "int8", kv_quant="int8", matmul_precision="int8")
    del model  # free the 16 GB serving model before training
    free_cuda()

    train_rows = flash_op_phase() + update_op_phase(LlamaConfig.llama3_8b(**TRAIN_CUT))
    counts = train_phase(card)
    for row in train_rows:
        row["launches"] = counts.get(row["name"], 0)
    rows += train_rows
    if "--profile" in argv:
        profile_train_step(LlamaConfig.llama3_8b(**TRAIN_CUT), (TRAIN_BATCH, TRAIN_SEQ), "train")
    free_cuda()

    splash_rows = splash_op_phase()
    counts = gemma2_train_phase(card)
    for row in splash_rows:
        row["launches"] = counts.get(row["name"], 0)
    rows += splash_rows
    if "--profile" in argv:
        profile_train_step(gemma2_config(GEMMA2_LAYERS), (GEMMA2_BATCH, GEMMA2_SEQ), "gemma2")
    free_cuda()

    rows += ring_phase()
    free_cuda()

    loop_counts = loop_phase(card, profile="--profile" in argv)
    free_cuda()
    ckpt_counts = checkpoint_phase(card)
    free_cuda()
    shard_counts = shard_phase(card)
    free_cuda()
    precision_rows, precision_counts = precision_phase(card)
    free_cuda()
    tp_counts = tp_phase(card)
    free_cuda()
    pp_counts = pp_phase(card)
    free_cuda()
    big_counts = big_model_phase(card)
    free_cuda()
    cv_counts = cv_phase(card)
    free_cuda()
    launch_counts = launch_phase(card)
    free_cuda()
    moe_counts = moe_phase(card)
    free_cuda()
    gptx_counts = gptx_phase(card)
    for row in rows:  # phase 3's or 7's launches plus those of phases 11 to 21
        later = [counts.get(row["name"], 0) for counts in (loop_counts, ckpt_counts,
                                                           shard_counts, precision_counts,
                                                           tp_counts, pp_counts, big_counts,
                                                           cv_counts, launch_counts,
                                                           moe_counts, gptx_counts)]
        if any(later):
            log(f"kernel {row['name']}: {row['launches']} launches in phase 3 or 7, "
                + ", ".join(f"{n} in phase {ph}" for n, ph in zip(later, range(11, 22))))
            row["launches"] += sum(later)
    for row in precision_rows:  # phase 14's launches plus phase 15's fp16 arms'
        if tp_counts.get(row["name"]):
            log(f"kernel {row['name']}: {row['launches']} launches in phase 14, "
                f"{tp_counts[row['name']]} in phase 15")
            row["launches"] += tp_counts[row["name"]]
    rows += precision_rows
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
