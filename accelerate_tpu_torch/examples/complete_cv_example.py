"""The complete CV example — the port's ``examples/complete_cv_example.py``.

The loop of ``cv_example.py`` with what a long run needs: trackers
(``--with_tracking``: the accuracy and loss once an epoch), ``save_state``
every N steps or every epoch (``--checkpointing_steps``), and ``load_state``
to go on from a checkpoint (``--resume_from_checkpoint``, a folder or the
newest ``step_*`` / ``epoch_*`` one). The prepared loaders are stateful:
after ``load_state`` the next pass over ``train_dl`` goes on at the batch
after the checkpoint, in the interrupted epoch's order.

Run::

    python -m accelerate_tpu_torch.examples.complete_cv_example --checkpointing_steps epoch
    python -m accelerate_tpu_torch.examples.complete_cv_example --cpu \\
        --checkpointing_steps 16 --output_dir out
    python -m accelerate_tpu_torch.examples.complete_cv_example --cpu \\
        --resume_from_checkpoint out/step_48 --output_dir out
"""

from __future__ import annotations

import argparse
import os

from accelerate_tpu_torch import (
    Accelerator,
    ConvNetConfig,
    ConvNetForImageClassification,
    cosine_decay_schedule,
    inject_hyperparams,
    set_seed,
)
from accelerate_tpu_torch.examples.cv_example import NUM_CLASSES, get_dataloaders
from accelerate_tpu_torch.optim import adam
from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration


def training_function(config, args):
    project_config = ProjectConfiguration(
        project_dir=args.output_dir, logging_dir=os.path.join(args.output_dir, "logs"))
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu,
                              log_with="all" if args.with_tracking else None,
                              project_config=project_config)
    if args.with_tracking:
        accelerator.init_trackers("complete_cv_example", config)

    lr, num_epochs, batch_size = config["lr"], config["num_epochs"], config["batch_size"]
    set_seed(config["seed"], device=accelerator.device)  # also the shuffle order

    model = ConvNetForImageClassification(ConvNetConfig(num_classes=NUM_CLASSES, widths=(32, 64)),
                                          device=accelerator.device)
    model.init_params(config["seed"])

    train_dl, eval_dl = get_dataloaders(batch_size)
    train_dl, eval_dl = accelerator.prepare(train_dl, eval_dl)
    schedule = cosine_decay_schedule(lr, num_epochs * len(train_dl), alpha=0.1)
    optimizer = inject_hyperparams(adam)(learning_rate=lr, device=accelerator.device)
    model, optimizer, scheduler = accelerator.prepare(model, optimizer, schedule)

    # ---------------------------------------------------------------- resume
    starting_epoch = 0
    resume_step = None
    if args.resume_from_checkpoint:
        ckpt_path = args.resume_from_checkpoint
        if ckpt_path in (True, "latest", ""):
            dirs = [os.path.join(args.output_dir, d) for d in os.listdir(args.output_dir)
                    if d.startswith(("epoch_", "step_"))]
            ckpt_path = max(dirs, key=os.path.getmtime)  # the newest
        accelerator.print(f"Resumed from checkpoint: {ckpt_path}")
        # Restores the model, optimizer, scheduler, random streams and the
        # loaders' positions: train_dl goes on mid-epoch by itself.
        accelerator.load_state(ckpt_path)
        training_difference = os.path.splitext(os.path.basename(ckpt_path))[0]
        if "epoch" in training_difference:
            starting_epoch = int(training_difference.replace("epoch_", "")) + 1
        else:
            resume_step = int(training_difference.replace("step_", ""))
            starting_epoch = resume_step // len(train_dl)
            resume_step -= starting_epoch * len(train_dl)

    overall_step = starting_epoch * len(train_dl)
    accuracy = 0.0
    for epoch in range(starting_epoch, num_epochs):
        model.train()
        train_dl.set_epoch(epoch)
        total_loss = 0.0
        if args.resume_from_checkpoint and epoch == starting_epoch and resume_step is not None:
            overall_step += resume_step  # the stateful loader skips these itself
        for batch in train_dl:
            with accelerator.accumulate(model):
                outputs = model(**batch)
                loss = outputs["loss"]
                total_loss += float(loss.detach())
                accelerator.backward(loss)
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad()
            overall_step += 1
            if (isinstance(args.checkpointing_steps, int)
                    and overall_step % args.checkpointing_steps == 0):
                accelerator.save_state(os.path.join(args.output_dir, f"step_{overall_step}"))

        model.eval()
        correct = total = 0
        for batch in eval_dl:
            labels = batch.pop("labels")
            preds = model(**batch)["logits"].argmax(-1)
            preds, refs = accelerator.gather_for_metrics((preds, labels))
            correct += int((preds == refs).sum())
            total += len(refs)
        accuracy = correct / total
        accelerator.print(f"epoch {epoch}: accuracy {accuracy:.3f}")
        if args.with_tracking:
            accelerator.log({"accuracy": accuracy,
                             "train_loss": total_loss / max(len(train_dl), 1),
                             "epoch": epoch}, step=overall_step)
        if args.checkpointing_steps == "epoch":
            accelerator.save_state(os.path.join(args.output_dir, f"epoch_{epoch}"))

    accelerator.end_training()
    return accuracy


def main(argv=None):
    parser = argparse.ArgumentParser(description="accelerate_tpu_torch complete cv example")
    parser.add_argument("--mixed_precision", default="no", choices=["no", "bf16", "fp16"])
    parser.add_argument("--num_epochs", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--output_dir", default=".accelerate_example_output")
    parser.add_argument("--checkpointing_steps", default=None,
                        help='Save state every N steps (int) or "epoch".')
    parser.add_argument("--resume_from_checkpoint", default=None, nargs="?", const="latest",
                        help='Checkpoint folder to resume from, or "latest".')
    parser.add_argument("--with_tracking", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    if args.checkpointing_steps is not None and args.checkpointing_steps != "epoch":
        args.checkpointing_steps = int(args.checkpointing_steps)
    os.makedirs(args.output_dir, exist_ok=True)
    config = {"lr": 3e-3, "num_epochs": args.num_epochs, "seed": 42,
              "batch_size": args.batch_size}
    return training_function(config, args)


if __name__ == "__main__":
    main()
