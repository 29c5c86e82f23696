"""Image classification with the convnet — the port's ``examples/cv_example.py``.

The JAX package's example (a timm resnet50 fine-tuned on a pet-image folder
in the reference): ``get_dataloaders`` → ``training_function`` → ``main``,
the canonical loop over prepared objects::

    model, optimizer, scheduler = accelerator.prepare(model, optimizer, schedule)
    for batch in train_dl:
        with accelerator.accumulate(model):
            outputs = model(**batch); accelerator.backward(outputs["loss"])
            optimizer.step(); scheduler.step(); optimizer.zero_grad()

The data is the JAX package's synthetic ``ColorBlobDataset``, built from a
seed with numpy (nothing is downloaded): each 32 x 32 image is noise with an
8 x 8 square of one of four colors at a random place, and the label is the
color. ``inject_hyperparams(adam)`` under the cosine schedule runs the
reference chain, as in the JAX package, so the loop launches no fused
update.

Run::

    python -m accelerate_tpu_torch.examples.cv_example                  # on the card
    python -m accelerate_tpu_torch.examples.cv_example --mixed_precision bf16
    python -m accelerate_tpu_torch.examples.cv_example --cpu            # on the CPU
"""

from __future__ import annotations

import argparse

import numpy as np
import torch.utils.data as tud

from accelerate_tpu_torch import (
    Accelerator,
    ConvNetConfig,
    ConvNetForImageClassification,
    cosine_decay_schedule,
    inject_hyperparams,
    set_seed,
)
from accelerate_tpu_torch.optim import adam

IMAGE_SIZE = 32
NUM_CLASSES = 4

_BLOB_COLORS = np.array(
    [[2.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 2.0], [1.5, 1.5, 0.0]], np.float32)


class ColorBlobDataset:
    """``size`` NHWC images of noise with an 8 x 8 colored square at a random
    position; the label is which of 4 colors (the JAX package's dataset,
    draw for draw)."""

    def __init__(self, size, seed):
        rng = np.random.default_rng(seed)
        imgs = 0.3 * rng.standard_normal((size, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
        labels = rng.integers(0, NUM_CLASSES, size).astype(np.int32)
        for i in range(size):
            y = int(rng.integers(0, IMAGE_SIZE - 8))
            x = int(rng.integers(0, IMAGE_SIZE - 8))
            imgs[i, y: y + 8, x: x + 8, :] += _BLOB_COLORS[labels[i]]
        self.imgs, self.labels = imgs, labels

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"pixel_values": self.imgs[i], "labels": self.labels[i]}


def collate(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def get_dataloaders(batch_size, train_size=1024, eval_size=256):
    """Torch ``DataLoader``s over the two splits; ``prepare`` shards them."""
    train_dl = tud.DataLoader(ColorBlobDataset(train_size, seed=0), batch_size=batch_size,
                              shuffle=True, drop_last=True, collate_fn=collate)
    eval_dl = tud.DataLoader(ColorBlobDataset(eval_size, seed=1), batch_size=batch_size,
                             shuffle=False, drop_last=True, collate_fn=collate)
    return train_dl, eval_dl


def training_function(config, args):
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    lr, num_epochs, batch_size = config["lr"], config["num_epochs"], config["batch_size"]
    set_seed(config["seed"], device=accelerator.device)  # also the shuffle order

    model = ConvNetForImageClassification(ConvNetConfig(num_classes=NUM_CLASSES, widths=(32, 64)),
                                          device=accelerator.device)
    model.init_params(config["seed"])

    train_dl, eval_dl = get_dataloaders(batch_size)
    # Loaders first: the schedule's horizon counts global optimizer steps,
    # which is the prepared loader's length.
    train_dl, eval_dl = accelerator.prepare(train_dl, eval_dl)
    schedule = cosine_decay_schedule(lr, num_epochs * len(train_dl), alpha=0.1)
    optimizer = inject_hyperparams(adam)(learning_rate=lr, device=accelerator.device)
    model, optimizer, scheduler = accelerator.prepare(model, optimizer, schedule)

    accuracy = 0.0
    for epoch in range(num_epochs):
        model.train()
        train_dl.set_epoch(epoch)
        for batch in train_dl:
            with accelerator.accumulate(model):
                outputs = model(**batch)
                accelerator.backward(outputs["loss"])
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad()

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
    accelerator.end_training()
    return accuracy


def main(argv=None):
    parser = argparse.ArgumentParser(description="accelerate_tpu_torch cv example")
    parser.add_argument("--mixed_precision", default="no", choices=["no", "bf16", "fp16"])
    parser.add_argument("--num_epochs", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    config = {"lr": 3e-3, "num_epochs": args.num_epochs, "seed": 42,
              "batch_size": args.batch_size}
    acc = training_function(config, args)
    assert acc > 0.9, f"model failed to learn (accuracy {acc:.3f})"
    return acc


if __name__ == "__main__":
    main()
