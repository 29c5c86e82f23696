"""The canonical Accelerate loop on BERT — the port's ``examples/nlp_example.py``.

The same loop, dataset and check as the JAX package's example (bert-base on
GLUE/MRPC in the reference): ``get_dataloaders`` → ``training_function`` →
``main``, over prepared objects::

    model, optimizer, scheduler = accelerator.prepare(model, optimizer, schedule)
    for batch in train_dl:
        with accelerator.accumulate(model):
            outputs = model(**batch); accelerator.backward(outputs["loss"])
            optimizer.step(); scheduler.step(); optimizer.zero_grad()

The data is synthetic: token sequences whose label says whether segment A and
segment B open with the same key token, a task a 2-layer attention model
learns to more than 0.8 accuracy in a few epochs. The loaders are torch
``DataLoader``s whose collate returns numpy arrays, and go through
``prepare``, so each rank gets its shard as tensors on its device.

Run::

    python -m accelerate_tpu_torch.examples.nlp_example          # on the card
    python -m accelerate_tpu_torch.examples.nlp_example --cpu    # on the CPU
    accelerate-tpu-torch launch --num_processes 4 -m accelerate_tpu_torch.examples.nlp_example
"""

from __future__ import annotations

import argparse

import numpy as np
import torch.utils.data as tud

from accelerate_tpu_torch import (
    Accelerator,
    BertConfig,
    BertForSequenceClassification,
    inject_hyperparams,
    linear_schedule,
    set_seed,
    tqdm,
)
from accelerate_tpu_torch.optim import adamw

SEQ_LEN = 16
NUM_KEYS = 8  # key symbols are the token ids [5, 5 + NUM_KEYS)


class KeyMatchDataset:
    """A map-style synthetic dataset of ``size`` examples of ``seq_len``
    tokens: each half opens with a key symbol, and the label is whether the
    two keys match (positives share it, negatives are forced to differ)."""

    def __init__(self, size, vocab_size, seed, seq_len: int = SEQ_LEN):
        seg = seq_len // 2
        rng = np.random.default_rng(seed)
        ids = rng.integers(5 + NUM_KEYS, vocab_size, (size, seq_len)).astype(np.int32)
        labels = rng.integers(0, 2, (size,)).astype(np.int32)
        key_a = rng.integers(0, NUM_KEYS, size)
        ids[:, 0] = 5 + key_a
        ids[:, seg] = 5 + np.where(
            labels == 1, key_a, (key_a + 1 + rng.integers(0, NUM_KEYS - 1, size)) % NUM_KEYS)
        self.ids = ids
        self.labels = labels
        self.token_type = np.concatenate(
            [np.zeros((size, seg), np.int32), np.ones((size, seq_len - seg), np.int32)], axis=1)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "token_type_ids": self.token_type[i],
                "labels": self.labels[i]}


def collate(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def get_dataloaders(batch_size, vocab_size, train_size=2048, eval_size=512, seq_len=SEQ_LEN,
                    eval_drop_last=True):
    """Torch ``DataLoader``s over the two splits; ``prepare`` shards them."""
    train_ds = KeyMatchDataset(train_size, vocab_size, seed=42, seq_len=seq_len)
    eval_ds = KeyMatchDataset(eval_size, vocab_size, seed=7, seq_len=seq_len)
    train_dl = tud.DataLoader(train_ds, batch_size=batch_size, shuffle=True, drop_last=True,
                              collate_fn=collate)
    eval_dl = tud.DataLoader(eval_ds, batch_size=batch_size, shuffle=False,
                             drop_last=eval_drop_last, collate_fn=collate)
    return train_dl, eval_dl


def training_function(config, args):
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    lr, num_epochs, batch_size = config["lr"], config["num_epochs"], config["batch_size"]
    set_seed(config["seed"], device=accelerator.device)  # also the shuffle order

    model_cfg = BertConfig.tiny(vocab_size=config["vocab_size"], max_position_embeddings=SEQ_LEN,
                                hidden_dropout_prob=0.0)
    model = BertForSequenceClassification(model_cfg, device=accelerator.device)
    model.init_params(config["seed"])

    train_dl, eval_dl = get_dataloaders(batch_size, config["vocab_size"])
    # Loaders first: the schedule's horizon counts global optimizer steps,
    # which is the prepared loader's length.
    train_dl, eval_dl = accelerator.prepare(train_dl, eval_dl)
    schedule = linear_schedule(lr, 0.1 * lr, num_epochs * len(train_dl))
    # A constant learning rate inside the transform; the scheduler writes the
    # schedule's value into it after every real optimizer step.
    optimizer = inject_hyperparams(adamw)(learning_rate=lr, device=accelerator.device)
    model, optimizer, scheduler = accelerator.prepare(model, optimizer, schedule)

    accuracy = 0.0
    for epoch in range(num_epochs):
        model.train()
        train_dl.set_epoch(epoch)
        for batch in tqdm(train_dl, main_process_only=True, desc=f"epoch {epoch}"):
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
    parser = argparse.ArgumentParser(description="accelerate_tpu_torch nlp example")
    parser.add_argument("--mixed_precision", default="no", choices=["no", "bf16"])
    parser.add_argument("--num_epochs", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    config = {"lr": 1e-3, "num_epochs": args.num_epochs, "seed": 42,
              "batch_size": args.batch_size, "vocab_size": 128}
    acc = training_function(config, args)
    assert acc > 0.8, f"model failed to learn (accuracy {acc:.3f})"
    return acc


if __name__ == "__main__":
    main()
