"""Per-architecture train steps — the counterpart of
``accelerate_tpu/train_steps.py:25-142``.

A train step is an architecture's batch contract and loss, handed to
``Accelerator.build_train_step(loss_fn=...)`` (or ``build_train_window``)::

    step_def = GPTTrainStep()
    step = accelerator.build_train_step(model, opt, loss_fn=step_def.loss_fn)
    loss = step(step_def.get_batch(raw))

Each ``loss_fn(outputs, batch)`` returns the model's own loss when it
computed one (labels in the batch), else the architecture's loss from the
logits, in f32 (``ops/losses.py``).
"""

from __future__ import annotations

import torch

from .ops.losses import cross_entropy_loss


def mse_loss(pred, target):
    """Mean squared error in f32 (JAX ``ops/losses.py:341``)."""
    return torch.mean(torch.square(pred.float() - target.float()))


def _has_loss(outputs) -> bool:
    return "loss" in outputs and outputs["loss"] is not None


class AbstractTrainStep:
    """The base: ``batch_keys`` is the batch contract, ``loss_fn`` the loss."""

    name = "abstract"
    batch_keys: tuple = ()

    def get_batch(self, data: dict) -> dict:
        """The raw example dict cut to the model's batch contract."""
        return {k: data[k] for k in self.batch_keys if k in data}

    def loss_fn(self, outputs, batch):
        raise NotImplementedError


class GPTTrainStep(AbstractTrainStep):
    """Causal LM: next-token cross-entropy with ignore-index masking; the
    shift lives here, so a model may return aligned logits."""

    name = "gpt"
    batch_keys = ("input_ids", "labels", "attention_mask")

    def __init__(self, z_loss: float = 0.0, label_smoothing: float = 0.0):
        self.z_loss = z_loss
        self.label_smoothing = label_smoothing

    def get_batch(self, data: dict) -> dict:
        batch = super().get_batch(data)
        if "labels" not in batch:
            batch["labels"] = batch["input_ids"]
        return batch

    def loss_fn(self, outputs, batch):
        if _has_loss(outputs):
            if self.z_loss or self.label_smoothing:
                # The model computed its loss in-graph (the fused head never
                # makes logits): the step's regularizers cannot apply.
                raise ValueError(
                    "GPTTrainStep(z_loss/label_smoothing) cannot be applied: the "
                    "model already computed its loss in-graph (fused_loss head or "
                    "in-model labels). Configure the regularizer on the model "
                    "config, or run the dense head without in-model labels.")
            return outputs["loss"]
        logits = outputs["logits"][:, :-1]
        labels = batch["labels"][:, 1:]
        mask = batch.get("attention_mask")
        if mask is not None:
            labels = torch.where(mask[:, 1:].bool(), labels, torch.full_like(labels, -100))
        return cross_entropy_loss(logits, labels, z_loss=self.z_loss,
                                  label_smoothing=self.label_smoothing)


class BertTrainStep(AbstractTrainStep):
    """BERT: masked-LM loss over token logits (padding masked), or the
    classification loss over sequence logits, plus the next-sentence loss
    when the model emits ``seq_logits`` and the batch has its label."""

    name = "bert"
    batch_keys = ("input_ids", "attention_mask", "token_type_ids", "labels",
                  "next_sentence_label")

    def loss_fn(self, outputs, batch):
        if _has_loss(outputs):
            return outputs["loss"]
        logits, labels = outputs["logits"], batch["labels"]
        mask = batch.get("attention_mask")
        if logits.dim() == 3 and mask is not None:  # MLM: [B, S, V] vs token labels
            labels = torch.where(mask.bool(), labels, torch.full_like(labels, -100))
        loss = cross_entropy_loss(logits, labels)
        nsl = batch.get("next_sentence_label")
        if nsl is not None and "seq_logits" in outputs:
            loss = loss + cross_entropy_loss(outputs["seq_logits"], nsl)
        return loss


class T5TrainStep(AbstractTrainStep):
    """Seq2seq: encoder and decoder batch keys, decoder-token cross-entropy."""

    name = "t5"
    batch_keys = ("input_ids", "attention_mask", "decoder_input_ids", "decoder_attention_mask",
                  "labels")

    def loss_fn(self, outputs, batch):
        if _has_loss(outputs):
            return outputs["loss"]
        return cross_entropy_loss(outputs["logits"], batch["labels"])


class RegressionTrainStep(AbstractTrainStep):
    """Mean squared error of ``prediction`` against ``y``."""

    name = "regression"
    batch_keys = ("x", "y")

    def loss_fn(self, outputs, batch):
        if _has_loss(outputs):
            return outputs["loss"]
        return mse_loss(outputs["prediction"], batch["y"])


TRAIN_STEPS = {cls.name: cls for cls in (GPTTrainStep, BertTrainStep, T5TrainStep,
                                         RegressionTrainStep)}


def get_train_step(name: str) -> AbstractTrainStep:
    """The train step registered under ``name``."""
    if name not in TRAIN_STEPS:
        raise ValueError(f"Unknown train step {name!r}; available: {sorted(TRAIN_STEPS)}")
    return TRAIN_STEPS[name]()
