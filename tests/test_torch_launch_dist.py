"""The launcher on four cards: one process per card over NCCL.

JAX-free: the card's machine, which has no JAX, runs it with ``python -m
pytest tests/test_torch_launch_dist.py -m cuda --noconftest -s``. Skipped
below four cards. Both cases go through ``python -m
accelerate_tpu_torch.commands.accelerate_cli launch``, the
``accelerate-tpu-torch`` entry point, from the repository root:

- ``launch --num_processes 4 -m accelerate_tpu_torch.test_utils.test_script``
  prints "All distributed asserts passed.", each rank on its own
  ``torch.cuda.current_device()`` (the script asserts it);
- ``launch --num_processes 4`` of a loop over the port's
  ``examples/nlp_example.py`` model and data under a constant adamw (dp 4,
  bf16) learns the task on every rank, with the fused adamw update launched
  on every rank (the example's own schedule runs the reference chain);
- ``notebook_launcher(fn, num_processes=4, mixed_precision="bf16")``: each
  process's ``Accelerator()`` is its own card's rank of a 4-rank NCCL job
  in bf16, and a sum over the ranks is right on every rank.

The same commands with ``--cpu`` run 4 gloo ranks on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CARDS = 4

NLP_WRAPPER = """
import json, os
import torch
from accelerate_tpu_torch import Accelerator, BertConfig, BertForSequenceClassification, set_seed
from accelerate_tpu_torch.examples import nlp_example
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.optim import adamw

# The example's model and data under a constant adamw, which runs the fused
# update (the example's own linear schedule runs the reference chain).
acc = Accelerator()
set_seed(42, device=acc.device)
model = BertForSequenceClassification(
    BertConfig.tiny(vocab_size=128, max_position_embeddings=nlp_example.SEQ_LEN,
                    hidden_dropout_prob=0.0), device=acc.device)
model.init_params(42)
train_dl, eval_dl = acc.prepare(*nlp_example.get_dataloaders(32, 128))
model, optimizer = acc.prepare(model, adamw(1e-3, device=acc.device))
for epoch in range(5):
    model.train()
    train_dl.set_epoch(epoch)
    for batch in train_dl:
        acc.backward(model(**batch)["loss"])
        optimizer.step()
        optimizer.zero_grad()
model.eval()
correct = total = 0
for batch in eval_dl:
    labels = batch.pop("labels")
    preds, refs = acc.gather_for_metrics((model(**batch)["logits"].argmax(-1), labels))
    correct += int((preds == refs).sum())
    total += len(refs)
rank = int(os.environ["RANK"])
with open(os.path.join(os.path.dirname(__file__), f"rank{rank}.json"), "w") as f:
    json.dump({"rank": rank, "accuracy": correct / total, "card": torch.cuda.current_device(),
               "launches": dict(registry.launch_counts)}, f)
"""


def _cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        pytest.skip(f"needs {CARDS} NVIDIA GPUs")
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    print(f"cards: {cards}")


def _launch(*args, timeout=900):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli",
                          "launch", "--num_processes", str(CARDS), *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    print(out.stdout[-4000:])
    assert out.returncode == 0, out.stderr[-6000:]
    return out.stdout


@pytest.mark.cuda
def test_test_script_on_four_cards_over_nccl():
    _cards()
    out = _launch("-m", "accelerate_tpu_torch.test_utils.test_script")
    assert f"state ok: {CARDS} processes" in out
    assert "All distributed asserts passed." in out
    launches = json.loads(next(line for line in out.splitlines()
                               if line.startswith('{"test_script_launches"')))
    assert launches["test_script_launches"].get("fused_sgd_update", 0) > 0


@pytest.mark.cuda
def test_nlp_example_dp4_launches_the_fused_update_on_every_rank(tmp_path):
    _cards()
    wrapper = tmp_path / "nlp_dp4.py"
    wrapper.write_text(NLP_WRAPPER)
    _launch(str(wrapper), "--mixed_precision", "bf16")
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(CARDS)]
    print(ranks)
    assert [r["rank"] for r in ranks] == list(range(CARDS))
    assert sorted(r["card"] for r in ranks) == list(range(CARDS))
    for r in ranks:
        assert r["accuracy"] > 0.8 and r["launches"].get("fused_adamw_update", 0) > 0, r
    assert len({r["launches"]["fused_adamw_update"] for r in ranks}) == 1


def notebook_rank(out_dir: str):
    """One process of ``notebook_launcher``: the contract's rank, card and
    precision, and a sum over the ranks."""
    import accelerate_tpu_torch as T
    from accelerate_tpu_torch.utils.operations import reduce

    acc = T.Accelerator()
    total = reduce(torch.full((), float(acc.process_index + 1), device=acc.device),
                   reduction="sum")
    with open(os.path.join(out_dir, f"rank{acc.process_index}.json"), "w") as f:
        json.dump({"rank": acc.process_index, "world": acc.num_processes,
                   "card": torch.cuda.current_device(), "precision": acc.mixed_precision,
                   "sum": float(total)}, f)


@pytest.mark.cuda
def test_notebook_launcher_one_process_per_card(tmp_path, monkeypatch):
    _cards()
    import accelerate_tpu_torch as T

    monkeypatch.delenv("ACCELERATE_MIXED_PRECISION", raising=False)
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "bf16")  # restored after the test
    monkeypatch.delenv("ACCELERATE_MIXED_PRECISION")
    T.notebook_launcher(notebook_rank, args=(str(tmp_path),), num_processes=CARDS,
                        mixed_precision="bf16", use_port=None, timeout=600)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(CARDS)]
    print(ranks)
    assert [(r["rank"], r["world"], r["card"], r["precision"]) for r in ranks] == [
        (r, CARDS, r, "bf16") for r in range(CARDS)]
    assert all(r["sum"] == CARDS * (CARDS + 1) / 2 for r in ranks)
