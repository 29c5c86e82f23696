"""The port's trackers (``tracking.py``) against the JAX package's.

The JAX package's tracker tests (``tests/test_tracking.py`` and the JSON
tracker case of ``tests/test_checkpointing.py``), mirrored on the port, and
the JSON tracker's files compared with the JAX package's for the same
calls: the same ``metrics.jsonl`` records (``_time`` aside, a wall clock)
and the same ``config.json``. The JSON and TensorBoard trackers run for
real; the six service-backed ones report themselves unavailable, as their
packages are absent here.
"""

import json
import os

import numpy as np
import pytest
import torch

from accelerate_tpu import tracking as J

import accelerate_tpu_torch as T
from accelerate_tpu_torch import tracking as P
from accelerate_tpu_torch.tracking import (
    LOGGER_TYPE_TO_CLASS,
    GeneralTracker,
    JSONTracker,
    TensorBoardTracker,
    filter_trackers,
)

OPTIONAL = ["wandb", "mlflow", "comet_ml", "aim", "clearml", "dvclive"]


def _records(path):
    return [{k: v for k, v in json.loads(line).items() if k != "_time"}
            for line in open(path)]


def test_json_tracker_records_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    losses = rng.random(4).astype(np.float32)
    calls = [({"loss": losses[0], "note": "start"}, 0),
             ({"loss": float(losses[1]), "acc": np.float64(0.5)}, 1),
             ({"loss": torch.tensor(losses[2])}, None),
             ({"loss": int(3), "lr": np.float32(2e-5)}, 7)]
    config = {"lr": 2e-5, "layers": 2, "name": "bert", "dtype": np.dtype("float32")}
    for pkg, mod in (("jax", J), ("port", P)):
        t = mod.JSONTracker("run", str(tmp_path / pkg))
        t.store_init_configuration(config)
        for values, step in calls:
            t.log(values, step=step)
        t.finish()
    for name in ("metrics.jsonl", "config.json"):
        want, got = (tmp_path / "jax" / "run" / name), (tmp_path / "port" / "run" / name)
        if name == "metrics.jsonl":
            assert _records(got) == _records(want)
        else:
            assert json.loads(got.read_text()) == json.loads(want.read_text())
    assert _records(tmp_path / "port" / "run" / "metrics.jsonl")[2] == {
        "_step": None, "loss": float(losses[2])}


def test_eight_tracker_classes_registered():
    assert sorted(LOGGER_TYPE_TO_CLASS) == sorted(J.LOGGER_TYPE_TO_CLASS) == [
        "aim", "clearml", "comet_ml", "dvclive", "json", "mlflow", "tensorboard", "wandb"]


def test_json_tracker_lifecycle(tmp_path):
    t = JSONTracker("run1", str(tmp_path))
    t.store_init_configuration({"lr": 0.1, "note": "hello"})
    t.log({"loss": 1.5}, step=0)
    t.log({"loss": 0.5, "acc": 0.9}, step=1)
    t.finish()
    t.log({"loss": 0.25}, step=2)  # after finish: reopens
    cfg = json.load(open(tmp_path / "run1" / "config.json"))
    assert cfg["lr"] == 0.1
    rows = [json.loads(line) for line in open(tmp_path / "run1" / "metrics.jsonl")]
    assert rows[0]["loss"] == 1.5 and rows[0]["_step"] == 0
    assert rows[1]["acc"] == 0.9 and rows[2]["_step"] == 2


def test_tensorboard_tracker_lifecycle(tmp_path):
    t = TensorBoardTracker("tbrun", str(tmp_path))
    t.store_init_configuration({"lr": 0.1, "layers": 2})
    t.log({"loss": 1.0, "msg": "text", "group": {"a": 1.0, "b": 2.0}}, step=0)
    t.finish()
    files = [f for _, _, fs in os.walk(tmp_path / "tbrun") for f in fs]
    assert any("tfevents" in f for f in files), files


def test_filter_trackers_unknown_raises(tmp_path):
    for mod in (J, P):
        with pytest.raises(ValueError, match="Unknown tracker"):
            mod.filter_trackers("not_a_tracker", str(tmp_path))


def test_filter_trackers_unavailable_skipped(tmp_path):
    assert filter_trackers(OPTIONAL[1:], str(tmp_path)) == \
        J.filter_trackers(OPTIONAL[1:], str(tmp_path)) == []


def test_filter_trackers_all_resolves_available(tmp_path):
    names = filter_trackers("all", str(tmp_path))
    assert names == J.filter_trackers("all", str(tmp_path))
    assert "json" in names and "tensorboard" in names and "wandb" not in names


def test_filter_trackers_requires_dir():
    with pytest.raises(ValueError, match="requires a logging_dir"):
        filter_trackers("json", None)


def test_filter_trackers_dedup_and_passthrough(tmp_path):
    class MyTracker(GeneralTracker):
        name = "custom"
        requires_logging_directory = False

        @property
        def tracker(self):
            return None

    mine = MyTracker()
    assert filter_trackers(["json", "json", mine], str(tmp_path)) == ["json", mine]


def test_accelerator_tracking_end_to_end(tmp_path):
    logged = []

    class RecordingTracker(GeneralTracker):
        name = "recording"
        requires_logging_directory = False

        @property
        def tracker(self):
            return logged

        def store_init_configuration(self, values):
            logged.append(("config", values))

        def log(self, values, step=None, **kwargs):
            logged.append(("log", values, step))

        def finish(self):
            logged.append(("finish",))

    acc = T.Accelerator(cpu=True, log_with=["json", RecordingTracker()],
                        project_dir=str(tmp_path))
    acc.init_trackers("proj", config={"lr": 1.0})
    acc.log({"loss": 2.0}, step=3)
    assert acc.get_tracker("recording").tracker is logged
    assert acc.get_tracker("recording", unwrap=True) is logged
    acc.end_training()
    assert ("config", {"lr": 1.0}) in logged
    assert ("log", {"loss": 2.0}, 3) in logged
    assert ("finish",) in logged
    rows = [json.loads(line) for line in open(tmp_path / "proj" / "metrics.jsonl")]
    assert rows[0]["loss"] == 2.0


def test_json_tracker_through_the_accelerator(tmp_path):
    """The JAX package's ``test_checkpointing.py::test_json_tracker``."""
    acc = T.Accelerator(cpu=True, log_with="json", project_dir=str(tmp_path))
    acc.init_trackers("myrun", config={"lr": 0.1})
    acc.log({"loss": 1.5}, step=0)
    acc.log({"loss": 0.5}, step=1)
    acc.end_training()
    lines = (tmp_path / "myrun" / "metrics.jsonl").read_text().strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[1])["loss"] == 0.5
    assert json.loads((tmp_path / "myrun" / "config.json").read_text())["lr"] == 0.1


def test_get_tracker_missing_raises(tmp_path):
    acc = T.Accelerator(cpu=True, log_with="json", project_dir=str(tmp_path))
    acc.init_trackers("proj")
    with pytest.raises(ValueError, match="not found"):
        acc.get_tracker("wandb")


def test_log_with_and_project_dir_from_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("ACCELERATE_LOG_WITH", "json, tensorboard")
    monkeypatch.setenv("ACCELERATE_PROJECT_DIR", str(tmp_path))
    monkeypatch.setenv("ACCELERATE_CHECKPOINT_AUTO_NAMING", "yes")
    monkeypatch.setenv("ACCELERATE_CHECKPOINT_TOTAL_LIMIT", "3")
    acc = T.Accelerator(cpu=True)
    assert acc.log_with == ["json", "tensorboard"]
    cfg = acc.project_configuration
    assert (acc.project_dir, acc.logging_dir, cfg.automatic_checkpoint_naming,
            cfg.total_limit, acc.iteration) == (str(tmp_path), str(tmp_path), True, 3, 0)
    explicit = T.Accelerator(cpu=True, project_dir=str(tmp_path / "x"), log_with=[])
    assert explicit.project_dir == str(tmp_path / "x") and explicit.log_with == []


@pytest.mark.parametrize("name", OPTIONAL)
def test_optional_trackers_report_unavailable(name):
    cls = LOGGER_TYPE_TO_CLASS[name]
    assert cls.is_available() is J.LOGGER_TYPE_TO_CLASS[name].is_available() is False
    assert cls.name == name


def test_json_tracker_log_images_and_table(tmp_path):
    t = JSONTracker("run", str(tmp_path))
    imgs = np.random.default_rng(0).random((2, 4, 4, 3)).astype(np.float32)
    t.log_images({"samples": imgs}, step=1)
    t.log_table("preds", columns=["id", "score"], data=[[0, 0.5], [1, 0.75]], step=1)
    t.finish()
    idx = [json.loads(line) for line in open(tmp_path / "run" / "images.jsonl")]
    assert idx[0]["_step"] == 1 and len(idx[0]["samples"]) >= 2
    assert np.load(idx[0]["samples"][0]).shape == (4, 4, 3)
    tables = [json.loads(line) for line in open(tmp_path / "run" / "tables.jsonl")]
    assert tables[0]["columns"] == ["id", "score"] and tables[0]["rows"][1] == [1, 0.75]


def test_markdown_table_rendering():
    cols, rows = P._table_rows(["a", "b"], [[1, 2], [3, 4]], None)
    md = P._markdown_table(cols, rows)
    assert md == J._markdown_table(cols, rows)
    assert md.splitlines()[0] == "| a | b |" and "| 3 | 4 |" in md
    with pytest.raises(ValueError, match="dataframe"):
        P._table_rows(None, None, None)


def test_base_tracker_log_table_unsupported():
    class Stub(GeneralTracker):
        name = "stub"
        requires_logging_directory = False

    with pytest.raises(NotImplementedError, match="table"):
        Stub(_blank=True).log_table("t", columns=["a"], data=[[1]])


def test_trackers_write_on_the_main_process_only(monkeypatch, tmp_path):
    class Rank1:
        is_main_process = False

    monkeypatch.setattr(P, "ProcessView", Rank1)
    t = JSONTracker("run", str(tmp_path))
    t.log({"loss": 1.0}, step=0)
    assert not (tmp_path / "run").exists()
