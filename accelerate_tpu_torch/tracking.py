"""Experiment trackers — the counterpart of ``accelerate_tpu/tracking.py``.

``GeneralTracker`` (``name``, ``requires_logging_directory``,
``main_process_only``; ``store_init_configuration``, ``log``,
``log_images``, ``log_table``, ``finish``), the always-available
``JSONTracker`` (one JSON record a ``log`` call in
``<logging_dir>/<run>/metrics.jsonl``, the run's configuration in
``config.json``: the JAX package's files), ``TensorBoardTracker`` (torch's
``SummaryWriter``, else tensorboardX), and the wandb, MLflow, Comet ML, Aim,
ClearML and DVCLive trackers, each of which reports itself unavailable when
its package is missing. :func:`filter_trackers` resolves ``log_with``
(``"all"``, names, instances) and :func:`init_trackers` starts them. All of
it runs on the host; methods run on the main process only.
"""

from __future__ import annotations

import json
import os
import time
from functools import wraps

from .logging import get_logger
from .state import ProcessView
from .utils import imports

logger = get_logger(__name__)

_available_trackers = []


def _register(cls):
    _available_trackers.append(cls)
    return cls


def on_main_process(function):
    """Run only on the main process unless the tracker opts out."""

    @wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if getattr(self, "main_process_only", True):
            if ProcessView().is_main_process:
                return function(self, *args, **kwargs)
            return None
        return function(self, *args, **kwargs)

    return execute_on_main_process


class GeneralTracker:
    """The tracker API every tracker implements."""

    main_process_only = True

    def __init__(self, _blank=False):
        self._started = False

    @property
    def name(self) -> str:
        raise NotImplementedError

    @property
    def requires_logging_directory(self) -> bool:
        raise NotImplementedError

    @property
    def tracker(self):
        raise NotImplementedError

    def store_init_configuration(self, values: dict):
        pass

    def log(self, values: dict, step: int | None = None, **kwargs):
        pass

    def log_images(self, values: dict, step: int | None = None, **kwargs):
        raise NotImplementedError(f"{self.name} does not support image logging")

    def log_table(self, table_name: str, columns: list | None = None,
                  data: list | None = None, dataframe=None, step: int | None = None,
                  **kwargs):
        """Log tabular data. Either
        ``columns``+``data`` (list of rows) or a ``dataframe``."""
        raise NotImplementedError(f"{self.name} does not support table logging")

    def finish(self):
        pass


def _table_rows(columns, data, dataframe):
    """Normalize (columns, data, dataframe) to (columns, list-of-rows)."""
    if dataframe is not None:
        return list(dataframe.columns), dataframe.values.tolist()
    if data is None:
        raise ValueError("log_table needs either data or dataframe")
    return columns, data


def _markdown_table(columns, rows) -> str:
    cols = columns
    if not cols:
        cols = [f"c{i}" for i in range(len(rows[0]))] if rows else []
    lines = ["| " + " | ".join(str(c) for c in cols) + " |",
             "| " + " | ".join("---" for _ in cols) + " |"]
    lines += ["| " + " | ".join(str(v) for v in row) + " |" for row in rows]
    return "\n".join(lines)


@_register
class JSONTracker(GeneralTracker):
    """Native tracker: appends one JSON line per log call to
    ``<logging_dir>/<run_name>/metrics.jsonl``. Always available."""

    name = "json"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        super().__init__()
        self.run_name = run_name
        self.dir = os.path.join(logging_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.jsonl")
        # Persistent line-buffered handle, flushed per record: a preempted or
        # SIGKILLed run keeps every metric logged up to the kill — reopening
        # per call would also be an open/close syscall pair per step.
        self._file = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    @property
    def tracker(self):
        return self.path

    @on_main_process
    def store_init_configuration(self, values: dict):
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(values, f, indent=2, default=str)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        record = {"_step": step, "_time": round(time.time() - self._t0, 3)}
        record.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in values.items()})
        if self._file.closed:  # logging after finish() reopens rather than dies
            self._file = open(self.path, "a", buffering=1)
        self._file.write(json.dumps(record, default=str) + "\n")
        self._file.flush()

    @on_main_process
    def finish(self):
        if not self._file.closed:
            self._file.close()

    @on_main_process
    def log_images(self, values: dict, step: int | None = None, **kwargs):
        """File-path fallback (no image backend required): each array lands in
        ``<dir>/images/`` as ``.npy`` (plus ``.png`` when PIL is importable)
        and ``images.jsonl`` records the paths per step."""
        import numpy as _np

        img_dir = os.path.join(self.dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        index = {"_step": step}
        for key, imgs in values.items():
            if hasattr(imgs, "ndim") and getattr(imgs, "ndim", 0) <= 3:
                imgs = [imgs]
            paths = []
            for i, img in enumerate(imgs):
                arr = _np.asarray(img)
                base = os.path.join(img_dir, f"{key.replace('/', '_')}_{step}_{i}")
                _np.save(base + ".npy", arr)
                paths.append(base + ".npy")
                try:
                    from PIL import Image  # optional

                    u8 = arr if arr.dtype == _np.uint8 else (
                        _np.clip(arr, 0, 1) * 255).astype(_np.uint8)
                    Image.fromarray(u8).save(base + ".png")
                    paths.append(base + ".png")
                except Exception:
                    pass
            index[key] = paths
        with open(os.path.join(self.dir, "images.jsonl"), "a") as f:
            f.write(json.dumps(index) + "\n")

    @on_main_process
    def log_table(self, table_name: str, columns: list | None = None,
                  data: list | None = None, dataframe=None, step: int | None = None,
                  **kwargs):
        columns, rows = _table_rows(columns, data, dataframe)
        with open(os.path.join(self.dir, "tables.jsonl"), "a") as f:
            f.write(json.dumps({"_step": step, "name": table_name,
                                "columns": columns, "rows": rows}, default=str) + "\n")


@_register
class TensorBoardTracker(GeneralTracker):
    """torch's ``SummaryWriter`` (tensorboardX when torch's is missing)."""

    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        super().__init__()
        try:
            from torch.utils import tensorboard
        except ImportError:
            import tensorboardX as tensorboard  # type: ignore
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        self.writer = tensorboard.SummaryWriter(self.logging_dir, **kwargs)

    @classmethod
    def is_available(cls) -> bool:
        try:
            from torch.utils import tensorboard  # noqa

            return True
        except ImportError:
            try:
                import tensorboardX  # noqa

                return True
            except ImportError:
                return False

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.add_hparams(
            {k: v for k, v in values.items() if isinstance(v, (int, float, str, bool))}, metric_dict={}
        )
        self.writer.flush()

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        for k, v in values.items():
            if isinstance(v, (int, float)) or hasattr(v, "__float__"):
                self.writer.add_scalar(k, float(v), global_step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.add_text(k, v, global_step=step, **kwargs)
            elif isinstance(v, dict):
                self.writer.add_scalars(k, {kk: float(vv) for kk, vv in v.items()}, global_step=step)
        self.writer.flush()

    @on_main_process
    def log_images(self, values: dict, step: int | None = None, **kwargs):
        """NHWC arrays (or one HWC image) per key."""
        import numpy as _np

        for key, imgs in values.items():
            arr = _np.asarray(imgs)
            if arr.ndim == 3:  # single HWC image
                self.writer.add_image(key, arr, global_step=step, dataformats="HWC")
            else:  # batch NHWC
                self.writer.add_images(key, arr, global_step=step, dataformats="NHWC")
        self.writer.flush()

    @on_main_process
    def log_table(self, table_name: str, columns: list | None = None,
                  data: list | None = None, dataframe=None, step: int | None = None,
                  **kwargs):
        """Rendered as a markdown table via add_text (TensorBoard has no native
        table artifact)."""
        columns, rows = _table_rows(columns, data, dataframe)
        self.writer.add_text(table_name, _markdown_table(columns, rows), global_step=step)
        self.writer.flush()

    @on_main_process
    def finish(self):
        self.writer.close()


@_register
class WandBTracker(GeneralTracker):
    """Weights & Biases: one run per project name."""

    name = "wandb"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import wandb

        self.run = wandb.init(project=run_name, **kwargs)

    @classmethod
    def is_available(cls) -> bool:
        return imports.is_wandb_available()

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import wandb

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: int | None = None, **kwargs):
        import wandb

        self.run.log({k: [wandb.Image(img) for img in v] for k, v in values.items()}, step=step)

    @on_main_process
    def log_table(self, table_name: str, columns: list | None = None,
                  data: list | None = None, dataframe=None, step: int | None = None,
                  **kwargs):
        import wandb

        table = wandb.Table(columns=columns, data=data, dataframe=dataframe)
        self.run.log({table_name: table}, step=step)

    @on_main_process
    def finish(self):
        self.run.finish()


@_register
class MLflowTracker(GeneralTracker):
    """MLflow: one run; numeric values logged as metrics."""

    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str | None = None, **kwargs):
        super().__init__()
        import mlflow

        self.active_run = mlflow.start_run(run_name=run_name, **kwargs)

    @classmethod
    def is_available(cls) -> bool:
        return imports.is_mlflow_available()

    @property
    def tracker(self):
        return self.active_run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import mlflow

        for k, v in values.items():
            mlflow.log_param(k, v)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        import mlflow

        metrics = {k: float(v) for k, v in values.items() if isinstance(v, (int, float)) or hasattr(v, "__float__")}
        mlflow.log_metrics(metrics, step=step)

    @on_main_process
    def finish(self):
        import mlflow

        mlflow.end_run()


@_register
class CometMLTracker(GeneralTracker):
    """Comet ML: an Experiment; log_metrics / log_parameters."""

    name = "comet_ml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import comet_ml

        self.run_name = run_name
        self.writer = comet_ml.Experiment(project_name=run_name, **kwargs)

    @classmethod
    def is_available(cls) -> bool:
        return imports.is_comet_ml_available()

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        if step is not None:
            self.writer.set_step(step)
        for k, v in values.items():
            if isinstance(v, (int, float)) or hasattr(v, "__float__"):
                self.writer.log_metric(k, float(v), step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.log_other(k, v)
            elif isinstance(v, dict):
                self.writer.log_metrics(v, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.writer.end()


@_register
class AimTracker(GeneralTracker):
    """Aim: an ``aim.Run`` with the hyperparameters and ``track()``."""

    name = "aim"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str | None = ".", **kwargs):
        super().__init__()
        import aim

        self.run_name = run_name
        self.writer = aim.Run(repo=logging_dir, **kwargs)
        self.writer.name = run_name

    @classmethod
    def is_available(cls) -> bool:
        return imports.is_aim_available()

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        for k, v in values.items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.writer.close()


@_register
class ClearMLTracker(GeneralTracker):
    """ClearML: ``Task.init``, ``report_scalar`` with a title/series split."""

    name = "clearml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str | None = None, **kwargs):
        super().__init__()
        from clearml import Task

        kwargs.setdefault("project_name", os.environ.get("CLEARML_PROJECT", run_name))
        kwargs.setdefault("task_name", os.environ.get("CLEARML_TASK", run_name))
        self.task = Task.init(**kwargs)

    @classmethod
    def is_available(cls) -> bool:
        return imports.is_clearml_available()

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict):
        return self.task.connect_configuration(values)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        clearml_logger = self.task.get_logger()
        for k, v in values.items():
            if not isinstance(v, (int, float)) and not hasattr(v, "__float__"):
                continue
            # Split only the known split prefixes:
            # "train_loss" → title "loss", series "train"; everything else
            # keeps its full name as the title under the default "train" series.
            title, series = k, "train"
            for prefix in ("eval", "test", "train"):
                if k.startswith(prefix + "_"):
                    title, series = k[len(prefix) + 1 :], prefix
                    break
            if step is None:
                clearml_logger.report_single_value(name=k, value=float(v), **kwargs)
            else:
                clearml_logger.report_scalar(
                    title=title, series=series, value=float(v), iteration=step, **kwargs
                )

    @on_main_process
    def finish(self):
        if self.task:
            self.task.close()


@_register
class DVCLiveTracker(GeneralTracker):
    """DVCLive: ``dvclive.Live``; log_params / log_metric."""

    name = "dvclive"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str | None = None, live=None, **kwargs):
        super().__init__()
        from dvclive import Live

        self.live = live if live is not None else Live(**kwargs)

    @classmethod
    def is_available(cls) -> bool:
        return imports.is_dvclive_available()

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.live.log_params(values)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        if step is not None:
            self.live.step = step
        for k, v in values.items():
            if isinstance(v, (int, float)) or hasattr(v, "__float__"):
                self.live.log_metric(k, float(v), **kwargs)

    @on_main_process
    def finish(self):
        self.live.end()


LOGGER_TYPE_TO_CLASS = {
    "json": JSONTracker,
    "tensorboard": TensorBoardTracker,
    "wandb": WandBTracker,
    "mlflow": MLflowTracker,
    "comet_ml": CometMLTracker,
    "aim": AimTracker,
    "clearml": ClearMLTracker,
    "dvclive": DVCLiveTracker,
}


def filter_trackers(log_with, logging_dir: str | None = None):
    """Resolve requested trackers to available classes:
    'all' → every importable tracker; unavailable ones are skipped with a warning;
    a ``GeneralTracker`` instance passes through."""
    loggers = []
    if log_with is None:
        return []
    if not isinstance(log_with, (list, tuple)):
        log_with = [log_with]
    for tracker in log_with:
        if isinstance(tracker, GeneralTracker):
            loggers.append(tracker)
        elif str(tracker) == "all":
            for cls in _available_trackers:
                if getattr(cls, "is_available", lambda: True)():
                    loggers.append(cls.name)
        else:
            name = str(tracker).lower()
            if name not in LOGGER_TYPE_TO_CLASS:
                raise ValueError(f"Unknown tracker {name!r}; choose from {sorted(LOGGER_TYPE_TO_CLASS)}")
            cls = LOGGER_TYPE_TO_CLASS[name]
            if not getattr(cls, "is_available", lambda: True)():
                logger.warning(f"Tracker {name} requested but its package is not installed; skipping.")
                continue
            if cls.requires_logging_directory and logging_dir is None:
                raise ValueError(f"Tracker {name} requires a logging_dir/project_dir.")
            loggers.append(name)
    # dedup, keep order
    seen, out = set(), []
    for l in loggers:
        key = l if isinstance(l, str) else id(l)
        if key not in seen:
            seen.add(key)
            out.append(l)
    return out


def init_trackers(log_with, project_name, logging_dir, config, init_kwargs, accelerator):
    """Instantiate trackers & store the run config (the body of
    ``Accelerator.init_trackers``)."""
    init_kwargs = init_kwargs or {}
    trackers = []
    for entry in log_with or []:
        if isinstance(entry, GeneralTracker):
            trackers.append(entry)
            continue
        cls = LOGGER_TYPE_TO_CLASS[entry]
        kwargs = init_kwargs.get(entry, {})
        if cls.requires_logging_directory:
            trackers.append(cls(project_name, logging_dir, **kwargs))
        else:
            trackers.append(cls(project_name, **kwargs))
    if config is not None:
        for tracker in trackers:
            tracker.store_init_configuration(config)
    return trackers
