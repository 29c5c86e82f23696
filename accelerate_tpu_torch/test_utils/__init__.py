"""Test fixtures and the bundled distributed checks — the counterpart of
``accelerate_tpu/test_utils/``: ``training.py`` (the regression fixtures)
and ``test_script.py`` (what ``accelerate-tpu-torch test`` runs)."""

from .training import (
    MatrixRegressionModel,
    RegressionDataset,
    RegressionModel,
    regression_batches,
)
