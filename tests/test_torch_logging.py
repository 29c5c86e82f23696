"""The port's logging (``logging.py``) against the JAX package's.

The JAX package's logger cases (``tests/test_environment_and_logging.py``
and ``tests/test_checkpointing.py``), mirrored: the same calls to each
package's ``get_logger`` emit the same records (messages and levels) on
the main process; ``warning_once`` deduplicates; the level follows
``log_level``; ``in_order`` walks one barrier per rank on every rank,
main included; ``log_every_n`` emits the first and every n-th call of a
call site; a non-main rank emits only with ``main_process_only=False``.
"""

import logging

import pytest

from accelerate_tpu.logging import get_logger as j_get_logger

from accelerate_tpu_torch import logging as P
from accelerate_tpu_torch.logging import get_logger


def _emit(make, name, caplog, calls):
    logger = make(name)
    with caplog.at_level(logging.DEBUG, logger=name):
        caplog.clear()
        for method, args, kwargs in calls:
            getattr(logger, method)(*args, **kwargs)
        return [(r.levelname, r.getMessage()) for r in caplog.records]


def test_records_match_jax(caplog):
    calls = [("info", ("hello %s", "world"), {}),
             ("warning", ("careful",), {"main_process_only": True}),
             ("debug", ("detail",), {"main_process_only": False}),
             ("error", ("bad %d", 3), {"in_order": True}),
             ("warning_once", ("dup",), {}), ("warning_once", ("dup",), {})]
    want = _emit(j_get_logger, "at_torch_cmp_jax", caplog, calls)
    got = _emit(get_logger, "at_torch_cmp_port", caplog, calls)
    assert got == want == [("INFO", "hello world"), ("WARNING", "careful"),
                           ("DEBUG", "detail"), ("ERROR", "bad 3"), ("WARNING", "dup")]


def test_get_logger_main_process_only(caplog):
    logger = get_logger("at_torch_logger", log_level="INFO")
    with caplog.at_level(logging.INFO, logger="at_torch_logger"):
        logger.info("hello")
    assert any("hello" in r.message for r in caplog.records)


def test_warning_once_deduplicates(caplog):
    logger = get_logger("at_torch_logger_once")
    with caplog.at_level(logging.WARNING, logger="at_torch_logger_once"):
        logger.warning_once("dup")
        logger.warning_once("dup")
        logger.warning_once("other")
    assert len([r for r in caplog.records if r.message == "dup"]) == 1
    assert any(r.message == "other" for r in caplog.records)


def test_get_logger_respects_level():
    logger = get_logger("at_torch_logger_lvl", log_level="ERROR")
    assert logger.logger.level == logging.ERROR
    assert not logger.isEnabledFor(logging.INFO) and logger.isEnabledFor(logging.ERROR)
    logging.getLogger().setLevel(logging.WARNING)  # get_logger also set the root's


class _FakeRanks:
    """Four ranks as ``ProcessView`` reports them; counts the barriers."""

    num_processes = 4
    barrier_calls = 0

    def __init__(self, index):
        self.process_index = index

    @property
    def is_main_process(self):
        return self.process_index == 0

    def wait_for_everyone(self):
        type(self).barrier_calls += 1


@pytest.mark.parametrize("rank", [0, 2])
def test_in_order_barrier_is_symmetric(caplog, monkeypatch, rank):
    """Every rank, the one that emits included, walks all 4 barriers."""

    class Fake(_FakeRanks):
        barrier_calls = 0

    monkeypatch.setattr(P, "_process", lambda: Fake(rank))
    logger = get_logger("at_torch_logger_sym")
    with caplog.at_level(logging.INFO, logger="at_torch_logger_sym"):
        logger.info("sym", main_process_only=True, in_order=True)
    assert any("sym" in r.message for r in caplog.records) == (rank == 0)
    assert Fake.barrier_calls == 4


def test_non_main_rank_logs_only_when_asked(caplog, monkeypatch):
    monkeypatch.setattr(P, "_process", lambda: _FakeRanks(1))
    logger = get_logger("at_torch_logger_rank1")
    with caplog.at_level(logging.INFO, logger="at_torch_logger_rank1"):
        logger.info("main only")
        logger.info("everyone", main_process_only=False)
    assert [r.message for r in caplog.records] == ["everyone"]


def test_log_every_n_emits_first_and_every_nth(caplog):
    logger = get_logger("at_torch_logger_every")
    with caplog.at_level(logging.INFO, logger="at_torch_logger_every"):
        for _ in range(7):
            logger.log_every_n(3, logging.INFO, "tick")
    assert [r.message for r in caplog.records] == [
        "tick", "tick [1/3 of 4 occurrences logged]", "tick [1/3 of 7 occurrences logged]"]
    with pytest.raises(ValueError, match="n >= 1"):
        logger.log_every_n(0, logging.INFO, "never")
