"""Main-process progress bars — the counterpart of ``accelerate_tpu/utils/tqdm.py``.

``tqdm(iterable, main_process_only=True)`` draws the bar on rank 0 only, so a
job of N ranks does not print N interleaved bars; ``main_process_only=False``
draws one on every rank. The rank is the job's default process group's (0
without one).
"""

from __future__ import annotations

import torch.distributed as dist


def tqdm(*args, main_process_only: bool = True, **kwargs):
    """``tqdm.auto.tqdm`` that is disabled on the ranks other than 0."""
    from tqdm.auto import tqdm as _tqdm

    if main_process_only and dist.is_initialized() and dist.get_rank() != 0:
        kwargs["disable"] = True
    return _tqdm(*args, **kwargs)
