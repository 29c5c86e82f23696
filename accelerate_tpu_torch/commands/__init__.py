"""The command-line interface — the counterpart of ``accelerate_tpu/commands/``.

``accelerate-tpu-torch <config|env|launch|test|estimate-memory|merge-weights>``
(``accelerate_cli.py``). The launcher is the design change: the JAX
package runs one process per host, which owns every local chip; the port
runs **one process per card**, PyTorch's idiom, with ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` beside the ``ACCELERATE_*`` keys the port reads.

Not ported: ``tpu-config`` (gcloud TPU pods have no GPU counterpart: on
several GPU machines run ``launch --num_machines M --machine_rank r`` on
each), and the JAX package's ``lint``, ``audit``, ``memcheck``,
``fingerprint``, ``profile``, ``blackbox``, ``tune``, ``top``,
``timeline`` and ``report``, which wait for their subsystems (ROADMAP.md,
Queue 1 items 6 and 10).
"""
