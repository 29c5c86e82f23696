"""``accelerate-tpu-torch launch`` — the launch contract and one process per
card; the counterpart of ``accelerate_tpu/commands/launch.py``.

The JAX package runs one process per host, which owns every local chip.
The port runs PyTorch's way, one process per card:

- ``--num_processes N`` processes on this machine (default: every visible
  card; with ``--cpu``, one), started with ``subprocess.Popen`` as the JAX
  package starts its gang (``launch.py:713-740``). Without ``--cpu``, N above
  the visible cards raises: NCCL cannot hold two ranks on one card.
- Each process gets ``RANK`` (``machine_rank x N + local``),
  ``LOCAL_RANK``, ``WORLD_SIZE`` (``num_machines x N``),
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (the
  ``--main_process_ip`` and ``--main_process_port``, else this host and a
  free port on one machine, 29500 on several), and the ``ACCELERATE_*``
  keys of the JAX package's ``prepare_launch_env`` (``launch.py:455-657``)
  that the port reads (``utils/constants.HONOURED_ENV``), with the same
  values; ``PYTHONPATH`` names the repository. ``state.PartialState``
  reads them: ``cuda:LOCAL_RANK`` over NCCL, or gloo on the CPU with
  ``--cpu`` (``ACCELERATE_USE_CPU``).
- The gang fails fast: the first process that exits nonzero has the others
  stopped, and its code is the launcher's. ``--max_restarts R`` starts the
  whole gang again up to R times (``ACCELERATE_RESTART_ATTEMPT`` counts
  them) and is refused on several machines, as in the JAX package.
  Nothing is delegated to ``torchrun``'s elastic agent.
- Each process runs the script through ``commands/rank.py``: after a clean
  finish it leaves the process group once every rank is done, after a
  failure at once, so fail-fast is not held up by a rank that waits for its
  peers.
- A config field or flag the port cannot honour raises, by name
  (``config_args.check_ported``).

``python -m accelerate_tpu_torch.commands.launch`` works as well as the
``accelerate-tpu-torch launch`` entry point.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

from ..utils.constants import (
    ENV_CHECKPOINT_AUTO_NAMING,
    ENV_CHECKPOINT_TOTAL_LIMIT,
    ENV_CPU,
    ENV_DEBUG_MODE,
    ENV_FSDP_CPU_OFFLOAD,
    ENV_FSDP_MIN_SHARD_SIZE,
    ENV_GRADIENT_ACCUMULATION_STEPS,
    ENV_LOG_WITH,
    ENV_MESH_SHAPE,
    ENV_MIXED_PRECISION,
    ENV_PP_MICROBATCHES,
    ENV_PP_SCHEDULE,
    ENV_PROJECT_DIR,
    ENV_RESTART_ATTEMPT,
    ENV_TRAIN_WINDOW,
    ENV_ZERO_SHARDING,
)
from ..utils.dataclasses import PrecisionType
from .config_args import UNPORTED_FIELDS, ClusterConfig, check_ported, load_config_from_file

# Flags of the JAX package's launcher that set a field the port cannot
# honour (config_args.UNPORTED_FIELDS): they parse, and the launch raises.
_UNPORTED_SWITCHES = ("handle_preemption", "guard_numerics")
_UNPORTED_TRISTATES = ("elastic", "telemetry", "fleet_metrics")
_NO_FLAG = ("compute_environment", "downcast_bf16", "dcn_size")
_UNPORTED_FLAGS = tuple(f for f in UNPORTED_FIELDS if f not in _NO_FLAG)
# Flags that set a field of the same name (--cpu sets use_cpu).
_PORTED_FLAGS = ("num_processes", "num_machines", "machine_rank", "main_process_ip",
                 "main_process_port", "mixed_precision", "debug", "max_restarts", "dp_size",
                 "fsdp_size", "tp_size", "pp_size", "sp_size", "ep_size", "dcn_size",
                 "train_window", "zero_sharding")
DEFAULT_PORT = 29500  # the rendezvous port of a job over several machines
RANK_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rank.py")


def launch_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = "Launch a script on this machine's cards, one process per card"
    if subparsers is not None:
        parser = subparsers.add_parser("launch", description=description, allow_abbrev=False)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch launch", description=description,
                                         allow_abbrev=False)
    parser.add_argument("--config_file", default=None, help="Config file to read defaults from")
    parser.add_argument("--cpu", action="store_true", default=None,
                        help="Run gloo ranks on the CPU instead of one process per card")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Processes on this machine, one per card (default: every "
                             "visible card; with --cpu, 1)")
    parser.add_argument("--num_machines", type=int, default=None, help="Number of machines")
    parser.add_argument("--machine_rank", type=int, default=None, help="Rank of this machine")
    parser.add_argument("--main_process_ip", default=None,
                        help="Address of the machine of rank 0 (MASTER_ADDR)")
    parser.add_argument("--main_process_port", type=int, default=None,
                        help="Rendezvous port on that machine (MASTER_PORT)")
    parser.add_argument("--mixed_precision", choices=[p.value for p in PrecisionType],
                        default=None)
    parser.add_argument("--debug", action="store_true", default=None,
                        help="Check the ranks' shapes before each collective "
                             "(ACCELERATE_DEBUG_MODE)")
    parser.add_argument("--max_restarts", type=int, default=None,
                        help="Start the whole gang again up to N times after a failure "
                             "(resume from a checkpoint is the script's: load_state)")
    for axis in ("dp", "fsdp", "tp", "pp", "sp", "ep", "dcn"):
        parser.add_argument(f"--{axis}_size", type=int, default=None,
                            help=f"{axis} size of the mesh (ACCELERATE_MESH_SHAPE)")
    parser.add_argument("--train_window", type=int, default=None,
                        help="Steps a build_train_window call runs (ACCELERATE_TRAIN_WINDOW)")
    parser.add_argument("--zero_sharding", action=argparse.BooleanOptionalAction, default=None,
                        help="ZeRO: the optimizer state sharded over dp "
                             "(ACCELERATE_ZERO_SHARDING)")
    for name in _UNPORTED_FLAGS:
        why = f"not ported: {UNPORTED_FIELDS[name]}"
        if name in _UNPORTED_SWITCHES:
            parser.add_argument(f"--{name}", action="store_true", default=None, help=why)
        elif name in _UNPORTED_TRISTATES:
            parser.add_argument(f"--{name}", action=argparse.BooleanOptionalAction,
                                default=None, help=why)
        else:
            parser.add_argument(f"--{name}", default=None, help=why)
    parser.add_argument("-m", "--module", action="store_true",
                        help="Run the script as a python module")
    parser.add_argument("training_script", help="The script (or module, with -m) to launch")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER,
                        help="Arguments for the script")
    if subparsers is not None:
        parser.set_defaults(func=launch_command)
    return parser


def _merge_config(args) -> ClusterConfig:
    """The config file's values with the flags over them.
    ``num_processes`` is None when neither gives it: every visible card."""
    loaded = load_config_from_file(args.config_file)
    cfg = loaded or ClusterConfig()
    if args.cpu is not None:
        cfg.use_cpu = args.cpu
    for name in _PORTED_FLAGS + _UNPORTED_FLAGS:
        value = getattr(args, name, None)
        if value is not None:
            setattr(cfg, name, value)
    if loaded is None and args.num_processes is None:
        cfg.num_processes = None
    return cfg


def prepare_launch_env(cfg: ClusterConfig, local_rank: int | None = None, attempt: int = 0,
                       master_port: int | None = None) -> dict:
    """The environment of one process: this one's with the ``ACCELERATE_*``
    keys the port reads (the JAX package's values for the same ``cfg``)
    and, for ``local_rank``, PyTorch's rank and rendezvous keys."""
    env = dict(os.environ)
    env[ENV_RESTART_ATTEMPT] = str(attempt)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if repo not in env.get("PYTHONPATH", "").split(os.pathsep):
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env[ENV_MIXED_PRECISION] = cfg.mixed_precision
    env[ENV_MESH_SHAPE] = cfg.mesh_shape_env()
    if cfg.gradient_accumulation_steps and cfg.gradient_accumulation_steps > 1:
        env[ENV_GRADIENT_ACCUMULATION_STEPS] = str(cfg.gradient_accumulation_steps)
    if cfg.fsdp_min_shard_size:
        env[ENV_FSDP_MIN_SHARD_SIZE] = str(cfg.fsdp_min_shard_size)
    if cfg.fsdp_cpu_offload:
        env[ENV_FSDP_CPU_OFFLOAD] = "1"
    if cfg.pp_schedule:
        env[ENV_PP_SCHEDULE] = cfg.pp_schedule
    if cfg.pp_microbatches:
        env[ENV_PP_MICROBATCHES] = str(cfg.pp_microbatches)
    if cfg.project_dir:
        env[ENV_PROJECT_DIR] = cfg.project_dir
    if cfg.checkpoint_total_limit:
        env[ENV_CHECKPOINT_TOTAL_LIMIT] = str(cfg.checkpoint_total_limit)
    if cfg.checkpoint_auto_naming:
        env[ENV_CHECKPOINT_AUTO_NAMING] = "1"
    if cfg.log_with:
        env[ENV_LOG_WITH] = cfg.log_with
    # Tri-state, as in the JAX package: unset lets an inherited value flow,
    # an explicit 1 scrubs it.
    if cfg.train_window and cfg.train_window > 1:
        env[ENV_TRAIN_WINDOW] = str(int(cfg.train_window))
    elif cfg.train_window is not None:
        env.pop(ENV_TRAIN_WINDOW, None)
    if cfg.zero_sharding is not None:
        env[ENV_ZERO_SHARDING] = "1" if cfg.zero_sharding else "0"
    if cfg.use_cpu:
        env[ENV_CPU] = "1"
    if cfg.debug:
        env[ENV_DEBUG_MODE] = "1"
    if local_rank is not None:
        n = cfg.num_processes
        env.update(RANK=str(cfg.machine_rank * n + local_rank), LOCAL_RANK=str(local_rank),
                   WORLD_SIZE=str(cfg.num_machines * n), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR=cfg.main_process_ip or "127.0.0.1",
                   MASTER_PORT=str(master_port or cfg.main_process_port or DEFAULT_PORT))
        if n > 1:  # torchrun's default: one thread a rank unless set
            env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _check(cfg: ClusterConfig) -> None:
    """Refuse what the port cannot run, before any process starts."""
    check_ported(cfg)
    if cfg.mixed_precision not in {p.value for p in PrecisionType}:
        raise ValueError(f"Unknown mixed_precision mode: {cfg.mixed_precision!r}")
    if cfg.max_restarts < 0:
        raise ValueError(f"--max_restarts must be >= 0, got {cfg.max_restarts}")
    if cfg.max_restarts > 0 and cfg.num_machines > 1:
        raise ValueError(
            "--max_restarts only applies to single-machine jobs: a per-machine restart cannot "
            "rendezvous again with the live ranks of the old incarnation. Restart the whole "
            "multi-machine launch (your scheduler) and resume with load_state.")
    if cfg.train_window is not None and int(cfg.train_window) < 1:
        raise ValueError(f"--train_window must be >= 1, got {cfg.train_window}")
    if not 0 <= cfg.machine_rank < max(cfg.num_machines, 1):
        raise ValueError(f"--machine_rank {cfg.machine_rank} is not one of "
                         f"{cfg.num_machines} machines")
    if cfg.use_cpu:
        if cfg.num_processes is None:
            cfg.num_processes = 1
    else:
        import torch

        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("launch: no CUDA card is visible; pass --cpu to run gloo ranks "
                               "on the CPU")
        if cfg.num_processes is None:
            cfg.num_processes = cards
        if cfg.num_processes > cards:
            raise ValueError(f"launch: {cfg.num_processes} processes need as many cards; "
                             f"{cards} are visible (NCCL cannot hold two ranks on one card)")
    if cfg.num_processes < 1:
        raise ValueError(f"--num_processes must be >= 1, got {cfg.num_processes}")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _exit_code(rc: int) -> int:
    """A process killed by signal s reads as 128 + s, as in a shell."""
    return rc if rc >= 0 else 128 - rc


def _stop(procs, grace: float = 30.0) -> None:
    """SIGTERM every process still running, SIGKILL those that outlive
    ``grace`` seconds, and reap them all."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def run_gang(cfg: ClusterConfig, cmd: list, attempt: int = 0) -> int:
    """One incarnation of the gang: ``cfg.num_processes`` processes of
    ``cmd``; returns 0 when every one exits 0, else the first nonzero exit
    code seen, the others stopped at once."""
    port = cfg.main_process_port or (_free_port() if cfg.num_machines <= 1 else None)
    procs = []
    try:
        for local_rank in range(cfg.num_processes):
            env = prepare_launch_env(cfg, local_rank, attempt=attempt, master_port=port)
            procs.append(subprocess.Popen(cmd, env=env))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return _exit_code(failed[0])
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.05)
    finally:
        _stop(procs)


def launch(cfg: ClusterConfig, cmd: list) -> int:
    """Check ``cfg``, run the gang and restart it up to ``max_restarts``
    times; returns the last incarnation's exit code."""
    _check(cfg)
    rc = 1
    for attempt in range(cfg.max_restarts + 1):
        rc = run_gang(cfg, cmd, attempt)
        if rc == 0:
            return 0
        if attempt < cfg.max_restarts:
            print(f"launch: the gang failed (rc={rc}); restarting all {cfg.num_processes} "
                  f"processes, {attempt + 1}/{cfg.max_restarts}", file=sys.stderr, flush=True)
    return rc


def script_command(args) -> list:
    """Each rank runs the script through ``commands/rank.py``, which leaves
    the process group after a clean finish and at once after a failure."""
    return [sys.executable, RANK_SCRIPT, *(["-m"] if args.module else []),
            args.training_script, *args.training_script_args]


def launch_command(args) -> None:
    rc = launch(_merge_config(args), script_command(args))
    if rc:
        raise SystemExit(rc)


def main() -> None:
    launch_command(launch_command_parser().parse_args())


if __name__ == "__main__":
    main()
