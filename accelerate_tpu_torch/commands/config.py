"""``accelerate-tpu-torch config`` — the wizard and ``--default``; the
counterpart of ``accelerate_tpu/commands/config.py``.

The wizard asks what the port can honour: the machines and the processes
of each (one per card, or gloo ranks on the CPU), the mesh sizes (dp,
fsdp, tp, pp, sp, ep), the fsdp and pipeline options, gradient accumulation,
checkpointing, trackers, the train window, ZeRO and the precision. It does
not ask about the JAX package's multi-slice pods, compilation
cache, preemption and elastic training, health guards, telemetry, serving
tiers and levers, Pallas kernels or autotuner (``config_args.UNPORTED_FIELDS``).
"""

from __future__ import annotations

import argparse

from ..utils.other import default_config_file
from .config_args import ClusterConfig


def _ask(prompt: str, default, cast=str, choices=None):
    # Fixed-choice questions get the cursor menu on a real terminal; free-form
    # values and sessions that are not a terminal keep the plain prompt.
    if choices is not None:
        from .menu import interactive_tty, select

        if interactive_tty():
            return select(prompt, choices, default=default)
    suffix = f" [{default}]" if default is not None else ""
    while True:
        raw = input(f"{prompt}{suffix}: ").strip()
        if not raw:
            return default
        try:
            val = cast(raw)
        except (TypeError, ValueError):
            print(f"  invalid value {raw!r}, expected {cast.__name__}")
            continue
        if choices is not None and val not in choices:
            print(f"  choose one of {choices}")
            continue
        return val


def _yesno(prompt: str, default: bool = False) -> bool:
    from .menu import interactive_tty, select

    if interactive_tty():
        return select(prompt, ["yes", "no"], default="yes" if default else "no") == "yes"
    raw = input(f"{prompt} [{'yes' if default else 'no'}]: ").strip().lower()
    if not raw:
        return default
    return raw in ("y", "yes", "true", "1")


def get_user_input() -> ClusterConfig:
    """The wizard's questions, in order; returns the configuration."""
    use_cpu = _yesno("Do you want to run your training on CPU only (e.g. for debugging)?", False)
    num_machines = _ask("How many machines will you use?", 1, int)
    machine_rank, ip, port = 0, None, None
    if num_machines > 1:
        machine_rank = _ask("What is the rank of this machine?", 0, int)
        ip = _ask("What is the IP address of the machine that will host the main process?",
                  "127.0.0.1")
        port = _ask("What is the port the main process will listen on?", 29500, int)
    what = "gloo ranks" if use_cpu else "processes (one per card)"
    num_processes = _ask(f"How many {what} on this machine?", 1, int)
    print("Mesh axis sizes (1 disables an axis; dp=0 lets dp absorb all remaining ranks):")
    dp = _ask("  data-parallel (dp) size", 0, int)
    fsdp = _ask("  fully-sharded (fsdp/ZeRO-3) size", 1, int)
    tp = _ask("  tensor-parallel (tp) size", 1, int)
    pp = _ask("  pipeline-parallel (pp) size", 1, int)
    sp = _ask("  sequence-parallel (sp) size", 1, int)
    ep = _ask("  expert-parallel (ep) size", 1, int)
    min_shard, cpu_offload = 0, False
    if fsdp > 1 or fsdp in (0, -1):
        if _yesno("Do you want to configure FSDP options?", False):
            min_shard = _ask("  minimum tensor size to shard (smaller stays replicated)",
                             2**14, int)
            cpu_offload = _yesno("  offload the optimizer state to host memory?", False)
    pp_schedule, pp_mbs = "", 0
    if pp > 1:
        pp_schedule = _ask("Pipeline schedule? (gpipe/1f1b: 1f1b keeps O(pp) activations)",
                           "gpipe", str, ["gpipe", "1f1b"])
        pp_mbs = _ask("Pipeline microbatches? (0 = one per stage)", 0, int)
    accum = _ask("How many gradient accumulation steps?", 1, int)
    project_dir, ckpt_limit, ckpt_auto = None, 0, False
    if _yesno("Do you want to configure checkpointing?", False):
        project_dir = _ask("  project directory (checkpoints/logs root)", ".")
        ckpt_auto = _yesno("  automatic checkpoint naming (checkpoints/checkpoint_<n>)?", True)
        ckpt_limit = _ask("  how many checkpoints to keep? (0 = all)", 0, int)
    train_window, zero_sharding = None, None
    if _yesno("Do you want to configure the train window and ZeRO optimizer sharding?",
              False):
        train_window = _ask("  train window K (fused steps per build_train_window call)", 1,
                            int)
        zero_sharding = _yesno("  ZeRO sharding of the optimizer state over the dp axis?",
                               False)
    log_with = ""
    if _yesno("Do you want to configure experiment tracking?", False):
        log_with = _ask("  trackers to log to (comma-separated: json,tensorboard,wandb,csv,"
                        "aim,mlflow,comet_ml,clearml,dvclive or 'all')", "json")
        if log_with and not project_dir:
            project_dir = _ask("  trackers need a logging root: project directory", ".")
    mixed_precision = _ask("Do you wish to use mixed precision? (no/bf16/fp16/fp8)", "bf16",
                           str, ["no", "bf16", "fp16", "fp8"])
    return ClusterConfig(
        distributed_type="MULTI_CPU" if use_cpu else "MULTI_GPU",
        num_machines=num_machines, machine_rank=machine_rank, num_processes=num_processes,
        main_process_ip=ip, main_process_port=port, mixed_precision=mixed_precision,
        use_cpu=use_cpu, dp_size=dp, fsdp_size=fsdp, tp_size=tp, pp_size=pp, sp_size=sp,
        ep_size=ep, gradient_accumulation_steps=accum, fsdp_min_shard_size=min_shard,
        fsdp_cpu_offload=cpu_offload, pp_schedule=pp_schedule, pp_microbatches=pp_mbs,
        project_dir=project_dir, checkpoint_total_limit=ckpt_limit,
        checkpoint_auto_naming=ckpt_auto, log_with=log_with, train_window=train_window,
        zero_sharding=zero_sharding)


def write_default_config(path: str | None = None) -> str:
    """``config --default``: the default :class:`ClusterConfig` (one
    process, no mixed precision) at ``path`` or the default location."""
    path = path or default_config_file()
    cfg = ClusterConfig()
    if path.endswith(".json"):
        cfg.to_json_file(path)
    else:
        cfg.to_yaml_file(path)
    return path


def config_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = "Create a launch configuration for accelerate-tpu-torch"
    if subparsers is not None:
        parser = subparsers.add_parser("config", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch config", description=description)
    parser.add_argument("--config_file", default=None,
                        help=f"Where to save the config (default: {default_config_file()})")
    parser.add_argument("--default", action="store_true",
                        help="Write the default config without prompting")
    if subparsers is not None:
        parser.set_defaults(func=config_command)
    return parser


def config_command(args) -> None:
    if args.default:
        path = write_default_config(args.config_file)
    else:
        cfg = get_user_input()
        path = args.config_file or default_config_file()
        if path.endswith(".json"):
            cfg.to_json_file(path)
        else:
            cfg.to_yaml_file(path)
    print(f"accelerate-tpu-torch configuration saved at {path}")


def main() -> None:
    config_command(config_command_parser().parse_args())


if __name__ == "__main__":
    main()
