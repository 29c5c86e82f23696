"""``accelerate-tpu-torch env`` — the environment, for bug reports; the
counterpart of ``accelerate_tpu/commands/env.py``.

The versions of Python, torch, CUDA (torch's build) and ``nvcc``, the
visible cards with each one's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them (power
limits change speed, so reports carry them), the ``ACCELERATE_*``
environment and the config file.
"""

from __future__ import annotations

import argparse
import os
import platform
import shutil
import subprocess

from ..utils.imports import is_triton_available
from ..utils.other import default_config_file
from .config_args import load_config_from_file


def env_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = "Print the accelerate-tpu-torch environment (for bug reports)"
    if subparsers is not None:
        parser = subparsers.add_parser("env", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch env", description=description)
    parser.add_argument("--config_file", default=None, help="Config file to display")
    if subparsers is not None:
        parser.set_defaults(func=env_command)
    return parser


def _run(cmd: list) -> str | None:
    """``cmd``'s standard output, or None when it is missing or fails."""
    if shutil.which(cmd[0]) is None and not os.path.isfile(cmd[0]):
        return None
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def nvcc_version() -> str | None:
    """The last line of ``nvcc --version`` (its release), from ``PATH`` or
    ``$CUDA_HOME/bin``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for nvcc in ("nvcc", os.path.join(home, "bin", "nvcc")):
        out = _run([nvcc, "--version"])
        if out:
            return out.splitlines()[-1]
    return None


def card_lines() -> list:
    """One ``name, power limit`` line a card, from ``nvidia-smi``."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return [line.strip() for line in out.splitlines() if line.strip()] if out else []


def env_info() -> dict:
    import numpy
    import torch

    return {
        "`accelerate_tpu_torch` location": os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
        "Platform": platform.platform(),
        "Python version": platform.python_version(),
        "Numpy version": numpy.__version__,
        "PyTorch version": torch.__version__,
        "PyTorch CUDA": torch.version.cuda or "none (a CPU build)",
        "nvcc": nvcc_version() or "not found",
        "triton": "available" if is_triton_available() else "not installed",
        "CUDA cards visible to torch": torch.cuda.device_count(),
        "Cards (nvidia-smi name, power limit)": "; ".join(card_lines()) or "none",
    }


def env_command(args) -> None:
    info = env_info()
    print("\nCopy-and-paste the text below in your GitHub issue\n")
    print("\n".join(f"- {k}: {v}" for k, v in info.items()))
    accelerate_env = {k: v for k, v in os.environ.items() if k.startswith("ACCELERATE_")}
    if accelerate_env:
        print("- ACCELERATE_* environment:")
        print("\n".join(f"\t- {k}: {v}" for k, v in sorted(accelerate_env.items())))
    path = args.config_file or default_config_file()
    cfg = load_config_from_file(args.config_file) if (args.config_file or os.path.isfile(path)) \
        else None
    if cfg is not None:
        print(f"- `accelerate-tpu-torch` config ({path}):")
        print("\n".join(f"\t- {k}: {v}" for k, v in cfg.to_dict().items()))
    else:
        print("- `accelerate-tpu-torch` config: not found")


def main() -> None:
    env_command(env_command_parser().parse_args())


if __name__ == "__main__":
    main()
