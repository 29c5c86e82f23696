"""``accelerate-tpu-torch`` — the command dispatcher; the counterpart of
``accelerate_tpu/commands/accelerate_cli.py``.

``accelerate-tpu-torch <config|env|launch|test|estimate-memory|merge-weights>``.
The JAX package's other commands have no port yet (``commands/__init__.py``).
"""

from __future__ import annotations

import argparse

from .config import config_command_parser
from .env import env_command_parser
from .estimate import estimate_command_parser
from .launch import launch_command_parser
from .merge import merge_command_parser
from .test import test_command_parser


def main() -> None:
    parser = argparse.ArgumentParser("accelerate-tpu-torch",
                                     usage="accelerate-tpu-torch <command> [<args>]",
                                     allow_abbrev=False)
    subparsers = parser.add_subparsers(help="accelerate-tpu-torch command helpers")
    for add in (config_command_parser, env_command_parser, launch_command_parser,
                estimate_command_parser, merge_command_parser, test_command_parser):
        add(subparsers=subparsers)
    args = parser.parse_args()
    if not hasattr(args, "func"):
        parser.print_help()
        raise SystemExit(1)
    args.func(args)


if __name__ == "__main__":
    main()
