"""``accelerate-tpu-torch test`` — the bundled distributed checks through the
launcher; the counterpart of ``accelerate_tpu/commands/test.py``.

Runs ``python -m accelerate_tpu_torch.test_utils.test_script`` under
``launch`` (with ``--config_file`` when given, so the checks run on the
configured layout: every visible card unless the config says otherwise, or
gloo ranks with its ``use_cpu``), and reports success or the script's
exit code.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def test_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = "Run accelerate-tpu-torch's install/config check through the launcher"
    if subparsers is not None:
        parser = subparsers.add_parser("test", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch test", description=description)
    parser.add_argument("--config_file", default=None, help="Config file to test with")
    if subparsers is not None:
        parser.set_defaults(func=test_command)
    return parser


def test_command(args) -> None:
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.launch"]
    if args.config_file is not None:
        cmd += ["--config_file", args.config_file]
    cmd += ["-m", "accelerate_tpu_torch.test_utils.test_script"]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    result = subprocess.run(cmd, env=env)
    if result.returncode == 0:
        print("Test is a success! You are ready for your distributed training!")
    else:
        raise SystemExit(result.returncode)


def main() -> None:
    test_command(test_command_parser().parse_args())


if __name__ == "__main__":
    main()
