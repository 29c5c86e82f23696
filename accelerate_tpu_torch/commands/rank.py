"""One rank of a launched job: ``launch`` starts every process as
``python <this file> [-m] <script> [args]``. It is started by its path, not
with ``-m``, so that a script that needs no torch starts without the
package's import.

The script (or, after ``-m``, the module) runs as ``__main__`` with the
``sys.argv`` and ``sys.path[0]`` that ``python <script>`` (or ``python -m``)
would give it. When it finishes cleanly (it returns, or exits with code 0),
the rank leaves the process group that the port's state joined through
``state.teardown_process_group``: it waits until every rank is done, then
destroys the group, so that no rank tears its gloo or NCCL group down while
a peer still works in a collective with it. When it fails (an exception, or
``sys.exit`` with another code), the rank leaves at once without that wait:
its peers may be blocked in a collective it never joins, and the launcher
stops them as soon as this rank's code comes back.
"""

from __future__ import annotations

import os
import sys


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    module = argv[:1] == ["-m"]
    if module:
        argv = argv[1:]
    if not argv:
        raise SystemExit(f"usage: python {__file__} [-m] <script> [args]")
    target = argv[0]
    sys.argv = argv
    # sys.path[0] is this file's folder, whose modules (config, test, ...)
    # would shadow the script's imports: set it first, as python would.
    sys.path[0] = os.getcwd() if module else os.path.dirname(os.path.abspath(target))
    import runpy

    try:
        if module:
            runpy.run_module(target, run_name="__main__", alter_sys=True)
        else:
            runpy.run_path(target, run_name="__main__")
    except SystemExit as exc:
        if exc.code not in (None, 0):
            raise
    state = sys.modules.get("accelerate_tpu_torch.state")  # None: the port never ran
    if state is not None:
        state.teardown_process_group()


if __name__ == "__main__":
    main()
