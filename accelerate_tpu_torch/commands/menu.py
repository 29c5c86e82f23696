"""Cursor-driven selection menu for the config wizard — the port's copy of
``accelerate_tpu/commands/menu.py``.

Arrow keys (or vi's j/k, or a digit) move a highlight over the choices,
Enter selects, and the menu redraws in place (POSIX terminals, ANSI
escapes). Sessions that are not a terminal on both ends (pipes, CI, tests
that feed ``input()``) never enter the raw-terminal path: the wizard keeps
its plain prompts there.
"""

from __future__ import annotations

import sys

_UP_KEYS = ("\x1b[A", "k")
_DOWN_KEYS = ("\x1b[B", "j")
_ENTER_KEYS = ("\r", "\n")
_INTERRUPT_KEYS = ("\x03",)  # Ctrl-C
_HOME_KEYS = ("\x1b[H",)
_END_KEYS = ("\x1b[F",)


def interactive_tty() -> bool:
    """True when both ends are real terminals AND raw mode is available."""
    try:
        import termios  # noqa: F401  (POSIX only)
        import tty  # noqa: F401
    except ImportError:
        return False
    try:
        return sys.stdin.isatty() and sys.stdout.isatty()
    except (AttributeError, ValueError):
        return False


def _read_key() -> str:
    """One keypress in raw mode; arrow keys return their full CSI sequence."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        ch = sys.stdin.read(1)
        if ch == "\x1b":
            nxt = sys.stdin.read(1)
            if nxt == "[":
                # CSI sequences end at a final byte in @..~ (0x40-0x7e);
                # parameterized forms (Shift+Down = \x1b[1;2B, PgUp =
                # \x1b[5~) carry parameter bytes first — consume the whole
                # sequence so leftovers can't replay as fake keypresses.
                seq = "\x1b["
                while True:
                    b = sys.stdin.read(1)
                    if not b:
                        return seq
                    seq += b
                    if "@" <= b <= "~":
                        return seq
            return ch
        return ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def select(prompt: str, choices, default=None, *, read_key=None, out=None):
    """Arrow-key selection over ``choices``; returns the chosen element.

    ``read_key``/``out`` are injection points for tests (and must not be used
    to bypass the TTY check in production callers — use ``interactive_tty()``
    to decide whether to call this at all).
    """
    read_key = read_key or _read_key
    out = out or sys.stdout
    labels = [str(c) for c in choices]
    n = len(labels)
    if n == 0:
        raise ValueError("select() needs at least one choice")
    try:
        idx = list(choices).index(default) if default is not None else 0
    except ValueError:
        idx = 0

    out.write(f"{prompt} (↑/↓ or j/k, Enter to accept)\n")

    def render(first: bool = False):
        if not first:
            out.write(f"\x1b[{n}A")  # cursor up over the menu block
        for i, lab in enumerate(labels):
            cursor = "➤ " if i == idx else "  "
            style = ("\x1b[7m", "\x1b[0m") if i == idx else ("", "")
            out.write("\x1b[2K" + cursor + style[0] + lab + style[1] + "\n")
        out.flush()

    render(first=True)
    while True:
        key = read_key()
        if key in _UP_KEYS:
            idx = (idx - 1) % n
        elif key in _DOWN_KEYS:
            idx = (idx + 1) % n
        elif key in _HOME_KEYS:
            idx = 0
        elif key in _END_KEYS:
            idx = n - 1
        elif key.isdigit() and 1 <= int(key) <= n:
            idx = int(key) - 1
        elif key in _ENTER_KEYS:
            render()
            return list(choices)[idx]
        elif key in _INTERRUPT_KEYS:
            raise KeyboardInterrupt
        render()
