"""Interrupt hardening for long training runs (a copy of the JAX package's
`utils/signals.py` training half).

The emergency checkpoint of `main.Experiment.train` fires only when a signal
unwinds Python as an exception. Two launch quirks break that: a shell that
starts a run as an async job with job control off sets SIGINT to SIG_IGN in
the child, so CPython installs no KeyboardInterrupt handler; and SIGTERM's
default action ends the process without unwinding Python. Reinstalling
`default_int_handler` undoes the first, mapping SIGTERM to KeyboardInterrupt
the second. `signal.signal` is legal only in the main thread, so elsewhere
(a test driving `train()` from a worker thread) nothing is installed.
"""

from __future__ import annotations

import signal
import threading


def _raise_keyboard_interrupt(signum, frame):  # noqa: ARG001
    raise KeyboardInterrupt(f"signal {signum}")


def install_interrupt_handlers() -> bool:
    """Make SIGINT and SIGTERM unwind the process as KeyboardInterrupt.
    Returns True when installed (main thread), False when skipped."""
    if threading.current_thread() is not threading.main_thread():
        return False
    signal.signal(signal.SIGINT, signal.default_int_handler)
    signal.signal(signal.SIGTERM, _raise_keyboard_interrupt)
    return True
