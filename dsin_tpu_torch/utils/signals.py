"""Interrupt hardening for long training runs, and the drain handlers of a
long-lived service (a copy of the JAX package's `utils/signals.py`).

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


def install_drain_handlers(drain) -> bool:
    """Route SIGINT/SIGTERM to `drain()` instead of unwinding (the serving
    half of the JAX package's `utils/signals.py`).

    A long-lived service must not die mid-batch on a deploy's SIGTERM: it
    stops ACCEPTING work and finishes what is in flight. `drain` must
    therefore be fast and non-blocking (flip a flag, close a queue); the
    wait for in-flight work happens in the serve loop, never inside a
    signal handler. A second signal falls back to the interrupt handlers
    above, so a stuck drain can still be interrupted the ordinary way.

    Returns True when installed (main thread only), False when skipped;
    the caller then drains via its own stop API instead."""
    if threading.current_thread() is not threading.main_thread():
        return False

    def _drain_once(signum, frame):  # noqa: ARG001
        install_interrupt_handlers()  # second signal: hard interrupt
        drain()

    signal.signal(signal.SIGINT, _drain_once)
    signal.signal(signal.SIGTERM, _drain_once)
    return True
