"""Shared bounded-retry policy: one backoff curve for every recovery path.

Three subsystems retry transient failures — the serve supervisor
restarting crashed workers, durable checkpoint writes riding out
transient OSErrors, and the rANS native-backend loader forcing one
rebuild before falling back to pure Python. Each previously would have
grown its own ad-hoc loop; this module is the single policy object they
all share, so "capped exponential backoff" means the same thing (and is
tested once) everywhere.

Deterministic by design: no jitter. The delay for attempt k is
``min(max_delay_s, base_delay_s * backoff ** k)`` — reproducible under
the fault-injection harness (utils/faults.py), which is what makes
chaos runs replayable from a seed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff: attempt k (0-based) sleeps
    ``min(max_delay_s, base_delay_s * backoff ** k)`` before retrying.
    ``max_attempts`` counts total tries, not retries (1 = no retry)."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    backoff: float = 2.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")

    def delay(self, attempt: int) -> float:
        """Backoff before retry number `attempt` (0-based)."""
        # cap the exponent: the serve supervisor feeds an ever-growing
        # per-slot restart count through here, and float `backoff **
        # attempt` raises OverflowError past ~2**1024 — which would kill
        # the supervisor thread mid-crash-loop. Beyond 64 doublings the
        # max_delay_s cap decides anyway (and backoff == 1 is constant).
        exponent = min(attempt, 64)
        return min(self.max_delay_s,
                   self.base_delay_s * self.backoff ** exponent)


def call_with_retry(fn: Callable, policy: RetryPolicy, *,
                    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                    on_retry: Optional[Callable[[int, BaseException],
                                                None]] = None,
                    sleep: Callable[[float], None] = time.sleep):
    """Call `fn()` up to `policy.max_attempts` times.

    Only exceptions matching `retry_on` are retried; anything else (and
    the final failure) propagates unmasked. `on_retry(attempt, exc)` runs
    before each backoff sleep — the hook recovery code uses to force a
    rebuild / reopen between attempts. `sleep` is injectable so tests
    assert the backoff curve without waiting it out.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if attempt >= policy.max_attempts - 1:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            delay = policy.delay(attempt)
            if delay > 0:
                sleep(delay)
            attempt += 1
