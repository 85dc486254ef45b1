"""Step watchdog: a hung step becomes a loud exit that a relaunch resumes
from. Own copy of ``acr_wsss_tpu/utils/watchdog.py``.

The train loop must call :meth:`StepWatchdog.beat` within ``timeout_s``
of the previous beat; otherwise the watchdog thread reports the stall and
ends the process with ``EX_TEMPFAIL`` (75), and a supervisor
(``utils/supervisor.py``) relaunches it from the latest checkpoint.
``os._exit`` from the watchdog thread, not an exception, because the main
thread is stuck in native code (a device sync that never returns) and
cannot be unwound. CUDA launches return before the work is done, so the
beat belongs after the step's host sync: before it, a hung kernel would
never be seen.

The clock starts at the first beat, so the first step's warm-up never
counts against the budget; ``timeout_s <= 0`` disables the watchdog.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

EX_TEMPFAIL = 75


def _default_exit(message: str) -> None:
    print(message, file=sys.stderr, flush=True)
    os._exit(EX_TEMPFAIL)


class StepWatchdog:
    """Daemon-thread deadman switch around a progress loop."""

    def __init__(self, timeout_s: float, exit_fn: Optional[Callable[[str], None]] = None):
        self.timeout_s = float(timeout_s)
        self._exit_fn = exit_fn or _default_exit
        self._last: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._beats = 0

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def beat(self) -> None:
        """Record progress. The first beat arms the watchdog thread."""
        if not self.enabled:
            return
        self._last = time.monotonic()
        if self._thread is None:
            self._thread = threading.Thread(target=self._watch, daemon=True)
            self._thread.start()
        self._maybe_inject_hang()

    def _maybe_inject_hang(self) -> None:
        """Deterministic fault injection for supervisor tests.

        ``ACR_FAULT_HANG_ONCE=<sentinel path>``: on beat number
        ``ACR_FAULT_HANG_BEAT`` (default 2), if the sentinel does not exist
        yet, create it and block the calling (main) thread for good, as a
        device sync that never returns would. The watchdog thread then
        takes the real EX_TEMPFAIL exit; the relaunched process sees the
        sentinel and runs clean. No-op unless the variable is set."""
        sentinel = os.environ.get("ACR_FAULT_HANG_ONCE")
        if not sentinel:
            return
        self._beats += 1
        if (self._beats == int(os.environ.get("ACR_FAULT_HANG_BEAT", "2"))
                and not os.path.exists(sentinel)):
            with open(sentinel, "w") as f:
                f.write("hang injected\n")
            time.sleep(10 ** 9)  # blocked until the watchdog exits the process

    def stop(self) -> None:
        self._stop.set()

    def __enter__(self) -> "StepWatchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _watch(self) -> None:
        interval = max(0.05, min(self.timeout_s / 4.0, 10.0))
        while not self._stop.wait(interval):
            last = self._last
            if last is None:
                continue
            stalled = time.monotonic() - last
            if stalled > self.timeout_s:
                self._exit_fn(
                    f"watchdog: no train step completed in {stalled:.0f}s "
                    f"(> {self.timeout_s:.0f}s budget); exiting {EX_TEMPFAIL} so a "
                    "relaunch resumes from the last checkpoint")
                return
