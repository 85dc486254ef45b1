"""Preemption-safe training: own copy of ``acr_wsss_tpu/utils/preemption.py``.

A cloud VM gets SIGTERM shortly before a preemption or maintenance event
kills the process. :class:`PreemptionGuard` turns SIGTERM and SIGINT into
a flag that the train loop reads at each step boundary, where it saves a
checkpoint and stops; the next launch resumes from it::

    with PreemptionGuard() as guard:
        for step in ...:
            ...
            if guard.fired:
                ckpt.save(step, ...)
                break

The guard installs handlers only in the main thread (Python restricts
``signal.signal`` to it); elsewhere it is inert and ``fired`` stays
False. The previous handlers are restored on exit, and a second signal
falls through to the previous handler, so a double Ctrl-C still kills a
hung run.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.fired = False
        self._previous = {}

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.SIGNALS:
            self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def _handle(self, signum, frame) -> None:
        if self.fired:
            # second signal: defer to the original handler (default
            # SIGTERM terminates; SIGINT raises KeyboardInterrupt)
            prev = self._previous.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self.fired = True
        print(f"signal {signal.Signals(signum).name} received: will "
              "checkpoint and stop at the next step boundary "
              "(signal again to force-quit)", flush=True)
