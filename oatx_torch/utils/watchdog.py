"""Step watchdog — hang detection for long training runs (port of
oatx/utils/watchdog.py).

The reference has no failure detection at all. This watchdog
watches a heartbeat the train loop beats once per step; if no beat arrives for
`timeout_s`, it logs a warning with a stack dump of every thread (so a hung
device sync, a stuck data-loader thread, or a wedged collective is diagnosable
from the log), repeating with backoff. Purely observational — it never kills
the run (the platform's own preemption/restart owns that).
"""

from __future__ import annotations

import faulthandler
import io
import logging
import sys
import threading
import time
import traceback
from typing import Optional


class StepWatchdog:
    def __init__(self, timeout_s: float = 600.0,
                 logger: Optional[logging.Logger] = None,
                 dump_stacks: bool = True):
        self.timeout_s = timeout_s
        self.logger = logger or logging.getLogger("oatx_torch.watchdog")
        self.dump_stacks = dump_stacks
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._warned = 0

    def beat(self) -> None:
        self._last_beat = time.monotonic()
        self._warned = 0

    def start(self) -> "StepWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="oatx_torch-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(min(self.timeout_s / 4, 30.0)):
            stalled = time.monotonic() - self._last_beat
            if stalled > self.timeout_s * (2 ** self._warned):
                self._warned += 1
                msg = (f"no training step completed for {stalled:.0f}s "
                       f"(threshold {self.timeout_s:.0f}s) — possible hang")
                if self.dump_stacks:
                    buf = io.StringIO()
                    for tid, frame in sys._current_frames().items():
                        buf.write(f"\n--- thread {tid} ---\n")
                        traceback.print_stack(frame, file=buf)
                    msg += buf.getvalue()
                self.logger.warning(msg)

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()
