"""Wall-clock context-manager timer (reference: numbskull/timer.py:7-18)."""

from __future__ import annotations

import time


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        self.interval = self.end - self.start
        return False
