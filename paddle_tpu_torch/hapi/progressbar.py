"""A text progress bar (counterpart of
``paddle_tpu/hapi/progressbar.py``)."""
from __future__ import annotations

import sys
import time

__all__ = ["ProgressBar"]


class ProgressBar:
    def __init__(self, num=None, width=30, verbose=1, start=True,
                 file=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self._file = file
        self._start_ts = time.time() if start else None
        self._last = 0

    def start(self):
        self._start_ts = time.time()

    def update(self, current_num, values=None):
        vals = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                          else f"{k}: {v}" for k, v in (values or []))
        if self._verbose == 1 and self._num:
            frac = min(current_num / self._num, 1.0)
            fill = int(frac * self._width)
            bar = "=" * fill + "." * (self._width - fill)
            self._file.write(f"\rstep {current_num}/{self._num} [{bar}] "
                             f"{vals}")
            if current_num >= self._num:
                self._file.write("\n")
        elif self._verbose == 2:
            self._file.write(f"step {current_num} {vals}\n")
        self._file.flush()
        self._last = current_num
