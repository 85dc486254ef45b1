"""Progress meters and timers (own copy of ``acr_wsss_tpu/utils/meters.py``:
``AverageMeter`` and ``Timer``, the reference's ``tool/pyutils.py:6-71``)."""

from __future__ import annotations

import time
from typing import Dict, Union


class AverageMeter:
    """Windowed running means of named scalar series: ``add`` accumulates,
    ``get`` reads the mean since the last ``pop``, ``pop`` reads and
    resets."""

    def __init__(self, *keys: str):
        self._data: Dict[str, list] = {k: [0.0, 0] for k in keys}

    def _slot(self, key: str):
        if key not in self._data:
            self._data[key] = [0.0, 0]
        return self._data[key]

    def add(self, values: Dict[str, float]) -> None:
        for k, v in values.items():
            slot = self._slot(k)
            slot[0] += float(v)
            slot[1] += 1

    def get(self, *keys: str) -> Union[float, tuple]:
        out = tuple(self._slot(k)[0] / max(self._slot(k)[1], 1) for k in keys)
        return out[0] if len(out) == 1 else out

    def pop(self, key: str = None):
        if key is None:
            out = {k: self.get(k) for k in self._data}
            for k in self._data:
                self._data[k] = [0.0, 0]
            return out
        value = self.get(key)
        self._data[key] = [0.0, 0]
        return value


class Timer:
    """Wall-clock timer with a progress-based finish estimate."""

    def __init__(self, starting_msg: str = None):
        self.start = time.time()
        self.stage_start = self.start
        self.est_total = None
        if starting_msg is not None:
            print(starting_msg, time.ctime(self.start))

    def update_progress(self, progress: float) -> None:
        elapsed = time.time() - self.start
        if progress > 0:
            self.est_total = elapsed / progress

    def str_est_finish(self) -> str:
        if self.est_total is None:
            return "unknown"
        return time.ctime(self.start + self.est_total)

    def get_stage_elapsed(self) -> float:
        return time.time() - self.stage_start

    def reset_stage(self) -> None:
        self.stage_start = time.time()
