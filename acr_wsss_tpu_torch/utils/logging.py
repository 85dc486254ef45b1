"""Structured metric logging: the port's copy of ``MetricWriter``
(``acr_wsss_tpu/utils/logging.py``), as the train loop uses it.

Training metrics stream to a JSONL file, one record per event with a
wall-clock time and the step, beside the reference-style console lines.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricWriter:
    """Append-only JSONL metric stream; with ``path`` None it writes
    nothing (the ranks other than 0 of a data-parallel run)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._file = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "a", buffering=1)

    def write(self, step: int, metrics: Dict[str, Any], kind: str = "train") -> None:
        if self._file is None:
            return
        record = {
            "time": time.time(),
            "step": int(step),
            "kind": kind,
            **{k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()},
        }
        self._file.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
