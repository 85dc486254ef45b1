"""Weights in the JAX package's flat flax npz format, with numpy alone, and
step-numbered training checkpoints.

``save_params_npz`` (``acr_wsss_tpu/utils/checkpoint.py``) writes one array
per flax leaf under its "/"-joined path, e.g.
``params/trunk/blocks_0/attn/qkv/kernel``; the port reads and writes the
same format (``models/convert.py`` maps it to and from a ``state_dict``).
It stays the interchange format between the two packages.

``CheckpointManager`` is the counterpart of the JAX package's orbax
manager (``:17-47``): step-numbered entries, the newest ``max_to_keep``
kept, restore of the latest. An entry is one ``torch.save`` file,
``<directory>/<step>.pt``, of whatever state the trainer hands it (there:
model and optimizer ``state_dict``s and the step); the port does not read
orbax's format. Like orbax, a save returns before the file is written:
``save`` copies every tensor to host memory, then a thread writes the
copy to a temporary name and renames it into place with ``os.replace``,
so a process killed during a save leaves the previous entries readable
and no partial entry under a step's name.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_ENTRY = re.compile(r"^(\d+)\.pt$")


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat ``{flax_path: array}`` of a ``save_params_npz`` file; feed it to
    :func:`acr_wsss_tpu_torch.models.convert.flax_to_state_dict`."""
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def save_params_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write a flat ``{flax_path: array}`` dict (e.g. from
    :func:`acr_wsss_tpu_torch.models.convert.state_dict_to_flax`) as the
    JAX package's ``save_params_npz`` does."""
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` whose tensors live in host memory and share no
    storage with the originals (the trainer updates those in place)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def steps(self) -> List[int]:
        """Steps of the complete entries, oldest first; temporary files of
        an interrupted save are not entries."""
        return sorted(int(m[1]) for m in map(_ENTRY.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Copy ``state`` to host memory now, write it on a thread; a save
        still in flight is waited for first."""
        self.wait()
        host = _to_host(state)
        self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
        self._thread.start()

    def _write(self, step: int, host: Any) -> None:
        try:
            tmp = self._path(step) + f".tmp{os.getpid()}"
            torch.save(host, tmp)
            os.replace(tmp, self._path(step))
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        except BaseException as e:  # re-raised by wait() in the caller's thread
            self._error = e

    def restore(self, step: Optional[int] = None) -> Any:
        """The entry of ``step`` (default: the latest) in host memory, or
        None if there is none."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()
