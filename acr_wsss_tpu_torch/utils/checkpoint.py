"""Weights in the JAX package's flat flax npz format, with numpy alone.

``save_params_npz`` (``acr_wsss_tpu/utils/checkpoint.py``) writes one array
per flax leaf under its "/"-joined path, e.g.
``params/trunk/blocks_0/attn/qkv/kernel``; the port reads and writes the
same format (``models/convert.py`` maps it to and from a ``state_dict``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


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
