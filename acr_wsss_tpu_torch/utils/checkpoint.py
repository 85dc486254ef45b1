"""Weights saved by the JAX package, read with numpy alone.

``save_params_npz`` (``acr_wsss_tpu/utils/checkpoint.py``) writes one array
per flax leaf under its "/"-joined path, e.g.
``params/trunk/blocks_0/attn/qkv/kernel``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat ``{flax_path: array}`` of a ``save_params_npz`` file; feed it to
    :func:`acr_wsss_tpu_torch.models.convert.flax_to_state_dict`."""
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}
