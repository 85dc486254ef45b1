"""Shared set-up of the parity tests between the JAX package and its port.

Weights are made with numpy from a seed in the flax layout, flattened with
"/"-joined paths as ``save_params_npz`` writes them, and handed to both
sides: to JAX as a param tree, to the port through its converter.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu_torch.models.acr import ACR as TorchACR
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict


def flatten_params(tree):
    """{"/".joined flax path: leaf}, as ``save_params_npz`` names them."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in flat}


def unflatten_params(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def random_flax_params(jax_module, example, seed):
    """Seeded numpy weights in the flax layout of ``jax_module``: fan-in
    normal kernels, scales 1 + N(0, 0.1^2), biases and tokens N(0, 0.1^2)
    (nonzero, so that a mapping mistake shows), pos_embed N(0, 0.02^2)."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.key(0), example))
    rng = np.random.default_rng(seed)
    flat = {}
    for key, leaf in flatten_params(shapes).items():
        shape = leaf.shape
        name = key.rsplit("/", 1)[-1]
        if name == "kernel":
            val = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "pos_embed":
            val = 0.02 * rng.standard_normal(shape)
        else:
            val = 0.1 * rng.standard_normal(shape)
        flat[key] = val.astype(np.float32)
    return flat


def build_acr_pair(crop, seed=0, backbone="vitb_hybrid", jax_impl="xla",
                   torch_impl="kernel"):
    """(jax model, jax params, port model) in float32 on shared weights."""
    jax_model = JaxACR(backbone_name=backbone, dtype=jnp.float32, attn_impl=jax_impl)
    flat = random_flax_params(jax_model, jnp.zeros((1, crop, crop, 3)), seed)
    port = TorchACR(backbone_name=backbone, dtype=torch.float32, attn_impl=torch_impl)
    port.load_state_dict(flax_to_state_dict(flat, port.state_dict()))
    port.requires_grad_(False).eval()
    return jax_model, unflatten_params(flat), port
