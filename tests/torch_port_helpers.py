"""Shared set-up of the parity tests between the JAX package and its port.

Weights are made with numpy from a seed in the flax layout, flattened with
"/"-joined paths as ``save_params_npz`` writes them, and handed to both
sides: to JAX as a param tree, to the port through its converter.
``write_coco`` writes a tiny synthetic COCO layout (images, bbox txts).
``dpt_flax_params`` and ``jax_dpt_apply`` are cached per process, so the
segmentation test files that one worker runs trace and compile JAX's DPT
model once per backbone (and dtype).
"""

import functools

import numpy as np
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu.models.dpt import DPTSegmentationModel as JaxDPT
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


def random_flax_params(jax_module, example, seed, args=()):
    """Seeded numpy weights in the flax layout of ``jax_module`` (called on
    ``example`` and ``args``): fan-in normal kernels, scales
    1 + N(0, 0.1^2), biases and tokens N(0, 0.1^2) (nonzero, so that a
    mapping mistake shows), pos_embed N(0, 0.02^2)."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.key(0), example, *args))
    return _draw_flax_params({k: v.shape for k, v in flatten_params(shapes).items()}, seed)


def _draw_flax_params(shapes, seed):
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in shapes.items():
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


@functools.lru_cache(maxsize=None)
def _dpt_param_shapes(backbone, crop):
    model = JaxDPT(backbone_name=backbone)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, crop, crop, 3))))
    return {k: v.shape for k, v in flatten_params(shapes).items()}


@functools.lru_cache(maxsize=None)
def dpt_flax_params(backbone, seed, crop=32):
    """``random_flax_params`` of JAX's ``DPTSegmentationModel``; callers
    must not modify the arrays."""
    return _draw_flax_params(_dpt_param_shapes(backbone, crop), seed)


@functools.lru_cache(maxsize=None)
def jax_dpt_apply(backbone, dtype="float32"):
    """The jitted ``apply`` of JAX's ``DPTSegmentationModel``."""
    return jax.jit(JaxDPT(backbone_name=backbone, dtype=getattr(jnp, dtype)).apply)


def assert_within_one_bf16_ulp(actual, desired, atol=1e-6):
    """|actual - desired| <= one bfloat16 ulp of desired (2^(e - 7) for
    |desired| in [2^e, 2^(e + 1))) + atol, elementwise."""
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape
    tiny = np.finfo(np.float32).tiny
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(desired), tiny))) - 7)
    err = np.abs(actual - desired)
    bad = err > ulp + atol
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} elements more than one bf16 ulp "
                           f"apart, max abs err {err.max():.3g}")


def build_acr_pair(crop, seed=0, backbone="vitb_hybrid", jax_impl="xla",
                   torch_impl="kernel"):
    """(jax model, jax params, port model) in float32 on shared weights."""
    jax_model = JaxACR(backbone_name=backbone, dtype=jnp.float32, attn_impl=jax_impl)
    flat = random_flax_params(jax_model, jnp.zeros((1, crop, crop, 3)), seed)
    port = TorchACR(backbone_name=backbone, dtype=torch.float32, attn_impl=torch_impl)
    port.load_state_dict(flax_to_state_dict(flat, port.state_dict()))
    port.requires_grad_(False).eval()
    return jax_model, unflatten_params(flat), port


def write_coco(root, seed=0, n_train=6, n_val=3):
    """Train and val image directories of small JPEGs and one bbox txt per
    image (``x y category_id ...`` lines, some repeated, one short line)."""
    from acr_wsss_tpu_torch.data import coco

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            name = f"COCO_{split}2014_{i:012d}"
            h, w = ((48, 64), (64, 40), (40, 40))[i % 3]
            Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(
                root / split / f"{name}.jpg")
            cats = rng.choice(coco.COCO_CATEGORY_IDS, size=int(rng.integers(1, 4)))
            lines = [f"{rng.integers(0, w)} {rng.integers(0, h)} {c} 5 5" for c in cats]
            (root / "bbox").mkdir(exist_ok=True)
            (root / "bbox" / f"{name}.txt").write_text("\n".join(lines + ["x"]) + "\n")
    (root / "train" / "notes.txt").write_text("not an image\n")
    return root
