"""Why ``chip_smoke.py`` phase 15 trains Swin from trained-like weights.

The recipe (lr 0.05, alpha 125, SGD with momentum 0.9) from the seeded
init (``init_random_``: biases 0, norm scales 1) diverges at crop 384 on
images that do not fill the crop: the pad-crop's zero pixels give patch
tokens that are all 0 after the bias-free patch embedding, the LayerNorm
after it divides their gradient by sqrt(eps) (eps 1e-5), and the first
update moves the patch embedding's bias by about 1e13. This script shows
that the JAX package does the same, step for step, and that the same
recipe from weights whose biases and norm scales are nonzero, as a
trained checkpoint's are (``chip_smoke.trained_like``), stays finite:

* the port and JAX's ``make_swin_train_step``, float32 on the CPU, at
  swin_base_384's widths and window (12) with depths (2, 2, 2, 2), crop
  384, batch 4, on ``chip_smoke``'s fixture (16 JPEGs of 375x500 and
  500x375), 4 steps from the same seeded init: loss parts and the largest
  |patch_embed bias| after each update;
* the port alone, 5 steps from the trained-like weights.

    python docs/swin_seeded_init_probe.py      # from the repository's root, CPU
"""

import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from acr_wsss_tpu_torch.data import voc as voc_data  # noqa: E402
from acr_wsss_tpu_torch.models.acr import init_random_  # noqa: E402
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax  # noqa: E402
from acr_wsss_tpu_torch.models.swin import SwinTransformer  # noqa: E402
from acr_wsss_tpu_torch.train_swin import make_swin_train_step  # noqa: E402
from acr_wsss_tpu_torch.utils.schedule import make_optimizer  # noqa: E402

CROP, LR, STEPS = 384, 0.05, 4
WIDTHS = dict(num_classes=20, embed_dim=128, depths=(2, 2, 2, 2), num_heads=(4, 8, 16, 32),
              window_size=12)


def port_run(flat, cfg, batches):
    model = SwinTransformer(img_size=CROP, dtype=torch.float32, **WIDTHS)
    model.load_state_dict(flax_to_state_dict(flat, model.state_dict()))
    step = make_swin_train_step(model, make_optimizer(model.parameters(), LR, STEPS), cfg,
                                CROP, torch.device("cpu"))
    for batch in batches:
        parts = {k: float(v) for k, v in step(batch).items()}
        yield parts, model.patch_embed.bias.abs().max().item()


def jax_run(flat, batches):
    import jax
    import jax.numpy as jnp

    from acr_wsss_tpu import train_swin as jax_train_swin
    from acr_wsss_tpu.configs import ModelConfig, TrainConfig
    from acr_wsss_tpu.models.swin import SwinTransformer as JaxSwin
    from acr_wsss_tpu.train import TrainState
    from acr_wsss_tpu.utils.schedule import make_optimizer as jax_make_optimizer
    from tests.torch_port_helpers import unflatten_params

    model = JaxSwin(dtype=jnp.float32, **WIDTHS)
    cfg = TrainConfig(model=ModelConfig(backbone="swin"), crop_size=CROP, batch_size=4)
    state = TrainState.create(apply_fn=model.apply, params=unflatten_params(flat),
                              tx=jax_make_optimizer(LR, STEPS, 5e-4, 0.9, 0.9))
    step = jax.jit(jax_train_swin.make_swin_train_step(model, cfg, CROP))
    for batch in batches:
        state, parts = step(state, {k: jnp.asarray(batch[k]) for k in ("image", "label")})
        yield ({k: float(v) for k, v in parts.items()},
               float(jnp.abs(state.params["params"]["patch_embed"]["bias"]).max()))


def main():
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(cs.make_train_fixture(tmp, seed=0), crop_size=CROP,
                                  device="cpu")
        labels = voc_data.load_cls_labels(cfg.cls_labels_path)
        it = voc_data.TrainIterator(voc_data.VOCClassificationSource(cfg.image_dir, labels, CROP),
                                    voc_data.read_file(cfg.train_list), 4, num_workers=4)
        batches = [next(it) for _ in range(STEPS + 1)]
        it.close()
        seeded = {k: v.copy() for k, v in state_dict_to_flax(
            init_random_(SwinTransformer(img_size=CROP, **WIDTHS), seed=0)).items()}
        print(f"seeded init, lr {LR}, crop {CROP}, depths {WIDTHS['depths']}, float32, CPU:")
        for i, (port, jax_) in enumerate(zip(port_run(seeded, cfg, batches[:STEPS]),
                                             jax_run(seeded, batches[:STEPS]))):
            for name, (parts, bias) in (("port", port), ("jax ", jax_)):
                print(f"  step {i} {name}: " + ", ".join(f"{k} {v:.6g}" for k, v in
                                                         sorted(parts.items()))
                      + f"; max |patch_embed bias| after the update {bias:.4g}", flush=True)
        print("trained-like weights (chip_smoke.trained_like), the port:")
        for i, (parts, bias) in enumerate(port_run(cs.trained_like(seeded, 1), cfg, batches)):
            print(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(parts.items()))
                  + f"; max |patch_embed bias| {bias:.4g}", flush=True)


if __name__ == "__main__":
    main()
