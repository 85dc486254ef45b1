"""Serving export: the CAM-inference program as one ``torch.export``
artifact that loads without this package.

Counterpart of ``acr_wsss_tpu/serving.py`` (``export_infer``,
``save_exported``, ``load_exported``, ``main``; ``:52-159``). The whole
inference computation of ``infer_cam.build_infer_fn`` (the trunk forward
with GETAM's gradient taps, one backward per class slot, the affinity
refinement, the patch-CAM head) is traced into one shape-static graph of
ATen ops and saved as a ``.pt2``, which any PyTorch loads::

    # producer (this repo)
    python -m acr_wsss_tpu_torch.serving --weights weight/acr_last.npz \\
        --backbone vitb_hybrid --crop 384 --out acr_cam.pt2 [--device cuda]

    # consumer: PyTorch alone
    program = torch.export.load("acr_cam.pt2").module()
    params = torch.load("acr_cam_params.pt", weights_only=True)
    out = program(params, images, class_ids)

The calling convention is JAX's: ``call(params, x, class_ids)``, or
``call(x, class_ids)`` with ``--embed_weights``; ``params`` is a flat dict
of tensors named as the model's ``state_dict`` (the CLI writes it beside
the artifact as ``<out>_params.pt``), ``x`` the (batch, crop, crop, 3)
float32 normalized images (batch 2 serves the flip-TTA pair) and
``class_ids`` the (K,) int64 class slots to backpropagate, K =
``class_slots`` or ``num_classes``. It returns {"cams", "patch_cam",
"logits"}. The artifact is built for one device (``--device``, default
``cuda``) and takes its inputs there.

The artifact runs the plain attention path, as JAX's exports the XLA path
and not its Pallas kernels (``serving.py:27-31``), and for a reason of
the same kind: the hand-written kernels launch through ``ctypes``, which a
trace cannot see, so a launch would enter the graph as the constant that
its output buffer held when traced. ``export_infer`` therefore refuses a
model with kernel attention. The tap policy is the live path's
(``getam.tap_config``, through ``build_infer_fn``).

``torch.export.export`` of a function that calls ``torch.autograd.grad``
fails, so the function is first traced by ``make_fx``, which records the
forward and every backward as ATen ops, and that graph is exported; the
class ids flow through it as a tensor (``getam_cams`` indexes the logits
with them), so they are an input and not a constant.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
from torch.fx.experimental.proxy_tensor import make_fx

from acr_wsss_tpu_torch.configs import ModelConfig, parse_bool
from acr_wsss_tpu_torch.getam import GETAM_FUNCS
from acr_wsss_tpu_torch.infer_cam import build_infer_fn


class _Program(nn.Module):
    """``infer`` as a module over ``model``, so that ``functional_call``
    can hand it the caller's parameters (named ``model.<state_dict key>``)."""

    def __init__(self, model: nn.Module, infer):
        super().__init__()
        self.model = model
        self.infer = infer

    def forward(self, x, class_ids):
        return self.infer(x, class_ids)


def export_infer(model: nn.Module, crop_size: int, batch: int = 2, *, start_layer: int = 10,
                 getam_func: str = "grad", use_aff: bool = True, num_classes: int = 20,
                 class_slots: int = 0, embed_weights: bool = False
                 ) -> torch.export.ExportedProgram:
    """Trace and export the CAM-inference program of ``model`` (an ACR with
    plain attention, on the artifact's device) for ``batch`` images of
    ``crop_size``. Without ``embed_weights`` the program takes the
    parameters as its first argument; with it, ``model``'s are constants."""
    if getam_func not in GETAM_FUNCS:
        raise ValueError(f"getam_func must be one of {GETAM_FUNCS}")
    if any(getattr(m, "attn_impl", None) == "kernel" for m in model.modules()):
        raise ValueError("export_infer traces plain attention only (attn_impl='plain'): a "
                         "trace cannot see a ctypes kernel launch, whose output would be "
                         "baked into the graph")
    infer = build_infer_fn(model, crop_size, start_layer, getam_func, use_aff, num_classes,
                           class_slots=class_slots)
    x = torch.zeros((batch, crop_size, crop_size, 3), dtype=torch.float32, device=infer.device)
    ids = torch.arange(class_slots or num_classes, device=infer.device)
    if embed_weights:
        args = (x, ids)
        graph = make_fx(infer)(*args)
    else:
        program = _Program(model, infer)

        def call(params: Dict[str, torch.Tensor], x, class_ids):
            named = {f"model.{k}": v for k, v in params.items()}
            return torch.func.functional_call(program, named, (x, class_ids))

        args = ({k: v.detach() for k, v in model.state_dict().items()}, x, ids)
        graph = make_fx(call)(*args)
    exported = torch.export.export(graph, args)
    exported.example_inputs = None     # would save a copy of the parameters
    return exported


def save_exported(path: str, exported: torch.export.ExportedProgram) -> None:
    torch.export.save(exported, path)


def load_exported(path: str):
    """The saved program as a callable; needs PyTorch alone."""
    return torch.export.load(path).module()


def main(argv: Optional[Sequence[str]] = None) -> None:
    from acr_wsss_tpu_torch.models.convert import flax_to_state_dict
    from acr_wsss_tpu_torch.train import build_model
    from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weights", required=True, help="npz param file")
    parser.add_argument("--backbone", default="vitb_hybrid")
    parser.add_argument("--crop", default=384, type=int)
    parser.add_argument("--batch", default=2, type=int,
                        help="images per call (2 = the flip-TTA pair)")
    parser.add_argument("--start_layer", default=10, type=int)
    parser.add_argument("--getam_func", default="grad", choices=GETAM_FUNCS)
    parser.add_argument("--aff", default=True, type=parse_bool)
    parser.add_argument("--num_classes", default=20, type=int)
    parser.add_argument("--class_slots", default=0, type=int)
    parser.add_argument("--embed_weights", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    model = build_model(ModelConfig(backbone=args.backbone, num_classes=args.num_classes,
                                    attn_impl="plain"))
    model.load_state_dict(flax_to_state_dict(load_params_npz(args.weights),
                                             model.state_dict()))
    model.to(args.device)
    exported = export_infer(model, args.crop, args.batch, start_layer=args.start_layer,
                            getam_func=args.getam_func, use_aff=args.aff,
                            num_classes=args.num_classes, class_slots=args.class_slots,
                            embed_weights=args.embed_weights)
    save_exported(args.out, exported)
    size = os.path.getsize(args.out)
    if args.embed_weights:
        convention = "call(x, class_ids)"
    else:
        params_path = os.path.splitext(args.out)[0] + "_params.pt"
        torch.save({k: v.detach() for k, v in model.state_dict().items()}, params_path)
        convention = f"call(params, x, class_ids), params in {params_path}"
    print(f"exported {args.out} ({size / 1e6:.1f} MB, device {args.device}, "
          f"calling convention: {convention})")


if __name__ == "__main__":
    main()
