"""How often two identical ``train_swin`` steps differ on the card, and which
operations of the step PyTorch calls nondeterministic.

Runs the step of ``tests/test_torch_cuda.py::test_swin_step_gives_the_same_
bits_twice`` (a small Swin: width 32, window 4, crop 64, batch 2, TF32 off)
``--pairs`` times per dtype in one process, each pair from the same weights
and batch, and prints for each dtype how many pairs differed and, for the
first that did, the loss parts and parameters that differ and by how much.
Then it runs one more step under ``torch.use_deterministic_algorithms(True,
warn_only=True)`` and prints each distinct warning: the operations of the
step that have no deterministic CUDA implementation.

    python docs/swin_determinism_probe.py [--pairs 8] [--load]

``--load`` runs the pairs while another process keeps the card busy with
float32 and bf16 matrix products (it is stopped at the end): whether
another process's work on the card changes the step's bits.

Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys
import warnings

import numpy as np
import torch

from acr_wsss_tpu_torch.configs import TrainConfig
from acr_wsss_tpu_torch.models.acr import init_random_
from acr_wsss_tpu_torch.models.swin import SwinTransformer
from acr_wsss_tpu_torch.train_swin import make_swin_train_step
from acr_wsss_tpu_torch.utils.schedule import make_optimizer

KW = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), window_size=4, img_size=64)


def one_step(weights, batch, cfg, dtype, device):
    model = SwinTransformer(**KW, dtype=dtype)
    model.load_state_dict(weights)
    model.to(device)
    opt = make_optimizer(model.parameters(), cfg.lr, 4)
    parts = make_swin_train_step(model, opt, cfg, 64, device)(batch)
    torch.cuda.synchronize()
    return ({k: v.detach().clone() for k, v in parts.items()},
            {k: v.detach().clone() for k, v in model.state_dict().items()})


def differences(a, b) -> dict:
    """Name -> largest absolute difference, for the tensors that differ."""
    return {k: float((a[k].double() - b[k].double()).abs().max()) for k in a
            if not torch.equal(a[k], b[k])}


# Another process's load on the card: products until it is killed.
LOAD = """
import torch
torch.backends.cuda.matmul.allow_tf32 = False
a = torch.randn(4096, 4096, device="cuda")
b = a.bfloat16()
a @ a
torch.cuda.synchronize()
print("busy", flush=True)
while True:
    for _ in range(20):
        a @ a
        b @ b
    torch.cuda.synchronize()
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--load", action="store_true",
                    help="run the pairs while another process keeps the card busy")
    args = ap.parse_args()
    load = (subprocess.Popen([sys.executable, "-c", LOAD], stdout=subprocess.PIPE, text=True)
            if args.load else None)
    try:
        if load is not None:
            load.stdout.readline()           # "busy": its products have started
        run(args)
    finally:
        if load is not None:
            load.kill()
            load.wait()


def run(args) -> None:
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    weights = init_random_(SwinTransformer(**KW), seed=1).state_dict()
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             "label": (rng.uniform(size=(2, 20)) > 0.7).astype(np.float32)}
    cfg = TrainConfig(crop_size=64, batch_size=2, device="cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    for dtype in (torch.float32, torch.bfloat16):
        differ, first = 0, None
        for _ in range(args.pairs):
            (pa, wa), (pb, wb) = (one_step(weights, batch, cfg, dtype, device)
                                  for _ in range(2))
            d = {**differences(pa, pb), **differences(wa, wb)}
            if d:
                differ += 1
                first = first or d
        print(json.dumps({"dtype": str(dtype)[6:], "pairs": args.pairs, "load": args.load,
                          "pairs_that_differ": differ, "first_difference": first}))
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        one_step(weights, batch, cfg, torch.float32, device)
    torch.use_deterministic_algorithms(False)
    for msg in sorted({str(w.message).split("\n")[0] for w in caught}):
        print("nondeterministic:", msg)


if __name__ == "__main__":
    main()
