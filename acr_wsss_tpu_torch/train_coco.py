"""MS-COCO training CLI: counterpart of ``acr_wsss_tpu/train_coco.py``
(reference ``train_acr_coco.py`` / ``train_acr_coco.sh``).

The machinery of ``train.py`` with the COCO configuration: 80 classes,
names from the image directory listing, labels from bbox txts, validation
images from ``--valpath``, 5 epochs, validation every 30k steps, and a
640-pixel pad square for ``--device_aug``:

    python -m acr_wsss_tpu_torch.train_coco --IMpath train2014 \\
        --bbox_dir bbox_txts --valpath val2014
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.train import TrainState, train


def parse_args(argv: Optional[List[str]] = None) -> TrainConfig:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--max_epoches", default=5, type=int)
    parser.add_argument("--lr", default=0.05, type=float)
    parser.add_argument("--wt_dec", default=5e-4, type=float)
    parser.add_argument("--backbone", default="vitb_hybrid")
    parser.add_argument("--alpha", default=125, type=float)
    parser.add_argument("--session_name", default="acr_tpu_coco")
    parser.add_argument("--crop_size", default=384, type=int)
    parser.add_argument("--IMpath", required=True, help="COCO train2014 image directory")
    parser.add_argument("--bbox_dir", required=True,
                        help="per-image bbox txt directory (labels)")
    parser.add_argument("--valpath", default=None,
                        help="COCO val2014 image directory (reference train_acr_coco.py "
                             "--valpath); no validation if omitted")
    parser.add_argument("--attn_impl", default="kernel", choices=["kernel", "plain"])
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device_aug", action="store_true",
                        help="resize, flip, normalize and crop on the device from uint8 "
                             "rasters")
    parser.add_argument("--aug_pad", default=640, type=int,
                        help="static pad square for --device_aug (COCO images go up to "
                             "640 px)")
    parser.add_argument("--cache_decoded", action="store_true",
                        help="cache decoded rasters in memory")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return TrainConfig(
        model=ModelConfig(backbone=args.backbone, num_classes=80, attn_impl=args.attn_impl),
        dataset="coco", batch_size=args.batch_size, max_epochs=args.max_epoches, lr=args.lr,
        weight_decay=args.wt_dec, alpha=args.alpha, session_name=args.session_name,
        crop_size=args.crop_size, image_dir=args.IMpath, val_image_dir=args.valpath,
        cls_labels_path=args.bbox_dir, val_every=30000, seed=args.seed,
        device_aug=args.device_aug, aug_pad=args.aug_pad, cache_decoded=args.cache_decoded,
        device=args.device)


def main(argv: Optional[List[str]] = None) -> TrainState:
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
