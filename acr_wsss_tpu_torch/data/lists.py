"""VOC12 name lists and ``cls_labels.npy`` from the devkit: own copy of
``acr_wsss_tpu/data/lists.py``.

* bare-id lists from ``ImageSets/Segmentation(Aug)/*.txt``;
* path-pair lists (``/JPEGImages/<id>.jpg /SegmentationClassAug/<id>.png``)
  in the reference's ``train_aug.txt`` format, whose ids ``voc.read_file_2``
  reads from chars 12:23;
* the multi-hot labels from the XML annotations (``voc.make_cls_labels``).

    python -m acr_wsss_tpu_torch.data.lists --voc12_root VOCdevkit/VOC2012
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

from acr_wsss_tpu_torch.data.voc import make_cls_labels


def ids_from_imagesets(voc12_root: str, split: str) -> List[str]:
    for subdir in ("ImageSets/SegmentationAug", "ImageSets/Segmentation", "ImageSets/Main"):
        path = os.path.join(voc12_root, subdir, f"{split}.txt")
        if os.path.exists(path):
            with open(path) as f:
                return [line.split()[0].strip().replace("/JPEGImages/", "")
                        .replace(".jpg", "")[:11] or line.strip()
                        for line in f if line.strip()]
    raise FileNotFoundError(f"no ImageSets list for split {split!r}")


def write_id_list(ids: List[str], out_path: str) -> None:
    with open(out_path, "w") as f:
        f.write("\n".join(ids) + "\n")


def write_pathpair_list(ids: List[str], out_path: str) -> None:
    with open(out_path, "w") as f:
        for i in ids:
            f.write(f"/JPEGImages/{i}.jpg /SegmentationClassAug/{i}.png\n")


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Generate VOC12 split lists + cls_labels.npy")
    parser.add_argument("--voc12_root", required=True)
    parser.add_argument("--out_dir", default="voc12")
    parser.add_argument("--splits", nargs="+", default=["train", "train_aug", "val"])
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    all_ids = []
    for split in args.splits:
        ids = ids_from_imagesets(args.voc12_root, split)
        all_ids.append(ids)
        write_id_list(ids, os.path.join(args.out_dir, f"{split}_id.txt"))
        write_pathpair_list(ids, os.path.join(args.out_dir, f"{split}.txt"))
        print(f"{split}: {len(ids)} ids")
    make_cls_labels(args.voc12_root, all_ids, os.path.join(args.out_dir, "cls_labels.npy"))
    print("cls_labels.npy written")


if __name__ == "__main__":
    main()
