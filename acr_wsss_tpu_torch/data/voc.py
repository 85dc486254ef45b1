"""VOC12 data pipeline: lists, labels and batch iterators on host threads.

Own copy of ``acr_wsss_tpu/data/voc.py`` (``:40-252``): ``read_file``,
``load_cls_labels``, the example source, and the train and eval iterators,
with the same ``numpy`` seed streams, so that one seed gives the same
batches as the JAX package: a seeded permutation per epoch (``(seed,
epoch)``), host sharding ``order[host_id::num_hosts]`` (one host per rank of a
data-parallel run), and a per-example
generator seeded by ``(seed, epoch, host_id, crc32(name))``. Batches are
NHWC float32 numpy arrays; with ``device_aug`` the train batches carry
the uint8 rasters and augmentation descriptors that ``data/device_aug.py``
turns into crops on the device (``:122-133``, ``:208-226``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from acr_wsss_tpu_torch.configs import VOC_CLASSES
from acr_wsss_tpu_torch.data import device_aug, transforms

CLASS_TO_INDEX: Dict[str, int] = {c: i for i, c in enumerate(VOC_CLASSES)}


def read_file(path: str) -> List[str]:
    """Bare-id list, one id per line (reference ``myTool.py:867-873``)."""
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def read_file_2(path: str) -> List[str]:
    """VOC path-pair list: id = chars 12:23 of each line (reference
    ``myTool.py:875-880``; lines look like
    '/JPEGImages/2007_000032.jpg /SegmentationClassAug/...')."""
    with open(path) as f:
        return [line[12:23] for line in f if line.strip()]


def chunker(seq: Sequence, size: int) -> Iterator[Sequence]:
    return (seq[pos:pos + size] for pos in range(0, len(seq), size))


def make_cls_labels(voc12_root: str, name_lists: Sequence[Sequence[str]],
                    out_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The multi-hot label store from the VOC XML annotations (reference
    ``voc12/make_cls_labels.py:1-22``)."""
    labels: Dict[str, np.ndarray] = {}
    for names in name_lists:
        for name in names:
            if name in labels:
                continue
            vec = np.zeros(len(VOC_CLASSES), np.float32)
            tree = ET.parse(os.path.join(voc12_root, "Annotations", f"{name}.xml"))
            for obj in tree.findall("object"):
                cls = obj.findtext("name")
                if cls in CLASS_TO_INDEX:
                    vec[CLASS_TO_INDEX[cls]] = 1.0
            labels[name] = vec
    if out_path:
        np.save(out_path, labels)  # type: ignore[arg-type]
    return labels


def load_cls_labels(path: str) -> Dict[str, np.ndarray]:
    return np.load(path, allow_pickle=True).item()


class VOCClassificationSource:
    """Loads and augments single examples; thread-safe. ``cache_decoded``
    keeps decoded uint8 rasters in memory after their first read."""

    def __init__(self, image_dir: str, labels: Dict[str, np.ndarray],
                 crop_size: int, cache_decoded: bool = False):
        self.image_dir = image_dir
        self.labels = labels
        self.crop_size = crop_size
        self._cache: Optional[Dict[str, np.ndarray]] = {} if cache_decoded else None

    def _decoded(self, name: str) -> np.ndarray:
        if self._cache is not None and name in self._cache:
            return self._cache[name]
        img = transforms.load_image_rgb(os.path.join(self.image_dir, f"{name}.jpg"))
        if self._cache is not None:
            self._cache[name] = img
        return img

    def load_train(self, name: str, rng: np.random.Generator):
        crop, _ = transforms.train_transform(self._decoded(name), self.crop_size, rng)
        return crop, self.labels[name].astype(np.float32)

    def load_train_packed(self, name: str, rng: np.random.Generator, pad_to: int):
        """The uint8 raster padded to ``pad_to``^2, its augmentation
        descriptor (from the same draws as ``load_train``) and its label."""
        img = self._decoded(name)
        params = transforms.train_aug_params(img.shape[:2], self.crop_size, rng)
        padded, vec = device_aug.pack_example(img, params, pad_to)
        return padded, vec, self.labels[name].astype(np.float32)

    def load_val(self, name: str):
        return (transforms.val_transform(self._decoded(name), self.crop_size),
                self.labels[name].astype(np.float32))


def shard_names(names: Sequence[str], host_id: int, num_hosts: int) -> List[str]:
    """The names of one host (a rank, a ``--dp`` worker): every
    ``num_hosts``-th from ``host_id``."""
    return list(names[host_id::num_hosts])


class TrainIterator:
    """Infinite shuffled, host-sharded batch iterator; ``prefetch`` batches
    are loaded ahead on a thread pool. With ``device_aug`` a batch is
    ``{"image_u8" (B, aug_pad, aug_pad, 3) uint8, "aug" (B, 9) int32,
    "label", "name"}`` instead of ``{"image", "label", "name"}``."""

    def __init__(self, source: VOCClassificationSource, names: Sequence[str],
                 batch_size: int, seed: int = 0, host_id: int = 0,
                 num_hosts: int = 1, num_workers: int = 8, prefetch: int = 2,
                 device_aug: bool = False, aug_pad: int = 512):
        self.source = source
        self.names = list(names)
        self.batch_size = batch_size
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.prefetch = prefetch
        self.device_aug = device_aug
        self.aug_pad = aug_pad
        self._epoch = 0
        self._name_iter = self._iter_names()
        self._pending: List = []

    def _iter_names(self) -> Iterator[str]:
        while True:
            rng = np.random.default_rng((self.seed, self._epoch))
            order = rng.permutation(len(self.names))
            for idx in order[self.host_id::self.num_hosts]:
                yield self.names[idx]
            self._epoch += 1

    def _submit_batch(self) -> None:
        names = [next(self._name_iter) for _ in range(self.batch_size)]
        # crc32 of the name, not hash(): str hashing is randomized per process.
        seeds = [(self.seed, self._epoch, self.host_id, zlib.crc32(n.encode()))
                 for n in names]
        futures = [self.pool.submit(self._load, n, np.random.default_rng(s))
                   for n, s in zip(names, seeds)]
        self._pending.append((names, futures))

    def _load(self, name: str, rng: np.random.Generator):
        if self.device_aug:
            return self.source.load_train_packed(name, rng, self.aug_pad)
        return self.source.load_train(name, rng)

    def __iter__(self):
        return self

    def __next__(self):
        while len(self._pending) < self.prefetch + 1:
            self._submit_batch()
        names, futures = self._pending.pop(0)
        results = [f.result() for f in futures]
        if self.device_aug:
            return {"image_u8": np.stack([r[0] for r in results]),
                    "aug": np.stack([r[1] for r in results]),
                    "label": np.stack([r[2] for r in results]), "name": names}
        return {"image": np.stack([r[0] for r in results]),
                "label": np.stack([r[1] for r in results]), "name": names}

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


class EvalIterator:
    """Deterministic sequential batches for validation."""

    def __init__(self, source: VOCClassificationSource, names: Sequence[str],
                 batch_size: int = 1, num_workers: int = 4):
        self.source = source
        self.names = list(names)
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __iter__(self):
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = {name: pool.submit(self.source.load_val, name) for name in self.names}
            for batch_names in chunker(self.names, self.batch_size):
                results = [futures[n].result() for n in batch_names]
                yield {"image": np.stack([r[0] for r in results]),
                       "label": np.stack([r[1] for r in results]),
                       "name": list(batch_names)}

    def __len__(self):
        return (len(self.names) + self.batch_size - 1) // self.batch_size
