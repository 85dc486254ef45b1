"""VOC12 data pipeline: lists, labels and batch iterators on host threads.

Own copy of ``acr_wsss_tpu/data/voc.py`` (``:40-252``): ``read_file``,
``load_cls_labels``, the example source, and the train and eval iterators,
with the same ``numpy`` seed streams, so that one seed gives the same
batches as the JAX package: a seeded permutation per epoch (``(seed,
epoch)``), host sharding ``order[host_id::num_hosts]``, and a per-example
generator seeded by ``(seed, epoch, host_id, crc32(name))``. Batches are
NHWC float32 numpy arrays.

The device-side augmentation (``load_train_packed``, ``device_aug``) is not
part of this module yet.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from acr_wsss_tpu_torch.data import transforms


def read_file(path: str) -> List[str]:
    """Bare-id list, one id per line (reference ``myTool.py:867-873``)."""
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def chunker(seq: Sequence, size: int) -> Iterator[Sequence]:
    return (seq[pos:pos + size] for pos in range(0, len(seq), size))


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

    def load_val(self, name: str):
        return (transforms.val_transform(self._decoded(name), self.crop_size),
                self.labels[name].astype(np.float32))


class TrainIterator:
    """Infinite shuffled, host-sharded batch iterator; ``prefetch`` batches
    are loaded ahead on a thread pool."""

    def __init__(self, source: VOCClassificationSource, names: Sequence[str],
                 batch_size: int, seed: int = 0, host_id: int = 0,
                 num_hosts: int = 1, num_workers: int = 8, prefetch: int = 2):
        self.source = source
        self.names = list(names)
        self.batch_size = batch_size
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.prefetch = prefetch
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
        futures = [self.pool.submit(lambda n, s: self.source.load_train(
            n, np.random.default_rng(s)), n, s) for n, s in zip(names, seeds)]
        self._pending.append((names, futures))

    def __iter__(self):
        return self

    def __next__(self):
        while len(self._pending) < self.prefetch + 1:
            self._submit_batch()
        names, futures = self._pending.pop(0)
        results = [f.result() for f in futures]
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
