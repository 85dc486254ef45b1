"""The port's COCO data path and VOC list builder against the JAX
package's, on the CPU.

* ``data/coco.py``: image names, multi-hot labels from bbox txts and the
  lazy ``CocoLabelStore``, equal to JAX's;
* ``train._dataset_setup`` for ``dataset="coco"`` gives JAX's names,
  validation names (from ``val_image_dir``) and labels, and ``validate``
  reads ``val_image_dir`` (``acr_wsss_tpu/train.py:449``): its loss is
  the mean of the per-example losses of the validation directory's
  images;
* ``train_coco.parse_args`` has JAX's defaults, apart from ``--device``
  (``cuda``) and ``--attn_impl`` (the port's names);
* ``data/lists.py`` writes the same lists and ``cls_labels.npy`` as JAX's
  from a synthetic devkit, and ``voc.read_file_2`` reads the path-pair
  lists as JAX's does.
"""

import dataclasses
import os

import numpy as np
import pytest

from acr_wsss_tpu import train as jax_train
from acr_wsss_tpu import train_coco as jax_train_coco
from acr_wsss_tpu.configs import TrainConfig as JaxTrainConfig
from acr_wsss_tpu.data import coco as jax_coco
from acr_wsss_tpu.data import lists as jax_lists
from acr_wsss_tpu.data import voc as jax_voc
from acr_wsss_tpu_torch import train as train_mod
from acr_wsss_tpu_torch import train_coco
from acr_wsss_tpu_torch.configs import ModelConfig, TrainConfig
from acr_wsss_tpu_torch.data import coco, lists
from acr_wsss_tpu_torch.data import voc as port_voc
from tests.torch_port_helpers import write_coco


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("torch_coco"))


def test_names_labels_and_store_match_jax(coco_root):
    names = coco.list_image_names(str(coco_root / "train"))
    assert names == jax_coco.list_image_names(str(coco_root / "train")) and len(names) == 6
    assert coco.COCO_CATEGORY_IDS == jax_coco.COCO_CATEGORY_IDS
    store = coco.CocoLabelStore(str(coco_root / "bbox"), names)
    ref = jax_coco.CocoLabelStore(str(coco_root / "bbox"), names)
    assert list(store) == list(ref) and len(store) == len(ref) == 6
    for name in names:
        got = coco.get_coco_cls_label(name, str(coco_root / "bbox"))
        assert got.dtype == np.float32 and got.shape == (80,) and got.sum() >= 1
        np.testing.assert_array_equal(got, jax_coco.get_coco_cls_label(
            name, str(coco_root / "bbox")))
        np.testing.assert_array_equal(store[name], ref[name])


def _coco_cfg(root):
    return TrainConfig(model=ModelConfig(backbone="vitb", num_classes=80,
                                         compute_dtype="float32"),
                       dataset="coco", crop_size=32, batch_size=2,
                       image_dir=str(root / "train"), val_image_dir=str(root / "val"),
                       cls_labels_path=str(root / "bbox"), device="cpu")


def test_dataset_setup_and_validate_read_the_val_directory(coco_root):
    cfg = _coco_cfg(coco_root)
    names, val_names, labels = train_mod._dataset_setup(cfg)
    ref = jax_train._dataset_setup(JaxTrainConfig(
        dataset="coco", image_dir=cfg.image_dir, val_image_dir=cfg.val_image_dir,
        cls_labels_path=cfg.cls_labels_path))
    assert (names, val_names) == (ref[0], ref[1]) and len(val_names) == 3
    assert all(np.array_equal(labels[n], ref[2][n]) for n in names)
    no_val = train_mod._dataset_setup(dataclasses.replace(cfg, val_image_dir=None))
    assert no_val[1] == []

    model, _ = train_mod.create_train_state(cfg, 1)
    eval_step = train_mod.make_eval_step(model)
    # val names are not in the train directory: validate must read val_image_dir
    store = coco.CocoLabelStore(cfg.cls_labels_path, val_names)
    got = train_mod.validate(cfg, model, eval_step, val_names, store)
    source = port_voc.VOCClassificationSource(cfg.val_image_dir, store, cfg.crop_size)
    per = []
    for n in val_names:
        img, lab = source.load_val(n)
        s, c = eval_step({"image": img[None], "label": lab[None], "weight": np.ones(1)})
        per.append(float(s) / float(c))
    np.testing.assert_allclose(got, np.mean(per), rtol=1e-5)


def test_train_coco_parse_args_matches_jax():
    argv = ["--IMpath", "train2014", "--bbox_dir", "bbox"]
    got = dataclasses.asdict(train_coco.parse_args(argv))
    ref = dataclasses.asdict(jax_train_coco.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert (got["model"].pop("attn_impl"), ref["model"].pop("attn_impl")) == ("kernel", "pallas")
    for k, v in got["model"].items():
        assert v == ref["model"][k], k
    for k, v in got.items():
        if k != "model":
            assert v == ref[k], k
    assert (got["dataset"], got["max_epochs"], got["aug_pad"], got["val_every"],
            got["model"]["num_classes"]) == ("coco", 5, 640, 30000, 80)
    with_val = train_coco.parse_args(argv + ["--valpath", "val2014", "--device_aug",
                                             "--device", "cpu"])
    assert (with_val.val_image_dir, with_val.device_aug, with_val.device) == (
        "val2014", True, "cpu")


def _write_devkit(root):
    rng = np.random.default_rng(1)
    classes = ("aeroplane", "person", "dog", "tvmonitor", "unknownthing")
    ids = {"train": ["2007_000032", "2007_000039", "2008_000123"],
           "val": ["2007_000033", "2007_000042"]}
    ids["train_aug"] = ids["train"] + ["2011_003276"]
    (root / "ImageSets" / "Segmentation").mkdir(parents=True)
    (root / "Annotations").mkdir()
    for split, split_ids in ids.items():
        (root / "ImageSets" / "Segmentation" / f"{split}.txt").write_text(
            "".join(f"{i}\n" for i in split_ids))
        for i in split_ids:
            objs = "".join(f"<object><name>{classes[c]}</name></object>"
                           for c in rng.choice(len(classes), size=2))
            (root / "Annotations" / f"{i}.xml").write_text(
                f"<annotation>{objs}</annotation>")


def test_lists_and_cls_labels_match_jax(tmp_path):
    _write_devkit(tmp_path / "VOC2012")
    for name, mod in (("port", lists), ("jax", jax_lists)):
        mod.main(["--voc12_root", str(tmp_path / "VOC2012"),
                  "--out_dir", str(tmp_path / name)])
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files and len(files) == 7
    for f in files:
        if f.endswith(".txt"):
            assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text(), f
    got = port_voc.load_cls_labels(str(tmp_path / "port" / "cls_labels.npy"))
    ref = jax_voc.load_cls_labels(str(tmp_path / "jax" / "cls_labels.npy"))
    assert got.keys() == ref.keys() and len(got) == 6
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    pairs = str(tmp_path / "port" / "train_aug.txt")
    assert port_voc.read_file_2(pairs) == jax_voc.read_file_2(pairs) == [
        "2007_000032", "2007_000039", "2008_000123", "2011_003276"]
