"""The port's one-command pipeline (``python -m acr_wsss_tpu_torch.pipeline``):
train -> infer (with PAMR) -> eval on a tiny synthetic VOC on the CPU,
checking every stage's artifact; the pattern of
``tests/test_pipeline_cli.py``. Then ``--dataset coco`` on a synthetic
COCO layout (bbox txts, a separate ``--valpath``): 80 classes in training
and inference, 81 in the eval, the infer list written into
``--weight_dir``. The infer stage alone with the CRF and heatmap outputs.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from acr_wsss_tpu.models.acr import ACR as JaxACR
from acr_wsss_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from acr_wsss_tpu_torch import pipeline
from tests.torch_port_helpers import write_coco


@pytest.fixture(scope="module")
def tiny_voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipevoc")
    (root / "img").mkdir()
    (root / "gt").mkdir()
    rng = np.random.default_rng(3)
    names, labels = [], {}
    for i in range(4):
        name = f"p{i}"
        names.append(name)
        Image.fromarray(rng.integers(0, 255, size=(48, 56, 3), dtype=np.uint8)).save(
            root / "img" / f"{name}.jpg")
        Image.fromarray(rng.integers(0, 3, size=(48, 56), dtype=np.uint8)).save(
            root / "gt" / f"{name}.png")
        lab = np.zeros(20, np.float32)
        lab[i % 3] = 1.0
        labels[name] = lab
    np.save(root / "cls_labels.npy", labels)
    (root / "list.txt").write_text("\n".join(names) + "\n")
    return root, names


def _argv(root, tmp_path, *extra):
    return ["--session_name", "pipe_torch", "--backbone", "vitb", "--device", "cpu",
            "--IMpath", str(root / "img"), "--gt_dir", str(root / "gt"),
            "--cls_labels", str(root / "cls_labels.npy"), "--crop_size", "32",
            "--train_list", str(root / "list.txt"), "--val_list", str(root / "list.txt"),
            "--infer_list", str(root / "list.txt"), "--max_epoches", "1",
            "--lr", "0.001", "--alpha", "1", "--pamr", "2",
            "--weight_dir", str(tmp_path / "weight"), "--out_cam", str(tmp_path / "cams"),
            "--logfile", str(tmp_path / "evallog.txt"), *extra]


def _read_cams(tmp_path, names):
    cams = []
    for name in names:
        cam = np.load(tmp_path / "cams" / f"{name}.npy", allow_pickle=True).item()
        assert all(m.shape == (48, 56) and np.isfinite(m).all() and 0 <= m.min()
                   and m.max() <= 1 for m in cam.values())
        cams.append(cam)
    return cams


def test_pipeline_all_stages_then_infer_and_eval_again(tiny_voc, tmp_path, capsys):
    root, names = tiny_voc
    pipeline.main(_argv(root, tmp_path))
    out = capsys.readouterr().out
    assert "model saved!" in out and "99/60 background score" in out

    # train: the npz in the JAX package's flat flax format
    params = jax_load_params_npz(str(tmp_path / "weight" / "pipe_torch_last.npz"))
    jax_model = JaxACR(backbone_name="vitb", dtype=jnp.float32)
    logits = jax_model.apply(params, jnp.zeros((1, 32, 32, 3)),
                             method=jax_model.forward_cls)["logits"]
    assert logits.shape == (1, 20) and np.isfinite(np.asarray(logits)).all()
    # infer: one CAM dict per name, with its present class
    cams = _read_cams(tmp_path, names)
    assert [sorted(c) for c in cams] == [[i % 3] for i in range(len(names))]
    # eval: the 100-threshold mIoU record under the session's name
    text = (tmp_path / "evallog.txt").read_text()
    assert text.count("pipe_torch") == 1 and text.count("mIoU:[") == 1
    assert len(text.split("mIoU:[")[1].split("]")[0].split(",")) == 100

    pipeline.main(_argv(root, tmp_path, "--stages", "infer,eval", "--comment", "rerun",
                        "--eval_threshold", "0.3"))
    out = capsys.readouterr().out
    assert "model saved!" not in out and "mIoU" in out
    for before, after in zip(cams, _read_cams(tmp_path, names)):
        assert sorted(before) == sorted(after)
        for c in before:
            np.testing.assert_allclose(after[c], before[c], rtol=0, atol=1e-6)
    assert "rerun" in (tmp_path / "evallog.txt").read_text()


@pytest.mark.parametrize("flag", [["--infer_scan"], ["--infer_dp", "2", "--train_relaunches", "1"],
                                  ["--stages", "train,export"]])
def test_unported_flags_are_refused(flag, capsys, monkeypatch):
    """The scanned trunk, an unknown stage, and the relaunch supervisor
    under a launcher (one rank's relaunch would strand the others)."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        pipeline.parse_args(["--IMpath", "img", "--gt_dir", "gt", *flag])
    assert "error" in capsys.readouterr().err


def test_crf_and_heatmap_flags_reach_the_infer_config():
    _, infer_cfg, _ = pipeline.configs(pipeline.parse_args(
        ["--IMpath", "img", "--gt_dir", "gt", "--out_crf", "out/crf", "--crf_device",
         "--heatmap", "out/heat"]))
    assert (infer_cfg.out_crf, infer_cfg.crf_device, infer_cfg.heatmap) == (
        "out/crf", True, "out/heat")
    assert (infer_cfg.low_alpha, infer_cfg.high_alpha, infer_cfg.crf_pad) == (1, 12, 512)
    _, infer_cfg, _ = pipeline.configs(pipeline.parse_args(["--IMpath", "img", "--gt_dir", "gt"]))
    assert (infer_cfg.out_crf, infer_cfg.crf_device, infer_cfg.heatmap) == (None, False, None)


def test_infer_stage_writes_the_crf_folders_and_heatmaps(tiny_voc, tmp_path, capsys):
    """``--stages infer --out_crf --crf_device --heatmap`` on the saved npz
    of a seeded vitb: both alpha folders, one CRF dict per name over the
    background and the present class, every image on the device route."""
    from acr_wsss_tpu_torch.models.acr import ACR, init_random_
    from acr_wsss_tpu_torch.models.convert import state_dict_to_flax
    from acr_wsss_tpu_torch.utils.checkpoint import save_params_npz

    root, names = tiny_voc
    (tmp_path / "weight").mkdir()
    model = init_random_(ACR(backbone_name="vitb", dtype=torch.float32), seed=1)
    save_params_npz(str(tmp_path / "weight" / "pipe_torch_last.npz"), state_dict_to_flax(model))
    pipeline.main(_argv(root, tmp_path, "--stages", "infer", "--out_crf",
                        str(tmp_path / "crf"), "--crf_device", "--heatmap",
                        str(tmp_path / "heat")))
    assert "crf: 4 on cpu, 0 on host (larger than pad 512)" in capsys.readouterr().out
    cams = _read_cams(tmp_path, names)
    for alpha in (1, 12):
        for name, cam in zip(names, cams):
            crf = np.load(tmp_path / f"crf_{alpha}" / f"{name}.npy", allow_pickle=True).item()
            assert sorted(crf) == [0] + [c + 1 for c in sorted(cam)]
            assert all(m.shape == (48, 56) and np.isfinite(m).all() for m in crf.values())
    assert len(list((tmp_path / "heat").glob("*_getam.jpg"))) == len(names)


def test_defaults_are_the_recipe_on_cuda():
    train_cfg, infer_cfg, eval_cfg = pipeline.configs(
        pipeline.parse_args(["--IMpath", "img", "--gt_dir", "gt", "--pamr", "10"]))
    assert train_cfg.device == infer_cfg.device == "cuda"
    assert (train_cfg.model.backbone, train_cfg.crop_size, train_cfg.batch_size, train_cfg.lr,
            train_cfg.alpha, train_cfg.max_epochs) == ("vitb_hybrid", 384, 4, 0.05, 125.0, 10)
    assert train_cfg.model.attn_impl == infer_cfg.model.attn_impl == "kernel"
    assert infer_cfg.weights == "weight/acr_001_last.npz"
    assert (infer_cfg.pamr_iters, tuple(infer_cfg.pamr_dilations)) == (10, (1, 2, 4, 8, 12, 24))
    assert (infer_cfg.start_layer, infer_cfg.getam_func, infer_cfg.batch_images) == (
        10, "grad", 4)
    assert eval_cfg.curve and eval_cfg.num_classes == 21 and eval_cfg.comment == "acr_001"


def test_coco_pipeline_trains_infers_and_evaluates_80_classes(tmp_path, capsys):
    root = write_coco(tmp_path / "coco", seed=5, n_train=4, n_val=2)
    (root / "gt").mkdir()
    names = sorted(p.stem for p in (root / "train").glob("*.jpg"))
    rng = np.random.default_rng(6)
    for name in names:
        h, w = Image.open(root / "train" / f"{name}.jpg").size[::-1]
        Image.fromarray(rng.integers(0, 81, size=(h, w), dtype=np.uint8)).save(
            root / "gt" / f"{name}.png")
    argv = ["--dataset", "coco", "--session_name", "coco_torch", "--backbone", "vitb",
            "--device", "cpu", "--IMpath", str(root / "train"), "--bbox_dir", str(root / "bbox"),
            "--valpath", str(root / "val"), "--gt_dir", str(root / "gt"), "--crop_size", "32",
            "--max_epoches", "1", "--lr", "0.001", "--alpha", "1", "--device_aug",
            "--weight_dir", str(tmp_path / "weight"), "--out_cam", str(tmp_path / "cams"),
            "--logfile", str(tmp_path / "evallog.txt")]
    train_cfg, infer_cfg, eval_cfg = pipeline.configs(pipeline.parse_args(argv))
    assert (train_cfg.model.num_classes, infer_cfg.model.num_classes, eval_cfg.num_classes) == (
        80, 80, 81)
    assert (train_cfg.aug_pad, train_cfg.val_image_dir, infer_cfg.dataset) == (
        640, str(root / "val"), "coco")
    pipeline.main(argv)
    out = capsys.readouterr().out
    assert "model saved!" in out and "99/60 background score" in out

    listed = tmp_path / "weight" / "coco_torch_infer_list.txt"
    assert listed.read_text().split() == names
    params = jax_load_params_npz(str(tmp_path / "weight" / "coco_torch_last.npz"))
    assert params["params"]["cls_head"]["kernel"].shape == (768, 80)
    from acr_wsss_tpu.data.coco import get_coco_cls_label

    for name in names:
        cam = np.load(tmp_path / "cams" / f"{name}.npy", allow_pickle=True).item()
        present = np.flatnonzero(get_coco_cls_label(name, str(root / "bbox"))).tolist()
        assert sorted(cam) == present
        assert all(np.isfinite(m).all() and 0 <= m.min() and m.max() <= 1 for m in cam.values())
    text = (tmp_path / "evallog.txt").read_text()
    assert text.count("coco_torch") == 1 and text.count("mIoU:[") == 1


def test_coco_requires_bbox_dir(capsys):
    with pytest.raises(SystemExit):
        pipeline.parse_args(["--IMpath", "img", "--gt_dir", "gt", "--dataset", "coco"])
    assert "--bbox_dir" in capsys.readouterr().err
