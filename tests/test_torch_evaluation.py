"""The port's evaluations against the JAX package's: the binary and
cluster-matching metrics, `resize_nearest`, and the `semantic_eval` and
`object_segmentation` tasks through both task CLIs on the same synthetic
directories (inputs from a numpy seed).

Tolerances: metrics within 1e-6 (f32 sums over at most a few thousand
pixels, in another order); `resize_nearest`, the match lists and the
printed mIoU / acc / IoU lines exactly equal; the returned mIoU, accuracy,
IoU and F-max within 1e-6.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deep_spectral_tpu.tasks import cli as j_cli
from deep_spectral_tpu.tasks import object_segmentation as JOS
from deep_spectral_tpu_torch.ops import metrics as TMx
from deep_spectral_tpu_torch.ops.resize import resize_nearest
from deep_spectral_tpu_torch.tasks import cli as t_cli
from deep_spectral_tpu_torch.tasks import object_segmentation as TOS
from deep_spectral_tpu_torch.tasks import semantic_segmentation as TSS

JMx = importlib.import_module("deep_spectral_tpu.ops.metrics")
JR = importlib.import_module("deep_spectral_tpu.ops.resize")


def _pair(rng, shape=(3, 24, 32), p=0.4):
    pred, target = rng.random(shape) < p, rng.random(shape) < 0.5
    pred[0] = False   # empty prediction: precision 1
    target[1] = False  # empty target: recall 1
    pred[2] = target[2] = False  # both empty: IoU 0
    return pred, target


def test_binary_metrics_match_jax():
    pred, target = _pair(np.random.default_rng(0))
    for p, t in zip(pred, target):
        tp, tt, jp, jt = torch.from_numpy(p), torch.from_numpy(t), jnp.asarray(p), jnp.asarray(t)
        np.testing.assert_allclose(float(TMx.binary_accuracy(tp, tt)),
                                   float(JMx.binary_accuracy(jp, jt)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(TMx.binary_iou(tp, tt)),
                                   float(JMx.binary_iou(jp, jt)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.array([float(x) for x in TMx.precision_recall(tt, tp)]),
                                   np.array([float(x) for x in JMx.precision_recall(jt, jp)]),
                                   rtol=0, atol=1e-6)


def test_soft_curve_and_f_max_match_jax():
    """Soft values on the thresholds' own grid (ties with a threshold) and
    random ones; F-max over 3 images."""
    rng = np.random.default_rng(1)
    soft = rng.random((3, 20, 20)).astype(np.float32)
    soft[0, :5] = np.arange(0.0, 1.0, 1.0 / 255, dtype=np.float32)[rng.integers(0, 255, (5, 20))]
    target = rng.random((3, 20, 20)) < 0.4
    tp, tr, jp, jr = [], [], [], []
    for s, t in zip(soft, target):
        a, b = TMx.soft_precision_recall_curve(torch.from_numpy(s), torch.from_numpy(t))
        c, d = JMx.soft_precision_recall_curve(jnp.asarray(s), jnp.asarray(t))
        assert a.shape == (254,)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0, atol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(d), rtol=0, atol=1e-6)
        tp.append(a), tr.append(b), jp.append(np.asarray(c)), jr.append(np.asarray(d))
    np.testing.assert_allclose(float(TMx.f_max(torch.stack(tp), torch.stack(tr))),
                               float(JMx.f_max(jnp.asarray(np.stack(jp)),
                                               jnp.asarray(np.stack(jr)))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [(5, 5), (7, 4)])
def test_matching_metrics_match_jax(k):
    """IoU matrix within 1e-6; Hungarian (square) or majority-vote matches
    and the remapped labels equal."""
    preds_k, targets_k = k
    rng = np.random.default_rng(preds_k)
    targets = rng.integers(0, targets_k, 3000)
    preds = np.where(rng.random(3000) < 0.7, (targets * 3 + 1) % preds_k,
                     rng.integers(0, preds_k, 3000))
    conf = TMx.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(targets),
                                preds_k, targets_k)
    np.testing.assert_allclose(
        TMx.iou_matrix_from_confusion(conf).numpy(),
        np.asarray(JMx.iou_matrix_from_confusion(jnp.asarray(conf.numpy()))), rtol=0, atol=1e-6)
    if preds_k == targets_k:
        t = TMx.hungarian_match(torch.from_numpy(preds), torch.from_numpy(targets), *k)
        j = JMx.hungarian_match(preds, targets, *k)
    else:
        t = TMx.majority_vote(torch.from_numpy(preds), torch.from_numpy(targets), *k)
        j = JMx.majority_vote(preds, targets, *k)
    assert t == j
    np.testing.assert_array_equal(TMx.apply_label_map(preds, t), JMx.apply_label_map(preds, j))


@pytest.mark.parametrize("shapes", [((4, 6), (64, 96)), ((8, 8), (282, 300)),
                                    ((30, 40), (7, 5)), ((5, 7), (5, 7))])
def test_resize_nearest_matches_jax(shapes):
    (h, w), out = shapes
    x = np.random.default_rng(h).integers(0, 9, (2, h, w, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        resize_nearest(torch.from_numpy(x[0, ..., 0]), out).numpy(),
        np.asarray(JR.resize_nearest(jnp.asarray(x[0, ..., 0]), out)))
    batched = np.moveaxis(x, -1, 1)  # (2, 3, h, w): leading dims ride along
    np.testing.assert_array_equal(
        resize_nearest(torch.from_numpy(batched), out).numpy(),
        np.asarray(JR.resize_nearest(jnp.asarray(batched), out)))


# ------------------------------------------------------------- semantic_eval

@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """8 images (4 of them val), block GT with classes 0-5 and 255 borders,
    patch-level segments: a permutation of the GT blocks into 21 cluster
    ids, with a tenth of the patches noised."""
    root = tmp_path_factory.mktemp("voc")
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation", "segments"):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(2)
    perm = rng.permutation(21)
    names = [f"im{i}" for i in range(8)]
    for i, n in enumerate(names):
        H, W = [(64, 96), (80, 64)][i % 2]
        Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        blocks = rng.integers(0, 6, (H // 16, W // 16))
        gt = np.kron(blocks, np.ones((16, 16), np.int64)).astype(np.uint8)
        gt[::16] = 255
        Image.fromarray(gt).save(root / "SegmentationClass" / f"{n}.png")
        seg = perm[blocks]
        noisy = rng.random(seg.shape) < 0.1
        seg[noisy] = rng.integers(0, 21, noisy.sum())
        Image.fromarray(seg.astype(np.uint8)).save(root / "segments" / f"{n}.png")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text("\n".join(names[4:]))
    return root


@pytest.mark.parametrize("n_clusters", [21, 24])  # Hungarian; majority vote
def test_semantic_eval_cli_matches_jax(voc, tmp_path, capsys, n_clusters):
    """The same mIoU and match list from both CLIs on the same directories."""
    args = [f"data.root={voc}", f"segments_dir={voc / 'segments'}",
            f"n_clusters={n_clusters}", "visualize=0", f"output_dir={tmp_path}"]
    j_miou, j_match = j_cli.main(["semantic_eval", *args])
    j_out = capsys.readouterr().out
    assert t_cli.main(["semantic_eval", *args, "device=cpu"]) == 0
    t_out = capsys.readouterr().out
    t_miou, t_match = t_cli.TASKS["semantic_eval"]([*args, "device=cpu"])
    capsys.readouterr()
    assert t_match == j_match and len(t_match) == n_clusters
    np.testing.assert_allclose(t_miou, j_miou, rtol=0, atol=1e-6)
    lines = [[ln for ln in out.splitlines() if ln.startswith(("mIoU:", "matching:"))]
             for out in (t_out, j_out)]
    assert lines[0] == lines[1] and len(lines[0]) == 2
    assert 0.2 < t_miou <= 6 / 21  # 6 of the 21 classes have pixels


def test_evaluate_segments_needs_the_card_by_default(voc, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = TSS.VOCSegmentationWithPseudolabels(str(voc), "val", str(voc / "segments"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSS.evaluate_segments(ds)


def test_visualize_overlays_writes_pngs(voc, tmp_path):
    ds = TSS.VOCSegmentationWithPseudolabels(str(voc), "val", str(voc / "segments"))
    TSS.visualize_overlays(ds, [(c, c % 21) for c in range(21)], tmp_path, max_images=2)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["im4.png", "im5.png"]
    assert Image.open(tmp_path / files[0]).size[0] > 100


# ------------------------------------------------------- object_segmentation

@pytest.fixture(scope="module")
def saliency(tmp_path_factory):
    """Two saliency datasets (ECSSD-like, CUB-like with its center crop),
    GT masks at image size, patch-level 0/255 predictions (P=16) that cover
    the object more or less well, one of them empty."""
    root = tmp_path_factory.mktemp("sal")
    rng = np.random.default_rng(4)
    for name in ("ECSSD", "CUB"):
        for sub in ("images", "labels", f"preds/{name}"):
            (root / name / sub if sub != f"preds/{name}" else root / sub).mkdir(parents=True)
        for i in range(4):
            H, W = [(72, 100), (96, 64)][i % 2]
            Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)).save(
                root / name / "images" / f"{name}{i}.jpg")
            gt = np.zeros((H, W), np.uint8)
            y, x = int(rng.integers(0, H // 2)), int(rng.integers(0, W // 2))
            gt[y:y + H // 2, x:x + W // 2] = 255
            Image.fromarray(gt).save(root / name / "labels" / f"{name}{i}.png")
            pred = (rng.random((H // 16, W // 16)) < 0.3 + 0.2 * i).astype(np.uint8) * 255
            if i == 3:
                pred[:] = 0
            Image.fromarray(pred).save(root / "preds" / name / f"{name}{i}.png")
    return root


def test_object_segmentation_cli_matches_jax(saliency, capsys):
    """acc and IoU per dataset (downsample 16; CUB center-cropped) from both
    CLIs on the same directories."""
    args = [f"predictions.root={saliency / 'preds'}"]
    for name in ("ECSSD", "CUB"):
        args += [f"datasets.{name}.images_dir={saliency / name / 'images'}",
                 f"datasets.{name}.labels_dir={saliency / name / 'labels'}"]
    j_res = j_cli.main(["object_segmentation", *args])
    j_out = capsys.readouterr().out
    assert t_cli.main(["object_segmentation", *args, "device=cpu"]) == 0
    t_out = capsys.readouterr().out
    t_res = t_cli.TASKS["object_segmentation"]([*args, "device=cpu"])
    assert set(t_res) == set(j_res) == {"ECSSD", "CUB"}
    for name in t_res:
        assert t_res[name]["n_images"] == j_res[name]["n_images"] == 4
        for key in ("acc", "iou"):
            np.testing.assert_allclose(t_res[name][key], j_res[name][key], rtol=0, atol=1e-6)
    lines = [[ln for ln in out.splitlines() if ln.startswith(("acc:", "=="))]
             for out in (t_out, j_out)]
    assert lines[0] == lines[1] and len(lines[0]) == 4


@pytest.mark.parametrize("downsample,crop", [(16, True), (None, False), (8, False)])
def test_prepare_prediction_matches_jax(downsample, crop):
    rng = np.random.default_rng(6)
    hw = (70, 90) if downsample is not None else (9, 11)
    pred = (rng.random((9, 11)) < 0.5).astype(np.uint8) * 255
    np.testing.assert_array_equal(TOS.prepare_prediction(pred, hw, downsample, crop),
                                  JOS.prepare_prediction(pred, hw, downsample, crop))


def test_soft_predictions_match_jax():
    """acc, IoU and F-max of soft predictions within 1e-6."""
    rng = np.random.default_rng(8)
    soft = rng.random((3, 24, 24)).astype(np.float32)
    targets = rng.random((3, 24, 24)) < 0.5
    t = TOS.evaluate_soft_predictions(soft, targets, device="cpu")
    j = JOS.evaluate_soft_predictions(soft, targets)
    assert set(t) == set(j) == {"acc", "iou", "f_max"}
    for key in t:
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-6)


def test_not_ported_task_exits_with_usage(capsys):
    """Every task of the JAX CLI is ported: a task name the CLI does not know
    exits 2 with the usage line, which lists semantic_generate."""
    assert t_cli.main(["semantic_segment"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("usage:") and "semantic_generate" in err


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
