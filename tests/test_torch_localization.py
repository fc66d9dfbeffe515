"""The port's localization task (`tasks/localization.py`, the `localization`
CLI, `utils/native_cc.py`, the box metrics) against the JAX package's, on
the same inputs: a synthetic VOC tree, the tiny test ViT's DINO-format
checkpoint loaded by both packages, eigs from the port's stages 1-2.

Tolerances: connected components, boxes, predictions and CorLoc are exact
(integer masks and box arithmetic on the same host). The box IoU family is
f32 on both sides: 1e-6. The on-the-fly methods compare boxes exactly: the
two fp32 forwards differ by ~1e-5, far from flipping the sign of a Fiedler
entry, a LOST affinity or an attention ranking on these images.
"""
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deep_spectral_tpu.ops import metrics as jm
from deep_spectral_tpu.tasks import cli as j_cli
from deep_spectral_tpu.tasks import localization as JL
from deep_spectral_tpu.utils import native_cc as j_cc
from deep_spectral_tpu_torch.models.convert import random_init_
from deep_spectral_tpu_torch.models.vit import VisionTransformer, get_model_config
from deep_spectral_tpu_torch.ops import metrics as tm
from deep_spectral_tpu_torch.pipeline import extract as t_stages
from deep_spectral_tpu_torch.tasks import cli as t_cli
from deep_spectral_tpu_torch.tasks import localization as TL
from deep_spectral_tpu_torch.utils import native_cc as t_cc
from deep_spectral_tpu_torch.utils.serialization import save_pth

MODEL = "test_vit_tiny"
# one non-square size (8x10 patches at P=8): the JAX package compiles its
# on-the-fly forward once per image size
SIZES = [(64, 80)] * 3


def _write_voc_xml(path, boxes):
    objs = "".join(
        f"<object><name>cat</name><truncated>0</truncated><difficult>0</difficult>"
        f"<bndbox><xmin>{x0 + 1}</xmin><ymin>{y0 + 1}</ymin><xmax>{x1}</xmax>"
        f"<ymax>{y1}</ymax></bndbox></object>" for x0, y0, x1, y1 in boxes)
    Path(path).write_text(f"<annotation>{objs}</annotation>")


@pytest.mark.parametrize("connectivity", [1, 2])
def test_native_cc_matches_jax_copy(connectivity):
    rng = np.random.default_rng(connectivity)
    assert t_cc.backend() == "native"
    for shape, p in (((9, 12), 0.5), ((30, 41), 0.4), ((1, 7), 0.6), ((5, 5), 0.0)):
        mask = rng.random(shape) < p
        labels, num = t_cc.cc_label(mask, connectivity)
        j_labels, j_num = j_cc.cc_label(mask, connectivity)
        assert num == j_num
        np.testing.assert_array_equal(labels, j_labels)
        np.testing.assert_array_equal(t_cc.largest_component(mask, connectivity),
                                      j_cc.largest_component(mask, connectivity))
        np.testing.assert_array_equal(t_cc.label_bboxes(labels, num),
                                      j_cc.label_bboxes(j_labels, j_num))


def test_box_metrics_match_jax():
    rng = np.random.default_rng(0)
    b1 = np.array([10.0, 20.0, 60.0, 90.0], np.float32)
    b2 = np.concatenate([rng.uniform(0, 50, (6, 2)), rng.uniform(50, 120, (6, 2))],
                        1).astype(np.float32)
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    np.testing.assert_allclose(tm.bbox_iou(t1, t2).numpy(),
                               np.asarray(jm.bbox_iou(jnp.asarray(b1), jnp.asarray(b2))),
                               atol=1e-6)
    for kw in (dict(), dict(giou=True), dict(diou=True), dict(ciou=True),
               dict(x1y1x2y2=False, ciou=True)):
        np.testing.assert_allclose(
            tm.bbox_iou_variants(t1, t2, **kw).numpy(),
            np.asarray(jm.bbox_iou_variants(jnp.asarray(b1), jnp.asarray(b2), **kw)),
            atol=1e-6)
    valid = np.array([True, False, True, True, False, True])
    for gt in (b2, np.stack([b1, b1 + 100]), b2[:0]):
        for v in (None, valid[:len(gt)]):
            got = tm.corloc_hit(t1, torch.from_numpy(gt),
                                None if v is None else torch.from_numpy(v)).item()
            ref = float(jm.corloc_hit(jnp.asarray(b1), jnp.asarray(gt),
                                      None if v is None else jnp.asarray(v)))
            assert got == ref


def test_evaluate_corloc_matches_jax(tmp_path):
    """`tests/test_tasks.py`'s synthetic eigs directory through both packages:
    the same predictions, score and files."""
    img_dir, ann_dir, eigs_dir = (tmp_path / d for d in ("JPEGImages", "Annotations", "eigs"))
    for d in (img_dir, ann_dir, eigs_dir):
        d.mkdir()
    H, W = 160, 320
    pairs = []
    for i, hit in enumerate([True, True, False, True]):
        Image.fromarray(np.zeros((H, W, 3), np.uint8)).save(img_dir / f"im{i}.jpg")
        mask = np.zeros((10, 20), np.float32)
        mask[2:5, 3 + i:8 + i] = 1.0
        if i == 3:
            mask = 1.0 - mask  # over half foreground: inverted
        vec = mask.reshape(-1) * 2 - 1
        save_pth({"eigenvalues": np.zeros(2, np.float32),
                  "eigenvectors": np.stack([np.ones_like(vec), vec])}, eigs_dir / f"im{i}.pth")
        gt = (48 + 16 * i, 32, 128 + 16 * i, 80) if hit else (200, 100, 300, 150)
        _write_voc_xml(ann_dir / f"im{i}.xml", [gt])
        pairs.append((img_dir / f"im{i}.jpg", ann_dir / f"im{i}.xml"))
    out = {}
    for name, L in (("t", TL), ("j", JL)):
        out[name] = L.evaluate_corloc(pairs, eigs_dir, progress=False,
                                      output_dir=tmp_path / name)
    assert out["t"][0] == out["j"][0] == 75.0
    for a, b in zip(out["t"][1] + out["t"][2], out["j"][1] + out["j"][2]):
        np.testing.assert_array_equal(a, b)
    for f in ("preds.pkl", "gt.pkl", "results.txt"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


def test_lost_and_dino_seg_match_jax():
    rng = np.random.default_rng(0)
    wf, hf, d = 12, 10, 32
    grid = np.tile(rng.standard_normal(d), (wf, hf, 1)) + 0.05 * rng.standard_normal((wf, hf, d))
    grid[3:7, 2:6] = rng.standard_normal(d) + 0.05 * rng.standard_normal((4, 4, d))
    feats = grid.reshape(-1, d).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    Msum, seed, cent, A = TL._lost_core(torch.from_numpy(feats))
    j_Msum, j_seed, j_cent, j_A = JL._lost_core(jnp.asarray(feats))
    assert int(seed) == int(j_seed)
    np.testing.assert_array_equal(cent.numpy(), np.asarray(j_cent))
    np.testing.assert_allclose(Msum.numpy(), np.asarray(j_Msum), atol=1e-5)
    np.testing.assert_array_equal(Msum.numpy() > 0, np.asarray(j_Msum) > 0)
    np.testing.assert_array_equal(TL.lost(feats, (wf, hf), (16, 16), (wf * 16, hf * 16)),
                                  JL.lost(feats, (wf, hf), (16, 16), (wf * 16, hf * 16)))
    attn = rng.random((1, 4, wf * hf + 1, wf * hf + 1)).astype(np.float32)
    for head in range(4):
        np.testing.assert_array_equal(TL.dino_seg(attn, (wf, hf), 16, head),
                                      JL.dino_seg(attn, (wf, hf), 16, head))


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """A VOC tree of blob images with the blob as GT, the tiny ViT's
    DINO-format checkpoint, and the port's stage 1-2 eigs of the images."""
    root = tmp_path_factory.mktemp("voc")
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(4)
    ids = []
    for i, (h, w) in enumerate(SIZES):
        img = (rng.random((h, w, 3)) * 60).astype(np.uint8)
        y, x = int(rng.integers(4, h - 36)), int(rng.integers(4, w - 36))
        img[y:y + 32, x:x + 32] = [230, 50, 40]
        ids.append(f"v{i}")
        Image.fromarray(img).save(root / "JPEGImages" / f"v{i}.jpg", quality=95)
        _write_voc_xml(root / "Annotations" / f"v{i}.xml", [(x, y, x + 32, y + 32)])
    (root / "ImageSets" / "Main" / "trainval.txt").write_text("\n".join(ids))
    (root / "list.txt").write_text("\n".join(f"{i}.jpg" for i in ids))
    (root / "ckpt").mkdir()
    model = random_init_(VisionTransformer(get_model_config(MODEL)), seed=3)
    torch.save(model.state_dict(), root / "ckpt" / f"{MODEL}.pth")
    t_stages.extract_features(images_list=str(root / "list.txt"),
                              images_root=str(root / "JPEGImages"), model_name=MODEL,
                              batch_size=2, output_dir=str(root / "feats"),
                              ckpt_dir=str(root / "ckpt"), precision="fp32", device="cpu")
    t_stages.extract_eigs(images_root=str(root / "JPEGImages"), features_dir=str(root / "feats"),
                          output_dir=str(root / "eigs"), K=3, batch_size=2,
                          image_color_lambda=1.0, device="cpu")
    return root


@pytest.mark.parametrize("flags", [["--eigenseg", "--precomputed_eigs_dir", "eigs"],
                                   ["--eigenseg"], ["--lost"], ["--dino_seg"]])
def test_localization_cli_matches_jax(voc, flags, capsys):
    """Both packages' `localization` CLI on one VOC tree, from the port's
    eigs or on the fly with the same weights: the same predictions, GT and
    score."""
    flags = [str(voc / f) if f == "eigs" else f for f in flags]
    common = ["localization", "--dataset_root", str(voc), "--model_name", MODEL,
              "--ckpt_dir", str(voc / "ckpt"), *flags]
    tag = "_".join(f.strip("-") for f in flags[:1])
    assert t_cli.main(common + ["--output_dir", str(voc / f"t_{tag}_{len(flags)}"),
                                "--device", "cpu"]) == 0
    j_cli.main(common + ["--output_dir", str(voc / f"j_{tag}_{len(flags)}")])
    t_out, j_out = voc / f"t_{tag}_{len(flags)}", voc / f"j_{tag}_{len(flags)}"
    assert (t_out / "results.txt").read_text() == (j_out / "results.txt").read_text()
    assert (t_out / "results.txt").read_text().endswith(f",{len(SIZES)}\n")
    for f in ("preds.pkl", "gt.pkl"):
        t_v, j_v = (pickle.loads((o / f).read_bytes()) for o in (t_out, j_out))
        assert len(t_v) == len(j_v) == len(SIZES)
        for a, b in zip(t_v, j_v):
            np.testing.assert_array_equal(a, b)


def test_localization_cli_needs_the_card_by_default(voc):
    """Without --device the on-the-fly ViT is placed on CUDA, which raises
    on a host without a card; the task is no longer refused as unported."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["localization", "--dataset_root", str(voc), "--lost",
                    "--model_name", MODEL, "--ckpt_dir", str(voc / "ckpt"),
                    "--output_dir", str(voc / "t_default")])


def test_localization_vis_imports_matplotlib_lazily():
    code = ("import sys, deep_spectral_tpu_torch.tasks.localization_vis; "
            "assert 'matplotlib' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
