"""The port's morphology and stages 3-8 against the JAX package's.

Morphology (`deep_spectral_tpu_torch.ops.morphology`, batched over images)
against `deep_spectral_tpu.ops.morphology` image by image on random masks
and segmaps from a numpy seed: exactly equal.

Stages 3-8: each port stage runs on the JAX stage's own input files (the
JAX stage 1's features of tiny synthetic images through a DINO-format
checkpoint that both packages load by `ckpt_dir`; synthetic eigs whose
eigenvectors put each patch near one of 3 or 4 well-separated region
points, with an eigengap that says how many; the JAX stages' outputs
downstream), and its output is compared with the JAX stage's:
  * stage 3 (k-means draws differ): equal partitions up to a permutation,
    label 0 (the border-heavy segment) equal;
  * stages 4, 5 and 8: equal PNG arrays and equal loaded `.pth`;
  * stage 6: CLS features within 1e-4 absolute (fp32 tiny ViT; the port
    normalizes uint8 crops after the upload, JAX normalizes whole images in
    f32 before cropping, and the attention sums run in another order);
  * stage 7 (draws differ): equal partitions up to a permutation, on box
    features drawn around 3 well-separated directions.
One chained port run of stages 3-8 through the port's CLI (stage 8 as
`python -m deep_spectral_tpu_torch.pipeline`) checks the on-disk schema and
that each output follows from the one before it; stages 3 and 6 rerun with
no batch in flight (DSS_TPU_INFLIGHT=0) write the same bytes.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deep_spectral_tpu.pipeline import extract as j_stages
from deep_spectral_tpu.utils.serialization import load_pth, load_segmap_png, save_pth
from deep_spectral_tpu_torch.models.convert import random_init_
from deep_spectral_tpu_torch.models.vit import VisionTransformer, get_model_config
from deep_spectral_tpu_torch.ops import morphology as TM
from deep_spectral_tpu_torch.pipeline import cli as t_cli
from deep_spectral_tpu_torch.pipeline import extract as t_stages

JM = importlib.import_module("deep_spectral_tpu.ops.morphology")
MODEL = "test_vit_tiny"  # P = 8, embed_dim 32
# (H, W, regions): grids 12x16 and 11x15 (one 12x16 bucket), 8x9 and 8x12 (8x12)
IMAGES = [(96, 128, 4), (90, 125, 4), (64, 72, 3), (64, 96, 3)]
STAGE6 = dict(model_name=MODEL, batch_size=4, precision="fp32")


# ---------------------------------------------------------------- morphology

def _masks(rng, n=5, h=9, w=13, p=0.55):
    m = rng.random((n, h, w)) < p
    m[0] = False   # empty
    m[1] = True    # full
    return m


@pytest.mark.parametrize("iterations", [1, 2])
def test_erode_dilate_match_jax(iterations):
    m = _masks(np.random.default_rng(iterations))
    te = TM.binary_erode(torch.from_numpy(m), iterations).numpy()
    td = TM.binary_dilate(torch.from_numpy(m), iterations).numpy()
    for i in range(len(m)):
        np.testing.assert_array_equal(te[i], np.asarray(JM.binary_erode(jnp.asarray(m[i]),
                                                                          iterations)))
        np.testing.assert_array_equal(td[i], np.asarray(JM.binary_dilate(jnp.asarray(m[i]),
                                                                           iterations)))


@pytest.mark.parametrize("erode", [True, False])
def test_erode_or_dilate_mask_matches_jax(erode):
    """The never-empty guard per image: thin masks that a step would empty."""
    rng = np.random.default_rng(3)
    m = _masks(rng, p=0.3)
    m[2] = False
    m[2, 4, 2:5] = True  # one erosion empties it
    got = TM.erode_or_dilate_mask(torch.from_numpy(m), 3, erode).numpy()
    for i in range(len(m)):
        want = np.asarray(JM.erode_or_dilate_mask(jnp.asarray(m[i]), 3, erode))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_components_matches_jax(connectivity):
    m = _masks(np.random.default_rng(5), h=17, w=11, p=0.5)
    got = TM.label_components(torch.from_numpy(m), connectivity).numpy()
    for i in range(len(m)):
        want = np.asarray(JM.label_components(jnp.asarray(m[i]), connectivity))
        np.testing.assert_array_equal(got[i], want)
    sizes = TM.component_sizes(torch.from_numpy(got), 40).numpy()
    for i in range(len(m)):
        np.testing.assert_array_equal(
            sizes[i], np.asarray(JM.component_sizes(jnp.asarray(got[i]), 40)))


def test_largest_component_and_boxes_match_jax():
    """Including an empty mask (empty component, zero box) and ties between
    equal-sized components (the first label wins)."""
    m = _masks(np.random.default_rng(7), h=10, w=14, p=0.4)
    m[3] = False
    m[3, 1:3, 1:3] = m[3, 6:8, 9:11] = True  # two 2x2 components: a tie
    lc = TM.largest_component(torch.from_numpy(m)).numpy()
    lb = TM.largest_component_bbox(torch.from_numpy(m)).numpy()
    mb = TM.mask_bbox(torch.from_numpy(m)).numpy()
    for i in range(len(m)):
        mi = jnp.asarray(m[i])
        np.testing.assert_array_equal(lc[i], np.asarray(JM.largest_component(mi)))
        np.testing.assert_array_equal(lb[i], np.asarray(JM.largest_component_bbox(mi)))
        np.testing.assert_array_equal(mb[i], np.asarray(JM.mask_bbox(mi)))


@pytest.mark.parametrize("num_segments", [3, 5])
def test_border_fraction_and_background_swap_match_jax(num_segments):
    """Whole segmaps, and a padded batch with per-image extents against JAX
    on each image's valid part (corners counted twice, first max wins)."""
    rng = np.random.default_rng(num_segments)
    seg = rng.integers(0, num_segments, (4, 7, 9)).astype(np.int32)
    seg[1] = 0
    seg[1, :, :2] = 2 % num_segments  # one segment owns a whole side
    c, f = TM.get_border_fraction(torch.from_numpy(seg), num_segments)
    swapped = TM.infer_background_swap(torch.from_numpy(seg), num_segments).numpy()
    for i in range(len(seg)):
        jc, jf = JM.get_border_fraction(jnp.asarray(seg[i]), num_segments)
        np.testing.assert_array_equal(c[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(f[i].numpy(), np.asarray(jf))
        np.testing.assert_array_equal(
            swapped[i], np.asarray(JM.infer_background_swap(jnp.asarray(seg[i]), num_segments)))
    extents = np.array([[7, 9], [5, 3], [1, 6], [4, 1]])
    padded = torch.from_numpy(np.where(
        (np.arange(7)[:, None] < extents[:, :1, None]) & (np.arange(9) < extents[:, 1:, None]),
        seg, -1))
    got = TM.infer_background_swap(padded, num_segments, extents=torch.from_numpy(extents))
    for i, (h, w) in enumerate(extents):
        want = JM.infer_background_swap(jnp.asarray(seg[i, :h, :w]), num_segments)
        np.testing.assert_array_equal(got[i, :h, :w].numpy(), np.asarray(want))


# ------------------------------------------------------------ stages 3 to 8

def _regions(h, w, n):
    """A 2-patch border ring (the background: most border pixels) and n - 1
    interior blocks."""
    y, x = np.mgrid[:h, :w]
    lab = 1 + (x >= w // 2).astype(int)
    if n == 4:
        lab = np.where((y >= h // 2) & (x >= w // 2), 3, lab)
    ring = (y < 2) | (y >= h - 2) | (x < 2) | (x >= w - 2)
    return np.where(ring, 0, lab)


def _synthetic_eigs(rng, h, w, n):
    """K=5: a constant vector, then each patch's region point in R^4 plus
    0.02 noise; eigenvalues whose largest gap gives n clusters."""
    points = rng.normal(size=(n, 4)) * 2.0
    lab = _regions(h, w, n).reshape(-1)
    vecs = points[lab] + 0.02 * rng.normal(size=(h * w, 4))
    evecs = np.concatenate([np.full((1, h * w), 0.1), vecs.T]).astype(np.float32)
    evals = {4: [0.0, 0.01, 0.025, 0.04, 0.5], 3: [0.0, 0.01, 0.025, 0.4, 0.45]}[n]
    return {"eigenvalues": np.asarray(evals, np.float32), "eigenvectors": evecs}


def _same_partition(a, b):
    pairs = set(zip(a.reshape(-1).tolist(), b.reshape(-1).tolist()))
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


def _assert_equal_tree(a, b, path="root"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _no_batch_in_flight(fn, **kw):
    old = os.environ.get("DSS_TPU_INFLIGHT")
    os.environ["DSS_TPU_INFLIGHT"] = "0"
    try:
        fn(**kw)
    finally:
        if old is None:
            del os.environ["DSS_TPU_INFLIGHT"]
        else:
            os.environ["DSS_TPU_INFLIGHT"] = old


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every JAX stage once, and each port stage on the JAX stage's inputs."""
    root = tmp_path_factory.mktemp("segs")
    rng = np.random.default_rng(0)
    (root / "images").mkdir()
    (root / "eigs").mkdir()
    names = []
    for i, (h, w, _) in enumerate(IMAGES):
        img = (rng.random((h, w, 3)) * 120).astype(np.uint8)
        img[h // 4: h // 2, w // 3: w // 2] = [220, 60, 60]
        names.append(f"im{i}.png")
        Image.fromarray(img).save(root / "images" / names[-1])
    (root / "images.txt").write_text("\n".join(names))
    (root / "ckpt").mkdir()
    model = random_init_(VisionTransformer(get_model_config(MODEL)), seed=3)
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               root / "ckpt" / f"{MODEL}.pth")
    ckpt = str(root / "ckpt")
    j_stages.extract_features(images_list=str(root / "images.txt"),
                              images_root=str(root / "images"), model_name=MODEL,
                              batch_size=4, output_dir=str(root / "feats"),
                              ckpt_dir=ckpt, precision="fp32")
    for i, (h, w, n) in enumerate(IMAGES):
        save_pth(_synthetic_eigs(rng, h // 8, w // 8, n), root / "eigs" / f"im{i}.pth")
    d = {k: str(root / k) for k in ("feats", "eigs", "images")}

    for pkg, stages, kw in (("j", j_stages, {}), ("t", t_stages, {"device": "cpu"})):
        stages.extract_multi_region_segmentations(
            features_dir=d["feats"], eigs_dir=d["eigs"], output_dir=str(root / f"{pkg}_multi"),
            adaptive=True, **kw)
        stages.extract_single_region_segmentations(
            features_dir=d["feats"], eigs_dir=d["eigs"], output_dir=str(root / f"{pkg}_single"))
        stages.extract_bboxes(features_dir=d["feats"], segmentations_dir=str(root / "j_multi"),
                              output_file=str(root / f"{pkg}_bboxes.pth"))
    # stage 6's input: JAX's boxes plus a crop narrower than one patch and an
    # image without boxes
    boxes = load_pth(root / "j_bboxes.pth")
    boxes[0]["bboxes"].append([0, 0, 1, 4])
    boxes[0]["bboxes_original_resolution"].append([3, 0, 8, 30])
    boxes[0]["segment_indices"].append(9)
    boxes.append({"bboxes": [], "bboxes_original_resolution": [], "segment_indices": [],
                  "id": "im3", "format": "(xmin, ymin, xmax, ymax)"})
    save_pth(boxes, root / "bboxes6.pth")
    for pkg, stages, kw in (("j", j_stages, {}), ("t", t_stages, {"device": "cpu"})):
        stages.extract_bbox_features(images_root=d["images"], bbox_file=str(root / "bboxes6.pth"),
                                     output_file=str(root / f"{pkg}_bbox_feats.pth"),
                                     ckpt_dir=ckpt, **STAGE6, **kw)
    # stage 7's input: JAX's boxes with features around 3 directions
    blobs = rng.normal(size=(3, 32)) * 3.0
    synth = load_pth(root / "j_bboxes.pth")
    n_boxes = sum(len(b["bboxes"]) for b in synth)
    which = np.concatenate([np.arange(3), rng.integers(0, 3, n_boxes - 3)])
    feats = (blobs[which] + 0.1 * rng.normal(size=(n_boxes, 32))).astype(np.float32)
    at = 0
    for b in synth:
        b["features"] = feats[at: at + len(b["bboxes"])]
        at += len(b["bboxes"])
    save_pth(synth, root / "synth_feats.pth")
    for pkg, stages, kw in (("j", j_stages, {}), ("t", t_stages, {"device": "cpu"})):
        for pca_dim in (0, 4):
            stages.extract_bbox_clusters(bbox_features_file=str(root / "synth_feats.pth"),
                                         output_file=str(root / f"{pkg}_clusters{pca_dim}.pth"),
                                         num_clusters=3, pca_dim=pca_dim, **kw)
        stages.extract_semantic_segmentations(
            segmentations_dir=str(root / "j_multi"), bbox_clusters_file=str(root / "j_clusters0.pth"),
            output_dir=str(root / f"{pkg}_semantic"))
    # stage 8 on 0/255 single-region segmaps
    single = []
    for b in load_pth(root / "j_bboxes.pth"):
        single.append({"id": b["id"], "segment_indices": [255], "bboxes": [[0, 0, 1, 1]],
                       "clusters": np.array([2], np.int32)})
    save_pth(single, root / "single_clusters.pth")
    for pkg, stages in (("j", j_stages), ("t", t_stages)):
        stages.extract_semantic_segmentations(
            segmentations_dir=str(root / "j_single"),
            bbox_clusters_file=str(root / "single_clusters.pth"),
            output_dir=str(root / f"{pkg}_semantic_single"))
    _no_batch_in_flight(t_stages.extract_multi_region_segmentations, features_dir=d["feats"],
                        eigs_dir=d["eigs"], output_dir=str(root / "t_multi_0"), adaptive=True,
                        device="cpu")
    t_stages.extract_multi_region_segmentations(
        features_dir=d["feats"], eigs_dir=d["eigs"], output_dir=str(root / "t_multi_b1"),
        adaptive=True, batch_size=1, device="cpu")
    _no_batch_in_flight(t_stages.extract_bbox_features, images_root=d["images"],
                        bbox_file=str(root / "bboxes6.pth"),
                        output_file=str(root / "inflight0" / "t_bbox_feats.pth"), ckpt_dir=ckpt,
                        device="cpu", **STAGE6)
    return root


def _stems():
    return [f"im{i}" for i in range(len(IMAGES))]


def test_multi_region_matches_jax(run):
    """Stage 3 (adaptive: 4 regions in two images, 3 in the others, two
    n_clusters groups, two buckets, ragged extents)."""
    for stem, (h, w, n) in zip(_stems(), IMAGES):
        j = load_segmap_png(run / "j_multi" / f"{stem}.png")
        t = load_segmap_png(run / "t_multi" / f"{stem}.png")
        assert t.dtype == j.dtype == np.uint8 and t.shape == j.shape == (h // 8, w // 8)
        assert len(np.unique(t)) == n
        assert _same_partition(t, j), stem
        np.testing.assert_array_equal(t == 0, j == 0)
        np.testing.assert_array_equal(t == 0, _regions(h // 8, w // 8, n) == 0)


def test_multi_region_does_not_depend_on_the_batch(run):
    """Each image's k-means draws come from its own generator (seed +
    index): one image per batch writes the bytes of the default batching."""
    for stem in _stems():
        assert (run / "t_multi" / f"{stem}.png").read_bytes() == \
            (run / "t_multi_b1" / f"{stem}.png").read_bytes()


def test_single_region_matches_jax(run):
    for stem in _stems():
        j = load_segmap_png(run / "j_single" / f"{stem}.png")
        t = load_segmap_png(run / "t_single" / f"{stem}.png")
        assert set(np.unique(t).tolist()) <= {0, 255}
        np.testing.assert_array_equal(t, j)


def test_bboxes_match_jax(run):
    j, t = load_pth(run / "j_bboxes.pth"), load_pth(run / "t_bboxes.pth")
    _assert_equal_tree(t, j)
    assert [b["id"] for b in t] == _stems()
    assert sum(len(b["bboxes"]) for b in t) >= 3


def test_bbox_features_match_jax(run):
    """Stage 6: CLS features within 1e-4 (see the module docstring), the
    narrow crop's and the box-less image's included; the rest equal."""
    j, t = load_pth(run / "j_bbox_feats.pth"), load_pth(run / "t_bbox_feats.pth")
    assert len(t) == len(j) == len(IMAGES) + 1
    for a, b in zip(t, j):
        fa, fb = a.pop("features"), b.pop("features")
        assert fa.dtype == fb.dtype == np.float32 and fa.shape == fb.shape
        assert fa.shape == (len(b["bboxes"]), 32)
        np.testing.assert_allclose(fa, fb, rtol=0, atol=1e-4)
        _assert_equal_tree(a, b)


@pytest.mark.parametrize("pca_dim", [0, 4])
def test_bbox_clusters_match_jax(run, pca_dim):
    j = load_pth(run / f"j_clusters{pca_dim}.pth")
    t = load_pth(run / f"t_clusters{pca_dim}.pth")
    tc, jc = (np.concatenate([b["clusters"] for b in x]) for x in (t, j))
    assert tc.dtype == jc.dtype == np.int32
    assert _same_partition(tc, jc) and len(np.unique(tc)) == 3
    for a, b in zip(t, j):
        a.pop("clusters"), b.pop("clusters")
        _assert_equal_tree(a, b)


@pytest.mark.parametrize("which", ["semantic", "semantic_single"])
def test_semantic_segmentations_match_jax(run, which):
    for stem in _stems():
        np.testing.assert_array_equal(load_segmap_png(run / f"t_{which}" / f"{stem}.png"),
                                      load_segmap_png(run / f"j_{which}" / f"{stem}.png"))


def test_no_batch_in_flight_same_bytes(run):
    """DSS_TPU_INFLIGHT=0 writes the bytes of the default (one batch in
    flight) in stages 3 and 6."""
    for stem in _stems():
        assert (run / "t_multi" / f"{stem}.png").read_bytes() == \
            (run / "t_multi_0" / f"{stem}.png").read_bytes()
    # the same file name: torch.save writes it into the archive
    assert (run / "t_bbox_feats.pth").read_bytes() == \
        (run / "inflight0" / "t_bbox_feats.pth").read_bytes()


def test_chained_stages_through_the_cli(run, tmp_path):
    """Stages 3-8 of the port chained through its CLI, stage 8 as
    `python -m deep_spectral_tpu_torch.pipeline`: every output with the
    JAX schema, each following from the one before it."""
    c = tmp_path
    t_cli.main(["extract_multi_region_segmentations", "--features_dir", str(run / "feats"),
                "--eigs_dir", str(run / "eigs"), "--output_dir", str(c / "multi"),
                "--adaptive", "true", "--device", "cpu"])
    t_cli.main(["extract_single_region_segmentations", "--features_dir", str(run / "feats"),
                "--eigs_dir", str(run / "eigs"), "--output_dir", str(c / "single")])
    t_cli.main(["extract_bboxes", "--features_dir", str(run / "feats"),
                "--segmentations_dir", str(c / "multi"), "--output_file", str(c / "bboxes.pth")])
    t_cli.main(["extract_bbox_features", "--images_root", str(run / "images"),
                "--bbox_file", str(c / "bboxes.pth"), "--model_name", MODEL,
                "--output_file", str(c / "feats.pth"), "--ckpt_dir", str(run / "ckpt"),
                "--precision", "fp32", "--batch_size", "4", "--device", "cpu"])
    t_cli.main(["extract_bbox_clusters", "--bbox_features_file", str(c / "feats.pth"),
                "--output_file", str(c / "clusters.pth"), "--num_clusters", "2",
                "--device", "cpu"])
    subprocess.run([sys.executable, "-m", "deep_spectral_tpu_torch.pipeline",
                    "extract_semantic_segmentations", "--segmentations_dir", str(c / "multi"),
                    "--bbox_clusters_file", str(c / "clusters.pth"),
                    "--output_dir", str(c / "semantic")],
                   check=True, cwd=Path(__file__).resolve().parents[1])
    for stem in _stems():
        for sub in ("multi", "single"):  # the same bytes as the direct runs
            assert (c / sub / f"{stem}.png").read_bytes() == \
                (run / f"t_{sub}" / f"{stem}.png").read_bytes()
    boxes = load_pth(c / "bboxes.pth")
    assert set(boxes[0]) == {"bboxes", "bboxes_original_resolution", "segment_indices",
                             "id", "format"}
    feats = load_pth(c / "feats.pth")
    assert set(feats[0]) == set(boxes[0]) | {"features"}
    clusters = load_pth(c / "clusters.pth")
    assert set(clusters[0]) == set(boxes[0]) | {"clusters"}
    for b in clusters:
        seg = load_segmap_png(c / "multi" / f"{b['id']}.png")
        sem = load_segmap_png(c / "semantic" / f"{b['id']}.png")
        assert sem.dtype == np.uint8 and sem.shape == seg.shape
        np.testing.assert_array_equal(sem[seg == 0], 0)
        for s, k in zip(b["segment_indices"], b["clusters"].tolist()):
            np.testing.assert_array_equal(sem[seg == s], k)


@pytest.mark.parametrize("stage", ["extract_multi_region_segmentations",
                                   "extract_bbox_features", "extract_bbox_clusters"])
def test_card_stages_need_the_card_by_default(run, tmp_path, monkeypatch, stage):
    """Stages 3, 6 and 7 run on CUDA unless device='cpu' is passed: with no
    card they raise before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {"extract_multi_region_segmentations": dict(
              features_dir=str(run / "feats"), eigs_dir=str(run / "eigs"),
              output_dir=str(tmp_path / "m")),
          "extract_bbox_features": dict(
              images_root=str(run / "images"), bbox_file=str(run / "j_bboxes.pth"),
              model_name=MODEL, output_file=str(tmp_path / "f.pth")),
          "extract_bbox_clusters": dict(
              bbox_features_file=str(run / "synth_feats.pth"),
              output_file=str(tmp_path / "c.pth"))}[stage]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(t_stages, stage)(**kw)
    assert not any(tmp_path.iterdir())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
