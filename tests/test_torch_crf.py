"""The port's dense CRF (`deep_spectral_tpu_torch/ops/crf.py`) and stage 9
(`extract_crf_segmentations`) against the JAX package's, on the CPU.

Inputs are made from seeded numpy draws and fed to both packages.
Tolerances:
  * helpers (`gaussian_filter_2d`, `_dense_kernel`, both regimes of
    `bilateral_filter`, at s = 1 and s > 1): 1e-5 relative to the largest
    entry. The port computes the bilateral coordinates in the order and
    rounding of XLA's jitted CPU code (see `ops/crf.py`), so what is left is
    the matmuls' and `exp`'s last bits, measured at <= 3e-6; the kernel's
    sq_i + sq_j - 2 dot cancellation would turn one coordinate ulp into
    ~3e-5.
  * labels (`dense_crf`, stage 9): >= 99.9% of each image's pixels equal to
    JAX's. A label can flip where two labels' marginals are nearly tied and
    the last bits differ.
  * the port against itself (batch 1 against batch 4, no batch in flight):
    the same bytes.
"""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent))
from crf_oracle import blobby_case  # noqa: E402

import deep_spectral_tpu.ops.crf as J  # noqa: E402
from deep_spectral_tpu.pipeline import extract as j_stages  # noqa: E402
import deep_spectral_tpu_torch.ops.crf as T  # noqa: E402
from deep_spectral_tpu_torch.pipeline import extract as t_stages  # noqa: E402
from deep_spectral_tpu_torch.utils.serialization import load_segmap_png  # noqa: E402

REL_TOL = 1e-5
LABEL_AGREEMENT = 0.999


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture
def grid_regime(monkeypatch):
    """Both packages' bilateral filters forced onto the 5-D grid (the dense
    bound lowered to 0), the JAX traces of the dense regime dropped."""
    monkeypatch.setattr(J, "_DENSE_MAX_POINTS", 0)
    monkeypatch.setattr(T, "_DENSE_MAX_POINTS", 0)
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_gaussian_filter_matches_jax():
    x = np.random.default_rng(0).random((2, 40, 30, 3)).astype(np.float32)
    for sigma in (1.0, 3.0):
        want = J.gaussian_filter_2d(jnp.asarray(x[0]), sigma)
        assert _rel(T.gaussian_filter_2d(torch.from_numpy(x[0]), sigma), want) <= REL_TOL
        # a batch filters each image as the single-image call does
        batch = T.gaussian_filter_2d(torch.from_numpy(x), sigma)
        assert torch.equal(batch[0], T.gaussian_filter_2d(torch.from_numpy(x[0]), sigma))


@pytest.mark.parametrize("alpha", [4.0, 16.0, 80.0])   # s = 1, 2, 10
def test_dense_kernel_matches_jax(alpha):
    """The kernel over the low-res coordinates of an image, as jitted JAX
    builds them."""
    img = (np.random.default_rng(1).random((64, 80, 3)) * 255).astype(np.float32)
    _, _, j_coords = jax.jit(lambda im: J._lowres_setup(im, alpha, 13.0))(jnp.asarray(img))
    s, _, coords = T._lowres_setup(torch.from_numpy(img), alpha, 13.0)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(j_coords))
    want = jax.jit(J._dense_kernel)(j_coords)
    assert _rel(T._dense_kernel(coords), want) <= REL_TOL


def _filter_case(seed, H, W, C):
    rng = np.random.default_rng(seed)
    img = (rng.random((H, W, 3)) * 255).astype(np.float32)
    img[H // 4: H // 2, W // 3: 2 * W // 3] = [200.0, 60.0, 50.0]
    vals = rng.random((H, W, C)).astype(np.float32)
    return img, vals


def _check_filter(img, vals, alpha, beta):
    avg, density = T.bilateral_filter(torch.from_numpy(vals), torch.from_numpy(img),
                                      alpha, beta)
    j_avg, j_density = J.bilateral_filter(jnp.asarray(vals), jnp.asarray(img), alpha, beta)
    assert avg.shape == j_avg.shape and density.shape == j_density.shape
    assert _rel(avg, j_avg) <= REL_TOL
    assert _rel(density, j_density) <= REL_TOL


@pytest.mark.parametrize("H,W,C,alpha,beta", [(16, 16, 1, 4.0, 26.0),   # s == 1
                                              (50, 70, 3, 16.0, 13.0),  # s == 2
                                              (64, 80, 7, 80.0, 13.0)])  # s == 10, C + 1 = 8
def test_bilateral_filter_dense_matches_jax(H, W, C, alpha, beta):
    _check_filter(*_filter_case(2, H, W, C), alpha, beta)


@pytest.mark.parametrize("H,W,C,alpha,beta", [(16, 16, 1, 4.0, 26.0),   # s == 1
                                              (48, 56, 3, 16.0, 13.0)])  # s == 2
def test_bilateral_filter_grid_matches_jax(grid_regime, H, W, C, alpha, beta):
    _check_filter(*_filter_case(3, H, W, C), alpha, beta)


def test_grid_splat_is_a_fixed_order_sum(grid_regime):
    """The splat's sorted, segmented sum equals an f64 scatter-add to f32
    rounding, and two plans of one image give the same bits."""
    img, vals = _filter_case(4, 40, 48, 3)
    img_t = torch.from_numpy(img)
    s, _, coords = T._lowres_setup(img_t, 16.0, 13.0)
    plans = [T._GridPlan(img_t, coords, 16.0, 13.0, s) for _ in range(2)]
    v = torch.from_numpy(vals[::2, ::2].reshape(-1, 3).copy())
    grids = [p.splat(v) for p in plans]
    assert torch.equal(grids[0], grids[1])
    p = plans[0]
    gy, gx, gc = p.grid_shape[:3]
    cells, w = T._grid_corners(coords, torch.tensor(p.grid_shape),
                               torch.tensor([gx * gc ** 3, gc ** 3, gc * gc, gc, 1]))
    upd = (v.double()[None] * w.double()[..., None] * s * s).reshape(-1, 3)
    ref = torch.zeros((p.G, 3), dtype=torch.float64).index_add_(0, cells.reshape(-1), upd)
    np.testing.assert_allclose(grids[0].numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def _blob_case(seed, H, W, n_labels=3):
    img, seg = blobby_case(np.random.default_rng(seed), H, W, n_labels=n_labels)
    return img, seg.astype(np.int32)


def _agreement(got, want) -> float:
    return float(np.mean(np.asarray(got) == np.asarray(want)))


@pytest.mark.parametrize("seed,H,W,pad", [(0, 96, 128, False), (1, 128, 128, False),
                                          (2, 80, 112, True)])
def test_dense_crf_labels_match_jax(seed, H, W, pad):
    """Three blob images at the default parameters; `pad`: the image and its
    segmap edge-replicated into stage 9's 64-pixel bucket (128x128 here), a
    ragged pad on both axes."""
    img, seg = _blob_case(seed, H, W)
    if pad:
        BH, BW = -(-H // 64) * 64, -(-W // 64) * 64
        img = np.pad(img, ((0, BH - H), (0, BW - W), (0, 0)), mode="edge")
        seg = np.pad(seg, ((0, BH - H), (0, BW - W)), mode="edge")
    want = np.asarray(J.dense_crf(jnp.asarray(img), jnp.asarray(seg), num_classes=3))
    got = T.dense_crf(torch.from_numpy(img), torch.from_numpy(seg), num_classes=3)
    assert got.dtype == torch.int32 and got.shape == seg.shape
    assert _agreement(got, want) >= LABEL_AGREEMENT
    assert (want != seg).mean() > 0.005  # the CRF moved labels: a real comparison


def test_dense_crf_grid_regime_labels_match_jax(grid_regime):
    img, seg = _blob_case(3, 56, 56)
    params = (10.0, 16.0, 13.0, 3.0, 3.0, 5.0)
    want = np.asarray(J.dense_crf(jnp.asarray(img), jnp.asarray(seg), num_classes=3,
                                  params=params))
    got = T.dense_crf(torch.from_numpy(img), torch.from_numpy(seg), num_classes=3,
                      params=params)
    assert _agreement(got, want) >= LABEL_AGREEMENT


def test_dense_crf_batch_gives_single_image_results():
    """A batch of same-shape images (mixed label counts, an out-of-range
    label) gives each image the single-image call's labels."""
    cases = [_blob_case(s, 64, 64, n_labels=n) for s, n in ((5, 3), (6, 2), (7, 3))]
    imgs = np.stack([c[0] for c in cases])
    segs = np.stack([c[1] for c in cases])
    segs[1, :3, :3] = 9  # outside num_classes: uniform unaries there
    batch = T.dense_crf(torch.from_numpy(imgs), torch.from_numpy(segs), num_classes=3)
    for i in range(len(cases)):
        single = T.dense_crf(torch.from_numpy(imgs[i]), torch.from_numpy(segs[i]),
                             num_classes=3)
        assert torch.equal(batch[i], single)
    want = np.asarray(J.dense_crf(jnp.asarray(imgs[1]), jnp.asarray(segs[1]), num_classes=3))
    assert _agreement(batch[1], want) >= LABEL_AGREEMENT


def test_coarse_blob_snaps_to_pixels():
    """The verification recipe's probe: a 16x-coarse nearest-upsampled blob
    mask through `dense_crf` at the default parameters gives blob IoU > 0.95
    (before the CRF ~0.8)."""
    rng = np.random.default_rng(0)
    H, W = 160, 240
    img = (rng.random((H, W, 3)) * 100).astype(np.float32)
    img[37:103, 83:171] = [210.0, 70.0, 60.0]
    blob = np.zeros((H, W), bool)
    blob[37:103, 83:171] = True
    coarse = blob[8::16, 8::16].astype(np.int32)
    seg = np.repeat(np.repeat(coarse, 16, 0), 16, 1)
    iou_before = (seg.astype(bool) & blob).sum() / (seg.astype(bool) | blob).sum()
    out = T.dense_crf(torch.from_numpy(img), torch.from_numpy(seg), num_classes=2).numpy()
    pred = out == 1
    iou = (pred & blob).sum() / (pred | blob).sum()
    assert iou > 0.95 and iou > iou_before, (iou, iou_before)


# ------------------------------------------------------------------ stage 9

IMAGES = [(96, 128), (90, 125), (64, 72)]


@pytest.fixture(scope="module")
def stage9(tmp_path_factory):
    """Blob images, JAX stage-8-style patch segmaps (labels 0-20 on the
    16-pixel grid) and single-region {0, 255} maps, and the JAX stage's
    output for both."""
    root = tmp_path_factory.mktemp("crf")
    rng = np.random.default_rng(0)
    for d in ("images", "semantic", "single"):
        (root / d).mkdir()
    names = []
    for i, (h, w) in enumerate(IMAGES):
        img = (rng.random((h, w, 3)) * 110).astype(np.uint8)
        y, x = h // 4, w // 3
        img[y: y + h // 3, x: x + w // 3] = [210, 60, 60]
        names.append(f"im{i}.jpg")
        Image.fromarray(img).save(root / "images" / names[-1], quality=95)
        gh, gw = h // 16, w // 16
        sem = np.zeros((gh, gw), np.uint8)
        sem[y // 16: (y + h // 3) // 16 + 1, x // 16: (x + w // 3) // 16 + 1] = 5 + i
        sem[0, :2] = 17
        Image.fromarray(sem).save(root / "semantic" / f"im{i}.png")
        Image.fromarray((sem > 0).astype(np.uint8) * 255).save(root / "single" / f"im{i}.png")
    (root / "images.txt").write_text("\n".join(names))
    for kind, num_classes in (("semantic", 21), ("single", 2)):
        j_stages.extract_crf_segmentations(
            str(root / "images.txt"), str(root / "images"), str(root / kind),
            str(root / f"j_{kind}"), num_classes=num_classes)
    return root


def _port_stage9(root, kind, out, **kw):
    num_classes = 21 if kind == "semantic" else 2
    t_stages.extract_crf_segmentations(
        str(root / "images.txt"), str(root / "images"), str(root / kind), str(out),
        num_classes=num_classes, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["semantic", "single"])
def test_stage9_matches_jax(stage9, tmp_path, kind):
    """On the JAX stage's inputs, each output PNG has the JAX one's shape and
    >= 99.9% of its labels (the {0, 255} maps read as {0, 1}); batch 1 and no
    batch in flight write the same bytes as batch 4; a rerun skips every
    existing file."""
    _port_stage9(stage9, kind, tmp_path / "b4")
    j_files = sorted((stage9 / f"j_{kind}").iterdir())
    t_files = sorted((tmp_path / "b4").iterdir())
    assert [f.name for f in t_files] == [f.name for f in j_files] == \
        [f"im{i}.png" for i in range(len(IMAGES))]
    for jf, tf in zip(j_files, t_files):
        want, got = load_segmap_png(jf), load_segmap_png(tf)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert _agreement(got, want) >= LABEL_AGREEMENT, tf.name
        assert got.max() < (21 if kind == "semantic" else 2)
    _port_stage9(stage9, kind, tmp_path / "b1", batch_size=1)
    old = os.environ.get("DSS_TPU_INFLIGHT")
    os.environ["DSS_TPU_INFLIGHT"] = "0"
    try:
        _port_stage9(stage9, kind, tmp_path / "inflight0")
    finally:
        if old is None:
            del os.environ["DSS_TPU_INFLIGHT"]
        else:
            os.environ["DSS_TPU_INFLIGHT"] = old
    for other in ("b1", "inflight0"):
        for tf in t_files:
            assert (tmp_path / other / tf.name).read_bytes() == tf.read_bytes(), (other, tf.name)
    stamps = {f.name: f.stat().st_mtime_ns for f in t_files}
    _port_stage9(stage9, kind, tmp_path / "b4")
    assert {f.name: f.stat().st_mtime_ns for f in (tmp_path / "b4").iterdir()} == stamps


def test_stage9_needs_the_card_by_default(stage9, tmp_path, monkeypatch):
    """Stage 9 runs on CUDA unless device='cpu' is passed: with no card it
    raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_stages.extract_crf_segmentations(
            str(stage9 / "images.txt"), str(stage9 / "images"), str(stage9 / "single"),
            str(tmp_path / "out"), num_classes=2)
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
