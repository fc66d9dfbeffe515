"""Stages 1-2 of the port end to end against the JAX pipeline, on tiny
synthetic images, with the same weights (a DINO-format checkpoint of the
port's seeded init, loaded by both packages through `ckpt_dir`).

Stage 2 runs on the same feature files in both packages in its default
configuration and, on two of the images (`VARIANT_IMAGES`: each of the JAX
stage's bucket shapes costs a compile), in the variants of `VARIANTS` (the
color-fused graph with the knn and rw color affinities, features upsampled
to a grid of half the patch size, the 'affinity' mode, the XLA-chain filter
on that upsampled grid, where the chebyshev solver runs). The port's stages
run once more with no batch in flight (`DSS_TPU_INFLIGHT=0`), which must
write the same bytes.

Tolerances: features are stored as fp16; the two fp32 forwards differ by
~1e-5, which can move a value across one fp16 rounding step (2^-10
relative), so 1e-3 relative + 1e-3 absolute. Eigenvalues from identical
feature files agree to 1e-4 and eigenvectors to |cosine| >= 0.999; the
'affinity' mode's eigenvalues (of W, up to ~N) to 1e-5 relative.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from deep_spectral_tpu.pipeline import extract as j_stages
from deep_spectral_tpu.utils.serialization import load_pth
from deep_spectral_tpu_torch.models.convert import random_init_
from deep_spectral_tpu_torch.models.vit import VisionTransformer, get_model_config
from deep_spectral_tpu_torch.pipeline import cli as t_cli
from deep_spectral_tpu_torch.pipeline import extract as t_stages

MODEL = "test_vit_tiny"
# (H, W): patch grids 12x16, 14x12, 8x9 and 25x25 (625 nodes: the chebyshev
# solver's regime; the others take dense eigh).
SIZES = [(96, 128), (112, 96), (64, 72), (200, 200)]
FEATURE_KEYS = {"k", "indices", "file", "id", "model_name", "patch_size", "shape"}
VARIANTS = {"color_knn": dict(image_color_lambda=1.0, which_color_matrix="knn"),
            "color_rw": dict(image_color_lambda=1.0, which_color_matrix="rw"),
            "upsampled": dict(image_downsample_factor=4),  # 2x the P=8 grid
            "affinity": dict(which_matrix="affinity"),
            "xla": dict(cheb_filter_impl="xla", image_downsample_factor=4)}
# 12x16 (768 nodes upsampled: chebyshev) and 8x9 (ragged in its 8x12 bucket)
VARIANT_IMAGES = [0, 2]


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
    root = tmp_path_factory.mktemp("pipe")
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i, (h, w) in enumerate(SIZES):
        img = (rng.random((h, w, 3)) * 120).astype(np.uint8)
        y, x = rng.integers(8, h - 40), rng.integers(8, w - 40)
        img[y:y + 32, x:x + 32] = [220, 60, 60]
        names.append(f"img_{i}.png")
        Image.fromarray(img).save(root / "images" / names[-1])
    (root / "images.txt").write_text("\n".join(names))
    (root / "ckpt").mkdir()
    model = random_init_(VisionTransformer(get_model_config(MODEL)), seed=5)
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               root / "ckpt" / f"{MODEL}.pth")
    common = dict(images_list=str(root / "images.txt"), images_root=str(root / "images"),
                  model_name=MODEL, batch_size=2, ckpt_dir=str(root / "ckpt"),
                  precision="fp32")
    j_stages.extract_features(output_dir=str(root / "j_feats"), **common)
    t_stages.extract_features(output_dir=str(root / "t_feats"), device="cpu", **common)
    eig = dict(images_root=str(root / "images"), K=5, batch_size=2)
    j_stages.extract_eigs(features_dir=str(root / "j_feats"), output_dir=str(root / "j_eigs"),
                          cheb_filter_impl="pallas", **eig)
    t_stages.extract_eigs(features_dir=str(root / "j_feats"), output_dir=str(root / "t_eigs"),
                          device="cpu", **eig)
    t_stages.extract_eigs(features_dir=str(root / "t_feats"), output_dir=str(root / "tt_eigs"),
                          device="cpu", **eig)
    (root / "j_feats_some").mkdir()
    for i in VARIANT_IMAGES:
        stem = Path(names[i]).stem
        (root / "j_feats_some" / f"{stem}.pth").write_bytes(
            (root / "j_feats" / f"{stem}.pth").read_bytes())
    for name, kw in VARIANTS.items():
        j_stages.extract_eigs(features_dir=str(root / "j_feats_some"),
                              output_dir=str(root / f"j_eigs_{name}"), **eig, **kw)
        t_stages.extract_eigs(features_dir=str(root / "j_feats_some"),
                              output_dir=str(root / f"t_eigs_{name}"), device="cpu", **eig, **kw)
    _no_batch_in_flight(t_stages.extract_features, output_dir=str(root / "t_feats_0"),
                        device="cpu", **common)
    _no_batch_in_flight(t_stages.extract_eigs, features_dir=str(root / "t_feats"),
                        output_dir=str(root / "tt_eigs_0"), device="cpu", **eig)
    return root, names


def _stems(names):
    return [Path(n).stem for n in names]


def test_features_match_jax(run):
    root, names = run
    for stem, (h, w) in zip(_stems(names), SIZES):
        j = load_pth(root / "j_feats" / f"{stem}.pth")
        t = load_pth(root / "t_feats" / f"{stem}.pth")
        assert set(t) == set(j) >= FEATURE_KEYS
        n = (h // 8) * (w // 8)
        assert t["k"].dtype == np.float16 and t["k"].shape == j["k"].shape == (1, n, 32)
        np.testing.assert_allclose(t["k"].astype(np.float32), j["k"].astype(np.float32),
                                   rtol=1e-3, atol=1e-3)
        for key in FEATURE_KEYS - {"k"}:
            np.testing.assert_array_equal(np.asarray(t[key]), np.asarray(j[key]))


@pytest.mark.parametrize("port_eigs", ["t_eigs", "tt_eigs"])
def test_eigs_match_jax(run, port_eigs):
    """t_eigs: the port's stage 2 on the JAX features; tt_eigs: the port's
    stage 2 on its own features (both against the JAX stage 2 on the JAX
    features)."""
    root, names = run
    for stem, (h, w) in zip(_stems(names), SIZES):
        j = load_pth(root / "j_eigs" / f"{stem}.pth")
        t = load_pth(root / port_eigs / f"{stem}.pth")
        n = (h // 8) * (w // 8)
        assert set(t) == set(j) == {"eigenvalues", "eigenvectors"}
        assert t["eigenvalues"].dtype == t["eigenvectors"].dtype == np.float32
        assert t["eigenvalues"].shape == (5,) and t["eigenvectors"].shape == (5, n)
        np.testing.assert_allclose(t["eigenvalues"], j["eigenvalues"], atol=1e-4)
        a, b = t["eigenvectors"].astype(np.float64), j["eigenvectors"].astype(np.float64)
        cos = np.abs((a * b).sum(1)) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        assert cos.min() >= 0.999, (stem, cos)


def _cos(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return np.abs((a * b).sum(1)) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eigs_variants_match_jax(run, variant):
    """The stage-2 flags that raised NotImplementedError before this port
    slice, each against the JAX stage on the same feature files."""
    root, names = run
    f = VARIANTS[variant].get("image_downsample_factor", 8)
    for i in VARIANT_IMAGES:
        stem, (h, w) = Path(names[i]).stem, SIZES[i]
        j = load_pth(root / f"j_eigs_{variant}" / f"{stem}.pth")
        t = load_pth(root / f"t_eigs_{variant}" / f"{stem}.pth")
        n = ((h // 8) * 8 // f) * ((w // 8) * 8 // f)
        assert t["eigenvalues"].shape == (5,) and t["eigenvectors"].shape == (5, n)
        if variant == "affinity":
            np.testing.assert_allclose(t["eigenvalues"], j["eigenvalues"], rtol=1e-5)
        else:
            np.testing.assert_allclose(t["eigenvalues"], j["eigenvalues"], atol=1e-4)
        assert _cos(t["eigenvectors"], j["eigenvectors"]).min() >= 0.999, stem


def test_no_batch_in_flight_same_bytes(run):
    """DSS_TPU_INFLIGHT=0 (fetch each batch at once) writes the bytes the
    default (one batch in flight) writes, in both stages."""
    root, names = run
    for a, b in (("t_feats", "t_feats_0"), ("tt_eigs", "tt_eigs_0")):
        for stem in _stems(names):
            assert (root / a / f"{stem}.pth").read_bytes() == \
                (root / b / f"{stem}.pth").read_bytes(), (a, stem)


def test_stages_resume_and_cli(run, tmp_path, capsys):
    root, names = run
    t_cli.main(["extract_features", "--images_list", str(root / "images.txt"),
                "--images_root", str(root / "images"), "--output_dir", str(root / "t_feats"),
                "--model_name", MODEL, "--batch_size", "2", "--device", "cpu"])
    assert "Saved 0 features" in capsys.readouterr().out  # every output existed
    t_cli.main(["extract_eigs", "--images_root", str(root / "images"),
                "--features_dir", str(root / "t_feats"), "--output_dir", str(tmp_path / "e"),
                "--K", "3", "--solver", "eigh", "--device", "cpu"])
    assert len(list((tmp_path / "e").iterdir())) == len(names)
    eigs = ["extract_eigs", "--images_root", str(root / "images"),
            "--features_dir", str(root / "t_feats"), "--device", "cpu", "--K", "3"]
    t_cli.main(eigs + ["--output_dir", str(tmp_path / "x"), "--cheb_filter_impl", "xla"])
    assert len(list((tmp_path / "x").iterdir())) == len(names)
    assert "eigs: chebyshev filter 'xla'" in capsys.readouterr().out
    for i, flags in enumerate((["--image_color_lambda", "1.0", "--which_color_matrix", "rw"],
                               ["--which_matrix", "affinity_svd"],
                               ["--image_downsample_factor", "16", "--lapnorm", "false"])):
        t_cli.main(eigs + ["--output_dir", str(tmp_path / f"v{i}"), *flags])
        assert len(list((tmp_path / f"v{i}").iterdir())) == len(names)
    n = (200 // 16) ** 2  # the 200x200 image on a 16-pixel grid
    assert load_pth(tmp_path / "v2" / "img_3.pth")["eigenvectors"].shape == (3, n)
    with pytest.raises(SystemExit):
        t_cli.main(["extract_crf_segmentations"])  # its required flags are missing


def test_port_imports_no_jax():
    code = ("import sys, deep_spectral_tpu_torch, deep_spectral_tpu_torch.pipeline.extract, "
            "deep_spectral_tpu_torch.pipeline.cli, deep_spectral_tpu_torch._build, "
            "deep_spectral_tpu_torch.tasks.cli, deep_spectral_tpu_torch.tasks.semantic_segmentation, "
            "deep_spectral_tpu_torch.models.deeplab, deep_spectral_tpu_torch.ops.lobpcg, "
            "deep_spectral_tpu_torch.ops.metrics, deep_spectral_tpu_torch.utils.native_cc, "
            "deep_spectral_tpu_torch.tasks.localization, "
            "deep_spectral_tpu_torch.tasks.localization_vis, "
            "deep_spectral_tpu_torch.ops.kmeans, deep_spectral_tpu_torch.ops.morphology, "
            "deep_spectral_tpu_torch.ops.resize, deep_spectral_tpu_torch.tasks.object_segmentation, "
            "deep_spectral_tpu_torch.ops.crf, deep_spectral_tpu_torch.pipeline.run_all, "
            "deep_spectral_tpu_torch.pipeline.vis_server, deep_spectral_tpu_torch.utils.profiling, "
            "deep_spectral_tpu_torch.models.resnet, deep_spectral_tpu_torch.parallel, "
            "deep_spectral_tpu_torch.parallel.distributed, deep_spectral_tpu_torch.parallel.mesh, "
            "deep_spectral_tpu_torch.parallel.lobpcg, deep_spectral_tpu_torch.parallel.ring_attention, "
            "deep_spectral_tpu_torch.parallel.sp_vit, deep_spectral_tpu_torch.parallel.pp_vit, "
            "deep_spectral_tpu_torch.parallel.sharded, deep_spectral_tpu_torch.utils.logging, "
            "deep_spectral_tpu_torch.data; "
            "assert 'jax' not in sys.modules and 'deep_spectral_tpu' not in sys.modules")
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
