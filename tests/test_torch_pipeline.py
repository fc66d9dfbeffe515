"""Stages 1-2 of the port end to end against the JAX pipeline, on tiny
synthetic images, with the same weights (a DINO-format checkpoint of the
port's seeded init, loaded by both packages through `ckpt_dir`).

Tolerances: features are stored as fp16; the two fp32 forwards differ by
~1e-5, which can move a value across one fp16 rounding step (2^-10
relative), so 1e-3 relative + 1e-3 absolute. Eigenvalues from identical
feature files agree to 1e-4 and eigenvectors to |cosine| >= 0.999.
"""
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
    for flags in (["--image_color_lambda", "1.0"], ["--which_matrix", "affinity"],
                  ["--cheb_filter_impl", "xla"]):
        with pytest.raises(NotImplementedError):
            t_cli.main(["extract_eigs", "--images_root", str(root / "images"),
                        "--features_dir", str(root / "t_feats"),
                        "--output_dir", str(tmp_path / "x"), "--device", "cpu", *flags])
    with pytest.raises(SystemExit):
        t_cli.main(["extract_bboxes"])  # not ported: not a stage of this CLI


def test_port_imports_no_jax():
    code = ("import sys, deep_spectral_tpu_torch, deep_spectral_tpu_torch.pipeline.extract, "
            "deep_spectral_tpu_torch.pipeline.cli, deep_spectral_tpu_torch._build; "
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
