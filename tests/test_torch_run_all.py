"""The port's entry points around the stages against the JAX package's, on the CPU:
`run_all` (stages 1-9 and the single-region CRF, with its timing summary),
stage 10's gallery (`vis_segmentations`), the viewer server (`vis_server`)
and `utils.profiling`.

Inputs are seeded synthetic images and segmaps, written once and read by
both packages. Stage 10 and the server must give the JAX package's bytes:
both draw the same arrays with matplotlib's Agg backend, or encode them with
PIL.
"""
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from deep_spectral_tpu.pipeline import extract as j_stages
from deep_spectral_tpu.pipeline.vis_server import make_vis_server as j_make_vis_server
from deep_spectral_tpu.utils.serialization import save_pth
from deep_spectral_tpu_torch.pipeline import cli as t_cli
from deep_spectral_tpu_torch.pipeline import extract as t_stages
from deep_spectral_tpu_torch.pipeline import run_all as t_run_all
from deep_spectral_tpu_torch.pipeline.vis_server import PALETTE
from deep_spectral_tpu_torch.pipeline.vis_server import make_vis_server as t_make_vis_server
from deep_spectral_tpu_torch.utils.profiling import StageTimer, trace
from deep_spectral_tpu_torch.utils.serialization import load_pth, load_segmap_png


def _images(root, rng, shapes):
    (root / "images").mkdir(parents=True, exist_ok=True)
    names = []
    for i, (h, w) in enumerate(shapes):
        img = (rng.random((h, w, 3)) * 110).astype(np.uint8)
        img[h // 3: 2 * h // 3, w // 3: 3 * w // 4] = [210, 60, 60]
        names.append(f"r{i}.jpg")
        Image.fromarray(img).save(root / "images" / names[-1], quality=95)
    return names


def test_run_all(tmp_path, capsys):
    """`tests/test_run_all.py`'s run on the port with device='cpu': every
    stage writes its outputs in the canonical layout, with the stages'
    schemas, and the timer summary is printed."""
    names = _images(tmp_path, np.random.default_rng(3), [(96, 128), (96, 128)])
    (tmp_path / "lists").mkdir()
    (tmp_path / "lists" / "images.txt").write_text("\n".join(names))
    dirs = t_run_all.run_all(
        images_list=str(tmp_path / "lists" / "images.txt"),
        images_root=str(tmp_path / "images"), output_root=str(tmp_path / "out"),
        num_clusters=2, crf_num_classes=3, non_adaptive_num_segments=2,
        feature_batch_size=2, batch_size=2, K=4, device="cpu")
    for key in ["features", "eigs", "multi", "single", "semantic", "crf", "crf_single"]:
        assert len(list(Path(dirs[key]).iterdir())) == 2, key
    for key in ["bboxes", "bbox_features", "bbox_clusters"]:
        assert len(load_pth(dirs[key])) == 2, key
    feats = load_pth(f"{dirs['features']}/r0.pth")
    assert feats["k"].shape == (1, 6 * 8, 384) and feats["k"].dtype == np.float16
    assert load_pth(f"{dirs['eigs']}/r0.pth")["eigenvectors"].shape == (4, 48)
    for key, labels in (("crf", 3), ("crf_single", 2)):
        for i in range(2):
            crf = load_segmap_png(f"{dirs[key]}/r{i}.png")
            assert crf.shape == (96, 128) and crf.dtype == np.uint8 and crf.max() < labels
    out = capsys.readouterr().out
    summary = out[out.index("stage "):].splitlines()
    assert "items/s" in summary[0]
    assert [ln.split()[0] for ln in summary[1:]] == [
        "extract_features", "extract_eigs", "multi_region", "single_region", "bboxes",
        "bbox_features", "bbox_clusters", "semantic_segmaps", "crf", "crf_single_region"]
    assert all(ln.split()[1] == "2" for ln in summary[1:])


def test_run_all_stop_after_and_cli(tmp_path, capsys):
    """`stop_after` ends the run after the named stage; the module's argparse
    front end takes the same flags."""
    names = _images(tmp_path, np.random.default_rng(4), [(64, 80)])
    (tmp_path / "images.txt").write_text("\n".join(names))
    dirs = t_run_all.main(["--images_list", str(tmp_path / "images.txt"),
                           "--images_root", str(tmp_path / "images"),
                           "--output_root", str(tmp_path / "out"), "--model_name",
                           "test_vit_tiny", "--K", "3", "--stop_after", "extract_eigs",
                           "--device", "cpu"])
    assert len(list((tmp_path / "out" / "eigs" / "laplacian").iterdir())) == 1
    assert not (tmp_path / "out" / "multi_region_segmentation").exists()
    out = capsys.readouterr().out
    assert "Stopped after stage 'extract_eigs'" in out and "multi_region" not in out
    assert dirs["crf"].endswith("semantic_segmentations/crf/fixed/segmaps")
    with pytest.raises(ValueError, match="unknown stop_after"):
        t_run_all.run_all(str(tmp_path / "images.txt"), str(tmp_path / "images"),
                          str(tmp_path / "x"), stop_after="stage_11", device="cpu")


def test_run_all_needs_the_card_by_default(tmp_path, monkeypatch):
    """run_all runs on CUDA unless device='cpu' is passed: with no card it
    raises before any stage runs."""
    names = _images(tmp_path, np.random.default_rng(5), [(64, 80)])
    (tmp_path / "images.txt").write_text("\n".join(names))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_run_all.run_all(str(tmp_path / "images.txt"), str(tmp_path / "images"),
                          str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_stage_timer_and_trace(tmp_path):
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("a", n_items=3):
            torch.ones(4).sum()
    assert timer.stats["a"].items == 6 and timer.stats["a"].seconds > 0
    assert timer.summary().splitlines()[1].split()[:2] == ["a", "6"]
    with trace(str(tmp_path / "tr")):
        torch.ones(8).cumsum(0)
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    with trace(None):  # no logdir: no trace
        pass


@pytest.fixture(scope="module")
def vis_tree(tmp_path_factory):
    """`tests/test_vis_server.py`'s tree: two images listed out of order,
    a segmap with labels, a {0, 255} segmap, an eigs file and a box file."""
    root = tmp_path_factory.mktemp("vis")
    for d in ("images", "segs", "eigs"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)).save(
            root / "images" / f"{name}.jpg")
    (root / "images.txt").write_text("b.jpg\na.jpg\n")
    seg = np.zeros((4, 6), np.uint8)
    seg[1:3, 2:5] = 1
    seg[3, 0] = 2
    Image.fromarray(seg).save(root / "segs" / "a.png")
    segb = np.zeros((4, 6), np.uint8)
    segb[0, :3] = 255
    Image.fromarray(segb).save(root / "segs" / "b.png")
    save_pth({"eigenvalues": np.zeros(3, np.float32),
              "eigenvectors": rng.standard_normal((3, 24)).astype(np.float32)},
             root / "eigs" / "a.pth")
    save_pth([{"id": "a", "bboxes_original_resolution": [[5, 6, 40, 30]]}],
             root / "bboxes.pth")
    return root


PATHS = ["/", "/api/index", "/image/a", "/image/b", "/seg/a", "/seg/b", "/eig/a/1",
         "/eig/a/2"]
MISSING = ["/image/zzz", "/seg/zzz", "/eig/a/9", "/eig/zzz/0", "/image/%2e%2e%2fimages.txt",
           "/image/..%2fimages.txt", "/seg/..%2f..%2fbboxes", "/other", "/api/nope"]


def _serve(make, root):
    srv = make(images_list=str(root / "images.txt"), images_root=str(root / "images"),
               segmentations_dir=str(root / "segs"), bbox_file=str(root / "bboxes.pth"),
               eigs_dir=str(root / "eigs"), port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, "", b""


def test_vis_server_matches_jax(vis_tree):
    """Every path of `tests/test_vis_server.py`: the same status, content
    type and body as the JAX server's; unknown ids and traversal attempts
    404."""
    servers = [_serve(make, vis_tree) for make in (j_make_vis_server, t_make_vis_server)]
    try:
        for path in PATHS + MISSING:
            (j_status, j_type, j_body), (t_status, t_type, t_body) = (
                _get(url + path) for _, url in servers)
            assert (t_status, t_type, t_body) == (j_status, j_type, j_body), path
            assert t_status == (404 if path in MISSING else 200), path
        items = json.loads(_get(servers[1][1] + "/api/index")[2])["items"]
        assert [it["id"] for it in items] == ["b", "a"]
        import io
        rgba = np.asarray(Image.open(io.BytesIO(_get(servers[1][1] + "/seg/b")[2])))
        assert tuple(rgba[0, 0, :3]) == tuple(PALETTE[1])  # {0, 255} read as {0, 1}
    finally:
        for srv, _ in servers:
            srv.shutdown()
            srv.server_close()


def test_vis_segmentations_matches_jax(tmp_path, vis_tree):
    """Stage 10 (with boxes and without) writes the JAX stage's bytes: the
    gallery PNGs and index.html."""
    for box in (True, False):
        kw = dict(images_list=str(vis_tree / "images.txt"),
                  images_root=str(vis_tree / "images"),
                  segmentations_dir=str(vis_tree / "segs"),
                  bbox_file=str(vis_tree / "bboxes.pth") if box else None)
        j_stages.vis_segmentations(output_dir=str(tmp_path / f"j{box}"), **kw)
        t_stages.vis_segmentations(output_dir=str(tmp_path / f"t{box}"), **kw)
        j_files = sorted((tmp_path / f"j{box}").iterdir())
        assert [f.name for f in j_files] == ["a.png", "b.png", "index.html"]
        for f in j_files:
            assert (tmp_path / f"t{box}" / f.name).read_bytes() == f.read_bytes(), f.name


def test_pipeline_cli_lists_every_jax_stage():
    from deep_spectral_tpu.pipeline import cli as j_cli
    assert t_cli.STAGES == j_cli.STAGES
    for name in t_cli.STAGES:
        assert callable(getattr(t_stages, name))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
