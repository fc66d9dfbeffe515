"""The port's SAM family (`models/vit.py`, `models/relpos.py`: no prefix
token, a positional embedding added once, windowed attention over zero-
padded windows whose padded tokens stay keys, SAM's decomposed relative-
position bias, global blocks, exact GELU, the conv neck; SAM's preprocess)
against the plain reference `benchmark/reference/sam.py` (the JAX package
has no SAM), on seeded random weights of the tiny sibling `test_sam_tiny`
(width 160, 2 heads of 80, 3 blocks: windows of 3 over a 20x20 grid, so
padded to 21x21, block 1 global) drawn as the benchmark draws them (rel-pos
tables included, N(0, 0.5^2) here so that the bias moves the tiny model's
logits as far as the full configuration's 0.08 moves its 80-wide heads);
SAM's names through `load_model`; the full model's published shapes; the
CLI's stages 1-2; and the benchmark's driver on a tiny cell on the CPU.

Tolerances: f32 keys and the neck agree to 1e-4 absolute on O(1) values
(both sides true f32; only the summation order differs: read ~4e-6); a
fault must move them by over 1e-2, a hundred times that. bf16 keys by
per-token cosine >= 0.99, as the other families'.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import checks, harness
from benchmark.drivers.eigs import image_grids
from benchmark.drivers.extract_sam import (port_config, resized_grid, sam_shapes,
                                           seeded_weights, stage1_plan)
from benchmark.drivers.extract_dinov3 import build_vit
from benchmark.reference import sam as ref_sam
from benchmark.reference.vit import Numerics
from deep_spectral_tpu_torch.models import convert as t_convert
from deep_spectral_tpu_torch.models.flash_attention import (flash_attention_packed,
                                                            flash_attention_packed_plain)
from deep_spectral_tpu_torch.models.relpos import (gathered_rel_pos, rel_tables,
                                                   sam_preprocess, sam_resized_size,
                                                   window_partition, window_unpartition)
from deep_spectral_tpu_torch.models.vit import (VisionTransformer, extract_patch_keys,
                                                get_model_config)
from deep_spectral_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
NAME = "test_sam_tiny"
P, D, G, L = 16, 160, 20, 320
SIZES = [(60, 90), (100, 40)]          # resized 213x320 and 320x128: grids 13x20 and 20x8
GRIDS = [(13, 20), (20, 8)]


def _cfg_dict(name=NAME) -> dict:
    """The benchmark's configuration keys of a port config."""
    c = get_model_config(name)
    return {"name": name, "patch_size": c.patch_size, "img_size": c.img_size,
            "embed_dim": c.embed_dim, "depth": c.depth, "num_heads": c.num_heads,
            "mlp_dim": int(c.embed_dim * c.mlp_ratio), "window_size": c.window_size,
            "global_attn_indexes": list(c.global_blocks), "layer_norm_eps": c.norm_eps,
            "rel_pos_sigma": 0.5}


def _weights(seed=5) -> dict:
    return seeded_weights(_cfg_dict(), seed, "cpu")


def _model(dtype=torch.float32, seed=5, impl="auto"):
    return build_vit(port_config(_cfg_dict()), _weights(seed), "cpu", dtype, impl)


def _images(seed=1) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8) for h, w in SIZES]


def _inputs(images) -> torch.Tensor:
    x = torch.zeros((len(images), 100, 90, 3), dtype=torch.uint8)  # the batch's largest
    for i, im in enumerate(images):
        x[i, :im.shape[0], :im.shape[1]] = im
    return sam_preprocess(x, np.array([im.shape[:2] for im in images]), L)


def _crop(k) -> list:
    return [ki.float().reshape(G, G, -1)[:gh, :gw].reshape(gh * gw, -1)
            for ki, (gh, gw) in zip(k, GRIDS)]


def _reference(images, seed=5, which_block=-1, **faults):
    return ref_sam.patch_keys(_weights(seed), _cfg_dict(), images, Numerics(torch.float32),
                              which_block=which_block, **faults)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_published_widths_names_and_parameter_count():
    """sam_vit_h (built on the meta device) holds SAM's image encoder's
    names and shapes at its published widths: 16 heads of 80, MLP 5120, a
    (1, 64, 64, 1280) positional embedding, rel-pos tables of (27, 80) in
    window blocks and (127, 80) in blocks 7, 15, 23 and 31, no CLS, the
    neck; 637,026,048 parameters, as the configuration file states."""
    cfg = json.loads((REPO / "benchmark/configs/sam_vit_h.json").read_text())
    with torch.device("meta"):
        model = VisionTransformer(port_config(cfg), torch.bfloat16)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: s for k, (s, _) in sam_shapes(cfg).items()}
    assert shapes["pos_embed"] == (1, 64, 64, 1280)
    assert shapes["blocks.0.attn.rel_pos_h"] == (27, 80)
    assert all(shapes[f"blocks.{i}.attn.rel_pos_w"] == (127, 80) for i in (7, 15, 23, 31))
    assert shapes["blocks.31.mlp.lin1.weight"] == (5120, 1280)
    assert shapes["neck.2.weight"] == (256, 256, 3, 3) and "cls_token" not in shapes
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"] == 637026048
    assert [b.window for b in model.blocks].count(0) == 4
    assert model.cfg.num_prefix == 0 and model.blocks[0].norm1.eps == 1e-6


def test_preprocess_resizes_normalizes_and_pads():
    """SAM's preprocess: longer side to 1024 at int(s * 1024 / max + 0.5),
    bilinear (align_corners False) in f32, SAM's mean and std, zeros after
    normalization at the bottom and right; a padding row stays zero; the
    reference's own preprocess agrees."""
    assert sam_resized_size(480, 640, 1024) == (768, 1024)
    assert sam_resized_size(427, 640, 1024) == (683, 1024) == ref_sam.resized_size(427, 640, 1024)
    assert sam_resized_size(640, 640, 1024) == (1024, 1024)
    images = _images()
    x = torch.zeros((3, 100, 90, 3), dtype=torch.uint8)
    for i, im in enumerate(images):
        x[i, :im.shape[0], :im.shape[1]] = im
    out = sam_preprocess(x, np.array(SIZES + [(0, 0)]), L)
    assert out.shape == (3, L, L, 3)
    for i, im in enumerate(images):
        want = ref_sam.preprocess(im, L)[0].permute(1, 2, 0)
        assert (out[i] - want).abs().max().item() <= 1e-5
        hr, wr = sam_resized_size(*im.shape[:2], L)
        assert out[i, hr:].abs().sum() == 0 and out[i, :, wr:].abs().sum() == 0
    assert out[2].abs().max() == 0


def test_windows_round_trip_and_tables_follow_the_formula():
    """window_partition cuts an 8x8 grid padded to 9x9 into 9 windows of 3x3
    in row-major order, the padded tokens zero; unpartition crops back. The
    tables are rel_h[q, y'] = q . rel_pos_h[y_q - y' + s - 1] and rel_w
    likewise over columns, of the unscaled q, as (B, H, T, s) views."""
    u = torch.randn((2, 8 * 8, 4))
    w = window_partition(u, 8, 3)
    assert w.shape == (18, 9, 4)
    grid = torch.nn.functional.pad(u.reshape(2, 8, 8, 4), (0, 0, 0, 1, 0, 1))
    assert torch.equal(w[4].reshape(3, 3, 4), grid[0, 3:6, 3:6])
    assert torch.equal(w[17].reshape(3, 3, 4), grid[1, 6:9, 6:9])
    assert w[8].reshape(3, 3, 4)[2].abs().max() == 0
    assert torch.equal(window_unpartition(w, 2, 8, 3), u)
    g = torch.Generator().manual_seed(0)
    s, C = 4, 80
    rh, rw = torch.randn((2 * s - 1, C), generator=g), torch.randn((2 * s - 1, C), generator=g)
    q = torch.randn((2, s * s, 3, C), generator=g)
    rel_h, rel_w = rel_tables(q, gathered_rel_pos(rh, rw, q.dtype))
    assert rel_h.shape == rel_w.shape == (2, 3, s * s, s) and rel_h.stride(-1) == 1
    for t in (0, 5, 15):
        y, x = divmod(t, s)
        for k in range(s):
            want_h = (q[1, t, 2] * rh[y - k + s - 1]).sum()
            want_w = (q[1, t, 2] * rw[x - k + s - 1]).sum()
            assert abs(rel_h[1, 2, t, k] - want_h) <= 1e-4
            assert abs(rel_w[1, 2, t, k] - want_w) <= 1e-4


def test_kernel_twin_adds_the_decomposed_bias():
    """On CPU tensors kernel 1 is its twin: softmax(q k^T / sqrt(80) +
    rel_h[q, k // S] + rel_w[q, k % S]) v, the same as the einsum route."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((2, 12, 2, 80), generator=g) for _ in range(3))
    rel = tuple(torch.randn((2, 2, 12, n), generator=g) for n in (3, 4))
    out = flash_attention_packed(q, k, v, rel_pos=rel)
    assert torch.equal(out, flash_attention_packed_plain(q, k, v, rel_pos=rel))
    s = torch.einsum("bthd,bshd->bhts", q, k) / 80 ** 0.5
    key = torch.arange(12)
    s = s + rel[0][..., key // 4] + rel[1][..., key % 4]
    want = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    assert (out - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("which_block", [-1, 1])
def test_f32_keys_match_the_reference(impl, which_block):
    """extract_patch_keys on a batch of two images of other aspects, on the
    'einsum' route and the kernel's twin ('flash' on the CPU), equals the
    reference's keys of each image alone: of block 2 (a window block, the
    last) and of block 1 (the global block), cropped to each image's
    resized grid."""
    model = _model(impl=impl)
    images = _images()
    got = _crop(extract_patch_keys(model, _inputs(images), which_block=which_block))
    ref = _reference(images, which_block=which_block)
    for a, b in zip(got, ref, strict=True):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.parametrize("fault", [{"rel": False}, {"mask_pad": True}, {"scaled_rel": True}])
def test_each_fault_fails_the_tolerance(fault):
    """The reference without the rel-pos bias, with the padded window tokens
    masked as keys, or with the rel terms built from the scaled q, moves
    each image's keys by over 1e-2, a hundred times the tolerance."""
    images = _images()
    got = _crop(extract_patch_keys(_model(), _inputs(images)))
    for a, b in zip(got, _reference(images, **fault), strict=True):
        assert (a - b).abs().max().item() > 1e-2


def test_neck_matches_the_reference():
    """The forward's output, the conv neck (B, 256, 20, 20), equals the
    reference's for each image; the last block's tokens feed it."""
    model = _model()
    images = _images()
    with torch.no_grad():
        out = model(_inputs(images))
    assert out["neck"].shape == (2, 256, G, G) and out["tokens"].shape == (2, G * G, D)
    for i, im in enumerate(images):
        ref = ref_sam.neck(_weights(), _cfg_dict(), im, Numerics(torch.float32))
        assert (out["neck"][i:i + 1] - ref).abs().max().item() <= 1e-4


def test_bf16_close_to_the_reference_and_spans_counted():
    """bf16 keys by per-token cosine >= 0.99; the window block before the
    keys' block counts its 2 x 49 windows' 9 rows and the 2 x 400 grid rows
    among them; the global block counts none."""
    model = _model(torch.bfloat16)
    images = _images()
    before = profiling.totals()
    k = extract_patch_keys(model, _inputs(images))
    counts = {n: v - before.get(n, 0) for n, v in profiling.totals().items()
              if v != before.get(n, 0)}
    assert k.dtype == torch.bfloat16
    assert counts == {"vit.window_rows": 2 * 49 * 9, "vit.window_rows_valid": 2 * 400,
                      "vit.tokens": 2 * 400}
    for a, b in zip(_crop(k), _reference(images), strict=True):
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        assert cos.min().item() >= 0.99


def test_sam_checkpoint_loads_through_load_model(tmp_path):
    """A state dict under SAM's checkpoint names (`image_encoder.` entries
    beside the prompt encoder's and the mask decoder's) saved under the
    published file name loads strictly through load_model as the encoder;
    without a file the seeded init leaves the rel-pos tables at SAM's 0."""
    sd = _weights(seed=7)
    published = {f"image_encoder.{k}": v for k, v in sd.items()}
    published["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = torch.ones(2, 128)
    published["mask_decoder.iou_token.weight"] = torch.ones(1, 256)
    assert {"image_encoder.blocks.0.attn.rel_pos_h", "image_encoder.blocks.2.mlp.lin1.weight",
            "image_encoder.neck.3.bias", "image_encoder.pos_embed"} <= set(published)
    torch.save(published, tmp_path / f"{NAME}_4b8939.pth")
    t_convert.CHECKPOINT_FILES[NAME] = f"{NAME}_4b8939.pth"
    try:
        got = t_convert.load_model(NAME, ckpt_dir=str(tmp_path), device="cpu").state_dict()
    finally:
        del t_convert.CHECKPOINT_FILES[NAME]
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    assert t_convert.CHECKPOINT_FILES["sam_vit_h"] == "sam_vit_h_4b8939.pth"
    init = t_convert.load_model(NAME, seed=3, device="cpu")
    assert init.blocks[1].attn.rel_pos_h.abs().max() == 0 and init.pos_embed.abs().min() > 0


def test_cli_runs_stages_1_and_2_on_sam(tmp_path):
    """`extract.py extract_features --model_name test_sam_tiny` then
    `extract_eigs` on two images of other aspects: each saved feature is its
    resized grid's reference keys (fp16 files of O(1) keys), `shape` is the
    resized size, and the eigenvectors cover that grid."""
    from PIL import Image

    from deep_spectral_tpu_torch.pipeline import cli
    images = _images()
    (tmp_path / "images").mkdir()
    names = ["a.png", "b.png"]
    for name, im in zip(names, images):
        Image.fromarray(im.numpy()).save(tmp_path / "images" / name)
    (tmp_path / "images.txt").write_text("\n".join(names))
    cli.main(["extract_features", "--images_list", str(tmp_path / "images.txt"),
              "--images_root", str(tmp_path / "images"), "--model_name", NAME,
              "--batch_size", "2", "--output_dir", str(tmp_path / "feats"),
              "--precision", "fp32", "--device", "cpu"])
    cli.main(["extract_eigs", "--images_root", str(tmp_path / "images"),
              "--features_dir", str(tmp_path / "feats"), "--output_dir", str(tmp_path / "eigs"),
              "--K", "3", "--device", "cpu"])
    sd = t_convert.load_model(NAME, device="cpu").state_dict()
    refs = ref_sam.patch_keys(sd, _cfg_dict(), images, Numerics(torch.float32))
    for name, (h, w), (gh, gw), ref in zip(names, SIZES, GRIDS, refs):
        out = torch.load(tmp_path / "feats" / f"{Path(name).stem}.pth", weights_only=False)
        assert out["k"].shape == (1, gh * gw, D) and out["patch_size"] == P
        assert tuple(out["shape"]) == (1, 3, *sam_resized_size(h, w, L))
        got = torch.as_tensor(np.asarray(out["k"], np.float32))[0]
        assert (got - ref).abs().max().item() <= 1e-2
        eigs = torch.load(tmp_path / "eigs" / f"{Path(name).stem}.pth", weights_only=False)
        assert eigs["eigenvectors"].shape == (3, gh * gw)


def test_cell_plan_fills_whole_batches_of_mixed_grids():
    """The cell's mix: 216 images at six aspects, longer side 640, resized
    to longer side 1024: grids (h, w) 48x64, 64x48, 42x64, 64x42, 64x64 and
    36x64 (N = 2304-4096); nine b24 stage-1 batches, each of three whole b8
    runs of one grid, grids mixed within some."""
    tr = json.loads((REPO / "benchmark/traffic/coco1024_sam.json").read_text())
    cfg = json.loads((REPO / "benchmark/configs/sam_vit_h.json").read_text())
    grids = [resized_grid(s, cfg) for s in image_grids(tr, 1)]
    assert sorted(set(grids)) == [(36, 64), (42, 64), (48, 64), (64, 42), (64, 48), (64, 64)]
    plan = stage1_plan(grids, np.random.default_rng(0).permutation(len(grids)), 24, 8)
    assert len(plan) == 9
    mixed = 0
    for _, runs in plan:
        assert len(runs) == 3 and all(len(r) == 8 for r in runs)
        assert all(len({grids[i] for i in r}) == 1 for r in runs)
        mixed += len({grids[r[0]] for r in runs}) > 1
    assert mixed >= 4
    n = [gh * gw for gh, gw in grids]
    assert (min(n), max(n)) == (2304, 4096)


@pytest.fixture(scope="module")
def tiny_checkout(tmp_path_factory) -> Path:
    """A copy of the benchmark with a tiny cell of the `extract_sam` driver
    added by files alone, under the full-size cell's limits: 80-px images
    at 4:3 and 3:2 (resized grids 15x20 and 13x20), b4 and b2."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    bench = root / "benchmark"
    (bench / "configs" / f"{NAME}.json").write_text(json.dumps(_cfg_dict()))
    traffic = json.loads((bench / "traffic" / "coco1024_sam.json").read_text())
    traffic.update(longer_side=80, aspects=[[[4, 3], 4], [[3, 2], 4]], batch_size=4,
                   eig_batch_size=2, warm_batches=2, trace_batches=2)
    (bench / "traffic" / "tiny_sam.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits" / "samvith-extract-coco1024.json",
                bench / "limits" / "tiny-sam.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": NAME, "source": "tests", "reduced": [], "why": "tests",
                            "file": f"benchmark/configs/{NAME}.json"})
    spec["workloads"].append({"name": "tiny-sam", "config": NAME, "traffic": "tiny_sam",
                              "chips": 1, "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_benchmark_driver_runs_a_tiny_cell_on_the_cpu(tiny_checkout):
    """The `extract_sam` driver's set-up, window, check and calibration rows
    on the CPU: two b4 batches, each of a 4:3 and a 3:2 run of two; the run
    is correct, its f32 keys agree with the reference to f32 rounding, each
    fault reads far from it, and the chebyshev solver ran."""
    from benchmark.drivers.extract_sam import calibration_rows
    cell = harness.find_cell("tiny-sam", tiny_checkout)
    driver = harness.driver(cell, tiny_checkout)
    runner = driver.Runner(cell, 2**31 + 11, torch.device("cpu"))
    assert len(runner.pool) == 2 and runner.pool[0].bucket1 == (20, 20)
    assert sorted(map(tuple, runner.pool[0].grids1.tolist())) == [(13, 20)] * 2 + [(15, 20)] * 2
    assert runner.s2.kw["solver"] == "chebyshev"
    out = runner.window(0.5)
    runner.release()
    correct, numbers = runner.check()
    assert out["attempted"] > 0 and out["failed"] == 0
    assert correct, numbers
    f32 = numbers["keys_f32_rel_err"]["value"]
    assert f32 <= 1e-5
    rows = {r["kind"]: r["numbers"] for r in calibration_rows(runner)}
    for kind in ("fault.no_relpos", "fault.padded_keys_masked", "fault.relpos_from_scaled_q"):
        assert rows[kind]["keys_f32_rel_err"] > 100 * f32, (kind, rows[kind])
    assert rows["fault.keys_altered"]["keys_rel_err"] > 0.09


@pytest.mark.parametrize("entry", ["build_stage", "pp_vit_forward", "sp_vit_forward",
                                   "sp_patch_features", "tp_sharded_patch_features"])
def test_parallel_vit_paths_refuse_sam(entry):
    """The sequence-, pipeline- and tensor-parallel ViT paths run DINO v1's
    rows and blocks: a SAM model raises before any collective, as DINOv2
    and DINOv3 do (without its windows, relative positions and prefix-free
    rows it would give wrong keys silently)."""
    from deep_spectral_tpu_torch.parallel import pp_vit, sharded, sp_vit
    cfg = get_model_config(NAME)
    model = VisionTransformer(cfg)
    images = torch.zeros((1, L, L, 3))
    calls = {"build_stage": lambda: pp_vit.build_stage(cfg, model.state_dict(), None),
             "pp_vit_forward": lambda: pp_vit.pp_vit_forward(None, model, images),
             "sp_vit_forward": lambda: sp_vit.sp_vit_forward(None, model, images),
             "sp_patch_features": lambda: sp_vit.sp_patch_features(None, model, images),
             "tp_sharded_patch_features":
                 lambda: sharded.tp_sharded_patch_features(None, model, images)}
    with pytest.raises(ValueError, match="DINO v1"):
        calls[entry]()


def test_bbox_features_refuse_sam(tmp_path):
    """Stage 6 embeds each box by the model's CLS token, which SAM lacks: it
    raises before loading the model."""
    from deep_spectral_tpu_torch.pipeline import extract as t_stages
    with pytest.raises(ValueError, match="CLS"):
        t_stages.extract_bbox_features(images_root=str(tmp_path), bbox_file=str(tmp_path / "b"),
                                       model_name=NAME, output_file=str(tmp_path / "o"),
                                       device="cpu")
