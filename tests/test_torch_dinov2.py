"""The port's DINOv2 family (`models/vit.py`: registers, LayerScale, the fused
SwiGLU FFN, antialiased per-image positional embeddings) against the plain
reference `benchmark/reference/dinov2.py` (the JAX package has no DINOv2),
on seeded random weights of the tiny sibling `test_dinov2_tiny` drawn as
the benchmark draws them; the DINOv2 names through `load_model`; stage 1
(`extract_features`) and the benchmark's driver on the CPU; and the DINO v1
blocks' ops held to the golden record made before the family was added.

Tolerances are `tests/test_torch_vit.py`'s, for its reasons: f32 keys
agree to 1e-4 absolute on O(1) features (both sides true f32; only the
summation order differs); bf16 keys by per-token cosine >= 0.99 (bf16
rounds at other places than the f32 reference, ~3 significant digits an op).
"""
import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import harness, weights
from benchmark.drivers.extract_dinov2 import dinov2_shapes
from benchmark.reference import dinov2 as ref_dinov2
from benchmark.reference.vit import Numerics, normalize_uint8
from deep_spectral_tpu_torch.models import convert as t_convert
from deep_spectral_tpu_torch.models.vit import (VisionTransformer, extract_patch_keys,
                                                get_model_config, swiglu_hidden)
from deep_spectral_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
NAME = "test_dinov2_tiny"
P, R = 14, 4


def _cfg_dict(name=NAME) -> dict:
    """The benchmark's configuration keys of a port config."""
    c = get_model_config(name)
    return {"name": name, "patch_size": c.patch_size, "embed_dim": c.embed_dim,
            "depth": c.depth, "num_heads": c.num_heads, "mlp_ratio": c.mlp_ratio,
            "img_size": c.img_size, "num_register_tokens": c.num_registers,
            "ffn_layer": c.ffn}


def _weights(seed=5) -> dict:
    return weights.seeded_weights(dinov2_shapes(_cfg_dict()), seed, "cpu")


def _model(dtype=torch.float32, seed=5):
    model = VisionTransformer(get_model_config(NAME), dtype).eval()
    model.load_state_dict(_weights(seed))
    return model


def _image(hp, wp, seed):
    return torch.randn((hp * P, wp * P, 3), generator=torch.Generator().manual_seed(seed))


def _reference(images, seed=5, registers=True):
    return ref_dinov2.patch_keys(_weights(seed), _cfg_dict(), images,
                                 Numerics(torch.float32), registers)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_swiglu_width_rule_and_published_names():
    """4096 at width 1536; the full model's state dict holds DINOv2's names
    and shapes, 1.137B parameters (built on the meta device)."""
    assert swiglu_hidden(1536, 4.0) == ref_dinov2.swiglu_hidden(1536, 4.0) == 4096
    assert swiglu_hidden(128, 4.0) == 344
    cfg = json.loads((REPO / "benchmark/configs/dinov2_vitg14_reg.json").read_text())
    with torch.device("meta"):
        model = VisionTransformer(get_model_config("dinov2_vitg14_reg"), torch.bfloat16)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: s for k, (s, _) in dinov2_shapes(cfg).items()}
    assert shapes["blocks.39.mlp.w12.weight"] == (8192, 1536)
    assert shapes["blocks.39.mlp.w3.weight"] == (1536, 4096)
    assert shapes["register_tokens"] == (1, 4, 1536) and shapes["mask_token"] == (1, 1536)
    assert shapes["pos_embed"] == (1, 1 + 37 * 37, 1536)
    assert sum(math.prod(s) for s in shapes.values()) == cfg["parameters"]


@pytest.mark.parametrize("grid", [(5, 5), (4, 6), (6, 7)])
def test_f32_keys_match_the_reference(grid):
    """At the stored grid (no resample), down and up: extract_patch_keys and
    the forward's keys after the 1 + R prefix rows both match."""
    model = _model()
    x = _image(*grid, seed=1)
    ref = _reference([x])[0]
    got = extract_patch_keys(model, x[None])[0]
    assert got.shape == (grid[0] * grid[1], 128)
    assert (got - ref).abs().max().item() <= 1e-4
    with torch.no_grad():
        full = model(x[None])["qkv"]["k"][0]
    assert full.shape[0] == 1 + R + grid[0] * grid[1]
    assert (full[1 + R:] - ref).abs().max().item() <= 1e-4


def test_bf16_close_to_the_reference():
    model = _model(torch.bfloat16)
    x = _image(4, 6, seed=2)
    got = extract_patch_keys(model, x[None])[0].float()
    ref = _reference([x])[0]
    assert extract_patch_keys(model, x[None]).dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    assert cos.min().item() >= 0.99


def _counted(fn):
    """fn's result and the counters it added."""
    before = profiling.totals()
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in profiling.totals().items()
                 if v != before.get(k, 0)}


def test_bucket_padded_batch_gives_each_image_its_own_keys():
    """Two images of other grids (4x6, 5x3) padded into one 5x6 bucket,
    with garbage in the padding: given the token mask and the grids, each
    image's keys are its unpadded reference's, so each took its own grid's
    positional embeddings and the mask reached past the registers. The
    blocks ran compacted, on 5 + 24 tokens an image (the 5x3 image's tail
    masked), and every padded position of the output is exactly zero.
    Without the grids (the bucket's grid resampled) the keys are not the
    reference's."""
    model = _model()
    a, b = _image(4, 6, seed=3), _image(5, 3, seed=4)
    x = 50.0 * torch.randn((2, 5 * P, 6 * P, 3), generator=torch.Generator().manual_seed(9))
    x[0, :4 * P, :6 * P], x[1, :5 * P, :3 * P] = a, b
    mask = torch.zeros((2, 5, 6), dtype=torch.bool)
    mask[0, :4, :6] = True
    mask[1, :5, :3] = True
    grids = np.array([[4, 6], [5, 3]])
    got, counts = _counted(lambda: extract_patch_keys(model, x, token_mask=mask.reshape(2, -1),
                                                      grids=grids))
    assert counts == {"vit.compacted": 1, "vit.tokens": 2 * (R + 1 + 24),
                      "vit.tokens_valid": (R + 1 + 24) + (R + 1 + 15)}
    got = got.reshape(2, 5, 6, -1)
    assert torch.equal(got[~mask], torch.zeros_like(got[~mask]))
    refs = _reference([a, b])
    ka, kb = got[0, :4, :6].reshape(24, -1), got[1, :5, :3].reshape(15, -1)
    assert (ka - refs[0]).abs().max().item() <= 1e-4
    assert (kb - refs[1]).abs().max().item() <= 1e-4
    mask = mask.reshape(2, -1)
    stretched = extract_patch_keys(model, x, token_mask=mask).reshape(2, 5, 6, -1)
    assert (stretched[1, :5, :3].reshape(15, -1) - refs[1]).abs().max().item() > 1e-2
    with pytest.raises(ValueError, match="do not fit"):
        extract_patch_keys(model, x, token_mask=mask, grids=np.array([[6, 6], [5, 3]]))


def test_zero_patch_padding_row_gives_zeros():
    """A short batch's padding row (grid 0x0, as `pad_batch_images` makes
    it) beside a 3x4 image in a 4x4 bucket: the batch runs compacted on
    5 + 12 tokens an image, the padding row keeps only its prefix, its
    output is all zeros, and the image's keys are its reference's."""
    model = _model()
    a = _image(3, 4, seed=7)
    x = torch.zeros((2, 4 * P, 4 * P, 3))
    x[0, :3 * P] = a
    mask = torch.zeros((2, 4, 4), dtype=torch.bool)
    mask[0, :3] = True
    got, counts = _counted(lambda: extract_patch_keys(
        model, x, token_mask=mask.reshape(2, -1), grids=np.array([[3, 4], [0, 0]])))
    assert counts == {"vit.compacted": 1, "vit.tokens": 2 * (R + 1 + 12),
                      "vit.tokens_valid": R + 1 + 12}
    assert got.shape == (2, 16, 128)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.equal(got[0, 12:], torch.zeros_like(got[0, 12:]))
    assert (got[0, :12] - _reference([a])[0]).abs().max().item() <= 1e-4


def test_grids_that_fill_the_bucket_run_uncompacted():
    """Two 4x5 images in a 4x5 bucket: nothing to drop, so the blocks run on
    the bucket's T = 5 + 20 tokens, uncompacted, and each image's keys are
    its reference's."""
    model = _model()
    a, b = _image(4, 5, seed=8), _image(4, 5, seed=9)
    x = torch.stack([a, b])
    got, counts = _counted(lambda: extract_patch_keys(
        model, x, token_mask=torch.ones(2, 20, dtype=torch.bool),
        grids=np.array([[4, 5], [4, 5]])))
    assert counts == {"vit.tokens": 2 * (R + 1 + 20), "vit.tokens_valid": 2 * (R + 1 + 20)}
    for k, ref in zip(got, _reference([a, b])):
        assert (k - ref).abs().max().item() <= 1e-4


def test_register_rows_are_absent_from_the_features():
    """Stage 1's features are the rows after CLS and the 4 registers: they
    are the forward's keys from row 5 on, not from row 1, and a reference
    without registers gives other keys."""
    model = _model()
    x = _image(4, 4, seed=6)[None]
    k = extract_patch_keys(model, x)
    with torch.no_grad():
        full = model(x)["qkv"]["k"]
    assert k.shape[1] == 16 and full.shape[1] == 21
    assert torch.equal(k, full[:, 5:])
    assert not torch.allclose(k, full[:, 1:17])
    no_reg = _reference([x[0]], registers=False)[0]
    assert (k[0] - no_reg).abs().max().item() > 1e-2


def test_dinov2_state_dict_round_trips_through_load_model(tmp_path, monkeypatch):
    """A DINOv2-named state dict (register_tokens, mask_token, ls1.gamma,
    mlp.w12 ...) saved as `<name>.pth`, or under the published file name,
    loads strictly through load_model; without a file the seeded init puts
    LayerScale at 1 and the mask token at 0."""
    sd = _weights(seed=7)
    assert {"register_tokens", "mask_token", "blocks.0.ls1.gamma", "blocks.1.ls2.gamma",
            "blocks.0.mlp.w12.weight", "blocks.0.mlp.w3.bias"} <= set(sd)
    torch.save(sd, tmp_path / f"{NAME}.pth")
    got = t_convert.load_model(NAME, ckpt_dir=str(tmp_path), device="cpu").state_dict()
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    published = tmp_path / "published"
    published.mkdir()
    torch.save(sd, published / "dinov2_tiny_reg4_pretrain.pth")
    monkeypatch.setitem(t_convert.CHECKPOINT_FILES, NAME, "dinov2_tiny_reg4_pretrain.pth")
    assert t_convert.find_local_checkpoint(NAME, str(published)) == \
        published / "dinov2_tiny_reg4_pretrain.pth"
    got = t_convert.load_model(NAME, ckpt_dir=str(published), device="cpu")
    assert torch.equal(got.blocks[1].ls2.gamma, sd["blocks.1.ls2.gamma"])
    assert t_convert.CHECKPOINT_FILES["dinov2_vitg14_reg"] == "dinov2_vitg14_reg4_pretrain.pth"
    init = t_convert.load_model(NAME, seed=3, device="cpu")
    assert torch.equal(init.blocks[0].ls1.gamma, torch.ones(128))
    assert torch.equal(init.mask_token, torch.zeros(1, 128))
    assert init.register_tokens.abs().min() > 0


def test_extract_features_runs_test_dinov2_tiny_on_the_cpu(tmp_path):
    """`extract_features --model_name test_dinov2_tiny`: two images of other
    sizes in one bucket; each saved feature is its floor-cropped image's
    reference keys (h * w rows: no register row), in fp32."""
    from PIL import Image

    from deep_spectral_tpu_torch.pipeline import extract as t_stages
    rng = np.random.default_rng(0)
    sizes = {"a.png": (60, 90), "b.png": (75, 50)}
    (tmp_path / "images").mkdir()
    for name, (h, w) in sizes.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / "images" / name)
    (tmp_path / "images.txt").write_text("\n".join(sizes))
    t_stages.extract_features(images_list=str(tmp_path / "images.txt"),
                              images_root=str(tmp_path / "images"), model_name=NAME,
                              batch_size=2, output_dir=str(tmp_path / "feats"),
                              precision="fp32", device="cpu")
    sd = t_convert.load_model(NAME, device="cpu").state_dict()
    for name, (h, w) in sizes.items():
        out = torch.load(tmp_path / "feats" / f"{Path(name).stem}.pth", weights_only=False)
        hp, wp = h // P, w // P
        assert out["k"].shape == (1, hp * wp, 128) and out["patch_size"] == P
        img = np.asarray(Image.open(tmp_path / "images" / name))[:hp * P, :wp * P]
        x = normalize_uint8(torch.from_numpy(img.copy()))
        ref = ref_dinov2.patch_keys(sd, _cfg_dict(), [x], Numerics(torch.float32))[0]
        got = torch.as_tensor(np.asarray(out["k"], np.float32))[0]
        assert (got - ref).abs().max().item() <= 1e-2   # fp16 files of O(1) keys


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dino_v1_blocks_run_the_same_ops(dtype):
    """test_vit_tiny's stage 1 and forward, masked, dispatch the very ops
    (in order) recorded before the DINOv2 family was added
    (`tests/golden/vit_tiny_ops.json`): no LayerScale, no extra op."""
    golden = json.loads((REPO / "tests/golden/vit_tiny_ops.json").read_text())
    model = t_convert.random_init_(VisionTransformer(get_model_config("test_vit_tiny"), dtype),
                                   0).eval()
    x = torch.randn(2, 32, 40, 3, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(2, 20, dtype=torch.bool)
    mask[1, -5:] = False
    with _Ops() as rec:
        extract_patch_keys(model, x, token_mask=mask)
    assert rec.ops == golden[f"extract_{dtype}"]
    with _Ops() as rec, torch.no_grad():
        model(x, token_mask=mask)
    assert rec.ops == golden[f"forward_{dtype}"]
    with _Ops() as rec:
        extract_patch_keys(model, x, token_mask=mask, grids=np.array([[4, 5], [3, 5]]))
    assert rec.ops == golden[f"extract_{dtype}"]      # DINO v1 reads no grids


@pytest.fixture(scope="module")
def tiny_checkout(tmp_path_factory) -> Path:
    """A copy of the benchmark with a tiny cell of the `extract_dinov2`
    driver added by files alone, under the full-size cell's limits."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    bench = root / "benchmark"
    (bench / "configs" / f"{NAME}.json").write_text(json.dumps(_cfg_dict()))
    traffic = json.loads((bench / "traffic" / "voc480_dinov2.json").read_text())
    traffic.update(image_hw=[200, 200], batch_size=4, eig_batch_size=2, pool_batches=2,
                   warm_batches=2)
    (bench / "traffic" / "tiny_dinov2.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits" / "dinov2g14-extract-voc480.json",
                bench / "limits" / "tiny-dinov2.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": NAME, "source": "tests", "reduced": [], "why": "tests",
                            "file": f"benchmark/configs/{NAME}.json"})
    spec["workloads"].append({"name": "tiny-dinov2", "config": NAME, "traffic": "tiny_dinov2",
                              "chips": 1, "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_benchmark_driver_runs_a_tiny_cell_on_the_cpu(tiny_checkout):
    """The `extract_dinov2` driver's set-up, window and check on the CPU:
    200x200 images cropped to 196x196 (14x14 patches) in a 16x16 bucket, each
    image handed its grid; the run is correct, its f32 keys agree with the
    reference to f32 rounding, and the register-less reference is far
    further from the whole one."""
    cell = harness.find_cell("tiny-dinov2", tiny_checkout)
    driver = harness.driver(cell, tiny_checkout)
    runner = driver.Runner(cell, 2**31 + 11, torch.device("cpu"))
    assert runner.grids1.tolist() == [[14, 14]] * 4 and runner.buckets[0] == (16, 16)
    out = runner.window(0.5)
    runner.release()
    correct, checks = runner.check()
    assert out["attempted"] > 0 and out["failed"] == 0
    assert correct, checks
    whole = runner.reference_keys()
    from benchmark import checks as bench_checks
    no_reg = runner.reference_keys(registers=False)
    assert bench_checks.keys_gap(no_reg[:2], whole[:2]) > 100 * checks["keys_f32_rel_err"]["value"]
    assert checks["keys_f32_rel_err"]["value"] <= 1e-5
