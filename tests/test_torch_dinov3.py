"""The port's DINOv3 family (`models/vit.py`: storage tokens, no positional
embedding, 2D axial RoPE on each image's own grid (`models/rope.py`), the
unfused SwiGLU FFN, LayerNorm eps 1e-5) against the plain reference
`benchmark/reference/dinov3.py` (the JAX package has no DINOv3), on seeded
random weights of the tiny sibling `test_dinov3_tiny` (width 256, 2 heads
of 128, 2 blocks, 4 storage tokens) drawn as the benchmark draws them; the
RoPE twin against DINOv3's formula; DINOv3's names through `load_model`;
the full model's published shapes; and the benchmark's driver on a tiny
cell on the CPU.

Tolerances are `tests/test_torch_dinov2.py`'s, for its reasons: f32 keys
agree to 1e-4 absolute on O(1) features (both sides true f32; only the
summation order differs); bf16 keys by per-token cosine >= 0.99. The RoPE
twin and the formula are the same f32 operations: equal bit for bit.
"""
import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import checks, harness
from benchmark.drivers.extract_dinov3 import (build_vit, dinov3_shapes, port_config,
                                              seeded_weights, stage1_plan)
from benchmark.drivers.eigs import image_grids
from benchmark.reference import dinov3 as ref_dinov3
from benchmark.reference.vit import Numerics
from deep_spectral_tpu_torch.models import convert as t_convert
from deep_spectral_tpu_torch.models.rope import (RopePlan, apply_rope_, apply_rope_plain_,
                                                 rope_periods)
from deep_spectral_tpu_torch.models.vit import (VisionTransformer, extract_patch_keys,
                                                get_model_config, swiglu_hidden)
from deep_spectral_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
NAME = "test_dinov3_tiny"
P, R, D = 16, 4, 256


def _cfg_dict(name=NAME) -> dict:
    """The benchmark's configuration keys of a port config."""
    c = get_model_config(name)
    return {"name": name, "patch_size": c.patch_size, "embed_dim": c.embed_dim,
            "depth": c.depth, "num_heads": c.num_heads, "ffn_ratio": c.mlp_ratio,
            "n_storage_tokens": c.num_registers, "ffn_layer": c.ffn,
            "layer_norm_eps": c.norm_eps, "pos_embed_rope_base": 100.0}


def _weights(seed=5) -> dict:
    return seeded_weights(_cfg_dict(), seed, "cpu")


def _model(dtype=torch.float32, seed=5):
    return build_vit(port_config(_cfg_dict()), _weights(seed), "cpu", dtype)


def _image(hp, wp, seed):
    return torch.randn((hp * P, wp * P, 3), generator=torch.Generator().manual_seed(seed))


def _reference(images, seed=5, **kw):
    return ref_dinov3.patch_keys(_weights(seed), _cfg_dict(), images, Numerics(torch.float32),
                                 **kw)


def _counted(fn):
    before = profiling.totals()
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in profiling.totals().items()
                 if v != before.get(k, 0)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_published_widths_names_and_parameter_count():
    """dinov3_vit7b16 (built on the meta device) holds DINOv3's names and
    shapes at its published widths: 32 heads of 128, SwiGLU hidden 8192 =
    4096 * 3 * 2/3 aligned to 64, no qkv bias, no positional embedding,
    6,716,035,072 parameters, as the configuration file states."""
    cfg = json.loads((REPO / "benchmark/configs/dinov3_vit7b16.json").read_text())
    assert swiglu_hidden(4096, 3.0, align=64) == ref_dinov3.swiglu_hidden(4096, 3.0) == 8192
    with torch.device("meta"):
        model = VisionTransformer(port_config(cfg), torch.bfloat16)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: s for k, (s, _) in dinov3_shapes(cfg).items()} | {
        "rope_embed.periods": (32,)}
    assert shapes["blocks.39.mlp.w1.weight"] == (8192, 4096)
    assert shapes["blocks.39.mlp.w3.weight"] == (4096, 8192)
    assert shapes["storage_tokens"] == (1, 4, 4096) and "pos_embed" not in shapes
    assert "blocks.0.attn.qkv.bias" not in shapes
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg["parameters"] == 6716035072
    assert model.blocks[0].norm1.eps == model.norm.eps == 1e-5


def test_rope_periods_and_twin_follow_the_formula():
    """The periods are 100^(f/32); the twin rotates each image's patch rows
    of q and k by c_y = 2(i + 0.5)/h - 1, c_x = 2(j + 0.5)/w - 1 (angles
    [2 pi c_y / p, 2 pi c_x / p] tiled twice) in f32, bit for bit the
    formula written out here, in a compacted batch (rows w_b apart) and in
    a bucket (rows w apart); prefix rows, v, padding rows and a zero-patch
    row keep their bits."""
    per = rope_periods(128, 100.0)
    assert torch.equal(per, 100.0 ** (torch.arange(32, dtype=torch.float32) / 32))
    g = torch.Generator().manual_seed(0)
    grids = np.array([[3, 4], [2, 5], [0, 0]])
    for compacted, (h, w) in ((True, (3, 5)), (False, (3, 5))):
        T = R + 1 + (15 if not compacted else 12)
        qkv = torch.randn((3, T, 3, 2, 128), generator=g)
        plan = RopePlan.make(per, grids, h, w, 3, R + 1, compacted)
        assert plan.rows == 12 + 10
        got = apply_rope_plain_(qkv.clone(), plan)
        want = qkv.clone()
        for b, (gh, gw) in enumerate(grids):
            stride = gw if compacted else w
            for i in range(gh):
                for j in range(gw):
                    t = R + 1 + i * stride + j
                    cy = 2.0 * ((torch.tensor(i + 0.5, dtype=torch.float32)) / gh) - 1
                    cx = 2.0 * ((torch.tensor(j + 0.5, dtype=torch.float32)) / gw) - 1
                    a = torch.cat([2 * math.pi * cy / per, 2 * math.pi * cx / per]).tile(2)
                    z = qkv[b, t, :2]
                    rot = torch.cat([-z[..., 64:], z[..., :64]], dim=-1)
                    want[b, t, :2] = z * torch.cos(a) + rot * torch.sin(a)
        assert torch.equal(got, want)
        assert torch.equal(got[:, :R + 1], qkv[:, :R + 1]) and torch.equal(got[:, :, 2],
                                                                           qkv[:, :, 2])
        assert torch.equal(got[2], qkv[2])
    with pytest.raises(ValueError, match="do not fit"):
        RopePlan.make(per, np.array([[4, 4]]), 3, 5, 1, R + 1, False)


def test_rope_twin_in_bf16_rounds_once():
    """bf16 q and k are rotated in f32 and rounded once: the bf16 twin is the
    f32 twin's result cast to bf16."""
    per = rope_periods(128, 100.0)
    qkv = torch.randn((2, 1 + 12, 3, 1, 128), generator=torch.Generator().manual_seed(1))
    plan = RopePlan.make(per, np.array([[3, 4], [2, 4]]), 3, 4, 2, 1, True)
    b16 = apply_rope_(qkv.to(torch.bfloat16), plan)
    f32 = apply_rope_(qkv.to(torch.bfloat16).float(), plan)
    assert torch.equal(b16, f32.to(torch.bfloat16))


@pytest.mark.parametrize("grid", [(4, 4), (3, 6), (5, 2)])
def test_f32_keys_match_the_reference(grid):
    """extract_patch_keys of one image equals the reference's keys (before
    the last block's RoPE) at square and oblong grids."""
    model = _model()
    x = _image(*grid, seed=1)
    got = extract_patch_keys(model, x[None])[0]
    assert got.shape == (grid[0] * grid[1], D)
    assert (got - _reference([x])[0]).abs().max().item() <= 1e-4


def test_bf16_close_to_the_reference():
    model = _model(torch.bfloat16)
    x = _image(3, 5, seed=2)
    got = extract_patch_keys(model, x[None])
    assert got.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(got[0].float(), _reference([x])[0], dim=-1)
    assert cos.min().item() >= 0.99


def test_ragged_batch_gives_each_image_its_own_keys():
    """A 4x6 and a 5x3 image padded into one 5x6 bucket, garbage in the
    padding: given the mask and the grids, the blocks run compacted (5 + 24
    tokens an image), each image's RoPE takes its own grid, and each
    image's keys are its unpadded reference's; padded positions are zero.
    RoPE opens one span a block before the last and counts its q and k
    patch rows. Over the bucket's grid (the fault the benchmark plants) the
    5x3 image's keys move off the reference, and without RoPE as well."""
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
                      "vit.tokens_valid": (R + 1 + 24) + (R + 1 + 15),
                      "vit.rope_rows": 2 * (24 + 15)}
    got = got.reshape(2, 5, 6, -1)
    assert torch.equal(got[~mask], torch.zeros_like(got[~mask]))
    refs = _reference([a, b])
    ka, kb = got[0, :4, :6].reshape(24, -1), got[1, :5, :3].reshape(15, -1)
    assert (ka - refs[0]).abs().max().item() <= 1e-4
    assert (kb - refs[1]).abs().max().item() <= 1e-4
    bucket = _reference([b], rope_grids=[(5, 6)])[0]
    assert checks.keys_gap([bucket], [refs[1]]) > 100 * checks.keys_gap([kb], [refs[1]])
    assert (_reference([b], rope="none")[0] - refs[1]).abs().max().item() > 1e-2


@pytest.mark.parametrize("grids", [[[5, 6], [5, 3]], [[4, 6], [0, 0]]])
def test_keys_do_not_depend_on_the_padding(grids):
    """An image's keys are the same bits whatever it is batched with: run
    alone unpadded, beside a shorter image (uncompacted: the first fills the
    bucket, so RoPE reads rows w apart) or beside a padding row (compacted).
    Its keys do not depend on the padding, which is left as garbage."""
    model = _model()
    gh, gw = grids[0]
    a = _image(gh, gw, seed=11)
    alone = extract_patch_keys(model, a[None])[0]
    x = 30.0 * torch.randn((2, 5 * P, 6 * P, 3), generator=torch.Generator().manual_seed(2))
    x[0, :gh * P, :gw * P] = a
    mask = torch.zeros((2, 5, 6), dtype=torch.bool)
    for i, (h, w) in enumerate(grids):
        mask[i, :h, :w] = True
    got = extract_patch_keys(model, x, token_mask=mask.reshape(2, -1), grids=np.array(grids))
    got = got.reshape(2, 5, 6, -1)[0, :gh, :gw].reshape(gh * gw, -1)
    assert (got - alone).abs().max().item() <= 1e-5


def test_storage_rows_are_absent_from_the_features():
    """Stage 1's features are the 16 rows after CLS and the 4 storage
    tokens, before the last block's RoPE: the forward's keys of that block
    (21 rows, the attention's operands) are after it and differ; a
    reference without storage tokens gives other keys."""
    model = _model()
    x = _image(4, 4, seed=6)[None]
    k = extract_patch_keys(model, x)
    with torch.no_grad():
        full = model(x)["qkv"]["k"]
    assert k.shape[1] == 16 and full.shape[1] == 21
    assert not torch.allclose(k, full[:, 5:])
    no_storage = _reference([x[0]], storage=False)[0]
    assert (k[0] - no_storage).abs().max().item() > 1e-2


def test_dinov3_state_dict_loads_through_load_model(tmp_path):
    """A state dict under DINOv3's names (storage_tokens, mask_token,
    rope_embed.periods, ls1.gamma, mlp.w1/w2/w3; no qkv bias), with the
    training-only local_cls_norm the published file holds, saved under the
    published file name loads strictly through load_model; without a file
    the seeded init puts LayerScale at the hub's 1e-5."""
    sd = _weights(seed=7)
    assert {"storage_tokens", "mask_token", "rope_embed.periods", "blocks.0.ls1.gamma",
            "blocks.1.mlp.w1.weight", "blocks.1.mlp.w2.bias", "blocks.0.mlp.w3.bias"} <= set(sd)
    published = dict(sd, **{"local_cls_norm.weight": torch.ones(D),
                            "local_cls_norm.bias": torch.zeros(D)})
    torch.save(published, tmp_path / f"{NAME}_pretrain_lvd1689m-0123abcd.pth")
    t_convert.CHECKPOINT_FILES[NAME] = f"{NAME}_pretrain_lvd1689m*.pth"
    try:
        got = t_convert.load_model(NAME, ckpt_dir=str(tmp_path), device="cpu").state_dict()
    finally:
        del t_convert.CHECKPOINT_FILES[NAME]
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    assert "dinov3_vit7b16_pretrain_lvd1689m" in t_convert.CHECKPOINT_FILES["dinov3_vit7b16"]
    init = t_convert.load_model(NAME, seed=3, device="cpu")
    assert torch.equal(init.blocks[0].ls1.gamma, torch.full((D,), 1e-5))
    assert init.storage_tokens.abs().min() > 0 and torch.equal(init.mask_token,
                                                               torch.zeros(1, D))
    assert torch.equal(init.rope_embed.periods, rope_periods(128, 100.0))


def test_extract_features_runs_test_dinov3_tiny_on_the_cpu(tmp_path):
    """`extract_features --model_name test_dinov3_tiny`: two images of other
    sizes in one bucket; each saved feature is its floor-cropped image's
    reference keys, fp16 files of O(1) keys."""
    from PIL import Image

    from deep_spectral_tpu_torch.pipeline import extract as t_stages
    from benchmark.reference.vit import normalize_uint8
    rng = np.random.default_rng(0)
    sizes = {"a.png": (70, 100), "b.png": (90, 50)}
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
        assert out["k"].shape == (1, hp * wp, D) and out["patch_size"] == P
        img = np.asarray(Image.open(tmp_path / "images" / name))[:hp * P, :wp * P]
        x = normalize_uint8(torch.from_numpy(img.copy()))
        ref = ref_dinov3.patch_keys(sd, _cfg_dict(), [x], Numerics(torch.float32))[0]
        got = torch.as_tensor(np.asarray(out["k"], np.float32))[0]
        assert (got - ref).abs().max().item() <= 1e-2


def test_cell_plan_fills_whole_batches_of_mixed_grids():
    """The cell's mix: 216 images at six aspects, longer side 640, floor-
    cropped grids (h, w) 30x40, 40x30, 26x40, 40x26, 40x40, 22x40; nine b24
    stage-1 batches in four buckets (32x40, 40x32, 40x40, 24x40), each made
    of whole b8 runs of one grid, and grids mixed inside four of them."""
    tr = json.loads((REPO / "benchmark/traffic/coco_ragged_dinov3.json").read_text())
    grids = image_grids(tr, 16)
    assert sorted(set(grids)) == [(22, 40), (26, 40), (30, 40), (40, 26), (40, 30), (40, 40)]
    plan = stage1_plan(grids, np.random.default_rng(0).permutation(len(grids)), 24, 8, 8)
    assert len(plan) == 9
    assert sorted({b for b, _ in plan}) == [(24, 40), (32, 40), (40, 32), (40, 40)]
    mixed = 0
    for bucket, runs in plan:
        assert len(runs) == 3 and all(len(r) == 8 for r in runs)
        assert all(len({grids[i] for i in r}) == 1 for r in runs)
        mixed += len({grids[r[0]] for r in runs}) > 1
    assert mixed == 4
    n = [gh * gw + 5 for gh, gw in grids]
    assert (min(n) - 5, max(n) - 5) == (880, 1600)


@pytest.fixture(scope="module")
def tiny_checkout(tmp_path_factory) -> Path:
    """A copy of the benchmark with a tiny cell of the `extract_dinov3`
    driver added by files alone, under the full-size cell's limits: 320-px
    images at 4:3 and 3:2 (grids 15x20 and 13x20) sharing 16x24 stage-1
    buckets, b4 and b2."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    bench = root / "benchmark"
    (bench / "configs" / f"{NAME}.json").write_text(json.dumps(_cfg_dict()))
    traffic = json.loads((bench / "traffic" / "coco_ragged_dinov3.json").read_text())
    traffic.update(longer_side=320, aspects=[[[4, 3], 4], [[3, 2], 4]], batch_size=4,
                   eig_batch_size=2, warm_batches=2, trace_batches=2)
    (bench / "traffic" / "tiny_dinov3.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits" / "dinov3-7b16-extract-coco-ragged.json",
                bench / "limits" / "tiny-dinov3.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": NAME, "source": "tests", "reduced": [], "why": "tests",
                            "file": f"benchmark/configs/{NAME}.json"})
    spec["workloads"].append({"name": "tiny-dinov3", "config": NAME, "traffic": "tiny_dinov3",
                              "chips": 1, "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_benchmark_driver_runs_a_tiny_cell_on_the_cpu(tiny_checkout):
    """The `extract_dinov3` driver's set-up, window, check and calibration
    rows on the CPU: two b4 batches, each of a 4:3 and a 3:2 run of two,
    each image handed its grid; the run is correct, its f32 keys agree with
    the reference to f32 rounding, and each fault reads far from it."""
    from benchmark.drivers.extract_dinov3 import calibration_rows
    cell = harness.find_cell("tiny-dinov3", tiny_checkout)
    driver = harness.driver(cell, tiny_checkout)
    runner = driver.Runner(cell, 2**31 + 11, torch.device("cpu"))
    assert len(runner.pool) == 2 and runner.pool[0].bucket1 == (16, 24)
    assert sorted(map(tuple, runner.pool[0].grids1.tolist())) == [(13, 20)] * 2 + [(15, 20)] * 2
    out = runner.window(0.5)
    runner.release()
    correct, numbers = runner.check()
    assert out["attempted"] > 0 and out["failed"] == 0
    assert correct, numbers
    assert numbers["keys_f32_rel_err"]["value"] <= 1e-5
    rows = {r["kind"]: r["numbers"] for r in calibration_rows(runner)}
    f32 = numbers["keys_f32_rel_err"]["value"]
    for kind in ("fault.no_rope", "fault.bucket_grid_rope", "fault.no_storage"):
        assert rows[kind]["keys_f32_rel_err"] > 100 * f32, (kind, rows[kind])
    assert rows["fault.keys_altered"]["keys_rel_err"] > 0.09


def test_check_skips_a_sampled_batch_that_fills_its_bucket(tiny_checkout):
    """Where the window samples a batch whose images all fill their bucket
    (the full-size cell's 1:1 batch), the check takes the next batch of the
    cycle, which has an image smaller than its bucket; where every batch
    fills its bucket, the window's own."""
    cell = harness.find_cell("tiny-dinov3", tiny_checkout)
    runner = harness.driver(cell, tiny_checkout).Runner(cell, 2**31 + 12, torch.device("cpu"))
    n = len(runner.pool)
    runner.sample = n + 1
    assert runner.sample == n + 1
    filled = runner._batch(n)
    filled.grids1 = np.tile(filled.bucket1, (len(filled.grids1), 1))
    runner.sample = n
    assert runner.sample == n + 1
    for batch in runner.pool:
        batch.grids1 = np.tile(batch.bucket1, (len(batch.grids1), 1))
    runner.sample = n
    assert runner.sample == n


@pytest.mark.parametrize("name", ["test_dinov2_tiny", NAME])
@pytest.mark.parametrize("entry", ["build_stage", "pp_vit_forward", "sp_vit_forward",
                                   "sp_patch_features", "tp_sharded_patch_features"])
def test_parallel_vit_paths_refuse_dinov2_and_dinov3(entry, name):
    """The sequence-, pipeline- and tensor-parallel ViT paths run DINO v1's
    rows and blocks: a DINOv2 or DINOv3 model raises before any collective
    (without RoPE, LayerScale or its extra tokens it would give wrong keys
    silently)."""
    from deep_spectral_tpu_torch.parallel import pp_vit, sharded, sp_vit
    cfg = get_model_config(name)
    model = VisionTransformer(cfg)
    images = torch.zeros((1, 2 * cfg.patch_size, 2 * cfg.patch_size, 3))
    calls = {"build_stage": lambda: pp_vit.build_stage(cfg, model.state_dict(), None),
             "pp_vit_forward": lambda: pp_vit.pp_vit_forward(None, model, images),
             "sp_vit_forward": lambda: sp_vit.sp_vit_forward(None, model, images),
             "sp_patch_features": lambda: sp_vit.sp_patch_features(None, model, images),
             "tp_sharded_patch_features":
                 lambda: sharded.tp_sharded_patch_features(None, model, images)}
    with pytest.raises(ValueError, match="DINO v1"):
        calls[entry]()
