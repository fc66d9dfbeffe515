"""Which stage-1 forwards the port replays from a CUDA graph, and when it
captures one, on the CPU: the rule on the activations' size
(`graphs_forward`) over the benchmark's four configurations, the graph's
key (`forward_key`), the capture policy (`GraphPolicy`), the CPU forward
left eager with its counters, and the benchmark's reader of the share of
forwards a replay served. The replay itself needs the card
(tests/test_torch_cuda.py)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from deep_spectral_tpu_torch.models import vit
from deep_spectral_tpu_torch.models.convert import random_init_
from deep_spectral_tpu_torch.models.vit import (GraphPolicy, VisionTransformer,
                                                extract_patch_keys, forward_key,
                                                get_model_config, graphs_forward)
from deep_spectral_tpu_torch.utils import profiling


# stage 1's b24 batches in the benchmark's cells: (model, tokens run, graphed)
STAGE1 = [("dino_vits16", 1 + 32 * 32, True),            # 480x480 in its 512x512 bucket
          ("dino_vits8", 1 + 64 * 48, True),             # 480x360 in 512x384
          ("dinov2_vitg14_reg", 5 + 34 * 34, False),     # compacted to the 34x34 grid
          ("dinov3_vit7b16", 5 + 30 * 40, False)]        # a COCO 480x640 image's


@pytest.mark.parametrize("name,tokens,graphed", STAGE1)
def test_rule_graphs_the_forwards_the_host_paces(name, tokens, graphed):
    """B x T x D under 2^25 elements: ViT-S/16 (9.4M) and ViT-S/8 (28.3M)
    replay, DINOv2 ViT-g/14 (42.8M) and DINOv3 ViT-7B/16 (~118M) run
    eagerly; a batch of one of the large models is small enough."""
    D = get_model_config(name).embed_dim
    assert graphs_forward(24, tokens, D) is graphed
    assert graphs_forward(1, tokens, D)


def _meta_model(name):
    with torch.device("meta"):
        return VisionTransformer(get_model_config(name), torch.bfloat16)


@pytest.mark.parametrize("name,tokens,graphed", STAGE1)
def test_key_at_the_configurations_widths(name, tokens, graphed):
    """`forward_key` keys the b24 batches the rule graphs, on models built
    without storage; DINOv3 (its RoPE plan is uploaded per call) and a
    DINOv2 batch that compacts stay eager at any size."""
    cfg = get_model_config(name)
    model = _meta_model(name)
    P = cfg.patch_size
    side = {"dino_vits16": (512, 512), "dino_vits8": (384, 512),
            "dinov2_vitg14_reg": (34 * P, 34 * P), "dinov3_vit7b16": (30 * P, 40 * P)}[name]
    assert (side[0] // P) * (side[1] // P) + cfg.num_prefix == tokens
    images = torch.empty((24, *side, 3), device="meta")
    mask = torch.ones((24, tokens - cfg.num_prefix), dtype=torch.bool, device="meta")
    key = forward_key(model, images, cfg.depth - 1, 1, mask, None)
    assert (key is not None) is graphed
    small = forward_key(model, images[:1], cfg.depth - 1, 1, mask[:1], None)
    assert (small is not None) is (cfg.family != "dinov3")
    if cfg.family == "dinov2":
        h, w = side[0] // P, side[1] // P
        assert forward_key(model, images[:1], cfg.depth - 1, 1, mask[:1],
                           np.array([[h - 1, w]])) is None
        assert forward_key(model, images[:1], cfg.depth - 1, 1, mask[:1],
                           np.array([[h, w]])) is not None


def _tiny(name="test_vit_tiny", dtype=torch.float32):
    return random_init_(VisionTransformer(get_model_config(name), dtype), seed=0).eval()


def test_key_follows_what_fixes_the_kernels():
    """The key changes with the input's shape and dtype, the mask's
    presence, the block, the feature, a write to `pos_embed` (whose table
    a graph holds; `load_state_dict` copies into it) and a replaced
    parameter or a moved model; it stays under a write to another weight
    (a replay reads its values) and under grids that DINO v1 does not
    read, and a DINOv2 model's grids enter it."""
    model = _tiny()
    x = torch.randn(2, 32, 40, 3)
    mask = torch.ones(2, 20, dtype=torch.bool)
    key = forward_key(model, x, 1, 1, mask, None)
    assert key == forward_key(model, x.clone(), 1, 1, mask.clone(), None)
    assert key == forward_key(model, x, 1, 1, mask, np.array([[4, 5], [3, 5]]))
    others = [forward_key(model, torch.randn(2, 40, 40, 3), 1, 1, torch.ones(2, 25, dtype=bool),
                          None),
              forward_key(model, x.double(), 1, 1, mask, None),
              forward_key(model, x, 1, 1, None, None),
              forward_key(model, x, 1, 1, mask.to(torch.uint8), None),
              forward_key(model, x, 0, 1, mask, None),
              forward_key(model, x, 1, 0, mask, None)]
    assert all(k is not None and k != key for k in others)
    assert len(set(others)) == len(others)
    with torch.no_grad():
        model.blocks[0].attn.qkv.weight.mul_(2.0)
    assert forward_key(model, x, 1, 1, mask, None) == key
    model.load_state_dict(_tiny().state_dict())
    loaded = forward_key(model, x, 1, 1, mask, None)
    assert loaded != key
    model.blocks[0].attn.qkv.weight = torch.nn.Parameter(model.blocks[0].attn.qkv.weight.clone())
    moved = forward_key(model, x, 1, 1, mask, None)
    assert moved not in (key, loaded)
    model.to(torch.float64).to(torch.float32)
    assert forward_key(model, x, 1, 1, mask, None) not in (key, loaded, moved)
    v2 = _tiny("test_dinov2_tiny")
    x2 = torch.randn(2, 5 * 14, 6 * 14, 3)
    grids = [np.array([[5, 6], [5, 6]]), np.array([[5, 6], [4, 5]])]
    keys = [forward_key(v2, x2, 1, 1, None, g) for g in grids]
    assert keys[0] is not None and keys[0] != forward_key(v2, x2, 1, 1, None, None)
    assert keys[1] != keys[0]


def test_policy_captures_at_the_second_consecutive_use():
    """Eager at a key's first use, capture at its second in a row, replay
    while the model holds its graph; one graph a model: another key used
    twice in a row replaces it, and a key interleaved with another never
    captures."""
    policy = GraphPolicy()
    steps = [policy.step(k) for k in "aaaab"]
    assert steps == ["eager", "capture", "replay", "replay", "eager"]
    assert [policy.step(k) for k in "abab"] == ["replay", "eager", "replay", "eager"]
    assert [policy.step(k) for k in "bbab"] == ["capture", "replay", "eager", "replay"]
    assert policy.captured == "b"
    assert [policy.step(k) for k in "cdcdcc"] == ["eager"] * 5 + ["capture"]
    assert [policy.step(k) for k in "bcc"] == ["eager", "replay", "replay"]


def test_policy_recaptures_after_the_parameters_move():
    """A model whose parameters are replaced gives its calls a new key:
    its first call runs eagerly, its second captures again."""
    model, policy = _tiny(), GraphPolicy()
    x = torch.randn(2, 32, 40, 3)

    def step():
        return policy.step(forward_key(model, x, 1, 1, None, None))

    assert [step(), step(), step()] == ["eager", "capture", "replay"]
    model.to(torch.float64).to(torch.float32)
    assert [step(), step(), step()] == ["eager", "capture", "replay"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_forward_stays_eager(dtype):
    """On the CPU no call is keyed, so none is graphed: repeated calls hold
    no graph for the model, count no replay or capture, and give the same
    keys each time."""
    model = _tiny(dtype=dtype)
    x = torch.randn(2, 32, 40, 3, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 20, dtype=torch.bool)
    mask[1, -5:] = False
    before = profiling.totals()
    keys = [extract_patch_keys(model, x, token_mask=mask) for _ in range(3)]
    after = profiling.totals()
    assert model not in vit._model_graphs
    for name in ("vit.graph_replays", "vit.graph_captures"):
        assert after.get(name, 0) == before.get(name, 0)
    assert after["vit.tokens"] - before.get("vit.tokens", 0) == 3 * 2 * 21
    assert all(torch.equal(k, keys[0]) for k in keys)


def test_graph_share_reader(monkeypatch):
    """vit_graph_share.extract: replays over the `vit.extract` spans opened
    in the window, 0 where every forward ran eagerly, None where no span
    opened or the port has no rule for graphs."""
    from benchmark import harness
    read = harness.metric_reader("vit_graph_share.extract").read

    def recs(*counts):
        return [{"name": "vit.extract", "parent": None, "counts": c, "device_ms": None}
                for c in counts] + [{"name": "eigs.decompose", "parent": None, "counts": {},
                                     "device_ms": None}]

    monkeypatch.setattr(profiling, "records", lambda: recs(
        {"vit.tokens": 4, "vit.graph_captures": 1}, {"vit.tokens": 4, "vit.graph_replays": 1},
        {"vit.tokens": 4, "vit.graph_replays": 1}, {"vit.tokens": 4, "vit.graph_replays": 1}))
    assert read(None) == pytest.approx(75.0)
    monkeypatch.setattr(profiling, "records", lambda: recs({"vit.tokens": 4}, {"vit.tokens": 4}))
    assert read(None) == 0.0
    monkeypatch.setattr(profiling, "records", lambda: recs())
    assert read(None) is None
    monkeypatch.setattr(profiling, "records", lambda: recs({"vit.tokens": 4}))
    monkeypatch.delattr(vit, "graphs_forward")
    assert read(None) is None
