"""The port's DINO ViT, resize and weight bridge against the JAX package.

Inputs come from numpy seeds and go through both packages with the same
weights (the port's seeded init, carried over by the JAX package's
converter; `flax_to_torch_state_dict` is pinned as its inverse).
Tolerances: fp32 forwards agree to 1e-4 absolute on O(1) features (both run
true f32; only the summation order differs); bf16 forwards are compared by
per-token cosine >= 0.99 (bf16 rounds at different places in the two
frameworks, ~3 significant digits per op over a few layers).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu.models.convert import (convert_dino_torch_checkpoint,
                                              find_local_checkpoint)
from deep_spectral_tpu.models.vit import VisionTransformer as JViT
from deep_spectral_tpu.models.vit import ViTConfig as JViTConfig
from deep_spectral_tpu.models.vit import (extract_patch_keys as j_keys,
                                          get_model_config, vit_forward)
from deep_spectral_tpu.ops.resize import resize_bicubic as j_resize_bicubic
from deep_spectral_tpu_torch.models import convert as t_convert
from deep_spectral_tpu_torch.models.vit import VIT_CONFIGS as T_VIT_CONFIGS
from deep_spectral_tpu_torch.models.vit import VisionTransformer as TViT
from deep_spectral_tpu_torch.models.vit import ViTConfig as TViTConfig
from deep_spectral_tpu_torch.models.vit import extract_patch_keys as t_keys
from deep_spectral_tpu_torch.ops.resize import resize_bicubic

# A 2-block config with the real head dim (hd = 64) next to test_vit_tiny (hd = 16).
HD64 = dict(patch_size=16, embed_dim=128, depth=2, num_heads=2, img_size=64)
CONFIGS = {"test_vit_tiny": get_model_config("test_vit_tiny"),
           "hd64_2block": JViTConfig(**HD64)}


def _t_cfg(jcfg):
    return TViTConfig(jcfg.patch_size, jcfg.embed_dim, jcfg.depth, jcfg.num_heads,
                      jcfg.mlp_ratio, jcfg.img_size)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def bridged(request):
    return _bridged(request.param)


def _bridged(name):
    """(jax model, jax params, port model) with identical fp32 weights: the
    port's seeded init, carried to the JAX package by its own converter."""
    jcfg = CONFIGS[name]
    tmodel = t_convert.random_init_(TViT(_t_cfg(jcfg)), seed=3).eval()
    params = convert_dino_torch_checkpoint(tmodel.state_dict(), jcfg)
    return JViT(jcfg), params, tmodel


def _images(jcfg, B, hp, wp, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (B, hp * jcfg.patch_size, wp * jcfg.patch_size, 3)).astype(np.float32)
    return x


def test_configs_match_jax():
    """Every JAX config has the port's entry of its name, equal field by
    field, with the port's DINOv2, DINOv3 and SAM fields at their DINO v1
    defaults; the port may hold more names (the DINOv2, DINOv3 and SAM
    families, which the JAX package lacks)."""
    from deep_spectral_tpu.models.vit import VIT_CONFIGS as J_VIT_CONFIGS
    v1 = {"family": "dino", "num_registers": 0, "ffn": "mlp", "norm_eps": 1e-6,
          "window_size": 0, "global_blocks": ()}
    for name, jcfg in J_VIT_CONFIGS.items():
        assert vars(T_VIT_CONFIGS[name]) == vars(jcfg) | v1, name
    assert set(T_VIT_CONFIGS) - set(J_VIT_CONFIGS) == {"dinov2_vitg14_reg", "test_dinov2_tiny",
                                                       "dinov3_vit7b16", "test_dinov3_tiny",
                                                       "sam_vit_h", "test_sam_tiny"}


@pytest.mark.parametrize("in_hw,out_hw", [((14, 14), (30, 30)), ((14, 14), (20, 30)),
                                          ((4, 4), (7, 9)), ((14, 14), (6, 5))])
def test_resize_bicubic_matches_jax(in_hw, out_hw):
    """F.interpolate(bicubic, size=) == the JAX package's torch-exact kernel,
    to f32 rounding (1e-5 on N(0,1) inputs)."""
    x = np.random.default_rng(1).standard_normal((1, *in_hw, 16)).astype(np.float32)
    ref = np.asarray(j_resize_bicubic(jnp.asarray(x), out_hw, channels_last=True))
    got = resize_bicubic(torch.from_numpy(x), out_hw, channels_last=True).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    ref2 = np.asarray(j_resize_bicubic(jnp.asarray(x[..., 0]), out_hw, channels_last=False))
    got2 = resize_bicubic(torch.from_numpy(x[..., 0]), out_hw, channels_last=False).numpy()
    np.testing.assert_allclose(got2, ref2, atol=1e-5)


def _synthetic_dino_state_dict(cfg, seed=0):
    """Random tensors under every key and shape of a DINO ViT checkpoint."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in TViT(_t_cfg(cfg)).state_dict().items()}
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["test_vit_tiny", "dino_vits16", "dino_vits8"])
def test_weight_bridge_round_trip(name):
    """convert_dino_torch_checkpoint(flax_to_torch_state_dict(p)) == p and
    flax_to_torch_state_dict(convert_dino_torch_checkpoint(sd)) == sd, and the
    bridged dict loads into the port's module with DINO's names."""
    cfg = get_model_config(name)
    sd = _synthetic_dino_state_dict(cfg)
    params = convert_dino_torch_checkpoint(sd, cfg)
    sd_back = t_convert.flax_to_torch_state_dict(params, cfg)
    assert sd_back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(sd_back[k], v), k
    back = convert_dino_torch_checkpoint(sd_back, cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a))
    result = TViT(_t_cfg(cfg)).load_state_dict(sd_back, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_vit_forward_matches_jax_fp32(bridged):
    """x_norm, q/k/v of block 0, both blocks' normed outputs and the last
    attention map, at an interpolated positional grid."""
    jmodel, params, tmodel = bridged
    x = _images(jmodel.cfg, 2, 5, 7)
    ref = vit_forward(jmodel, params, jnp.asarray(x), qkv_block=0,
                      n_intermediates=2, want_attn=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), qkv_block=0, n_intermediates=2,
                     want_attn=True)
    np.testing.assert_allclose(got["x_norm"].numpy(), np.asarray(ref["x_norm"]), atol=1e-4)
    for name in "qkv":
        np.testing.assert_allclose(got["qkv"][name].numpy(),
                                   np.asarray(ref["qkv"][name]), atol=1e-4)
    assert len(got["intermediates"]) == len(ref["intermediates"]) == 2
    for a, b in zip(got["intermediates"], ref["intermediates"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(got["attn"].numpy(), np.asarray(ref["attn"]), atol=1e-5)


def _bucket_inputs(jcfg, seed=4):
    """Two images padded into one 6x6-patch bucket: image 0 is 6x6, image 1
    is 4x5 with garbage in the pad region."""
    P = jcfg.patch_size
    x = _images(jcfg, 2, 6, 6, seed=seed)
    mask = np.ones((2, 6, 6), bool)
    mask[1, 4:, :] = False
    mask[1, :, 5:] = False
    return x, mask.reshape(2, -1), P


def test_extract_patch_keys_masked_matches_jax(bridged):
    jmodel, params, tmodel = bridged
    x, mask, _ = _bucket_inputs(jmodel.cfg)
    ref = np.asarray(j_keys(jmodel, params, jnp.asarray(x), token_mask=jnp.asarray(mask)))
    got = t_keys(tmodel, torch.from_numpy(x), token_mask=torch.from_numpy(mask))
    assert got.shape == ref.shape == (2, 36, jmodel.cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    full = tmodel(torch.from_numpy(x), token_mask=torch.from_numpy(mask))["qkv"]["k"]
    np.testing.assert_allclose(got.numpy(), full[:, 1:].detach().numpy(), atol=1e-6)


def test_pad_invariance_under_bucket_masks(bridged):
    """Valid tokens' keys do not depend on what the padded pixels hold."""
    _, _, tmodel = bridged
    x, mask, P = _bucket_inputs(tmodel.cfg)
    x2 = x.copy()
    x2[1, 4 * P:, :] = 1e3 * np.random.default_rng(9).standard_normal(x2[1, 4 * P:, :].shape)
    x2[1, :, 5 * P:] = -7.0
    m = torch.from_numpy(mask)
    a = t_keys(tmodel, torch.from_numpy(x), token_mask=m)
    b = t_keys(tmodel, torch.from_numpy(x2), token_mask=m)
    np.testing.assert_allclose(a[m].numpy(), b[m].numpy(), atol=1e-6)
    assert not torch.allclose(a[~m], b[~m])


def test_vit_bf16_close_to_jax_bf16():
    jmodel, params, tmodel = _bridged("hd64_2block")
    x, mask, _ = _bucket_inputs(jmodel.cfg, seed=5)
    jb = JViT(jmodel.cfg, jnp.bfloat16)
    ref = np.asarray(j_keys(jb, params, jnp.asarray(x), token_mask=jnp.asarray(mask)),
                     np.float32)
    tb = TViT(tmodel.cfg, torch.bfloat16)
    tb.load_state_dict(tmodel.state_dict())
    got = t_keys(tb, torch.from_numpy(x), token_mask=torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos[mask].min() > 0.99


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_load_model_without_a_card_raises(monkeypatch, device):
    """load_model() defaults to CUDA and never falls back to the CPU: with no
    card, device=None and an explicit CUDA device raise before any weight is
    made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(t_convert, "random_init_",
                        lambda *a, **k: pytest.fail("load_model() went on without a card"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_convert.load_model("test_vit_tiny", device=device)


def test_load_model_checkpoint_and_random_init(tmp_path):
    """A DINO-style checkpoint ('module.' prefix, projection head) loads by
    name from ckpt_dir; without one the init is seeded and deterministic."""
    a = t_convert.load_model("test_vit_tiny", seed=0, device="cpu")
    b = t_convert.load_model("test_vit_tiny", seed=0, device="cpu")
    c = t_convert.load_model("test_vit_tiny", seed=1, device="cpu")
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.blocks[0].attn.qkv.weight, c.blocks[0].attn.qkv.weight)
    sd = {f"module.{k}": v for k, v in c.state_dict().items()}
    sd["module.head.weight"] = torch.zeros(3, 3)
    torch.save({"state_dict": sd}, tmp_path / "test_vit_tiny.pth")
    d = t_convert.load_model("test_vit_tiny", ckpt_dir=str(tmp_path), precision="bf16",
                               device="cpu")
    assert d.compute_dtype == torch.bfloat16
    for k, v in c.state_dict().items():
        assert torch.equal(d.state_dict()[k], v), k


@pytest.mark.parametrize("impl,dtype,grad,route", [
    ("flash", torch.float32, False, "lse"),
    ("flash", torch.bfloat16, False, "packed"),
    ("flash", torch.float32, True, "autograd"),
    ("flash", torch.bfloat16, True, "autograd"),
    ("einsum", torch.float32, True, "einsum"),
    ("auto", torch.float32, False, "einsum"),     # 'auto' is einsum on the CPU
])
def test_attention_dispatch(monkeypatch, impl, dtype, grad, route):
    """The Attention routes of the JAX model's vit.py:92-108 (on CPU
    tensors, where each wrapper computes its twin): an fp32 model without
    gradients takes the f32 build of the residual-saving forward, bf16 the
    packed forward, anything that needs q/k/v gradients the autograd
    function, and 'einsum' the plain softmax."""
    from deep_spectral_tpu_torch.models import vit as t_vit
    calls = []
    for name in ("flash_attention_lse", "flash_attention_packed"):
        fn = getattr(t_vit, name)
        monkeypatch.setattr(t_vit, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    apply = t_vit.FlashAttentionFn.apply
    monkeypatch.setattr(t_vit.FlashAttentionFn, "apply",
                        lambda *a: calls.append("autograd") or apply(*a))
    attn = t_vit.Attention(128, 2, impl)
    x = torch.randn((2, 5, 128), generator=torch.Generator().manual_seed(0))
    with torch.set_grad_enabled(grad):
        out, _, amap = attn(x, torch.tensor([[1, 1, 1, 0, 1]] * 2, dtype=torch.bool),
                            dtype=dtype)
    assert calls == ([] if route == "einsum" else
                     ["flash_attention_" + route] if route in ("lse", "packed") else [route])
    assert (amap is not None) == (route == "einsum")
    assert out.dtype == dtype and out.requires_grad == grad
    with pytest.raises(ValueError, match="attention_impl"):
        t_vit.Attention(128, 2, "xla")


def test_real_weights_match_jax():
    """With a real DINO checkpoint ($DSS_TPU_DINO_CKPT_DIR/dino_vits16.pth),
    the port and the JAX package load it each their own way and agree on the
    k features (per-patch cosine >= 0.9999, as tests/test_real_weights.py
    holds the JAX model to its torch oracle)."""
    path = find_local_checkpoint("dino_vits16")
    if path is None:
        pytest.skip("no real DINO checkpoint (set DSS_TPU_DINO_CKPT_DIR with "
                    "dino_vits16.pth to enable)")
    from deep_spectral_tpu.models.convert import load_params
    jmodel, params = load_params("dino_vits16")
    tmodel = t_convert.load_model("dino_vits16", device="cpu")
    x = np.random.default_rng(0).standard_normal((1, 224, 224, 3)).astype(np.float32)
    ref = np.asarray(j_keys(jmodel, params, jnp.asarray(x)))[0]
    got = t_keys(tmodel, torch.from_numpy(x))[0].numpy()
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.9999
    assert os.path.samefile(path, t_convert.find_local_checkpoint("dino_vits16"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
