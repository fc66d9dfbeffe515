"""The port's self-training step, optimizer, NaN guard, bucketed evaluation,
checkpoints and CLI against the JAX package (test_vit_tiny, crop 32,
batch 2, 3 classes).

Tolerances: one train step with attention_impl='flash' on both sides (the
JAX flash kernels in interpret mode, the port's autograd function on its
twins) and the same dropout keep-mask: loss and accuracy 1e-5 relative,
each trained parameter's gradient 1e-4 relative to its largest entry, the
new BN statistics 1e-5 (all f32; only summation orders differ). AdamW with
the linear schedule against optax, fed identical gradients: 1e-6. The NaN
revert, bucketed predictions and per-image predictions: exact.
"""
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from deep_spectral_tpu.models.deeplab import DeepLabViT as JDeepLab
from deep_spectral_tpu.models.vit import get_model_config
from deep_spectral_tpu.tasks import semantic_segmentation as JSS
from deep_spectral_tpu_torch.models import deeplab as t_deeplab
from deep_spectral_tpu_torch.models.convert import flax_deeplab_to_torch_state_dict
from deep_spectral_tpu_torch.models.flash_attention import flash_attention_lse
from deep_spectral_tpu_torch.models.vit import ViTConfig
from deep_spectral_tpu_torch.tasks import cli as t_cli
from deep_spectral_tpu_torch.tasks import semantic_segmentation as TSS

TINY = get_model_config("test_vit_tiny")
T_TINY = ViTConfig(**vars(TINY))


def _cfgs(**kw):
    base = dict(num_classes=3, crop_size=32, resize_size=40, batch_size=2, lr=5e-3,
                max_train_steps=10, unfrozen_backbone_layers=1, num_workers=1)
    base.update(kw)
    return (JSS.TrainConfig(backbone=TINY, **base),
            TSS.TrainConfig(backbone=T_TINY, **base))


@functools.lru_cache(maxsize=None)
def _jax_variables():
    return JDeepLab(TINY, 3).init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                                  train=False)


class _InitOnce:
    """JAX's DeepLabViT with its (attention-independent) variables made once
    per process: an eager flax init costs seconds per train state."""

    def __init__(self, impl):
        self.model = JDeepLab(TINY, 3, attention_impl=impl)
        self.vit_cfg, self.apply = self.model.vit_cfg, self.model.apply

    def init(self, *args, **kwargs):
        return jax.tree.map(jnp.array, _jax_variables())  # a copy: train_step donates


def _states(impl="einsum", **kw):
    """A JAX train state and a port train state with the same weights (the
    JAX init, bridged) and random BN statistics on both."""
    jcfg, tcfg = _cfgs(**kw)
    jstate = JSS.create_train_state(jcfg, _InitOnce(impl))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rng.uniform(0.5, 2.0, x.shape) if path[-1].key == "var"
                                    else rng.normal(0, 0.3, x.shape), jnp.float32),
        jstate.batch_stats)
    jstate = jstate.replace(batch_stats=stats)
    tstate = TSS.create_train_state(tcfg, t_deeplab.DeepLabViT(T_TINY, 3, attention_impl=impl),
                                    device="cpu")
    tstate.model.load_state_dict(
        flax_deeplab_to_torch_state_dict(jstate.params, stats, T_TINY), strict=True)
    return jstate, tstate


def _to_torch(tree, stats):
    return flax_deeplab_to_torch_state_dict(tree, stats, T_TINY)


def _batch(seed=0):
    """Image 0 is noise, image 1 two-toned. Two images that differ keep the
    ASPP pooling branch's BatchNorm (whose batch is the two pooled vectors)
    well conditioned: for two alike images flax's E[x^2] - E[x]^2 variance
    cancels ~4 digits, and both frameworks' gradients carry their own
    rounding amplified (up to 5e-4 relative, measured on alike pairs)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    x[1, :, :16], x[1, :, 16:] = 2.0, -2.0
    y = rng.integers(0, 3, (2, 32, 32)).astype(np.int32)
    y[0, :2, :5] = 255                          # out of range: 0 loss, still counted
    return x, y


def test_train_step_flash_matches_jax(monkeypatch):
    jstate, tstate = _states("flash")
    x, y = _batch()
    key = jax.random.PRNGKey(7)
    stats = jstate.batch_stats

    def loss_fn(params):  # JSS.train_step's loss, capturing the dropout output
        logits, mut = jstate.apply_fn(
            {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
            mutable=["batch_stats", "intermediates"], rngs={"dropout": key},
            capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.sum(jax.nn.one_hot(jnp.asarray(y), 3) * logp, axis=-1)
        return jnp.mean(ce), mut

    (_, mut), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    g_ref = _to_torch(grads, stats)
    dropped = mut["intermediates"]["head"]["ASPP_0"]["Dropout_0"]["__call__"][0]
    # Where the dropout output is 0 the mask was 0 or its input was: either way
    # keep=False reproduces the output.
    keep = torch.from_numpy(np.asarray(dropped) != 0).permute(0, 3, 1, 2)
    monkeypatch.setattr(t_deeplab, "dropout",
                        lambda v, rate, gen, group=None: torch.where(keep, v / (1 - rate), 0.0))
    new_j, logs_j = JSS.train_step(jstate, jnp.asarray(x), jnp.asarray(y), key)
    bs_ref = _to_torch(new_j.params, new_j.batch_stats)

    before = flash_attention_lse.launches
    logs_t = TSS.train_step(tstate, torch.from_numpy(x), torch.from_numpy(y))
    assert flash_attention_lse.launches == before  # CPU: the twins
    assert int(tstate.step) == 1
    np.testing.assert_allclose(float(logs_t["loss"]), float(logs_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(logs_t["acc"]), float(logs_j["acc"]), rtol=1e-5)
    trained = 0
    for name, p in tstate.model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        trained += 1
        ref = g_ref[name]
        err = (p.grad - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), (name, err)
    assert trained == len(tstate.opt.params) > 0
    assert any(n.startswith("backbone.blocks.1.attn.qkv") for n in tstate.opt.params)
    for name, b in tstate.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), bs_ref[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("clip,accum", [(None, 1), (0.05, 1), (None, 2)])
def test_adamw_matches_optax(clip, accum):
    """Three updates of the trainable parameters from identical gradients:
    adamw + linear schedule, with global-norm clipping (triggered), and under
    MultiSteps accumulation."""
    jstate, tstate = _states(clip_grad_norm=clip, gradient_accumulation_steps=accum,
                             max_train_steps=4)
    rng = np.random.default_rng(2)
    params, opt_state = jstate.params, jstate.opt_state
    ok = torch.tensor(True)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = jstate.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.1,
                                                   jnp.float32), params)
        params, opt_state = update(grads, opt_state, params)
        g_t = _to_torch(grads, jstate.batch_stats)
        tstate.opt.step({n: g_t[n] for n in tstate.opt.params}, ok)
    ref = _to_torch(params, jstate.batch_stats)
    for name, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_nan_guard_reverts_full_state():
    """A non-finite loss reverts params, Adam moments, schedule count, BN
    statistics and EMA exactly; the next finite step trains on."""
    _, tcfg = _cfgs(use_ema=True, unfrozen_backbone_layers=-1)
    state = TSS.create_train_state(tcfg, TSS.build_model(tcfg), device="cpu")
    x, y = _batch(3)
    gen = torch.Generator().manual_seed(0)
    logs = TSS.train_step(state, torch.from_numpy(x), torch.from_numpy(y), gen,
                          use_ema=True, ema_decay=0.9)
    assert np.isfinite(float(logs["loss"]))

    def snapshot():
        return [t.detach().clone() for t in (*state.model.parameters(),
                                             *state.model.buffers(),
                                             *state.opt.state.values(),
                                             *state.ema_params.values())]

    before = snapshot()
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    logs = TSS.train_step(state, torch.from_numpy(bad), torch.from_numpy(y), gen,
                          use_ema=True, ema_decay=0.9)
    assert not np.isfinite(float(logs["loss"]))
    assert int(state.step) == 2
    for a, b in zip(before, snapshot()):
        assert torch.equal(a, b)
    logs = TSS.train_step(state, torch.from_numpy(x), torch.from_numpy(y), gen,
                          use_ema=True, ema_decay=0.9)
    assert np.isfinite(float(logs["loss"]))
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


@functools.lru_cache(maxsize=None)
def _voc(root):
    """VOC-like tree with varying image shapes (multiples of 8) and a 2-image
    val split with GT; pseudolabels on the 8-pixel grid."""
    from pathlib import Path
    root = Path(root)
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation", "pseudo"):
        (root / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    shapes = [(32, 48), (48, 32), (40, 40), (32, 32), (32, 48), (48, 40)]
    names = [f"s{i:02d}" for i in range(len(shapes))]
    for n, (h, w) in zip(names, shapes):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        img[:, : w // 2] //= 3
        Image.fromarray(img).save(root / "JPEGImages" / f"{n}.jpg")
        gt = np.zeros((h, w), np.uint8)
        gt[:, w // 2:] = 1
        gt[: h // 4] = 2
        Image.fromarray(gt).save(root / "SegmentationClass" / f"{n}.png")
        Image.fromarray(gt[::8, ::8]).save(root / "pseudo" / f"{n}.png")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text("\n".join(names[4:]))
    return root


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return _voc(str(tmp_path_factory.mktemp("voc")))


def test_bucketed_eval_exact(voc):
    """Port bucketed == port per-image == JAX bucketed predictions, pixel
    for pixel, and the mIoU paths agree."""
    jstate, tstate = _states()
    ds = TSS.VOCSegmentationWithPseudolabels(str(voc), "all", str(voc / "pseudo"))
    jds = JSS.VOCSegmentationWithPseudolabels(str(voc), "all", str(voc / "pseudo"))
    idx = list(range(len(ds)))
    got = dict(TSS.bucketed_predictions(tstate, ds, idx, batch_size=4))
    ref = dict(JSS.bucketed_predictions(jstate, jds, idx, patch_size=8, batch_size=4))
    assert set(got) == set(ref) == set(idx)
    for i in idx:
        image = ds[i][0]
        per_image = TSS.eval_step(tstate, torch.from_numpy(TSS.normalize_image(image))[None])
        np.testing.assert_array_equal(got[i], per_image[0].numpy(), err_msg=f"image {i}")
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"image {i} vs JAX")
    m_b, _ = TSS.evaluate_model(tstate, ds, num_classes=3, batch_size=4)
    m_p, _ = TSS.evaluate_model(tstate, ds, num_classes=3, bucketed=False)
    m_j, _ = JSS.evaluate_model(jstate, jds, num_classes=3, patch_size=8, batch_size=4)
    assert m_b == m_p and abs(m_b - m_j) < 1e-6


def test_checkpoint_round_trip_and_resume(voc, tmp_path, capsys):
    _, tcfg = _cfgs(max_train_steps=6, use_ema=True)
    ds = TSS.VOCSegmentationWithPseudolabels(str(voc), "train", str(voc / "pseudo"))
    state, _ = TSS.train(tcfg, ds, log_every=0, max_steps=3, device="cpu")
    path = TSS.save_checkpoint(str(tmp_path / "ck"), state, 3)
    assert path.name == "step_3.pt"
    fresh = TSS.create_train_state(tcfg, TSS.build_model(tcfg), device="cpu")
    TSS.restore_checkpoint(str(tmp_path / "ck"), fresh)
    assert int(fresh.step) == 3
    for a, b in zip((*state.model.state_dict().values(), *state.opt.state.values(),
                     *state.ema_params.values()),
                    (*fresh.model.state_dict().values(), *fresh.opt.state.values(),
                     *fresh.ema_params.values())):
        assert torch.equal(a, b)
    # resume runs only the remaining steps
    state2, _ = TSS.train(tcfg, ds, log_every=0, max_steps=6, resume=str(path), device="cpu")
    assert int(state2.step) == 6
    assert "trained steps 3..6: 3 steps" in capsys.readouterr().out
    # EMA presence mismatch, both ways
    _, no_ema = _cfgs(max_train_steps=6)
    other = TSS.create_train_state(no_ema, TSS.build_model(no_ema), device="cpu")
    TSS.restore_checkpoint(str(path), other)
    assert other.ema_params is None and int(other.step) == 3
    p2 = TSS.save_checkpoint(str(tmp_path / "ck2"), other, 3, keep_best=True)
    with_ema = TSS.create_train_state(tcfg, TSS.build_model(tcfg), device="cpu")
    TSS.restore_checkpoint(str(p2), with_ema)
    assert with_ema.ema_params is not None and int(with_ema.step) == 3
    assert "no EMA state" in capsys.readouterr().out



@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_train_without_a_card_raises(voc, monkeypatch, device):
    """train() defaults to CUDA and never falls back to the CPU: with no card,
    device=None (the CLI's default) and an explicit CUDA device raise before
    any step runs."""
    _, tcfg = _cfgs(max_train_steps=2)
    ds = TSS.VOCSegmentationWithPseudolabels(str(voc), "train", str(voc / "pseudo"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(TSS, "create_train_state",
                        lambda *a, **k: pytest.fail("train() went on without a card"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSS.train(tcfg, ds, log_every=0, max_steps=2, device=device)

@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_create_train_state_without_a_card_raises(monkeypatch, device):
    """create_train_state() defaults to CUDA and never falls back to the CPU:
    with no card, device=None and an explicit CUDA device raise before the
    model is initialized."""
    _, tcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(TSS, "init_deeplab_",
                        lambda *a, **k: pytest.fail("create_train_state() went on without a card"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSS.create_train_state(tcfg, t_deeplab.DeepLabViT(T_TINY, 3), device=device)


def test_semantic_train_cli(voc, tmp_path, capsys):
    args = ["semantic_train", f"data.root={voc}", f"segments_dir={voc / 'pseudo'}",
            "backbone=test_vit_tiny", "data.num_classes=2", "data.loader.batch_size=2",
            "data.loader.num_workers=1", "data.transform.crop_size=32",
            "data.transform.resize_size=40", "max_train_steps=4", "eval_every=2",
            "device=cpu", f"checkpoint.dir={tmp_path / 'ckpt'}"]
    assert t_cli.main(args) == 0
    out = capsys.readouterr().out
    assert "val mIoU=" in out and "best mIoU:" in out
    assert (tmp_path / "ckpt" / "best.pt").is_file()
    best_step = torch.load(tmp_path / "ckpt" / "best.pt", weights_only=True)["step"]
    assert t_cli.main(args[:-2] + ["max_train_steps=6", "device=cpu",
                                   f"checkpoint.resume={tmp_path / 'ckpt' / 'best.pt'}",
                                   f"checkpoint.dir={tmp_path / 'ckpt2'}"]) == 0
    out = capsys.readouterr().out
    assert f"at step {best_step}" in out and f"{6 - best_step} steps" in out
    with pytest.raises(SystemExit):  # --checkpoint and --output_dir are required
        t_cli.main(["semantic_generate"])
    assert t_cli.main([]) == 2


def test_generate_predictions_match_jax(voc, tmp_path):
    """`generate_predictions` writes the JAX function's PNGs byte for byte
    (the same weights; bucketed), and the per-image path the same bytes."""
    jstate, tstate = _states()
    ds = TSS.VOCSegmentationWithPseudolabels(str(voc), "all", str(voc / "pseudo"))
    jds = JSS.VOCSegmentationWithPseudolabels(str(voc), "all", str(voc / "pseudo"))
    JSS.generate_predictions(jstate, jds, tmp_path / "j", patch_size=8, batch_size=4)
    TSS.generate_predictions(tstate, ds, tmp_path / "t", batch_size=4)
    TSS.generate_predictions(tstate, ds, tmp_path / "p", bucketed=False)
    for sub in ("pred", "gt"):
        names = sorted(f.name for f in (tmp_path / "j" / sub).iterdir())
        assert len(names) == len(ds) and names == sorted(
            f.name for f in (tmp_path / "t" / sub).iterdir())
        for name in names:
            want = (tmp_path / "j" / sub / name).read_bytes()
            assert (tmp_path / "t" / sub / name).read_bytes() == want, (sub, name)
            assert (tmp_path / "p" / sub / name).read_bytes() == want, (sub, name)


def test_semantic_generate_cli(voc, tmp_path, capsys):
    """semantic_train writes a checkpoint; semantic_generate restores it under
    the same config and writes one prediction per val image, at the image's
    size cropped to a multiple of the patch size, equal to the trained
    state's own predictions."""
    cfg = ["backbone=test_vit_tiny", "data.num_classes=2", "data.loader.batch_size=2",
           "data.loader.num_workers=1", "data.transform.crop_size=32",
           "data.transform.resize_size=40", "device=cpu", f"data.root={voc}",
           f"segments_dir={voc / 'pseudo'}"]
    assert t_cli.main(["semantic_train", *cfg, "max_train_steps=2", "eval_every=2",
                       f"checkpoint.dir={tmp_path / 'ck'}"]) == 0
    ck = tmp_path / "ck" / "best.pt"
    t_cli.main(["semantic_generate", "--checkpoint", str(ck), "--output_dir",
                str(tmp_path / "gen"), *cfg])
    assert "Wrote 2 predictions" in capsys.readouterr().out
    _, tcfg = _cfgs(num_classes=3)
    state = TSS.restore_checkpoint(str(ck), TSS.create_train_state(
        tcfg, TSS.build_model(tcfg), device="cpu"))
    val = TSS.VOCSegmentationWithPseudolabels(str(voc), "val", str(voc / "pseudo"))
    for i in range(len(val)):
        image, _, target, stem = val[i]
        pred = np.asarray(Image.open(tmp_path / "gen" / "pred" / f"{stem}.png"))
        H, W = (image.shape[0] // 8) * 8, (image.shape[1] // 8) * 8
        assert pred.shape == (H, W)
        want = TSS.eval_step(state, torch.from_numpy(TSS.normalize_image(image[:H, :W]))[None])
        np.testing.assert_array_equal(pred, want[0].numpy())
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "gen" / "gt" / f"{stem}.png")), target)


def test_semantic_generate_needs_the_card_by_default(voc, tmp_path, monkeypatch):
    """semantic_generate runs on CUDA unless device=cpu is given: with no card
    it raises before restoring anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["semantic_generate", "--checkpoint", str(tmp_path / "none.pt"),
                    "--output_dir", str(tmp_path / "gen"), "backbone=test_vit_tiny",
                    f"data.root={voc}", f"segments_dir={voc / 'pseudo'}"])
    assert not (tmp_path / "gen").exists()


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_remat_gradients_equal_plain(impl, monkeypatch):
    """TrainConfig.remat recomputes each ViT block in the backward: one step
    from the same weights, batch and dropout generator gives the same
    gradients, bit for bit, as the plain step. On the 'flash' route the
    remat'd step runs kernel 3's function twice per trained block (the
    forward, then the recompute), and on the CPU its plain twin: the launch
    counters stay as they were."""
    import deep_spectral_tpu_torch.models.flash_attention as fa
    calls = []
    real = fa.flash_attention_lse
    monkeypatch.setattr(fa, "flash_attention_lse",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, y = (torch.from_numpy(v) for v in _batch())
    grads, n_calls = {}, {}
    for remat in (False, True):
        _, tcfg = _cfgs(remat=remat, unfrozen_backbone_layers=2)
        model = t_deeplab.DeepLabViT(T_TINY, 3, attention_impl=impl, remat=remat)
        assert TSS.build_model(tcfg).backbone.remat == remat
        state = TSS.create_train_state(tcfg, model, device="cpu")
        before = (real.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
        calls.clear()
        TSS.train_step(state, x, y, torch.Generator().manual_seed(3))
        n_calls[remat] = len(calls)
        assert (real.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == before
        grads[remat] = {n: p.grad.clone() for n, p in state.opt.params.items()}
    assert grads[True].keys() == grads[False].keys()
    assert any(n.startswith("backbone.blocks.0.") for n in grads[True])
    for name, g in grads[False].items():
        assert torch.equal(grads[True][name], g), name
    if impl == "flash":
        assert (n_calls[False], n_calls[True]) == (2, 4)  # 2 trained blocks


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
