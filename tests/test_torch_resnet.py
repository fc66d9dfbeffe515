"""The port's ResNet-50 / VGG-16 trunks (`models/resnet.py`) and
`DeepLabResNet` against the JAX package's, on the CPU, with the JAX params
carried across by `models.convert`.

Inputs and BatchNorm statistics are seeded numpy draws. Tolerance: 1e-4
relative to the largest entry of each feature map and of the logits. Both
sides run true f32 convolutions (the port under `exact_f32`), so what is left
is the summation order of XLA's and oneDNN's convolutions, through 50
layers (measured below 3e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu.models import resnet as JR
from deep_spectral_tpu.models.deeplab import DeepLabResNet as JDeepLabResNet
from deep_spectral_tpu.models.deeplab import backbone_param_labels as j_labels
from deep_spectral_tpu_torch.models import resnet as TR
from deep_spectral_tpu_torch.models.convert import (flax_deeplab_resnet_to_torch_state_dict,
                                                    flax_resnet_to_torch_state_dict,
                                                    flax_vgg16_to_torch_state_dict)
from deep_spectral_tpu_torch.models.deeplab import DeepLabResNet, backbone_param_labels
from deep_spectral_tpu_torch.tasks import semantic_segmentation as TSS
from deep_spectral_tpu_torch.utils.precision import exact_f32

REL_TOL = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_variables(model, x_shape, seed):
    """Seeded numpy draws in the shapes of `model`'s flax variables (shapes
    from `jax.eval_shape`, which compiles nothing): kernels ~ N(0, 1/fan_in),
    biases and BatchNorm shifts small, BatchNorm scales and statistics
    random, so the eval path uses them. Returns (params, batch_stats)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros(x_shape))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            x = rng.uniform(-0.5, 0.5, shape)
        return jnp.asarray(x, jnp.float32)
    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return variables["params"], variables.get("batch_stats", {})


def _image(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_resnet_variables():
    """One draw of ResNet-50 variables (dilation changes no shape)."""
    return _random_variables(JR.ResNet50(), (1, 64, 64, 3), 1)


@pytest.mark.parametrize("rswd", [(False, False, False), (False, False, True),
                                  (False, True, True)])
def test_resnet50_matches_jax(rswd):
    """Every stage of ResNet-50 (no dilation; layer4 dilated, the zoo's
    'dilated' variant; output stride 8) from the JAX params."""
    x = _image((1, 64, 64, 3))
    params, stats = _jax_resnet_variables()
    jmodel = JR.ResNet50(replace_stride_with_dilation=rswd)
    want = jax.jit(functools.partial(jmodel.apply, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = TR.ResNet50(replace_stride_with_dilation=rswd).eval()
    model.load_state_dict(flax_resnet_to_torch_state_dict(params, stats), strict=True)
    with torch.no_grad(), exact_f32():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(want) == {"stem", "layer1", "layer2", "layer3", "layer4"}
    for name in got:
        g = got[name].permute(0, 2, 3, 1).numpy()
        assert g.shape == want[name].shape, name
        assert _rel(g, want[name]) <= REL_TOL, name
    stride = 8 if rswd[1] else 16 if rswd[2] else 32
    assert got["layer4"].shape[-1] == 64 // stride


def test_vgg16_matches_jax():
    x = _image((1, 64, 96, 3), seed=1)
    jmodel = JR.VGG16Features()
    params, _ = _random_variables(jmodel, x.shape, 2)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    model = TR.VGG16Features().eval()
    model.load_state_dict(flax_vgg16_to_torch_state_dict(params), strict=True)
    with torch.no_grad(), exact_f32():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert list(got) == [f"stage{i}" for i in range(1, 6)]
    for name in got:
        g = got[name].permute(0, 2, 3, 1).numpy()
        assert g.shape == want[name].shape, name
        assert _rel(g, want[name]) <= REL_TOL, name
    assert tuple(got["stage5"].shape) == (1, 512, 4, 6)


def test_torchvision_layout_loads_and_extractor():
    """A state dict in torchvision's layout (its BatchNorm counters included)
    loads as it is; the truncated extractor returns the named stage."""
    model, extract = TR.resnet50_feature_extractor("layer3", dilate_last=True)
    sd = dict(model.state_dict())
    assert "layer1.0.downsample.0.weight" in sd and "layer4.2.bn3.running_var" in sd
    for name in [k[:-len(".running_mean")] for k in sd if k.endswith(".running_mean")]:
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)
    TR.ResNet50().load_state_dict(sd, strict=True)
    with torch.no_grad():
        assert tuple(extract(torch.zeros(1, 3, 64, 64)).shape) == (1, 1024, 4, 4)
    vgg = {k for k in TR.VGG16Features().state_dict()}
    assert {"features.0.weight", "features.28.bias"} <= vgg and len(vgg) == 26


@functools.lru_cache(maxsize=None)
def _jax_deeplab_variables():
    """One draw of DeepLabResNet variables (the output stride changes no
    shape)."""
    return _random_variables(JDeepLabResNet(3), (1, 64, 64, 3), 3)


@pytest.mark.parametrize("output_stride", [8, 16])
def test_deeplab_resnet_logits_match_jax(output_stride):
    params, stats = _jax_deeplab_variables()
    jmodel = JDeepLabResNet(3, output_stride=output_stride)
    x = _image((2, 64, 80, 3), seed=2)
    want = jax.jit(functools.partial(jmodel.apply, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = DeepLabResNet(3, output_stride=output_stride).eval()
    model.load_state_dict(flax_deeplab_resnet_to_torch_state_dict(params, stats),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 64, 80, 3)
    assert _rel(got, want) <= REL_TOL


@pytest.mark.parametrize("unfrozen", [-1, 0, 1, 2])
def test_deeplab_resnet_param_labels_match_jax(unfrozen):
    """Each parameter's train/freeze label equals the JAX label of its module
    (the stem, a ResNet block, or the head)."""
    params, _ = _jax_deeplab_variables()
    want = {}
    for path, label in jax.tree_util.tree_flatten_with_path(
            j_labels(params, unfrozen, 4))[0]:
        keys = [p.key for p in path]
        want.setdefault(tuple(keys[:2]) if keys[0] == "backbone" else ("head",), set()).add(label)
    assert all(len(v) == 1 for v in want.values())
    labels = backbone_param_labels(DeepLabResNet(3), unfrozen)
    for name, label in labels.items():
        parts = name.split(".")
        if parts[0] == "head":
            key = ("head",)
        elif parts[1].startswith("layer"):
            key = ("backbone", f"{parts[1]}_{parts[2]}")
        else:
            key = ("backbone", parts[1])
        assert want[key] == {label}, name
    trained = {n for n, lab in labels.items() if lab == "train"}
    if unfrozen == 1:
        assert any(n.startswith("backbone.layer4.") for n in trained)
        assert not any(n.startswith(("backbone.layer3.", "backbone.conv1")) for n in trained)


def test_deeplab_resnet_trains_and_predicts_per_image(tmp_path):
    """TrainConfig(backbone='resnet50') on the CPU: two train steps with a
    finite loss, then `generate_predictions` takes the per-image path, each
    image cropped to a multiple of 16."""
    cfg = TSS.TrainConfig(backbone="resnet50", num_classes=3, crop_size=32, batch_size=2,
                          unfrozen_backbone_layers=1, max_train_steps=4)
    state = TSS.create_train_state(cfg, TSS.build_model(cfg), device="cpu")
    assert isinstance(state.model, DeepLabResNet) and not TSS.supports_bucketed_eval(state)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, (2, 32, 32)))
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        assert np.isfinite(float(TSS.train_step(state, x, y, gen)["loss"]))

    class Images:
        """A dataset of two odd-sized images and no GT."""
        items = [(rng.integers(0, 255, (40, 50, 3), dtype=np.uint8), None, None, "p0"),
                 (rng.integers(0, 255, (35, 64, 3), dtype=np.uint8), None, None, "p1")]

        def __len__(self):
            return len(self.items)

        def __getitem__(self, i):
            return self.items[i]

    TSS.generate_predictions(state, Images(), tmp_path)
    from deep_spectral_tpu_torch.utils.serialization import load_segmap_png
    for image, _, _, stem in Images.items:
        pred = load_segmap_png(tmp_path / "pred" / f"{stem}.png")
        H, W = (image.shape[0] // 16) * 16, (image.shape[1] // 16) * 16
        assert pred.shape == (H, W)
        want = TSS.eval_step(state, torch.from_numpy(
            TSS.normalize_image(image[:H, :W]))[None])[0].numpy()
        np.testing.assert_array_equal(pred, want)
    assert not any((tmp_path / "gt").iterdir())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
