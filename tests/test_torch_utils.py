"""The port's copies of the numpy-only host modules (sizes, bucketing,
image_io, serialization) against the JAX package's originals, on the same
inputs: results must be identical (same numpy code, same data)."""
import numpy as np
import pytest
import torch
from PIL import Image

from deep_spectral_tpu.utils import bucketing as j_bucketing
from deep_spectral_tpu.utils import image_io as j_image_io
from deep_spectral_tpu.utils import serialization as j_ser
from deep_spectral_tpu.utils import sizes as j_sizes
from deep_spectral_tpu_torch.utils import bucketing as t_bucketing
from deep_spectral_tpu_torch.utils import image_io as t_image_io
from deep_spectral_tpu_torch.utils import serialization as t_ser
from deep_spectral_tpu_torch.utils import sizes as t_sizes


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("shape,P,ds", [((1, 3, 480, 480), 16, None),
                                        ((1, 3, 333, 517), 8, None),
                                        ((1, 3, 320, 480), 16, 8)])
def test_sizes_match(shape, P, ds):
    d = {"shape": shape, "patch_size": P}
    _same(tuple(t_sizes.get_image_sizes(d, ds)), tuple(j_sizes.get_image_sizes(d, ds)))
    assert t_sizes.patch_grid(*shape[2:], P) == j_sizes.patch_grid(*shape[2:], P)
    H, W = shape[2:]
    for n in ((H // 8) * (W // 8), (H // 16) * (W // 16)):
        assert t_sizes.infer_patch_grid(n, H, W) == j_sizes.infer_patch_grid(n, H, W)
    with pytest.raises(ValueError):
        t_sizes.get_image_sizes({"shape": (2, 3, H, W), "patch_size": P})


def test_bucketing_matches(rng):
    sizes = [tuple(int(x) for x in rng.integers(5, 40, 2)) for _ in range(23)]
    for g in (1, 4, 8):
        _same({(b.h, b.w): v for b, v in t_bucketing.group_into_buckets(sizes, g).items()},
              {(b.h, b.w): v for b, v in j_bucketing.group_into_buckets(sizes, g).items()})
    for h, w in sizes[:5]:
        tb, jb = t_bucketing.square_pow2_bucket(h, w), j_bucketing.square_pow2_bucket(h, w)
        assert (tb.h, tb.w, tb.tokens) == (jb.h, jb.w, jb.tokens)
    imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for h, w in sizes[:3]]
    _same(t_bucketing.pad_batch_images(imgs, (48, 48), 4),
          j_bucketing.pad_batch_images(imgs, (48, 48), 4))
    extents = np.asarray([[33, 17], [48, 48], [0, 0]], np.int32)
    _same(t_bucketing.token_masks(extents, t_bucketing.Bucket(6, 6), 8),
          j_bucketing.token_masks(extents, j_bucketing.Bucket(6, 6), 8))
    _same(t_bucketing.grid_masks(extents // 8, (6, 6)),
          j_bucketing.grid_masks(extents // 8, (6, 6)))
    plan_t = t_bucketing.make_batch_plan(list(range(23)), lambda i: sizes[i], batch_size=4)
    plan_j = j_bucketing.make_batch_plan(list(range(23)), lambda i: sizes[i], batch_size=4)
    _same([((b.h, b.w), x) for b, x in plan_t], [((b.h, b.w), x) for b, x in plan_j])
    got = {"t": [], "j": []}
    for key, mod in (("t", t_bucketing), ("j", j_bucketing)):
        mod.run_bucketed_prefetched(
            list(range(23)), lambda i: sizes[i], lambda b, items: sum(items),
            lambda b, items, prep, key=key: got[key].append((b.h, b.w, items, prep)),
            batch_size=5, granularity=8)
    _same(got["t"], got["j"])


def test_image_io_matches(tmp_path, rng):
    names = []
    for i, (h, w) in enumerate([(37, 51), (64, 48)]):
        names.append(f"im{i}.png")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(tmp_path / names[-1])
    (tmp_path / "list.txt").write_text("\n".join(names[::-1] + [names[0], ""]))
    assert (t_image_io.read_image_list(tmp_path / "list.txt", tmp_path)
            == j_image_io.read_image_list(tmp_path / "list.txt", tmp_path))
    for n in names:
        rgb = t_image_io.load_image_rgb(tmp_path / n)
        _same(rgb, j_image_io.load_image_rgb(tmp_path / n))
        _same(t_image_io.load_image_resized(tmp_path / n, (20, 12)),
              j_image_io.load_image_resized(tmp_path / n, (20, 12)))
        _same(t_image_io.normalize_imagenet(rgb), j_image_io.normalize_imagenet(rgb))
        _same(t_image_io.normalize_imagenet_hwc(rgb), j_image_io.normalize_imagenet_hwc(rgb))
        chw = t_image_io.normalize_imagenet(rgb)
        _same(t_image_io.denormalize_imagenet(chw), j_image_io.denormalize_imagenet(chw))
    _same(t_image_io.IMAGENET_SCALE, j_image_io.IMAGENET_SCALE)
    _same(t_image_io.IMAGENET_SHIFT, j_image_io.IMAGENET_SHIFT)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_serialization_interoperates(tmp_path, rng, writer):
    """A .pth written by either package loads identically in both."""
    obj = {"k": rng.standard_normal((1, 12, 8)).astype(np.float16),
           "indices": np.asarray([3]), "file": "a.jpg", "id": "a",
           "model_name": "dino_vits16", "patch_size": 16, "shape": (1, 3, 48, 64),
           "eigenvalues": rng.random(5).astype(np.float32)}
    path = tmp_path / "x.pth"
    (t_ser if writer == "port" else j_ser).save_pth(obj, path)
    _same(t_ser.load_pth(path), j_ser.load_pth(path))
    _same(t_ser.load_pth(path), obj)
    _same(t_ser.load_pth_meta(path), j_ser.load_pth_meta(path))
    seg = rng.integers(0, 4, (9, 7)).astype(np.uint8)
    t_ser.save_segmap_png(seg, tmp_path / "s.png")
    _same(j_ser.load_segmap_png(tmp_path / "s.png"), t_ser.load_segmap_png(tmp_path / "s.png"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
