"""The port's host helpers against the JAX package's, in one process: the
`utils.logging` meters, seeding and top-k accuracy, the VOC lists of
`data/`, the tensor-parallel plan, and what `parallel.distributed` and
`parallel.mesh` do with no process group or no card. Their multi-process
behaviour is held in test_torch_parallel.py (gloo workers).

Exact comparisons throughout: the helpers are host arithmetic (float64
sums, numpy statistics, a stable argsort) that both packages do alike.
"""
import json

import jax
import numpy as np
import pytest
import torch

from deep_spectral_tpu import data as j_data
from deep_spectral_tpu.models.vit import ViTConfig as JViTConfig
from deep_spectral_tpu.models.vit import init_vit_params
from deep_spectral_tpu.parallel import distributed as j_dist
from deep_spectral_tpu.parallel.mesh import make_mesh as j_make_mesh
from deep_spectral_tpu.parallel.sharded import tensor_parallel_param_shardings as j_plan
from deep_spectral_tpu.utils import logging as j_log
from deep_spectral_tpu_torch import data as t_data
from deep_spectral_tpu_torch.models.vit import VisionTransformer, ViTConfig
from deep_spectral_tpu_torch.parallel import distributed as t_dist
from deep_spectral_tpu_torch.parallel.mesh import make_mesh
from deep_spectral_tpu_torch.parallel.sharded import tensor_parallel_param_shardings
from deep_spectral_tpu_torch.pipeline.extract import shard_across_processes
from deep_spectral_tpu_torch.utils import logging as t_log


def _fill(mod, values):
    v = mod.SmoothedValue(window_size=3)
    for x in values:
        v.update(x, n=2)
    return v


def test_smoothed_value_matches_jax():
    values = [1.5, 2.0, -3.25, 4.0, 0.5]
    j, t = _fill(j_log, values), _fill(t_log, values)
    for name in ("median", "avg", "global_avg", "max", "value", "count", "total"):
        assert getattr(t, name) == getattr(j, name), name
    assert str(t) == str(j)
    t.synchronize_between_processes()  # no group: a no-op, as JAX's at one process
    assert (t.count, t.total) == (j.count, j.total)


def test_metric_logger_matches_jax(capsys):
    out = {}
    for mod in (j_log, t_log):
        logger = mod.MetricLogger()
        seen = [x for x in logger.log_every(range(5), print_freq=2, header="h")
                if logger.update(loss=x, acc=2 * x) is None]
        logger.add_meter("lr", mod.SmoothedValue(fmt="{value:.3f}"))
        logger.lr.update(0.5)
        logger.synchronize_between_processes()
        printed = capsys.readouterr().out
        out[mod] = (seen, str(logger), [line.split(" eta")[0] for line in printed.splitlines()
                                        if line.startswith("h [")])
        with pytest.raises(AttributeError):
            logger.missing  # noqa: B018
    assert out[t_log] == out[j_log]


@pytest.mark.parametrize("offset", [True, False])
def test_set_seed_matches_jax(offset):
    """Rank 0 (one process): the same python, numpy and Generator draws."""
    import random
    draws = []
    for mod in (j_log, t_log):
        g = mod.set_seed(7, process_offset=offset)
        draws.append((g.integers(0, 1000, 4).tolist(), random.random(), np.random.rand()))
    assert draws[0] == draws[1]
    t_log.set_seed(7)  # torch is seeded too
    first = torch.rand(3)
    t_log.set_seed(7)
    assert torch.equal(first, torch.rand(3))


def test_topk_accuracy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 10)).astype(np.float32)
    logits[:8, :3] = 1.0  # ties: the lower class ranks first in both
    targets = rng.integers(0, 10, 64)
    for topk in ((1,), (1, 2, 5)):
        assert t_log.topk_accuracy(logits, targets, topk) == \
            j_log.topk_accuracy(logits, targets, topk)
    assert t_log.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(targets), (3,)) == \
        j_log.topk_accuracy(logits, targets, (3,))


def test_metric_writer_matches_jax(tmp_path):
    for mod, name in ((j_log, "j.jsonl"), (t_log, "t.jsonl")):
        w = mod.MetricWriter(tmp_path / name)
        w.log(0, loss=1.5, acc=np.float32(0.2))
        w.log(3, miou=torch.tensor(0.25).item())
        w.close()
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert json.loads((tmp_path / "t.jsonl").read_text().splitlines()[1]) == \
        {"step": 3, "miou": 0.25}


def test_setup_distributed_print(capsys, monkeypatch):
    import builtins
    monkeypatch.setattr(builtins, "print", builtins.print)
    t_log.setup_distributed_print(False)
    print("hidden")
    print("shown", force=True)
    t_log.setup_distributed_print(True)
    assert capsys.readouterr().out == "shown\n"


@pytest.mark.parametrize("dataset", ["VOC2007", "VOC2012"])
def test_voc_lists_match_jax(dataset):
    """The port's own copies: the same bytes, checksums and names, read from
    the port's package directory."""
    assert t_data.VOC_LIST_SHA256 == j_data.VOC_LIST_SHA256
    assert t_data.VOC_LIST_LENGTHS == j_data.VOC_LIST_LENGTHS
    path = t_data.voc_list_path(dataset)
    assert "deep_spectral_tpu_torch" in path.parts
    assert path.read_bytes() == j_data.voc_list_path(dataset).read_bytes()
    names = t_data.voc_image_list(dataset)
    assert names == j_data.voc_image_list(dataset)
    assert len(names) == t_data.VOC_LIST_LENGTHS[dataset]
    with pytest.raises(KeyError):
        t_data.voc_list_path("VOC2010")


def test_corrupt_voc_list_rejected(tmp_path, monkeypatch):
    bad = tmp_path / "VOC2007" / "lists"
    bad.mkdir(parents=True)
    (bad / "images.txt").write_text("tampered.jpg\n")
    monkeypatch.setattr(t_data, "_DATA_DIR", tmp_path)
    with pytest.raises(ValueError, match="corrupt"):
        t_data.voc_image_list("VOC2007")
    assert t_data.voc_image_list("VOC2007", verify=False) == ["tampered.jpg"]


def _torch_name(flax_path: str) -> str:
    """'params/blocks_0/attn/qkv/kernel' -> 'blocks.0.attn.qkv.weight'."""
    parts = flax_path.split("/")[1:]
    if parts[0].startswith("blocks_"):
        parts = ["blocks", parts[0][len("blocks_"):], *parts[1:]]
    elif parts[0] == "patch_embed":
        parts = ["patch_embed", "proj", *parts[1:]]
    if len(parts) == 1:
        return parts[0]
    return ".".join([*parts[:-1], {"kernel": "weight", "scale": "weight"}.get(parts[-1],
                                                                             parts[-1])])


def test_tensor_parallel_plan_matches_jax():
    """The port's plan names JAX's shardings: column for P(None, axis)
    kernels and their P(axis) biases (a torch Linear's weight rows), row for
    P(axis, None) kernels (its columns), replicated for P()."""
    cfg = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)
    params = init_vit_params(JViTConfig(**cfg), seed=0)[1]
    P = jax.sharding.PartitionSpec
    labels = {P(None, "model"): "column", P("model"): "column", P("model", None): "row"}
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            j_plan(j_make_mesh(2, axes=[("model", 2)]), params))[0]:
        name = _torch_name("/".join(str(getattr(k, "key", k)) for k in path))
        want[name] = labels.get(sharding.spec, "replicated")
    model = VisionTransformer(ViTConfig(**cfg))
    assert tensor_parallel_param_shardings(model) == want
    assert tensor_parallel_param_shardings(model.state_dict()) == want
    assert sorted(set(want.values())) == ["column", "replicated", "row"]


def test_distributed_without_a_group():
    """No group and no torchrun environment: initialize joins nothing, and
    the helpers act for one process, as the JAX ones do at one process."""
    assert t_dist.initialize() is False
    assert (t_dist.process_index(), t_dist.process_count()) == (0, 1)
    assert t_dist.is_master() == j_dist.is_master()
    assert t_dist.all_sum_scalar(2.5) == j_dist.all_sum_scalar(2.5) == 2.5
    assert t_dist.all_sum_host([1, 2.5]) == [1.0, 2.5]
    t_dist.barrier("single")
    assert shard_across_processes(list(range(5))) == list(range(5))
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        t_dist.initialize("localhost:1", 1, 0, device_type="tpu")
    with pytest.raises(ValueError, match="num_processes"):
        t_dist.initialize("localhost:1", device_type="cpu")


@pytest.mark.parametrize("call", ["initialize", "make_mesh"])
def test_cuda_group_without_a_card_raises(monkeypatch, call):
    """The parallel entry points default to CUDA and never fall back to gloo
    or the CPU: with no card they raise before any group is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("a group came up without a card"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if call == "initialize":
            t_dist.initialize("localhost:1", 1, 0)
        else:
            make_mesh()


@pytest.mark.parametrize("impl,device,want", [("auto", "cuda", "flash"), ("auto", "cpu", "einsum"),
                                              ("einsum", "cuda", "einsum"),
                                              ("flash", "cpu", "flash")])
def test_ring_impl_resolves_from_the_device(impl, device, want):
    """The ring's default impl, 'auto', is kernel 3's flash hops for CUDA
    tensors and the einsum hops on the CPU; an explicit impl is kept."""
    from deep_spectral_tpu_torch.parallel.ring_attention import resolve_impl
    assert resolve_impl(impl, torch.device(device)) == want
    with pytest.raises(ValueError, match="impl"):
        resolve_impl("pallas", torch.device(device))
