"""Worker for tests/test_torch_parallel.py: one process of a gloo group on
the CPU, which runs every case of the port's parallel paths at its world
size and saves its rank's results.

Usage: python test_torch_parallel_worker.py <rank> <world> <port> <inputs.pt> <out_dir>

The inputs (numpy-seeded tensors, the JAX models' weights as the port's
state dicts) come from the test module; the train step's (the JAX train
state's weights and the dropout keep-mask JAX drew) arrive later, in
<out_dir>/train_inputs.pt, which the test writes while the workers run
the other cases. A case that raises stores its traceback under its name,
so the test that reads it reports it. Imports no JAX. It defines no test
of its own, so pytest collects nothing from it.
"""
import json
import sys
import time
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deep_spectral_tpu_torch.models import deeplab as t_deeplab  # noqa: E402
from deep_spectral_tpu_torch.models.vit import VisionTransformer, ViTConfig  # noqa: E402
from deep_spectral_tpu_torch.parallel import distributed  # noqa: E402
from deep_spectral_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, local_rows,  # noqa: E402
                                                   make_mesh)
from deep_spectral_tpu_torch.parallel.pp_vit import build_stage, pp_vit_forward  # noqa: E402
from deep_spectral_tpu_torch.parallel.ring_attention import ring_attention_sharded  # noqa: E402
from deep_spectral_tpu_torch.parallel.sharded import (  # noqa: E402
    row_sharded_laplacian_eigs, sharded_patch_features, sharded_spectral_decompose,
    tp_sharded_patch_features)
from deep_spectral_tpu_torch.parallel.sp_vit import sp_patch_features, sp_vit_forward  # noqa: E402
from deep_spectral_tpu_torch.tasks import semantic_segmentation as TSS  # noqa: E402

TRAIN_INPUTS_WAIT = 300  # seconds


def _vit(inputs, key, dtype=torch.float32):
    model = VisionTransformer(ViTConfig(**inputs[key + "_cfg"]), dtype)
    model.load_state_dict(inputs[key + "_sd"])
    return model.eval()


def _raises(exc, fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except exc as e:
        return str(e)
    return None


def ring_cases(I, world, mesh):
    out = {}
    for impl in ("einsum", "flash"):
        for name, mask in (("full", None), ("ragged", I["ring_mask"])):
            out[f"ring_{impl}_{name}"] = lambda impl=impl, mask=mask: ring_attention_sharded(
                mesh, I["ring_q"], I["ring_k"], I["ring_v"], mask, impl=impl)
    # no impl: 'auto', which is 'einsum' on the CPU
    out["ring_auto_ragged"] = lambda: ring_attention_sharded(
        mesh, I["ring_q"], I["ring_k"], I["ring_v"], I["ring_mask"])
    if world > 1:
        x = torch.zeros((1, 63, 1, 8))
        out["ring_indivisible"] = lambda: _raises(ValueError, ring_attention_sharded, mesh, x, x, x)
    return out


def sp_cases(I, mesh):
    """Masked inputs throughout (image 0's last 24 patches are padding)."""
    m32, m16 = _vit(I, "sp"), _vit(I, "sp", torch.bfloat16)
    x, m = I["sp_x"], I["sp_mask"]
    return {
        "sp_keys": lambda: sp_patch_features(mesh, m32, x, m, attn_impl="einsum"),
        "sp_keys_flash": lambda: sp_patch_features(mesh, m32, x, m, attn_impl="flash"),
        "sp_keys_block0": lambda: sp_patch_features(mesh, m32, x, m, which_block=0,
                                                    attn_impl="einsum"),
        "sp_fwd": lambda: sp_vit_forward(mesh, m32, x, m, n_intermediates=2,
                                         attn_impl="einsum"),
        "sp_keys_bf16": lambda: sp_patch_features(mesh, m16, x, m, attn_impl="flash"),
        "sp_fwd_bf16": lambda: sp_vit_forward(mesh, m16, x, m, attn_impl="flash"),
        "sp_fwd_b1": lambda: sp_vit_forward(mesh, m32, x[:1], m[:1], n_intermediates=2,
                                            attn_impl="einsum"),
    }


def pp_cases(I, mesh, world):
    """Every case on one batch of 4 (images 0-1 ragged, 2-3 whole)."""
    cfg, sd = ViTConfig(**I["pp_cfg"]), I["pp_sd"]
    stage = build_stage(cfg, sd, mesh, attention_impl="einsum", device="cpu")
    flash = build_stage(cfg, sd, mesh, attention_impl="flash", device="cpu")
    bf16 = build_stage(cfg, sd, mesh, compute_dtype=torch.bfloat16, attention_impl="flash",
                       device="cpu")
    x, m = I["pp_x"], I["pp_mask"]
    out = {f"pp_m{M}": lambda M=M: pp_vit_forward(mesh, stage, x, m, n_microbatches=M)
           for M in (1, 2, 4)}
    out.update({
        "pp_flash": lambda: pp_vit_forward(mesh, flash, x, m, n_microbatches=2),
        "pp_bf16": lambda: pp_vit_forward(mesh, bf16, x, m, n_microbatches=2),
        "pp_params": lambda: sum(p.numel() for p in stage.parameters()),
        "pp_bad_batch": lambda: _raises(ValueError, pp_vit_forward, mesh, stage, x[:3],
                                        n_microbatches=2),
    })
    if world > 1:
        out["pp_bad_depth"] = lambda: _raises(
            ValueError, build_stage, ViTConfig(**{**I["pp_cfg"], "depth": 3}), sd, mesh,
            device="cpu")
    return out


def dp_cases(I, world):
    """PP x DP and TP x DP on a (data, model) mesh; DP features and eigs,
    and TP over every rank, on a 1-D data mesh."""
    dmesh = make_mesh(axes=[(DATA_AXIS, world)], device_type="cpu")
    dp = min(world, 2)
    mesh2 = make_mesh(axes=[(DATA_AXIS, dp), (MODEL_AXIS, world // dp)], device_type="cpu")
    d = mesh2.get_local_rank(DATA_AXIS)
    stage = build_stage(ViTConfig(**I["pp_cfg"]), I["pp_sd"], mesh2, attention_impl="einsum",
                        device="cpu")
    tp_model, feats_model = _vit(I, "tp"), _vit(I, "dpf")
    tp_rows = local_rows(mesh2.get_group(DATA_AXIS), torch.arange(4))
    data = dmesh.get_group(DATA_AXIS)
    return {
        # JAX's microbatch sharding P(None, data) of (M=2, mb=2) rows: data
        # row d of dp holds rows d, d + dp, ... of the batch
        "ppdp": lambda: pp_vit_forward(mesh2, stage, I["pp_x"][d::dp], I["pp_mask"][d::dp],
                                       n_microbatches=2),
        "tp_keys": lambda: tp_sharded_patch_features(mesh2, tp_model, I["tp_x"][tp_rows],
                                                     I["tp_mask"][tp_rows]),
        "tp_keys_1d": lambda: tp_sharded_patch_features(dmesh, tp_model, I["tp_x"],
                                                        I["tp_mask"]),
        "dp_keys": lambda: sharded_patch_features(
            dmesh, feats_model, local_rows(data, I["dpf_x"]), local_rows(data, I["dpf_mask"])),
        "dp_eigs": lambda: sharded_spectral_decompose(
            dmesh, local_rows(data, I["eig_feats"]), local_rows(data, I["eig_masks"]), K=4),
    }


def row_cases(I, mesh):
    group = mesh.get_group(MODEL_AXIS)
    return {
        "row_eigs": lambda: row_sharded_laplacian_eigs(
            mesh, local_rows(group, I["row_W"]), 4, iters=200, x0=I["row_x0"]),
        "row_eigs_masked": lambda: row_sharded_laplacian_eigs(
            mesh, local_rows(group, I["row_Wp"]), 4, iters=200,
            mask=local_rows(group, I["row_mask"]), x0=I["row_x0"]),
    }


def helper_cases(rank):
    from deep_spectral_tpu_torch.pipeline.extract import shard_across_processes
    from deep_spectral_tpu_torch.utils.logging import MetricLogger, SmoothedValue

    def run():
        items = shard_across_processes(list(range(10)))
        all_sum = distributed.all_sum_scalar(float(rank + 1))
        distributed.barrier("test_torch_parallel")
        sv = SmoothedValue()
        for v in range(rank + 2):  # rank 0 updates {0, 1}, rank 1 {0, 1, 2}, ...
            sv.update(float(v))
        sv.synchronize_between_processes()
        logger = MetricLogger()
        logger.update(loss=float(rank))
        logger.synchronize_between_processes()
        return {"items": items, "all_sum": all_sum, "is_master": distributed.is_master(),
                "sv_count": sv.count, "sv_total": sv.total,
                "logger": (logger.loss.count, logger.loss.total)}
    return {"helpers": run}


def train_loop_cases(I, world, rank, out_dir):
    """`train(mesh=...)`: 3 steps over the VOC tree, an eval after step 2,
    the best checkpoint; every rank returns its final state, and rank 0
    its metric log's losses."""
    cfg = TSS.TrainConfig(backbone=ViTConfig(**I["train_vit"]), **I["loop_cfg"])
    root = Path(I["voc_root"])
    ds = TSS.VOCSegmentationWithPseudolabels(str(root), "train", str(root / "pseudo"))
    val = TSS.VOCSegmentationWithPseudolabels(str(root), "val", str(root / "pseudo"))

    def run(mesh):
        ck = out_dir / f"ckpt_w{world}_{'mesh' if mesh else 'single'}"
        metrics = ck / f"metrics_r{rank}.jsonl"
        state, best = TSS.train(cfg, ds, val, ckpt_dir=str(ck), eval_every=2, log_every=1,
                                max_steps=3, metrics_path=str(metrics),
                                device="cpu" if mesh is None else None, mesh=mesh)
        records = [json.loads(line) for line in metrics.read_text().splitlines()] \
            if metrics.is_file() else []
        return {"best": best, "step": int(state.step),
                "losses": [r["loss"] for r in records if "loss" in r],
                "params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
                "files": sorted(p.name for p in ck.iterdir()) if ck.is_dir() else []}

    out = {"loop_mesh": lambda: run(make_mesh(device_type="cpu"))}
    if world == 1:
        out["loop_single"] = lambda: run(None)
    return out


def train_cases(I, world, rank, out_dir):
    """One data-parallel train step on the global batch's rank block, with
    the global dropout keep-mask's rank block (the JAX step's); and at world
    1 the plain step from the same weights."""
    cfg = TSS.TrainConfig(backbone=ViTConfig(**I["train_vit"]), **I["train_cfg"])
    b = cfg.batch_size // world
    rows = slice(rank * b, (rank + 1) * b)
    loaded = {}

    def inputs():
        if not loaded:
            path, t0 = out_dir / "train_inputs.pt", time.monotonic()
            while not path.is_file():
                if time.monotonic() - t0 > TRAIN_INPUTS_WAIT:
                    raise TimeoutError(f"{path} did not appear")
                time.sleep(0.2)
            loaded.update(torch.load(path, weights_only=False))
        return loaded

    def step(data_parallel):
        T = inputs()
        state = TSS.create_train_state(
            cfg, t_deeplab.DeepLabViT(cfg.backbone, 3, attention_impl="flash"), device="cpu")
        state.model.load_state_dict(T["train_sd"])
        if data_parallel:
            TSS.make_data_parallel(state, make_mesh(device_type="cpu").get_group(DATA_AXIS))
        keep, dropout = T["train_keep"][rows], t_deeplab.dropout
        t_deeplab.dropout = lambda v, rate, gen, group=None: torch.where(keep, v / (1 - rate), 0.0)
        try:
            logs = TSS.train_step(state, T["train_x"][rows], T["train_y"][rows])
        finally:
            t_deeplab.dropout = dropout
        return {"loss": logs["loss"], "acc": logs["acc"],
                "grads": {n: p.grad.clone() for n, p in state.opt.params.items()},
                "buffers": {n: x.clone() for n, x in state.model.named_buffers()},
                "params": {n: p.detach().clone() for n, p in state.model.named_parameters()}}

    out = {"train_dp": lambda: step(True)}
    if world == 1:
        out["train_plain"] = lambda: step(False)
    return out


def main() -> None:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    inputs, out_dir = sys.argv[4], Path(sys.argv[5])
    torch.set_num_threads(1)
    assert distributed.initialize(f"localhost:{port}", world, rank, device_type="cpu")
    I = torch.load(inputs, weights_only=False)
    mesh = make_mesh(axes=[(MODEL_AXIS, world)], device_type="cpu")
    cases = ring_cases(I, world, mesh)
    cases.update(sp_cases(I, mesh))
    cases.update(pp_cases(I, mesh, world))
    cases.update(dp_cases(I, world))
    cases.update(row_cases(I, mesh))
    cases.update(helper_cases(rank))
    if world <= 2:  # the train batch is 2 images
        cases.update(train_loop_cases(I, world, rank, out_dir))
        cases.update(train_cases(I, world, rank, out_dir))
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:  # the test of this case reports it
            out[name] = {"error": traceback.format_exc()}
    torch.save(out, out_dir / f"w{world}_r{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
