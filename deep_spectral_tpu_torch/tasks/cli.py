"""Task CLI of the port.

  python -m deep_spectral_tpu_torch.tasks.cli localization \
      --eigenseg --precomputed_eigs_dir E --dataset VOC12 --dataset_root R
      (argparse flags of the JAX CLI, object-localization/main.py:26-131,
      plus --device)
  python -m deep_spectral_tpu_torch.tasks.cli object_segmentation \
      predictions.root=... datasets.ECSSD.images_dir=... datasets.ECSSD.labels_dir=...
  python -m deep_spectral_tpu_torch.tasks.cli semantic_eval [cfg overrides]
  python -m deep_spectral_tpu_torch.tasks.cli semantic_train [cfg overrides]
  python -m deep_spectral_tpu_torch.tasks.cli semantic_generate \
      --checkpoint CK --output_dir OUT [--max_images N] [cfg overrides]

The YAML tasks take `--config` plus key=value overrides, mirroring the JAX
package's `deep_spectral_tpu.tasks.cli` (and the reference's hydra
commands); their default configs are the copies in `configs/`. The port's
own option chooses the device, `device=cuda|cpu` for the YAML tasks and
`--device cuda|cpu` for localization (default: cuda, which raises
RuntimeError when there is no card). Localization's on-the-fly ViT runs in
f32, as the JAX CLI's does. `semantic_eval`'s overlays (`visualize`, 40 by
default) need matplotlib; `visualize=0` skips them. `semantic_generate`
restores one of `semantic_train`'s `.pt` checkpoints (a file, or a directory:
its newest step_*.pt, else best.pt) under the same config and writes the
model's predictions on the val split.
"""
from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def localization(argv) -> float:
    """CorLoc of eigenseg (from precomputed eigs or on the fly), LOST or
    dino_seg over a VOC or COCO20k split; returns the score."""
    from . import localization as L
    p = argparse.ArgumentParser(prog="localization")
    p.add_argument("--dataset", default="VOC12", choices=["VOC07", "VOC12", "COCO20k"])
    p.add_argument("--set", default="trainval", dest="image_set")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--eigenseg", action="store_true")
    p.add_argument("--lost", action="store_true")
    p.add_argument("--dino_seg", action="store_true")
    p.add_argument("--precomputed_eigs_dir", default=None)
    p.add_argument("--which_matrix", default="laplacian")
    p.add_argument("--model_name", default="dino_vits16")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--remove_hards", action="store_true")
    p.add_argument("--output_dir", default="./outputs/localization")
    p.add_argument("--coco_annotations", default=None,
                   help="COCO instances json (default: "
                        "<dataset_root>/annotations/instances_train2014.json)")
    p.add_argument("--coco20k_list", default=None,
                   help="LOST's published sel_20k file-name list; without it a "
                        "seeded 20k fallback subset is used (not paper-comparable)")
    p.add_argument("--keep_iscrowd", action="store_true",
                   help="keep crowd GT boxes (the reference removes them by "
                        "default, datasets.py:217)")
    p.add_argument("--device", default="cuda",
                   help="device of the on-the-fly ViT and solve (cuda or cpu)")
    a = p.parse_args(argv)
    if a.dataset == "COCO20k":
        root = Path(a.dataset_root)
        ann_json = a.coco_annotations or str(
            root / "annotations" / "instances_train2014.json")
        images_dir = next((root / d for d in ("train2014", "images")
                           if (root / d).is_dir()), root)
        ids = L.select_coco_20k(ann_json, sel_file=a.coco20k_list)
        pairs = L.load_coco_detection(images_dir, ann_json, subset_ids=ids,
                                      remove_iscrowd=not a.keep_iscrowd)
    else:
        year = {"VOC07": "2007", "VOC12": "2012"}[a.dataset]
        pairs = L.load_voc_detection(a.dataset_root, year=year, image_set=a.image_set)
    method = "lost" if a.lost else "dino_seg" if a.dino_seg else "eigenseg"
    model, patch_size = None, 16
    if a.precomputed_eigs_dir is None or method != "eigenseg":
        from ..models.convert import load_model
        from ..models.vit import get_model_config
        model = load_model(a.model_name, a.ckpt_dir, device=a.device)
        patch_size = get_model_config(a.model_name).patch_size
    score, _, _ = L.evaluate_corloc(
        pairs, a.precomputed_eigs_dir if method == "eigenseg" else None,
        which_matrix=a.which_matrix, output_dir=a.output_dir,
        remove_hards=a.remove_hards, method=method, model=model,
        patch_size=patch_size)
    return score


def object_segmentation(argv) -> dict:
    """Accuracy and IoU of single-region masks for every dataset of the
    config with an `images_dir`; returns {dataset: results}."""
    from ..utils.config import load_config
    from . import object_segmentation as OS
    p = argparse.ArgumentParser(prog="object_segmentation")
    p.add_argument("--config", default=str(CONFIG_DIR / "object_segmentation_eval.yaml"))
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    cfg = load_config(a.config, a.overrides)
    results = {}
    for name, ds in cfg.datasets.items():
        if not ds.get("images_dir"):
            continue
        pred_dir = Path(cfg.predictions.root) / cfg.predictions.get("run", "") / name
        if not pred_dir.is_dir():
            pred_dir = Path(cfg.predictions.root)
        print(f"== {name} ==")
        results[name] = OS.evaluate_predictions(
            ds.images_dir, ds.labels_dir, pred_dir,
            downsample=cfg.predictions.get("downsample"),
            crop=bool(ds.get("crop", False)), device=cfg.get("device"))
    return results


def semantic_eval(argv) -> tuple:
    """mIoU of pseudolabel segmaps under Hungarian or majority-vote
    matching; returns (miou, match)."""
    from ..utils.config import load_config
    from . import semantic_segmentation as SS
    p = argparse.ArgumentParser(prog="semantic_eval")
    p.add_argument("--config", default=str(CONFIG_DIR / "semantic_eval.yaml"))
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    cfg = load_config(a.config, a.overrides)
    ds = SS.VOCSegmentationWithPseudolabels(
        cfg.data.root, cfg.data.image_set, cfg.segments_dir)
    miou, _, match = SS.evaluate_segments(
        ds, n_clusters=cfg.n_clusters, num_classes=cfg.data.num_classes + 1,
        device=cfg.get("device"))
    print(f"mIoU: {miou * 100:.2f}")
    print(f"matching: {match}")
    if cfg.get("visualize"):
        SS.visualize_overlays(ds, match, Path(cfg.output_dir) / "vis",
                              max_images=int(cfg.visualize))
    return miou, match


def _train_config(cfg):
    """The `TrainConfig` of a semantic_train config."""
    from . import semantic_segmentation as SS
    return SS.TrainConfig(
        backbone=cfg.backbone, num_classes=cfg.data.num_classes + 1,
        lr=cfg.lr, weight_decay=cfg.optimizer.weight_decay,
        max_train_steps=cfg.max_train_steps,
        warmup_steps=cfg.scheduler.warmup_steps,
        unfrozen_backbone_layers=cfg.unfrozen_backbone_layers,
        gradient_accumulation_steps=cfg.gradient_accumulation_steps,
        clip_grad_norm=cfg.optimizer.clip_grad_norm,
        use_ema=cfg.ema.use_ema, ema_decay=cfg.ema.decay,
        crop_size=cfg.data.transform.crop_size,
        resize_size=cfg.data.transform.resize_size,
        batch_size=cfg.data.loader.batch_size, seed=cfg.seed,
        precision=cfg.get("precision", "fp32"),
        num_workers=int(cfg.data.loader.get("num_workers", 4)))


def semantic_train(argv) -> float:
    """Self-train DeepLab on pseudolabels; returns the best val mIoU."""
    from ..utils.config import load_config
    from . import semantic_segmentation as SS
    p = argparse.ArgumentParser(prog="semantic_train")
    p.add_argument("--config", default=str(CONFIG_DIR / "semantic_train.yaml"))
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    cfg = load_config(a.config, a.overrides)
    matching = None
    if cfg.get("matching"):
        # The reference eval()s this value (dataset/__init__.py:50);
        # literal_eval accepts the same list-of-pairs syntax.
        matching = dict(ast.literal_eval(str(cfg.matching)))
        print(f"Using matching: {matching}")
    train_ds = SS.VOCSegmentationWithPseudolabels(
        cfg.data.root, cfg.data.train_image_set, cfg.segments_dir, label_map=matching)
    val_ds = SS.VOCSegmentationWithPseudolabels(
        cfg.data.root, cfg.data.val_image_set, cfg.segments_dir, label_map=matching)
    _, best = SS.train(_train_config(cfg), train_ds, val_ds, ckpt_dir=cfg.checkpoint.dir,
                       eval_every=cfg.eval_every,
                       resume=cfg.checkpoint.get("resume"), device=cfg.get("device"))
    print(f"best mIoU: {best:.4f}")
    return best


def semantic_generate(argv) -> str:
    """Dump a trained model's predictions (and GT) on the val split as PNGs:
    the reference's `job_type=generate` (train.py:351-388). Restores a
    checkpoint of `semantic_train` built from the same config, then runs the
    bucketed (ViT) or per-image (ResNet) prediction; returns output_dir."""
    from ..utils.config import load_config
    from . import semantic_segmentation as SS
    p = argparse.ArgumentParser(prog="semantic_generate")
    p.add_argument("--config", default=str(CONFIG_DIR / "semantic_train.yaml"))
    p.add_argument("--checkpoint", required=True,
                   help="a .pt checkpoint of semantic_train, or its checkpoint dir")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    cfg = load_config(a.config, a.overrides)
    ds = SS.VOCSegmentationWithPseudolabels(
        cfg.data.root, cfg.data.val_image_set, cfg.segments_dir)
    tcfg = _train_config(cfg)
    state = SS.create_train_state(tcfg, SS.build_model(tcfg), device=cfg.get("device"))
    state = SS.restore_checkpoint(a.checkpoint, state)
    SS.generate_predictions(state, ds, a.output_dir, max_images=a.max_images,
                            patch_size=SS._backbone_patch_size(tcfg))
    return a.output_dir


TASKS = {"localization": localization, "object_segmentation": object_segmentation,
         "semantic_eval": semantic_eval, "semantic_train": semantic_train,
         "semantic_generate": semantic_generate}


def main(argv=None) -> int:
    """Run the task named by argv[0]; 0 when it ran, 2 with the usage line."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TASKS:
        print(f"usage: python -m deep_spectral_tpu_torch.tasks.cli "
              f"<{'/'.join(TASKS)}> [flags or key=value ...]", file=sys.stderr)
        return 2
    TASKS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
