"""Task CLI of the port.

  python -m deep_spectral_tpu_torch.tasks.cli semantic_train [cfg overrides]

YAML + key=value overrides, mirroring the JAX package's
`deep_spectral_tpu.tasks.cli semantic_train` (and the reference's hydra
command); the default config is `configs/semantic_train.yaml`. One key is the
port's own: `device=cuda|cpu` (default: cuda, which raises RuntimeError when
there is no card; pass `device=cpu` to train on the CPU). The JAX CLI's other
tasks (localization, object_segmentation, semantic_eval, semantic_generate)
are not ported yet: they exit with the usage line.
"""
from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"
NOT_PORTED = ("localization", "object_segmentation", "semantic_eval", "semantic_generate")


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
    tcfg = SS.TrainConfig(
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
    _, best = SS.train(tcfg, train_ds, val_ds, ckpt_dir=cfg.checkpoint.dir,
                       eval_every=cfg.eval_every,
                       resume=cfg.checkpoint.get("resume"), device=cfg.get("device"))
    print(f"best mIoU: {best:.4f}")
    return best


TASKS = {"semantic_train": semantic_train}


def main(argv=None) -> int:
    """Run the task named by argv[0]; 0 when it ran, 2 with the usage line."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TASKS:
        if argv and argv[0] in NOT_PORTED:
            print(f"{argv[0]} is not ported to deep_spectral_tpu_torch yet",
                  file=sys.stderr)
        print(f"usage: python -m deep_spectral_tpu_torch.tasks.cli "
              f"<{'/'.join(TASKS)}> [key=value ...]", file=sys.stderr)
        return 2
    TASKS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
