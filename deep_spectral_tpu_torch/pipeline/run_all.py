"""One-command pipeline runner of the port: stages 1-9 (and the single-region
CRF) chained over the canonical data layout, with a per-stage timing summary.
The port of `deep_spectral_tpu.pipeline.run_all`.

The reference needs ten manual CLI invocations with hand-threaded paths
(README.md's recipe); this module runs them over the layout
data/<DATASET>/{features,eigs,...} and prints a `StageTimer` summary.

    python -m deep_spectral_tpu_torch.pipeline.run_all \\
        --images_list data/VOC2012/lists/images.txt \\
        --images_root data/VOC2012/images \\
        --output_root data/VOC2012 \\
        --model_name dino_vits16 --K 5 --num_clusters 21 --pca_dim 32

The stages that use the card (1-3, 6, 7, 9) run on `--device` (default
cuda, which raises without a card; `--device cpu` runs them on the CPU).
"""
from __future__ import annotations

import argparse
import inspect
from pathlib import Path

from . import extract as stages
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer, trace


def run_all(
    images_list: str,
    images_root: str,
    output_root: str,
    model_name: str = "dino_vits16",
    K: int = 5,
    image_color_lambda: float = 0.0,
    non_adaptive_num_segments: int = 4,
    num_erode: int = 2,
    num_dilate: int = 3,
    num_clusters: int = 20,
    pca_dim: int = 0,
    crf_num_classes: int = 21,
    batch_size: int = 16,
    feature_batch_size: int = 16,
    downsample_factor: int = 16,
    precision: str = "bf16",
    trace_dir: str | None = None,
    stop_after: str | None = None,
    device: str = "cuda",
) -> dict:
    """Runs features -> eigs -> multi/single-region -> bboxes -> bbox features
    -> clusters -> semantic -> CRF. Returns the output directory map.

    stop_after: stage name ('extract_features', 'extract_eigs', 'multi_region',
    'single_region', 'bboxes', 'bbox_features', 'bbox_clusters',
    'semantic_segmaps', 'crf') after which to stop — e.g. 'extract_eigs' for
    the localization recipe, which only consumes eigs. trace_dir: a
    torch.profiler trace of the whole run, written there."""
    resolve_device(device, "run_all")
    root = Path(output_root)
    n_images = len([ln for ln in Path(images_list).read_text().splitlines()
                    if ln.strip()])
    dirs = {
        "features": root / "features" / model_name,
        "eigs": root / "eigs" / "laplacian",
        "multi": root / "multi_region_segmentation" / "fixed",
        "single": root / "single_region_segmentation" / "patches",
        "bboxes": root / "multi_region_bboxes" / "fixed" / "bboxes.pth",
        "bbox_features": root / "multi_region_bboxes" / "fixed" / "bbox_features.pth",
        "bbox_clusters": root / "multi_region_bboxes" / "fixed" / "bbox_clusters.pth",
        "semantic": root / "semantic_segmentations" / "patches" / "fixed" / "segmaps",
        "crf": root / "semantic_segmentations" / "crf" / "fixed" / "segmaps",
        "crf_single": root / "single_region_segmentation" / "crf",
    }
    plan = [
        ("extract_features", lambda: stages.extract_features(
            images_list=images_list, images_root=images_root,
            model_name=model_name, batch_size=feature_batch_size,
            output_dir=str(dirs["features"]), precision=precision, device=device)),
        ("extract_eigs", lambda: stages.extract_eigs(
            images_root=images_root, features_dir=str(dirs["features"]),
            output_dir=str(dirs["eigs"]), which_matrix="laplacian", K=K,
            image_color_lambda=image_color_lambda, batch_size=batch_size,
            device=device)),
        ("multi_region", lambda: stages.extract_multi_region_segmentations(
            features_dir=str(dirs["features"]), eigs_dir=str(dirs["eigs"]),
            output_dir=str(dirs["multi"]),
            non_adaptive_num_segments=non_adaptive_num_segments,
            batch_size=batch_size, device=device)),
        ("single_region", lambda: stages.extract_single_region_segmentations(
            features_dir=str(dirs["features"]), eigs_dir=str(dirs["eigs"]),
            output_dir=str(dirs["single"]))),
        ("bboxes", lambda: stages.extract_bboxes(
            features_dir=str(dirs["features"]),
            segmentations_dir=str(dirs["multi"]),
            output_file=str(dirs["bboxes"]),
            num_erode=num_erode, num_dilate=num_dilate)),
        ("bbox_features", lambda: stages.extract_bbox_features(
            images_root=images_root, bbox_file=str(dirs["bboxes"]),
            model_name=model_name, output_file=str(dirs["bbox_features"]),
            precision=precision, device=device)),
        ("bbox_clusters", lambda: stages.extract_bbox_clusters(
            bbox_features_file=str(dirs["bbox_features"]),
            output_file=str(dirs["bbox_clusters"]),
            num_clusters=num_clusters, pca_dim=pca_dim, device=device)),
        ("semantic_segmaps", lambda: stages.extract_semantic_segmentations(
            segmentations_dir=str(dirs["multi"]),
            bbox_clusters_file=str(dirs["bbox_clusters"]),
            output_dir=str(dirs["semantic"]))),
        ("crf", lambda: stages.extract_crf_segmentations(
            images_list=images_list, images_root=images_root,
            segmentations_dir=str(dirs["semantic"]),
            output_dir=str(dirs["crf"]), num_classes=crf_num_classes,
            downsample_factor=downsample_factor, device=device)),
        ("crf_single_region", lambda: stages.extract_crf_segmentations(
            images_list=images_list, images_root=images_root,
            segmentations_dir=str(dirs["single"]),
            output_dir=str(dirs["crf_single"]), num_classes=2,
            downsample_factor=downsample_factor, device=device)),
    ]
    stage_names = [name for name, _ in plan]
    if stop_after is not None and stop_after not in stage_names:
        raise ValueError(f"unknown stop_after {stop_after!r}; one of {stage_names}")
    timer = StageTimer()
    with trace(trace_dir):
        for name, thunk in plan:
            with timer.stage(name, n_images):
                thunk()
            if stop_after == name:
                print(f"Stopped after stage {name!r}")
                break
    print(timer.summary())
    return {k: str(v) for k, v in dirs.items()}


def main(argv=None):
    p = argparse.ArgumentParser(prog="run_all", description=run_all.__doc__)
    for name, param in inspect.signature(run_all).parameters.items():
        required = param.default is inspect.Parameter.empty
        default = None if required else param.default
        typ = type(default) if default is not None else str
        p.add_argument(f"--{name}", required=required, default=default, type=typ)
    return run_all(**vars(p.parse_args(argv)))


if __name__ == "__main__":
    main()
