"""Command-line entry point for the port's pipeline stages.

    python -m deep_spectral_tpu_torch.pipeline extract_features \
        --images_list ... --images_root ... --output_dir ... \
        --model_name dino_vits16 --batch_size 24
    python -m deep_spectral_tpu_torch.pipeline extract_eigs \
        --images_root ... --features_dir ... --output_dir ... --K 5
    python -m deep_spectral_tpu_torch.pipeline extract_multi_region_segmentations \
        --features_dir ... --eigs_dir ... --output_dir ...
    ... extract_multi_region_segmentations, extract_bboxes,
    extract_bbox_features, extract_bbox_clusters,
    extract_semantic_segmentations, extract_crf_segmentations,
    extract_single_region_segmentations, vis_segmentations, vis_server

The stages of `deep_spectral_tpu.pipeline.cli`, in its order, with its flag
names (and the reference's, extract/extract.py:837-850), plus `--device`
(default cuda) for the stages that use the card (1-3, 6, 7, 9). Implemented
with argparse by introspecting each stage function's signature. Every flag
of the JAX CLI runs. Stage 2's `--cheb_filter_impl` picks the Chebyshev
filter: `auto` (the default) and `pallas` are the filter kernel on the card
(its plain twin on the CPU), `xla` the chain of batched products that the
JAX package runs off a TPU.
`python -m deep_spectral_tpu_torch.pipeline.run_all` runs stages 1-9 in one
command.
"""
from __future__ import annotations

import argparse
import inspect
import typing

from . import extract as stages

STAGES = [
    "extract_features",
    "extract_eigs",
    "extract_multi_region_segmentations",
    "extract_bboxes",
    "extract_bbox_features",
    "extract_bbox_clusters",
    "extract_semantic_segmentations",
    "extract_crf_segmentations",
    "extract_single_region_segmentations",
    "vis_segmentations",
    "vis_server",
]


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def _add_stage_parser(sub, name: str):
    fn = getattr(stages, name)
    p = sub.add_parser(name, help=(fn.__doc__ or "").split("\n")[0])
    sig = inspect.signature(fn)
    # `from __future__ import annotations` stringifies annotations; resolve them.
    try:
        hints = typing.get_type_hints(fn)
    except Exception:
        hints = {}
    for pname, param in sig.parameters.items():
        has_default = param.default is not inspect.Parameter.empty
        ann = hints.get(pname, param.annotation)
        origin = typing.get_origin(ann)
        if origin is typing.Union:  # Optional[...]
            args = [a for a in typing.get_args(ann) if a is not type(None)]
            ann = args[0] if args else str
        if ann is bool or isinstance(param.default, bool):
            typ = _str2bool
        elif ann in (int,) or isinstance(param.default, int):
            typ = int
        elif ann in (float,) or isinstance(param.default, float):
            typ = float
        else:
            typ = str
        if has_default:
            p.add_argument(f"--{pname}", type=typ, default=param.default)
        else:
            p.add_argument(f"--{pname}", type=typ, required=True)
    p.set_defaults(_fn=fn)
    return p


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="deep_spectral_tpu_torch.pipeline",
        description="deep-spectral segmentation pipeline on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="stage", required=True)
    for name in STAGES:
        _add_stage_parser(sub, name)
    args = vars(parser.parse_args(argv))
    fn = args.pop("_fn")
    args.pop("stage")
    return fn(**args)


if __name__ == "__main__":
    main()
