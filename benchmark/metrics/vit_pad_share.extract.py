"""vit_pad_share.extract (%): the share of stage 1's tokens that are
padding, 100 (1 - `vit.tokens_valid` / `vit.tokens`): the port's counters of
the tokens a batch's ViT runs (B x T, from shapes) and of each image's CLS,
registers and valid patches (from the grids the caller hands it), over the
traced window. Silent where the port counts neither. Moves `images_per_s`."""
from benchmark import spans


def read(run):
    tokens, valid = spans.total("vit.tokens"), spans.total("vit.tokens_valid")
    return 100.0 * (1.0 - valid / tokens) if tokens and valid else None
