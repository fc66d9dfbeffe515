"""window_pad_share.extract (%): the share of the rows SAM's window blocks
run through their qkv projection that are window padding, 100 (1 -
`vit.window_rows_valid` / `vit.window_rows`): the port's counters of a
window block's rows (its windows' tokens, from shapes) and of the grid's
tokens among them, over the traced window. Silent where the port counts
neither. Moves `images_per_s`."""
from benchmark import spans


def read(run):
    rows, valid = spans.total("vit.window_rows"), spans.total("vit.window_rows_valid")
    return 100.0 * (1.0 - valid / rows) if rows and valid else None
