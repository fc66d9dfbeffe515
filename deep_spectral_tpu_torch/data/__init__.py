"""The VOC image lists, shipped as package data (the port's own copies of
`deep_spectral_tpu/data/VOC20{07,12}/lists/images.txt`, byte for byte).

The reference vendors the exact VOC2007 (5,011) / VOC2012 (17,125) image
lists (`extract/data/VOC{2007,2012}/lists/images.txt`). Their membership AND
order are load-bearing: the semantic-segmentation dataset pairs sorted
segment files to sorted image files *by position, not id*
(reference: semantic-segmentation/dataset/voc.py:112-131), so a regenerated
list with different membership silently mispairs pseudolabels. The lists are
checksummed so corruption is caught at read time.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

_DATA_DIR = Path(__file__).resolve().parent

# sha256 of the vendored lists (byte-identical to the reference's).
VOC_LIST_SHA256 = {
    "VOC2007": "a4d9db647d6172abdf93e8047fde305e53049296b7d3c3e2035a90868c864fba",
    "VOC2012": "387a2fcc0b42bacf3ee852b0e750a3e6e771e6463b7263fc16bc1087493749b0",
}
VOC_LIST_LENGTHS = {"VOC2007": 5011, "VOC2012": 17125}


def voc_list_path(dataset: str) -> Path:
    """Path to the vendored `lists/images.txt` for 'VOC2007' or 'VOC2012'."""
    if dataset not in VOC_LIST_SHA256:
        raise KeyError(f"no vendored list for {dataset!r}; "
                       f"have {sorted(VOC_LIST_SHA256)}")
    return _DATA_DIR / dataset / "lists" / "images.txt"


def voc_image_list(dataset: str, verify: bool = True) -> list[str]:
    """The vendored VOC image filenames, in reference order."""
    path = voc_list_path(dataset)
    data = path.read_bytes()
    if verify:
        digest = hashlib.sha256(data).hexdigest()
        if digest != VOC_LIST_SHA256[dataset]:
            raise ValueError(
                f"vendored list {path} is corrupt: sha256 {digest} != "
                f"{VOC_LIST_SHA256[dataset]}")
    return data.decode().split()
