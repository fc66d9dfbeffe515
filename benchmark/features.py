"""Seeded inputs of the benchmark: structured patch-feature fields and images.

`structured_field` is the root `bench.py`'s `_structured_features` (the
generator the solver tests validate on), copied and rewritten: the random
draws are made on the host in the same order from a numpy `Generator`, and
the fields are evaluated on the device in one pass. For a square grid it is
bench.py's field to f32 rounding; a grid of h x w rows and columns
normalizes each axis by its own length and bounds the blob's centre and
radius by both.

Why such a field: a random-weight ViT gives graphs with no small bottom
spectrum (no iterative solver isolates its smallest eigenpairs), while real
DINO features are spatially coherent. Low-frequency spatial modes plus an
object blob reproduce that regime; stage 2's features are this field plus
0.02 x the ViT's keys, so the forward stays on the timed path.
"""
from __future__ import annotations

import math

import numpy as np
import torch

N_MODES = 6


def field_draws(rng: np.random.Generator, h: int, w: int, D: int) -> dict:
    """One image's draws, in bench.py's order: per mode (fy, fx), the phase
    and a D-vector; then the blob's centre and its D-vector."""
    freqs, phases, vecs = [], [], []
    for _ in range(N_MODES):
        freqs.append(rng.uniform(0.5, 3, 2))
        phases.append(rng.uniform(0, 2 * np.pi))
        vecs.append(rng.standard_normal(D).astype(np.float32))
    cy = int(rng.integers(6, h - 6))
    cx = int(rng.integers(6, w - 6))
    blob = rng.standard_normal(D).astype(np.float32)
    return {"freqs": np.stack(freqs), "phases": np.asarray(phases), "vecs": np.stack(vecs),
            "centre": (cy, cx), "blob": blob}


def structured_field(draws: list[dict], h: int, w: int, device) -> torch.Tensor:
    """(B, h * w, D) f32 fields of the images whose draws are given."""
    yy = torch.arange(h, dtype=torch.float64, device=device)[:, None] / h
    xx = torch.arange(w, dtype=torch.float64, device=device)[None, :] / w
    iy = torch.arange(h, device=device)[:, None]
    ix = torch.arange(w, device=device)[None, :]
    out = []
    for d in draws:
        f = torch.as_tensor(d["freqs"], dtype=torch.float64, device=device)
        ph = torch.as_tensor(d["phases"], dtype=torch.float64, device=device)
        modes = torch.sin(2 * math.pi * (f[:, 0, None, None] * yy + f[:, 1, None, None] * xx)
                          + ph[:, None, None]).to(torch.float32)         # (6, h, w)
        vecs = torch.as_tensor(d["vecs"], device=device)                 # (6, D)
        base = torch.zeros((h * w, vecs.shape[1]), dtype=torch.float32, device=device)
        for m in range(N_MODES):   # bench.py's order of f32 additions
            base += modes[m].reshape(-1, 1) * vecs[m]
        cy, cx = d["centre"]
        blob = ((iy - cy) ** 2 + (ix - cx) ** 2) < (h * w) // 36
        base += blob.reshape(-1, 1).to(torch.float32) * (
            3 * torch.as_tensor(d["blob"], device=device))
        out.append(base)
    return torch.stack(out)

