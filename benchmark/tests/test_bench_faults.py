"""A run with the timed path broken underneath comes out not correct.

Each test drives a tiny cell of each kind through the whole run but the
look for a card (set-up, window, release, check) on the CPU, with a fault
planted in the port where its answer is produced, and sees `correct` come
out false under the full-size cell's limits; the same run without the fault
is correct."""
from __future__ import annotations

from contextlib import contextmanager

import pytest
import torch

from benchmark import harness


def _check(root, name: str, seed: int = 2**31 + 5):
    cell = harness.find_cell(name, root)
    runner = harness.driver(cell, root).Runner(cell, seed, torch.device("cpu"))
    runner.window(0.5)
    runner.release()
    return runner.check()


@contextmanager
def _wrap(module, attr, after):
    inner = getattr(module, attr)

    def wrapped(*args, **kwargs):
        return after(inner(*args, **kwargs), *args, **kwargs)

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, inner)


def _eigen():
    from deep_spectral_tpu_torch.ops import eigen
    return eigen


def answer_altered():
    def after(out, *a, **k):
        evals, evecs = out
        evecs = evecs.clone()
        gen = torch.Generator().manual_seed(0)
        noise = torch.randn(evecs.shape[-1], generator=gen).to(evecs)
        evecs[0, 0] += 0.01 * torch.linalg.vector_norm(evecs[0, 0]) * noise / noise.norm()
        return evals, evecs
    return _wrap(_eigen(), "spectral_decompose_batched", after)


def half_batch_missing():
    def after(out, *a, **k):
        evals, evecs = (t.clone() for t in out)
        half = evals.shape[0] // 2
        evals[half:], evecs[half:] = 0, 0
        return evals, evecs
    return _wrap(_eigen(), "spectral_decompose_batched", after)


def keys_altered():
    from deep_spectral_tpu_torch.models import vit

    def after(k, *a, **kw):
        k = k.clone()
        k[0] = k[0] * 1.1
        return k
    return _wrap(vit, "extract_patch_keys", after)


@contextmanager
def state_unchanged():
    from deep_spectral_tpu_torch.tasks import semantic_segmentation as ss
    inner = ss.AdamW.step
    ss.AdamW.step = lambda self, grads, ok: None
    try:
        yield
    finally:
        ss.AdamW.step = inner


@contextmanager
def half_batch_trained():
    from deep_spectral_tpu_torch.tasks import semantic_segmentation as ss
    inner = ss.train_step

    def half(state, images, labels, *a, **k):
        n = images.shape[0] // 2
        return inner(state, images[:n], labels[:n], *a, **k)

    ss.train_step = half
    try:
        yield
    finally:
        ss.train_step = inner


@pytest.mark.parametrize("name", ["tiny-extract", "tiny-eigs", "tiny-train"])
def test_sound_run_is_correct(tiny_root, name):
    correct, checks = _check(tiny_root, name)
    assert correct, checks


@pytest.mark.parametrize("name,fault", [
    ("tiny-extract", answer_altered), ("tiny-extract", half_batch_missing),
    ("tiny-extract", keys_altered), ("tiny-eigs", answer_altered),
    ("tiny-eigs", half_batch_missing), ("tiny-train", state_unchanged),
    ("tiny-train", half_batch_trained)])
def test_fault_is_not_correct(tiny_root, name, fault):
    with fault():
        correct, checks = _check(tiny_root, name)
    assert not correct, checks
