"""The port's parallel paths (`deep_spectral_tpu_torch.parallel`, the
data-parallel train step and loop, `shard_across_processes` and the process
helpers) against the JAX package's on the virtual 8-device CPU mesh.

The port side runs in gloo groups of world 1, 2 and 4 on the CPU
(`test_torch_parallel_worker.py`): one group per world size for the module, all
three started together, each running every case once and saving each
rank's results. The inputs come from numpy seeds; the JAX models' weights
reach the port through `models.convert.flax_to_torch_state_dict` and
`flax_deeplab_to_torch_state_dict`. Pallas paths of the JAX side run in
interpret mode, as the JAX package's tests run them.

Tolerances are the JAX tests' own: ring attention 2e-5 on valid rows; the
SP-ViT's patch keys 2e-4 absolute + 1e-4 relative and its full forward
5e-4 + 1e-4; PP-ViT 5e-4 + 1e-4; TP and DP patch features 1e-5; bf16 paths
by per-token cosine >= 0.99. Eigenpairs as the port's stage-2 tests hold
them: eigenvalues 1e-4, eigenvector |cosine| >= 0.999; the row-sharded
LOBPCG (the JAX start block passed in) against the JAX solve at the same
bounds and against dense eigh at 1e-3 and 0.99, as `test_parallel.py`
holds the JAX solve. One DP train step at world 2 against JAX's
`train_step` on the global batch, with the same dropout keep-mask: loss and
accuracy 1e-5 relative, each gradient 1e-4 of its largest entry, BN
statistics 1e-5 (`test_torch_train.py`'s bounds). At world 1 every entry
point is also held against the port's single-device path.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu import parallel as jpar
from deep_spectral_tpu.models.convert import convert_dino_torch_checkpoint
from deep_spectral_tpu.models.vit import ViTConfig as JViTConfig
from deep_spectral_tpu.models.vit import VisionTransformer as JViT
from deep_spectral_tpu.ops.eigen import laplacian_eigs as j_laplacian_eigs
from deep_spectral_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from deep_spectral_tpu.parallel.pp_vit import pp_vit_forward as j_pp
from deep_spectral_tpu.parallel.sp_vit import sp_vit_forward as j_sp_forward
from deep_spectral_tpu_torch.models.convert import flax_to_torch_state_dict, random_init_
from deep_spectral_tpu_torch.models.flash_attention import flash_attention_packed_plain
from deep_spectral_tpu_torch.models.vit import VisionTransformer, ViTConfig
from deep_spectral_tpu_torch.models.vit import extract_patch_keys as t_keys
from deep_spectral_tpu_torch.ops.eigen import spectral_decompose_batched as t_decompose
from deep_spectral_tpu_torch.parallel.lobpcg import lobpcg_laplacian_eigs as t_lobpcg_eigs

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import T_TINY, _batch, _states, _voc  # noqa: E402

WORKER = Path(__file__).parent / "test_torch_parallel_worker.py"
WORLDS = (1, 2, 4)
# SP and TP share one model (hd 16), PP and DP features another (4 blocks)
SP_CFG = TP_CFG = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)
PP_CFG = DPF_CFG = dict(patch_size=8, embed_dim=32, depth=4, num_heads=2, img_size=32)
TRAIN_CFG = dict(num_classes=3, crop_size=32, resize_size=40, batch_size=2, lr=5e-3,
                 max_train_steps=10, unfrozen_backbone_layers=1, num_workers=1)


def _params(cfg):
    """(JAX model, flax params, the port's state dict) of one seeded init:
    the port's, carried to flax by the JAX package's converter (a flax init
    costs ~5 s here), and back by `flax_to_torch_state_dict`."""
    jcfg = JViTConfig(**cfg)
    model = random_init_(VisionTransformer(ViTConfig(**cfg)), seed=0)
    params = convert_dino_torch_checkpoint(model.state_dict(), jcfg)
    return JViT(jcfg), params, flax_to_torch_state_dict(params, ViTConfig(**cfg))


def _affinity(rng, n, d=32):
    f = rng.standard_normal((n, d)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    W = f @ f.T
    W = W * (W > 0)
    return (W / W.max()).astype(np.float32)


def _inputs(tmp: Path) -> tuple[dict, dict]:
    """Every case's inputs (numpy, seeded) and weights as state dicts, and
    the JAX models and params the references need."""
    rng = np.random.default_rng(0)
    I, J = {}, {}
    q, k, v = (rng.standard_normal((2, 64, 2, 8)).astype(np.float32) for _ in range(3))
    ring_mask = np.ones((2, 64), bool)
    ring_mask[0, 32:] = False  # image 0: its second half all padding
    ring_mask[1, 61:] = False
    I.update(ring_q=q, ring_k=k, ring_v=v, ring_mask=ring_mask)

    for keys, cfg in ((("sp", "tp"), SP_CFG), (("pp", "dpf"), PP_CFG)):
        model, params, sd = _params(cfg)
        for key in keys:
            J[key + "_model"], J[key + "_params"], I[key + "_sd"] = model, params, sd
            I[key + "_cfg"] = cfg
    sp_mask = np.ones((2, 64), bool)
    sp_mask[0, 40:] = False  # at world 4 (17 tokens a shard) the last shard is padding
    sp_mask[1, 61:] = False
    pp_mask = np.ones((4, 16), bool)
    pp_mask[0, 10:] = False
    pp_mask[1, 13:] = False
    I.update(sp_x=rng.standard_normal((2, 64, 64, 3)).astype(np.float32), sp_mask=sp_mask,
             pp_x=rng.standard_normal((4, 32, 32, 3)).astype(np.float32), pp_mask=pp_mask,
             tp_x=rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             tp_mask=np.ones((4, 16), bool),
             dpf_x=rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
             dpf_mask=np.ones((8, 16), bool),
             eig_feats=rng.standard_normal((8, 96, 24)).astype(np.float32),
             eig_masks=np.ones((8, 96), bool))
    Wp = np.zeros((320, 320), np.float32)
    Wp[:300, :300] = _affinity(rng, 300)
    I.update(row_W=_affinity(rng, 320), row_Wp=Wp, row_mask=np.arange(320) < 300,
             row_x0=np.array(jax.random.normal(jax.random.PRNGKey(0), (320, 7), jnp.float32)))
    I.update(train_vit=vars(T_TINY), train_cfg=TRAIN_CFG,
             loop_cfg={**TRAIN_CFG, "num_workers": 2, "lr": 1e-5}, voc_root=str(_voc(str(tmp / "voc"))))
    return I, J


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _save(obj: dict, path: Path) -> None:
    """torch.save of `obj` with numpy arrays as tensors, under its final name
    only once written whole."""
    tmp = path.with_suffix(".tmp")
    torch.save({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in obj.items()}, tmp)
    os.replace(tmp, path)


def _jmesh(*axes):
    return jpar.make_mesh(int(np.prod([a[1] for a in axes])), axes=list(axes))


def _jax_refs(I: dict, J: dict) -> dict:
    """The JAX functions' results on the same inputs, one call serving
    several cases where it can (a JAX SP call costs ~10 s here): the SP
    forward's last-block keys stand for JAX's sp_patch_features."""
    from deep_spectral_tpu.parallel.sharded import tp_sharded_patch_features
    mesh8, data8 = _jmesh((MODEL_AXIS, 8)), _jmesh((DATA_AXIS, 8))
    q, k, v = (jnp.asarray(I[f"ring_{n}"].transpose(0, 2, 1, 3)) for n in "qkv")
    refs = {}
    for impl, name, mask in (("einsum", "full", None), ("einsum", "ragged", I["ring_mask"]),
                             ("flash", "ragged", I["ring_mask"])):
        out = jpar.ring_attention_sharded(mesh8, q, k, v, None if mask is None else
                                          jnp.asarray(mask), impl=impl, interpret=True)
        refs["ring", impl, name] = np.asarray(out).transpose(0, 2, 1, 3)
    x, m = jnp.asarray(I["sp_x"]), jnp.asarray(I["sp_mask"])
    refs["sp_fwd"] = j_sp_forward(mesh8, J["sp_model"], J["sp_params"], x, m, qkv_block=-1,
                                  n_intermediates=2)
    refs["pp"] = j_pp(_jmesh((DATA_AXIS, 2), (MODEL_AXIS, 4)), J["pp_model"], J["pp_params"],
                      jnp.asarray(I["pp_x"]), jnp.asarray(I["pp_mask"]), n_microbatches=2)
    refs["tp"] = tp_sharded_patch_features(
        _jmesh((DATA_AXIS, 4), (MODEL_AXIS, 2)), J["tp_model"], J["tp_params"],
        jnp.asarray(I["tp_x"]), jnp.asarray(I["tp_mask"]))
    refs["dp_keys"] = jpar.sharded_patch_features(data8, J["dpf_model"], J["dpf_params"],
                                                  jnp.asarray(I["dpf_x"]),
                                                  jnp.asarray(I["dpf_mask"]))
    refs["dp_eigs"] = jpar.sharded_spectral_decompose(
        data8, jnp.asarray(I["eig_feats"]), jnp.asarray(I["eig_masks"]), K=4)
    refs["row"] = jpar.row_sharded_laplacian_eigs(data8, jnp.asarray(I["row_W"]), 4, iters=200)
    refs["row_masked"] = jpar.row_sharded_laplacian_eigs(
        data8, jnp.asarray(I["row_Wp"]), 4, iters=200, mask=jnp.asarray(I["row_mask"]))
    refs["dense"] = j_laplacian_eigs(jnp.asarray(I["row_W"]), 4, apply_sign_fix=False)
    refs["dense_masked"] = j_laplacian_eigs(jnp.asarray(I["row_Wp"][:300, :300]), 4,
                                            apply_sign_fix=False)
    return {key: jax.tree.map(np.asarray, val) for key, val in refs.items()}


def _jax_train_step() -> tuple[dict, dict]:
    """JAX's train step on test_torch_train's global batch and states
    (flash attention): (the worker's inputs: the weights, the batch and the
    dropout keep-mask JAX drew, NCHW; the references: loss, accuracy,
    gradients and the new BN statistics under the port's names)."""
    import flax.linen as nn
    from deep_spectral_tpu.tasks import semantic_segmentation as JSS
    from deep_spectral_tpu_torch.models.convert import flax_deeplab_to_torch_state_dict
    jstate, tstate = _states("flash")
    x, y = _batch()
    key = jax.random.PRNGKey(7)
    stats = jstate.batch_stats

    def loss_fn(params):  # JSS.train_step's loss, capturing the dropout output
        logits, mut = jstate.apply_fn(
            {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
            mutable=["batch_stats", "intermediates"], rngs={"dropout": key},
            capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.sum(jax.nn.one_hot(jnp.asarray(y), 3) * logp, axis=-1)
        return jnp.mean(ce), mut

    (_, mut), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    dropped = mut["intermediates"]["head"]["ASPP_0"]["Dropout_0"]["__call__"][0]
    g_ref = flax_deeplab_to_torch_state_dict(grads, stats, T_TINY)  # before the donation
    new, logs = JSS.train_step(jstate, jnp.asarray(x), jnp.asarray(y), key)
    worker = {"train_sd": tstate.model.state_dict(), "train_x": x, "train_y": y,
              "train_keep": torch.from_numpy(np.asarray(dropped) != 0).permute(0, 3, 1, 2)}
    return worker, {"grads": g_ref, "loss": float(logs["loss"]), "acc": float(logs["acc"]),
                    "buffers": flax_deeplab_to_torch_state_dict(new.params, new.batch_stats,
                                                                T_TINY)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX references, {world: [rank 0's results, rank 1's, ...]}).
    The three gloo groups start first and run while this process computes
    the JAX references; the train step's inputs follow when JAX has drawn
    its dropout mask."""
    tmp = tmp_path_factory.mktemp("parallel")
    I, J = _inputs(tmp)
    _save(I, tmp / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    try:
        for world in WORLDS:
            port = _free_port()
            for rank in range(world):
                log = open(tmp / f"w{world}_r{rank}.log", "w")
                procs.append((subprocess.Popen(
                    [sys.executable, str(WORKER), str(rank), str(world), str(port),
                     str(tmp / "inputs.pt"), str(tmp)],
                    stdout=log, stderr=subprocess.STDOUT, env=env), log))
        refs = _jax_refs(I, J)
        worker_train, refs["train"] = _jax_train_step()
        _save(worker_train, tmp / "train_inputs.pt")
        for proc, _ in procs:
            proc.wait(timeout=240)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    results = {}
    for world in WORLDS:
        files = [tmp / f"w{world}_r{r}.pt" for r in range(world)]
        if not all(f.is_file() for f in files):
            logs = "\n".join((tmp / f"w{world}_r{r}.log").read_text()[-3000:]
                             for r in range(world))
            pytest.fail(f"world {world} workers failed:\n{logs}")
        results[world] = [torch.load(f, weights_only=False) for f in files]
    return I, refs, results


def _case(run, world, name):
    """Each rank's result of a case (failing the test with a rank's traceback)."""
    results = [r[name] for r in run[2][world]]
    for r in results:
        if isinstance(r, dict) and "error" in r:
            pytest.fail(r["error"])
    return results


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


def _abs_cos(a, b):
    return np.abs(_cos_rows(a, b))


# ------------------------------------------------------------ ring attention

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("mask", ["full", "ragged"])
def test_ring_attention_matches_jax(run, world, impl, mask):
    """Token shards gathered in rank order against JAX's ring on 8 shards,
    on the valid rows (image 0's second half is padding: at world 2 a whole
    shard, at world 4 two). The full mask's flash hops are held against
    JAX's einsum hops, as test_ring_attention.py holds JAX's."""
    I, refs, _ = run
    got = np.concatenate([_np(r) for r in _case(run, world, f"ring_{impl}_{mask}")], axis=1)
    ref = refs["ring", impl if mask == "ragged" else "einsum", mask]
    assert got.shape == ref.shape and np.isfinite(got).all()
    valid = I["ring_mask"] if mask == "ragged" else np.ones(got.shape[:2], bool)
    np.testing.assert_allclose(got[valid], ref[valid], atol=2e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_rejects_indivisible_T(run, world):
    for msg in _case(run, world, "ring_indivisible"):
        assert msg is not None and "not divisible" in msg


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_ring_world1_is_one_local_attention(run, impl):
    """World 1: the ring is one local attention, the single-device one."""
    I = run[0]
    ref = flash_attention_packed_plain(*(torch.from_numpy(I[f"ring_{n}"]) for n in "qkv"),
                                       torch.from_numpy(I["ring_mask"])).numpy()
    got = _np(_case(run, 1, f"ring_{impl}_ragged")[0])
    np.testing.assert_allclose(got[I["ring_mask"]], ref[I["ring_mask"]], atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_default_impl_is_auto(run, world):
    """With no impl the ring resolves 'auto' from the tensors' device: on
    the CPU that is the einsum hops, the same bits."""
    for auto, einsum in zip(_case(run, world, "ring_auto_ragged"),
                            _case(run, world, "ring_einsum_ragged")):
        assert torch.equal(auto, einsum)


# -------------------------------------------------------------------- SP-ViT

def _sp_valid(I):
    return np.concatenate([np.ones((2, 1), bool), I["sp_mask"]], axis=1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["sp_keys", "sp_keys_flash"])
def test_sp_patch_features_match_jax(run, world, case):
    """The last block's keys (einsum and flash hops) against the keys of
    JAX's sp_vit_forward (JAX's SP keys are its sp_patch_features'), on the
    valid patches; flash hops at the JAX test's flash tolerance (5e-4)."""
    I, refs, _ = run
    got = np.concatenate([_np(r) for r in _case(run, world, case)], axis=1)
    ref = refs["sp_fwd"]["qkv"]["k"][:, 1:]
    assert got.shape == ref.shape
    atol = 5e-4 if case == "sp_keys_flash" else 2e-4
    m = I["sp_mask"]
    np.testing.assert_allclose(got[m], ref[m], atol=atol, rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["sp_fwd", "sp_fwd_b1"])
def test_sp_vit_forward_matches_jax(run, world, case):
    """Every output of the dict on the valid tokens: x_norm, q/k/v of the
    last block, the last two intermediates, and the CLS, replicated on
    every rank; also for the batch's first image alone (b1, where a rank's
    first row and the CLS are one contiguous view)."""
    I, refs, _ = run
    results = _case(run, world, case)
    b = 1 if case == "sp_fwd_b1" else 2
    ref = jax.tree.map(lambda a: a[:b], refs["sp_fwd"])
    valid = _sp_valid(I)[:b]

    def gathered(get):
        return np.concatenate([_np(get(r)) for r in results], axis=1)

    pairs = [(gathered(lambda r: r["x_norm"]), ref["x_norm"])]
    pairs += [(gathered(lambda r, n=n: r["qkv"][n]), ref["qkv"][n]) for n in "qkv"]
    assert len(results[0]["intermediates"]) == len(ref["intermediates"]) == 2
    pairs += [(gathered(lambda r, i=i: r["intermediates"][i]), ref["intermediates"][i])
              for i in range(2)]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got[valid], want[valid], atol=5e-4, rtol=1e-4)
    for r in results:
        np.testing.assert_allclose(_np(r["cls"]), ref["cls"], atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sp_bf16_matches_jax(run, world):
    """bf16 with flash hops against JAX's fp32 SP: keys by per-patch cosine
    on the valid patches and the CLS by cosine, > 0.99 (test_sp_vit.py's
    bound for JAX's bf16 SP)."""
    I, refs, _ = run
    got = np.concatenate([_np(r) for r in _case(run, world, "sp_keys_bf16")], axis=1)
    m = I["sp_mask"]
    assert _cos_rows(got[m], refs["sp_fwd"]["qkv"]["k"][:, 1:][m]).min() > 0.99
    for r in _case(run, world, "sp_fwd_bf16"):
        assert _cos_rows(_np(r["cls"]), refs["sp_fwd"]["cls"]).min() > 0.99


@pytest.mark.parametrize("world", WORLDS)
def test_sp_early_exit_matches_single_device(run, world):
    """The keys of block 0 (the stack exits there) against the port's
    single-device `extract_patch_keys` (held against JAX's in
    test_torch_vit.py), on the valid patches, at the SP keys' tolerance."""
    I = run[0]
    model = VisionTransformer(ViTConfig(**SP_CFG), attention_impl="einsum")
    model.load_state_dict(I["sp_sd"])
    ref = t_keys(model, torch.from_numpy(I["sp_x"]), which_block=0,
                 token_mask=torch.from_numpy(I["sp_mask"])).numpy()
    got = np.concatenate([_np(r) for r in _case(run, world, "sp_keys_block0")], axis=1)
    m = I["sp_mask"]
    np.testing.assert_allclose(got[m], ref[m], atol=2e-4, rtol=1e-4)


def test_sp_world1_matches_single_device(run):
    """World 1 against the port's `VisionTransformer`: keys and forward."""
    I = run[0]
    model = VisionTransformer(ViTConfig(**SP_CFG), attention_impl="einsum")
    model.load_state_dict(I["sp_sd"])
    x, m = torch.from_numpy(I["sp_x"]), torch.from_numpy(I["sp_mask"])
    np.testing.assert_allclose(_np(_case(run, 1, "sp_keys")[0])[I["sp_mask"]],
                               t_keys(model, x, token_mask=m).numpy()[I["sp_mask"]], atol=1e-5)
    with torch.no_grad():
        ref = model(x, qkv_block=-1, n_intermediates=2, token_mask=m)
    got, valid = _case(run, 1, "sp_fwd")[0], _sp_valid(I)
    np.testing.assert_allclose(_np(got["x_norm"])[valid], ref["x_norm"].numpy()[valid],
                               atol=1e-5)
    np.testing.assert_allclose(_np(got["qkv"]["v"])[valid], ref["qkv"]["v"].numpy()[valid],
                               atol=1e-5)


# -------------------------------------------------------------------- PP-ViT

def _pp_valid(I):
    return np.concatenate([np.ones((4, 1), bool), I["pp_mask"]], axis=1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["pp_m1", "pp_m2", "pp_m4", "pp_flash"])
def test_pp_matches_jax(run, world, case):
    """Microbatches 1 (all bubble), 2 and 4 (the deepest pipeline), and the
    flash route (kernel 3's f32 build's twin on the CPU), against JAX's PP
    on a (2 data, 4 model) mesh, on the valid tokens (images 0-1 ragged):
    x_norm and cls on every rank."""
    I, refs, _ = run
    valid = _pp_valid(I)
    for r in _case(run, world, case):
        np.testing.assert_allclose(_np(r["x_norm"])[valid], refs["pp"]["x_norm"][valid],
                                   atol=5e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(r["cls"]), refs["pp"]["cls"], atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_pp_bf16_matches_jax(run, world):
    """bf16 stages against JAX's fp32 PP: the CLS by cosine > 0.99
    (test_pp_vit.py's bound for JAX's bf16 PP)."""
    for r in _case(run, world, "pp_bf16"):
        assert _cos_rows(_np(r["cls"]), run[1]["pp"]["cls"]).min() > 0.99


@pytest.mark.parametrize("world", WORLDS)
def test_pp_composes_with_dp(run, world):
    """PP x DP on a (data, model) mesh: data row d of dp runs its own
    pipeline on rows d, d + dp, ... (JAX's microbatch sharding)."""
    I, refs, _ = run
    dp, valid = min(world, 2), _pp_valid(I)
    for rank, r in enumerate(_case(run, world, "ppdp")):
        d = rank // (world // dp)
        np.testing.assert_allclose(_np(r["x_norm"])[valid[d::dp]],
                                   refs["pp"]["x_norm"][d::dp][valid[d::dp]],
                                   atol=5e-4, rtol=1e-4)


def test_pp_world1_matches_single_device(run):
    """World 1: one stage of every block, against the port's forward of the
    whole batch (the microbatches of 2 round as the batch of 4 does)."""
    I = run[0]
    model = VisionTransformer(ViTConfig(**PP_CFG), attention_impl="einsum")
    model.load_state_dict(I["pp_sd"])
    with torch.no_grad():
        ref = model(torch.from_numpy(I["pp_x"]), token_mask=torch.from_numpy(I["pp_mask"]))
    valid = _pp_valid(I)
    for case in ("pp_m1", "pp_m2", "pp_m4"):
        got = _case(run, 1, case)[0]
        np.testing.assert_allclose(_np(got["x_norm"])[valid], ref["x_norm"].numpy()[valid],
                                   atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_pp_stage_holds_only_its_blocks(run, world):
    model = VisionTransformer(ViTConfig(**PP_CFG))
    full = sum(p.numel() for p in model.parameters())
    block = sum(p.numel() for p in model.blocks[0].parameters())
    for n in _case(run, world, "pp_params"):
        assert n == full - (PP_CFG["depth"] - PP_CFG["depth"] // world) * block


@pytest.mark.parametrize("world", WORLDS)
def test_pp_rejects_bad_shapes(run, world):
    for msg in _case(run, world, "pp_bad_batch"):
        assert msg is not None and "not divisible" in msg
    if world > 1:
        for msg in _case(run, world, "pp_bad_depth"):
            assert msg is not None and "not divisible" in msg


# ------------------------------------------------------ TP, DP and the eigs

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["tp_keys", "tp_keys_1d"])
def test_tp_patch_features_match_jax(run, world, case):
    """Megatron TP over the model dim (x DP over the data dim of world 4's
    2 x 2 mesh), and over the whole 1-D mesh (world 4: a head a rank),
    against JAX's TP on a (4 data, 2 model) mesh."""
    ref = run[1]["tp"]
    got = _case(run, world, case)
    if case == "tp_keys":
        dp = min(world, 2)
        for r in got:  # replicated over the model dim
            assert r.shape == (4 // dp, 16, 64)
        got = [got[d * (world // dp)] for d in range(dp)]  # one rank per data row
    else:
        assert all(torch.equal(got[0], r) for r in got)
        got = got[:1]
    np.testing.assert_allclose(np.concatenate([_np(r) for r in got]), ref, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_patch_features_match_jax(run, world):
    got = np.concatenate([_np(r) for r in _case(run, world, "dp_keys")])
    np.testing.assert_allclose(got, run[1]["dp_keys"], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_spectral_decompose_matches_jax(run, world):
    rv, rx = run[1]["dp_eigs"]
    for sv, sx in _case(run, world, "dp_eigs"):  # gathered on every rank
        np.testing.assert_allclose(_np(sv), rv, atol=1e-4)
        assert _abs_cos(_np(sx), rx).min() >= 0.999


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("masked", [False, True])
def test_row_sharded_lobpcg_matches_jax_and_dense(run, world, masked):
    """From JAX's start block: against JAX's row-sharded solve (1e-4, 0.999)
    and dense eigh (1e-3, 0.99); the same bits on every rank; padded rows 0."""
    refs = run[1]
    jv, jx = refs["row_masked" if masked else "row"]
    dv, dx = refs["dense_masked" if masked else "dense"]
    results = _case(run, world, "row_eigs_masked" if masked else "row_eigs")
    for sv, sx in results[1:]:
        assert torch.equal(sv, results[0][0]) and torch.equal(sx, results[0][1])
    sv, sx = (_np(a) for a in results[0])
    np.testing.assert_allclose(sv, jv, atol=1e-4)
    assert _abs_cos(sx, jx).min() >= 0.999
    n = 300 if masked else 320
    np.testing.assert_allclose(sv, dv, atol=1e-3)
    assert _abs_cos(sx[:, :n], dx).min() > 0.99
    if masked:
        assert np.abs(sx[:, n:]).max() == 0.0


def test_sharded_world1_matches_single_device(run):
    """World 1: DP features, DP eigs, TP and the row-sharded LOBPCG against
    the port's single-device functions."""
    I = run[0]
    model = VisionTransformer(ViTConfig(**DPF_CFG))
    model.load_state_dict(I["dpf_sd"])
    ref = t_keys(model, torch.from_numpy(I["dpf_x"]),
                 token_mask=torch.from_numpy(I["dpf_mask"]))
    assert torch.equal(_case(run, 1, "dp_keys")[0], ref)
    ev, vec = t_decompose(torch.from_numpy(I["eig_feats"]), torch.from_numpy(I["eig_masks"]),
                          K=4)
    got = _case(run, 1, "dp_eigs")[0]
    assert torch.equal(got[0], ev) and torch.equal(got[1], vec)
    tp = VisionTransformer(ViTConfig(**TP_CFG))
    tp.load_state_dict(I["tp_sd"])
    ref = t_keys(tp, torch.from_numpy(I["tp_x"]), token_mask=torch.from_numpy(I["tp_mask"]))
    np.testing.assert_allclose(_np(_case(run, 1, "tp_keys")[0]), ref.numpy(), atol=1e-5)
    ev, vec = t_lobpcg_eigs(torch.from_numpy(I["row_W"]), 4, iters=200, x0=I["row_x0"])
    sv, sx = _case(run, 1, "row_eigs")[0]
    np.testing.assert_allclose(sv.numpy(), ev.numpy(), atol=1e-5)
    assert _abs_cos(sx.numpy(), vec.numpy()).min() >= 0.9999


# ------------------------------------------------------- data-parallel train

@pytest.mark.parametrize("world", [1, 2])
def test_dp_train_step_matches_jax(run, world):
    """Each rank trains its block of JAX's global batch with its block of
    the global keep-mask (flash attention on both sides, test_torch_train's
    inputs): the global loss and accuracy, the averaged gradients and the
    global-batch BN statistics match JAX's step on the whole batch, and
    every rank holds the same state after it."""
    ref = run[1]["train"]
    results = _case(run, world, "train_dp")
    for r in results:
        np.testing.assert_allclose(float(r["loss"]), ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(r["acc"]), ref["acc"], rtol=1e-5)
        assert len(r["grads"]) > 0
        for name, g in r["grads"].items():
            want = ref["grads"][name]
            assert (g - want).abs().max().item() <= 1e-4 * want.abs().max().item(), name
        for name, b in r["buffers"].items():
            np.testing.assert_allclose(b.numpy(), ref["buffers"][name].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    for r in results[1:]:
        for name, p in r["params"].items():
            assert torch.equal(p, results[0]["params"][name]), name


def test_dp_train_step_world1_is_the_plain_step(run):
    dp, plain = _case(run, 1, "train_dp")[0], _case(run, 1, "train_plain")[0]
    assert torch.equal(dp["loss"], plain["loss"])
    for key in ("grads", "buffers", "params"):
        for name, t in plain[key].items():
            assert torch.equal(dp[key][name], t), (key, name)


def test_dp_train_loop(run):
    """`train(mesh=...)` for 3 steps with an eval: at world 1 the same state
    as `train(device='cpu')`; at world 2 the same state on both ranks, and
    each step's loss as world 1 logged it, to 1e-5 (the same global
    batches, BN statistics and dropout masks; lr 1e-5, since Adam turns
    rounding-level gradient differences into steps of lr size, which at
    lr 5e-3 moved the third loss 2e-3); rank 0 alone writes the
    checkpoint and the metric log, and both ranks get its mIoU."""
    single = _case(run, 1, "loop_single")[0]
    w1 = _case(run, 1, "loop_mesh")[0]
    w2 = _case(run, 2, "loop_mesh")
    assert single["step"] == w1["step"] == w2[0]["step"] == w2[1]["step"] == 3
    for name, p in single["params"].items():
        assert torch.equal(w1["params"][name], p), name
        assert torch.equal(w2[1]["params"][name], w2[0]["params"][name]), name
    assert w1["losses"] == single["losses"] and len(single["losses"]) == 3
    np.testing.assert_allclose(w2[0]["losses"], single["losses"], rtol=1e-5)
    assert w2[1]["losses"] == []
    assert w1["files"] == single["files"] == ["best.pt", "metrics_r0.jsonl"]
    assert all(r["files"] == ["best.pt", "metrics_r0.jsonl"] for r in w2)
    assert w2[0]["best"] == w2[1]["best"] >= 0.0


def test_step_batches_split_by_rank(tmp_path):
    """A step's global batch is the same whichever ranks make its rows: the
    rank blocks of world 2 and 4 concatenate to world 1's batch, bit for
    bit; later steps run through the dataset's permutation (every image
    once an epoch) and differ from step to step."""
    from deep_spectral_tpu_torch.tasks import semantic_segmentation as TSS
    cfg = TSS.TrainConfig(backbone=ViTConfig(**vars(T_TINY)),
                          **{**TRAIN_CFG, "batch_size": 4})
    root = _voc(str(tmp_path / "voc"))
    ds = TSS.VOCSegmentationWithPseudolabels(str(root), "train", str(root / "pseudo"))
    whole = [TSS._step_batch(ds, cfg, step, range(4)) for step in range(3)]
    for step, (ims, segs) in enumerate(whole):
        for world in (2, 4):
            n = 4 // world
            parts = [TSS._step_batch(ds, cfg, step, range(r * n, (r + 1) * n))
                     for r in range(world)]
            np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), ims)
            np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), segs)
    assert not np.array_equal(whole[0][0], whole[1][0])
    order = np.random.default_rng((cfg.seed, 0)).permutation(len(ds))
    assert sorted(order.tolist()) == list(range(len(ds)))


# ------------------------------------------------------ process helpers

@pytest.mark.parametrize("world", WORLDS)
def test_process_helpers(run, world):
    """shard_across_processes covers the items once; all_sum_scalar sums;
    SmoothedValue and MetricLogger sync to the global (count, total);
    rank 0 alone is master (the checks of tests/_dist_worker.py)."""
    results = _case(run, world, "helpers")
    assert sorted(i for r in results for i in r["items"]) == list(range(10))
    for rank, r in enumerate(results):
        assert r["items"] == list(range(10))[rank::world]
        assert r["all_sum"] == world * (world + 1) / 2
        assert r["is_master"] == (rank == 0)
        assert r["sv_count"] == sum(range(2, world + 2))
        assert r["sv_total"] == float(sum(sum(range(p + 2)) for p in range(world)))
        assert r["logger"] == (world, float(sum(range(world))))
