"""The port's data parallelism (``recombiner_tpu_torch/parallel/``) on the CPU:
ranks are spawned processes on gloo (``launch.spawn``, a file rendezvous in
a temporary directory, a time limit on every spawn and every collective),
held to the port in one process and to the JAX package's sharded runs on
conftest's 8 virtual devices, as ``tests/test_parallel.py`` holds the JAX
package. The rank functions live in ``torch_parallel_workers.py``.

Tolerances: ``_close`` and ``_state_close`` of ``test_torch_trainer.py``
for a training epoch's metrics and every leaf of a trained state; the
M-step to rtol 1e-4; shared leaves bitwise equal across ranks; an encode's
indices equal in at least 98% of cells and its PSNR within 0.3 dB (the JAX
bar, ``tests/test_parallel.py:166-170``); a decoded bitstream within
``DECODE_TOL``.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recombiner_tpu.coding import encoder as jenc
from recombiner_tpu.coding import progressive as jprog
from recombiner_tpu.config import TINY as JTINY
from recombiner_tpu.config import TINY_PATCH as JTINY_PATCH
from recombiner_tpu.coords import grid_fourier_features
from recombiner_tpu.data.synthetic import synthetic_dataset
from recombiner_tpu.io import bitstream as jax_bitstream
from recombiner_tpu.models.inr import init_linear_transform as jax_init_linear_transform
from recombiner_tpu.models.inr import inr_forward as jax_inr_forward
from recombiner_tpu.parallel import mesh as jmesh
from recombiner_tpu.parallel.tp import make_mesh_tp as jax_make_mesh_tp
from recombiner_tpu.parallel.tp import shard_A as jax_shard_A
from recombiner_tpu.parallel.tp import tp_inr_forward as jax_tp_inr_forward
from recombiner_tpu.priors import trainer as jtr
from recombiner_tpu_torch.coding import decoder
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.io import bitstream, checkpoint
from recombiner_tpu_torch.models.inr import inr_forward
from recombiner_tpu_torch.parallel import launch
from recombiner_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    partition,
    replicate,
    shard_rows,
)
from recombiner_tpu_torch.priors import trainer as tr

import torch_parallel_workers as workers
from test_torch_encode import DECODE_TOL, _artifacts, _close, _images, _replayed_noise
from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_trainer import jax_epoch_keys, jax_noise

SPAWN_S = 300  # each spawn's limit, and every collective's
LR = 2e-3


def spawn(fn, world, *args):
    launch.spawn(fn, world, args, timeout_s=SPAWN_S)


def _load(out_dir, name, world):
    return [torch.load(os.path.join(out_dir, f"{name}_{r}.pt"), weights_only=False)
            for r in range(world)]


def _leaves(js):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]


def _leaves_close(got, want, start, lr, steps, what=""):
    """``test_torch_trainer._state_close`` on numpy leaves: each leaf's gap
    within 1e-6 of its norm plus 1e-2 of the norm of the change training
    made, every element within 2 lr per Adam step."""
    assert len(got) == len(want) == len(start)
    for i, (g, w, w0) in enumerate(zip(got, want, start)):
        gap = np.linalg.norm(g - w)
        assert gap <= 1e-6 * np.linalg.norm(w) + 1e-2 * np.linalg.norm(w - w0), (
            what, i, gap, np.linalg.norm(w - w0))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max() + 2 * lr * steps,
                                   err_msg=f"{what} leaf {i}")


# ------------------------------------------------------------------ cases


def _train_case(jcfg, n_data, seed, em=False):
    """A training case: the JAX package's initial state and priors, data,
    and JAX's noise for 3 epochs (and 3 EM iterations of 2), as numpy."""
    X, Y = synthetic_dataset(jcfg, n_data, seed=seed)
    js = jtr.init_prior_state(jax.random.key(0), jcfg, X.shape[0])
    jp = jtr.init_priors(jcfg)
    key = jax.random.key(1)
    case = dict(cfg=jcfg.name, n_data=n_data, X=X, Y=Y, state=_leaves(js), priors=_leaves(jp),
                beta=1e-3, lr=LR, n_epochs=3, key=key,
                noise=[jax_noise(k, js) for k in jax.random.split(key, 3)])
    if em:
        ekey = jax.random.key(9)
        case.update(em_noise=[jax_noise(k, js) for k in jax_epoch_keys(ekey, [2, 2, 2])],
                    em_key=ekey, em_iters=3, em_epochs=2, budget=jcfg.bits_budget(4.0))
    return case


def _jax_train(case, jcfg, n_devices):
    """JAX's sgd_epochs (and em_iters) on ``n_devices`` of the 8 virtual
    devices, rows sharded."""
    mesh = jmesh.make_mesh(n_devices)
    X, Y = (jmesh.shard_rows(jnp.asarray(a), mesh) for a in (case["X"], case["Y"]))
    js = jtr.init_prior_state(jax.random.key(0), jcfg, case["X"].shape[0])
    jp = jtr.init_priors(jcfg)
    start = _leaves(js)

    def fresh():  # the JAX trainer donates its state
        return jmesh.shard_rows(jax.tree_util.tree_map(jnp.copy, js), mesh)

    js1, jm = jtr.sgd_epochs(fresh(), X, Y, jp, jnp.float32(case["beta"]),
                             case["key"], cfg=jcfg, n_epochs=case["n_epochs"], lr=LR)
    out = {"mse": float(jm.mse), "kl": float(jm.kl), "state": _leaves(js1), "start": start,
           "m_step": _leaves(jtr.m_step(js1, jcfg))}
    if "em_key" in case:
        lo, hi = case["budget"]
        js3, jp3, jbeta, _, jhist = jtr.em_iters(
            fresh(), X, Y, jp, jnp.float32(1e-8), case["em_key"],
            jnp.float32(lo), jnp.float32(hi), cfg=jcfg, n_iters=3, n_epochs=2, lr=LR)
        out["em"] = {"state": _leaves(js3), "priors": _leaves(jp3), "beta": float(jbeta),
                     "hist": [np.asarray(h) for h in jhist]}
    return out


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    """TINY (8 datapoints) and TINY_PATCH (4 datapoints: 16 / 8 / 4 rows of
    w / h / hh) at 2 ranks, TINY at 4 (with the 4-rank grids), the port in
    one process and the JAX package sharded over as many devices."""
    out = tmp_path_factory.mktemp("training")
    cases = {"tiny": _train_case(JTINY, 8, 0, em=True),
             "tiny_patch": _train_case(JTINY_PATCH, 4, 2)}
    inp = str(out / "train_in.pt")
    torch.save({n: {k: v for k, v in c.items() if not k.endswith("key")}
                for n, c in cases.items()}, inp)
    spawn(workers.train_worker, 2, inp, str(out))
    one = {n: workers.train_case({k: v for k, v in c.items() if not k.endswith("key")}, Mesh())
           for n, c in cases.items()}
    # the 4-rank grids: TINY training, the TP forward, pixel-axis training
    grid_in = str(out / "grid_in.pt")
    A = [np.asarray(a) for a in jax_init_linear_transform(jax.random.key(0), JTINY.net_dims)]
    Pn = JTINY.n_pixels
    x = np.asarray(jax.random.normal(jax.random.key(1), (4, 2, Pn, JTINY.input_dim)))
    h_w = np.asarray(jax.random.normal(jax.random.key(2), (4, 2, JTINY.n_inr_params))) * 0.02
    pix = _train_case(JTINY, 2, 1)
    torch.save({"train": {"tiny": {k: v for k, v in cases["tiny"].items()
                                   if not k.endswith("key") and not k.startswith("em")}},
                "tp": {"cfg": "tiny", "A": A, "x": x, "h_w": h_w},
                "pixels": {k: v for k, v in pix.items() if not k.endswith("key")}}, grid_in)
    spawn(workers.grid_worker, 4, grid_in, str(out))
    pix_one = workers.train_case({k: v for k, v in pix.items() if not k.endswith("key")}, Mesh())
    return {"cases": cases, "one": one, "two": _load(str(out), "train", 2),
            "grid": _load(str(out), "grid", 4), "tp_in": (A, x, h_w), "pix_one": pix_one,
            "pix": pix,
            "jax": {("tiny", 2): _jax_train(cases["tiny"], JTINY, 2),
                    ("tiny", 4): _jax_train({k: v for k, v in cases["tiny"].items()
                                             if not k.startswith("em")}, JTINY, 4),
                    ("tiny_patch", 4): _jax_train(cases["tiny_patch"], JTINY_PATCH, 4)}}


def _dp_runs(training, world):
    if world == 2:
        return [r["tiny"] for r in training["two"]]
    return [r["train"]["tiny"] for r in training["grid"]]


# ------------------------------------------------------------------- mesh


@pytest.mark.parametrize("n_data,world,cfg_name,sharded,block", [
    (8, 1, None, False, (0, 8)),
    (8, 2, None, True, (4, 8)),
    (8, 4, None, True, (2, 4)),
    (3, 2, None, False, (0, 3)),  # not divisible: every rank holds all
    (1, 2, "kodak", True, (48, 96)),  # one Kodak image on 2 ranks: 4 patch rows each
    (4, 2, "tiny_patch", True, (8, 16)),  # a patch encode: whole images, coded rows whole
])
def test_partition_by_whole_datapoints(n_data, world, cfg_name, sharded, block):
    """Shard contiguous blocks of whole datapoints when the count divides by
    the world size, else replicate (JAX's ``shard_rows`` rule); the block of
    w rows of rank 1 (rank 0 at world size 1); never empty. With a patch
    config (an encode) one datapoint's patch rows are split too (Kodak's 96
    at 2 ranks: h split with them, hh whole), and the coded rows of w and h
    stay whole on every rank, since they mix every datapoint's."""
    cfg = get_config(cfg_name) if cfg_name else None
    ppd = cfg.patches_per_datapoint if cfg else 1
    part = partition(Mesh(world, min(1, world - 1)), n_data, cfg)
    assert part.sharded == sharded and part.reason
    b = part.block(n_data * ppd)
    assert (b.start, b.stop) == block and b.stop > b.start
    assert part.global_rows(b.stop - b.start) == n_data * ppd
    if cfg is None or part.slab is None:
        # an upper level of 4 rows per datapoint: the same datapoints' rows
        b4 = part.level("h").block(4 * n_data)
        assert (b4.start, b4.stop) == (4 * block[0] // ppd, 4 * block[1] // ppd)
    else:  # Kodak's h rows 3-5 cover patch rows 4-7; its one hh row is whole
        assert part.slab.per_rank == 4 and part.slab.halo == 1 and part.whole == ("hh",)
        hb, hhb = part.level("h").block(6), part.level("hh").block(1)
        assert (hb.start, hb.stop, hhb.start, hhb.stop) == (3, 6, 0, 1)
    assert part.coded("w").sharded == (sharded and cfg is None)


def test_shard_rows_of_a_state_keeps_every_levels_block():
    """A TINY_PATCH state of 2 datapoints sharded over 2 ranks: rank 1 holds
    datapoint 1's 4 w rows, 2 h rows and 1 hh row; the mappings whole."""
    cfg = get_config("tiny_patch")
    st = tr.init_prior_state(cfg, 8, torch.Generator().manual_seed(0), "cpu")
    part = partition(Mesh(2, 1), 2)
    loc = shard_rows(st, part)
    assert loc.part is part
    assert torch.equal(loc.w.loc, st.w.loc[4:]) and torch.equal(loc.h.loc, st.h.loc[2:])
    assert torch.equal(loc.hh.loc, st.hh.loc[1:]) and torch.equal(loc.lpe.loc, st.lpe.loc[4:])
    assert all(a is b for a, b in zip(loc.A, st.A))
    whole = replicate(st, Mesh(2, 1), 2)  # every row on every rank, never summed
    assert not whole.part.sharded and whole.gathered().w.loc is st.w.loc


def test_n_devices_above_the_visible_count_raises():
    """As ``mesh.py:24-29``: above the visible devices raises; None is every
    visible card (one process on the CPU); no group, no mesh of 2."""
    with pytest.raises(ValueError, match="requested but only"):
        launch.requested_world(10**6, "cpu")
    with pytest.raises(ValueError, match="requested but only"):
        launch.requested_world(0, "cpu")
    assert launch.requested_world(None, "cpu") == 1
    assert launch.requested_world(2, "cpu") == 2
    assert make_mesh() == Mesh(1, 0) == make_mesh(1)
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(2)


def test_multihost_scaffold_single_process_noop(monkeypatch):
    """The env gate off, nothing is started; one process is the primary;
    ``fetch_global`` and ``shard_rows_global`` are plain copies."""
    for name in ("RECOMBINER_TPU_MULTIHOST", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert launch.multihost_enabled() is False and launch.launched() is False
    assert launch.maybe_initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert launch.process_count() == 1 and launch.is_primary() is True
    assert launch.spawn_if_needed("recombiner_tpu_torch.cli.train", [], None, "cpu") is False
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    np.testing.assert_array_equal(launch.fetch_global(x), x)
    np.testing.assert_array_equal(launch.shard_rows_global(x, None).numpy(), x)
    monkeypatch.setenv("RECOMBINER_TPU_MULTIHOST", "yes")
    assert launch.multihost_enabled() and launch.launched()


# ------------------------------------------------------------ collectives


def test_collectives_take_unequal_shards_and_rank_values(training):
    """At 2 ranks: ``gather_rows`` and ``fetch_global`` of 1 and 2 rows give
    the 3 rows in rank order on both ranks (the sizes gathered first); the
    max and the any of values that differ by rank, and a rank-ordered sum,
    are the same on both ranks."""
    want = np.array([[0.0, 0.0], [1.0, 1.0], [1.0, 1.0]])
    runs = [r["collectives"] for r in training["two"]]
    for c in runs:
        np.testing.assert_array_equal(c["gathered"], want)
        np.testing.assert_array_equal(c["fetched"], want.astype(np.int64))
        assert c["max"] == 2 and c["any"] is True and c["none"] is False
    assert runs[0]["sum"] == runs[1]["sum"] == np.float32(np.float32(0.1) + np.float32(0.2))


# --------------------------------------------------------------- training


@pytest.mark.parametrize("world", [2, 4])
def test_dp_training_matches_one_process(training, world):
    """sgd_epochs over 2 and 4 ranks: the metrics (``_close``) and every leaf
    of the gathered state (``_state_close``) of the port in one process;
    the M-step to rtol 1e-4."""
    one = training["one"]["tiny"]
    start = training["jax"][("tiny", 2)]["start"]
    for r in _dp_runs(training, world):
        assert r["sharded"]
        _close(r["mse"], one["mse"], "mse")
        _close(r["kl"], one["kl"], "kl")
        _leaves_close(r["state"], one["state"], start, LR, 3, f"world {world}")
        for g, w in zip(r["m_step"], one["m_step"]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_training_matches_jax_sharded(training, world):
    """The same against the JAX package's ``sgd_epochs`` over as many of its
    virtual devices (GSPMD's collectives), and its M-step (rtol 1e-4)."""
    want = training["jax"][("tiny", world)]
    r = _dp_runs(training, world)[0]
    _close(r["mse"], want["mse"], "mse")
    _close(r["kl"], want["kl"], "kl")
    _leaves_close(r["state"], want["state"], want["start"], LR, 3, "vs jax")
    for g, w in zip(r["m_step"], want["m_step"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_shared_leaves_are_bitwise_equal_on_every_rank(training, world):
    """The A matrices and the conv stack after the rank-ordered gradient
    sums: bitwise the same on every rank, as is every gathered leaf."""
    runs = _dp_runs(training, world)
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r["shared"], runs[0]["shared"]))
        assert all(np.array_equal(a, b) for a, b in zip(r["state"], runs[0]["state"]))
        assert r["mse"] == runs[0]["mse"] and r["kl"] == runs[0]["kl"]
    em = [r["tiny"]["em"] for r in training["two"]]
    assert all(torch.equal(a, b) for a, b in zip(em[0]["shared"], em[1]["shared"]))


def test_dp_em_iterations_match(training):
    """Three EM iterations at 2 ranks (beta's update from the global KL and
    row count, the M-step over sharded rows): beta at every iteration as in
    one process and in the JAX package (rel 1e-6), the history (``_close``),
    the state (``_state_close``)."""
    r = training["two"][0]["tiny"]["em"]
    one = training["one"]["tiny"]["em"]
    want = training["jax"][("tiny", 2)]["em"]
    start = training["jax"][("tiny", 2)]["start"]
    np.testing.assert_allclose(r["hist"][2], one["hist"][2], rtol=1e-6)
    np.testing.assert_allclose(r["hist"][2], want["hist"][2], rtol=1e-6)
    for k in (0, 1):
        _close(r["hist"][k], want["hist"][k], f"history {k}")
    _leaves_close(r["state"], want["state"], start, LR, 6, "em vs jax")
    _leaves_close(r["state"], one["state"], start, LR, 6, "em vs one process")
    for g, w in zip(r["priors"], one["priors"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7)


def test_dp_patch_mode_with_hierarchy(training):
    """TINY_PATCH's three levels at 2 ranks (2 datapoints each: the stitched
    canvas, expand_level and the h and hh rows stay on their rank): the mse
    within rtol 1e-4 of one process and of JAX over 4 devices, every leaf
    (``_state_close``)."""
    r = training["two"][0]["tiny_patch"]
    one = training["one"]["tiny_patch"]
    want = training["jax"][("tiny_patch", 4)]
    assert r["sharded"]
    assert np.isclose(r["mse"], one["mse"], rtol=1e-4)
    assert np.isclose(r["mse"], want["mse"], rtol=1e-4)
    _leaves_close(r["state"], one["state"], want["start"], LR, 3, "patch vs one process")
    _leaves_close(r["state"], want["state"], want["start"], LR, 3, "patch vs jax")
    two = training["two"]
    assert all(torch.equal(a, b) for a, b in zip(two[0]["tiny_patch"]["shared"],
                                                 two[1]["tiny_patch"]["shared"]))


# ------------------------------------------------------------------ encode


N_ENC, S, ENC_LR, P1, FT = 8, 2, 2e-4, 20, 2


@pytest.fixture(scope="module")
def encode(tmp_path_factory):
    """TINY, 8 datapoints: compress with JAX's phase-1 and CRN finetune
    noise replayed at 2 ranks, in one process and in the JAX package over 8
    devices; the adaptive runs at 2 ranks and in one process."""
    out = tmp_path_factory.mktemp("encode")
    jart, art = _artifacts()
    cfg = jart.config
    prior = str(out / "prior.npz")
    checkpoint.save_prior_artifact(prior, art)
    X = np.ascontiguousarray(np.broadcast_to(
        grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim),
        (N_ENC, cfg.n_pixels, cfg.fourier_dim))).astype(np.float32)
    Y = _images(N_ENC, seed=3).reshape(N_ENC, cfg.n_pixels, 3)
    jcodec, jstate = jenc.init_codec(jart, N_ENC)
    key = jax.random.key(4)
    mesh = jmesh.make_mesh()
    jres = jprog.compress(jmesh.shard_rows(jcodec, mesh), jmesh.shard_rows(jstate, mesh),
                          jmesh.shard_rows(jnp.asarray(X), mesh),
                          jmesh.shard_rows(jnp.asarray(Y), mesh), cfg, key,
                          n_optimize_epochs=P1, sample_size=S, lr=ENC_LR,
                          finetune_overrides={"w": FT}, finetune_crn=True)
    k, sub = jax.random.split(key)
    crn_key = jax.random.fold_in(k, 0x0C12)
    replay = dict(prior=prior, X=X, Y=Y, S=S, lr=ENC_LR,
                  eps=np.asarray(jcodec.w.eps), gumbel=np.asarray(jcodec.w.gumbel),
                  phase1=[_replayed_noise(k1, cfg, N_ENC, S) for k1 in jax.random.split(sub, P1)],
                  crn=[_replayed_noise(k1, cfg, N_ENC, S)
                       for k1 in jax.random.split(jax.random.split(crn_key)[1], FT)])
    noise = [_replayed_noise(k1, cfg, N_ENC, S) for k1 in jax.random.split(jax.random.key(6), 60)]
    adaptive = dict(prior=prior, X=X, Y=Y, S=S, lr=LR, noise=noise, min_epoch=8, window=4,
                    rel_tol=0.02)
    inp = str(out / "encode_in.pt")
    torch.save({"replay": replay, "adaptive": adaptive}, inp)
    spawn(workers.encode_worker, 2, inp, str(out))
    one_res, _ = workers.replayed_compress(replay, Mesh())
    one_ad = workers.adaptive_runs(adaptive, Mesh())
    return dict(jart=jart, art=art, X=X, Y=Y, jres=jres, one=one_res, one_ad=one_ad,
                two=_load(str(out), "encode", 2), out=out)


def _psnr(rec, Y):
    return -10 * np.log10(np.mean((rec - Y) ** 2))


def test_sharded_compress_matches_one_process_and_jax(encode, tmp_path):
    """compress over 2 ranks (rows sharded) with JAX's noise replayed: every
    rank returns the same indices and reconstruction; against the port in
    one process and the JAX package over 8 devices, at least 98% of the
    indices equal and the PSNR within 0.3 dB (the agreement measured on the
    CPU is total); the bitstream decodes in both packages within
    DECODE_TOL."""
    two, one, jres = encode["two"], encode["one"], encode["jres"]
    assert two[0]["replay"]["sharded"]
    for r in two[1:]:
        np.testing.assert_array_equal(r["replay"]["indices"], two[0]["replay"]["indices"])
        np.testing.assert_array_equal(r["replay"]["reconstruction"],
                                      two[0]["replay"]["reconstruction"])
    got = two[0]["replay"]
    Y = encode["Y"]
    for what, want, rec in (("one process", one.indices["w"], one.reconstruction),
                            ("jax", np.asarray(jres.indices["w"]),
                             np.asarray(jres.reconstruction))):
        frac = float(np.mean(got["indices"] == want))
        gap = _psnr(got["reconstruction"], Y) - _psnr(rec, Y)
        print(f"2 ranks against {what}: indices equal {frac}, PSNR gap {gap:+.6f} dB")
        assert frac >= 0.98, frac
        assert abs(gap) < 0.3
    art, jart, X = encode["art"], encode["jart"], encode["X"]
    cfg = art.config
    path = str(tmp_path / "bitstream_test_id_0.rctb")
    bitstream.write_bitstream(path, {"w": got["indices"]}, config_name=cfg.name,
                              codebook_seed=art.codebook_seed, bits_per_group=cfg.bits_per_group)
    _, idx_t = bitstream.read_bitstream(path)
    _, idx_j = jax_bitstream.read_bitstream(path)
    y_port = decoder.decode(decoder.init_codec(art, N_ENC, device="cpu")[0], idx_t, X, cfg)
    y_jax = jenc.decode(jenc.init_codec(jart, N_ENC)[0], idx_j, jnp.asarray(X), jart.config)
    np.testing.assert_allclose(y_port.numpy(), np.asarray(y_jax), **DECODE_TOL)
    np.testing.assert_allclose(y_port.numpy(), got["reconstruction"], **DECODE_TOL)


def test_adaptive_encode_stops_alike_on_every_rank(encode):
    """Each rank's rows differ, and its window sums differ: ``optimize_adaptive``
    sums them over the ranks before the test, so both ranks stop at the same
    epoch as one process does, with the same carry; an adaptive compress
    (phase-1 and finetune stops) spends the same epochs on both ranks."""
    runs = [r["adaptive"] for r in encode["two"]]
    one = encode["one_ad"]
    assert runs[0]["done"] == runs[1]["done"] == one["done"]
    assert runs[0]["stopped"] and runs[1]["stopped"] and one["stopped"]
    assert runs[0]["done"] < 60
    assert runs[0]["es"] == runs[1]["es"]
    _close(np.array(runs[0]["es"]), np.array(one["es"]), "carry")
    assert runs[0]["timings"] == runs[1]["timings"] == one["timings"]
    t = runs[0]["timings"]
    assert t["phase1_epochs"] < 60 and t["finetune_epochs"] < t["finetune_budget"]
    np.testing.assert_array_equal(runs[0]["indices"], runs[1]["indices"])


# ------------------------------------------------------- TP and pixel axis


def test_tp_forward_matches_inr_forward_and_jax(training):
    """The column-sharded A (2 x 2 (data, model) ranks): each A_l of TINY's
    hidden layers split 2 ways, the output layer's whole; the forward
    within 1e-5 of ``inr_forward`` and of the JAX package's
    ``tp_inr_forward`` on a 2 x 4 mesh."""
    A, x, h_w = training["tp_in"]
    cfg = get_config("tiny")
    want = inr_forward(torch.from_numpy(x), torch.from_numpy(h_w),
                       [torch.from_numpy(a) for a in A], cfg).numpy()
    jmesh_tp = jax_make_mesh_tp(2, 4)
    y_jax = np.asarray(jax_tp_inr_forward(jnp.asarray(x), jnp.asarray(h_w),
                                          jax_shard_A([jnp.asarray(a) for a in A], jmesh_tp),
                                          JTINY, jmesh_tp))
    np.testing.assert_allclose(y_jax, np.asarray(jax_inr_forward(jnp.asarray(x),
                                                                 jnp.asarray(h_w),
                                                                 [jnp.asarray(a) for a in A],
                                                                 JTINY)), atol=1e-5)
    for r in training["grid"]:
        t = r["tp"]
        assert t["A_shapes"] == [(d, d // 2) if d % 2 == 0 else (d, d)
                                 for d in cfg.layer_param_counts]
        assert t["A_shapes"][-1] == (27, 27) and t["A_shapes"][0][1] < t["A_shapes"][0][0]
        np.testing.assert_allclose(t["y"], want, atol=1e-5)
        np.testing.assert_allclose(t["y"], y_jax, atol=1e-5)
        np.testing.assert_array_equal(t["y"], training["grid"][0]["tp"]["y"])


def test_pixel_axis_sharding(training):
    """sgd_epochs on a 2 x 2 (data, pixels) grid: each rank renders half the
    pixels of one datapoint; the mse within rtol 1e-4 of one process, the
    shared leaves bitwise equal on every rank, the state (``_state_close``)."""
    grid = [r["pixels"] for r in training["grid"]]
    one = training["pix_one"]
    start = training["pix"]["state"]
    for r in grid:
        assert np.isclose(r["mse"], one["mse"], rtol=1e-4), (r["mse"], one["mse"])
        _close(r["kl"], one["kl"], "kl")
        assert all(torch.equal(a, b) for a, b in zip(r["shared"], grid[0]["shared"]))
        _leaves_close(r["state"], one["state"], start, LR, 3, "pixels")
    assert math.isfinite(grid[0]["mse"])
