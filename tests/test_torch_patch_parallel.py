"""One datapoint's patch rows split over ranks (``parallel/mesh.py``'s slab
layout, the conv canvas's halo in ``parallel/halo.py``, the gathered coding
steps), on the CPU: ranks are spawned gloo processes (one spawn per world
size, in a module fixture), held to the port in one process and to the JAX
package, unsharded and after ``shard_rows`` over conftest's virtual
devices, as ``tests/test_torch_parallel.py`` holds whole-datapoint
sharding. The rank functions live in ``torch_parallel_workers.py``.

Tolerances:

- the halo-split ``lpe_to_pe`` and its LPE gradient: within 1e-5 of the
  largest entry (``_near``) of the whole canvas in one process and of the
  JAX package's ``lpe_to_pe`` (``jax.vjp`` for the gradient);
- an encode: every rank's indices and reconstruction equal, and against
  the port in one process and the JAX package at least 98% of the indices
  equal and the PSNR within 0.3 dB (the JAX bar,
  ``tests/test_parallel.py:166-170``), or at least 1 - 2 (1 - a) of them
  where the one-process encode nudged by 1e-7 keeps only a < 99% of its
  own (``NUDGE``); a decoded bitstream within ``DECODE_TOL``.

TINY_PATCH groups its h rows by patch column (``level2_patch_nums`` (2,
1)), so one image over 2 ranks (a patch row each) keeps h and hh whole on
every rank; the 4 x 2-patch geometry below splits h with w at 2 ranks.
"""

import dataclasses
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from recombiner_tpu.coding import encoder as jenc
from recombiner_tpu.coding import progressive as jprog
from recombiner_tpu.config import get_config as jax_get_config
from recombiner_tpu.io import bitstream as jax_bitstream
from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu.models import mappings as jmap
from recombiner_tpu.parallel import mesh as jmesh
from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.coding import decoder
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.data import pipeline
from recombiner_tpu_torch.io import bitstream, checkpoint, convert, encode_state
from recombiner_tpu_torch.models import mappings
from recombiner_tpu_torch.parallel import launch
from recombiner_tpu_torch.parallel.mesh import Mesh, partition

import torch_parallel_workers as workers
from test_torch_encode import DECODE_TOL
from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_patch import FIXTURE, _images, _noise

SPAWN_S = 300  # each spawn's limit, and every collective's
# The encode of two images is not determined by f32: the port in one
# process, its initial w means nudged by 1e-7 (relative), moves 5 of its
# own 152 indices (all in w; 96.7% kept), as many as the 2-rank encode
# differs in (the CPU's conv stack rounds a batch of one image otherwise
# than one of two). Where the nudge moves more than 1% of the indices, the
# 2-rank encode is held to at most twice the cells it moves, 1 - 2 (1 -
# agreement), the bar of chip_smoke.py's scale-out phase, instead of 98%.
# One image is stable (the nudge moves none): 98% stands.
NUDGE = 1e-7
S, LR, P1, FT = 2, 2e-4, 20, 2
LEVELS = ("w", "h", "hh")

# geometries: (config, override of its patch grid, datapoints)
TALL = dict(pixel_sizes=(32, 32), patch_nums=(4, 2), level2_patch_nums=(2, 1),
            level3_patch_nums=(4, 2))  # 4 x 2 patches of 2 x 2 latents
GEOMETRIES = {
    2: {"tiny_patch": ("tiny_patch", {}, 1),
        "tall": ("tiny_patch", TALL, 1),
        "tiny_audio": ("tiny_audio", {}, 1),
        "video": ("tiny_video", dict(patch_nums=(1, 4, 2), level2_patch_nums=(1, 2, 1),
                                     level3_patch_nums=(1, 4, 2)), 1)},
    4: {"tall": ("tiny_patch", TALL, 1),
        "tall_two_images": ("tiny_patch", TALL, 2)},
}


def _near(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=what)


def _up(d, rng):
    """Conv stack weights of a ``d``-D config, in the artifact's (*k, I, O)
    layout."""
    up = {}
    for i, (cin, cout, k) in enumerate([(128, 64, 5), (64, 64, 3), (64, 16, 3)]):
        b = 1 / np.sqrt(cin * k**d)
        up[f"conv{i}"] = {"w": rng.uniform(-b, b, (*(k,) * d, cin, cout)).astype(np.float32),
                          "b": rng.uniform(-b, b, cout).astype(np.float32)}
    return up


def _lpe_case(base, geometry, n_data, seed):
    cfg = dataclasses.replace(get_config(base), **geometry)
    jcfg = dataclasses.replace(jax_get_config(base), **geometry)
    rng = np.random.default_rng(seed)
    up = _up(cfg.data_dim, rng)
    R = n_data * cfg.patches_per_datapoint
    lpe = rng.normal(0, 1, (R, S, *cfg.lpe_spatial, cfg.latent_dim)).astype(np.float32)
    dy = rng.normal(0, 1, (R, S, cfg.n_pixels, cfg.upsample_out)).astype(np.float32)
    return dict(cfg=cfg, jcfg=jcfg, n_data=n_data, up=up, lpe=lpe, dy=dy)


def _one_process(case):
    """The whole canvas in one process (the port) and in the JAX package."""
    up = convert.torch_params_from_artifact(types.SimpleNamespace(A=[], up=case["up"]),
                                            "cpu")[1]
    lpe = torch.from_numpy(case["lpe"]).requires_grad_()
    pe = mappings.lpe_to_pe(up, lpe, case["cfg"])
    (g,) = torch.autograd.grad(pe, lpe, torch.from_numpy(case["dy"]))
    jup = jax.tree_util.tree_map(jnp.asarray, case["up"])
    jpe, vjp = jax.vjp(lambda x: jmap.lpe_to_pe(jup, x, case["jcfg"]), jnp.asarray(case["lpe"]))
    (jg,) = vjp(jnp.asarray(case["dy"]))
    return {"pe": pe.detach().numpy(), "grad": g.numpy(), "jax_pe": np.asarray(jpe),
            "jax_grad": np.asarray(jg)}


def _encode_case(n_images, seed):
    """A TINY_PATCH encode of ``n_images`` images: the JAX package's codebooks
    and its phase-1 and CRN finetune noise (as numpy)."""
    jart = jck.load_prior_artifact(FIXTURE)
    art = checkpoint.load_prior_artifact(FIXTURE)
    cfg = art.config
    X, Y = pipeline.points_from_data(_images(n_images, (32, 32), seed=seed), cfg)
    R = X.shape[0]
    jcodec = jenc.init_codec(jart, R)[0]
    own = decoder.init_codec(art, R, device="cpu")[0]
    k, sub = jax.random.split(jax.random.key(11 + n_images))
    crn_key = jax.random.fold_in(k, 0x0C12)
    return dict(prior=FIXTURE, X=X, Y=Y, S=S, lr=LR, key=11 + n_images,
                codebooks={n: (np.asarray(jcodec.meta(n).eps), np.asarray(jcodec.meta(n).gumbel))
                           for n in LEVELS},
                phase1=[_noise(k1, own, R, cfg) for k1 in jax.random.split(sub, P1)],
                crn=[_noise(k1, own, R, cfg)
                     for k1 in jax.random.split(jax.random.split(crn_key)[1], FT)])


def _jax_compress(case, n_devices):
    """The JAX package's compress of ``case`` (its own noise, which the port
    replays) over ``n_devices`` virtual devices, rows after ``shard_rows``."""
    jart = jck.load_prior_artifact(FIXTURE)
    mesh = jmesh.make_mesh(n_devices)
    jc, js = jenc.init_codec(jart, case["X"].shape[0])
    r = jprog.compress(jmesh.shard_rows(jc, mesh), jmesh.shard_rows(js, mesh),
                       jmesh.shard_rows(jnp.asarray(case["X"]), mesh),
                       jmesh.shard_rows(jnp.asarray(case["Y"]), mesh), jart.config,
                       jax.random.key(case["key"]), n_optimize_epochs=P1, sample_size=S, lr=LR,
                       finetune_overrides={n: FT for n in LEVELS}, finetune_crn=True)
    return {"indices": {lv: np.asarray(r.indices[lv]) for lv in LEVELS},
            "reconstruction": np.asarray(r.reconstruction)}


# the JAX package's runs of each encode: (images, virtual devices); each
# compiles its programs anew (about 13 s on the CPU), so two images run on
# 2 devices only
JAX_RUNS = {"one_image": (1, 2), "two_images": (2,)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawns at 2 and 4 ranks (in a thread: the ranks are processes of
    their own) while the JAX package and the port in one process run
    here."""
    out = tmp_path_factory.mktemp("patch_parallel")
    lpe = {w: {name: _lpe_case(base, geo, n, seed)
               for seed, (name, (base, geo, n)) in enumerate(cases.items())}
           for w, cases in GEOMETRIES.items()}
    enc = {"one_image": _encode_case(1, seed=4), "two_images": _encode_case(2, seed=4)}
    # a snapshot taken in one process (crashed at level h), resumed at 2 ranks
    snap = dict(prior=FIXTURE, X=enc["one_image"]["X"], Y=enc["one_image"]["Y"], S=S, lr=2e-3,
                epochs=10, one_rank_state=str(out / "one_rank_state.npz"))
    art, _, state = workers._codec(snap)
    save = workers.crash_at_h(snap["one_rank_state"])
    try:
        with pytest.raises(workers.Crash):
            workers.generator_compress(snap, Mesh(), state, snap["one_rank_state"])
    finally:
        encode_state.save_encode_state = save
    images = out / "images"
    images.mkdir()
    Image.fromarray(np.round(_images(1, (32, 32), seed=7)[0] * 255).astype(np.uint8)).save(
        images / "0.png")
    cli = ["--test_dir", str(images), "--test_idx", "0", "--prior_path", FIXTURE,
           "--save_dir", str(out / "cli"), "--device", "cpu", "--sample_size", "2",
           "--n_epochs", "4", "--finetune_epochs", "1", "--n_devices", "2"]
    inputs = {}
    for world in (2, 4):
        inputs[world] = str(out / f"in_{world}.pt")
        strip = {name: {k: v for k, v in c.items() if k != "jcfg"}
                 for name, c in lpe[world].items()}
        torch.save({"lpe": strip, "encode": enc, "snapshot": snap, "cli": cli}, inputs[world])
    failed = []

    def spawns():
        try:
            for world in (2, 4):
                launch.spawn(workers.patch_worker, world, (inputs[world], str(out)),
                             timeout_s=SPAWN_S)
        except BaseException as e:  # re-raised below, in the test's thread
            failed.append(e)

    thread = threading.Thread(target=spawns)
    thread.start()
    try:
        jax_runs = {name: {n: _jax_compress(enc[name], n) for n in devs}
                    for name, devs in JAX_RUNS.items()}
        one = {name: workers._summary(*workers.replayed_compress(c, Mesh()))
               for name, c in enc.items()}
        nudged = {name: workers._summary(*workers.replayed_compress({**c, "nudge": NUDGE},
                                                                    Mesh()))
                  for name, c in enc.items()}
        full_one = workers._summary(*workers.generator_compress(snap, Mesh(), state))
    finally:
        thread.join()
    if failed:
        raise failed[0]
    ranks = {world: [torch.load(str(out / f"patch{world}_{r}.pt"), weights_only=False)
                     for r in range(world)] for world in (2, 4)}
    resume, restored = compress_cli.resume_from(str(out / "two_ranks_state.npz"), art, "cpu")
    resumed_one = workers._summary(*workers.generator_compress(snap, Mesh(), restored, None,
                                                               resume))
    return types.SimpleNamespace(out=out, lpe=lpe, enc=enc, jax=jax_runs, ranks=ranks, one=one,
                                 nudged=nudged, full_one=full_one, resumed_one=resumed_one,
                                 art=art)


# ------------------------------------------------------------- the layout


@pytest.mark.parametrize("world,name", [(w, n) for w, c in GEOMETRIES.items() for n in c])
def test_halo_split_lpe_to_pe_and_its_gradient_match_the_whole_canvas(runs, world, name):
    """Each rank stitches its slab, takes a halo of latent rows from its
    neighbours, upsamples and crops: the gathered PEs and LPE gradients
    match the whole canvas in one process and the JAX package's
    ``lpe_to_pe`` (``_near``); every rank gathers the same arrays."""
    case = runs.lpe[world][name]
    want = _one_process(case)
    got = runs.ranks[world]
    assert got[0]["lpe"][name]["slab"] is not None
    for r in got:
        np.testing.assert_array_equal(r["lpe"][name]["pe"], got[0]["lpe"][name]["pe"])
    g = got[0]["lpe"][name]
    _near(g["pe"], want["pe"], "PE vs one process")
    _near(g["grad"], want["grad"], "gradient vs one process")
    _near(g["pe"], want["jax_pe"], "PE vs jax")
    _near(g["grad"], want["jax_grad"], "gradient vs jax")
    _near(want["pe"], want["jax_pe"], "one process vs jax")


def test_the_slab_layout_of_each_geometry(runs):
    """Which levels are split: w always; h with w where a rank's h rows
    cover its slabs (the 4 x 2 geometry at 2 ranks, audio's 1-D one), else
    whole; hh whole; the halo 1 latent row, 2 for the video stack's axis."""
    two, four = runs.ranks[2][1]["lpe"], runs.ranks[4][3]["lpe"]
    assert two["tiny_patch"]["whole"] == ("h", "hh")
    assert two["tall"]["whole"] == ("hh",) and four["tall"]["whole"] == ("h", "hh")
    assert two["tiny_audio"]["whole"] == ("hh",)
    assert two["video"]["slab"].halo == 2 and two["tall"]["slab"].halo == 1
    assert four["tall"]["slab"].index == 3 and four["tall"]["slab"].count == 4
    assert four["tall_two_images"]["slab"].index == 1
    assert four["tall_two_images"]["slab"].count == 2


# ----------------------------------------------------------------- encode


def _psnr(rec, Y):
    return -10 * np.log10(np.mean((rec - Y) ** 2))


def _equal_share(got, want):
    """The share of the indices (every level) that are equal."""
    a = np.concatenate([np.ravel(got["indices"][n]) for n in LEVELS])
    b = np.concatenate([np.ravel(want["indices"][n]) for n in LEVELS])
    return float(np.mean(a == b))


def _agree(got, want, Y, what, floor=0.98):
    """At least ``floor`` of the indices (every level) equal and the PSNR
    within 0.3 dB."""
    frac = _equal_share(got, want)
    gap = _psnr(got["reconstruction"], Y) - _psnr(want["reconstruction"], Y)
    print(f"{what}: indices equal {frac}, PSNR gap {gap:+.6f} dB")
    assert frac >= floor, (what, frac, floor)
    assert abs(gap) < 0.3, (what, gap)


@pytest.mark.parametrize("name", ["one_image", "two_images"])
def test_patch_encode_over_two_ranks_matches_one_process_and_jax(runs, name, tmp_path):
    """A TINY_PATCH encode over 2 ranks with JAX's noise replayed: one image
    (a patch row a rank, h and hh whole) and two (an image a rank, the
    coded rows of w and h whole on every rank). Every rank returns the
    same indices and reconstruction; against the port in one process and
    the JAX package (``JAX_RUNS``: unsharded and over 2 virtual devices
    for one image, over 2 for two), the JAX bar (``_agree``), or where the
    encode itself is not determined by f32 the bar of ``NUDGE``; the bitstream decodes in both packages within
    DECODE_TOL."""
    ranks = [r["encode"][name] for r in runs.ranks[2]]
    assert ranks[0]["sharded"] and (ranks[0]["slab"] is not None) == (name == "one_image")
    for r in ranks[1:]:
        for n in LEVELS:
            np.testing.assert_array_equal(r["indices"][n], ranks[0]["indices"][n])
        np.testing.assert_array_equal(r["reconstruction"], ranks[0]["reconstruction"])
    got, Y = ranks[0], runs.enc[name]["Y"]
    stable = _equal_share(runs.nudged[name], runs.one[name])
    floor = min(0.98, 1 - 2 * (1 - stable))
    print(f"{name}: one process against itself nudged by {NUDGE}: indices equal {stable}")
    _agree(got, runs.one[name], Y, "2 ranks against one process", floor)
    for n_dev, want in runs.jax[name].items():
        _agree(got, want, Y, f"2 ranks against jax on {n_dev} device(s)", floor)
    art, cfg, X = runs.art, runs.art.config, runs.enc[name]["X"]
    path = str(tmp_path / "bitstream_test_id_0.rctb")
    bitstream.write_bitstream(path, got["indices"], config_name=cfg.name,
                              codebook_seed=art.codebook_seed, bits_per_group=cfg.bits_per_group)
    _, idx_t = bitstream.read_bitstream(path)
    _, idx_j = jax_bitstream.read_bitstream(path)
    R = X.shape[0]
    codec = decoder.init_codec(art, R, device="cpu")[0]
    jart = jck.load_prior_artifact(FIXTURE)
    jcodec = jenc.init_codec(jart, R)[0]
    for n in LEVELS:  # the codebooks the encode coded against
        codec = convert.with_codebook(codec, jcodec.meta(n), n)
    y_port = decoder.decode(codec, idx_t, X, cfg).numpy()
    y_jax = np.asarray(jenc.decode(jcodec, idx_j, jnp.asarray(X), jart.config))
    np.testing.assert_allclose(y_port, y_jax, **DECODE_TOL)
    np.testing.assert_allclose(y_port, got["reconstruction"], **DECODE_TOL)


def test_snapshots_resume_across_world_sizes(runs):
    """A snapshot taken at 2 ranks (crashed after level h's first one: every
    row gathered, rank 0 wrote) resumes in one process, and one taken in
    one process resumes at 2 ranks; each resumed encode meets the JAX bar
    against the uninterrupted encode at the other world size."""
    snap, header, _ = encode_state.load_encode_state_full(
        str(runs.out / "two_ranks_state.npz"), device="cpu")
    assert header["level"] == "h" and snap.w.q.loc.shape[0] == 4
    assert snap.hh.compressed.all() and not snap.w.compressed.any()
    Y = runs.enc["one_image"]["Y"]
    two = runs.ranks[2]
    _agree(runs.resumed_one, two[0]["full"], Y, "2-rank snapshot resumed in one process")
    _agree(two[0]["resumed"], runs.full_one, Y, "1-rank snapshot resumed at 2 ranks")
    _agree(two[0]["full"], runs.full_one, Y, "2 ranks against one process")
    for r in two[1:]:
        for n in LEVELS:
            np.testing.assert_array_equal(r["resumed"]["indices"][n],
                                          two[0]["resumed"]["indices"][n])


def test_cli_compress_shards_one_patch_image_over_two_ranks(runs):
    """``cli.compress --n_devices 2 --device cpu`` in a group of 2 ranks on
    one TINY_PATCH image: it says the rows are sharded and why, and rank 0
    writes the files."""
    said = runs.ranks[2][0]["cli"]
    assert "Encoding on 2 ranks (rows sharded: 1 of 2 patches along axis 0" in said, said
    assert sorted(os.listdir(runs.out / "cli")) == [
        "Distortion_test_id_0.csv", "GroupIndex_test_id_0.csv", "HH_GroupIndex_test_id_0.csv",
        "H_GroupIndex_test_id_0.csv", "bitstream_test_id_0.rctb"]
    assert runs.ranks[2][1]["cli"] == ""
    assert partition(Mesh(2, 0), 1, get_config("tiny_patch")).sharded
