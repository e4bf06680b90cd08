"""Rank functions of the port's multi-process tests (``test_torch_parallel.py``,
``test_torch_multiprocess.py``), in a module of their own so that a spawned
rank imports torch and the port only, never jax.

Each function runs in every rank of a group that
``recombiner_tpu_torch.parallel.launch.spawn`` started, reads its inputs from
a ``torch.save`` file that the test wrote, and writes ``{name}_{rank}.pt``
beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import shutil
import sys
import types

import numpy as np
import torch

from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.coding import decoder, encoder, progressive
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.io import checkpoint, convert, encode_state
from recombiner_tpu_torch.models import mappings
from recombiner_tpu_torch.models.inr import inr_forward
from recombiner_tpu_torch.parallel import launch, tp
from recombiner_tpu_torch.parallel.mesh import (
    Partition,
    gather_rows,
    global_any,
    global_max,
    make_mesh,
    make_mesh_2d,
    ordered_sum,
    partition,
    pixel_partition,
    shard_data_and_pixels,
    shard_rows,
)
from recombiner_tpu_torch.priors import trainer as tr


def _load(path):
    return torch.load(path, weights_only=False)


def _save(obj, out_dir, name, rank):
    torch.save(obj, os.path.join(out_dir, f"{name}_{rank}.pt"))


def _feeder(noise):
    """A callable noise source returning the given epochs' global noise."""
    it = iter(noise)
    return lambda: next(it)


def _shared(state):
    return [t.clone() for t in state.leaves()[2 * len(state.posteriors()):]]


# ----------------------------------------------------------------- training


def train_case(case, mesh):
    """sgd_epochs, m_step and em_iters of one case on this rank's rows of
    ``case``'s datapoints, with the given global noise per epoch."""
    cfg = get_config(case["cfg"])
    state0, priors = convert.prior_state_from(case["state"], case["priors"], cfg, "cpu")
    part = partition(mesh, case["n_data"])
    state0 = shard_rows(state0, part)
    X = shard_rows(torch.from_numpy(case["X"]), part)
    Y = shard_rows(torch.from_numpy(case["Y"]), part)
    out = {"sharded": part.sharded}
    s1, m = tr.sgd_epochs(state0, X, Y, priors, case["beta"], _feeder(case["noise"]), cfg=cfg,
                          n_epochs=case["n_epochs"], lr=case["lr"])
    out["mse"], out["kl"] = float(m.mse), float(m.kl)
    out["shared"] = _shared(s1)
    out["state"] = convert.prior_state_leaves(s1.gathered())[0]
    out["m_step"] = [t.numpy() for t in tr.m_step(s1).leaves()]
    if "em_noise" in case:
        lo, hi = case["budget"]
        s2, p2, beta, hist = tr.em_iters(state0, X, Y, priors, 1e-8, _feeder(case["em_noise"]),
                                         lo, hi, cfg=cfg, n_iters=case["em_iters"],
                                         n_epochs=case["em_epochs"], lr=case["lr"])
        out["em"] = {"state": convert.prior_state_leaves(s2.gathered())[0],
                     "priors": [t.numpy() for t in p2.leaves()], "beta": float(beta),
                     "hist": [np.asarray(h) for h in hist], "shared": _shared(s2)}
    return out


def collectives(rank, mesh):
    """The collectives on values that differ by rank: shards of unequal
    size (rank r holds r + 1 rows), a max and an any of rank-local values,
    a rank-ordered sum."""
    part = Partition(mesh, mesh.world, True)
    rows = torch.full((rank + 1, 2), float(rank))
    return {"gathered": gather_rows(rows, part).numpy(),
            "fetched": launch.fetch_global(rows.to(torch.int64), part),
            "max": global_max(rank + 1, part), "any": global_any(rank == 1, part),
            "none": global_any(False, part),
            "sum": ordered_sum(torch.tensor([0.1 * (rank + 1)]), part).item()}


def train_worker(rank, inp, out_dir):
    torch.set_num_threads(1)
    mesh = make_mesh()
    out = {name: train_case(case, mesh) for name, case in _load(inp).items()}
    out["collectives"] = collectives(rank, mesh)
    _save(out, out_dir, "train", rank)


# ------------------------------------------------------------------- encode


def _codec(c, device="cpu"):
    art = checkpoint.load_prior_artifact(c["prior"])
    codec, state = decoder.init_codec(art, c["X"].shape[0], device=device)
    books = dict(c.get("codebooks", {}))
    if "eps" in c:
        books["w"] = (c["eps"], c["gumbel"])
    for name, (eps, gumbel) in books.items():  # the JAX package's, so that both code alike
        codec = dataclasses.replace(codec, **{name: dataclasses.replace(
            codec.meta(name), eps=torch.tensor(eps), gumbel=torch.tensor(gumbel))})
    return art, codec, state


def _layout(c, cfg, mesh):
    """The encode layout of ``c``'s rows (``partition`` with the config)."""
    return partition(mesh, c["X"].shape[0] // cfg.patches_per_datapoint, cfg)


def replayed_compress(c, mesh):
    """``compress`` with JAX's phase-1 noise and CRN finetune noise replayed
    (global arrays; each rank keeps its rows), every level's finetunes as
    long as the CRN stream; with ``c['nudge']`` from initial w means
    nudged by that much (relative)."""
    art, codec, state = _codec(c)
    if c.get("nudge"):  # the initial w means scaled by (1 + nudge)
        w = state.w
        state = state.replace_level("w", dataclasses.replace(
            w, q=dataclasses.replace(w.q, loc=w.q.loc * (1 + c["nudge"]))))
    part = _layout(c, art.config, mesh)
    crn = c["crn"]
    real = progressive.finetune_noise
    progressive.finetune_noise = lambda gen, on: (lambda: _feeder(crn))
    try:
        res = progressive.compress(
            codec, shard_rows(state, part), shard_rows(c["X"], part), shard_rows(c["Y"], part),
            art.config, _feeder(c["phase1"]), n_optimize_epochs=len(c["phase1"]),
            sample_size=c["S"], finetune_overrides={n: len(crn) for n in codec.level_names},
            lr=c["lr"], finetune_crn=True)
    finally:
        progressive.finetune_noise = real
    return res, part


def adaptive_runs(a, mesh):
    """``optimize_adaptive`` with replayed global noise, and an adaptive
    ``compress`` (phase-1 and finetune stops), on this rank's rows."""
    art, codec, state = _codec(a)
    part = partition(mesh, a["X"].shape[0])
    Xl, Yl = shard_rows(torch.from_numpy(a["X"]), part), shard_rows(torch.from_numpy(a["Y"]), part)
    _, _, es, done, stopped = encoder.optimize_adaptive(
        codec, shard_rows(state, part), Xl, Yl, art.config, _feeder(a["noise"]), 0,
        len(a["noise"]), a["min_epoch"], a["rel_tol"], (np.inf, 0.0), lr=a["lr"],
        sample_size=a["S"], window=a["window"], monitor="mse")
    ad = progressive.compress(codec, shard_rows(state, part), Xl, Yl, art.config,
                              torch.Generator().manual_seed(3), sample_size=a["S"],
                              n_optimize_epochs=60, phase1_stop=(4, 5e-3, 8),
                              finetune_stop=(2, 1e-2, 2), finetune_overrides={"w": 8},
                              fused_steps=4, chunk_epochs=20)
    timings = {k: v for k, v in ad.timings.items() if not k.endswith("_s")}
    return {"es": es, "done": done, "stopped": stopped, "timings": timings,
            "indices": ad.indices["w"]}


def encode_worker(rank, inp, out_dir):
    """The replayed-noise compress, and the adaptive runs with unequal rows
    on the ranks."""
    torch.set_num_threads(1)
    c = _load(inp)
    mesh = make_mesh()
    res, part = replayed_compress(c["replay"], mesh)
    _save({"replay": {"indices": res.indices["w"], "reconstruction": res.reconstruction,
                      "distortion": res.distortion, "sharded": part.sharded},
           "adaptive": adaptive_runs(c["adaptive"], mesh)}, out_dir, "encode", rank)


class Crash(RuntimeError):
    pass


RESUME_KW = dict(n_optimize_epochs=20, chunk_epochs=10, phase1_stop=(4, 1e-9, 100),
                 finetune_overrides={"w": 2}, save_every=5)


def resumable_compress(r, mesh, state, state_path, resume=None):
    """``compress`` with a snapshot at every 10 phase-1 epochs (in the middle
    of a 4-epoch stop window) and every 5 groups."""
    art, codec, _ = _codec(r)
    part = partition(mesh, r["X"].shape[0])
    return progressive.compress(
        codec, shard_rows(state, part), shard_rows(r["X"], part), shard_rows(r["Y"], part),
        art.config, torch.Generator().manual_seed(5), sample_size=r["S"], state_path=state_path,
        state_extra={"prior_fingerprint": checkpoint.prior_fingerprint(art)}, **RESUME_KW,
        **(resume or {}))


def resume_worker(rank, inp, out_dir):
    """A compress uninterrupted; the same crashed after its first snapshot
    (a phase-1 one, on every rank), the snapshot kept, and resumed."""
    torch.set_num_threads(1)
    r = _load(inp)
    mesh = make_mesh()
    art, _, state = _codec(r)
    path = os.path.join(out_dir, "enc_state.npz")
    full = resumable_compress(r, mesh, state, os.path.join(out_dir, "enc_state_full.npz"))
    save = encode_state.save_encode_state

    def crashing(*a, **k):
        save(*a, **k)
        raise Crash("after the first snapshot")

    encode_state.save_encode_state = crashing
    try:
        resumable_compress(r, mesh, state, path)
        raise AssertionError("no snapshot was taken")
    except Crash:
        pass
    finally:
        encode_state.save_encode_state = save
    torch.distributed.barrier()
    if rank == 0:
        shutil.copy(path, os.path.join(out_dir, "crash_snapshot.npz"))
    torch.distributed.barrier()
    resume, restored = compress_cli.resume_from(path, art, "cpu")
    again = resumable_compress(r, mesh, restored, path, resume)
    _save({"full": full.indices["w"], "full_loc": full.state.w.q.loc.numpy(),
           "full_rec": full.reconstruction, "again": again.indices["w"],
           "again_loc": again.state.w.q.loc.numpy(), "resume_at": resume["phase1_epochs_done"],
           "sharded": partition(mesh, r["X"].shape[0]).sharded}, out_dir, "resume", rank)


# ---------------------------------------------------------------------- CLI


def _record_writes(under):
    """Every file under ``under`` this process opens for writing."""
    seen = []
    root = os.path.realpath(under)

    def hook(event, args):
        if event == "open" and isinstance(args[0], str) and args[1] is not None:
            mode = args[1] if isinstance(args[1], str) else ""
            flags = args[2] if len(args) > 2 and isinstance(args[2], int) else 0
            writes = any(m in mode for m in "wax+") or flags & (os.O_WRONLY | os.O_RDWR)
            if writes and os.path.realpath(args[0]).startswith(root):
                seen.append(os.path.relpath(os.path.realpath(args[0]), root))

    sys.addaudithook(hook)
    return seen


def cli_worker(rank, runs, out_dir):
    """Run each (module, argv) CLI in this rank of a group that is already up
    (so the CLI does not spawn), recording the files each rank writes."""
    torch.set_num_threads(1)
    import importlib

    seen = _record_writes(out_dir)
    for module, argv in runs:
        importlib.import_module(module).main(list(argv))
    _save(sorted(set(seen)), out_dir, "writes", rank)


# ------------------------------------------------------------ 4-rank grids


def grid_worker(rank, inp, out_dir):
    """At world size 4: data-parallel sgd_epochs; the TP forward on a 2 x 2
    (data, model) grid; pixel-axis sgd_epochs on a 2 x 2 (data, pixels)
    grid."""
    torch.set_num_threads(1)
    c = _load(inp)
    out = {"train": {name: train_case(case, make_mesh()) for name, case in c["train"].items()}}

    t = c["tp"]
    cfg = get_config(t["cfg"])
    mesh = tp.make_mesh_tp(2, 2)
    A = [torch.from_numpy(a) for a in t["A"]]
    A_tp = tp.shard_A(A, mesh)
    rows = tp.data_partition(mesh, t["x"].shape[0])
    x = shard_rows(torch.from_numpy(t["x"]), rows)
    h_w = shard_rows(torch.from_numpy(t["h_w"]), rows)
    y = tp.tp_inr_forward(x, h_w, A_tp, cfg, mesh)
    out["tp"] = {"y": gather_rows(y, rows).numpy(),
                 "A_shapes": [tuple(a.shape) for a in A_tp],
                 "y_local_plain": inr_forward(x, h_w, A, cfg).numpy()}

    p = c["pixels"]
    cfg = get_config(p["cfg"])
    state0, priors = convert.prior_state_from(p["state"], p["priors"], cfg, "cpu")
    grid = make_mesh_2d(2, 2)
    part = pixel_partition(grid, p["X"].shape[0], p["X"].shape[1])
    X = shard_data_and_pixels(torch.from_numpy(p["X"]), part)
    Y = shard_data_and_pixels(torch.from_numpy(p["Y"]), part)
    s1, m = tr.sgd_epochs(shard_rows(state0, part), X, Y, priors, p["beta"],
                          _feeder(p["noise"]), cfg=cfg, n_epochs=p["n_epochs"], lr=p["lr"])
    out["pixels"] = {"mse": float(m.mse), "kl": float(m.kl), "shared": _shared(s1),
                     "state": convert.prior_state_leaves(s1.gathered())[0]}
    _save(out, out_dir, "grid", rank)


# ------------------------------------------------------ patch rows over ranks


def lpe_case(c, mesh):
    """``lpe_to_pe`` and its LPE gradient (cotangent ``dy``) on this rank's
    rows of ``c``'s canvas, gathered."""
    cfg = c["cfg"]
    part = partition(mesh, c["n_data"], cfg)
    up = convert.torch_params_from_artifact(types.SimpleNamespace(A=[], up=c["up"]), "cpu")[1]
    lpe = shard_rows(torch.from_numpy(c["lpe"]), part).requires_grad_()
    pe = mappings.lpe_to_pe(up, lpe, cfg, part)
    (g,) = torch.autograd.grad(pe, lpe, shard_rows(torch.from_numpy(c["dy"]), part))
    return {"slab": part.slab, "whole": part.whole,
            "pe": gather_rows(pe.detach(), part).numpy(), "grad": gather_rows(g, part).numpy()}


def _summary(res, part):
    return {"indices": res.indices, "reconstruction": res.reconstruction,
            "sharded": part.sharded, "slab": part.slab, "whole": part.whole,
            "w_loc": res.state.w.q.loc.numpy()}


def generator_compress(c, mesh, state, state_path=None, resume=None):
    """A patch ``compress`` from a seeded generator, snapshotting every 2
    groups to ``state_path``."""
    art, codec, _ = _codec(c)
    part = _layout(c, art.config, mesh)
    res = progressive.compress(
        codec, shard_rows(state, part), shard_rows(c["X"], part), shard_rows(c["Y"], part),
        art.config, torch.Generator().manual_seed(5), sample_size=c["S"], lr=c["lr"],
        n_optimize_epochs=c["epochs"], finetune_overrides={n: 1 for n in codec.level_names},
        state_path=state_path, save_every=2,
        state_extra={"prior_fingerprint": checkpoint.prior_fingerprint(art)}, **(resume or {}))
    return res, part


def crash_at_h(state_path):
    """``encode_state.save_encode_state`` replaced by one that raises
    ``Crash`` after the first snapshot of level h; returns the original."""
    save = encode_state.save_encode_state

    def crashing(path, state, **kw):
        save(path, state, **kw)
        if kw["extra"].get("level") == "h":
            raise Crash("h")

    encode_state.save_encode_state = crashing
    return save


def patch_worker(rank, inp, out_dir):
    """The halo-split canvases; at world size 2 also the replayed-noise
    patch encodes, a snapshot taken here (crashed at level h) and one taken
    in one process resumed here, and the compress CLI in this group."""
    torch.set_num_threads(1)
    c = _load(inp)
    mesh = make_mesh()
    out = {"lpe": {name: lpe_case(case, mesh) for name, case in c["lpe"].items()}}
    if mesh.world == 2:
        out["encode"] = {name: _summary(*replayed_compress(case, mesh))
                         for name, case in c["encode"].items()}
        snap = c["snapshot"]
        art, _, state = _codec(snap)
        path = os.path.join(out_dir, "two_ranks_state.npz")
        save = crash_at_h(path)
        try:
            generator_compress(snap, mesh, state, path)
            raise AssertionError("no snapshot at level h")
        except Crash:
            pass
        finally:
            encode_state.save_encode_state = save
        torch.distributed.barrier()
        out["full"] = _summary(*generator_compress(snap, mesh, state))
        resume, restored = compress_cli.resume_from(snap["one_rank_state"], art, "cpu")
        out["resumed"] = _summary(*generator_compress(snap, mesh, restored, None, resume))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            compress_cli.main(list(c["cli"]))
        out["cli"] = buf.getvalue()
    _save(out, out_dir, f"patch{mesh.world}", rank)
