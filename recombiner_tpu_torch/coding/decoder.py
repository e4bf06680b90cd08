"""Codec context, rendering and decode: the receiving half of
``recombiner_tpu/coding/encoder.py`` (lines 56-130, 136-266, 269-329 and
932-1004), plus the sampling form of ``predict`` that the sender's half
(``coding/encoder.py``) optimises through.

Decode is deterministic given the indices: every cell is frozen at its
decoded codebook sample with zero scale, so the result matches the JAX
package up to f32 rounding with no shared random numbers. Posteriors are
kept in PHYSICAL (param-order, physical-row) layout as in the JAX package;
the coded (group-order, budget-mixed-row) view exists only as index maps:

    coded cell (r', c) <-> physical cell (r, d):
    d = param2group[c], r = perm_g2p[r', c]; c = group2param[d],
    r' = beta_row[r, d]

Patch configs code three levels: w per patch row, h per block of
``level2_patch_nums`` patches, hh per datapoint; the rows of w and h are
mixed across patches per coded column (``perm_g2p``), so that every coded
row draws on all patches' budgets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from recombiner_tpu_torch.coding.codebook import make_codebook
from recombiner_tpu_torch.coding.gumbel import gumbel_chain
from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.device import (
    DeviceLike,
    deterministic_convs,
    exact_f32,
    resolve_device,
)
from recombiner_tpu_torch.io.checkpoint import LevelArtifact, PriorArtifact
from recombiner_tpu_torch.io.convert import torch_params_from_artifact
from recombiner_tpu_torch.models.gaussian import Gaussian, scale_transform
from recombiner_tpu_torch.models.mappings import lpe_to_pe, sample_hierarchical_latents
from recombiner_tpu_torch.ops.fused_inr import inr_forward_fused
from recombiner_tpu_torch.parallel.mesh import Partition, gather_rows, local_rows

LEVELS = ("w", "h", "hh")


@dataclasses.dataclass
class LevelMeta:
    """Static per-level coding metadata."""

    pp_loc: torch.Tensor  # (D,) prior in param order
    pp_scale: torch.Tensor  # (D,)
    p_loc: torch.Tensor  # (Dpad,) prior in coded order, padded
    p_scale: torch.Tensor  # (Dpad,)
    group_start: torch.Tensor  # (G,) coded offsets
    group_size: torch.Tensor  # (G,)
    group_idx: torch.Tensor  # (D,) coded position -> group id
    param2group: torch.Tensor  # (D,) coded position -> param index
    group2param: torch.Tensor  # (D,) param index -> coded position
    group_of_col: torch.Tensor  # (D,) param index -> group id
    perm_g2p: Optional[torch.Tensor]  # (R, D) coded row -> physical row, per coded column
    beta_row: Optional[torch.Tensor]  # (R, D) physical cell -> its coded row, per param column
    eps: torch.Tensor  # (n_samples, Gmax) codebook
    gumbel: torch.Tensor  # (n_samples,) A* perturbations, bitstream format
    D: int
    Dpad: int
    Gmax: int
    n_groups: int


@dataclasses.dataclass
class LevelState:
    """Per-level posterior state in physical (param-order) layout; group
    bookkeeping in coded-row/group layout."""

    q: Gaussian  # (R, D)
    frozen_mask: torch.Tensor  # (R, D) 1.0 where coded
    frozen_val: torch.Tensor  # (R, D)
    kl_beta: torch.Tensor  # (R, G)
    compressed: torch.Tensor  # (R, G) bool
    indices: torch.Tensor  # (R, G) transmitted sample indices

    def map_rows(self, fn, coded_fn=None) -> "LevelState":
        """``fn`` on every per-row tensor (all of them lead with the rows):
        on the physical ones (posteriors, frozen cells), and ``coded_fn``
        (default ``fn``) on the coded ones (``kl_beta``, ``compressed``,
        ``indices``)."""
        coded_fn = fn if coded_fn is None else coded_fn
        return LevelState(q=Gaussian(fn(self.q.loc), fn(self.q.log_scale)),
                          frozen_mask=fn(self.frozen_mask), frozen_val=fn(self.frozen_val),
                          **{f: coded_fn(getattr(self, f)) for f in ("kl_beta", "compressed",
                                                                     "indices")})


@dataclasses.dataclass
class Codec:
    """Frozen coding context: per-level metadata + the learned mappings."""

    w: LevelMeta
    h: Optional[LevelMeta]
    hh: Optional[LevelMeta]
    A: Tuple[torch.Tensor, ...]
    up: dict  # {conv{i}: {w (O, I, *k), b}}

    @property
    def device(self) -> torch.device:
        return self.A[0].device

    @property
    def level_names(self) -> Tuple[str, ...]:
        return ("w",) if self.h is None else LEVELS

    def meta(self, name: str) -> LevelMeta:
        return getattr(self, name)


@dataclasses.dataclass
class CodecState:
    w: LevelState
    h: Optional[LevelState] = None
    hh: Optional[LevelState] = None
    # how the rows lie over the ranks (None: one process, all rows)
    part: Optional[Partition] = None

    def level(self, name: str) -> LevelState:
        return getattr(self, name)

    def replace_level(self, name: str, ls: LevelState) -> "CodecState":
        return dataclasses.replace(self, **{name: ls})

    def _map_rows(self, fn, part) -> "CodecState":
        """``fn(tensor, layout)`` on every per-row tensor, with the layout of
        its level's physical or coded rows under ``part`` (None:
        ``self.part``); the result is recorded as laid out by ``part``."""
        lay = self.part if part is None else part

        def level(n: str):
            ls = self.level(n)
            if ls is None:
                return None
            if lay is None:
                return ls.map_rows(lambda t: fn(t, None))
            return ls.map_rows(lambda t: fn(t, lay.level(n)), lambda t: fn(t, lay.coded(n)))

        return CodecState(part=part, **{n: level(n) for n in LEVELS})

    def shard_rows(self, part: Partition) -> "CodecState":
        """This rank's block of a whole state's rows, recorded as laid out
        by ``part`` (a level or a coded view that ``part`` keeps whole stays
        whole)."""
        return self._map_rows(local_rows, part)

    def gathered(self) -> "CodecState":
        """Every rank's rows on every rank (a collective when sharded)."""
        return self._map_rows(gather_rows, None)


def _round_up(x: int, m: int = 128) -> int:
    return ((x + m - 1) // m) * m


def patch_permutations(n_rows: int, n_cols: int) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv), each (n_rows, n_cols) int32: column c is the numpy stream
    ``RandomState(c).choice(n_rows, n_rows, False)``, inv its inverse. Part
    of the bitstream format: the JAX package's ``native.patch_permutations``
    and its RandomState fallback (``encoder.py:156-173``) give the same
    arrays. One RandomState reseeded per column draws the same stream as a
    new one per column and spares building a generator per column (the
    time is in PERF.md: ``chip_smoke.py``, phase "Kodak decode")."""
    perm = np.empty((n_rows, n_cols), np.int32)
    inv = np.empty((n_rows, n_cols), np.int32)
    rs = np.random.RandomState()
    rows = np.arange(n_rows, dtype=np.int32)
    for c in range(n_cols):
        rs.seed(c)
        order = rs.choice(n_rows, n_rows, False)
        perm[:, c] = order
        inv[order, c] = rows
    return perm, inv


def _make_level_meta(lv: LevelArtifact, level_name: str, n_rows: int, permute_rows: bool,
                     codebook_seed: int, gumbel_seed: int, bits_per_group: int,
                     codebook_kind: str, device: torch.device) -> LevelMeta:
    g = lv.grouping
    D = g.n_params
    Gmax = _round_up(g.max_group_size)
    Dpad = D + Gmax
    p2g = g.param2group
    p_loc = np.zeros(Dpad, np.float32)
    p_scale = np.ones(Dpad, np.float32)
    p_loc[:D] = lv.p_loc[p2g]
    p_scale[:D] = lv.p_scale[p2g]
    perm = beta_row = None
    if permute_rows:
        # the cross-patch budget-mixing permutation, one per coded column
        # (encoder.py:147-173), regenerated alike at decode
        perm, inv = patch_permutations(n_rows, D)
        beta_row = inv[:, g.group2param]
    n_samples = 2**bits_per_group
    eps = make_codebook(codebook_seed, level_name, n_samples, Gmax, codebook_kind)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return LevelMeta(
        pp_loc=f32(lv.p_loc),
        pp_scale=f32(lv.p_scale),
        p_loc=f32(p_loc),
        p_scale=f32(p_scale),
        group_start=i64(g.group_start),
        group_size=i64(g.group_sizes),
        group_idx=i64(g.group_idx),
        param2group=i64(p2g),
        group2param=i64(g.group2param),
        group_of_col=i64(g.group_idx[g.group2param]),
        perm_g2p=None if perm is None else i64(perm),
        beta_row=None if beta_row is None else i64(beta_row),
        eps=f32(eps),
        gumbel=f32(gumbel_chain(n_samples, gumbel_seed)),
        D=D,
        Dpad=Dpad,
        Gmax=Gmax,
        n_groups=g.n_groups,
    )


def _init_level_state(lv: LevelArtifact, meta: LevelMeta, n_rows: int,
                      kl_beta: float) -> LevelState:
    """Posteriors initialised from the prior: loc = p_loc, raw scale = the
    training-average log_scale."""
    dev = meta.pp_loc.device
    D, G = meta.D, meta.n_groups
    log_scale = torch.as_tensor(np.asarray(lv.avg_log_scale, np.float32), device=dev)
    return LevelState(
        q=Gaussian(loc=meta.pp_loc.expand(n_rows, D), log_scale=log_scale.expand(n_rows, D)),
        frozen_mask=torch.zeros(n_rows, D, device=dev),
        frozen_val=torch.zeros(n_rows, D, device=dev),
        kl_beta=torch.full((n_rows, G), float(kl_beta), device=dev),
        compressed=torch.zeros(n_rows, G, dtype=torch.bool, device=dev),
        indices=torch.zeros(n_rows, G, dtype=torch.int64, device=dev),
    )


def init_codec(artifact: PriorArtifact, n_rows: int, codebook_kind: Optional[str] = None,
               initial_beta: Optional[float] = None,
               device: DeviceLike = None) -> Tuple[Codec, CodecState]:
    """Build the coding context and a fresh state for ``n_rows`` rows
    (datapoints, or patches of a patch config) on ``device`` (None: the CUDA
    card). A patch config gets levels h and hh beside w, each with its own
    codebook; the rows of w and h are mixed across patches per coded
    column. The codebook kind defaults to the artifact's: it is bitstream
    format, not a tuning knob."""
    cfg = artifact.config
    dev = resolve_device(device)
    beta = artifact.kl_beta if initial_beta is None else initial_beta
    kind = artifact.codebook_kind if codebook_kind is None else codebook_kind
    seed = artifact.codebook_seed
    rows = {"w": n_rows}
    if cfg.patch:
        rows.update(h=cfg.rows_level2(n_rows), hh=cfg.rows_level3(n_rows))
    metas, states = {}, {}
    for name, r in rows.items():
        lv = getattr(artifact, name)
        metas[name] = _make_level_meta(lv, name, r, cfg.patch and name != "hh", seed, seed,
                                       cfg.bits_per_group, kind, dev)
        states[name] = _init_level_state(lv, metas[name], r, beta)
    A, up = torch_params_from_artifact(artifact, dev)
    return Codec(A=tuple(A), up=up, **{n: metas.get(n) for n in LEVELS}), CodecState(**states)


def _effective(ls: LevelState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend frozen samples into the posterior: coded positions take the
    transmitted sample with zero scale."""
    fm = ls.frozen_mask
    loc = ls.q.loc * (1.0 - fm) + ls.frozen_val * fm
    scale = scale_transform(ls.q.log_scale) * (1.0 - fm)
    return loc, scale


def decode_level_values(meta: LevelMeta, indices: torch.Tensor) -> torch.Tensor:
    """Transmitted indices (R, G) -> coded-order values (R, D):
    z[r, c] = p_loc[c] + p_scale[c] * eps[idx[r, g(c)], off(c)]."""
    D = meta.D
    gidx = meta.group_idx
    offs = torch.arange(D, device=gidx.device) - meta.group_start[gidx]
    sel = indices[:, gidx]
    return meta.p_loc[:D] + meta.p_scale[:D] * meta.eps[sel, offs[None, :]]


def _coded_to_physical(x_coded: torch.Tensor, meta: LevelMeta) -> torch.Tensor:
    """phys[r, d] = coded[beta_row[r, d], group2param[d]]; without row
    mixing beta_row[r, d] = r."""
    if meta.beta_row is None:
        return x_coded.index_select(1, meta.group2param)
    return x_coded[meta.beta_row, meta.group2param[None, :]]


def decode_state(codec: Codec, indices: Dict[str, object], cfg: ModalityConfig) -> CodecState:
    """A fully frozen CodecState from the transmitted indices alone
    ({'w': (R, G)}, and 'h', 'hh' for a patch config)."""

    def level(name: str) -> LevelState:
        meta = codec.meta(name)
        # validated where they arrive (the host, for indices read from a
        # bitstream), before they move to the device
        idx = torch.as_tensor(indices[name], dtype=torch.int64)
        if idx.numel():
            lo, hi = torch.stack(torch.aminmax(idx)).tolist()
            if lo < 0 or hi >= meta.eps.shape[0]:
                raise ValueError(f"level {name}: indices outside the codebook's "
                                 f"{meta.eps.shape[0]} samples")
        idx = idx.to(codec.device)
        R = idx.shape[0]
        vals = _coded_to_physical(decode_level_values(meta, idx), meta)
        dev = vals.device
        return LevelState(
            q=Gaussian(loc=vals, log_scale=torch.full((R, meta.D), -1e9, device=dev)),
            frozen_mask=torch.ones(R, meta.D, device=dev),
            frozen_val=vals,
            kl_beta=torch.zeros(R, meta.n_groups, device=dev),
            compressed=torch.ones(R, meta.n_groups, dtype=torch.bool, device=dev),
            indices=idx,
        )

    return CodecState(**{name: level(name) for name in codec.level_names})


# Standard-normal noise of one predict: (LPE (R, S, *lpe_spatial,
# latent_dim), w (R, S, n_inr)), and for a patch config h (R2, S, D_h) and
# hh (R3, S, D_hh) after them.
Noise = Sequence[torch.Tensor]


def draw_noise(codec: Codec, state: CodecState, cfg: ModalityConfig, sample_size: int,
               generator: Optional[torch.Generator] = None) -> Noise:
    """The noise of one ``predict``, drawn from ``generator`` in the order the
    JAX package splits its key (LPE, then w, h, hh: ``encoder.py:304``,
    ``models/mappings.py:147``), or zero without one. Every rank's rows are
    drawn and this rank keeps its own (``state.part``; an upper level kept
    whole is whole), so a row's noise does not depend on the world size."""
    S = sample_size
    R = state.w.q.loc.shape[0]
    shapes = [(R, S, *cfg.lpe_spatial, cfg.latent_dim), (R, S, cfg.n_inr_params)]
    for name in codec.level_names[1:]:
        shapes.append((state.level(name).q.loc.shape[0], S, codec.meta(name).D))
    dev = state.w.q.loc.device
    if generator is None:
        return [torch.zeros(s, device=dev) for s in shapes]
    parts = noise_layouts(codec, state.part)
    return [local_rows(torch.randn((p.global_rows(s[0]) if p else s[0], *s[1:]),
                                   generator=generator, device=dev), p)
            for s, p in zip(shapes, parts)]


def noise_layouts(codec: Codec, part: Optional[Partition]) -> list:
    """The layout of each tensor of a ``Noise`` (LPE, w, then h, hh) under
    ``part``: w's for the first two, each upper level's own after them."""
    if part is None:
        return [None] * (1 + len(codec.level_names))
    return [part, part] + [part.level(n) for n in codec.level_names[1:]]


def predict(codec: Codec, state: CodecState, X: torch.Tensor, cfg: ModalityConfig,
            sample_size: int = 1, generator: Optional[torch.Generator] = None,
            noise: Optional[Noise] = None) -> torch.Tensor:
    """Render the INR from the current (partially coded) posteriors:
    X (R, P, fourier_dim) -> (R, S, P, out_dim), S = ``sample_size``.

    The standard-normal noise is ``noise`` (``Noise``) when given (the tests
    replay the JAX package's draws through it, and the ELBO draws it before
    a rematerialised forward); else ``draw_noise`` from ``generator``; else
    zero, which renders the posterior means and is exact for a fully frozen
    state (every scale is zero): the decode form."""
    loc, scale = _effective(state.w)
    n_inr = cfg.n_inr_params
    R, D = loc.shape
    S = sample_size
    dev = loc.device
    if noise is None:
        noise = draw_noise(codec, state, cfg, S, generator)
    eps = [torch.as_tensor(n, dtype=torch.float32, device=dev) for n in noise]
    lpe = loc[:, None, n_inr:] + scale[:, None, n_inr:] * eps[0].reshape(R, S, D - n_inr)
    lpe = lpe.reshape(R, S, *cfg.lpe_spatial, cfg.latent_dim)
    pe = lpe_to_pe(codec.up, lpe, cfg, state.part)
    x = torch.cat([X[:, None].expand(*pe.shape[:3], X.shape[-1]), pe], -1)
    upper = {}
    for name, e in zip(codec.level_names[1:], eps[2:]):
        upper[name] = (*_effective(state.level(name)), e)
    h_w = sample_hierarchical_latents(loc[:, :n_inr], scale[:, :n_inr], eps[1], cfg,
                                      part=state.part, **upper)
    return inr_forward_fused(x, h_w, codec.A, cfg)


def decode(codec: Codec, indices: Dict[str, object], X, cfg: ModalityConfig) -> torch.Tensor:
    """indices {'w': (R, G)} (and 'h', 'hh' for a patch config) ->
    reconstruction (R, P, out) on the codec's device, in exact f32 (TF32
    off) in every precision mode, as the JAX package decodes at
    precision='highest', and on deterministic cuDNN algorithms, as the
    encode's epochs run: cuDNN's own choice may depend on the strides and
    the workspace it finds, and a receiver's decode should not."""
    with exact_f32(), deterministic_convs():
        state = decode_state(codec, indices, cfg)
        X = torch.as_tensor(X, dtype=torch.float32, device=codec.device)
        return predict(codec, state, X, cfg)[:, 0]
