"""The sender's half of ``recombiner_tpu/coding/encoder.py``: per-datapoint
posterior optimisation (the MC-ELBO with per-group KL annealing, Adam; for a
fixed number of epochs or up to a plateau) and the steps of progressive A*
coding with their finetunes, for every level (w, and h and hh of a patch
config).

The codec context, the state classes and ``predict`` live in
``coding/decoder.py``; this module changes a ``CodecState`` and returns a
new one. Posteriors stay in PHYSICAL (param-order) layout, so the
differentiated path has no gathers; the coded (group-order, budget-mixed
row) view is taken forward-only, through ``param2group`` and ``perm_g2p``.
With ``remat`` the ELBO's forward is recomputed in the backward
(``torch.utils.checkpoint``), with its noise drawn before it.

Determinism: group KLs are summed over a padded (R, G, Gmax) window with a
mask, not with ``index_add_``/``scatter_add_`` (atomics on CUDA), the
SIREN chain's gradient comes from ``siren_bwd``, whose sums run in a fixed
order, the patch hierarchy's broadcasts and stitch are reshapes, expands
and permutes (``models/mappings.py``), and the epochs run with cuDNN
restricted to deterministic algorithms (``deterministic_convs``: its own
choice for the conv stack's data gradient sums in no fixed order on the
H100), so an encode on one card repeats bit for bit given the generator.
``chip_smoke.py`` checks it there: two 20-epoch ``optimize`` runs from one
state and generator state, and crashed and resumed encodes (CIFAR, and
Kodak at level h) against uninterrupted ones, agree bit for bit (PERF.md
section 5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from recombiner_tpu_torch.coding.decoder import (
    Codec,
    CodecState,
    LevelMeta,
    LevelState,
    Noise,
    draw_noise,
    noise_layouts,
    predict,
)
from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.device import deterministic_convs, exact_f32
from recombiner_tpu_torch.device import precision as precision_scope
from recombiner_tpu_torch.models.gaussian import Gaussian, kl_gaussian, scale_transform
from recombiner_tpu_torch.parallel.mesh import (
    Partition,
    gather_rows,
    is_sharded,
    local_rows,
    ordered_sum,
    sum_all_over,
)

LOG2 = math.log(2.0)
KL_ADJUST_GAP = 10  # epochs between beta annealing steps (encoder.py:487)


# ------------------------------------------------------------------- KL


def level_kl(ls: LevelState, meta: LevelMeta) -> torch.Tensor:
    """Elementwise KL(q || p) in physical layout: (R, D), nats."""
    return kl_gaussian(ls.q.loc, scale_transform(ls.q.log_scale), meta.pp_loc, meta.pp_scale)


def _to_coded(x: torch.Tensor, meta: LevelMeta) -> torch.Tensor:
    """Physical (R, D) -> coded layout (R, D): coded cell (r', c) reads
    physical (perm_g2p[r', c], param2group[c]). Forward-only gathers."""
    x = x.index_select(1, meta.param2group)
    if meta.perm_g2p is not None:
        x = torch.gather(x, 0, meta.perm_g2p)
    return x


def _group_windows(meta: LevelMeta, groups: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coded columns of each group in ``groups`` padded to Gmax: (columns,
    clamped into [0, D); valid lanes), each (*groups.shape, Gmax)."""
    lane = torch.arange(meta.Gmax, device=groups.device)
    cols = meta.group_start[groups][..., None] + lane
    valid = lane < meta.group_size[groups][..., None]
    return cols.clamp(max=meta.D - 1), valid


def group_kl(ls: LevelState, meta: LevelMeta) -> torch.Tensor:
    """Per-(row, group) KL in nats, (R, G). Groups are contiguous in coded
    order, so each is a masked sum over its padded window: a fixed order,
    no atomics."""
    kl = _to_coded(level_kl(ls, meta), meta)
    cols, valid = _group_windows(meta, torch.arange(meta.n_groups, device=kl.device))
    return torch.where(valid, kl[:, cols], 0.0).sum(-1)


def beta_weighted_kl(ls: LevelState, meta: LevelMeta,
                     part: Optional[Partition] = None) -> torch.Tensor:
    """sum over cells of beta[owning coded row, owning group] * KL(cell). The
    beta factor is a gather of a detached tensor, so no gradient flows
    through it and the differentiated path stays elementwise. ``part`` is
    the layout of the level's physical rows: each rank takes the cells of
    its rows, their coded rows read from the whole ``kl_beta``."""
    beta = ls.kl_beta.detach()
    if meta.beta_row is None:
        factor = beta[:, meta.group_of_col]
    else:
        factor = beta[local_rows(meta.beta_row, part), meta.group_of_col[None, :]]
    return (level_kl(ls, meta) * factor).sum()


def coded_view(ls: LevelState, name: str, part: Optional[Partition]) -> LevelState:
    """``ls`` with posteriors in the layout of its coded rows: where those
    are whole on every rank and the physical rows split (a patch config's
    w and h), every rank's posteriors gathered, in rank order (every rank
    must call); else ``ls``. Forward-only: the group KLs and the coding
    steps read it."""
    if part is None or not is_sharded(part.level(name)) or is_sharded(part.coded(name)):
        return ls
    D = ls.q.loc.shape[1]
    loc, log_scale = gather_rows(torch.cat([ls.q.loc, ls.q.log_scale], 1), part).split(D, 1)
    return dataclasses.replace(ls, q=Gaussian(loc, log_scale))


def shared_levels(codec: Codec, part: Optional[Partition]) -> Tuple[str, ...]:
    """The levels every rank holds whole while the rows of w are split: each
    rank's loss reaches them through its own rows, so their gradient is the
    rank-ordered sum of every rank's part, and their KL is counted once,
    on rank 0."""
    if not is_sharded(part):
        return ()
    return tuple(n for n in codec.level_names if not is_sharded(part.level(n)))


def update_betas(ls: LevelState, meta: LevelMeta, bits_per_group: float,
                 upper_buffer: float = 0.0, lower_buffer: float = 0.4,
                 step: float = 0.05) -> LevelState:
    """Per-group multiplicative beta annealing toward the bit budget; coded
    groups keep their beta."""
    with torch.no_grad():
        kls_bits = group_kl(ls, meta) / LOG2
        beta = ls.kl_beta
        beta = beta * torch.where(kls_bits > bits_per_group + upper_buffer, 1.0 + step, 1.0)
        beta = beta / torch.where(kls_bits <= bits_per_group - lower_buffer, 1.0 + step, 1.0)
        beta = torch.clamp(beta, 0.0, 10000.0)
        beta = torch.where(ls.compressed, ls.kl_beta, beta)
    return dataclasses.replace(ls, kl_beta=beta)


def _anneal_all(state: CodecState, codec: Codec, cfg: ModalityConfig) -> CodecState:
    for name in codec.level_names:
        ls = state.level(name)
        beta = update_betas(coded_view(ls, name, state.part), codec.meta(name),
                            cfg.bits_per_group).kl_beta
        state = state.replace_level(name, dataclasses.replace(ls, kl_beta=beta))
    return state


# ------------------------------------------------------------ optimisation


NoiseSource = Union[torch.Generator, Callable[[], Noise]]


def trainable_levels(codec: Codec) -> Tuple[str, ...]:
    """The levels whose posteriors are optimised, in the order of optax's
    leaves over the JAX package's trainables dict {'w', 'h', 'hh'}: sorted
    by name."""
    return tuple(sorted(codec.level_names))


def _posteriors(state: CodecState, levels: Sequence[str]) -> List[torch.Tensor]:
    return [t for name in levels for t in (state.level(name).q.loc,
                                           state.level(name).q.log_scale)]


def _with_posteriors(state: CodecState, levels: Sequence[str],
                     params: Sequence[torch.Tensor]) -> CodecState:
    for k, name in enumerate(levels):
        state = state.replace_level(name, dataclasses.replace(
            state.level(name), q=Gaussian(params[2 * k], params[2 * k + 1])))
    return state


def elbo_loss(codec: Codec, state: CodecState, X: torch.Tensor, Y: torch.Tensor,
              cfg: ModalityConfig, sample_size: int,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Noise] = None,
              remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MC-ELBO of ``_elbo_loss_fn(with_aux=True)``: (mean squared error
    times the number of rows plus every level's beta-weighted KL, that
    scaled mean squared error). The second is the distortion term that
    ``optimize_adaptive(monitor='mse')`` watches.

    ``remat=True`` recomputes the forward in the backward
    (``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``,
    ``encoder.py:437-438``). The noise is drawn before the checkpointed
    function and passed in: a recomputed forward that drew from the
    generator again would get other noise, and a wrong gradient.

    With the rows of w split over ranks (``state.part``) this is this
    rank's part of the global loss: its rows' squared error and KL, and on
    rank 0 the KL of every level kept whole (``shared_levels``)."""
    if noise is None:
        noise = draw_noise(codec, state, cfg, sample_size, generator)
    levels = trainable_levels(codec)
    params = _posteriors(state, levels)
    part = state.part
    counted = [n for n in codec.level_names
               if n not in shared_levels(codec, part) or part.mesh.rank == 0]

    def loss_of(*params):
        st = _with_posteriors(state, levels, params)
        y_hat = predict(codec, st, X, cfg, sample_size, noise=noise)
        mse = torch.mean((y_hat - Y[:, None]) ** 2) * Y.shape[0]
        kl = sum(beta_weighted_kl(st.level(n), codec.meta(n), part and part.level(n))
                 for n in counted)
        return mse + kl, mse

    if remat:
        # the function draws no random numbers, so there is no RNG state to
        # preserve for the recomputation
        return torch.utils.checkpoint.checkpoint(loss_of, *params, use_reentrant=False,
                                                 preserve_rng_state=False)
    return loss_of(*params)


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and the two moments, one
    tensor per parameter ([loc, log_scale] of each level, the levels in
    ``trainable_levels`` order)."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]

    def leaves(self, scheduled: bool, part: Optional[Partition] = None,
               levels: Optional[Sequence[str]] = None) -> List[np.ndarray]:
        """The optax state's leaves in ``jax.tree_util`` order, as an encode
        snapshot stores them: count, mu (loc and log_scale of each level, the
        levels sorted: h, hh, w), nu alike, and with a schedule
        (``_make_opt``'s chain) the schedule's count after them. The moments
        of rows sharded by ``part`` are gathered (every rank must call);
        ``levels`` names the moments' levels (``trainable_levels``)."""
        count = np.asarray(self.count, np.int32)
        lay = _moment_layouts(part, levels, len(self.mu))
        out = [count] + [gather_rows(t.detach(), p).cpu().numpy()
                         for t, p in zip(self.mu + self.nu, lay + lay)]
        return out + [count] if scheduled else out

    def shard_rows(self, part: Optional[Partition],
                   levels: Optional[Sequence[str]] = None) -> "AdamState":
        """This rank's rows of a whole state's moments (``leaves``'
        ``levels``)."""
        lay = _moment_layouts(part, levels, len(self.mu))
        return AdamState(self.count, [local_rows(t, p) for t, p in zip(self.mu, lay)],
                         [local_rows(t, p) for t, p in zip(self.nu, lay)])

    @classmethod
    def from_leaves(cls, leaves: Sequence, scheduled: bool, device,
                    n_levels: int = 1) -> "AdamState":
        """Inverse of ``leaves``, from arrays of either package, for
        ``n_levels`` optimised levels."""
        n = 4 * n_levels
        want = n + 1 + int(scheduled)
        if len(leaves) != want:
            raise ValueError(f"{len(leaves)} optimizer leaves; Adam over {n_levels} level(s) "
                             f"{'with' if scheduled else 'without'} a schedule has {want}")
        count = int(np.asarray(leaves[0]))
        if scheduled and int(np.asarray(leaves[-1])) != count:
            raise ValueError("the schedule's step count differs from Adam's")
        t = [torch.tensor(np.asarray(a, np.float32), device=device) for a in leaves[1:n + 1]]
        return cls(count, t[:n // 2], t[n // 2:])


def _moment_layouts(part: Optional[Partition], levels: Optional[Sequence[str]],
                    n: int) -> list:
    """The layout of each of ``n`` moments ([loc, log_scale] of each of
    ``levels``) under ``part``."""
    if part is None:
        return [None] * n
    return [part.level(name) for name in levels for _ in range(2)]


LearningRate = Union[float, Callable[[int], float]]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def cosine_lr(peak: float, floor: float, total: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(peak, total, alpha=floor/peak) in f32:
    peak down to floor over ``total`` steps, then floor."""
    alpha = np.float32(float(floor) / float(peak))

    def lr(count: int) -> float:
        c = np.float32(min(count, total))
        decay = np.float32(0.5) * (np.float32(1)
                                   + np.cos(np.float32(np.pi) * c / np.float32(total)))
        return float(np.float32(peak) * ((np.float32(1) - alpha) * decay + alpha))

    return lr


def adam_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], st: AdamState,
              lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> AdamState:
    """One Adam step with optax's semantics (``optax.adam``, or its chain with
    ``scale_by_schedule`` when ``lr`` is a schedule of the step count, read
    before the count moves): bias-corrected moments, eps outside the square
    root. Updates ``params`` in place (they are the optimised leaves; in
    place saves a copy of the posterior per epoch) and returns the new
    state."""
    count = st.count + 1
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    step = lr(st.count) if callable(lr) else lr
    mu, nu = [], []
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, st.mu, st.nu):
            m = (1 - b1) * g + b1 * m
            v = (1 - b2) * (g * g) + b2 * v
            p.add_(-(step * ((m / bc1) / (torch.sqrt(v / bc2) + eps))))
            mu.append(m)
            nu.append(v)
    return AdamState(count, mu, nu)


def _trainables(codec: Codec, state: CodecState) -> List[torch.Tensor]:
    return [t.detach().clone().requires_grad_()
            for t in _posteriors(state, trainable_levels(codec))]


def _settled(codec: Codec, state: CodecState, params: Sequence[torch.Tensor]) -> CodecState:
    return _with_posteriors(state, trainable_levels(codec), [p.detach() for p in params])


def _epoch(codec: Codec, state: CodecState, params: List[torch.Tensor], X: torch.Tensor,
           Y: torch.Tensor, cfg: ModalityConfig, source: NoiseSource, i: int,
           opt_state: AdamState, lr: LearningRate, sample_size: int, remat: bool):
    """One epoch of ``encoder.py:487-569``: the gradient of every level's
    posteriors first, then every level's betas annealed when ``i %
    KL_ADJUST_GAP == 0`` (on the pre-step posteriors), then the Adam step.
    Returns (state, Adam state, loss, scaled mse), the last two detached."""
    levels = trainable_levels(codec)
    state = _with_posteriors(state, levels, params)
    drawn = ({"generator": source} if isinstance(source, torch.Generator)
             else {"noise": [local_rows(torch.as_tensor(n), p)
                             for n, p in zip(source(), noise_layouts(codec, state.part))]})
    loss, mse = elbo_loss(codec, state, X, Y, cfg, sample_size, remat=remat, **drawn)
    grads = list(torch.autograd.grad(loss, params))
    shared = [2 * k + j for k, n in enumerate(levels) if n in shared_levels(codec, state.part)
              for j in (0, 1)]
    if shared:  # every rank's part of a level it holds whole, summed in rank order
        for k, g in zip(shared, sum_all_over([grads[k] for k in shared], state.part.mesh)):
            grads[k] = g
    if i % KL_ADJUST_GAP == 0:
        state = _anneal_all(state, codec, cfg)
    opt_state = adam_step(params, grads, opt_state, lr)
    return state, opt_state, loss.detach(), mse.detach()


def optimize(codec: Codec, state: CodecState, X: torch.Tensor, Y: torch.Tensor,
             cfg: ModalityConfig, generator: NoiseSource, *, n_epochs: int,
             lr: LearningRate = 2e-4, sample_size: int = 5,
             opt_state: Optional[AdamState] = None, return_opt_state: bool = False,
             remat: bool = False, precision: Optional[str] = None):
    """MC-ELBO posterior optimisation with beta annealing, in the order of
    ``encoder.py:487-569`` (``_epoch``; ``i`` restarts at 0 in each call).
    Data-parallel (``state.part`` sharded, X and Y this rank's rows): A and
    the convs are frozen and the loss's terms are per row, so an epoch's
    collectives are only those of the layout: the conv canvas's halo where
    a datapoint's rows are split (forward and backward), the rank-ordered
    sum of the gradient of a level every rank holds whole, and every
    ``KL_ADJUST_GAP`` epochs the gathered posteriors of a level whose coded
    rows mix every rank's (``coded_view``). A callable noise source returns
    every rank's noise, of which each keeps its rows.
    Adam starts fresh unless ``opt_state`` is given; with
    ``return_opt_state`` the result is (state, Adam state), so one run can
    be split into chunks without changing it. Fresh noise per epoch from
    ``generator`` (or, in the tests, a callable that returns each epoch's
    noise). Runs at ``precision`` (``device.precision``: None the
    process's ambient, TF32 unless made exact; 'highest' exact f32; 'high'
    or 'default' TF32), as the JAX package's ``precision`` argument, on
    deterministic cuDNN algorithms. Every level is optimised and annealed;
    ``remat`` recomputes each epoch's forward in its backward
    (``elbo_loss``), which changes no number."""
    params = _trainables(codec, state)
    opt_state = adam_init(params) if opt_state is None else opt_state
    with precision_scope(precision), deterministic_convs():
        for i in range(n_epochs):
            state, opt_state, _, _ = _epoch(codec, state, params, X, Y, cfg, generator, i,
                                            opt_state, lr, sample_size, remat)
    out = _settled(codec, state, params)
    return (out, opt_state) if return_opt_state else out


def optimize_adaptive(codec: Codec, state: CodecState, X: torch.Tensor, Y: torch.Tensor,
                      cfg: ModalityConfig, generator: NoiseSource, epoch0: int, max_epoch: int,
                      min_epoch: float, rel_tol: float, es_carry: Tuple[float, float], *,
                      lr: LearningRate = 2e-4, sample_size: int = 5, window: int = 25,
                      opt_state: Optional[AdamState] = None, monitor: str = "loss",
                      remat: bool = False, precision: Optional[str] = None):
    """``optimize`` that stops on a plateau (``encoder.py:580-685``): the same
    epochs, from global epoch ``epoch0`` up to ``max_epoch``; after every
    ``window``-th global epoch, once ``min_epoch`` epochs have run, stop
    when the window's mean of the watched scalar (the loss, or with
    ``monitor='mse'`` the scaled mse) improves on the previous window's by
    less than ``rel_tol`` times its magnitude. ``i % KL_ADJUST_GAP`` and
    the window boundaries use the global epoch, so chunks that thread
    ``es_carry = (previous window mean, running window sum)`` (start:
    (inf, 0.0)) and ``opt_state`` run as one call. ``precision`` as in
    ``optimize``.

    The window sum is an f32 tensor on the device, summed in epoch order,
    and the test is evaluated in f32 as the JAX package's is; the host
    reads it once per window. Returns (state, Adam state, es_carry as
    floats, global epochs done, stopped).

    Data-parallel: each rank sums its rows' loss; at a window's end the
    window is summed over the ranks in rank order before the test, so every
    rank stops at the same epoch. The carried sum is global: rank 0 starts
    from it, the others from 0."""
    if monitor not in ("loss", "mse"):
        raise ValueError(f"monitor must be 'loss' or 'mse', not {monitor!r}")
    window = int(window)
    params = _trainables(codec, state)
    opt_state = adam_init(params) if opt_state is None else opt_state
    dev = state.w.q.loc.device
    part = state.part
    prev, cur = (torch.tensor(float(v), dtype=torch.float32, device=dev) for v in es_carry)
    if is_sharded(part) and part.mesh.rank != 0:
        cur = torch.zeros_like(cur)
    tol = torch.tensor(float(rel_tol), dtype=torch.float32, device=dev)
    i, stopped = int(epoch0), False
    with precision_scope(precision), deterministic_convs():
        while i < max_epoch and not stopped:
            state, opt_state, loss, mse = _epoch(codec, state, params, X, Y, cfg, generator, i,
                                                 opt_state, lr, sample_size, remat)
            cur = cur + (mse if monitor == "mse" else loss)
            i += 1
            if i % window == 0:
                win = ordered_sum(cur, part) / window
                if i >= min_epoch:
                    stopped = bool((prev - win < tol * win.abs()) & torch.isfinite(prev))
                prev, cur = win, torch.zeros_like(cur)
    return (_settled(codec, state, params), opt_state,
            (prev.item(), ordered_sum(cur, part).item()), i, stopped)


# ----------------------------------------------------------- encode step


def encode_step_level(ls: LevelState, meta: LevelMeta, part: Optional[Partition] = None,
                      name: str = "w") -> LevelState:
    """Code one group per row, all rows at once: pick each row's max-KL
    uncoded group, A*-score it against the shared codebook through the
    [eps^2, eps] matmul basis (in exact f32), freeze the winning sample.

    log q(z) - log p(z) at z = p_loc + p_scale * eps is alpha * eps^2 +
    beta * eps + const; the constant does not move the argmax. Rows whose
    groups are all coded are left as they are. With row mixing a coded
    row's window reads and writes physical cells (perm_g2p[r', c],
    param2group[c]): distinct for distinct (r', c), since each column of
    perm_g2p is a permutation, so the scatter has no duplicates.

    ``part`` is the rows' layout (``name`` the level): where the coded rows
    are whole and the physical rows split, every rank gathers the
    posteriors (``coded_view``), runs the same bookkeeping on every coded
    row, and freezes the cells of its own physical rows."""
    mine = part.level(name) if part is not None else None
    local = ls
    ls = coded_view(ls, name, part)
    R, Gmax = ls.q.loc.shape[0], meta.Gmax
    with torch.no_grad():
        kls = group_kl(ls, meta) / LOG2
        kls = kls.masked_fill(ls.compressed, -math.inf)
        g = torch.argmax(kls, dim=1)  # first maximum, as jnp.argmax
        cols, valid = _group_windows(meta, g)  # (R, Gmax)
        d_cols = meta.param2group[cols]
        if meta.perm_g2p is not None:
            rows = torch.gather(meta.perm_g2p, 1, cols)
        else:
            rows = torch.arange(R, device=g.device)[:, None].expand(R, Gmax)
        start = meta.group_start[g][:, None]
        win = start + torch.arange(Gmax, device=g.device)  # < Dpad: the prior is padded
        q_loc = ls.q.loc[rows, d_cols]
        q_scale = scale_transform(ls.q.log_scale[rows, d_cols])
        p_loc, p_scale = meta.p_loc[win], meta.p_scale[win]

        inv_q2 = 1.0 / (q_scale * q_scale)
        delta = p_loc - q_loc
        alpha = torch.where(valid, 0.5 * (1.0 - p_scale * p_scale * inv_q2), 0.0)
        beta = torch.where(valid, -delta * p_scale * inv_q2, 0.0)
        with exact_f32():
            scores = ((meta.eps * meta.eps) @ alpha.T + meta.eps @ beta.T
                      + meta.gumbel[:, None])
        idx = torch.argmax(scores, dim=0)  # (R,)
        z = p_loc + p_scale * meta.eps[idx]

        active = ~ls.compressed.all(dim=1)
        # valid lanes of active rows only: distinct cells, so the scatter has
        # no duplicates (the JAX package routes the others out of bounds)
        write = valid & active[:, None]
        if ls is not local:  # this rank's physical rows only
            blk = mine.block(R)
            write = write & (rows >= blk.start) & (rows < blk.stop)
            rows = rows - blk.start
        r_w, c_w = rows[write], d_cols[write]
        frozen_val = local.frozen_val.clone()
        frozen_mask = local.frozen_mask.clone()
        frozen_val[r_w, c_w] = z[write]
        frozen_mask[r_w, c_w] = 1.0
        coded = active[:, None] & (torch.arange(meta.n_groups, device=g.device) == g[:, None])
    return dataclasses.replace(
        local,
        frozen_val=frozen_val,
        frozen_mask=frozen_mask,
        kl_beta=torch.where(coded, 0.0, ls.kl_beta),
        compressed=ls.compressed | coded,
        indices=torch.where(coded, idx[:, None], ls.indices),
    )


def encode_step(codec: Codec, state: CodecState, level: str = "w") -> CodecState:
    return state.replace_level(level, encode_step_level(state.level(level), codec.meta(level),
                                                        state.part, level))


# ------------------------------------------------------- the coding loop

CRN_FOLD = 0x0C12  # the JAX package's fold_in(key, 0x0C12) (progressive.py:389)
FinetuneNoise = Callable[[], NoiseSource]


def finetune_noise(generator: torch.Generator, crn: bool = False) -> FinetuneNoise:
    """The noise of each coding finetune, as ``encode_chunk`` asks for it: the
    main generator, which runs on from finetune to finetune, or with ``crn``
    (common random numbers) one fixed stream that restarts at every
    finetune. That stream's generator is seeded from the main one's seed
    and 0x0C12 without drawing from it, so turning CRN on moves no other
    draw, and a resumed encode (whose generator state is restored, seed
    included) gets the same stream."""
    if not crn:
        return lambda: generator
    seed = np.random.SeedSequence([generator.initial_seed(), CRN_FOLD]).generate_state(
        1, np.uint64)[0]
    crn_gen = torch.Generator(device=generator.device).manual_seed(int(seed))
    start = crn_gen.get_state()

    def restart() -> torch.Generator:
        crn_gen.set_state(start)
        return crn_gen

    return restart


def encode_chunk(codec: Codec, state: CodecState, X: torch.Tensor, Y: torch.Tensor,
                 cfg: ModalityConfig, noise: FinetuneNoise, min_epoch: float = 0,
                 rel_tol: float = 0.0, *, n_steps: int, n_ft: int, lr: float = 2e-4,
                 sample_size: int = 5, window: int = 0, lr_schedule: Optional[str] = None,
                 level: str = "w", remat: bool = False,
                 precision: Optional[str] = None) -> Tuple[CodecState, np.ndarray]:
    """``n_steps`` group steps of ``encoder.py:796-926`` at ``level``, each an
    ``encode_step`` followed by a finetune (of every level, as the JAX
    package's) with a fresh Adam whose noise
    comes from ``noise()`` (``finetune_noise``: the main generator, or the
    restarted CRN stream). The finetune runs ``n_ft`` epochs, or with
    ``window > 0`` stops on a plateau of the loss (``optimize_adaptive``
    with its epoch counted from 0 in each finetune, ``n_ft`` the ceiling).
    ``lr_schedule='cosine'`` decays each finetune's lr from ``lr`` to 0
    over ``n_ft`` steps, a fresh schedule per group. The finetunes run at
    ``precision`` (``optimize``'s); the A* scoring is exact in every mode.
    Returns (state, epochs each finetune ran, shape (n_steps,))."""
    if lr_schedule not in (None, "cosine"):
        raise ValueError(f"lr_schedule must be None or 'cosine', not {lr_schedule!r}")
    rate = cosine_lr(lr, 0.0, max(n_ft, 1)) if lr_schedule == "cosine" else lr
    ran = np.zeros(n_steps, np.int32)
    for k in range(n_steps):
        state = encode_step(codec, state, level)
        if n_ft == 0:
            continue
        if window > 0:
            state, _, _, ran[k], _ = optimize_adaptive(
                codec, state, X, Y, cfg, noise(), 0, n_ft, min_epoch, rel_tol, (math.inf, 0.0),
                lr=rate, sample_size=sample_size, window=window, remat=remat,
                precision=precision)
        else:
            state = optimize(codec, state, X, Y, cfg, noise(), n_epochs=n_ft, lr=rate,
                             sample_size=sample_size, remat=remat, precision=precision)
            ran[k] = n_ft
    return state, ran
