"""Prior training: EM over per-row variational posteriors, a copy of
``recombiner_tpu/priors/trainer.py`` in the port's idiom (tensors on an
explicit device, noise from an explicit ``torch.Generator``).

- ``PriorState`` holds a Gaussian posterior per training row (w, the latent
  positional encodings, and for a patch config the levels h and hh) and
  the shared mappings (the A matrices, the conv stack's parameters in
  torch's (O, I, *k) layout); ``Priors`` the M-step's priors.
- ``sgd_epochs`` is one E-step: ``n_epochs`` full-batch Adam epochs of
  ``mse * R + beta * KL`` with a fresh Adam (``coding/encoder.py::
  adam_step``, optax's semantics); ``em_iters`` runs ``n_iters`` E-steps,
  each followed by beta's f32 update against the KL budget window and the
  closed-form ``m_step``; ``em_train`` runs them in the chunks of
  ``em_chunks`` and steers the window at chunk boundaries (the rate
  controller: engage, realized-rate probes through the real grouping,
  ``rate_select``, the ``em_stop`` plateau).
- The forward goes through ``lpe_to_pe`` (the phase conv stack on cuDNN)
  and ``inr_forward_fused``, so that every epoch on the card launches the
  ``siren_fwd`` and ``siren_bwd`` kernels, and the gradients reach the A
  matrices (cuBLAS) and the conv weights and biases (cuDNN's weight
  gradient). Epochs run at the process's ambient precision
  (``device.precision()``: TF32 on the card unless ``--precision
  highest`` made it exact, as the JAX trainer inherits
  ``jax_default_matmul_precision``) on deterministic cuDNN algorithms
  (``device.deterministic_convs``); with no atomics on the path, an EM run
  repeats bit for bit on one card given its generator state.

Noise: a ``NoiseSource`` is a ``torch.Generator``, from which every epoch
draws its standard-normal noise in the order the JAX package splits its
key (LPE, then w, h, hh: ``trainer.py:114-131``, ``mappings.py:147-160``),
or a callable that returns each epoch's noise (the tests replay JAX's
draws through it). The JAX package computes beta's update and the KL per
row in f32 on the device; so does the port, in numpy f32 on the host.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from recombiner_tpu_torch.coding.encoder import adam_init, adam_step
from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.device import DeviceLike, deterministic_convs, precision, resolve_device
from recombiner_tpu_torch.models.gaussian import (
    Gaussian,
    NaturalGaussian,
    kl_gaussian,
    scale_transform,
)
from recombiner_tpu_torch.models.inr import init_linear_transform
from recombiner_tpu_torch.models.mappings import lpe_to_pe, sample_hierarchical_latents
from recombiner_tpu_torch.models.upsample import init_upsample_params
from recombiner_tpu_torch.ops.fused_inr import inr_forward_fused
from recombiner_tpu_torch.parallel.mesh import (
    Partition,
    PixelPartition,
    gather_rows,
    is_sharded,
    local_rows,
    ordered_sum,
    ordered_sum_all,
    sum_all_over,
    sum_over,
)

UPPER = ("h", "hh")

# One epoch's standard-normal noise: [LPE (R, S, *lpe_spatial, latent_dim),
# w (R, S, n_inr_params)], and h and hh (rows of their levels, S, D) after
# them for a patch config.
Noise = Sequence[torch.Tensor]
NoiseSource = Union[torch.Generator, Callable[[], Noise]]


@dataclasses.dataclass
class PriorState:
    """Trainable state: per-row posteriors and the shared mappings."""

    w: Gaussian  # (R, n_inr_params)
    lpe: Gaussian  # (R, *lpe_spatial, latent_dim)
    h: Optional[Gaussian]  # (R / prod(level2_patch_nums), n_inr_params)
    hh: Optional[Gaussian]  # (R / prod(level3_patch_nums), n_inr_params)
    A: Tuple[torch.Tensor, ...]  # per-layer linear transforms
    up: Dict[str, Dict[str, torch.Tensor]]  # {conv{i}: {w (O, I, *k), b}}
    # how the posterior rows lie over the ranks (None: one process, all rows);
    # the mappings are whole on every rank
    part: Optional[Partition] = None

    def posteriors(self) -> List[Gaussian]:
        return [g for g in (self.w, self.lpe, self.h, self.hh) if g is not None]

    def leaves(self, train_mappings: bool = True) -> List[torch.Tensor]:
        """The tensors in the JAX package's ``jax.tree_util`` order (None
        dropped, dict keys sorted): each posterior's loc and log_scale, the
        A matrices, then each conv's b and w; without ``train_mappings`` the
        posteriors' only."""
        out = [t for g in self.posteriors() for t in (g.loc, g.log_scale)]
        if train_mappings:
            out += list(self.A)
            out += [self.up[c][k] for c in sorted(self.up) for k in sorted(self.up[c])]
        return out

    def with_leaves(self, leaves: Sequence[torch.Tensor],
                    train_mappings: bool = True) -> "PriorState":
        """Inverse of ``leaves``: this state with those tensors in place."""
        it = iter(leaves)
        post = {n: (None if getattr(self, n) is None else Gaussian(next(it), next(it)))
                for n in ("w", "lpe", *UPPER)}
        A, up = self.A, self.up
        if train_mappings:
            A = tuple(next(it) for _ in self.A)
            up = {c: {k: next(it) for k in sorted(self.up[c])} for c in sorted(self.up)}
        if next(it, None) is not None:
            raise ValueError("more leaves than the state holds")
        return PriorState(A=A, up=up, part=self.part, **post)

    def to(self, device) -> "PriorState":
        return self.with_leaves([t.to(device) for t in self.leaves()])

    def _map_posteriors(self, fn, part) -> "PriorState":
        post = {n: None if getattr(self, n) is None
                else Gaussian(fn(getattr(self, n).loc), fn(getattr(self, n).log_scale))
                for n in ("w", "lpe", *UPPER)}
        return PriorState(A=self.A, up=self.up, part=part, **post)

    def shard_rows(self, part: Partition) -> "PriorState":
        """This rank's block of a whole state's posterior rows, recorded as
        laid out by ``part``."""
        return self._map_posteriors(lambda t: local_rows(t, part), part)

    def gathered(self) -> "PriorState":
        """Every rank's posterior rows, on every rank (a collective when the
        rows are sharded): the single-device state."""
        return self._map_posteriors(lambda t: gather_rows(t, self.part), None)


@dataclasses.dataclass
class Priors:
    """Per-level diagonal Gaussian priors (the M-step's output)."""

    w: NaturalGaussian  # (n_inr_params,)
    lpe: NaturalGaussian  # (*lpe_spatial, latent_dim)
    h: Optional[NaturalGaussian]
    hh: Optional[NaturalGaussian]

    def leaves(self) -> List[torch.Tensor]:
        """loc and scale of each level, in ``jax.tree_util`` order."""
        return [t for g in (self.w, self.lpe, self.h, self.hh) if g is not None
                for t in (g.loc, g.scale)]

    def to(self, device) -> "Priors":
        return Priors(**{n: None if getattr(self, n) is None else NaturalGaussian(
            getattr(self, n).loc.to(device), getattr(self, n).scale.to(device))
            for n in ("w", "lpe", *UPPER)})


def init_prior_state(cfg: ModalityConfig, train_size: int,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None, part: Optional[Partition] = None) -> PriorState:
    """SIREN-style posterior init (``trainer.py:61-87``): loc U(-w_std, w_std)
    with w_std = sqrt(c / hidden[-1]) / w0, LPE loc 0.1 N(0, 1), raw scales
    ``init_log_scale``; the A matrices and the conv stack as their init
    functions draw them. The same distributions as the JAX package's, other
    numbers for the same seed. ``train_size`` counts every rank's rows:
    the whole state is drawn on every rank and this rank keeps its block of
    ``part``, so a row starts alike at any world size."""
    dev = resolve_device(device)
    w_std = float(np.sqrt(cfg.c / cfg.hidden_dims[-1]) / cfg.w0)
    ils = cfg.init_log_scale
    D = cfg.n_inr_params

    def unif(rows: int) -> Gaussian:
        loc = torch.empty(rows, D, device=dev).uniform_(-w_std, w_std, generator=generator)
        return Gaussian(loc, torch.full((rows, D), ils, device=dev))

    w = unif(train_size)
    lpe_shape = (train_size, *cfg.lpe_spatial, cfg.latent_dim)
    lpe = Gaussian(0.1 * torch.randn(lpe_shape, generator=generator, device=dev),
                   torch.full(lpe_shape, ils, device=dev))
    upper = {n: None for n in UPPER}
    if cfg.patch:
        upper = {"h": unif(cfg.rows_level2(train_size)), "hh": unif(cfg.rows_level3(train_size))}
    A = tuple(init_linear_transform(cfg.net_dims, generator, dev))
    up = init_upsample_params(cfg.data_dim, cfg.latent_dim, cfg.upsample_hidden,
                              cfg.upsample_out, generator, dev)
    state = PriorState(w=w, lpe=lpe, A=A, up=up, **upper)
    return state if part is None else state.shard_rows(part)


def init_priors(cfg: ModalityConfig, device: DeviceLike = None) -> Priors:
    """The initial prior: loc 0, scale softplus(-2) / 6 (``trainer.py:90-103``)."""
    dev = resolve_device(device)
    s0 = float(scale_transform(torch.tensor(-2.0)))
    D = cfg.n_inr_params

    def ng(shape) -> NaturalGaussian:
        return NaturalGaussian(torch.zeros(shape, device=dev), torch.full(shape, s0, device=dev))

    upper = {n: ng((D,)) if cfg.patch else None for n in UPPER}
    return Priors(w=ng((D,)), lpe=ng((*cfg.lpe_spatial, cfg.latent_dim)), **upper)


def draw_noise(state: PriorState, cfg: ModalityConfig, sample_size: int,
               generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
    """One forward's noise from ``generator`` in the JAX package's order
    (LPE, w, h, hh), or zero without one (the posterior means). The noise
    of every rank's rows is drawn and this rank keeps its own
    (``state.part``), so row r sees the same noise at any world size, as
    ``jax.random`` over a sharded array does."""
    part, S = state.part, sample_size
    R = state.w.loc.shape[0]
    shapes = [(R, S, *cfg.lpe_spatial, cfg.latent_dim), (R, S, cfg.n_inr_params)]
    shapes += [(g.loc.shape[0], S, g.loc.shape[1]) for g in (state.h, state.hh) if g is not None]
    dev = state.w.loc.device
    if generator is None:
        return [torch.zeros(s, device=dev) for s in shapes]
    return [local_rows(torch.randn((part.global_rows(s[0]) if part else s[0], *s[1:]),
                                   generator=generator, device=dev), part) for s in shapes]


def forward(state: PriorState, X: torch.Tensor, cfg: ModalityConfig, sample_size: int = 1,
            generator: Optional[torch.Generator] = None,
            noise: Optional[Noise] = None) -> torch.Tensor:
    """Variational forward (``trainer.py:106-132``): sample the posteriors,
    upsample the LPEs, render the INR through the SIREN kernels.
    X (R, P, fourier_dim) -> (R, S, P, out_dim), for this rank's rows (and,
    on a 2-D mesh, its pixels). The noise is ``noise`` (this rank's rows)
    when given, else drawn from ``generator`` (``draw_noise``)."""
    S = sample_size
    dev = state.w.loc.device
    if noise is None:
        noise = draw_noise(state, cfg, S, generator)
    eps = [torch.as_tensor(n, dtype=torch.float32, device=dev) for n in noise]
    lpe = state.lpe.loc[:, None] + state.lpe.scale[:, None] * eps[0]
    pe = lpe_to_pe(state.up, lpe, cfg)  # (R, S, P, pe_dim)
    if isinstance(state.part, PixelPartition):
        # every pixel rank upsamples the whole canvas and keeps its pixels
        pe = pe[:, :, state.part.pixel_block(pe.shape[2])]
    x = torch.cat([X[:, None].expand(*pe.shape[:3], X.shape[-1]), pe], -1)
    upper = {}
    if cfg.patch:
        upper = {n: (g.loc, g.scale, e) for n, g, e in zip(UPPER, (state.h, state.hh), eps[2:])}
    h_w = sample_hierarchical_latents(state.w.loc, state.w.scale, eps[1], cfg, **upper)
    return inr_forward_fused(x, h_w, state.A, cfg)


def total_kl(state: PriorState, priors: Priors) -> torch.Tensor:
    """The KL of every posterior row of every level against its prior, summed
    (``trainer.py:135-142``), in nats: over the rows this rank holds."""
    levels = [(getattr(state, n), getattr(priors, n)) for n in ("w", "lpe", *UPPER)]
    return sum(kl_gaussian(q.loc, q.scale, p.loc, p.scale).sum() for q, p in levels
               if q is not None)


class EpochMetrics(NamedTuple):
    mse: torch.Tensor  # mean squared error per element (last epoch)
    kl: torch.Tensor  # total KL in nats (last epoch)


def _epoch_noise(source: NoiseSource, state: PriorState, cfg: ModalityConfig) -> Noise:
    """An epoch's noise for this rank's rows: drawn (``draw_noise``), or the
    rows of the global noise a callable source returns."""
    if isinstance(source, torch.Generator):
        return draw_noise(state, cfg, 1, source)
    return [local_rows(torch.as_tensor(n), state.part) for n in source()]


def sgd_epochs(state: PriorState, X: torch.Tensor, Y: torch.Tensor, priors: Priors,
               kl_beta: float, source: NoiseSource, *, cfg: ModalityConfig, n_epochs: int,
               lr: float = 2e-4, train_mappings: bool = True) -> Tuple[PriorState, EpochMetrics]:
    """One EM E-step (``trainer.py:150-200``): ``n_epochs`` full-batch Adam
    epochs of ``mse * R + kl_beta * KL`` at S = 1, Adam fresh in each call
    (the reference re-creates it per EM iteration). With ``train_mappings``
    off only the posteriors move. Returns the new state (the input's tensors
    are not changed) and the last epoch's (mse, KL). Runs at the ambient
    precision, on deterministic cuDNN algorithms.

    Data-parallel (``state.part`` sharded; X and Y this rank's rows): the
    mse is a mean over every row, so ``mse * R`` of a rank's rows alone is
    exactly its rows' term, and per-row gradients need no collective. The
    gradients of the shared A and conv weights are summed over the ranks
    in rank order (``ordered_sum_all``), so every rank takes the same Adam
    step on them. On a 2-D mesh (``PixelPartition``) a rank holds a pixel
    slice of its rows: the mse term is weighted by its share of the
    pixels, the KL counted on pixel rank 0, the per-row gradients summed
    over the pixel group and the shared ones over every rank. The metrics
    are global, the same on every rank."""
    beta = float(np.float32(kl_beta))
    part = state.part
    pix = part if isinstance(part, PixelPartition) else None
    leaves = [t.detach().clone().requires_grad_() for t in state.leaves(train_mappings)]
    n_post = 2 * len(state.posteriors())
    opt = adam_init(leaves)
    mse = kl = None
    with precision(), deterministic_convs():
        for _ in range(n_epochs):
            s = state.with_leaves(leaves, train_mappings)
            y_hat = forward(s, X, cfg, noise=_epoch_noise(source, s, cfg))[:, 0]
            mse = torch.mean((y_hat - Y) ** 2)
            kl = total_kl(s, priors)
            # the reference's loss: mean mse times the rows plus beta KL
            # (prior_model.py:237-247)
            if pix is None:
                loss = mse * Y.shape[0] + beta * kl
            else:
                loss = (mse * (Y.shape[0] / pix.grid.sp)
                        + beta * kl * float(pix.grid.pixels.rank == 0))
            grads = list(torch.autograd.grad(loss, leaves))
            if pix is not None:
                grads[:n_post] = sum_all_over(grads[:n_post], pix.grid.pixels)
                grads[n_post:] = sum_all_over(grads[n_post:], pix.grid.world)
            elif is_sharded(part):
                grads[n_post:] = ordered_sum_all(grads[n_post:], part)
            opt = adam_step(leaves, grads, opt, lr)
    out = state.with_leaves([t.detach() for t in leaves], train_mappings)
    mse, kl = mse.detach(), kl.detach()
    if pix is not None:
        mse = sum_over(mse, pix.grid.world) / pix.grid.world.world
        kl = ordered_sum(kl, part)
    elif is_sharded(part):
        mse = ordered_sum(mse, part) / part.mesh.world
        kl = ordered_sum(kl, part)
    return out, EpochMetrics(mse, kl)


def m_step(state: PriorState) -> Priors:
    """Closed-form prior update (``trainer.py:314-331``): moment-match the
    row-wise posterior mixture, var with ddof 1. Over sharded rows: the
    global mean first, then the global sum of squared deviations over the
    global count less one, each summed over the ranks in rank order."""
    part = state.part

    def match(g: Gaussian) -> NaturalGaussian:
        if not is_sharded(part):
            loc = g.loc.mean(0)
            var = (scale_transform(g.log_scale) ** 2).mean(0) + torch.var(g.loc, 0, correction=1)
            return NaturalGaussian(loc=loc, scale=torch.sqrt(var))
        n = part.global_rows(g.loc.shape[0])
        loc = ordered_sum(g.loc.sum(0), part) / n
        ssd, sq = ordered_sum_all([((g.loc - loc) ** 2).sum(0),
                                   (scale_transform(g.log_scale) ** 2).sum(0)], part)
        return NaturalGaussian(loc=loc, scale=torch.sqrt(sq / n + ssd / (n - 1)))

    with torch.no_grad():
        return Priors(**{n: None if getattr(state, n) is None else match(getattr(state, n))
                         for n in ("w", "lpe", *UPPER)})


def beta_update(kl_beta: np.float32, kl: float, rows: int, budget_min: np.float32,
                budget_max: np.float32) -> Tuple[np.float32, np.float32]:
    """(KL bits per row, the new beta), in f32 as ``em_iters`` computes them
    on the device in the JAX package (``trainer.py:268-271``): beta x1.5
    above the window, /1.5 below it, clipped to [1e-20, 1]."""
    f32 = np.float32
    kl_bits = f32(f32(kl) / f32(np.log(f32(2.0)))) / f32(rows)
    beta = f32(kl_beta)
    if kl_bits > budget_max:
        beta = beta * f32(1.5)
    if kl_bits < budget_min:
        beta = beta / f32(1.5)
    return f32(kl_bits), np.clip(beta, f32(1e-20), f32(1.0))


def em_iters(state: PriorState, X: torch.Tensor, Y: torch.Tensor, priors: Priors,
             kl_beta: float, source: NoiseSource, budget_min: float, budget_max: float, *,
             cfg: ModalityConfig, n_iters: int, n_epochs: int, lr: float = 2e-4):
    """``n_iters`` EM iterations (``trainer.py:203-278``): each an E-step
    (``sgd_epochs``), beta's f32 update against [budget_min, budget_max]
    (``beta_update``, from the global KL and row count) and the M-step.
    Returns (state, priors, kl_beta, history) with history = (mse, KL bits
    per row, kl_beta) f32 arrays of length ``n_iters``; beta and the
    budgets travel as f32, as in the JAX package."""
    R = state.part.global_rows(X.shape[0]) if state.part is not None else X.shape[0]
    beta = np.float32(kl_beta)
    lo, hi = np.float32(budget_min), np.float32(budget_max)
    hist = ([], [], [])
    for _ in range(n_iters):
        state, m = sgd_epochs(state, X, Y, priors, beta, source, cfg=cfg, n_epochs=n_epochs,
                              lr=lr)
        kl_bits, beta = beta_update(beta, m.kl.item(), R, lo, hi)
        priors = m_step(state)
        for h, v in zip(hist, (np.float32(m.mse.item()), kl_bits, beta)):
            h.append(v)
    return state, priors, beta, tuple(np.array(h, np.float32) for h in hist)


def realized_bitrate(state: PriorState, priors: Priors, cfg: ModalityConfig) -> float:
    """The bitrate the current posteriors would transmit at: the real
    grouping (shuffle and greedy 16-bit packing) on the same weights
    ``build_prior_artifact`` groups on, so the probe's group counts are the
    built artifact's (``trainer.py:281-311``)."""
    from recombiner_tpu_torch.priors.artifact import level_posterior_mats
    from recombiner_tpu_torch.priors.grouping import grouping_from_posteriors

    counts = {name: grouping_from_posteriors(*m, max_bits=cfg.bits_per_group).n_groups
              for name, m in level_posterior_mats(state, priors, cfg).items()}
    return float(cfg.bitrate_of_groups(counts["w"], counts.get("h", 0), counts.get("hh", 0)))


def rate_quantum(cfg: ModalityConfig) -> float:
    """The realized-rate step of one level-1 group (``trainer.py:334-342``)."""
    return float(cfg.bitrate_of_groups(1, 0, 0) - cfg.bitrate_of_groups(0, 0, 0))


def aim_update(aim: float, realized: float, target: float, rate_tolerance: float,
               quantum: float) -> float:
    """One rate-controller step (``trainer.py:345-367``): a sqrt-damped
    multiplicative correction toward the target, clamped to [0.5, 1.1],
    held inside a deadband of max(rate_tolerance * target, quantum / 2)."""
    if abs(realized - target) <= max(rate_tolerance * target, 0.5 * quantum):
        return aim
    err = realized / target
    return float(np.clip(aim * (1.0 / err) ** 0.5, 0.5, 1.1))


def adjust_kl_beta(kl_beta: float, kl_bits_per_row: float, budget_min: float,
                   budget_max: float) -> float:
    """The multiplicative beta controller in f64 (``trainer.py:370-378``)."""
    if kl_bits_per_row > budget_max:
        kl_beta *= 1.5
    if kl_bits_per_row < budget_min:
        kl_beta /= 1.5
    return float(np.clip(kl_beta, 1e-20, 1.0))


@dataclasses.dataclass
class EMResult:
    state: PriorState
    priors: Priors
    kl_beta: float
    elbo_history: list
    controller: Optional[dict] = None  # aim / in_window / seen_above, em_stop, selected


def resolve_em_schedule(em_schedule: Optional[str], em_stop: Optional[tuple],
                        n_em_iters: int) -> Optional[Tuple[int, float, int]]:
    """The ``em_stop`` spec (window_iters, rel_tol, min_iters) of an EM
    schedule preset (``trainer.py:390-414``): an explicit spec wins;
    'adaptive' is a 40-iteration window at 1% floored at a quarter of the
    schedule (at least 100); 'reference' or None, no stop."""
    if em_stop is not None:
        w, rtol, mi = em_stop
        return (int(w), float(rtol), int(mi))
    if em_schedule in (None, "reference"):
        return None
    if em_schedule == "adaptive":
        return (40, 0.01, max(100, int(round(0.25 * n_em_iters))))
    raise ValueError(f"unknown em_schedule {em_schedule!r}")


def em_chunks(n_em_iters: int, checkpoint_every: int, first_epochs: int,
              later_epochs: int) -> List[Tuple[int, int]]:
    """(iterations, epochs) of each chunk of ``em_train``, as the JAX loop
    cuts them (``trainer.py:543-556``): the first iteration alone at
    ``first_epochs`` when that differs from ``later_epochs``, then an
    odd-sized chunk first, then chunks of ``checkpoint_every``. Logs,
    checkpoints, probes and the ``em_stop`` test run only at their ends."""
    chunk = max(int(checkpoint_every), 1)
    plan, done = [], 0
    while done < n_em_iters:
        if done == 0 and first_epochs != later_epochs:
            step = (1, first_epochs)
        else:
            remaining = n_em_iters - done
            step = ((remaining % chunk) or min(chunk, remaining), later_epochs)
        plan.append(step)
        done += step[0]
    return plan


def em_train(source: NoiseSource, cfg: ModalityConfig, X: torch.Tensor, Y: torch.Tensor,
             max_bitrate: float, n_em_iters: int = 550, first_epochs: int = 200,
             later_epochs: int = 100, lr: float = 2e-4, checkpoint_every: int = 10,
             checkpoint_fn: Optional[Callable] = None, log_fn: Optional[Callable] = None,
             state: Optional[PriorState] = None, priors: Optional[Priors] = None,
             kl_beta: float = 1e-8, rate_control: bool = True, rate_tolerance: float = 0.015,
             probe_every: int = 10, controller: Optional[dict] = None, em_iter_offset: int = 0,
             schedule_total: Optional[int] = None, rate_select: bool = True,
             em_stop: Optional[Tuple[int, float, int]] = None,
             part: Optional[Partition] = None) -> EMResult:
    """The EM loop with the closed-loop rate controller
    (``trainer.py:417-703``; its docstring gives the reasons for each rule).

    X (R, P, fourier_dim) and Y (R, P, out_dim) are tensors on the training
    device. ``source`` gives each epoch's noise; when ``state`` is None it
    must be a ``torch.Generator``, from which the initial state is drawn
    first. At the end of each chunk (``em_chunks``): the history, the
    controller (engage once the KL reached the window, from above or
    rising into it, or after a quarter of ``schedule_total``; a
    realized-rate probe at most every ``probe_every`` iterations, adapting
    the aim until 90% of the schedule; ``rate_select``'s snapshot of the
    state nearest the target), the ``em_stop`` plateau test, then
    ``log_fn(em_iter, record, state, priors)`` and
    ``checkpoint_fn(em_iter, state, priors, kl_beta, controller)``.
    ``controller``, ``em_iter_offset`` and ``schedule_total`` resume a run.

    Data-parallel: X and Y are this rank's rows of ``part`` (a given
    ``state`` carries its own), the initial state is drawn whole and sliced,
    and every decision (beta, the window, the probes on the gathered state,
    the stop) reads global values, so every rank takes the same branch."""
    if state is not None:
        part = state.part
    train_size = part.global_rows(X.shape[0]) if part is not None else X.shape[0]
    base_min, base_max = cfg.bits_budget(max_bitrate)
    if state is None:
        if not isinstance(source, torch.Generator):
            raise ValueError("em_train draws the initial state from a torch.Generator; "
                             "pass one, or pass state")
        state = init_prior_state(cfg, train_size, source, X.device, part)
    if priors is None:
        priors = init_priors(cfg, X.device)

    history: list = []
    controller = dict(controller or {})
    aim = float(controller.get("aim", 1.0))
    in_window = bool(controller.get("in_window", False))
    seen_above = bool(controller.get("seen_above", False))
    total = int(schedule_total) if schedule_total else em_iter_offset + n_em_iters
    quantum = rate_quantum(cfg)
    deadband = max(rate_tolerance * max_bitrate, 0.5 * quantum)
    beta = np.float32(kl_beta)
    done = 0
    next_probe = 0
    best_err = float("inf")
    best_snapshot = None  # (state, priors, kl_beta, em_iter, realized)
    last_realized = None
    prev_probe = None
    probe_stability = 0
    early_stop = False
    for n_iters, n_epochs in em_chunks(n_em_iters, checkpoint_every, first_epochs,
                                       later_epochs):
        state, priors, beta, hist = em_iters(
            state, X, Y, priors, beta, source, np.float32(base_min * aim),
            np.float32(base_max * aim), cfg=cfg, n_iters=n_iters, n_epochs=n_epochs, lr=lr)
        mses, kl_bits, betas = hist
        for i in range(n_iters):
            history.append({"em_iter": done + i, "mse": float(mses[i]),
                            "kl_bits": float(kl_bits[i]), "kl_beta": float(betas[i])})
        done += n_iters
        kl_beta = float(betas[-1])

        global_done = em_iter_offset + done
        if rate_control:
            if not in_window:
                k, hi = float(kl_bits[-1]), base_max * aim * 1.05
                lo = base_min * aim * 0.95
                seen_above = seen_above or k > hi
                in_window = bool(k <= hi and (k >= lo or seen_above))
                if not in_window and global_done >= 0.25 * total:
                    in_window = True  # a settled undershoot
            if in_window and done < n_em_iters and done >= next_probe:
                next_probe = done + max(int(probe_every), 1)
                realized = realized_bitrate(state, priors, cfg)
                last_realized = realized
                if global_done < 0.9 * total:
                    aim = aim_update(aim, realized, max_bitrate, rate_tolerance, quantum)
                history[-1]["realized_bitrate"] = realized
                history[-1]["budget_aim"] = aim
                cur = (realized, aim)
                if (prev_probe is not None and abs(cur[0] - prev_probe[0]) <= 0.5 * quantum
                        and cur[1] == prev_probe[1]):
                    probe_stability += 1
                else:
                    probe_stability = 0
                prev_probe = cur
                if rate_select:
                    # inside the deadband every candidate ties, and the
                    # latest (most converged) wins
                    err = abs(realized - max_bitrate)
                    if err <= deadband:
                        err = 0.0
                    if err <= best_err + 1e-12:
                        best_err = err
                        best_snapshot = (copy.deepcopy(state), copy.deepcopy(priors), kl_beta,
                                         global_done, realized)

        if em_stop is not None and not early_stop:
            w_it, rtol, min_it = em_stop
            if global_done >= min_it and len(history) >= 2 * w_it:
                mh = [h["mse"] for h in history]
                prev_m = float(np.mean(mh[-2 * w_it:-w_it]))
                cur_m = float(np.mean(mh[-w_it:]))
                plateau = (prev_m - cur_m) <= rtol * abs(prev_m)
                deadband_ok = (last_realized is not None
                               and abs(last_realized - max_bitrate) <= deadband)
                rate_ok = (not rate_control) or deadband_ok or probe_stability >= 2
                if plateau and rate_ok:
                    early_stop = True
                    history[-1]["em_early_stop"] = global_done

        controller = {"aim": aim, "in_window": in_window, "seen_above": seen_above}
        if early_stop:
            controller["em_stop"] = {"stopped_at": int(em_iter_offset + done),
                                     "schedule": int(total), "last_realized": last_realized}
        if log_fn is not None:
            log_fn(done - 1, history[-1], state, priors)
        if checkpoint_fn is not None:
            checkpoint_fn(done - 1, state, priors, kl_beta, controller)
        if early_stop:
            break

    if rate_control and rate_select and best_snapshot is not None:
        # the final state sits past the last probe: probe it too, and return
        # whichever realizes the rate nearest the target (the final state
        # wins ties)
        final_realized = realized_bitrate(state, priors, cfg)
        history[-1]["final_realized_bitrate"] = final_realized
        final_err = abs(final_realized - max_bitrate)
        if final_err <= deadband:
            final_err = 0.0
        if best_err + 1e-12 < final_err:
            s_state, s_priors, s_beta, s_iter, s_realized = best_snapshot
            controller["selected"] = {"em_iter": int(s_iter), "realized": float(s_realized),
                                      "final_realized": float(final_realized)}
            return EMResult(state=s_state, priors=s_priors, kl_beta=s_beta,
                            elbo_history=history, controller=controller)

    return EMResult(state=state, priors=priors, kl_beta=kl_beta, elbo_history=history,
                    controller=controller)
