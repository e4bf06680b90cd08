"""The port's prior trainer against the JAX package's, on the CPU at TINY and
TINY_PATCH size with 2 datapoints.

Both packages start from one state: the JAX package's ``init_prior_state``
carried across as numpy leaves (``io/convert.prior_state_from``). JAX's
noise is replayed: each test draws it with ``jax.random`` from the keys the
JAX trainer splits (``jax_noise``, ``jax_epoch_keys``) and hands it to the
port as numpy. Tolerances (each test says which it uses):

- ``_close`` (rtol 1e-5, atol 1e-5 x the largest entry): one forward, the
  KL, an epoch's mse and KL: f32 sums in another order;
- ``_state_close``: every leaf of a trained state within 1e-6 of its norm
  (f32 rounding of the stored values) plus 1e-2 of the norm of the change
  that training made, and every element within 2 lr per Adam step. Adam
  moves an element by about lr x g / (|g| + 1e-8), so where a gradient is
  near its eps of 1e-8 the two packages' f32 gradient sums (at most 5e-10
  apart in these runs) give relatively different steps: in these runs a
  few such elements per leaf, 0.35 lr apart at most, the norms within 0.1%
  to 0.9% of the change;
- beta: f32 equal to rel 1e-6; the rate controller's decisions, chunk
  plans and histories under a scripted trainer: equal.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recombiner_tpu.config import TINY as JTINY
from recombiner_tpu.config import TINY_PATCH as JTINY_PATCH
from recombiner_tpu.config import get_config as jax_get_config
from recombiner_tpu.data.synthetic import synthetic_dataset
from recombiner_tpu.models.gaussian import Gaussian as JGaussian
from recombiner_tpu.models.upsample import apply_upsample as jax_apply_upsample
from recombiner_tpu.models.upsample import init_upsample_params as jax_init_upsample_params
from recombiner_tpu.ops.phase_upsample import apply_upsample_phased as jax_apply_upsample_phased
from recombiner_tpu.priors import trainer as jtr
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.io import convert
from recombiner_tpu_torch.models.gaussian import (
    Gaussian,
    NaturalGaussian,
    inverse_scale_transform,
    scale_transform,
)
from recombiner_tpu_torch.models.inr import init_linear_transform
from recombiner_tpu_torch.models.upsample import apply_upsample_phased, init_upsample_params
from recombiner_tpu_torch.priors import trainer as tr

from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_encode import _close

JCFGS = {"tiny": JTINY, "tiny_patch": JTINY_PATCH}


def jax_noise(key, jstate, S=1):
    """The noise JAX's ``forward`` draws from ``key`` (``trainer.py:114-131``,
    ``mappings.py:147-160``), as numpy in the port's order [LPE, w, h, hh]."""
    k_lpe, k_w = jax.random.split(key)
    R = jstate.w.loc.shape[0]
    out = [jax.random.normal(k_lpe, (R, S, *jstate.lpe.loc.shape[1:]))]
    k1, k2, k3 = jax.random.split(k_w, 3)
    out.append(jax.random.normal(k1, (R, S, jstate.w.loc.shape[1])))
    if jstate.h is not None:
        out.append(jax.random.normal(k2, (jstate.h.loc.shape[0], S, jstate.h.loc.shape[1])))
        out.append(jax.random.normal(k3, (jstate.hh.loc.shape[0], S, jstate.hh.loc.shape[1])))
    return [np.array(o) for o in out]


def jax_epoch_keys(key, epochs_per_iter):
    """The epoch keys of consecutive EM iterations from ``key``, split as
    ``em_iters`` splits them: per iteration k, sub = split(k), then
    split(sub, n_epochs)."""
    out = []
    for n in epochs_per_iter:
        key, sub = jax.random.split(key)
        out += list(jax.random.split(sub, n))
    return out


def replay(keys, jstate):
    """A port noise source that returns JAX's noise of ``keys`` in turn."""
    it = iter([jax_noise(k, jstate) for k in keys])
    return lambda: next(it)


def both_states(name, seed=0, perturb=True):
    """(JAX cfg, port cfg, X, Y, JAX state, JAX priors, port state, port
    priors): the JAX package's initial state with, by default, its raw scales
    and locs moved off the init so that the KL terms are not uniform, and
    priors from its M-step."""
    jcfg, cfg = JCFGS[name], get_config(name)
    X, Y = synthetic_dataset(jcfg, 2, seed=1)
    js = jtr.init_prior_state(jax.random.key(seed), jcfg, X.shape[0])
    if perturb:
        rng = np.random.default_rng(seed)

        def move(g):
            return JGaussian(g.loc + rng.normal(0, 0.01, g.loc.shape).astype(np.float32),
                             g.log_scale + rng.normal(0, 0.5, g.loc.shape).astype(np.float32))

        js = js.replace(w=move(js.w), lpe=move(js.lpe), **(
            {"h": move(js.h), "hh": move(js.hh)} if jcfg.patch else {}))
    jp = jtr.m_step(js, jcfg) if perturb else jtr.init_priors(jcfg)
    ps, pp = convert.prior_state_from(jax.tree_util.tree_leaves(js),
                                      jax.tree_util.tree_leaves(jp), cfg, "cpu")
    return jcfg, cfg, X, Y, js, jp, ps, pp


def _state_close(ps, js, js0, lr, steps, what=""):
    """Every leaf of the port's trained state against JAX's (``js``; both
    trained from ``js0``): the difference's norm within 1e-6 of the leaf's
    norm plus 1e-2 of the norm of the change training made, and every element
    within 1e-6 of the leaf's largest entry plus 2 lr per Adam step, the most
    two normalised Adam steps can move apart."""
    got, _ = convert.prior_state_leaves(ps)
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
    start = [np.asarray(a) for a in jax.tree_util.tree_leaves(js0)]
    assert len(got) == len(want) == len(start)
    for i, (g, w, w0) in enumerate(zip(got, want, start)):
        gap = np.linalg.norm(g - w)
        assert gap <= 1e-6 * np.linalg.norm(w) + 1e-2 * np.linalg.norm(w - w0), (
            what, i, gap, np.linalg.norm(w - w0))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max() + 2 * lr * steps,
                                   err_msg=f"{what} leaf {i}")


def _priors_close(pp, ps, js, jcfg):
    """The port's priors against the JAX package's M-step of the port's own
    state (``_close``): the state's training is held by ``_state_close``,
    whose few Adam-amplified elements the M-step's means carry."""
    jps = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(js),
                                       [jnp.asarray(a) for a in
                                        convert.prior_state_leaves(ps)[0]])
    want = jax.tree_util.tree_leaves(jtr.m_step(jps, jcfg))
    for i, (g, w) in enumerate(zip(pp.leaves(), want)):
        _close(g.numpy(), w, f"priors leaf {i}")


# ------------------------------------------------------------------ models


def test_gaussian_helpers_match_jax():
    from recombiner_tpu.models.gaussian import inverse_scale_transform as jinv

    s = np.random.default_rng(0).uniform(1e-3, 2.0, 1000).astype(np.float32)
    _close(inverse_scale_transform(torch.from_numpy(s)).numpy(), jinv(jnp.asarray(s)))
    back = scale_transform(inverse_scale_transform(torch.from_numpy(s).double())).numpy()
    np.testing.assert_allclose(back, s, rtol=1e-6)
    g = NaturalGaussian(torch.zeros(3), torch.ones(3))
    assert g.scale.shape == (3,)


def test_init_functions_draw_the_jax_distributions():
    """Shapes, layouts and bounds of the initial A matrices, conv stack and
    state, against the JAX package's (the numbers differ: other
    generators)."""
    gen = torch.Generator().manual_seed(0)
    for jcfg in (JTINY, JTINY_PATCH, jax_get_config("tiny_audio")):
        cfg = get_config(jcfg.name)
        js = jtr.init_prior_state(jax.random.key(0), jcfg, 2 * jcfg.patches_per_datapoint)
        ps = tr.init_prior_state(cfg, 2 * cfg.patches_per_datapoint, gen, "cpu")
        got, _ = convert.prior_state_leaves(ps)
        want = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            assert np.abs(g).max() <= np.abs(w).max() * 1.5 + 1e-6
            if np.ptp(w) > 0:  # uniform draws: the same bounds
                assert np.abs(g).max() > 0.5 * np.abs(w).max()
    A = init_linear_transform([32, 8, 3], gen)
    assert [a.shape for a in A] == [(264, 264), (27, 27)]
    assert all(a.abs().max() <= 1 / a.shape[0] for a in A)
    for d in (2, 3):
        up = init_upsample_params(d, generator=gen)
        jup = jax_init_upsample_params(jax.random.key(0), d)
        for c in up:
            assert tuple(up[c]["w"].shape) == convert.conv_weight_to_torch(
                np.asarray(jup[c]["w"])).shape
            bound = 1 / np.sqrt(up[c]["w"].shape[1] * up[c]["w"].shape[2] ** d)
            assert up[c]["w"].abs().max() <= bound and up[c]["b"].abs().max() <= bound


def test_init_priors_equal_jax():
    for name, jcfg in JCFGS.items():
        pp = tr.init_priors(get_config(name), "cpu")
        for g, w in zip(pp.leaves(), jax.tree_util.tree_leaves(jtr.init_priors(jcfg))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# (data_dim, layerwise scale factors, canvas (N, *spatial))
STACK_GEOMETRIES = {1: (1, (4, 2, 2), (2, 6)), 2: (2, (4, 2, 2), (2, 2, 2)),
                    3: (3, ((1, 2, 2), 2, 2), (2, 1, 2, 2))}


@pytest.mark.parametrize("jax_stack", [jax_apply_upsample, jax_apply_upsample_phased])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_phase_stack_weight_and_bias_gradients_match_jax_grad(d, jax_stack):
    """Gradients of <stack(x), r> with respect to every conv weight and bias
    through the port's phase stack, against ``jax.grad`` of each JAX stack at
    exact f32, at rtol 1e-5 and atol 1e-5 of the largest entry (f32 sums in
    another order), at d = 1, 2 and 3."""
    d, factors, canvas = STACK_GEOMETRIES[d]
    jp = jax_init_upsample_params(jax.random.key(d), d)
    _, up = convert.torch_params_from_artifact(
        types.SimpleNamespace(A=[], up=jax.tree_util.tree_map(np.asarray, jp)), "cpu")
    rng = np.random.default_rng(d)
    x = rng.standard_normal((*canvas, 128)).astype(np.float32)
    args = (d, factors, (2, 1, 1))
    leaves = [up[f"conv{i}"][n].requires_grad_() for i in range(3) for n in ("w", "b")]
    out = apply_upsample_phased(up, torch.from_numpy(x), *args)
    r = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), leaves)
    hi = jax.lax.Precision.HIGHEST
    jg = jax.grad(lambda p: (jax_stack(p, jnp.asarray(x), *args, precision=hi) * r).sum())(jp)
    for k, g in enumerate(grads):
        i, n = divmod(k, 2)
        want = np.asarray(jg[f"conv{i}"][("w", "b")[n]])
        want = convert.conv_weight_to_torch(want) if n == 0 else want
        _close(g.numpy(), want, f"conv{i}/{'wb'[n]}")


# ------------------------------------------------------------------ trainer


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("name", list(JCFGS))
def test_forward_matches_jax(name, S):
    """One forward with JAX's noise replayed (``_close``)."""
    jcfg, cfg, X, _, js, _, ps, _ = both_states(name)
    key = jax.random.key(7)
    want = jtr.forward(js, jnp.asarray(X), key, jcfg, sample_size=S)
    got = tr.forward(ps, torch.from_numpy(X), cfg, S, noise=jax_noise(key, js, S))
    assert got.shape == want.shape == (X.shape[0], S, cfg.n_pixels, cfg.output_dim)
    _close(got.numpy(), want)
    # a generator draws noise of the same shapes; none gives the means
    a = tr.forward(ps, torch.from_numpy(X), cfg, S, generator=torch.Generator().manual_seed(1))
    b = tr.forward(ps, torch.from_numpy(X), cfg, S, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, got)


@pytest.mark.parametrize("name", list(JCFGS))
def test_total_kl_and_m_step_match_jax(name):
    """``total_kl`` (``_close``) and ``m_step`` against an f64 evaluation of
    the moment match: both packages within 2e-6 of each value (f32 means and
    variances over the rows)."""
    jcfg, cfg, _, _, js, jp, ps, pp = both_states(name)
    _close(tr.total_kl(ps, pp).item(), float(jtr.total_kl(js, jp)), "total_kl")
    got, want = tr.m_step(ps), jtr.m_step(js, jcfg)
    for level in ("w", "lpe", "h", "hh"):
        q = getattr(js, level)
        if q is None:
            assert getattr(got, level) is None
            continue
        loc = np.asarray(q.loc, np.float64)
        raw = np.asarray(q.log_scale, np.float64)
        sig = np.logaddexp(raw, 0) / 6
        ref = (loc.mean(0), np.sqrt((sig ** 2).mean(0) + loc.var(0, ddof=1)))
        for f, r in zip(("loc", "scale"), ref):
            for pkg in (getattr(getattr(got, level), f).numpy(),
                        np.asarray(getattr(getattr(want, level), f))):
                np.testing.assert_allclose(pkg, r, rtol=2e-6, atol=2e-6 * np.abs(r).max(),
                                           err_msg=f"{level}.{f}")


@pytest.mark.parametrize("name,n_epochs,train_mappings", [
    ("tiny", 1, True), ("tiny_patch", 1, True), ("tiny", 4, True), ("tiny", 4, False)])
def test_sgd_epochs_match_jax(name, n_epochs, train_mappings):
    """``n_epochs`` E-step epochs from one state with JAX's noise replayed:
    the last epoch's mse and KL (``_close``), every leaf of the new state
    (``_state_close``); without ``train_mappings`` the mappings stay put."""
    jcfg, cfg, X, Y, js, jp, ps, pp = both_states(name)
    lr, key = 2e-3, jax.random.key(3)
    js2, jm = jtr.sgd_epochs(jax.tree_util.tree_map(jnp.copy, js), jnp.asarray(X),
                             jnp.asarray(Y), jp, jnp.float32(1e-3), key, cfg=jcfg,
                             n_epochs=n_epochs, lr=lr, train_mappings=train_mappings)
    keys = list(jax.random.split(key, n_epochs))
    ps2, m = tr.sgd_epochs(ps, torch.from_numpy(X), torch.from_numpy(Y), pp, 1e-3,
                           replay(keys, js), cfg=cfg, n_epochs=n_epochs, lr=lr,
                           train_mappings=train_mappings)
    _close(m.mse.item(), float(jm.mse), "mse")
    _close(m.kl.item(), float(jm.kl), "kl")
    _state_close(ps2, js2, js, lr, n_epochs)
    if not train_mappings:
        assert all(a is b for a, b in zip(ps2.A, ps.A))
    # the input state is not changed
    assert torch.equal(ps.w.loc, torch.from_numpy(np.asarray(js.w.loc)))


@pytest.mark.parametrize("name", list(JCFGS))
def test_three_em_iterations_match_jax(name):
    """Three ``em_iters`` iterations of 2 epochs with beta's f32 window
    update: the state (``_state_close``), the priors (``_priors_close``), the history's mse
    and KL bits (``_close``), beta at each iteration (rel 1e-6)."""
    jcfg, cfg, X, Y, js, jp, ps, pp = both_states(name)
    lo, hi = jcfg.bits_budget(4.0)
    lr, key = 2e-3, jax.random.key(9)
    jout = jtr.em_iters(jax.tree_util.tree_map(jnp.copy, js), jnp.asarray(X), jnp.asarray(Y),
                        jax.tree_util.tree_map(jnp.copy, jp), jnp.float32(1e-8), key,
                        jnp.float32(lo), jnp.float32(hi), cfg=jcfg, n_iters=3, n_epochs=2,
                        lr=lr)
    js3, _, jbeta, _, jhist = jout
    ps3, pp3, beta, hist = tr.em_iters(ps, torch.from_numpy(X), torch.from_numpy(Y), pp, 1e-8,
                                       replay(jax_epoch_keys(key, [2, 2, 2]), js), lo, hi,
                                       cfg=cfg, n_iters=3, n_epochs=2, lr=lr)
    _state_close(ps3, js3, js, lr, 6)
    _priors_close(pp3, ps3, js, jcfg)
    for got, want, what in zip(hist, jhist, ("mse", "kl_bits", "beta")):
        if what == "beta":
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
            assert len(set(got.tolist())) == 3  # beta moved every iteration
        else:
            _close(got, want, what)
    assert float(beta) == pytest.approx(float(jbeta), rel=1e-6)


def test_em_iters_is_the_per_iteration_loop():
    """The port's em_iters equals its own per-iteration loop of sgd_epochs,
    beta_update and m_step bit for bit (the split the JAX package's
    ``test_em_iters_matches_per_iter_loop`` holds), and its f64
    ``adjust_kl_beta`` to rel 1e-6."""
    _, cfg, X, Y, _, _, ps, pp = both_states("tiny")
    X, Y = torch.from_numpy(X), torch.from_numpy(Y)
    lo, hi = cfg.bits_budget(4.0)
    s_a, p_a, beta_a, beta64 = ps, pp, np.float32(1e-8), 1e-8
    gen_a = torch.Generator().manual_seed(4)
    for _ in range(3):
        s_a, m = tr.sgd_epochs(s_a, X, Y, p_a, beta_a, gen_a, cfg=cfg, n_epochs=2, lr=2e-3)
        kl_bits, beta_a = tr.beta_update(beta_a, m.kl.item(), 2, np.float32(lo), np.float32(hi))
        beta64 = tr.adjust_kl_beta(beta64, m.kl.item() / np.log(2.0) / 2, lo, hi)
        p_a = tr.m_step(s_a)
    s_b, p_b, beta_b, _ = tr.em_iters(ps, X, Y, pp, 1e-8, torch.Generator().manual_seed(4),
                                      lo, hi, cfg=cfg, n_iters=3, n_epochs=2, lr=2e-3)
    for a, b in zip(s_a.leaves() + p_a.leaves(), s_b.leaves() + p_b.leaves()):
        assert torch.equal(a, b)
    assert beta_a == beta_b and float(beta_b) == pytest.approx(beta64, rel=1e-6)


# ------------------------------------------------------------ controller


@pytest.mark.parametrize("n_em_iters,chunk,first,later", [
    (550, 10, 200, 100), (7, 3, 5, 3), (7, 3, 3, 3), (10, 1, 5, 3), (4, 10, 20, 10),
    (1, 10, 5, 3), (12, 5, 4, 4), (3, 10, 3, 3)])
def test_chunk_plan_is_the_jax_loops(monkeypatch, n_em_iters, chunk, first, later):
    """``em_chunks`` against the (n_iters, n_epochs) JAX's ``em_train`` loop
    passes to ``em_iters`` (recorded by a stand-in), and the port's
    ``em_train`` runs that plan."""
    calls = []

    def fake(state, X, Y, priors, beta, key, lo, hi, *, cfg, n_iters, n_epochs, lr):
        calls.append((n_iters, n_epochs))
        z = np.zeros(n_iters, np.float32)
        return state, priors, beta, key, (z, z, np.full(n_iters, beta, np.float32))

    monkeypatch.setattr(jtr, "em_iters", fake)
    X, Y = synthetic_dataset(JTINY, 1, seed=0)
    js = jtr.init_prior_state(jax.random.key(0), JTINY, 1)
    jtr.em_train(jax.random.key(0), JTINY, jnp.asarray(X), jnp.asarray(Y), 2.0,
                 n_em_iters=n_em_iters, first_epochs=first, later_epochs=later,
                 checkpoint_every=chunk, state=js, rate_control=False)
    assert tr.em_chunks(n_em_iters, chunk, first, later) == calls
    port_calls = []

    def port_fake(state, X, Y, priors, beta, source, lo, hi, *, cfg, n_iters, n_epochs, lr):
        port_calls.append((n_iters, n_epochs))
        z = np.zeros(n_iters, np.float32)
        return state, priors, beta, (z, z, np.full(n_iters, beta, np.float32))

    monkeypatch.setattr(tr, "em_iters", port_fake)
    tr.em_train(torch.Generator().manual_seed(0), get_config("tiny"), torch.from_numpy(X),
                torch.from_numpy(Y), 2.0, n_em_iters=n_em_iters, first_epochs=first,
                later_epochs=later, checkpoint_every=chunk, rate_control=False)
    assert port_calls == calls


def test_pure_controller_functions_match_jax():
    """``aim_update``, ``adjust_kl_beta``, ``rate_quantum`` and
    ``resolve_em_schedule`` case for case: equal."""
    for name in ("tiny", "tiny_patch", "cifar", "audio", "kodak"):
        assert tr.rate_quantum(get_config(name)) == jtr.rate_quantum(jax_get_config(name))
    for aim in (0.5, 0.9, 1.0, 1.1):
        for realized in (0.5, 1.9, 1.97, 2.0, 2.03, 2.5, 4.0):
            for tol, q in ((0.015, 0.0), (0.015, 0.2), (0.0, 0.0625)):
                assert (tr.aim_update(aim, realized, 2.0, tol, q)
                        == jtr.aim_update(aim, realized, 2.0, tol, q))
    for beta in (1e-20, 1e-8, 0.3, 0.9, 1.0):
        for kl in (0.0, 10.0, 30.0, 50.0, 100.0):
            assert tr.adjust_kl_beta(beta, kl, 10, 50) == jtr.adjust_kl_beta(beta, kl, 10, 50)
    for sched, stop, n in (("reference", None, 550), (None, None, 550), ("adaptive", None, 550),
                           ("adaptive", None, 100), ("adaptive", (5.0, 0.5, 7.0), 550),
                           (None, (3, 0.1, 2), 10)):
        assert tr.resolve_em_schedule(sched, stop, n) == jtr.resolve_em_schedule(sched, stop, n)
    with pytest.raises(ValueError):
        tr.resolve_em_schedule("bogus", None, 550)


TARGET = 30.0


def _scenario(name, quantum):
    """em_train arguments, and the scripted (mse, KL bits) per EM iteration
    and realized rate per probe, of each controller scenario."""
    cfg = JTINY
    lo, hi = cfg.bits_budget(TARGET)
    db = max(0.015 * TARGET, 0.5 * quantum)
    far = TARGET + 4 * db
    mid = 0.5 * (lo + hi)
    falling = [(1.0 / (i + 1), v) for i, v in enumerate(
        [3 * hi, 2 * hi, mid, mid, mid * 1.01, mid, mid * 0.99, mid, mid, mid, mid, mid])]
    kw = dict(n_em_iters=8, first_epochs=10, later_epochs=5, checkpoint_every=1,
              probe_every=1, rate_control=True)
    if name == "engage_from_above":
        return kw, falling, [TARGET * 1.2, TARGET * 1.1, TARGET, TARGET, TARGET, TARGET]
    if name == "engage_rising":
        rising = [(0.5, v) for v in [0.5 * lo, 0.8 * lo, 0.97 * lo, mid, mid, mid, mid, mid]]
        return dict(kw, probe_every=2), rising, [0.8 * TARGET] * 8
    if name == "settled_undershoot":
        return dict(kw, n_em_iters=10, checkpoint_every=2), [(0.5, 0.3 * lo)] * 10, \
            [0.7 * TARGET] * 8
    if name == "rate_select_best_probe":
        return dict(kw, n_em_iters=6), falling, [far, TARGET, far, far, far, far, far]
    if name == "rate_select_final_ties":
        return dict(kw, n_em_iters=6), falling, [TARGET] * 4 + [TARGET + 0.5 * db] * 4
    if name == "em_stop_plateau_no_rate_control":
        return dict(kw, n_em_iters=20, rate_control=False, em_stop=(2, 10.0, 3)), \
            [(0.1, mid)] * 20, []
    if name == "em_stop_needs_deadband":
        return dict(kw, n_em_iters=12, em_stop=(2, 10.0, 3)), falling, [far] * 12
    if name == "em_stop_in_deadband":
        return dict(kw, n_em_iters=12, em_stop=(2, 10.0, 3)), falling, [TARGET] * 12
    if name == "em_stop_settled_off_target":
        return dict(kw, n_em_iters=12, em_stop=(2, 10.0, 3)), falling, [2 * TARGET] * 12
    if name == "em_stop_blocked_improving":
        return dict(kw, n_em_iters=8, rate_control=False, em_stop=(2, -10.0, 3)), \
            [(1.0 / (i + 1), mid) for i in range(8)], []
    if name == "resume":
        return dict(kw, n_em_iters=6, checkpoint_every=2, probe_every=3,
                    controller={"aim": 1.05, "in_window": True, "seen_above": True},
                    em_iter_offset=4, schedule_total=10, kl_beta=3e-6), falling, \
            [0.9 * TARGET, 0.95 * TARGET, TARGET]
    if name == "odd_chunks":
        return dict(kw, n_em_iters=9, checkpoint_every=4, probe_every=3), falling, \
            [TARGET * 1.3, TARGET * 1.05, TARGET, TARGET]
    raise ValueError(name)


SCENARIOS = ["engage_from_above", "engage_rising", "settled_undershoot",
             "rate_select_best_probe", "rate_select_final_ties",
             "em_stop_plateau_no_rate_control", "em_stop_needs_deadband", "em_stop_in_deadband",
             "em_stop_settled_off_target", "em_stop_blocked_improving", "resume", "odd_chunks"]


def _scripted_run(pkg, kw, script, rates, monkeypatch):
    """Run ``pkg``'s em_train with em_iters replaced by the script (beta by
    the f32 window update; the state's w.loc set to the global iteration, so
    that the returned state names its iteration) and realized_bitrate by the
    rate sequence. Returns (result, em_iters calls, kl_beta, the returned
    state's iteration, log records, checkpoint records)."""
    it = iter(script)
    rate = iter(rates + rates[-1:] * 20)
    calls, logs, ckpts = [], [], []
    counter = [kw.get("em_iter_offset", 0)]
    jax_side = pkg is jtr

    def fake(state, X, Y, priors, beta, key, lo, hi, *, cfg, n_iters, n_epochs, lr):
        calls.append((n_iters, n_epochs, float(lo), float(hi)))
        hist = ([], [], [])
        for _ in range(n_iters):
            mse, kl_bits = next(it)
            kl_bits = np.float32(kl_bits)
            beta = np.float32(beta)
            if kl_bits > np.float32(hi):
                beta = beta * np.float32(1.5)
            if kl_bits < np.float32(lo):
                beta = beta / np.float32(1.5)
            beta = np.clip(beta, np.float32(1e-20), np.float32(1.0))
            for h, v in zip(hist, (mse, kl_bits, beta)):
                h.append(v)
            counter[0] += 1
        hist = tuple(np.array(h, np.float32) for h in hist)
        if jax_side:
            state = state.replace(w=JGaussian(jnp.full_like(state.w.loc, counter[0]),
                                              state.w.log_scale))
            return state, priors, jnp.float32(beta), key, hist
        state = copy.copy(state)
        state.w = Gaussian(torch.full_like(state.w.loc, counter[0]), state.w.log_scale)
        return state, priors, beta, hist

    monkeypatch.setattr(pkg, "em_iters", fake)
    monkeypatch.setattr(pkg, "realized_bitrate", lambda s, p, c: next(rate))
    X, Y = synthetic_dataset(JTINY, 1, seed=0)
    log = lambda i, rec, s, p: logs.append((i, dict(rec)))  # noqa: E731
    ckpt = lambda i, s, p, b, c: ckpts.append((i, b, dict(c)))  # noqa: E731
    if jax_side:
        res = jtr.em_train(jax.random.key(0), JTINY, jnp.asarray(X), jnp.asarray(Y),
                           TARGET, log_fn=log, checkpoint_fn=ckpt, **kw)
    else:
        res = tr.em_train(torch.Generator().manual_seed(0), get_config("tiny"),
                          torch.from_numpy(X), torch.from_numpy(Y), TARGET, log_fn=log,
                          checkpoint_fn=ckpt, **kw)
    return (res, calls, res.kl_beta, float(np.asarray(res.state.w.loc).flat[0]), logs, ckpts)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_controller_decisions_match_jax(monkeypatch, scenario):
    """The rate controller of both packages' em_train under one scripted
    trainer and one realized-rate sequence (as the JAX package's own tests
    script them): the same chunks and budget windows passed to em_iters
    (so the same aim at every chunk), the same history records (beta,
    probes, aims, the early stop), controller dict, kl_beta, log and
    checkpoint calls, and the same returned state (rate_select): equal."""
    kw, script, rates = _scenario(scenario, jtr.rate_quantum(JTINY))
    with monkeypatch.context() as m:
        jres = _scripted_run(jtr, kw, script, rates, m)
    with monkeypatch.context() as m:
        pres = _scripted_run(tr, kw, script, rates, m)
    (jr, *jrest), (pr, *prest) = jres, pres
    assert prest == jrest
    assert pr.elbo_history == jr.elbo_history
    assert pr.controller == jr.controller
    # the scenarios exercise what they are named after
    c = jr.controller
    expect = {"rate_select_best_probe": "selected" in c,
              "rate_select_final_ties": "selected" not in c,
              "em_stop_plateau_no_rate_control": "em_stop" in c,
              "em_stop_needs_deadband": "em_stop" not in c,
              "em_stop_in_deadband": "em_stop" in c,
              "em_stop_settled_off_target": "em_stop" in c,
              "em_stop_blocked_improving": "em_stop" not in c,
              "settled_undershoot": c["in_window"] and not c["seen_above"],
              "engage_from_above": c["in_window"] and c["seen_above"],
              "engage_rising": c["in_window"] and not c["seen_above"]}
    assert expect.get(scenario, True), c


def test_em_train_matches_jax_end_to_end(monkeypatch):
    """A whole em_train (4 iterations in chunks (1 x 3 epochs), (1 x 2),
    (2 x 2), probes every iteration once engaged) from one state with JAX's
    noise replayed across the chunks and one realized-rate sequence: the
    final state (``_state_close``), the history's mse and KL bits
    (``_close``), beta (rel 1e-6) and every controller decision: equal."""
    jcfg, cfg, X, Y, js, jp, ps, pp = both_states("tiny", perturb=False)
    rates = [1.2 * TARGET, 1.05 * TARGET, TARGET, TARGET, TARGET]
    kw = dict(n_em_iters=4, first_epochs=3, later_epochs=2, lr=2e-3, checkpoint_every=2,
              probe_every=1, rate_control=True)
    with monkeypatch.context() as m:
        it = iter(rates)
        m.setattr(jtr, "realized_bitrate", lambda s, p, c: next(it))
        jres = jtr.em_train(jax.random.key(5), jcfg, jnp.asarray(X), jnp.asarray(Y), TARGET,
                            state=jax.tree_util.tree_map(jnp.copy, js), **kw)
    plan = tr.em_chunks(4, 2, 3, 2)
    keys = jax_epoch_keys(jax.random.key(5), [e for n, e in plan for _ in range(n)])
    with monkeypatch.context() as m:
        it = iter(rates)
        m.setattr(tr, "realized_bitrate", lambda s, p, c: next(it))
        pres = tr.em_train(replay(keys, js), cfg, torch.from_numpy(X), torch.from_numpy(Y),
                           TARGET, state=ps, **kw)
    _state_close(pres.state, jres.state, js, 2e-3, 9)
    _priors_close(pres.priors, pres.state, js, jcfg)
    assert pres.kl_beta == pytest.approx(jres.kl_beta, rel=1e-6)
    assert pres.controller == jres.controller
    assert len(pres.elbo_history) == len(jres.elbo_history) == 4
    for got, want in zip(pres.elbo_history, jres.elbo_history):
        assert got.keys() == want.keys()
        for k in got:
            if k in ("mse", "kl_bits"):
                _close(got[k], want[k], k)
            elif k == "kl_beta":
                assert got[k] == pytest.approx(want[k], rel=1e-6)
            else:
                assert got[k] == want[k], k


def test_em_train_draws_its_initial_state_from_a_generator():
    cfg = get_config("tiny")
    X, Y = (torch.from_numpy(a) for a in synthetic_dataset(JTINY, 2, seed=0))
    runs = [tr.em_train(torch.Generator().manual_seed(1), cfg, X, Y, 2.0, n_em_iters=2,
                        first_epochs=2, later_epochs=1, rate_control=False) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0].state.leaves(), runs[1].state.leaves()))
    assert [h["em_iter"] for h in runs[0].elbo_history] == [0, 1]
    with pytest.raises(ValueError, match="Generator"):
        tr.em_train(lambda: None, cfg, X, Y, 2.0, n_em_iters=1)
