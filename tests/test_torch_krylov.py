"""PyTorch port vs the JAX package: the Krylov solvers other than FGMRES
(gmres, lgmres, cg, minres, cg_normal, cg_block).

Each batched port solver runs on bs >= 3 systems of the JAX tests' kinds
(tests/test_krylov.py, tests/test_misc.py::test_lgmres): SPD n 60 at cond
1e2, and at cond 1e5 with a diagonal preconditioner; symmetric indefinite n
50; nonsymmetric n 40; least squares 30 x 20; cg_block at bs 4, n 24 with
one zero right-hand side.  The samples of a batch differ in conditioning,
so they stop at different iterations: the per-sample masks must reproduce
the vmapped while_loop's freeze.  The reference is `jax.vmap` of the JAX
solver on the same numpy inputs, in float64.  Tolerances: x within 1e-10
relative (max-abs over max-abs), per-sample iteration counts equal, rnorm
within 1e-10 of ||b||.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.solvers import krylov as tk
from mech_nn_discovery_pde_tpu.solvers import krylov as jk

torch.set_num_threads(1)
TOL = 1e-10


def make_spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return Q @ np.diag(np.logspace(0, np.log10(cond), n)) @ Q.T


def make_scaled_spd(n, cond, seed):
    """D S D with S SPD at cond 10 and D spread over sqrt(cond): cond about
    `cond`, and about 10 after the diagonal (Jacobi) preconditioner."""
    d = np.logspace(0, np.log10(cond) / 2, n)[np.random.default_rng(seed).permutation(n)]
    return d[:, None] * make_spd(n, 10.0, seed) * d[None, :]


def make_indefinite(n, scale, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.concatenate([np.linspace(1, 10 * scale, n // 2),
                           -np.linspace(1, 5 * scale, n - n // 2)])
    return Q @ np.diag(eigs) @ Q.T


def make_nonsym(n, scale, seed):
    rng = np.random.default_rng(seed)
    return np.eye(n) * 5 + scale * rng.standard_normal((n, n))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def bmv(A):
    return lambda v: torch.einsum("bij,bj->bi", A, v)


def check(res, jres, b, distinct=True):
    """x, per-sample iterations and rnorm of the port against the JAX
    package's vmapped result."""
    iters = res.iters.tolist()
    assert iters == np.asarray(jres.iters).tolist()
    if distinct:
        assert len(set(iters)) > 1, iters  # the masks were exercised
    assert rel(res.x, jres.x) <= TOL
    bn = np.linalg.norm(b, axis=1)
    assert (np.abs(res.rnorm.numpy() - np.asarray(jres.rnorm)) <= TOL * bn).all()


@pytest.mark.parametrize("cond,precond", [(1e2, False), (1e5, True)])
def test_cg_matches_jax(cond, precond):
    """At cond 1e5 the systems are diagonally scaled, so the diagonal
    preconditioner brings them to cond ~10 (CG's iterates then stay far
    above rounding, whose order differs between the packages)."""
    n = 60
    make = make_scaled_spd if precond else make_spd
    A = np.stack([make(n, c, 7 + k) for k, c in enumerate((cond, cond / 10, cond / 100))])
    b = np.random.default_rng(8).standard_normal((3, n))
    kw = dict(maxiter=2000, tol=1e-10)

    def jone(A, b):
        d = 1.0 / jnp.diag(A)
        return jk.cg(lambda v: A @ v, b, precond=(lambda r: d * r) if precond else None, **kw)

    jres = jax.jit(jax.vmap(jone))(A, b)
    tA = torch.tensor(A)
    d = 1.0 / torch.diagonal(tA, dim1=1, dim2=2)
    res = tk.cg(bmv(tA), torch.tensor(b), precond=(lambda r: d * r) if precond else None, **kw)
    check(res, jres, b)


def test_minres_matches_jax():
    n = 50
    A = np.stack([make_indefinite(n, s, 11 + k) for k, s in enumerate((1.0, 4.0, 20.0))])
    b = np.random.default_rng(12).standard_normal((3, n))
    kw = dict(maxiter=500, tol=1e-10)
    jres = jax.jit(jax.vmap(lambda A, b: jk.minres(lambda v: A @ v, b, **kw)))(A, b)
    check(tk.minres(bmv(torch.tensor(A)), torch.tensor(b), **kw), jres, b)


def test_gmres_matches_jax():
    n = 40
    A = np.stack([make_nonsym(n, s, 12 + k) for k, s in enumerate((0.2, 0.5, 0.9))])
    b = np.random.default_rng(13).standard_normal((3, n))
    kw = dict(restart=5, maxiter=400, tol=1e-10, atol=1e-10)
    jres = jax.jit(jax.vmap(lambda A, b: jk.gmres(lambda v: A @ v, b, **kw)))(A, b)
    check(tk.gmres(bmv(torch.tensor(A)), torch.tensor(b), **kw), jres, b)


def test_lgmres_matches_jax():
    """On the nonsymmetric and the SPD kind (cond 1e3, test_lgmres's)."""
    n = 40
    A = np.stack([make_nonsym(n, 0.3, 14), make_nonsym(n, 0.6, 15), make_spd(n, 1e3, 4)])
    b = np.random.default_rng(16).standard_normal((3, n))
    kw = dict(restart=10, n_aug=3, maxiter=400, tol=1e-10, atol=1e-10)
    jres = jax.jit(jax.vmap(lambda A, b: jk.lgmres(lambda v: A @ v, b, **kw)))(A, b)
    check(tk.lgmres(bmv(torch.tensor(A)), torch.tensor(b), **kw), jres, b)


def test_cg_normal_matches_jax():
    """n 20 unknowns: CG ends in about 21 steps.  tol 1e-10 stops the samples
    at 21 and 22, each residual at least 2x from the threshold (at 1e-9 one
    sample sits at 1.03e-9, where rounding decides the step).  Earlier stops
    are no test of the port: midway the two packages' iterates part by up
    to 1e-5 (rounding, amplified by the squared conditioning) and meet
    again as CG converges."""
    rng = np.random.default_rng(13)
    A = rng.standard_normal((3, 30, 20)) * np.array([1.0, 1.5, 2.0])[:, None, None] ** (
        np.linspace(0, 1, 20)[None, None, :])
    b = np.einsum("bij,bj->bi", A.transpose(0, 2, 1), rng.standard_normal((3, 30)))
    kw = dict(maxiter=500, tol=1e-10)
    jres = jax.jit(jax.vmap(
        lambda A, b: jk.cg_normal(lambda v: A @ v, lambda y: A.T @ y, b, **kw)))(A, b)
    tA = torch.tensor(A)
    res = tk.cg_normal(bmv(tA), bmv(tA.transpose(1, 2)), torch.tensor(b), **kw)
    check(res, jres, b)


def test_cg_block_matches_jax():
    """The fixed-loop masked block CG equals the JAX package's (and the
    port's vmapped-equivalent cg), a zero right-hand side frozen at 0."""
    rng = np.random.default_rng(0)
    bs, n = 4, 24
    Ms = rng.standard_normal((bs, n, n))
    A = np.einsum("bij,bkj->bik", Ms, Ms) + 10 * np.eye(n)
    b = rng.standard_normal((bs, n))
    b[2] = 0.0
    jA = jnp.asarray(A)
    jx, jres = jax.jit(lambda b: jk.cg_block(lambda x: jnp.einsum("bij,bj->bi", jA, x), b,
                                              tol=1e-12, maxiter=200))(b)
    tA = torch.tensor(A)
    x, resid = tk.cg_block(bmv(tA), torch.tensor(b), tol=1e-12, maxiter=200)
    assert rel(x, jx) <= TOL
    assert (np.abs(resid.numpy() - np.asarray(jres)) <= TOL * max(np.linalg.norm(b), 1)).all()
    assert float(resid[2]) == 0.0 and float(x[2].abs().max()) == 0.0
    cgx = tk.cg(bmv(tA), torch.tensor(b), tol=1e-12, maxiter=200).x
    assert rel(x, cgx) <= 1e-8
