"""Batched nonlinear least squares for the exponential model, on the device.

Alg 2's ``Optimize`` step is a Levenberg–Marquardt solve run for every
workload group at once: a (G, m) batch of groups in float32 tensors, 60
steps, each a handful of elementwise ops over the whole batch.  It stands
in for the reference's ``jax.jit(jax.vmap(_fit_one))``.

Bounds (a, b >= 0; c >= 0) are enforced by projection after each LM step,
matching the paper's "bounded constraints" note.  Masked padding rows
make ragged groups rectangular.

A group's result is bit-identical whatever else shares the batch: every op
is elementwise over the groups, the 3x3 solve is the closed form
``_solve3``, and the sums over a group's rows are a fixed pairwise halving
of the power-of-two row axis (``_row_sums``) rather than a matmul or
``torch.sum``, whose reduction strategy may follow the batch's shape.
``update_exponential_database`` depends on that invariance.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.expmodel import exp_model
from repro_torch.device import resolve_device

_LM_ITERS = 60
_MU0 = 1e-2
# the optimum a 60-step float32 fit is judged by: the same LM in float64
# for 2,000 steps (2,000 and 4,000 agree within 3.2e-5 on suite's curves)
_OPT_ITERS = 2000
# lm_agreement's contract: curves within 1e-3 relative where converged
# (within 1e-4 of the optimum), within 2e-2 elsewhere, and fewer than a
# tenth of the groups beyond 1e-3
CURVE_RTOL = 1e-3
CONVERGED_RTOL = 1e-4
UNCONVERGED_RTOL = 2e-2
BEYOND_SHARE = 0.1


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis, a power of two, by halving it log2(m)
    times: elementwise adds only, in an order fixed by m alone."""
    m = x.shape[-1]
    while m > 1:
        m //= 2
        x = x[..., :m] + x[..., m:]
    return x[..., 0]


def _solve3(A, b):
    """Closed-form 3x3 solve (adjugate / Cramer) of a batch of systems.

    ``A`` is a 3x3 nest of (G,) tensors, ``b`` a triple of them.
    Elementwise arithmetic only, so — unlike a batched LU, which rounds
    differently for different batch sizes — the result for one system is
    bit-identical whatever else shares the batch.
    """
    c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1]
    c01 = A[1][2] * A[2][0] - A[1][0] * A[2][2]
    c02 = A[1][0] * A[2][1] - A[1][1] * A[2][0]
    det = A[0][0] * c00 + A[0][1] * c01 + A[0][2] * c02
    c10 = A[0][2] * A[2][1] - A[0][1] * A[2][2]
    c11 = A[0][0] * A[2][2] - A[0][2] * A[2][0]
    c12 = A[0][1] * A[2][0] - A[0][0] * A[2][1]
    c20 = A[0][1] * A[1][2] - A[0][2] * A[1][1]
    c21 = A[0][2] * A[1][0] - A[0][0] * A[1][2]
    c22 = A[0][0] * A[1][1] - A[0][1] * A[1][0]
    singular = det == 0
    safe = torch.where(singular, torch.ones_like(det), det)
    zero = torch.zeros_like(det)
    return tuple(torch.where(singular, zero, (r0 * b[0] + r1 * b[1]
                                              + r2 * b[2]) / safe)
                 for r0, r1, r2 in ((c00, c10, c20), (c01, c11, c21),
                                    (c02, c12, c22)))


def _residuals(a, b, c, x, y, w):
    """Weighted residuals, their row sums of squares, and exp(-b x)."""
    e = torch.exp(-b[:, None] * x)
    r = ((c[:, None] - a[:, None] * e) - y) * w
    return r, _row_sums(r * r), e


def _fit_batch(theta0: torch.Tensor, x, y, w,
               iters: int = _LM_ITERS) -> torch.Tensor:
    """(G, 3) start + (G, m) rows, m a power of two -> (G, 3) fitted
    (a, b, c), in the inputs' dtype (float32 on Alg 2's path)."""
    a, b, c = theta0.unbind(1)
    mu = torch.full_like(a, _MU0)
    for _ in range(iters):
        r, loss, e = _residuals(a, b, c, x, y, w)
        # analytic Jacobian of the residuals wrt (a, b, c)
        J = (-e * w, a[:, None] * x * e * w, w)
        s = _row_sums(torch.stack([
            J[0] * J[0], J[0] * J[1], J[0] * J[2], J[1] * J[1],
            J[1] * J[2], J[2] * J[2], J[0] * r, J[1] * r, J[2] * r]))
        A = ((s[0] + mu, s[1], s[2]), (s[1], s[3] + mu, s[4]),
             (s[2], s[4], s[5] + mu))
        da, db, dc = _solve3(A, (-s[6], -s[7], -s[8]))
        # projected bounds: a,b,c >= tiny (b also capped to avoid overflow)
        na = torch.clamp(a + da, min=1e-8)
        nb = torch.clamp(b + db, 1e-8, 50.0)
        nc = torch.clamp(c + dc, min=0.0)
        _, new_loss, _ = _residuals(na, nb, nc, x, y, w)
        improved = new_loss < loss
        a = torch.where(improved, na, a)
        b = torch.where(improved, nb, b)
        c = torch.where(improved, nc, c)
        mu = torch.clamp(torch.where(improved, mu * 0.5, mu * 2.5),
                         1e-10, 1e8)
    return torch.stack([a, b, c], dim=1)


def _pow2(n: int, lo: int = 1) -> int:
    """Next power of two >= n — the shape bucketing of the reference's
    solvers, kept so that padding and row order match it."""
    return max(lo, 1 << max(int(n) - 1, 0).bit_length())


def _solve_padded(T0, X, Y, W, device, dtype=torch.float32,
                  iters: int = _LM_ITERS) -> np.ndarray:
    """float32 numpy rectangles -> float64 (G, 3) fit, on ``device``, the
    LM run in ``dtype``.  ``_solve_padded.solves`` counts the batched
    solves."""
    dev = resolve_device(device)
    theta = _fit_batch(*(torch.from_numpy(a).to(dev, dtype)
                         for a in (T0, X, Y, W)), iters=iters)
    _solve_padded.solves += 1
    return theta.cpu().to(torch.float64).numpy()


_solve_padded.solves = 0


def fit_exponential_groups(groups, pad_to: int = 0, device=None,
                           dtype=torch.float32, iters: int = _LM_ITERS):
    """Fit (a,b,c) for a list of (bb, thpt, theta0) ragged groups.

    Returns (G, 3) float64 array.  Groups are padded to the max length and
    solved in one batched LM call on ``device`` (None: the GPU).

    The group dimension pads to the next power of two (at least 2) with
    all-zero dummy groups and the row dimension to the next power of two
    above ``max(group sizes, pad_to)``, as the reference does.  ``pad_to``
    lets an incremental refit of a *subset* of groups
    (``update_exponential_database``) reproduce the full batch's row
    padding — and therefore its float32 reduction order — bit-for-bit.
    """
    if not groups:
        return np.zeros((0, 3))
    maxn = _pow2(max(max(len(g[0]) for g in groups), pad_to, 1))
    G = len(groups)
    Gp = _pow2(G, lo=2)
    X = np.zeros((Gp, maxn), np.float32)
    Y = np.zeros((Gp, maxn), np.float32)
    W = np.zeros((Gp, maxn), np.float32)
    T0 = np.zeros((Gp, 3), np.float32)
    scale = np.zeros(G, np.float64)
    for i, (bb, thpt, theta0) in enumerate(groups):
        n = len(bb)
        # normalize thpt per group for conditioning; rescale after
        s = max(float(np.max(np.abs(thpt))), 1e-9)
        X[i, :n] = bb
        Y[i, :n] = np.asarray(thpt, np.float64) / s
        W[i, :n] = 1.0
        T0[i] = theta0 * np.array([1 / s, 1.0, 1 / s])
        scale[i] = s
    theta = _solve_padded(T0, X, Y, W, device, dtype, iters)[:G]
    theta[:, 0] *= scale
    theta[:, 2] *= scale
    return theta


def lm_optimum(groups, pad_to: int = 0) -> np.ndarray:
    """Each group's optimum, as ``lm_agreement`` reads convergence: the
    same LM from the same start in float64 for 2,000 steps, on the CPU."""
    return fit_exponential_groups(groups, pad_to, device="cpu",
                                  dtype=torch.float64, iters=_OPT_ITERS)


def lm_agreement(groups, got, want, opt, share=BEYOND_SHARE) -> dict:
    """The LM contract between two 60-step fits of the same groups:
    ``got`` (G, 3) held to ``want``, by their curves at each group's
    batch sizes.

    A group is converged where ``want``'s curve lies within
    ``CONVERGED_RTOL`` of ``opt``'s (``lm_optimum``).  There ``got`` must
    be within ``CURVE_RTOL`` relative.  Elsewhere the float32 LM has not
    converged in its 60 steps, and two fits that differ only in rounding
    stop at different points of a flat valley: ``got`` must be within
    ``UNCONVERGED_RTOL``, and (unless ``share`` is None) fewer than
    ``share`` of all groups may lie beyond ``CURVE_RTOL``.  Returns the
    counts, the worst gaps and ``ok``."""
    n = len(groups)
    rel = np.zeros(n)
    conv = np.zeros(n, bool)
    for i, g in enumerate(groups):
        x = np.unique(g[0])
        w = exp_model(x, *want[i])
        rel[i] = np.max(np.abs(exp_model(x, *got[i]) - w) / np.abs(w))
        conv[i] = (np.max(np.abs(exp_model(x, *opt[i]) - w) / np.abs(w))
                   <= CONVERGED_RTOL)
    out = dict(n=n, converged=int(conv.sum()),
               beyond=int((rel > CURVE_RTOL).sum()),
               worst_converged=float(rel[conv].max(initial=0.0)),
               worst=float(rel.max(initial=0.0)), rel=rel,
               is_converged=conv)
    out["ok"] = bool(out["worst_converged"] <= CURVE_RTOL
                     and out["worst"] <= UNCONVERGED_RTOL
                     and (share is None or out["beyond"] < share * n))
    return out


def fit_exponential_masked(theta0, X, Y, W, device=None):
    """Fixed-shape batched LM: (G, maxn) rectangles with 0/1 row weights.

    The batched annealing engine calls this with the *same* (G, maxn)
    every evaluation — subset membership only flips weights.  Zero-weight
    rows contribute nothing to the residuals (they are scaled by w inside
    the solver), and all-zero groups take no LM step (J = 0 => delta = 0),
    returning theta0 for the caller to mask.

    theta0: (G, 3); X/Y/W: (G, maxn).  Returns float64 (G, 3).  Both
    dimensions pad to powers of two with all-zero rows and groups.
    """
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    W = np.asarray(W, np.float64)
    G, maxn = X.shape
    s = np.maximum(np.max(np.abs(Y) * (W > 0), axis=1), 1e-9)
    T0 = np.asarray(theta0, np.float64) \
        * np.stack([1.0 / s, np.ones_like(s), 1.0 / s], axis=1)
    Gp, Mp = _pow2(G, lo=2), _pow2(maxn)
    T0p = np.zeros((Gp, 3), np.float32)
    Xp = np.zeros((Gp, Mp), np.float32)
    Yp = np.zeros((Gp, Mp), np.float32)
    Wp = np.zeros((Gp, Mp), np.float32)
    T0p[:G] = T0
    Xp[:G, :maxn] = X
    Yp[:G, :maxn] = Y / s[:, None]
    Wp[:G, :maxn] = W
    theta = _solve_padded(T0p, Xp, Yp, Wp, device)[:G]
    theta[:, 0] *= s
    theta[:, 2] *= s
    return theta
