"""Exponential parameter database (paper Alg 2).

For every unique (ii, oo) pair in a benchmark sub-dataset, fit the
exponential model parameters and store them in P (lookup) and T (training
rows for the parameter predictor).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.expmodel import exp_model, initial_params
from repro_torch.core.fit import _pow2, fit_exponential_groups


@dataclasses.dataclass
class ExpDatabase:
    params: Dict[Tuple[float, float], np.ndarray]  # (ii,oo) -> (a,b,c)
    training: np.ndarray                            # (n, 5): ii,oo,a,b,c

    def lookup(self, ii: float, oo: float) -> Optional[np.ndarray]:
        return self.params.get((float(ii), float(oo)))

    def __len__(self):
        return len(self.params)


def exponential_groups(ii, oo, bb, thpt, min_points: int = 1):
    """Alg 2's grouping: the unique (ii, oo) keys, lexicographic, the
    indices of the groups with at least ``min_points`` rows, and those
    groups as (bb, thpt, theta0) ready for ``fit_exponential_groups``."""
    ii = np.asarray(ii, np.float64)
    oo = np.asarray(oo, np.float64)
    bb = np.asarray(bb, np.float64)
    thpt = np.asarray(thpt, np.float64)

    keys = np.stack([ii, oo], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    groups = []
    kept = []
    for g in range(len(uniq)):
        rows = inv == g
        if rows.sum() < min_points:
            continue
        gb, gt = bb[rows], thpt[rows]
        theta0 = initial_params(gb, gt)
        groups.append((gb, gt, theta0))
        kept.append(g)
    return uniq, kept, groups


def database_from_fit(uniq, kept, theta) -> Optional[ExpDatabase]:
    """The database of the fitted groups: P and T in ``uniq``'s order,
    dropping every group whose fit is not finite ("optimization
    successful"); None when none is left."""
    params: Dict[Tuple[float, float], np.ndarray] = {}
    training = []
    for (g, th) in zip(kept, theta):
        if not np.all(np.isfinite(th)):
            continue
        key = (float(uniq[g, 0]), float(uniq[g, 1]))
        params[key] = th
        training.append([key[0], key[1], th[0], th[1], th[2]])
    if not training:
        return None
    return ExpDatabase(params=params, training=np.asarray(training))


def build_exponential_database(ii, oo, bb, thpt, min_points: int = 1,
                               device=None) -> Optional[ExpDatabase]:
    """Alg 2: group by unique (ii, oo), percentile-init, batched LM fit
    on ``device`` (None: the GPU)."""
    return build_exponential_databases([(ii, oo, bb, thpt)], min_points,
                                       device)[0]


def build_exponential_databases(workloads, min_points: int = 1,
                                device=None) -> List[Optional[ExpDatabase]]:
    """Alg 2 for many sub-datasets at once (the registry's combinations):
    each (ii, oo, bb, thpt) gets the database ``build_exponential_database``
    gives it, bit for bit, from one batched LM solve per row padding.

    A group's fit depends on its batch only through the padded row length
    (``core.fit``: bit-identical whatever else shares the batch), and a
    database built alone pads to the power of two above its largest group.
    So the workloads are classed by that length, and every class is solved
    in one call with all its groups."""
    parts = [exponential_groups(*w, min_points=min_points)
             for w in workloads]
    classes: Dict[int, List[int]] = {}
    for i, (_, _, groups) in enumerate(parts):
        if groups:
            pad = _pow2(max(len(g[0]) for g in groups))
            classes.setdefault(pad, []).append(i)
    thetas: Dict[int, np.ndarray] = {}
    for pad, members in sorted(classes.items()):
        theta = fit_exponential_groups(
            [g for i in members for g in parts[i][2]], pad_to=pad,
            device=device)
        start = 0
        for i in members:
            n = len(parts[i][2])
            thetas[i] = theta[start:start + n]
            start += n
    return [database_from_fit(uniq, kept, thetas[i]) if i in thetas
            else None for i, (uniq, kept, _) in enumerate(parts)]


def update_exponential_database(prev: Optional[ExpDatabase],
                                ii, oo, bb, thpt, n_delta: int,
                                min_points: int = 1, device=None
                                ) -> Optional[ExpDatabase]:
    """Incremental Alg 2 after ``n_delta`` rows were *appended*.

    The batched LM fit is per-group independent (zero-weight padding
    rows contribute exact zeros), so only the (ii, oo) groups the delta
    touches need a refit — over their full rows, since an LM solve is
    not additive — and every untouched group's params are reused as-is.
    Output ordering (params insertion, training rows) follows the same
    lexicographic ``np.unique`` order as ``build_exponential_database``,
    so downstream predictor training sees identically-ordered input.
    ``prev=None`` (or a non-appended history) falls back to the full
    build.
    """
    if prev is None or n_delta >= len(np.atleast_1d(ii)):
        return build_exponential_database(ii, oo, bb, thpt,
                                          min_points=min_points,
                                          device=device)
    ii = np.asarray(ii, np.float64)
    oo = np.asarray(oo, np.float64)
    bb = np.asarray(bb, np.float64)
    thpt = np.asarray(thpt, np.float64)
    n_old = len(ii) - int(n_delta)
    touched = {(float(a), float(b))
               for a, b in zip(ii[n_old:], oo[n_old:])}

    keys = np.stack([ii, oo], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    counts = np.bincount(inv, minlength=len(uniq))
    groups, kept = [], []
    for g in range(len(uniq)):
        key = (float(uniq[g, 0]), float(uniq[g, 1]))
        if key not in touched:
            continue
        rows = inv == g
        if rows.sum() < min_points:
            continue
        gb, gt = bb[rows], thpt[rows]
        groups.append((gb, gt, initial_params(gb, gt)))
        kept.append(g)
    # pad to the full batch's max group size — zero-weight rows keep the
    # float32 reduction order of the full build, so the subset solve is
    # bit-identical to the fit a from-scratch build would produce
    theta_new = (fit_exponential_groups(groups, pad_to=int(counts.max()),
                                        device=device)[:len(kept)]
                 if groups else np.zeros((0, 3)))
    refit = {kept[j]: theta_new[j] for j in range(len(kept))}

    params: Dict[Tuple[float, float], np.ndarray] = {}
    training = []
    for g in range(len(uniq)):
        key = (float(uniq[g, 0]), float(uniq[g, 1]))
        if key in touched:
            th = refit.get(g)
            if th is None or not np.all(np.isfinite(th)):
                continue              # same drop rules as the full build
        else:
            th = prev.params.get(key)
            if th is None:            # previously dropped; rows unchanged
                continue
        params[key] = th
        training.append([key[0], key[1], th[0], th[1], th[2]])
    if not training:
        return None
    return ExpDatabase(params=params, training=np.asarray(training))


@dataclasses.dataclass
class GroupStructure:
    """Precomputed (ii, oo) group rectangles for repeated masked fits.

    Alg 2 groups rows by unique (ii, oo); when the same benchmark data is
    re-fit under many training subsets (Alg 6), the groups never change —
    only which rows are *included*.  Padding every group to ``maxn`` rows
    once lets each subset evaluation run as a fixed-shape weighted fit
    (`fit_exponential_masked`) instead of re-grouping and re-padding.
    """
    keys: np.ndarray        # (G, 2) unique (ii, oo), lexicographic
    bb: np.ndarray          # (G, maxn) padded batch sizes
    thpt: np.ndarray        # (G, maxn) padded throughputs
    row_w: np.ndarray       # (G, maxn) 1.0 for real rows, 0.0 for padding
    bb_codes: np.ndarray    # (G, maxn) int32 index into bb_universe
    bb_universe: np.ndarray  # (U,) sorted unique batch sizes
    bb_present: np.ndarray  # (G, U) bool: bb value occurs in group rows

    def __len__(self):
        return len(self.keys)


def build_group_structure(ii, oo, bb, thpt) -> GroupStructure:
    """Group rows by unique (ii, oo) and pad to rectangles (see above)."""
    ii = np.asarray(ii, np.float64)
    oo = np.asarray(oo, np.float64)
    bb = np.asarray(bb, np.float64)
    thpt = np.asarray(thpt, np.float64)
    keys = np.stack([ii, oo], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    G = len(uniq)
    counts = np.bincount(inv, minlength=G)
    maxn = int(counts.max()) if G else 0
    bb_u = np.unique(bb)
    order = np.argsort(inv, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    bb_p = np.zeros((G, maxn), np.float64)
    th_p = np.zeros((G, maxn), np.float64)
    w_p = np.zeros((G, maxn), np.float64)
    code_p = np.zeros((G, maxn), np.int32)
    present = np.zeros((G, len(bb_u)), bool)
    codes = np.searchsorted(bb_u, bb)
    for g in range(G):
        rows = order[starts[g]:starts[g + 1]]
        n = len(rows)
        bb_p[g, :n] = bb[rows]
        th_p[g, :n] = thpt[rows]
        w_p[g, :n] = 1.0
        code_p[g, :n] = codes[rows]
        present[g, codes[rows]] = True
    return GroupStructure(keys=uniq, bb=bb_p, thpt=th_p, row_w=w_p,
                          bb_codes=code_p, bb_universe=bb_u,
                          bb_present=present)


def db_predict(db: ExpDatabase, ii: float, oo: float, bb) -> Optional[np.ndarray]:
    th = db.lookup(ii, oo)
    if th is None:
        return None
    return exp_model(np.asarray(bb, np.float64), *th)
