"""Simulated annealing over training-subset space (paper Alg 6).

State = which unique values of (ii, oo, bb) are included in the training
subset.  EvaluateSubset trains the full ALA pipeline (Alg 2 + Alg 3) on
the filtered rows and scores median percentage error on a held-out
evaluation set.  Every iteration logs (subset, error) — the raw material
for the error predictor (Alg 7) and the uncertainty metric (Alg 8).

Two engines share the ``SALog`` contract:

  * ``anneal``          — the original serial loop: one chain, one full
    pipeline train per iteration (re-groups and re-pads every subset).
  * ``anneal_batched``  — K parallel chains over a shared
    ``_BatchedEvaluator``: subset membership becomes 0/1 weights on
    fixed (G, maxn) group rectangles, the exponential fits of every
    candidate run as one masked LM solve, the per-subset GBTs grow
    jointly via ``fit_packed_forest``, and a fingerprint-keyed cache
    dedupes re-proposed subsets across all chains.

The proposal stream is a seeded numpy ``Generator``, as in the reference;
the LM solves, GBT histograms and forest traversals run on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.database import (build_exponential_database,
                                       build_group_structure)
from repro_torch.core.features import engineer
from repro_torch.core.fit import fit_exponential_masked
from repro_torch.core.gbt import MultiOutputGBT, fit_packed_forest
from repro_torch.core.predictor import (predict_throughput,
                                        train_param_predictor)
from repro_torch.device import resolve_device

Subset = Dict[str, frozenset]


@dataclasses.dataclass
class SAConfig:
    n_iters: int = 150
    temperature: float = 10.0
    cooling: float = 0.97
    min_keep: int = 2           # never drop a dim below this many values
    seed: int = 0
    # GBT size during SA evaluations (smaller = faster exploration)
    gbt_kw: dict = dataclasses.field(default_factory=lambda: dict(
        n_estimators=60, learning_rate=0.15, max_depth=4))
    # batched engine (anneal_batched): parallel chains + shared cache
    n_chains: int = 1
    use_cache: bool = True


@dataclasses.dataclass
class SALog:
    subsets: List[Subset]
    errors: List[float]
    universes: Dict[str, np.ndarray]
    best_subset: Subset
    best_error: float

    def subset_masks(self, ii, oo, bb) -> np.ndarray:
        """(S, n) row masks of every logged subset over the given rows
        (vectorized; the raw material for Alg 8's ``SubsetBank``)."""
        return batch_subset_masks(ii, oo, bb, self.subsets, self.universes)


def merge_logs(old: SALog, new: SALog) -> SALog:
    """Append ``new``'s proposals to ``old``'s — one growing log across
    online data epochs.

    Universes take the per-dimension union (appended data can introduce
    new unique values; old subsets stay valid as partial selections of
    the wider universe).  ``best_subset``/``best_error`` come from
    ``new``: errors from different epochs are measured against different
    evaluation sets, so only the freshest epoch's optimum is the state a
    warm start should chain from.  The merged subset/error lists feed
    the Alg 7 error predictor and the Alg 8 bank window as usual.
    """
    universes = {k: np.unique(np.concatenate(
        [np.asarray(old.universes[k], np.float64),
         np.asarray(new.universes[k], np.float64)]))
        for k in new.universes}
    return SALog(subsets=list(old.subsets) + list(new.subsets),
                 errors=list(old.errors) + list(new.errors),
                 universes=universes,
                 best_subset=dict(new.best_subset),
                 best_error=float(new.best_error))


def median_ape(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Median absolute percentage error (the paper's headline metric)."""
    denom = np.maximum(np.abs(y_true), 1e-9)
    return float(np.median(np.abs(y_pred - y_true) / denom) * 100.0)


def subset_mask(ii, oo, bb, subset: Subset) -> np.ndarray:
    m = np.isin(ii, list(subset["ii"]))
    m &= np.isin(oo, list(subset["oo"]))
    m &= np.isin(bb, list(subset["bb"]))
    return m


def batch_subset_masks(ii, oo, bb, subsets: Sequence[Subset],
                       universes: Optional[Dict[str, np.ndarray]] = None
                       ) -> np.ndarray:
    """(S, n) row masks for many subsets in one vectorized pass.

    Rows are coded into each dimension's universe once; each subset then
    contributes three membership bit-vectors, and the mask is a gather +
    logical-and — no per-subset ``np.isin`` over the rows.  Equals
    ``np.stack([subset_mask(ii, oo, bb, s) for s in subsets])``.
    """
    cols = {"ii": np.asarray(ii), "oo": np.asarray(oo),
            "bb": np.asarray(bb)}
    if universes is None:
        universes = {k: np.unique(v) for k, v in cols.items()}
    n = len(cols["ii"])
    out = np.ones((len(subsets), n), bool)
    for dim, col in cols.items():
        u = np.asarray(universes[dim])
        code = np.searchsorted(u, col)
        code_ok = (code < len(u))
        codec = np.minimum(code, len(u) - 1)
        in_universe = code_ok & (u[codec] == col)
        member = np.zeros((len(subsets), len(u)), bool)
        for si, s in enumerate(subsets):
            member[si] = np.isin(u, list(s[dim]))
        out &= member[:, codec] & in_universe[None, :]
    return out


def evaluate_subset(train, test, subset: Subset,
                    gbt_kw: Optional[dict] = None, device=None) -> float:
    """Train ALA on the subset rows (on ``device``, None: the GPU);
    median APE on the eval rows."""
    ii, oo, bb, thpt = train
    tii, too, tbb, tthpt = test
    m = subset_mask(ii, oo, bb, subset)
    if m.sum() < 4:
        return 100.0
    db = build_exponential_database(ii[m], oo[m], bb[m], thpt[m],
                                    device=device)
    if db is None:
        return 100.0
    pred = None
    if len(db.training) >= 4:
        pred = train_param_predictor(db.training, device=device,
                                     **(gbt_kw or {}))
    yhat = predict_throughput(db, pred, tii, too, tbb)
    return median_ape(tthpt, yhat)


def _modify(subset: Subset, universes, rng, min_keep: int) -> Subset:
    """Randomly add or delete one value from one of the (ii,oo,bb) dims."""
    new = {k: set(v) for k, v in subset.items()}
    for _ in range(10):  # retry until a legal move is found
        dim = rng.choice(("ii", "oo", "bb"))
        cur = new[dim]
        universe = set(universes[dim].tolist())
        missing = sorted(universe - cur)
        can_add = bool(missing)
        can_del = len(cur) > min_keep
        if not (can_add or can_del):
            continue
        if can_add and (not can_del or rng.random() < 0.5):
            cur.add(missing[rng.integers(len(missing))])
        else:
            cur.remove(sorted(cur)[rng.integers(len(cur))])
        break
    return {k: frozenset(v) for k, v in new.items()}


def anneal(train, test, cfg: SAConfig,
           initial: Optional[Subset] = None,
           on_iter: Optional[Callable[[int, float], None]] = None,
           device=None) -> SALog:
    """Alg 6. ``train``/``test`` are (ii, oo, bb, thpt) tuples; every
    evaluation runs on ``device`` (None: the GPU)."""
    ii, oo, bb, _ = train
    rng = np.random.default_rng(cfg.seed)
    universes = {"ii": np.unique(ii), "oo": np.unique(oo),
                 "bb": np.unique(bb)}
    if initial is None:
        # start from a random half of each universe
        initial = _sample_initial(universes, rng, cfg.min_keep)
    best = dict(initial)
    e_best = evaluate_subset(train, test, best, cfg.gbt_kw, device)
    tau = cfg.temperature
    subsets, errors = [dict(best)], [e_best]
    # anchor: log the full-coverage subset so the error predictor is
    # calibrated for near-complete signatures (Alg 8 queries often are)
    full = {k: frozenset(u.tolist()) for k, u in universes.items()}
    subsets.append(full)
    errors.append(evaluate_subset(train, test, full, cfg.gbt_kw, device))
    for it in range(cfg.n_iters):
        tau *= cfg.cooling
        cand = _modify(best, universes, rng, cfg.min_keep)
        e_cand = evaluate_subset(train, test, cand, cfg.gbt_kw, device)
        accept = (e_cand < e_best or
                  rng.random() < np.exp((e_best - e_cand)
                                        / max(tau, 1e-9)))
        if accept:
            best, e_best = cand, e_cand
        subsets.append(dict(cand))
        errors.append(e_cand)
        if on_iter is not None:
            on_iter(it, e_cand)
    return SALog(subsets=subsets, errors=errors, universes=universes,
                 best_subset=best, best_error=e_best)


# ---------------------------------------------------------------------------
# Batched engine: K chains over a fixed-shape evaluator + shared cache
# ---------------------------------------------------------------------------

def subset_fingerprint(subset: Subset) -> Tuple:
    """Hashable identity of a subset — the eval-cache key."""
    return (subset["ii"], subset["oo"], subset["bb"])


class _BatchedEvaluator:
    """Evaluates batches of training subsets against one (train, test)
    split with every shape fixed up front.

    Construction precomputes the (ii, oo) group rectangles
    (``GroupStructure``), the engineered Alg 3 features for both the
    group keys and the test rows, and the test-row -> group mapping.  A
    subset evaluation is then: membership bit-vectors -> 0/1 row
    weights -> one masked LM solve for *all* candidates -> one
    jointly-grown packed GBT forest -> one vectorized Alg 5 prediction
    pass, all on ``device`` (None: the GPU).  Numerics follow
    ``evaluate_subset`` exactly (same group order, same init, same GBT
    math) up to float padding noise.
    """

    def __init__(self, train, test, gbt_kw: Optional[dict] = None,
                 predict_backend: str = "torch", device=None):
        self.device = resolve_device(device)
        ii, oo, bb, thpt = (np.asarray(v, np.float64) for v in train)
        self.universes = {"ii": np.unique(ii), "oo": np.unique(oo),
                          "bb": np.unique(bb)}
        self.gs = build_group_structure(ii, oo, bb, thpt)
        self.predict_backend = predict_backend
        g_keys = self.gs.keys
        self.g_ii_code = np.searchsorted(self.universes["ii"], g_keys[:, 0])
        self.g_oo_code = np.searchsorted(self.universes["oo"], g_keys[:, 1])
        self.Xtrain = engineer(g_keys[:, 0], g_keys[:, 1])       # (G, 7)

        tii, too, tbb, tthpt = (np.asarray(v, np.float64) for v in test)
        self.t_bb, self.t_thpt = tbb, tthpt
        keymap = {(float(a), float(b)): g
                  for g, (a, b) in enumerate(g_keys)}
        self.t_group = np.asarray(
            [keymap.get((float(a), float(b)), -1)
             for a, b in zip(tii, too)], np.int64)
        self.Xtest = engineer(tii, too)                           # (m, 7)
        self.t_ii, self.t_oo = tii, too

        kw = dict(n_estimators=150, learning_rate=0.08, max_depth=4,
                  n_bins=64)
        kw.update(gbt_kw or {})
        kw.setdefault("min_child_weight", 1.0)
        kw.setdefault("reg_lambda", 1.0)
        # fit_packed_forest has no row/column sampling; those options
        # (and seed, which only matters when sampling) drop to a
        # per-candidate MultiOutputGBT fallback with identical semantics
        self.sample_kw = {k: kw.pop(k)
                          for k in ("subsample", "colsample", "seed")
                          if k in kw}
        self._joint_gbt = (self.sample_kw.get("subsample", 1.0) >= 1.0
                           and self.sample_kw.get("colsample", 1.0) >= 1.0)
        self.gbt_kw = kw

    # -- helpers -------------------------------------------------------------
    def _member(self, subsets: Sequence[Subset], dim: str) -> np.ndarray:
        u = self.universes[dim]
        out = np.zeros((len(subsets), len(u)), bool)
        for c, s in enumerate(subsets):
            out[c] = np.isin(u, list(s[dim]))
        return out

    def _theta0(self, W: np.ndarray, n_bb: np.ndarray) -> np.ndarray:
        """Vectorized ``initial_params`` over (C, G) masked rectangles."""
        C, G, maxn = W.shape
        dead = W.sum(axis=2) <= 0
        Xn = np.where(W > 0, self.gs.bb[None], np.nan)
        Yn = np.where(W > 0, self.gs.thpt[None], np.nan)
        # dead groups would make nanpercentile warn on all-NaN slices
        Xn[dead] = 0.0
        Yn[dead] = 0.0
        t10, t90 = np.nanpercentile(Yn, [10, 90], axis=2)
        b10, b90 = np.nanpercentile(Xn, [10, 90], axis=2)
        b90 = np.maximum(b90, b10 + 1e-3)
        theta0 = np.stack([np.maximum(t90 - t10, 1e-5),
                           1.0 / np.maximum(b90 - b10, 1e-5),
                           np.maximum(t90, 1e-5)], axis=2)
        theta0[(n_bb <= 1) | dead] = (1.0, 0.001, 0.0)
        return theta0

    # -- the batch evaluation ------------------------------------------------
    def evaluate_batch(self, subsets: Sequence[Subset]) -> np.ndarray:
        C = len(subsets)
        if C == 0:
            return np.zeros(0)
        gs = self.gs
        G, maxn = gs.bb.shape
        m_ii = self._member(subsets, "ii")
        m_oo = self._member(subsets, "oo")
        m_bb = self._member(subsets, "bb")
        selected = (m_ii[:, self.g_ii_code]
                    & m_oo[:, self.g_oo_code])                  # (C, G)
        W = (gs.row_w[None] * m_bb[:, gs.bb_codes]
             * selected[:, :, None])                            # (C, G, maxn)
        rows_total = W.sum(axis=(1, 2))
        n_bb = (gs.bb_present[None] & m_bb[:, None, :]).sum(axis=2)
        theta0 = self._theta0(W, n_bb)

        # one LM solve for every candidate's groups
        theta = fit_exponential_masked(
            theta0.reshape(C * G, 3),
            np.broadcast_to(gs.bb[None], (C, G, maxn)).reshape(C * G, maxn),
            np.broadcast_to(gs.thpt[None], (C, G, maxn)).reshape(C * G, maxn),
            W.reshape(C * G, maxn), device=self.device).reshape(C, G, 3)

        fitted = (selected & (W.sum(axis=2) >= 1)
                  & np.isfinite(theta).all(axis=2))             # (C, G)
        n_fitted = fitted.sum(axis=1)

        # Alg 3 targets: (a, log b, c) for fitted groups, 0 elsewhere
        Y = np.where(fitted[:, :, None], np.nan_to_num(theta), 0.0)
        Y[:, :, 1] = np.where(fitted,
                              np.log(np.maximum(Y[:, :, 1], 1e-10)), 0.0)
        with_model = n_fitted >= 4
        model_rows = np.nonzero(with_model)[0]
        params = None
        if len(model_rows):
            if self._joint_gbt:
                Xb = np.broadcast_to(self.Xtrain[None],
                                     (len(model_rows),) + self.Xtrain.shape)
                forest = fit_packed_forest(
                    Xb, Y[model_rows],
                    fitted[model_rows].astype(np.float64),
                    device=self.device, **self.gbt_kw)
                params = self._predict_params(forest, len(model_rows))
            else:
                params = self._predict_params_sampled(Y, fitted, model_rows)

        # -- Alg 5, vectorized over candidates and test rows ----------------
        tg = np.maximum(self.t_group, 0)
        hit = (self.t_group >= 0)[None, :] & fitted[:, tg]      # (C, m)
        a = theta[:, tg, 0]
        b = theta[:, tg, 1]
        cc = theta[:, tg, 2]
        analytic = cc - a * np.exp(-b * self.t_bb[None, :])
        preds = np.where(hit, analytic, 0.0)

        if params is not None:
            ml = (params[:, :, 2]
                  - params[:, :, 0] * np.exp(-params[:, :, 1]
                                             * self.t_bb[None, :]))
            for j, c in enumerate(model_rows):
                miss = ~hit[c]
                preds[c, miss] = ml[j, miss]
        for c in np.nonzero(~with_model)[0]:
            miss = ~hit[c]
            if miss.any():
                preds[c, miss] = self._nearest_fallback(
                    theta[c], fitted[c], miss)

        errors = np.array([median_ape(self.t_thpt, preds[c])
                           for c in range(C)])
        errors[rows_total < 4] = 100.0
        errors[n_fitted == 0] = 100.0
        return errors

    def _predict_params(self, forest, n_active: int) -> np.ndarray:
        """Packed-forest Alg 3 inference -> (n_active, m, 3) (a, b, c)."""
        X = np.broadcast_to(self.Xtest[None], (n_active,) + self.Xtest.shape)
        params = forest.predict(X, backend=self.predict_backend)
        return self._postprocess_params(params.copy())

    def _predict_params_sampled(self, Y, fitted, model_rows) -> np.ndarray:
        """Fallback when gbt_kw requests row/column sampling: train one
        MultiOutputGBT per candidate (exactly the serial Alg 3 path)."""
        out = np.empty((len(model_rows), len(self.t_bb), 3))
        for j, c in enumerate(model_rows):
            rows = fitted[c]
            model = MultiOutputGBT(3, device=self.device, **self.gbt_kw,
                                   **self.sample_kw)
            model.fit(self.Xtrain[rows], Y[c, rows])
            out[j] = model.predict(self.Xtest)
        return self._postprocess_params(out)

    @staticmethod
    def _postprocess_params(params: np.ndarray) -> np.ndarray:
        """Alg 3 target transforms inverted: b back from log space,
        positivity clamps on a and c (mirrors ``predict_params``)."""
        params[:, :, 1] = np.exp(params[:, :, 1])
        params[:, :, 0] = np.maximum(params[:, :, 0], 0.0)
        params[:, :, 2] = np.maximum(params[:, :, 2], 0.0)
        return params

    def _nearest_fallback(self, theta_c, fitted_c, miss) -> np.ndarray:
        """Legacy no-ML path: nearest fitted (ii, oo) in log1p distance."""
        sel = np.nonzero(fitted_c)[0]
        if not len(sel):
            return np.zeros(int(miss.sum()))
        keys = self.gs.keys[sel]
        d = (np.abs(np.log1p(keys[:, 0])[None, :]
                    - np.log1p(self.t_ii[miss])[:, None])
             + np.abs(np.log1p(keys[:, 1])[None, :]
                      - np.log1p(self.t_oo[miss])[:, None]))
        th = theta_c[sel[d.argmin(axis=1)]]
        return th[:, 2] - th[:, 0] * np.exp(-th[:, 1] * self.t_bb[miss])

    def evaluate(self, subset: Subset) -> float:
        return float(self.evaluate_batch([subset])[0])


def _sample_initial(universes, rng, min_keep: int) -> Subset:
    out = {}
    for k, u in universes.items():
        k_n = max(min_keep, len(u) // 2)
        out[k] = frozenset(rng.choice(u, size=k_n, replace=False).tolist())
    return out


def anneal_batched(train, test, cfg: SAConfig,
                   initial: Optional[Subset] = None,
                   on_iter: Optional[Callable[[int, float], None]] = None,
                   evaluator: Optional[_BatchedEvaluator] = None,
                   device=None) -> SALog:
    """Alg 6 with K parallel chains sharing one evaluation cache.

    ``cfg.n_iters`` counts *per-chain* steps, so one run proposes
    ``n_chains * n_iters`` subsets.  Each iteration every chain proposes
    a move; proposals not in the cache are evaluated together in one
    ``_BatchedEvaluator.evaluate_batch`` call.  ``best`` is the global
    minimum over every evaluation (the serial engine reports its final
    chain state instead).  The returned ``SALog`` is drop-in for
    Alg 7/8.  Evaluations run on ``device`` (None: the GPU) unless an
    ``evaluator`` is given.
    """
    K = max(1, cfg.n_chains)
    rng = np.random.default_rng(cfg.seed)
    ev = evaluator or _BatchedEvaluator(train, test, cfg.gbt_kw,
                                        device=device)
    universes = ev.universes
    chain_rngs = [np.random.default_rng(cfg.seed + 7919 * (c + 1))
                  for c in range(K)]

    states: List[Subset] = []
    for c in range(K):
        if c == 0 and initial is not None:
            states.append(dict(initial))
        else:
            states.append(_sample_initial(universes,
                                          rng if c == 0 else chain_rngs[c],
                                          cfg.min_keep))
    full = {k: frozenset(u.tolist()) for k, u in universes.items()}

    cache: Dict[Tuple, float] = {}
    subsets: List[Subset] = []
    errors: List[float] = []

    def eval_all(cands: Sequence[Subset]) -> List[float]:
        fps = [subset_fingerprint(s) for s in cands]
        todo, order = [], {}
        for f, s in zip(fps, cands):
            if f not in cache and f not in order:
                order[f] = len(todo)
                todo.append(s)
        if todo:
            fresh = ev.evaluate_batch(todo)
            for f, i in order.items():
                cache[f] = float(fresh[i])
        out = [cache[f] for f in fps]
        if not cfg.use_cache:
            # keep only within-batch dedup; forget across iterations
            cache.clear()
        return out

    # chain initial states + the full-coverage anchor (Alg 8 calibration)
    e_states = eval_all(states)
    e_full = eval_all([full])[0]
    for s, e in zip(states, e_states):
        subsets.append(dict(s))
        errors.append(e)
    subsets.append(dict(full))
    errors.append(e_full)

    tau = cfg.temperature
    for it in range(cfg.n_iters):
        tau *= cfg.cooling
        cands = [_modify(states[c], universes, chain_rngs[c], cfg.min_keep)
                 for c in range(K)]
        e_cands = eval_all(cands)
        for c in range(K):
            accept = (e_cands[c] < e_states[c] or
                      chain_rngs[c].random() < np.exp(
                          (e_states[c] - e_cands[c]) / max(tau, 1e-9)))
            if accept:
                states[c], e_states[c] = cands[c], e_cands[c]
            subsets.append(dict(cands[c]))
            errors.append(e_cands[c])
        if on_iter is not None:
            on_iter(it, min(e_cands))

    best_i = int(np.argmin(errors))
    return SALog(subsets=subsets, errors=errors, universes=universes,
                 best_subset=dict(subsets[best_i]),
                 best_error=float(errors[best_i]))
