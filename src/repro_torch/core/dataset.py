"""Columnar benchmark dataset (DataFrame-lite; pandas unavailable offline).

Columns are numpy arrays of equal length.  Canonical workload columns are
``ii, oo, bb, thpt`` plus arbitrary configuration columns (model, acc,
acc_count, back, prec, mode, ...) used by the Alg 4 registry.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


class Dataset:
    def __init__(self, columns: Dict[str, np.ndarray]):
        n = {len(v) for v in columns.values()}
        assert len(n) <= 1, f"ragged columns: { {k: len(v) for k, v in columns.items()} }"
        self.cols = {k: np.asarray(v) for k, v in columns.items()}

    def __len__(self):
        return 0 if not self.cols else len(next(iter(self.cols.values())))

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.cols[key]
        return Dataset({k: v[key] for k, v in self.cols.items()})

    def filter(self, **conds) -> "Dataset":
        mask = np.ones(len(self), bool)
        for k, v in conds.items():
            mask &= (self.cols[k] == v)
        return self[mask]

    def mask(self, mask: np.ndarray) -> "Dataset":
        return self[mask]

    def concat(self, other: "Dataset") -> "Dataset":
        """Row-wise concatenation of two schema-compatible datasets.

        Both sides must carry exactly the same columns — a mismatch
        raises ``ValueError`` naming the offending columns instead of
        silently dropping data (columns only in ``other``) or dying in a
        bare ``KeyError`` (columns only in ``self``).  Dtype promotion
        is deterministic: if either side of a column is string-like
        (``U``/``S``/``O`` kinds) both sides are cast to ``str`` before
        concatenating; purely numeric columns follow numpy's standard
        promotion (e.g. int64 + float64 -> float64).
        """
        missing = sorted(set(self.cols) - set(other.cols))
        extra = sorted(set(other.cols) - set(self.cols))
        if missing or extra:
            parts = []
            if missing:
                parts.append(f"columns {missing} missing from other")
            if extra:
                parts.append(f"columns {extra} only in other")
            raise ValueError("concat schema mismatch: " + "; ".join(parts))
        out = {}
        for k, a in self.cols.items():
            b = other.cols[k]
            if (a.dtype.kind in "USO") != (b.dtype.kind in "USO"):
                a, b = a.astype(str), b.astype(str)
            out[k] = np.concatenate([a, b])
        return Dataset(out)

    def unique_combos(self, keys: Sequence[str]) -> List[Tuple]:
        arr = np.stack([self.cols[k].astype(str) for k in keys], axis=1)
        return [tuple(r) for r in np.unique(arr, axis=0)]

    @property
    def workload(self):
        return (self.cols["ii"].astype(np.float64),
                self.cols["oo"].astype(np.float64),
                self.cols["bb"].astype(np.float64),
                self.cols["thpt"].astype(np.float64))

    # -- persistence ---------------------------------------------------------
    def save(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        meta = {k: str(v.dtype) for k, v in self.cols.items()}
        np.savez_compressed(path.with_suffix(".npz"),
                            **{k: v for k, v in self.cols.items()})
        path.with_suffix(".meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path) -> "Dataset":
        path = pathlib.Path(path)
        data = np.load(path.with_suffix(".npz"), allow_pickle=False)
        return cls({k: data[k] for k in data.files})

    def to_csv(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        keys = list(self.cols)
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for i in range(len(self)):
                f.write(",".join(str(self.cols[k][i]) for k in keys) + "\n")

    @classmethod
    def from_rows(cls, rows: Iterable[Dict],
                  require_finite: Tuple[str, ...] = ("ii", "oo", "bb",
                                                     "thpt")) -> "Dataset":
        rows = list(rows)
        if not rows:
            raise ValueError("from_rows needs at least one row (the "
                             "column schema comes from the first row)")
        keys = list(rows[0].keys())
        keyset = set(keys)
        for i, r in enumerate(rows):
            rk = set(r.keys())
            if rk != keyset:
                missing = sorted(keyset - rk)
                extra = sorted(rk - keyset)
                parts = []
                if missing:
                    parts.append(f"missing keys {missing}")
                if extra:
                    parts.append(f"unexpected keys {extra}")
                raise ValueError(f"from_rows: row {i} does not match the "
                                 f"row-0 schema: " + ", ".join(parts))
        cols = {k: np.asarray([r[k] for r in rows]) for k in keys}
        # a single NaN/inf workload value silently poisons every fit the
        # dataset feeds — refuse them at the door (opt out with
        # require_finite=None when building deliberately-corrupted data)
        for k in (require_finite or ()):
            v = cols.get(k)
            if v is None or v.dtype.kind not in "fiu":
                continue
            bad = ~np.isfinite(v.astype(np.float64))
            if bad.any():
                first = int(np.nonzero(bad)[0][0])
                raise ValueError(
                    f"from_rows: column {k!r} has {int(bad.sum())} "
                    f"non-finite value(s) (first at row {first}); drop or "
                    f"repair these rows, or pass require_finite=None to "
                    f"build a deliberately-corrupted dataset")
        return cls(cols)
