"""The paper's benchmark datasets (§III-A), read from the cache in the repo.

``results/data/{inhouse,suite,mismatch}.npz`` hold the rows the reference
package simulated: ``inhouse`` is the ~4,800-point (ii, oo, bb) grid of
LLaMA-3.1-8B, ``suite`` the many-model sweep, ``mismatch`` a model on a
different accelerator profile.  The port reads them as they are.  Making
them anew needs the roofline simulator (``perfmodel/simulator.py``), which
is not ported yet (ROADMAP item 15): without the cache the loaders raise.
"""
from __future__ import annotations

import pathlib

import numpy as np

from repro_torch.core.dataset import Dataset

DATA_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / "data"
NAMES = ("inhouse", "suite", "mismatch")


def load_or_make(name: str, **kw) -> Dataset:
    """The cached dataset ``name``; raises where it would have to be
    simulated (no cache, or generator arguments other than the cache's)."""
    if name not in NAMES:
        raise KeyError(f"unknown dataset {name!r}; known: {list(NAMES)}")
    path = DATA_DIR / name
    if kw or not path.with_suffix(".npz").exists():
        why = (f"arguments {sorted(kw)}" if kw
               else f"no cache at {path.with_suffix('.npz')}")
        raise FileNotFoundError(
            f"dataset {name!r} needs the roofline simulator ({why}); "
            f"perfmodel/simulator.py is not ported yet (ROADMAP item 15)")
    return Dataset.load(path)


def make_inhouse_dataset(seed: int = 0, reps: int = 10) -> Dataset:
    """The in-house grid as the reference makes it with its defaults,
    which is what the cache holds; other seeds or reps would need the
    simulator and raise."""
    kw = {} if (seed, reps) == (0, 10) else dict(seed=seed, reps=reps)
    return load_or_make("inhouse", **kw)


def train_test_split(ds: Dataset, test_frac: float = 0.3, seed: int = 0):
    rng = np.random.default_rng(seed)
    mask = rng.random(len(ds)) < test_frac
    return ds[~mask], ds[mask]
