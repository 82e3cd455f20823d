"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, one request
that the window finished is drawn from the seed among the longest, and the
plain reference (``reference/decoder.py``) runs once over each of its
prompts followed by its served tokens.  Two numbers are compared:

* ``max_logit_gap``: at every served position, the gap by which the served
  token's reference logit lies below the reference's best logit there; the
  widest over every served token of the request.  Greedy decoding serves
  the program's best token, so a sound program's gap is its rounding; a
  served token that is wrong, or computed from a wrong cache, lies far
  below.
* ``logit_rel_err``: the logits that the timed path leaves (the prefill's
  at the prompt's last position, and the last decode step's) against the
  reference's at those positions: the widest over those rows of the norm of
  their difference over the norm of the reference's row.  It reads the
  precision the program computes in, where the gap reads only a near-tie
  that flips.

With ``controls`` the same numbers are read of each control of
``CONTROLS``, the reference computed in fp8 and put in the program's place:
at each of the same positions the gap of the token that the control puts
first, and the control's logits at the rows the program leaves.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from perfbench.reference import decoder

NUMBERS = ("max_logit_gap", "logit_rel_err")
CONTROLS = {"fp8": decoder.Fp8(), "fp8_products": decoder.Fp8Products()}
LOGIT_BYTES = 1 << 30   # float32 logits held at a time


def pick(records, rng):
    """The request the check compares: drawn by ``rng`` among the longest
    the window finished."""
    longest = max(r["ii"] + r["oo"] for r in records)
    cands = [r for r in records if r["ii"] + r["oo"] == longest]
    return cands[int(rng.integers(len(cands)))]


def _blocks(hid, head_w, prec):
    """(first row, logits) of the rows ``hid`` (N, D), a block at a time."""
    rows = max(1, LOGIT_BYTES // (4 * head_w.shape[1]))
    for i in range(0, hid.shape[0], rows):
        yield i, decoder.logits(hid[i:i + rows], head_w, prec)


def _widest_gap(hid, head_w, chosen) -> float:
    """The widest gap of the tokens ``chosen`` (N,) below the reference's
    best logit at the rows ``hid`` (N, D)."""
    gap = 0.0
    for i, ref in _blocks(hid, head_w, decoder.FLOAT32):
        got = ref.gather(1, chosen[i:i + ref.shape[0], None])[:, 0]
        gap = max(gap, float((ref.max(-1).values - got).max()))
    return gap


def _rel_err(got, ref) -> float:
    """The widest relative error of the rows ``got`` against ``ref``."""
    return float(((got.float() - ref).norm(dim=-1)
                  / ref.norm(dim=-1)).max())


def readings(conf: dict, weights: dict, prompts: np.ndarray,
             served: np.ndarray, held: Optional[torch.Tensor], device,
             controls: bool = False) -> Dict[str, Dict[str, float]]:
    """{'program': {number: value}} and, with ``controls``, the same for each
    control.  ``held``: the program's logits (B, rows, vocab) at the
    prompt's last position and at the last decode step.  A served token
    outside the vocabulary, or held logits of another shape, read as an
    infinite number."""
    vocab, d = conf["vocab_size"], conf["hidden_size"]
    bb, ii = prompts.shape
    oo = served.shape[1]
    seqs = np.concatenate([prompts, served[:, :-1]], axis=1)
    tokens = torch.as_tensor(seqs, dtype=torch.int64, device=device)
    served_t = torch.as_tensor(np.clip(served, 0, vocab - 1),
                               dtype=torch.int64, device=device).reshape(-1)
    at = [0, oo - 1] if oo > 1 else [0]
    hid = decoder.final_hidden(conf, weights, tokens, ii)    # (B, oo, D)
    head = decoder.head(conf, weights)
    ref_at = decoder.logits(hid[:, at].reshape(-1, d), head)
    gap = _widest_gap(hid.reshape(-1, d), head, served_t)
    if held is None or tuple(held.shape) != (bb, len(at), vocab):
        rel = float("inf")
    else:
        rel = _rel_err(held.to(device).reshape(-1, vocab), ref_at)
    bad = bool(((served < 0) | (served >= vocab)).any())
    out = {"program": {"max_logit_gap": float("inf") if bad else gap,
                       "logit_rel_err": rel}}
    for name, prec in (CONTROLS.items() if controls else ()):
        ctl = decoder.final_hidden(conf, weights, tokens, ii, prec)
        ctl_head = decoder.head(conf, weights, prec)
        first = torch.cat([lg.argmax(-1) for _, lg in
                           _blocks(ctl.reshape(-1, d), ctl_head, prec)])
        ctl_at = decoder.logits(ctl[:, at].reshape(-1, d), ctl_head, prec)
        out[name] = {"max_logit_gap": _widest_gap(hid.reshape(-1, d), head,
                                                  first),
                     "logit_rel_err": _rel_err(ctl_at, ref_at)}
        del ctl, ctl_head
    return out


def within(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number compared is at most its limit: the one
    predicate that judges the program and each control."""
    return all(numbers[n] <= limits[n] for n in NUMBERS)


def compare(conf: dict, weights: dict, records, rng, device,
            controls: bool = False) -> Optional[dict]:
    """The readings of the request ``pick`` draws (None without one)."""
    if not records:
        return None
    req = pick(records, rng)
    return readings(conf, weights, req["prompts"], req["tokens"],
                    req["logits"], device, controls)
