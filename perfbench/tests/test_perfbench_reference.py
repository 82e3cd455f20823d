"""The plain reference (``perfbench/reference/decoder.py``) against the
port's forward at smoke size on the CPU, both in float32 on the same drawn
weights: a prefill of the prompts, then one decode step a served token
through the cache, against the reference's one pass over the whole
sequences.  With experts, also where the capacity drops entries, in the
prefill's group and in the decode steps' (capacity factor 0.5 at a batch
of 20: about 120 entries an expert against 64 slots in the prompt, 10
against 8 in a step)."""
import numpy as np
import pytest
import torch

from _perfbench_cells import smoke_conf
from perfbench import harness
from perfbench.reference import decoder

TOL = 1e-4   # float32 through two layers: sums in another order only


def _cases():
    return {
        "dense": (smoke_conf("qwen2.5-32b", "float32"), 3),
        "moe": (smoke_conf("phi3.5-moe-l24", "float32"), 3),
        "moe_drops": (smoke_conf("phi3.5-moe-l24", "float32"), 20),
    }


def _port_logits(model, prompts, served):
    """The port's logits at every served position: the prefill's last
    position, then a decode step a served token."""
    ii, oo = prompts.shape[1], served.shape[1]
    logits, cache = model.prefill(prompts, ii + oo)
    out = [logits[:, -1]]
    for j in range(oo - 1):
        logits, cache = model.decode_step(cache, served[:, j:j + 1])
        out.append(logits[:, -1])
    return torch.stack(out, 1)[..., :model.cfg.vocab_size].float()


def _ref_logits(conf, weights, prompts, served):
    seqs = torch.cat([prompts, served[:, :-1]], 1)
    hid = decoder.final_hidden(conf, weights, seqs, prompts.shape[1])
    return decoder.logits(hid, decoder.head(conf, weights))


@pytest.mark.parametrize("case", ["dense", "moe", "moe_drops"])
def test_reference_matches_the_port_forward(case):
    conf, bb = _cases()[case]
    if case == "moe_drops":
        conf["port"]["capacity_factor"] = 0.5
    model, weights, _ = harness.build(conf, 7, "cpu")
    rng = np.random.default_rng(3)
    prompts = torch.as_tensor(rng.integers(0, 256, (bb, 12)))
    served = torch.as_tensor(rng.integers(0, 256, (bb, 6)))
    got = _port_logits(model, prompts, served)
    want = _ref_logits(conf, weights, prompts, served)
    assert got.shape == want.shape == (bb, 6, 256)
    assert (got - want).abs().max().item() < TOL
    if case == "moe_drops":
        # the drops change the result: without them the reference differs
        conf["port"]["capacity_factor"] = 100.0
        free = _ref_logits(conf, weights, prompts, served)
        assert (free - want).abs().max().item() > 100 * TOL


def test_dispatch_ranks_entries_within_each_group():
    """Two groups, 2 experts, top-1, capacity 8: the first 8 entries of
    each group sent to expert 0 keep their slots, the rest drop."""
    sz = decoder.Sizes(smoke_conf("phi3.5-moe-l24"))
    sz.experts, sz.top_k, sz.capacity_factor = 2, 1, 1.0
    idx = torch.zeros((20, 1), dtype=torch.int64)
    group = torch.tensor([0] * 10 + [1] * 10)
    token, expert, keep = decoder.dispatch(sz, idx, group)
    assert keep.tolist() == [True] * 8 + [False] * 2 + [True] * 8 + \
        [False] * 2
    assert decoder.capacity(sz, 10) == 8
    sz.experts, sz.top_k, sz.capacity_factor = 16, 2, 1.25
    # phi3.5-moe-l24.prefill: 1.25 x 2 x 32768 / 16 slots an expert
    assert decoder.capacity(sz, 32768) == 5120
