"""The bf16 flash-attention forward's persistent walk, mirrored in Python
(``kernels/flash_attention/kernel.py``): ``min(items, SMs)`` blocks, each
taking the work items (128 query rows of one head of one sequence)
blockIdx.x, + blocks, ..., heaviest first; the K/V tiles an item's block
loads; and the block's shared memory.  ``test_torch_gpu.py`` holds the
shared-memory count to the built kernel's ``flash_attention_smem_bytes``
on a card."""
import pytest

from repro_torch.kernels.flash_attention.kernel import (
    KEYS, ROWS, fwd_smem_bytes, item_tiles, persistent_plan, ring_stages,
    work_items)

H100_SMS = 132
SMEM_LIMIT = 232_448  # a block's dynamic shared memory on the H100

# (B, Sq, H): a single item, about one per SM, the main path's prefills
# (llama3.1-8b's two cells, whisper's encoder and cross attention,
# internvl2's), qwen3-0.6b's training shape and ragged Sq
SHAPES = [(1, 64, 1), (1, 128, 132), (4, 128, 33), (8, 512, 32),
          (32, 128, 32), (16, 1500, 16), (16, 512, 16), (16, 768, 14),
          (4, 4096, 16), (2, 1, 8), (3, 129, 5), (2, 1000, 7)]


def _all_items(b, sq, h):
    return {(qt * ROWS, bb, hh) for qt in range(-(-sq // ROWS))
            for bb in range(b) for hh in range(h)}


@pytest.mark.parametrize("b,sq,h", SHAPES)
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_walk_visits_every_item_once(b, sq, h, sms):
    blocks, walks = persistent_plan(b, sq, h, sms)
    seen = [item for walk in walks for item in walk]
    assert len(walks) == blocks
    assert len(seen) == len(set(seen)) == len(work_items(b, sq, h))
    assert set(seen) == _all_items(b, sq, h)


@pytest.mark.parametrize("b,sq,h", SHAPES)
@pytest.mark.parametrize("sk_of", [lambda sq: sq, lambda sq: 2 * sq + 5,
                                   lambda sq: max(1, sq // 3)])
def test_walk_takes_the_heaviest_items_first(b, sq, h, sk_of):
    """Under the causal mask an item's K/V tiles never grow along the
    kernel's order, nor along any block's walk."""
    sk = sk_of(sq)
    weights = [item_tiles(q0, sk, True) for q0, _, _ in work_items(b, sq, h)]
    assert weights == sorted(weights, reverse=True)
    for walk in persistent_plan(b, sq, h, H100_SMS)[1]:
        w = [item_tiles(q0, sk, True) for q0, _, _ in walk]
        assert w == sorted(w, reverse=True)


@pytest.mark.parametrize("b,sq,h,blocks,most", [
    (1, 64, 1, 1, 1),         # fewer items than SMs
    (1, 128, 132, 132, 1),    # as many
    (4, 128, 33, 132, 1),
    (16, 1500, 16, 132, 24),  # whisper's encoder: 3,072 items, 23.3 a block
    (4, 4096, 16, 132, 16),   # qwen3-0.6b's training shape: 2,048
    (8, 512, 32, 132, 8)])    # llama3.1-8b B 8, S 512: 1,024
def test_block_count_and_walk_lengths(b, sq, h, blocks, most):
    n, walks = persistent_plan(b, sq, h, H100_SMS)
    assert n == blocks == min(len(work_items(b, sq, h)), H100_SMS)
    lengths = [len(w) for w in walks]
    assert max(lengths) == most and max(lengths) - min(lengths) <= 1


@pytest.mark.parametrize("sq,sk", [(1500, 1500), (512, 1500), (300, 65),
                                   (64, 63), (1, 70), (4096, 4096)])
@pytest.mark.parametrize("causal", [True, False])
def test_item_tiles_hold_every_key_its_rows_see(sq, sk, causal):
    """An item's tiles cover every key any of its rows attends to, and
    under the causal mask its last tile holds a key its last row sees."""
    for q0, _, _ in work_items(1, sq, 1):
        n = item_tiles(q0, sk, causal)
        last_row = q0 + ROWS - 1
        need = min(sk, last_row + 1) if causal else sk
        assert n * KEYS >= need and (n - 1) * KEYS < need
        if causal:
            assert (n - 1) * KEYS <= last_row


@pytest.mark.parametrize("dh,stages,want", [
    (16, 8, 42_192), (32, 8, 83_152), (64, 8, 165_072), (128, 5, 230_536)])
def test_shared_memory_as_the_mirror_counts_it(dh, stages, want):
    """Q and O's staging rows (128 each), a ring of K and V tiles of 64
    keys as deep as an H100 block's shared memory holds (at most 8), its
    mbarriers and the alignment slack."""
    tile = KEYS * dh * 2
    assert ring_stages(dh) == stages
    assert fwd_smem_bytes(dh) == want == (
        1024 + 2 * ROWS * dh * 2 + 2 * stages * tile + (3 * stages + 2) * 8)
    assert want <= SMEM_LIMIT < want + 2 * tile + 24 or stages == 8
