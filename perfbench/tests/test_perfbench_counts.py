"""The frozen counts against values worked out by hand from the two
configurations' published sizes."""
import json
from pathlib import Path

from perfbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
Q = counts.Sizes.of(json.loads((CONFIGS / "qwen2.5-32b.json").read_text()))
P = counts.Sizes.of(json.loads((CONFIGS / "phi3.5-moe-l24.json")
                               .read_text()))

# one layer's matrices: q and o 5120 x 5120, k and v 5120 x 1024, SwiGLU
# 3 x 5120 x 27648 (qwen2.5-32b); q and o 4096 x 4096, k and v 4096 x 1024,
# the router 4096 x 16, 16 experts of 3 x 4096 x 6400 (phi3.5-moe)
Q_LAYER = 2 * 5120 * 5120 + 2 * 5120 * 1024 + 3 * 5120 * 27648
P_ATTN = 2 * 4096 * 4096 + 2 * 4096 * 1024
P_EXPERT = 3 * 4096 * 6400


def test_qwen_holds_32_76_billion_parameters():
    # two 152064 x 5120 tables, 64 layers of matrices, q/k/v biases
    # (40 + 16) x 128 and two norms, the final norm
    per_layer = Q_LAYER + 56 * 128 + 2 * 5120
    assert Q_LAYER == 487_587_840
    assert counts.total_params(Q) == (2 * 152064 * 5120 + 64 * per_layer
                                      + 5120) == 32_763_876_352


def test_phi_l24_multiplies_4_9_billion_parameters_a_token():
    # 24 layers of attention, the router and 2 of 16 experts, and the head
    # over the 32064 real columns
    active = 24 * (P_ATTN + 4096 * 16 + 2 * P_EXPERT) + 4096 * 32064
    assert counts.active_params_per_token(P) == active == 4_914_413_568


def test_phi_l24_holds_31_47_billion_parameters():
    # the vocabulary padded to 32256 (a multiple of 256), no biases
    per_layer = P_ATTN + 4096 * 16 + 16 * P_EXPERT + 2 * 4096
    assert counts.total_params(P) == (2 * 32256 * 4096 + 24 * per_layer
                                      + 4096) == 31_471_636_480


def test_decode_weight_bytes_leave_out_the_embedding_table():
    # bf16 matrices and biases, float32 norm scales (2 a layer and the
    # final one), the untied table not read
    scales = 129 * 5120
    want = 2 * (32_763_876_352 - 152064 * 5120 - scales) + 4 * scales
    assert counts.weight_bytes(Q) == want == 63_971_938_304


def test_prefill_flops_of_qwen_at_8_x_2048():
    pairs = 2048 * 2049 // 2
    assert counts.prefill_flops(Q, 8, 2048) == (
        2 * 64 * Q_LAYER * 8 * 2048 + 2 * 5120 * 152064 * 8
        + 64 * 4 * 8 * 40 * 128 * pairs)


def test_prefill_flops_count_experts_at_top_k():
    pairs = 2048 * 2049 // 2
    per_token = P_ATTN + 4096 * 16 + 2 * P_EXPERT
    assert counts.prefill_flops(P, 16, 2048) == (
        2 * 24 * per_token * 16 * 2048 + 2 * 4096 * 32064 * 16
        + 24 * 4 * 16 * 32 * 128 * pairs)


def test_decode_step_of_qwen_at_32_sequences_and_384_keys():
    kv = 64 * 2 * 32 * 384 * 8 * 128 * 2
    assert counts.decode_step_bytes(Q, 32, 384) == 63_971_938_304 + kv
    assert counts.decode_step_flops(Q, 32, 384) == (
        2 * (64 * Q_LAYER + 5120 * 152064) * 32 + 64 * 4 * 32 * 40 * 128
        * 384)


def test_kernel_counts():
    assert counts.causal_pairs(3, 3) == 6
    assert counts.causal_pairs(4, 2) == 3 + 2 * 2
    assert counts.flash_attention_flops(1, 3, 3, 1, 2, True) == 4 * 2 * 6
    assert counts.decode_attention_flops(2, 3, 4, 5) == 4 * 2 * 3 * 4 * 5
    # q, k, v read and the output written once, bf16
    assert counts.flash_attention_bytes(Q, 8, 2048) == 2 * (
        2 * 8 * 2048 * 40 * 128 + 2 * 8 * 2048 * 8 * 128)
    assert counts.decode_attention_bytes(Q, 32, 384) == 2 * (
        2 * 32 * 384 * 8 * 128 + 2 * 32 * 40 * 128)


def test_a_request_steps_from_ii_plus_one_keys():
    keys = list(counts.step_keys(256, 256))
    assert len(keys) == 255 and keys[0] == 257 and keys[-1] == 511


def test_least_time_takes_the_longer_bound():
    assert counts.least_s(989e12, 0, 989e12, 3.35e12) == 1.0
    assert counts.least_s(0, 6.7e12, 989e12, 3.35e12) == 2.0
