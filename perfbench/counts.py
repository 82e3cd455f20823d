"""Operations and bytes of the benchmark's cells, worked out from a
configuration file's sizes alone.

These are frozen copies of the port's formulas, kept with the benchmark so
that a change to the program cannot move the yardstick: the FLOP formulas
of K2 and K3 (``kernels/flash_attention/ops.py::flash_attention_flops``,
``causal_pairs``; ``kernels/decode_attention/ops.py::
decode_attention_flops``) and the decode step's bytes
(``chip_smoke.py::_step_bytes``).  Nothing here reads the program.
"""
from __future__ import annotations

import dataclasses

BF16 = 2   # bytes of a matrix, a bias, a K/V entry or an activation
FP32 = 4   # bytes of a norm scale, as the port holds them


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A decoder's sizes, read from a configuration file (published keys,
    with the port's own settings under ``port``)."""

    layers: int
    d: int
    heads: int
    kv: int
    dh: int
    ff: int
    vocab: int
    padded_vocab: int
    experts: int
    top_k: int
    qkv_bias: bool
    tied: bool

    @classmethod
    def of(cls, conf: dict) -> "Sizes":
        port = conf["port"]
        pad = port["vocab_pad_multiple"]
        vocab = conf["vocab_size"]
        return cls(layers=conf["num_hidden_layers"], d=conf["hidden_size"],
                   heads=conf["num_attention_heads"],
                   kv=conf["num_key_value_heads"], dh=port["head_dim"],
                   ff=conf["intermediate_size"], vocab=vocab,
                   padded_vocab=-(-vocab // pad) * pad,
                   experts=conf.get("num_local_experts", 0),
                   top_k=conf.get("num_experts_per_tok", 0),
                   qkv_bias=port["qkv_bias"],
                   tied=conf["tie_word_embeddings"])

    @property
    def moe(self) -> bool:
        return self.experts > 0


def attn_params(s: Sizes) -> int:
    """The q, k, v and output projections of one layer."""
    return 2 * s.d * s.heads * s.dh + 2 * s.d * s.kv * s.dh


def ffn_params(s: Sizes, active: bool) -> int:
    """One layer's FFN matrices: SwiGLU's three, or the router and the
    experts' three each (the top-k a token uses with ``active``, every
    expert without)."""
    if not s.moe:
        return 3 * s.d * s.ff
    n = s.top_k if active else s.experts
    return n * 3 * s.d * s.ff + s.d * s.experts


def layer_matmul_params(s: Sizes, active: bool = True) -> int:
    return attn_params(s) + ffn_params(s, active)


def total_params(s: Sizes) -> int:
    """Every parameter the served model holds: the embedding table and the
    head (one matrix when tied), each layer's matrices, biases and two
    norm scales, and the final norm."""
    emb = s.padded_vocab * s.d * (1 if s.tied else 2)
    bias = (s.heads + 2 * s.kv) * s.dh if s.qkv_bias else 0
    per_layer = layer_matmul_params(s, active=False) + bias + 2 * s.d
    return emb + s.layers * per_layer + s.d


def active_params_per_token(s: Sizes) -> int:
    """Matrix parameters one token's forward multiplies by: every layer's
    (experts at top-k) and the head over the real vocabulary."""
    return s.layers * layer_matmul_params(s) + s.d * s.vocab


# -- K2 and K3: frozen copies of the kernels' FLOP formulas ------------------

def causal_pairs(s: int, sk: int) -> int:
    """(query row, key) pairs the top-left causal mask keeps: row i sees
    keys 0..min(i, Sk - 1)."""
    if sk >= s:
        return s * (s + 1) // 2
    return sk * (sk + 1) // 2 + (s - sk) * sk


def flash_attention_flops(b: int, s: int, sk: int, h: int, dh: int,
                          causal: bool) -> int:
    """K2's forward: Q K^T and P V over the kept pairs, 2 Dh each, for every
    one of the B x H query heads."""
    pairs = causal_pairs(s, sk) if causal else s * sk
    return 4 * b * h * dh * pairs


def decode_attention_flops(b: int, h: int, dh: int, keys: int) -> int:
    """K3: one query row of each of the B x H heads against ``keys`` cache
    positions, q K^T and P V, 2 Dh a key each."""
    return 4 * b * h * dh * keys


def flash_attention_bytes(s: Sizes, b: int, n: int) -> int:
    """K2's least traffic for one layer's prompt of ``b`` x ``n``: Q, K and V
    read once, the output written once."""
    return BF16 * (2 * b * n * s.heads * s.dh + 2 * b * n * s.kv * s.dh)


def decode_attention_bytes(s: Sizes, b: int, keys: int) -> int:
    """K3's least traffic for one layer's step: K and V up to ``keys``
    positions read, q read and the output written."""
    return BF16 * (2 * b * keys * s.kv * s.dh + 2 * b * s.heads * s.dh)


# -- whole forwards ----------------------------------------------------------

def prefill_flops(s: Sizes, b: int, n: int) -> int:
    """A prefill of ``b`` prompts of ``n`` tokens: 2 x the active matrix
    parameters of the layers a token, the head on the last token of each
    prompt (the prefill's logits are those alone), and causal attention."""
    return (2 * s.layers * layer_matmul_params(s) * b * n
            + 2 * s.d * s.vocab * b
            + s.layers * flash_attention_flops(b, n, n, s.heads, s.dh, True))


def decode_step_flops(s: Sizes, b: int, keys: int) -> int:
    """One decode step of ``b`` sequences whose attention reads ``keys``
    positions: 2 x the active parameters a token, and K3's FLOPs."""
    return (2 * active_params_per_token(s) * b
            + s.layers * decode_attention_flops(b, s.heads, s.dh, keys))


def weight_bytes(s: Sizes) -> int:
    """The weights a decode step reads at least, as ``_step_bytes`` counts
    them: every parameter the model holds but the embedding table when
    the head is untied (a step gathers only its rows), every expert (at
    these batches every expert is routed to), the norms in float32."""
    table = 0 if s.tied else s.padded_vocab * s.d
    scales = (2 * s.layers + 1) * s.d
    return BF16 * (total_params(s) - table - scales) + FP32 * scales


def kv_bytes(s: Sizes, b: int, keys: int) -> int:
    """The K/V of every layer up to ``keys`` positions of ``b`` sequences."""
    return s.layers * 2 * b * keys * s.kv * s.dh * BF16


def decode_step_bytes(s: Sizes, b: int, keys: int) -> int:
    return weight_bytes(s) + kv_bytes(s, b, keys)


def least_s(flops: float, nbytes: float, peak_flops: float,
            peak_bytes: float) -> float:
    """The least time the chip could take: operations over the peak rate or
    bytes over the memory's, whichever is longer."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def step_keys(ii: int, oo: int):
    """The key counts of a request's ``oo - 1`` decode steps: the step at
    position p (ii .. ii + oo - 2) reads p + 1 positions."""
    return range(ii + 1, ii + oo)
