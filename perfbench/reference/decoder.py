"""The plain reference of the benchmark's decoders: attention (GQA, RoPE,
optional q/k/v bias) with a dense SwiGLU FFN or routed experts, in float32
with TF32 off, layer by layer, in plain PyTorch.

It reads only a configuration file's sizes and a dict of weights named as
the benchmark draws them (``blocks.<layer>.0.attn.wq`` and so on), and runs
whole sequences at once, teacher forced: it keeps no cache and imports
nothing of the program.  The equations are the port's model as its
configuration file states it:

* RMSNorm before attention and before the FFN, and a final one:
  ``x * rsqrt(mean(x^2) + eps) * scale``;
* q, k, v projections (plus bias), RoPE over split halves at
  ``rope_theta``, causal softmax attention at 1 / sqrt(head_dim), query
  head h reading K/V head h // (heads / kv_heads), the output projection;
* SwiGLU ``(silu(x Wg) * (x Wu)) Wd``; or, for experts, the router's
  softmax, the top k (ties to the lower index) renormalised to sum to 1,
  and the sorted capacity dispatch: within each routing group, entries
  taken in token order, k choices a token, and those past an expert's
  ``max(8, ceil8(int(capacity_factor * k * n / experts)))`` slots dropped.
  A prefill routes its whole batch of prompts as one group; each decode
  step routes its batch's tokens at one position as one.

The controls that the check has to fail, not second references, compute
the same in float8 (e4m3): ``Fp8Products`` at the inputs of every product
(every weight with a scale an output column, every activation with a scale
a row, q, k and v with a scale a head's row, so the K/V cache too), the
step that would move the program's GEMMs and cache to fp8; ``Fp8`` besides
at each point where the program holds a bf16 tensor: the embedding's rows,
each norm's and product's output, the residual stream after each add, and
the logits.  Norms, softmax and accumulation stay in float32, as in the
program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
ROWS = 4096          # rows of a linear layer computed at a time
SCORE_BYTES = 1 << 30  # float32 attention scores held at a time


class Float32:
    def weight(self, w):
        return w.float()

    def inp(self, x):        # the input of a product
        return x

    def held(self, x):       # a tensor the program holds between products
        return x


def _fp8(x, dim):
    """x rounded to float8 e4m3 with one scale along ``dim``."""
    x = x.float()
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Fp8Products(Float32):
    def weight(self, w):     # (..., in, out): a scale an output column
        return _fp8(w, -2)

    def inp(self, x):        # (..., features): a scale a row
        return _fp8(x, -1)


class Fp8(Fp8Products):
    def held(self, x):
        return _fp8(x, -1)


FLOAT32 = Float32()


class Sizes:
    def __init__(self, conf: dict):
        port = conf["port"]
        self.layers = conf["num_hidden_layers"]
        self.d = conf["hidden_size"]
        self.heads = conf["num_attention_heads"]
        self.kv = conf["num_key_value_heads"]
        self.dh = port["head_dim"]
        self.vocab = conf["vocab_size"]
        self.eps = conf["rms_norm_eps"]
        self.theta = conf["rope_theta"]
        self.experts = conf.get("num_local_experts", 0)
        self.top_k = conf.get("num_experts_per_tok", 0)
        self.capacity_factor = port.get("capacity_factor", 0.0)
        self.tied = conf["tie_word_embeddings"]
        self.ffn = port["ffn"]


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()


def _linear(x, w, prec, bias=None):
    """x (N, in) times w (in, out) in row blocks; w as the precision holds
    it, computed once."""
    wq = prec.weight(w)
    out = torch.empty((x.shape[0], wq.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(0, x.shape[0], ROWS):
        out[i:i + ROWS] = prec.inp(x[i:i + ROWS]) @ wq
    if bias is not None:
        out += bias.float().reshape(-1)
    return prec.held(out)


def _rope_tables(n: int, dh: int, theta: float, device):
    """cos and sin (n, dh / 2) of the split-halves RoPE, the angles taken
    in float64."""
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                       device=device) / dh)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rope(x, cos, sin):
    """x (B, T, heads, Dh)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(sz: Sizes, w, pre: str, x, cos, sin, prec):
    b, t, d = x.shape
    xf = x.reshape(b * t, d)

    def proj(name, heads):
        bias = w.get(f"{pre}attn.b{name}")
        y = _linear(xf, w[f"{pre}attn.w{name}"].reshape(d, -1), prec, bias)
        return y.view(b, t, heads, sz.dh)

    q = prec.inp(prec.held(_rope(proj("q", sz.heads), cos, sin)))
    k = prec.inp(prec.held(_rope(proj("k", sz.kv), cos, sin)))
    v = prec.inp(proj("v", sz.kv))
    g = sz.heads // sz.kv
    scale = 1.0 / math.sqrt(sz.dh)
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    out = torch.empty((b, t, sz.heads, sz.dh), dtype=torch.float32,
                      device=x.device)
    rows = max(1, SCORE_BYTES // (4 * sz.heads * t * t))
    for i in range(0, b, rows):
        # (b, kv, g, t, dh) against (b, kv, t, dh)
        qi = q[i:i + rows].permute(0, 2, 1, 3).reshape(-1, sz.kv, g, t, sz.dh)
        ki = k[i:i + rows].permute(0, 2, 1, 3)[:, :, None]
        vi = v[i:i + rows].permute(0, 2, 1, 3)[:, :, None]
        s = (qi @ ki.transpose(-1, -2)) * scale
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o = p @ vi                                   # (b, kv, g, t, dh)
        out[i:i + rows] = o.reshape(-1, sz.heads, t, sz.dh).permute(0, 2, 1, 3)
    wo = w[f"{pre}attn.wo"].reshape(sz.heads * sz.dh, d)
    return _linear(prec.held(out).reshape(b * t, -1), wo, prec).view(b, t, d)


def _swiglu(x, wg, wu, wd, prec):
    return _linear(prec.held(F.silu(_linear(x, wg, prec))
                             * _linear(x, wu, prec)), wd, prec)


def capacity(sz: Sizes, n_tokens: int) -> int:
    """An expert's slots for a routing group of ``n_tokens`` tokens."""
    cap = int(sz.capacity_factor * sz.top_k * n_tokens / sz.experts)
    return max(8, ((cap + 7) // 8) * 8)


def route(sz: Sizes, x, router, prec):
    """(gate values (N, k), expert ids (N, k)) of the tokens x (N, D)."""
    probs = torch.softmax(_linear(x, router, prec), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :sz.top_k], idx[:, :sz.top_k]
    if sz.top_k > 1:
        vals = vals / vals.sum(-1, keepdim=True)
    return vals, idx


def dispatch(sz: Sizes, idx, group):
    """Which of the (N * k) entries (token-major, k-minor) keep a slot:
    within each routing group, an entry's rank is the count of earlier
    entries of its group sent to its expert, and it is kept while that is
    under the group's capacity.  ``group``: (N,) each token's group."""
    n, k = idx.shape
    token = torch.arange(n, device=idx.device).repeat_interleave(k)
    expert = idx.reshape(-1)
    key = group[token] * sz.experts + expert
    order = torch.argsort(key, stable=True)
    sk = key[order]
    rank = torch.empty_like(order)
    rank[order] = (torch.arange(n * k, device=idx.device)
                   - torch.searchsorted(sk, sk))
    sizes = torch.bincount(group)
    caps = torch.tensor([capacity(sz, int(c)) for c in sizes.tolist()],
                        device=idx.device)
    return token, expert, rank < caps[group[token]]


def _moe(sz: Sizes, w, pre: str, x, n_prompt: int, prec):
    b, t, d = x.shape
    xt = x.reshape(b * t, d)
    vals, idx = route(sz, xt, w[f"{pre}moe.router"], prec)
    pos = torch.arange(b * t, device=x.device) % t
    group = torch.where(pos < n_prompt, 0, pos - n_prompt + 1)
    token, expert, keep = dispatch(sz, idx, group)
    gate = vals.reshape(-1)
    out = torch.zeros_like(xt)
    for e in range(sz.experts):
        sel = keep & (expert == e)
        tok = token[sel]
        y = _swiglu(xt[tok], w[f"{pre}moe.experts.w_gate"][e],
                    w[f"{pre}moe.experts.w_up"][e],
                    w[f"{pre}moe.experts.w_down"][e], prec)
        out.index_add_(0, tok, y * gate[sel][:, None])
    return prec.held(out).view(b, t, d)


def _dense(w, pre: str, x, prec):
    b, t, d = x.shape
    return _swiglu(x.reshape(b * t, d), w[f"{pre}mlp.w_gate"],
                   w[f"{pre}mlp.w_up"], w[f"{pre}mlp.w_down"],
                   prec).view(b, t, d)


def final_hidden(conf: dict, w: dict, tokens, n_prompt: int,
                 prec: Float32 = FLOAT32):
    """The final norm's output at positions n_prompt - 1 .. T - 1 of the
    sequences ``tokens`` (B, T): (B, T - n_prompt + 1, D) float32, the rows
    whose logits choose the served tokens."""
    sz = Sizes(conf)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            b, t = tokens.shape
            cos, sin = _rope_tables(t, sz.dh, sz.theta, tokens.device)
            h = prec.held(w["embed.tok_embed"][tokens].float())
            for layer in range(sz.layers):
                pre = f"blocks.{layer}.0."
                x = prec.held(_rmsnorm(h, w[f"{pre}norm1.scale"], sz.eps))
                h = prec.held(h + _attention(sz, w, pre, x, cos, sin, prec))
                x = prec.held(_rmsnorm(h, w[f"{pre}norm2.scale"], sz.eps))
                h = prec.held(h + (_moe(sz, w, pre, x, n_prompt, prec)
                                  if sz.ffn == "moe"
                                  else _dense(w, pre, x, prec)))
                del x
            return prec.held(_rmsnorm(h[:, n_prompt - 1:],
                                     w["final_norm.scale"], sz.eps))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def head(conf: dict, w: dict, prec: Float32 = FLOAT32):
    """The head (D, vocab) over the real vocabulary, as ``prec`` holds it."""
    sz = Sizes(conf)
    m = (w["embed.tok_embed"].T if sz.tied else w["embed.lm_head"])
    return prec.weight(m[:, :sz.vocab])


def logits(rows, head_w, prec: Float32 = FLOAT32):
    """Logits (N, vocab) of final-norm rows (N, D), TF32 off."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return prec.held(prec.inp(rows) @ head_w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
