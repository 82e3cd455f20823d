"""Token sampling: greedy / temperature / top-k."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0,
           vocab_size: Optional[int] = None):
    """logits: (B, 1, V) -> tokens (B, 1) int64.

    Greedy (``temperature <= 0``) takes the first maximum, as
    ``jnp.argmax`` does.  A random draw needs an explicit ``generator`` on
    the logits' device."""
    logits = logits[:, -1, :].float()
    if vocab_size is not None:
        # mask vocab padding
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, float("-inf"))
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)[:, None]
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)
