"""Shared smoke-shape helper used by per-arch smoke tests."""
from repro_torch.configs.shapes import ShapeSpec

SMOKE_TRAIN = ShapeSpec("smoke_train", seq_len=32, global_batch=2,
                        kind="train")
SMOKE_PREFILL = ShapeSpec("smoke_prefill", seq_len=32, global_batch=2,
                          kind="prefill")
SMOKE_DECODE = ShapeSpec("smoke_decode", seq_len=32, global_batch=2,
                         kind="decode")
