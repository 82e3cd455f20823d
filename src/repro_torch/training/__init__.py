"""Training: AdamW, checkpoints, gradient compression, straggler
accounting and the trainer."""
