"""Model configuration, layers, attention and the dense transformer."""
