"""Meshes and the sharded steps (``mesh``, ``steps``): the reference's
``launch/`` on ``torch.distributed``."""
