"""Hopper kernels of the port (``csrc/``), their wrappers (:mod:`.ops`)
and their plain PyTorch versions (:mod:`.ref`)."""
