"""Atomic checkpoints in the reference's format and logical layout."""
