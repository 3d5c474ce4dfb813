"""Atomic, asynchronous, integrity-checked checkpoints in the JAX package's
on-disk format.  Counterpart of ``repro.checkpoint``."""

from .manager import CheckpointError, CheckpointManager  # noqa: F401
