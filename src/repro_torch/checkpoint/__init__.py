"""Crash-safe checkpointing (port of ``repro/checkpoint``): the streamed
route's per-partition journal.  The reference's step checkpoints (``save``,
``restore``, ``latest_step``, ``CheckpointManager``) serve the zoo's
training loop and are not ported (ROADMAP Queue 1, item 8)."""
from repro_torch.checkpoint.manager import PartitionJournal  # noqa: F401

__all__ = ["PartitionJournal"]
