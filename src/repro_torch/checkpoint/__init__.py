"""Crash-safe checkpointing (port of ``repro/checkpoint``): the zoo's step
checkpoints (``save``, ``restore``, ``latest_step``, ``CheckpointManager``)
and the streamed route's per-partition journal."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    PartitionJournal,
    latest_step,
    restore,
    save,
)

__all__ = ["CheckpointManager", "PartitionJournal", "latest_step", "restore", "save"]
