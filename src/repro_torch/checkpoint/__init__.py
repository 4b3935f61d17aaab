"""Checkpointing: ``manager`` (atomic, async, keep-N, restore onto the
current device)."""
