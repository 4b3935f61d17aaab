"""Serving: sampling, the batched decode engine and the slot-pool session."""
