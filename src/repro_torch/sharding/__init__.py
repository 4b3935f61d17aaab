"""Sharding: logical-axis rules, parameter placements and the sharded model."""
