"""Sharded checkpoints of torch or numpy trees."""
