"""Sharding rules and their placements on a ``torch.distributed`` mesh."""
