"""Parallelism: the sharding context, placements, and collectives."""
