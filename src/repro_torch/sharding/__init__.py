"""Sharding rules: per-leaf partition specs of parameters, batches and
decode state over the production meshes, and their DTensor
placements."""
