"""Trace generators and validators (numpy RNG, torch tensors at the boundary)."""
