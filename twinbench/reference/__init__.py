"""The plain reference of the benchmark's cells: NumPy and plain PyTorch.

It imports neither ``jax`` nor ``repro`` nor ``repro_torch``: the check of
a run works everything out again from the inputs the harness made, and
reads the program's outputs only to judge them.
"""
