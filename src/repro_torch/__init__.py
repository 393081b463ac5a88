"""PyTorch + CUDA port of the OpenDT digital twin.

Mirrors the layout and public names of the JAX package ``repro``: the
closed twinning loop (``core.twin.run_surf_experiment`` ->
``Orchestrator.run_window`` -> ``state.twin_step``) with the DES, the
prediction readout and the grid-search self-calibration.  The two hot
kernels of that loop (``calib_mape_grid``, ``des_readout``) are
hand-written CUDA C++ for Hopper (``kernels/csrc``), each with a plain
PyTorch version beside it (``kernels/ref.py``).

Entry points take ``device`` (default ``"cuda"``); asking for ``"cuda"``
without a card raises.  Kernel dispatch follows the tensor's device: a
CUDA tensor launches the hand-written kernel, a CPU tensor runs the plain
version.
"""
