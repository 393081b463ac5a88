"""Card-only checks of the port's kernel wrappers.

Every test here carries the ``cuda`` marker and skips without a card (the
hand-written kernels have no CPU mode).  The file imports neither JAX nor
the JAX package, so it runs on a GPU machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

It covers what ``chip_smoke.py`` does not: the wrappers' operand checks
and their launch counting.  ``chip_smoke.py`` holds each kernel against
its plain version on the card and runs the closed loop there and on the
CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.calib_mape import calib_mape_grid_cuda  # noqa: E402
from repro_torch.kernels.des_readout import des_readout_cuda  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _uniform(rng, lo, hi, shape, dev):
    return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=dev)


def _calib_operands(dev, b=1, t=16, h=4, c=8):
    rng = np.random.default_rng(1)
    return (_uniform(rng, 0, 1, (b, t, h), dev), _uniform(rng, 1e3, 5e3, (b, t), dev),
            _uniform(rng, 50, 90, c, dev), _uniform(rng, 250, 450, c, dev),
            _uniform(rng, 1, 6, c, dev))


def test_kernel_wrappers_count_one_launch_per_call(dev):
    u, real, pi, pm, r = _calib_operands(dev, b=3)
    ops.reset_launches()
    ops.calib_mape_grid(u, real, pi, pm, r)          # batched: one launch
    ops.calib_mape_grid(u[0], real[0], pi, pm, r)
    ops.des_readout(u[0], p_idle=70.0, p_max=350.0, r=2.0)
    assert ops.LAUNCHES == {"calib_mape_grid": 2, "des_readout": 1}
    ops.des_readout(u[0].cpu(), p_idle=70.0, p_max=350.0, r=2.0)   # plain version
    assert ops.LAUNCHES == {"calib_mape_grid": 2, "des_readout": 1}


def test_kernel_wrappers_reject_bad_operands(dev):
    u, real, pi, pm, r = _calib_operands(dev)
    with pytest.raises(TypeError, match="float32"):
        calib_mape_grid_cuda(u.double(), real, pi, pm, r)
    with pytest.raises(ValueError, match="shape"):
        calib_mape_grid_cuda(u, real[:, :-1], pi, pm, r)
    with pytest.raises(ValueError, match="expected"):
        calib_mape_grid_cuda(u, real, pi.cpu(), pm, r)
    x, operands = ops.pack_readout(u[0, :8, :], p_idle=pi[:4], p_max=pm[:4],
                                   r=2.0, cap_t=real[0, :8])
    with pytest.raises(ValueError, match="cap"):
        des_readout_cuda(x, **dict(operands, cap=operands["cap"][:-1]))
    with pytest.raises(ValueError, match="contiguous"):
        des_readout_cuda(x.T.contiguous().T, **operands)
