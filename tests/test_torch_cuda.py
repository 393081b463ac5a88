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
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.power_sim import power_sim_cuda  # noqa: E402
from repro_torch.kernels.ssd_chunk import limits, ssd_chunk_cuda  # noqa: E402

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


def _ssd_operands(dev, bc=2, q=24, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(2)
    return (_uniform(rng, -1, 1, (bc, q, h, p), dev), _uniform(rng, 0.1, 0.9, (bc, q, h), dev),
            _uniform(rng, -0.5, 0.5, h, dev), _uniform(rng, -1, 1, (bc, q, g, n), dev),
            _uniform(rng, -1, 1, (bc, q, g, n), dev), _uniform(rng, 0.5, 1.5, h, dev))


def test_kernel_wrappers_count_one_launch_per_call(dev):
    u, real, pi, pm, r = _calib_operands(dev, b=3)
    ops.reset_launches()
    ops.calib_mape_grid(u, real, pi, pm, r)          # batched: one launch
    ops.calib_mape_grid(u[0], real[0], pi, pm, r)
    ops.des_readout(u[0], p_idle=70.0, p_max=350.0, r=2.0)
    power = dict(p_idle=70.0, p_max=350.0, r=2.0, peak_tflops=1.0,
                 dt_seconds=300.0)
    ops.power_sim(u[0], **power)
    q = torch.randn((1, 4, 8, 16), device=dev)
    ops.flash_attention(q, q[:, :2], q[:, :2])          # GQA views: copied, one launch
    ssd = _ssd_operands(dev)
    ops.ssd_chunk(*ssd)
    counts = {"calib_mape_grid": 2, "des_readout": 1, "power_sim": 1,
              "flash_attention": 1, "ssd_chunk": 1}
    assert ops.LAUNCHES == counts
    ops.des_readout(u[0].cpu(), p_idle=70.0, p_max=350.0, r=2.0)   # plain version
    ops.power_sim(u[0].cpu(), **power)
    ops.flash_attention(q.cpu(), q[:, :2].cpu(), q[:, :2].cpu())
    ops.ssd_chunk(*(t.cpu() for t in ssd))
    assert ops.LAUNCHES == counts


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


def test_flash_and_power_sim_wrappers_reject_bad_operands(dev):
    q = torch.randn((2, 4, 8, 16), device=dev)
    kv = torch.randn((2, 2, 8, 16), device=dev)
    flash_attention_cuda(q, kv, kv, causal=True, scale=0.25)      # accepted
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q[..., :12].contiguous(), kv[..., :12].contiguous(),
                             kv[..., :12].contiguous(), causal=True, scale=0.25)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q[:, :3].contiguous(), kv, kv, causal=True, scale=0.25)
    with pytest.raises(ValueError, match="k and v"):
        flash_attention_cuda(q, kv, kv[:, :, :4].contiguous(), causal=True, scale=0.25)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_cuda(q.double(), kv.double(), kv.double(), causal=True,
                             scale=0.25)
    with pytest.raises(TypeError, match="is torch.float64"):
        flash_attention_cuda(q, kv.double(), kv, causal=True, scale=0.25)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3).contiguous().transpose(2, 3), kv,
                             kv, causal=True, scale=0.25)
    with pytest.raises(ValueError, match="on cpu"):
        flash_attention_cuda(q, kv.cpu(), kv, causal=True, scale=0.25)
    u = torch.rand((6, 5), device=dev)
    consts = dict(r=2.0, base=350.0, span=280.0, e_factor=1 / 12000, peak=1.0)
    power_sim_cuda(u, **consts)                                   # accepted
    with pytest.raises(TypeError, match="float32"):
        power_sim_cuda(u.double(), **consts)
    with pytest.raises(ValueError, match="contiguous"):
        power_sim_cuda(u.T.contiguous().T, **consts)
    with pytest.raises(ValueError, match=r"\[T, H\]"):
        power_sim_cuda(u[None], **consts)


def test_ssd_chunk_wrapper_rejects_bad_operands(dev):
    x, dt, a, b, c, d = _ssd_operands(dev)
    y, st = ssd_chunk_cuda(x, dt, a.bfloat16(), b, c, d.bfloat16())  # tracecheck: disable=TC005 — model-dtype SSM parameters, cast by the wrapper
    assert y.shape == x.shape and st.shape == (2, 4, 8, 16)
    assert y.dtype == st.dtype == torch.float32
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk_cuda(x.double(), dt, a, b, c, d)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk_cuda(x, dt, a, b.bfloat16(), c, d)  # tracecheck: disable=TC005 — a dtype the kernel refuses
    with pytest.raises(ValueError, match="multiple of groups"):
        ssd_chunk_cuda(x[:, :, :3].contiguous(), dt[:, :, :3].contiguous(), a[:3],
                       b, c, d[:3])
    max_q, max_p = limits(torch.cuda.current_device())
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros((2, 24, 4, max_p + 1), device=dev)
        ssd_chunk_cuda(wide, dt, a, b, c, d)
    with pytest.raises(ValueError, match="chunk length"):
        q = max_q + 1
        ssd_chunk_cuda(torch.zeros((1, q, 1, 8), device=dev),
                       torch.zeros((1, q, 1), device=dev), a[:1],
                       torch.zeros((1, q, 1, 4), device=dev),
                       torch.zeros((1, q, 1, 4), device=dev), d[:1])
    with pytest.raises(ValueError, match="c must have shape"):
        ssd_chunk_cuda(x, dt, a, b, c[..., :-1].contiguous(), d)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, b, c, d)
    with pytest.raises(ValueError, match="on cpu"):
        ssd_chunk_cuda(x, dt.cpu(), a, b, c, d)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_cuda(x.cpu(), dt.cpu(), a.cpu(), b.cpu(), c.cpu(), d.cpu())
