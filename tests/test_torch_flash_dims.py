"""The flash kernel's head dims: which instantiation runs each (QK, V) pair.

The card kernel (``csrc/flash_attention.cu``) is built for seven exact
pairs and runs any other pair with ``1 <= D, Dv <= 256`` padded, on the
instantiation ``flash_attention.instantiation_for`` picks.  These CPU tests
check that choice and what depends on it without a card: the pair every
registered arch gives the kernel at every reduction factor (traced on
``meta`` tensors) is covered, each pair maps to the instantiation of least
``Dp + Dvp``, the source's dispatch lists agree with the wrapper's, the
default scale is that of the true head dim, and MLA's prefill at the
reduced configs whose pairs run padded matches the JAX package's.  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import dataclasses
import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, param_specs_for  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models.common import abstract_params  # noqa: E402

#: the reduction factors the launchers' ``--reduce`` takes in practice
FACTORS = (1, 2, 4, 8, 16, 32)

#: the factors at which an arch's pair is none of the exact ones (it runs
#: padded); every other (arch, factor) with attention gives an exact pair
PADDED_AT = {"minicpm3-4b": (2, 4, 8, 16, 32),
             "deepseek-v2-lite-16b": (4, 8, 16, 32),
             "stablelm-3b": (2, 4)}

_SOURCE = (pathlib.Path(fa.__file__).parent / "csrc" / "flash_attention.cu").read_text()


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()


def _traced_pairs(cfg) -> set:
    """The ``(D, Dv)`` of every ``ops.flash_attention`` call of one prefill
    of ``cfg`` at its own depth on ``[1, 64]`` tokens, traced on ``meta``."""
    return {(key[5], key[6]) for key in _traced_shapes(cfg, 1, 64)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_at_every_reduction_runs_on_an_instantiation(arch):
    """Each pair the arch's prefill hands the kernel at ``reduce_config``
    factors 1-32 has an instantiation that holds it; the padded ones are
    the factors of ``PADDED_AT``."""
    padded = set()
    for factor in FACTORS:
        cfg = dataclasses.replace(reduce_config(get_config(arch), factor), dtype="float32")
        pairs = _traced_pairs(cfg)
        has_attention = cfg.family != "ssm" and not (
            cfg.family == "hybrid" and cfg.num_layers < cfg.shared_attn_every)
        assert bool(pairs) == has_attention, (factor, pairs)
        for d, dv in pairs:
            dp, dvp = fa.instantiation_for(d, dv)
            assert (dp, dvp) in fa.PADDED_PAIRS and dp >= d and dvp >= dv
            if (d, dv) not in fa.HEAD_DIM_PAIRS:
                padded.add(factor)
    assert padded == set(PADDED_AT.get(arch, ())), padded


def test_each_pair_maps_to_the_least_instantiation_that_holds_it():
    """Every ``(d, dv)`` in ``1..256`` runs on itself where it is an exact
    pair, else on the padded pair of least ``Dp + Dvp`` (ties: the
    smaller ``Dp``) with ``Dp >= d`` and ``Dvp >= dv``."""
    assert fa.MAX_HEAD_DIM == 256 and (256, 256) in fa.PADDED_PAIRS
    assert set(fa.HEAD_DIM_PAIRS) < set(fa.PADDED_PAIRS)
    n_padded = 0
    for d in range(1, 257):
        for dv in range(1, 257):
            got = fa.instantiation_for(d, dv)
            if (d, dv) in fa.HEAD_DIM_PAIRS:
                assert got == (d, dv)
                continue
            n_padded += 1
            holds = [p for p in fa.PADDED_PAIRS if p[0] >= d and p[1] >= dv]
            assert got == min(holds, key=lambda p: (p[0] + p[1], p[0])), (d, dv, got)
    assert n_padded == 256 * 256 - len(fa.HEAD_DIM_PAIRS)
    for pair, want in (((16, 8), (16, 16)), ((20, 20), (32, 32)), ((24, 16), (32, 32)),
                       ((40, 40), (64, 64)), ((48, 32), (64, 64)), ((36, 20), (64, 64)),
                       ((70, 60), (80, 80)), ((160, 128), (192, 128)),
                       ((193, 1), (256, 256)), ((256, 256), (256, 256))):
        assert fa.instantiation_for(*pair) == want, pair


@pytest.mark.parametrize("d,dv", [(257, 16), (16, 257), (257, 257), (0, 16), (16, 0)])
def test_head_dims_outside_1_to_256_raise(d, dv):
    with pytest.raises(ValueError, match="head dims"):
        fa.instantiation_for(d, dv)


def test_wrapper_refuses_cpu_tensors_before_any_head_dim():
    """``flash_attention_cuda`` takes card tensors only; on the CPU the op
    runs the plain version at any head dims (as the JAX package does)."""
    q = torch.zeros((1, 2, 4, 300))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q, causal=True, scale=1.0)
    assert ops.flash_attention(q, q, q).shape == (1, 2, 4, 300)


def test_source_dispatch_lists_match_the_wrapper():
    """The source tries ``FLASH_PAIR`` (exact) first, then ``FLASH_PADDED``
    in order: the wrapper's ``HEAD_DIM_PAIRS`` and ``PADDED_PAIRS``."""
    def listed(macro):
        return tuple((int(a), int(b)) for a, b in
                     re.findall(rf"^\s*{macro}\((\d+), (\d+)\)\s*$", _SOURCE, re.M))

    assert listed("FLASH_PAIR") == fa.HEAD_DIM_PAIRS
    assert listed("FLASH_PADDED") == fa.PADDED_PAIRS


@pytest.mark.parametrize("d,dv", [(20, 12), (16, 8), (48, 32), (37, 5)])
def test_default_scale_is_that_of_the_true_head_dim(d, dv):
    """``ops.flash_attention``'s default scale at a padded pair is
    ``d ** -0.5`` of the true ``d``, never of the instantiation's."""
    rng = np.random.default_rng(d * 7 + dv)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, s).astype(np.float32))
               for s in ((2, 4, 9, d), (2, 2, 13, d), (2, 2, 13, dv)))
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v, causal=True, scale=d ** -0.5)
    assert torch.equal(got, want.contiguous())
    dp = fa.instantiation_for(d, dv)[0]
    if dp != d:
        other = ref.flash_attention_ref(q, k, v, causal=True, scale=dp ** -0.5)
        assert not torch.equal(got, other.contiguous())


@pytest.mark.parametrize("arch,factor", [("minicpm3-4b", 8), ("deepseek-v2-lite-16b", 4)])
def test_mla_prefill_at_padded_reduced_configs_matches_jax(arch, factor):
    """One MLA layer of ``reduce_config(arch, factor)`` (pairs (16, 8) and
    (48, 32), which run padded on the card) through the port's
    ``mla_prefill`` against the JAX package's, float32 on the CPU, at
    ``tests/test_torch_mla.py``'s bar."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch.train import reduce_config as jax_reduce_config
    from repro.models import mla as jax_mla
    from repro_torch.models import mla
    from test_torch_lm import np_spec_params, rescale_qk

    jcfg = jax_reduce_config(jax_get_config(arch), factor)
    cfg = reduce_config(get_config(arch), factor)
    pair = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
    assert pair not in fa.HEAD_DIM_PAIRS
    assert (jcfg.qk_nope_dim + jcfg.qk_rope_dim, jcfg.v_head_dim) == pair
    tree = rescale_qk(np_spec_params(jax_mla.mla_specs(jcfg, 1), factor))
    p = {k: v[0] for k, v in tree.items()}
    rng = np.random.default_rng(factor)
    x = rng.normal(0, 1, (2, 40, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    want = jax_mla.mla_prefill(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
                               jnp.asarray(pos), kv_chunk=16)
    got = mla.mla_prefill({k: torch.from_numpy(np.array(v)) for k, v in p.items()}, cfg,
                          torch.from_numpy(x), torch.from_numpy(pos.copy()), kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _traced_shapes(cfg, b: int, s: int) -> set:
    """The ``chip_smoke.FlashShapes`` key of every ``ops.flash_attention``
    call of one prefill of ``cfg`` on ``chip_smoke.prefill_batch``'s
    ``[b, s]`` batch, traced on ``meta`` tensors in ``cfg``'s dtype."""
    seen = set()
    real = ops.flash_attention

    def recording(q, k, v, **kw):
        seen.add((*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                  v.shape[3], bool(kw.get("causal", True)), str(q.dtype) == "torch.bfloat16"))
        return real(q, k, v, **kw)

    params = abstract_params(param_specs_for(cfg), getattr(torch, cfg.dtype))
    gen = torch.Generator().manual_seed(0)
    batch = {k: v.to("meta") for k, v in
             CHIP_SMOKE.prefill_batch(torch, cfg, b, s, gen, "cpu").items()}
    ops.flash_attention = recording
    try:
        make_prefill_step(cfg)(params, batch)
    finally:
        ops.flash_attention = real
    return seen


@pytest.mark.parametrize("arch,factor,cvc", [
    *((arch, factor, False) for arch, factor in CHIP_SMOKE.REDUCED_SERVE),
    *((arch, factor, True) for arch, factor in CHIP_SMOKE.REDUCED_CVC.items())])
def test_phase_20_gives_the_kernel_only_checked_shapes(arch, factor, cvc):
    """Every flash shape ``chip_smoke.py``'s phase 20 gives the kernel, (a)
    a reduced config's prefill on the serving launcher's prompt or (b) its
    f32 card-vs-CPU prefill, is one of ``FLASH_CASES``, which phase 3 holds
    against the plain version (phase 20 fails on any other on the card)."""
    cs = CHIP_SMOKE
    cfg = reduce_config(get_config(arch), factor)
    if cvc:
        c = cs.FAMILY_CVC
        cfg = dataclasses.replace(cfg, num_layers=c["layers"], dtype="float32")
        b, s = c["b"], c["s"]
    else:
        argv = cs.REDUCED_SERVE_ARGV
        b = int(argv[argv.index("--batch") + 1])
        s = int(argv[argv.index("--prompt-len") + 1])
    shapes = _traced_shapes(cfg, b, s)
    assert bool(shapes) == (cfg.family != "ssm" and cs.attention_calls(cfg) > 0)
    assert shapes <= {case[:9] for case in cs.FLASH_CASES}, shapes
