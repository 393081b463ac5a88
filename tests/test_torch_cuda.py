"""Card-only checks of the port's kernel wrappers.

Every test here carries the ``cuda`` marker and skips without a card (the
hand-written kernels have no CPU mode).  The file imports neither JAX nor
the JAX package, so it runs on a GPU machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

It covers what ``chip_smoke.py`` does not: the wrappers' operand checks
and their launch counting (the flash wrapper running head dims with no
instantiation of their own padded, and refusing one above 256), the
flash kernel's head-dim pairs of StableLM and the MLA configs on both
routes, padded pairs on views at any alignment, the readout's lanes at
every warp split, and that ``chip_smoke.py``'s flash-attention, calib,
readout and placement checks fail on faults planted in copies of those
kernels (V read at K's row stride fails only the exact MLA shapes; a
padded load that leaves its padding unzeroed, and a store past the V
head dim, fail the padded shapes); and, for
training, the flash-attention and SSD autograd Functions' gradients on
the card against their CPU runs, the lse output, one counted bf16 train
step and a card checkpoint restored on the CPU, the Function's gradients
at the LM families' head dims and cross-attention shape, a MoE layer's
backward bitwise repeatable and the enc-dec loss and its gradients
against the CPU; and lane sharding over the
card mesh (every card, or ``cuda:0`` four times on a one-card host): the
fleet step and ``run_scenarios`` sharded equal to unsharded bit for bit
with one launch of each kernel an entry, ``des_place``'s probes on every
mesh device, and a mesh entry beyond the cards present raising; and for
the meta passes, the MoE's expert-parallel branch over ``cuda:0`` meshes
against the one-shard call, the kernel ops' FLOP count alike on the card
and on ``meta``, and the ops' fake outputs against the kernels' at every
head-dim pair.  ``chip_smoke.py`` holds each kernel against its plain version on the card
and runs the closed loop there and on the CPU.
"""

import ctypes
import functools
import importlib.util
import pathlib
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.calib_mape import (  # noqa: E402
    MAX_BINS,
    calib_mape_grid_cuda,
    launch,
)
from repro_torch.kernels import des_readout  # noqa: E402
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


def _place_operands(dev, s=5, j=30, h=7, t=24):
    """des_place operands: S lanes of J jobs on up to H hosts, T bins,
    backfill depth up to 2, no failures."""
    rng = np.random.default_rng(3)
    x = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    args = (x(np.sort(rng.integers(0, t // 2, (s, j)), axis=1).astype(np.int32)),
            x(rng.integers(1, 6, (s, j)).astype(np.int32)),
            x(rng.integers(1, 6, (s, j)).astype(np.int32)),
            x(np.ones((s, j), bool)), x(np.arange(h)[None] < rng.integers(2, h + 1, (s, 1))),
            x(np.full(s, 8, np.int32)), x(np.arange(s) % 4), x(np.arange(s) % 3))
    return args, dict(t_bins=t, max_backfill=2)


def test_kernel_wrappers_count_one_launch_per_call(dev):
    u, real, pi, pm, r = _calib_operands(dev, b=3)
    ops.reset_launches()
    ops.calib_mape_grid(u, real, pi, pm, r)          # batched: one launch
    ops.calib_mape_grid(u[0], real[0], pi, pm, r)
    ops.des_readout(u[0], p_idle=70.0, p_max=350.0, r=2.0)
    ops.des_readout(u, p_idle=pi[:4], p_max=350.0, r=r[:3, None])   # lanes: one launch
    power = dict(p_idle=70.0, p_max=350.0, r=2.0, peak_tflops=1.0,
                 dt_seconds=300.0)
    ops.power_sim(u[0], **power)
    q = torch.randn((1, 4, 8, 16), device=dev)
    ops.flash_attention(q, q[:, :2], q[:, :2])          # GQA views: copied, one launch
    ssd = _ssd_operands(dev)
    ops.ssd_chunk(*ssd)
    place_args, place_kw = _place_operands(dev)
    ops.des_place(*place_args, **place_kw)                  # 5 lanes: one launch
    ops.des_place(*(a[:1] for a in place_args), **place_kw)
    counts = {"calib_mape_grid": 2, "des_readout": 2, "power_sim": 1,
              "flash_attention": 1, "ssd_chunk": 1, "des_place": 2}
    assert ops.LAUNCHES == counts
    ops.des_readout(u[0].cpu(), p_idle=70.0, p_max=350.0, r=2.0)   # plain version
    ops.power_sim(u[0].cpu(), **power)
    ops.flash_attention(q.cpu(), q[:, :2].cpu(), q[:, :2].cpu())
    ops.ssd_chunk(*(t.cpu() for t in ssd))
    ops.des_place(*(a.cpu() for a in place_args), **place_kw)
    assert ops.LAUNCHES == counts


def test_kernel_wrappers_reject_bad_operands(dev):
    u, real, pi, pm, r = _calib_operands(dev)
    with pytest.raises(TypeError, match="float32"):
        calib_mape_grid_cuda(u.double(), real, pi, pm, r)
    with pytest.raises(ValueError, match="shape"):
        calib_mape_grid_cuda(u, real[:, :-1], pi, pm, r)
    with pytest.raises(ValueError, match="expected"):
        calib_mape_grid_cuda(u, real, pi.cpu(), pm, r)
    entry = _build.load("calib_mape").calib_mape_grid_launch
    scratch, out = torch.empty((1, 1, 8), device=dev), torch.empty((1, 8), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for tile in (0, MAX_BINS + 1):                  # beyond the block's shared memory
        assert entry(u.data_ptr(), real.data_ptr(), pi.data_ptr(), pm.data_ptr(),
                     r.data_ptr(), scratch.data_ptr(), out.data_ptr(), 1, 16, 4, 8,
                     tile, 1, stream) != 0
    for group in (0, 2):                            # no rows, or not dividing B = 1
        assert entry(u.data_ptr(), real.data_ptr(), pi.data_ptr(), pm.data_ptr(),
                     r.data_ptr(), scratch.data_ptr(), out.data_ptr(), 1, 16, 4, 8,
                     1, group, stream) != 0
    with pytest.raises(ValueError, match="dividing"):
        calib_mape_grid_cuda(u, real, pi[None].expand(2, 8).contiguous(), pm[None].expand(
            2, 8).contiguous(), r[None].expand(2, 8).contiguous())
    x, operands = ops.pack_readout(u[0, :8, :], p_idle=pi[:4], p_max=pm[:4],
                                   r=2.0, cap_t=real[0, :8])
    with pytest.raises(ValueError, match="cap"):
        des_readout_cuda(x, **dict(operands, cap=operands["cap"][:, :-1]))
    with pytest.raises(ValueError, match="fail_start"):
        des_readout_cuda(x, **dict(operands, fail_start=pi[None, :4]))
    with pytest.raises(ValueError, match="p_idle"):
        des_readout_cuda(x, **dict(operands, p_idle=operands["p_idle"].cpu()))
    with pytest.raises(ValueError, match="contiguous"):
        des_readout_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), **operands)
    with pytest.raises(ValueError, match="lanes"):
        des_readout_cuda(x[:0], **operands)
    readout = _build.load("des_readout").des_readout_launch
    for split in (0, 3, 16):                        # not a warp split
        with pytest.raises(RuntimeError, match="launch failed"):
            des_readout.launch(readout, x, operands, split=split)
    for split in (0, 3):
        assert _build.load("power_sim").power_sim_launch(
            u.data_ptr(), scratch.data_ptr(), 4, 4, split, 2.0, 1.0, 1.0, 1.0, 1.0,
            stream) != 0


def test_flash_and_power_sim_wrappers_reject_bad_operands(dev):
    from repro_torch.kernels import ref

    q = torch.randn((2, 4, 8, 16), device=dev)
    kv = torch.randn((2, 2, 8, 16), device=dev)
    flash_attention_cuda(q, kv, kv, causal=True, scale=0.25)      # accepted
    # head dim 12 and pairs with no instantiation of their own run padded,
    # on both routes, within chip_smoke.py's bars, one launch a call
    cs = _chip_smoke()
    for d, dv in ((12, 12), (64, 32), (80, 64), (192, 192)):
        qd = torch.randn((2, 4, 8, d), device=dev)
        kd = torch.randn((2, 2, 8, d), device=dev)
        vd = torch.randn((2, 2, 8, dv), device=dev)
        for dt, bar in ((torch.float32, (2e-5, 2e-4)), (BF16, (1e-2, 1.5e-2))):
            args = (qd.to(dt), kd.to(dt), vd.to(dt))
            got = flash_attention_cuda(*args, causal=True, scale=d ** -0.5)
            ops.reset_launches()
            assert torch.equal(got, ops.flash_attention(*args))
            assert ops.LAUNCHES["flash_attention"] == 1
            _, used = cs.flash_bar_use(torch, ref, got, *args, True, *bar)
            assert used <= 1.0, (d, dv, dt, used)
    for d, dv in ((257, 16), (16, 257), (257, 257)):     # wider than any instantiation
        qd = torch.randn((2, 4, 8, d), device=dev)
        kd = torch.randn((2, 2, 8, d), device=dev)
        vd = torch.randn((2, 2, 8, dv), device=dev)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention_cuda(qd, kd, vd, causal=True, scale=0.25)
        with pytest.raises(ValueError, match="head dims"):
            ops.flash_attention(qd.to(BF16), kd.to(BF16), vd.to(BF16))
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


def test_ssd_chunk_takes_every_chunk_up_to_its_cap(dev):
    """The cap on the chunk length (shared memory) lies past the 511 rows
    that ``ssd_chunked`` makes at most at upstream Mamba2's chunk of 256;
    chunks of 255 and 511 rows and of the cap itself run (the longer ones
    with fewer heads per block) and agree with the plain version, one row
    more raises."""
    from repro_torch.kernels import ref

    max_q, _ = limits(torch.cuda.current_device())
    assert max_q >= 511
    for q in (255, 511, max_q):
        args = _ssd_operands(dev, bc=1, q=q, h=2, p=16, g=1, n=32)
        for got, want in zip(ssd_chunk_cuda(*args), ref.ssd_chunk_ref(*args)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="chunk length"):
        ssd_chunk_cuda(*_ssd_operands(dev, bc=1, q=max_q + 1, h=2, p=16, g=1, n=32))


def test_flash_bf16_takes_views_off_a_16_byte_boundary(dev):
    """The bf16 route copies 16-byte chunks; a contiguous view that starts
    off such a boundary is copied by the wrapper, not refused."""
    from repro_torch.kernels import ref

    bf = torch.bfloat16  # tracecheck: disable=TC005 — the bf16 attention route
    base = torch.randn(1 + 2 * 4 * 40 * 32, device=dev).to(bf)
    q = base[1:].view(2, 4, 40, 32)                  # 2-byte offset
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    kv = torch.randn((2, 2, 40, 32), device=dev).to(bf)
    got = flash_attention_cuda(q, kv, kv, causal=True, scale=32 ** -0.5)
    _, used = _chip_smoke().flash_bar_use(torch, ref, got, q, kv, kv, True,
                                          rtol=1e-2, atol=1.5e-2)
    assert used <= 1.0


def test_flash_padded_pairs_take_views_at_any_alignment(dev):
    """A padded pair's bf16 route copies in chunks its operands' alignment
    allows (8, 4, 2 or 1 elements): views 2, 4 and 8 bytes off a 16-byte
    boundary, at even and odd head dims, run uncopied and agree with the
    plain version."""
    from repro_torch.kernels import ref

    for d, off in ((20, 1), (20, 2), (36, 2), (24, 1), (17, 1), (48, 4)):
        base = torch.randn(off + 2 * 4 * 70 * d, device=dev).to(BF16)
        q = base[off:].view(2, 4, 70, d)
        k = torch.randn(3 + 2 * 2 * 70 * d, device=dev).to(BF16)[3:].view(2, 2, 70, d)
        v = torch.randn((2, 2, 70, d), device=dev).to(BF16)
        assert q.is_contiguous() and q.data_ptr() % 16 != 0
        got = flash_attention_cuda(q, k, v, causal=True, scale=d ** -0.5)
        _, used = _chip_smoke().flash_bar_use(torch, ref, got, q, k, v, True,
                                              rtol=1e-2, atol=1.5e-2)
        assert used <= 1.0, (d, off, used)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: faults planted in a copy of the bf16 flash kernel, as (text, replacement)
#: in its source: the first three confined to the last 64-row query tile of
#: a 2048-key prefill, whose rows average the most keys, so a fault moves
#: them least; the last reads the first V tile with K's row stride, which
#: only a V head dim other than the QK one (MLA) can show; "none" is the
#: unchanged copy
FLASH_FAULTS = {
    "none": ("", ""),
    "kv tile skipped": (
        "    cp_async_commit();\n    const bf16* kst",
        "    cp_async_commit();\n    if (kv_tiles >= 32 && kt == kv_tiles / 2) continue;\n"
        "    const bf16* kst"),
    "wrong ring stage": (
        "const bf16* vst = vs + (kt & 1) * kKeys * kLdv;",
        "const bf16* vst = vs + ((kt + (kv_tiles >= 32 && kt == kv_tiles - 1)) & 1)"
        " * kKeys * kLdv;"),
    "diagonal key masked": (
        "(!causal || rows[e >> 1] + diag >= key)",
        "(!causal || rows[e >> 1] + diag >= key + (kv_tiles >= 32))"),
    "V read at the QK stride": (
        "load_tile<Dv, Dv, kKeys>(vs, vb, 0, Skv, tid);",
        "load_tile<Dv, D, kKeys>(vs, vb, 0, Skv, tid);"),
}


def _flash_fault_shows(fault: str, d: int, dv: int, skv: int) -> bool:
    """Whether the planted ``fault`` must fail a bf16 prefill case: the
    first three on 2048 keys (32 KV tiles), the V stride where ``dv != d``
    on an exact pair (a padded pair's loads are its own)."""
    from repro_torch.kernels.flash_attention import HEAD_DIM_PAIRS

    if fault == "none":
        return False
    if fault == "V read at the QK stride":
        return dv != d and (d, dv) in HEAD_DIM_PAIRS
    return skv >= 32 * 64


def _build_copies(name: str, faults: dict, out_dir: pathlib.Path) -> dict:
    """Each copy of ``csrc/<name>.cu`` in ``faults`` built with the port's
    nvcc flags (one nvcc each, all started together); its C entry point,
    loaded with the port's argument types, by fault name."""
    src = (pathlib.Path(_build.__file__).parent / "csrc" / f"{name}.cu").read_text()
    procs = {}
    for i, (fault, (text, planted)) in enumerate(faults.items()):
        assert text in src, f"{fault}: the source no longer holds {text!r}"
        cu = out_dir / f"{name}_fault{i}.cu"
        cu.write_text(src.replace(text, planted, 1) if text else src)
        so = out_dir / f"{name}_fault{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[fault] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), so)
    entries = {}
    fn_name, argtypes = _build.ENTRY_POINTS[name]
    for fault, (proc, so) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{fault}: nvcc failed\n{log}"
        fn = getattr(ctypes.CDLL(str(so)), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[fault] = fn
    return entries


def test_flash_check_fails_on_planted_faults(dev, tmp_path):
    """``chip_smoke.py``'s bf16 flash check, at every bf16 prefill shape
    (2048 queries), passes the unchanged copy and fails each planted fault
    where it shows (``_flash_fault_shows``): the V-stride fault fails the
    exact MLA shapes and only them.  Prints each bar use beside that of the
    earlier check (the plain version rounded to bf16, rtol / atol 2e-2)."""
    from repro_torch.kernels import ref

    cs = _chip_smoke()
    cases = [i for i, c in enumerate(cs.FLASH_CASES) if c[8] and c[3] == cs.PREFILL_S]
    assert len(cases) == 10
    assert sum(cs.FLASH_CASES[i][5] != cs.FLASH_CASES[i][6] for i in cases) == 3
    stream = torch.cuda.current_stream().cuda_stream
    for name, launch in _build_copies("flash_attention", FLASH_FAULTS, tmp_path).items():
        for i in cases:
            b, hq, hkv, sq, skv, d, dv, causal, _, rtol, atol = cs.FLASH_CASES[i]
            q, k, v = cs.flash_inputs(torch, np, i, dev)
            got = q.new_empty((b, hq, sq, dv))
            assert launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), got.data_ptr(),
                          None, b, hq, hkv, sq, skv, d, dv, 1, int(causal), d ** -0.5,
                          stream) == 0
            torch.cuda.synchronize()
            err, used = cs.flash_bar_use(torch, ref, got, q, k, v, causal, rtol, atol)
            want = ref.flash_attention_ref(q, k, v, causal=causal).float()
            old = float(((got.float() - want).abs() / (2e-2 + 2e-2 * want.abs())).max())
            print(f"flash fault {name!r} at {(b, hq, hkv, sq, skv, d, dv)}: max |err| "
                  f"{err:.3g}, bar used {used:.3g} (earlier check {old:.3g})")
            assert (used > 1.0) == _flash_fault_shows(name, d, dv, skv), (name, i, used)


#: faults planted in a copy of the bf16 flash kernel's padded route, as
#: (text, replacement) in its source: the padding columns of Q, K and V
#: loaded with the row's leading columns instead of zeros (in bounds), and
#: the output's paired stores not stopped at the V head dim (they write
#: into the next row, and past the end: the test leaves room there)
FLASH_PADDING_FAULTS = {
    "none": ("", ""),
    "padding not zeroed": (
        "const bool ok = row0 + r < valid && c < w;\n"
        "    const bf16* g = ok ? src + static_cast<long long>(row0 + r) * w + c : src;",
        "const bool ok = row0 + r < valid;\n"
        "    const bf16* g = ok ? src + static_cast<long long>(row0 + r) * w + c % w : src;"),
    "store past dv": (
        "if (c < wv) *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(lo, hi);",
        "*reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(lo, hi);"),
}


def _padding_fault_shows(fault: str, d: int, dv: int) -> bool:
    """Whether the planted ``fault`` must fail a padded bf16 case: the
    unzeroed padding where Q and K have padding columns (``d`` below the
    instantiation's), the store past ``dv`` where V has them and ``dv``
    is even (an odd one stores single values)."""
    from repro_torch.kernels.flash_attention import instantiation_for

    dp, dvp = instantiation_for(d, dv)
    return {"none": False, "padding not zeroed": dp > d,
            "store past dv": dvp > dv and dv % 2 == 0}[fault]


def test_flash_check_fails_on_planted_padding_faults(dev, tmp_path):
    """``chip_smoke.py``'s bf16 flash check at every padded bf16 case of
    ``FLASH_CASES`` passes the unchanged copy and fails each planted fault
    where it shows (``_padding_fault_shows``); prints each bar use."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import HEAD_DIM_PAIRS

    cs = _chip_smoke()
    cases = [i for i, c in enumerate(cs.FLASH_CASES)
             if c[8] and (c[5], c[6]) not in HEAD_DIM_PAIRS]
    assert len(cases) == 22
    stream = torch.cuda.current_stream().cuda_stream
    for name, launch in _build_copies("flash_attention", FLASH_PADDING_FAULTS,
                                      tmp_path).items():
        for i in cases:
            b, hq, hkv, sq, skv, d, dv, causal, _, rtol, atol = cs.FLASH_CASES[i]
            q, k, v = cs.flash_inputs(torch, np, i, dev)
            n = b * hq * sq * dv
            got = q.new_zeros(n + 1024)[:n].view(b, hq, sq, dv)   # room past the end
            assert launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), got.data_ptr(),
                          None, b, hq, hkv, sq, skv, d, dv, 1, int(causal), d ** -0.5,
                          stream) == 0
            torch.cuda.synchronize()
            err, used = cs.flash_bar_use(torch, ref, got, q, k, v, causal, rtol, atol)
            print(f"flash padding fault {name!r} at {(b, hq, hkv, sq, skv, d, dv, causal)}: "
                  f"max |err| {err:.3g}, bar used {used:.3g}")
            assert (used > 1.0) == _padding_fault_shows(name, d, dv), (name, i, used)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,dv", [(80, 80), (96, 64), (192, 128)])
def test_flash_new_head_dim_pairs_match_plain(dev, dtype, d, dv):
    """The head-dim pairs of StableLM-3B and the MLA configs on both
    routes, GQA, ragged (Sq 70 < Skv 150) and causal, against the plain
    version at chip_smoke.py's bars, with the lse, repeatable bit for bit."""
    from repro_torch.kernels import ref

    cs = _chip_smoke()
    rng = np.random.default_rng(d + dv)
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, s).astype(np.float32), device=dev).to(dt)
               for s in ((2, 6, 70, d), (2, 2, 150, d), (2, 2, 150, dv)))
    ops.reset_launches()
    out, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert out.shape == (2, 6, 70, dv) and out.dtype == dt
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=True))
    rtol, atol = (2e-5, 2e-4) if dtype == "float32" else (1e-2, 1.5e-2)
    _, used = cs.flash_bar_use(torch, ref, out, q, k, v, True, rtol, atol)
    assert used <= 1.0
    _, want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True,
                                      return_lse=True)
    torch.testing.assert_close(lse, want, rtol=cs.LSE_RTOL, atol=cs.LSE_ATOL)


#: faults planted in a copy of the calib kernel, as (text, replacement) in
#: its source; "none" is the unchanged copy
CALIB_FAULTS = {
    "none": ("", ""),
    "dedup merges different r": (
        "const unsigned bits = __float_as_uint(rc);",
        "const unsigned bits = __float_as_uint(rc) >> 16;"),
    "last bin tile dropped": (
        "for (int k = 0; k < n_tiles; ++k)",
        "for (int k = 0; k < n_tiles - (n_tiles > 1); ++k)"),
    "host chunk skipped": (
        "h0 += kHostChunk;", "h0 += (H > kHostChunk ? 2 : 1) * kHostChunk;"),
    "candidate rows read as shared": (
        "static_cast<long long>(b / group) * C + c;", "static_cast<long long>(c);"),
}


def test_calib_check_fails_on_planted_faults(dev, tmp_path):
    """``chip_smoke.py``'s calib check (``calib_cases``, ``calib_agrees``)
    passes the unchanged copy of the kernel and fails each planted fault
    in at least one case.  Prints the cases each fault fails."""
    from repro_torch.kernels import ref

    cs = _chip_smoke()
    cases = cs.calib_cases(torch, np, dev)
    for name, entry in _build_copies("calib_mape", CALIB_FAULTS, tmp_path).items():
        failed = []
        for label, args in cases:
            got = launch(entry, *args)
            torch.cuda.synchronize()
            err, ok = cs.calib_agrees(torch, got, ref.calib_mape_grid_ref(*args))
            if not ok:
                failed.append(f"{label} ({err:.3g})")
        print(f"calib fault {name!r}: fails {len(failed)} of {len(cases)} cases: "
              + "; ".join(failed))
        assert (not failed) == (name == "none"), (name, failed)


def test_calib_candidate_rows_match_plain_and_each_lanes_own_call(dev):
    """Per-lane candidate rows in one launch (``chip_smoke.calib_lane_cases``:
    64 lanes at E2's window, 16 lanes of refined joint grids, the per-host
    rows of 8 lanes) against the plain version at the calib bar, and each
    lane or lane group equal, bit for bit, to the call that lane makes alone
    (the solo twin's window, or its per-host refit)."""
    from repro_torch.kernels import ref

    cs = _chip_smoke()
    for label, (u, real, pi, pm, r) in cs.calib_lane_cases(torch, np, dev).items():
        ops.reset_launches()
        got = ops.calib_mape_grid(u, real, pi, pm, r)
        assert ops.LAUNCHES["calib_mape_grid"] == 1, label
        err, ok = cs.calib_agrees(torch, got, ref.calib_mape_grid_ref(u, real, pi, pm, r))
        assert ok, (label, err)
        group = u.shape[0] // r.shape[0]
        for lane in {0, r.shape[0] // 2, r.shape[0] - 1}:
            rows = slice(lane * group, (lane + 1) * group)
            alone = (ops.calib_mape_grid(u[lane], real[lane], pi[lane], pm[lane], r[lane])
                     if group == 1 else
                     ops.calib_mape_grid(u[rows], real[rows], pi[lane], pm[lane], r[lane]))
            assert torch.equal(got[rows].reshape(alone.shape).view(torch.int32),
                               alone.view(torch.int32)), (label, lane)


def test_readout_lanes_are_independent_at_every_split(dev):
    """Each lane of a batched launch equals, bit for bit, the launch of that
    lane alone at the same warp split, at splits 1, 2, 4 and 8, and every
    split agrees with the plain version; so does power_sim at every split."""
    from repro_torch.kernels import ref

    cs = _chip_smoke()
    entry = _build.load("des_readout").des_readout_launch
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.uniform(0, 1.15, (3, 20, 1100)).astype(np.float32), device=dev)
    kw = cs.lanes_case(torch, np, u, 4)
    x, operands = ops.pack_readout(u, **kw)
    want = ref.des_readout_ref(x, **operands)
    for split in (1, 2, 4, 8):
        got = des_readout.launch(entry, x, operands, split=split)
        err, bad = cs.readout_agrees(torch, dict(zip(ref.READOUT_FIELDS, got.unbind(0))),
                                     want, "f32")
        assert bad is None, (split, bad, err)
        for i in range(3):
            xi, oi = ops.pack_readout(u[i:i + 1], **{
                k: v[i:i + 1] if torch.is_tensor(v) and v.shape[0] == 3 else v
                for k, v in kw.items()})
            solo = des_readout.launch(entry, xi, oi, split=split)
            assert torch.equal(solo[:, 0], got[:, i]), (split, i)
    power = _build.load("power_sim").power_sim_launch
    field = u[0].contiguous()
    kw = dict(peak_tflops=120.0, dt_seconds=300.0)
    consts = ref.power_sim_constants(1100, p_idle=70.0, p_max=350.0, **kw)
    scalars = (2.3, consts["base"], consts["span"], consts["e_factor"], consts["peak"])
    want = ref.power_sim_ref(field, 70.0, 350.0, 2.3, **kw)
    stream = torch.cuda.current_stream().cuda_stream
    for split in (1, 2, 4, 8):
        out = torch.empty((3, 20), device=dev)
        assert power(field.data_ptr(), out.data_ptr(), 20, 1100, split, *scalars,
                     stream) == 0
        for g, w in zip(out, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-2)


#: faults planted in a copy of the readout kernel, as (text, replacement)
#: in its source; "none" is the unchanged copy
READOUT_FAULTS = {
    "none": ("", ""),
    "lanes' host rows swapped": (
        "        const long long h = h0 + i;\n",
        "        const long long h = h0 + i;\n"
        "        const long long s = (blockIdx.y + 1) % a.S;\n"),
    "last host chunk skipped": (
        "h0 < a.H; h0 += kHostChunk", "h0 < a.H && !(a.H > kHostChunk && "
        "h0 + kHostChunk >= a.H); h0 += kHostChunk"),
    "split drops a warp's partial": (
        "if (p < split) v +=", "if (p < split - 1) v +="),
    "lanes' carbon column read from lane 0": (
        "ci = f32_at(a.intensity, s, tb);", "ci = f32_at(a.intensity, 0, tb);"),
}


def test_readout_check_fails_on_planted_faults(dev, tmp_path):
    """``chip_smoke.py``'s readout check (``readout_cases``,
    ``readout_agrees``, opendc in f32) passes the unchanged copy of the
    kernel and fails each planted fault in at least one case.  Prints the
    cases each fault fails."""
    from repro_torch.kernels import ref

    cs = _chip_smoke()
    cases = cs.readout_cases(torch, np, dev)
    for name, entry in _build_copies("des_readout", READOUT_FAULTS, tmp_path).items():
        failed = []
        for label, u, kw in cases:
            x, operands = ops.pack_readout(u, **kw)
            got = des_readout.launch(entry, x, operands)
            torch.cuda.synchronize()
            err, bad = cs.readout_agrees(torch, dict(zip(ref.READOUT_FIELDS, got.unbind(0))),
                                         ref.des_readout_ref(x, **operands), "f32")
            if bad:
                failed.append(f"{label} ({bad}, {err:.3g})")
        print(f"readout fault {name!r}: fails {len(failed)} of {len(cases)} cases: "
              + "; ".join(failed))
        assert (not failed) == (name == "none"), (name, failed)


def test_des_place_wrapper_rejects_bad_operands(dev):
    """The host count beyond the kernel's shared memory, a backfill window
    beyond 31 and failure arrays given in part raise; so do operands on
    another device."""
    from repro_torch.kernels import des_place

    args, kw = _place_operands(dev)
    most = des_place.max_hosts()
    assert most == 8192
    wide = torch.ones((5, most + 1), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ops.des_place(*args[:4], wide, *args[5:], **kw)
    with pytest.raises(ValueError, match="max_backfill"):
        ops.des_place(*args, **dict(kw, max_backfill=32))
    fs = torch.zeros((5, 7), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="together"):
        ops.des_place(*args, **kw, fail_start=fs, fail_end=fs)
    with pytest.raises(ValueError, match="one device"):
        des_place.des_place_cuda(*args[:5], args[5].cpu(), *args[6:], t_bins=24,
                                 max_starts_per_bin=64, max_backfill=2)
    o = des_place.operands(*args, t_bins=24)
    entry = _build.load("des_place").des_place_launch
    with pytest.raises(RuntimeError, match="launch failed"):   # window beyond 31
        des_place.launch(entry, o, t_bins=24, max_starts_per_bin=64, max_backfill=40)


#: faults planted in a copy of the placement kernel, as (text, replacement)
#: in its source; "none" is the unchanged copy
PLACE_FAULTS = {
    "none": ("", ""),
    "ties to the highest index": (
        "idx[i] = v[i] == top ? i : 4 * R;\n    const int first = tree_min(idx);",
        "idx[i] = v[i] == top ? i : -1;\n    const int first = tree_max(idx);"),
    "random-fit salt counts attempts": ("const int salt = placed;",
                                        "const int salt = attempts;"),
    "kill rule dropped": ("if (fail && flag[host] && t < fs[host] && end > fs[host])",
                          "if (false)"),
    "window refilled one job late": ("fill(hi);", "fill(hi + 1);"),
    "host min turned into a max": (
        "__reduce_min_sync(kAll, best == m ? static_cast<unsigned>(best_host) : UINT_MAX)",
        "__reduce_max_sync(kAll, best == m ? static_cast<unsigned>(best_host) : 0u)"),
    "release into the prefetched row dropped": ("if (owner && soon) late[host] += need;", ""),
}


def test_place_check_fails_on_planted_faults(dev, tmp_path):
    """``chip_smoke.py``'s placement check (``place_cases``: schedules
    equal to the plain version on CPU copies) passes the unchanged copy of
    the kernel and fails each planted fault in at least one case.  Prints
    the cases each fault fails."""
    from repro_torch.kernels import des_place

    cs = _chip_smoke()
    cases = cs.place_cases(torch, np, dev)
    wants = []
    for label, args, kw, unique in cases:
        cpu = {k: v[:unique].cpu() if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        want = ops.des_place(*(a[:unique].cpu() for a in args), **cpu)
        wants.append([w[torch.arange(args[0].shape[0]) % unique] for w in want])
    for name, entry in _build_copies("des_place", PLACE_FAULTS, tmp_path).items():
        failed = []
        for (label, args, kw, _), want in zip(cases, wants):
            fails = {k: kw[k] for k in ("fail_start", "fail_end", "fail_kill") if k in kw}
            o = des_place.operands(*args, t_bins=kw["t_bins"], **fails)
            got = des_place.launch(entry, o, t_bins=kw["t_bins"],
                                   max_starts_per_bin=kw.get("max_starts_per_bin", 64),
                                   max_backfill=kw["max_backfill"])
            torch.cuda.synchronize()
            if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                failed.append(label)
        print(f"place fault {name!r}: fails {len(failed)} of {len(cases)} cases: "
              + "; ".join(failed))
        assert (not failed) == (name == "none"), (name, failed)


# -- training: the autograd Functions, a train step, checkpoints ---------------


#: the LM's training dtype (weights, not twin math)
BF16 = torch.bfloat16  # tracecheck: disable=TC005 — bf16 LM training step and checkpoint


def _grads_of(fn, inputs, cotangents):
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cotangents)
    return [o.detach() for o in outs], [x.grad for x in xs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,skv", [(True, 96), (False, 80)])
def test_flash_function_grads_on_the_card_match_its_cpu_run(dev, dtype, causal, skv):
    """The FlashAttention Function (the kernel's forward with its lse, the
    plain-torch backward) on the card against the same Function on float32
    CPU copies (the plain forward): f32 at rtol 1e-4 / atol 1e-5, bf16 at
    2^-6 of each tensor's largest value (its output and gradients are
    rounded to bf16)."""
    from repro_torch.models.attention import FlashAttention

    rng = np.random.default_rng(skv)
    dt = getattr(torch, dtype)
    shapes = ((2, 6, 64, 32), (2, 2, skv, 32), (2, 2, skv, 32), (2, 6, 64, 32))
    q, k, v, do = (torch.as_tensor(rng.normal(0, 1, s).astype(np.float32)) for s in shapes)
    fn = lambda a, b, c: FlashAttention.apply(a, b, c, causal, 32 ** -0.5, 40)  # noqa: E731
    ops.reset_launches()
    (out,), grads = _grads_of(fn, [x.to(dev, dt) for x in (q, k, v)], (do.to(dev, dt),))
    assert ops.LAUNCHES["flash_attention"] == 1
    (want,), wgrads = _grads_of(fn, [q, k, v], (do,))
    for got, w in zip([out, *grads], [want, *wgrads]):
        assert got.dtype == dt
        got = got.float().cpu()
        if dtype == "float32":
            torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-5)
        else:
            assert float((got - w).abs().max()) <= 2 ** -6 * float(w.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_lse_output_matches_plain(dev, dtype):
    from repro_torch.kernels import ref

    rng = np.random.default_rng(3)
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, s).astype(np.float32), device=dev).to(dt)
               for s in ((2, 4, 70, 64), (2, 2, 90, 64), (2, 2, 90, 64)))
    out, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=True))
    _, want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True,
                                      return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 70)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)


def test_ssd_function_grads_on_the_card_match_its_cpu_run(dev):
    """SSDChunk (the kernel's forward, the plain version's gradient) on the
    card against its CPU run, at ``ssd_chunk``'s bar (rtol/atol 1e-4 of
    each tensor's largest value)."""
    from repro_torch.models.mamba2 import SSDChunk

    args = [x.cpu() for x in _ssd_operands(dev, bc=3, q=64, h=4, p=16, g=1, n=32)]
    rng = np.random.default_rng(4)
    cts = (torch.as_tensor(rng.normal(0, 1, (3, 64, 4, 16)).astype(np.float32)),
           torch.as_tensor(rng.normal(0, 1, (3, 4, 16, 32)).astype(np.float32)))
    ops.reset_launches()
    outs, grads = _grads_of(SSDChunk.apply, [x.to(dev) for x in args], [c.to(dev) for c in cts])
    assert ops.LAUNCHES["ssd_chunk"] == 1
    wouts, wgrads = _grads_of(SSDChunk.apply, args, cts)
    for got, w in zip(outs + grads, wouts + wgrads):
        scale = float(w.abs().max())
        torch.testing.assert_close(got.cpu(), w, rtol=1e-4, atol=1e-4 * scale)


def test_one_bf16_train_step_counts_its_launches(dev):
    """A reduced SmolLM (2 layers, bf16, remat "dots") takes one train step
    on the card: finite metrics, and 2 flash launches a layer (the forward
    and its recompute in the backward)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step, param_specs_for
    from repro_torch.launch.train import reduce_config
    from repro_torch.models.common import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m"), 8), num_layers=2)
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=4)
    params = init_params(param_specs_for(cfg), torch.Generator(device=dev).manual_seed(0),
                         BF16, dev)
    tokens = torch.randint(0, cfg.vocab, (2, 65), device=dev, dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    ops.reset_launches()
    new, opt, m = make_train_step(cfg, opt_cfg)(params, init_opt_state(params, opt_cfg), batch)
    assert ops.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    assert all(ops.LAUNCHES[k] == 0 for k in ops.LAUNCHES if k != "flash_attention")
    assert all(bool(torch.isfinite(m[k])) for k in ("loss", "grad_norm", "lr"))
    assert new["embed"].dtype == BF16 and new["embed"].device.type == "cuda"
    assert int(opt.step) == 1


def test_card_checkpoint_restores_on_the_cpu(dev, tmp_path):
    from repro_torch._tree import leaves
    from repro_torch.checkpoint import ckpt
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    params = {"w": torch.randn(5, 3, device=dev).to(BF16),
              "b": torch.randn(3, device=dev)}
    state = {"params": params, "opt": init_opt_state(params, AdamWConfig())}
    ckpt.save(str(tmp_path), 3, state)
    like = {"params": {k: torch.zeros_like(v, device="cpu") for k, v in params.items()},
            "opt": init_opt_state({k: torch.zeros_like(v, device="cpu")
                                   for k, v in params.items()}, AdamWConfig())}
    step, got = ckpt.restore_as_torch(str(tmp_path), like)
    assert step == 3
    for a, b in zip(leaves(got), leaves(state)):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,d,dv,causal", [
    (96, 96, 96, 64, True), (96, 96, 192, 128, True), (96, 96, 80, 80, True),
    (256, 64, 64, 64, False)], ids=["96-64", "192-128", "80-80", "cross"])
def test_flash_function_grads_at_family_head_dims_match_plain_autograd(
        dev, dtype, sq, skv, d, dv, causal):
    """The FlashAttention Function on the card at the MLA pairs, StableLM's
    80 and the enc-dec's cross-attention shape (256 decoder queries
    against 64 frames, non-causal) against the plain version's autograd
    on the card in f32: ``dq``/``dk`` of width ``d``, ``dv`` of width
    ``dv``; f32 at rtol 1e-4 / atol 1e-5, bf16 at 2^-6 of each tensor's
    largest value."""
    from repro_torch.kernels import ref
    from repro_torch.models.attention import FlashAttention

    rng = np.random.default_rng(d + dv + skv)
    dt = getattr(torch, dtype)
    shapes = ((2, 4, sq, d), (2, 2, skv, d), (2, 2, skv, dv), (2, 4, sq, dv))
    q, k, v, do = (torch.as_tensor(rng.normal(0, 1, s).astype(np.float32), device=dev)
                   for s in shapes)
    fn = lambda a, b, c: FlashAttention.apply(a, b, c, causal, d ** -0.5, 40)  # noqa: E731
    ops.reset_launches()
    (out,), grads = _grads_of(fn, [x.to(dt) for x in (q, k, v)], (do.to(dt),))
    assert ops.LAUNCHES["flash_attention"] == 1
    (want,), wgrads = _grads_of(
        lambda a, b, c: ref.flash_attention_ref(a, b, c, causal=causal),
        [x.to(dt).float() for x in (q, k, v)], (do.to(dt).float(),))
    for got, w in zip([out, *grads], [want, *wgrads]):
        assert got.dtype == dt and got.shape == w.shape
        if dtype == "float32":
            torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-5)
        else:
            assert float((got.float() - w).abs().max()) <= 2 ** -6 * float(w.abs().max())


def test_moe_layer_backward_is_bitwise_repeatable(dev):
    """A MoE layer at Qwen1.5-MoE-A2.7B's width (60 experts padded to 64, top
    4, shared experts) in bf16 on [2, 256] tokens, with capacity drops
    (every dropped token gathers the same clamped row): two backward passes
    from the same inputs give bitwise equal gradients of the input, the
    router and every expert weight."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import init_params

    cfg = get_config("qwen2-moe-a2.7b")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {k: v[0] for k, v in init_params(moe.moe_specs(cfg, 1), gen, BF16, dev).items()}
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device=dev).to(BF16)
    ct = torch.randn((2, 256, cfg.d_model), generator=gen, device=dev).to(BF16)
    keep, _ = moe.dispatch(moe.route(x.reshape(-1, cfg.d_model), p["router"], cfg,
                                     moe.padded_experts(cfg))[2], moe.padded_experts(cfg), 0,
                           moe._capacity(512, cfg))
    assert not bool(keep.all())                       # some (token, slot) dropped

    def grads():
        xs = [t.detach().clone().requires_grad_() for t in (x, *p.values())]
        y, aux = moe.moe_ffn(cfg, dict(zip(p, xs[1:])), xs[0])
        torch.autograd.backward([y, aux], [ct, torch.ones_like(aux)])
        return [t.grad for t in xs]

    a, b = grads(), grads()
    assert all(torch.equal(g, h) for g, h in zip(a, b))
    assert all(bool(torch.isfinite(g).all()) for g in a)


def test_encdec_loss_on_the_card_matches_the_cpu(dev):
    """``loss_for`` of the enc-dec family (``encdec_loss``) at Seamless-M4T's
    ``reduce_config(..., 8)`` width, 2 + 2 layers, f32, random frames: the
    card's loss and every gradient against the CPU's (TF32 off) at
    ``chip_smoke.py`` phase 13's f32 bars: the loss at rtol 1e-5, the
    whole gradient's relative L2 error 1e-4 and each leaf's 1e-3, with 2
    flash launches an attention call under remat.  Query
    and key projections are rescaled from the init's fan-in (a head count)
    to the width they contract: at the init's scale attention is near
    argmax and rounding in a score moves the gradients as a fault would."""
    import dataclasses

    from repro_torch._tree import flatten
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_for, param_specs_for
    from repro_torch.launch.train import reduce_config
    from repro_torch.models.common import init_params

    cfg = dataclasses.replace(reduce_config(get_config("seamless-m4t-medium"), 8),
                              enc_layers=2, dec_layers=2, dtype="float32")
    params = init_params(param_specs_for(cfg), torch.Generator().manual_seed(1),
                         torch.float32, "cpu")
    for part in ("encoder", "decoder"):
        for name, w in params[part].items():
            if name in ("wq", "wk", "x_wq", "x_wk"):
                w *= (w.shape[-2] / w.shape[-3]) ** 0.5
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1),
             "frames": torch.as_tensor(rng.normal(0, 1, (2, 64, cfg.d_model))
                                       .astype(np.float32))}
    flat, unflatten = flatten(params)

    def run(device):
        xs = [x.to(device).requires_grad_() for x in flat]
        loss, _ = loss_for(cfg)(cfg, unflatten(xs), {k: v.to(device) for k, v in batch.items()})
        return loss.detach().cpu(), [g.cpu() for g in torch.autograd.grad(loss, xs)]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)                 # a process's first multithreaded
    try:                                     # CPU log is now and then off (ROADMAP C)
        want, wgrads = run("cpu")
    finally:
        torch.set_num_threads(threads)
    ops.reset_launches()
    got, grads = run(dev)
    assert ops.LAUNCHES["flash_attention"] == 2 * (2 + 2 * 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    diff = [float((g - w).norm()) for g, w in zip(grads, wgrads, strict=True)]
    norms = [float(w.norm()) for w in wgrads]
    assert sum(d * d for d in diff) ** 0.5 <= 1e-4 * sum(n * n for n in norms) ** 0.5
    assert all(d <= 1e-3 * n for d, n in zip(diff, norms))


# -- lane sharding over the card mesh ----------------------------------------


def _card_mesh(axis):
    """Every card when the host has more than one, else ``cuda:0`` four
    times (shards taken in turn on one card)."""
    from repro_torch.parallel.sharding import make_mesh_compat

    n = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0"] * 4
    return make_mesh_compat((len(devices),), (axis,), devices=devices)


def _same(a, b):
    """Every tensor of two (nested) dataclasses equal, bit for bit, on one
    device."""
    import dataclasses

    if isinstance(a, torch.Tensor):
        assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.name != "cfg":
                _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert (a is None) == (b is None)


def test_fleet_step_sharded_on_the_card_mesh_equals_unsharded(dev):
    """D=6 lanes with differing bases and mixed fill, split over the card
    mesh: successor states and outputs bit for bit the unsharded step's,
    one readout and one calibration launch an entry."""
    from repro_torch.core import state as pstate
    from repro_torch.core import twin as ptwin
    from repro_torch.core.power import PowerParams
    from repro_torch.traces.schema import DatacenterConfig

    cfg = pstate.TwinConfig(bins_per_window=12, dc=DatacenterConfig(num_hosts=8, cores_per_host=4))
    d = 6
    fleet = ptwin.stack_twin_states([pstate.init_twin_state(
        cfg, PowerParams(p_idle=60.0 + 3 * i, p_max=300.0 + 20 * i, r=1.5 + 0.3 * i))
        for i in range(d)])
    rng = np.random.default_rng(5)
    mesh = _card_mesh(ptwin.FLEET_AXIS)
    for _ in range(3):
        u = _uniform(rng, 0, 1, (d, 12, 8), dev)
        telem = pstate.TelemetrySlice(u_th=u, power_w=_uniform(rng, 800, 2500, (d, 12), dev),
                                      valid=torch.ones(d, dtype=torch.bool, device=dev))
        active = torch.as_tensor(rng.uniform(size=d) < 0.8, device=dev)
        ref = ptwin.fleet_step_masked(fleet, telem, pstate.SimSlice(u_th=u), active)
        ops.reset_launches()
        sh = ptwin.fleet_step_masked(fleet, telem, pstate.SimSlice(u_th=u), active,
                                     shard=True, mesh=mesh)
        torch.cuda.synchronize()
        assert (ops.LAUNCHES["des_readout"], ops.LAUNCHES["calib_mape_grid"]) == \
            (mesh.size, mesh.size)
        _same(ref, sh)
        fleet = sh[0]


@pytest.mark.parametrize("fused", [False, True])
def test_run_scenarios_sharded_on_the_card_mesh_equals_unsharded(dev, fused):
    """Six what-if lanes (policies, backfill, a failure window, caps, a
    shift, carbon) split over the card mesh equal the unsharded batch bit
    for bit: one placement launch an entry (and one readout, fused)."""
    from repro_torch.core import scenarios as psc
    from repro_torch.runtime.fault import HostFailure
    from repro_torch.traces.carbon import make_diurnal_carbon
    from repro_torch.traces.schema import DatacenterConfig
    from repro_torch.traces.surf import SurfTraceSpec, make_surf22_like

    dc = DatacenterConfig(num_hosts=32, cores_per_host=16)
    t = 72
    w = make_surf22_like(SurfTraceSpec(days=0.25, seed=5), dc, device=dev)
    scs = [psc.Scenario(name="base"),
           psc.Scenario(name="bf", num_hosts=16, policy="best_fit", backfill_depth=2),
           psc.Scenario(name="ff", num_hosts=24, policy="first_fit"),
           psc.Scenario(name="cap", power_cap_w=5000.0,
                        failures=(HostFailure(3, 4, 24, "outage"),)),
           psc.Scenario(name="shift", shift_bins=6),
           psc.Scenario(name="cc", carbon_cap_base_w=7000.0, carbon_cap_slope=-5.0)]
    ss = psc.build_scenario_set(w, dc, scs)
    kw = dict(max_hosts=ss.max_hosts, t_bins=t, carbon_intensity=make_diurnal_carbon(t, seed=1),
              fused_readout=fused)
    mesh = _card_mesh(psc.SCENARIO_AXIS)
    ref = psc.run_scenarios(ss, **kw)
    ops.reset_launches()
    sh = psc.run_scenarios(ss, **kw, shard=True, mesh=mesh)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["des_place"] == mesh.size
    assert ops.LAUNCHES["des_readout"] == (mesh.size if fused else 0)
    _same(ref, sh)


def test_des_place_probes_launch_on_every_mesh_device(dev):
    """The barrier and decision-step probes enter their tensor's card, so
    each launches on every distinct device of the card mesh."""
    from repro_torch.kernels import des_place
    from repro_torch.parallel.sharding import lane_devices

    mesh = _card_mesh("fleet")
    for d in dict.fromkeys(lane_devices(mesh, "fleet")):
        out = torch.zeros(1, dtype=torch.int32, device=d)
        assert des_place.barrier_launch(8, 2, out) == 0
        assert des_place.step_launch(8, out) == 0
        torch.cuda.synchronize(d)


def test_mesh_entry_beyond_the_cards_raises(dev):
    from repro_torch.core.twin import fleet_mesh
    from repro_torch.parallel.sharding import make_mesh_compat

    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="card"):
        make_mesh_compat((1,), ("fleet",), devices=[f"cuda:{n}"])
    with pytest.raises(RuntimeError, match="card"):
        fleet_mesh(n + 1)
    assert fleet_mesh().size == n


def test_expert_parallel_on_a_card_mesh_equals_one_shard(dev):
    """The MoE's expert-parallel branch over ``cuda:0`` x 4 on ``("model",)``
    at a small width (16 experts, top 2, a shared expert), f32: y within
    relative L2 1e-6 of the one-shard call and aux at rtol 1e-6; over a
    2x4 ``("data", "model")`` mesh each batch block equals the one-shard
    call on that block alone."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    from repro_torch.parallel.sharding import ShardingCtx, make_mesh_compat

    cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=64, vocab=8, moe=True,
                      n_experts=16, top_k=2, moe_d_ff=32, n_shared_experts=1,
                      shared_d_ff=48, remat="none").validate()
    gen = torch.Generator(device=dev).manual_seed(5)
    p = {k: v[0] for k, v in init_params(moe.moe_specs(cfg, 1), gen, torch.float32,
                                        dev).items()}
    x = torch.randn((4, 32, 64), generator=gen, device=dev)
    y1, aux1 = moe.moe_ffn(cfg, p, x)
    mesh = make_mesh_compat((4,), ("model",), devices=[dev] * 4)
    y4, aux4 = moe.moe_ffn(cfg, p, x, ShardingCtx(mesh=mesh))
    assert float((y4 - y1).norm() / y1.norm()) <= 1e-6
    torch.testing.assert_close(aux4, aux1, rtol=1e-6, atol=0)
    mesh = make_mesh_compat((2, 4), ("data", "model"), devices=[dev] * 8)
    y8, aux8 = moe.moe_ffn(cfg, p, x, ShardingCtx(mesh=mesh))
    halves = [moe.moe_ffn(cfg, p, x[i:i + 2]) for i in (0, 2)]
    want = torch.cat([h[0] for h in halves])
    assert float((y8 - want).norm() / want.norm()) <= 1e-6
    torch.testing.assert_close(aux8, (halves[0][1] + halves[1][1]) / 2, rtol=1e-6, atol=0)


def test_kernel_ops_count_flops_alike_on_card_and_meta(dev):
    """``FlopCounterMode`` counts one flash-attention or ``ssd_chunk`` call
    by the op's registered formula on the card and on ``meta`` alike; the
    card call launches the kernel once, the meta call none."""
    from torch.utils.flop_counter import FlopCounterMode

    rng = np.random.default_rng(6)
    q = _uniform(rng, -1, 1, (2, 4, 100, 64), dev).to(BF16)
    kv = _uniform(rng, -1, 1, (2, 2, 130, 64), dev).to(BF16)
    ssd = _ssd_operands(dev)
    want_flash = ops.flash_attention_flops(2, 4, 100, 130, 64, 64, True)
    want_ssd = ops.ssd_chunk_flops(2, 24, 4, 8, 2, 16)
    for device in (dev, torch.device("meta")):
        ops.reset_launches()
        with FlopCounterMode(display=False) as fc:
            ops.flash_attention(q.to(device), kv.to(device), kv.to(device))
        assert fc.get_total_flops() == want_flash
        with FlopCounterMode(display=False) as fc:
            ops.ssd_chunk(*(t.to(device) for t in ssd))
        assert fc.get_total_flops() == want_ssd
        n = 1 if device.type == "cuda" else 0
        assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["ssd_chunk"] == n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_outputs_match_the_kernels_at_every_head_dim_pair(dev, dtype):
    """The ops' ``meta`` outputs have the shapes and dtypes of the kernels'
    own, at every ``HEAD_DIM_PAIRS`` entry and at ``chip_smoke.py``'s
    padded pairs (with and without the lse) and for ``ssd_chunk``."""
    from repro_torch.kernels.flash_attention import HEAD_DIM_PAIRS

    dt = getattr(torch, dtype)
    for d, dv in HEAD_DIM_PAIRS + _chip_smoke().PADDED_FLASH_PAIRS:
        q = torch.randn((2, 4, 40, d), device=dev).to(dt)
        k = torch.randn((2, 2, 56, d), device=dev).to(dt)
        v = torch.randn((2, 2, 56, dv), device=dev).to(dt)
        for lse in (False, True):
            got = ops.flash_attention(q, k, v, return_lse=lse)
            fake = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                       return_lse=lse)
            got, fake = (got, fake) if lse else ((got,), (fake,))
            assert [(tuple(t.shape), t.dtype) for t in got] == \
                [(tuple(t.shape), t.dtype) for t in fake], (d, dv, lse)
            assert all(t.device.type == "meta" for t in fake)
    ssd = _ssd_operands(dev)
    got = ops.ssd_chunk(*ssd)
    fake = ops.ssd_chunk(*(t.to("meta") for t in ssd))
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in fake]


def test_alltoall_charge_on_meta_matches_the_card(dev):
    """A redistribute from a split of the columns to one of the rows over
    an axis of 16 (an all-to-all: MiniCPM3's embedding rows in the dry-run)
    gives the card a tensor of its own, no slice of a larger buffer, and
    ``trace_cost`` charges it the same largest storage and live peak on
    ``cuda:0`` shards as on ``meta`` shards."""
    from torch.distributed.tensor import Shard

    from repro_torch.analysis.cost import trace_cost
    from repro_torch.parallel import sharding
    from repro_torch.parallel.sharding import P, NamedSharding

    got = {}
    try:
        for where in (dev, torch.device("meta")):
            mesh = sharding.make_mesh_compat((16,), ("data",), devices=[where] * 16)
            x = sharding.distribute(torch.zeros((64, 256, 320), dtype=BF16, device=where),
                                    NamedSharding(mesh, P(None, None, "data")))
            out = trace_cost(lambda: x.redistribute(x.device_mesh, [Shard(0)]))
            local = out["out"].to_local()
            assert tuple(local.shape) == (4, 256, 320)
            if where.type == "cuda":
                assert local.untyped_storage().nbytes() == local.nbytes
            got[where.type] = (out["largest_alloc"], out["peak_live_bytes"],
                               out["collective_counts"])
            sharding.close_fake_world()
    finally:
        sharding.close_fake_world()
    assert got["cuda"] == got["meta"], got
    assert got["meta"][1] == 4 * 256 * 320 * 2
