#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port of the twin on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(``--profile`` adds a ``torch.profiler`` trace of the DES and of the
calibrated E2 run: device busy time, idle share, top kernels.)

Phases (each passes or the script exits non-zero without a result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones, and run the calibration kernel
   twice for bitwise-equal results;
4. drive the port's main path, experiment E2 at the paper's SURF-SARA size
   (277 hosts x 16 cores, 7 days, seed 22): uncalibrated, calibrated
   (r only) and joint calibration with one refine round, with the kernels'
   launch counts reset just before and read just after;
5. rerun the calibrated experiment on the CPU and require that the DES
   schedule the twin predicted from and the parameter stream equal the
   card run's own, and the MAPE stream within rtol 1e-5;
6. time each kernel and its plain version at the main path's shapes
   (device time, median of 5 rounds of up to 20 calls, with the
   rounds' spread).

The second-to-last line of standard output is the ``kernels`` JSON record,
the last line ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  The script needs no network and starts
no process that outlives it (``nvcc`` and ``nvidia-smi`` are waited for).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

#: experiment E2 at the paper's size
E2_DAYS = 7.0
E2_SEED = 22


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class DeviceTimer:
    """Per-call times on the card, with CUDA events.

    ``device_ms`` keeps the queue full: a spin kernel (``torch.cuda._sleep``)
    runs while the host enqueues the timed calls, so the events bracket the
    device's work alone, not the host's launch overhead.  A round counts
    only if the card was still spinning when the last call had been queued.
    Otherwise host gaps could count as device time: the spin was too short,
    or the calls held more launches than the stream's queue takes, so that
    the host waited for the spin to end.  Such a round is repeated with a
    spin twice as long and half as many calls.  ``wall_ms`` is the caller's
    view: host time per call up to a synchronize.
    """

    #: repeated rounds before the timer gives up on keeping the queue ahead
    MAX_RETRIES = 8

    def __init__(self, torch):
        self.torch = torch
        torch.cuda._sleep(1000)          # load the spin kernel before timing it
        torch.cuda.synchronize()
        start, end = self._events()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = 10_000_000 / start.elapsed_time(end)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def wall_ms(self, fn, reps: int = 20) -> float:
        fn()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        self.torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def device_ms(self, fn, reps: int = 20, rounds: int = 5) -> dict:
        """Device ms per call: the median over ``rounds`` rounds, with the
        least and greatest round, the calls per round and the retries."""
        spin_ms = 2.0 * reps * self.wall_ms(fn, reps=3) + 0.1   # warm-up too
        times, retries = [], 0
        while len(times) < rounds:
            start, end = self._events()
            self.torch.cuda._sleep(int(spin_ms * self.cycles_per_ms))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            covered = not start.query()      # still behind the spin?
            self.torch.cuda.synchronize()
            if covered:
                times.append(start.elapsed_time(end) / reps)
                continue
            retries += 1
            if retries > self.MAX_RETRIES:
                fail(f"device timer: the spin ran out before the host had "
                     f"queued {reps} call(s), {retries} times")
            spin_ms *= 2.0
            reps = max(1, reps // 2)
        return dict(ms=statistics.median(times), min_ms=min(times),
                    max_ms=max(times), reps=reps, retries=retries)


def calib_inputs(torch, np, b, t, h, c, seed, device):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
    u = f(rng.uniform(0.0, 1.0, (b, t, h)))
    real = f(rng.uniform(1e3, 5e3, (b, t)) * max(h / 4.0, 1.0))
    pi = f(rng.uniform(50, 90, c))
    pm = f(rng.uniform(250, 450, c))
    r = f(rng.uniform(1, 6, c))
    return u, real, pi, pm, r


def readout_case(torch, np, t, h, seed, device):
    """Readout operands at ``[t, h]`` with every scenario axis active."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    u = f(rng.uniform(0.0, 1.15, (t, h)))
    kw = dict(p_idle=f(rng.uniform(40.0, 90.0, h)),
              p_max=f(rng.uniform(200.0, 420.0, h)),
              r=float(rng.uniform(1.2, 3.4)),
              peak_tflops=float(rng.uniform(100.0, 500.0)))
    rough = float(kw["p_idle"].sum() + 0.4 * kw["p_max"].sum())
    fs = np.where(rng.uniform(size=h) < 0.4, rng.integers(0, t, h),
                  np.iinfo(np.int32).max).astype(np.int32)
    fe = np.minimum(fs.astype(np.int64) + rng.integers(3, max(t // 2, 4), h),
                    np.iinfo(np.int32).max).astype(np.int32)
    kw.update(
        mask=torch.as_tensor(rng.uniform(size=h) < 0.8, device=device),
        cap_t=f(rng.uniform(0.5 * rough, 1.1 * rough, t)),
        intensity=f(rng.uniform(50.0, 600.0, t)),
        fail_start=torch.as_tensor(fs, device=device),
        fail_end=torch.as_tensor(fe, device=device),
        fail_kill=torch.as_tensor(rng.uniform(size=h) < 0.7, device=device),
        pue_base=float(rng.uniform(1.05, 1.4)),
        pue_amb_coeff=float(rng.uniform(0.0, 0.05)),
        pue_amb_ref=float(rng.uniform(10.0, 22.0)),
        pue_load_coeff=float(rng.uniform(0.0, 0.25)),
        ambient=f(rng.uniform(-5.0, 38.0, t)),
        price=f(rng.uniform(-0.05, 0.45, t)))
    return u, kw


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail(f"the port's package is missing under {SRC}")
    sys.path.insert(0, str(SRC))

    import numpy as np

    from repro_torch.core import CalibrationSpec, OrchestratorConfig
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.traces.schema import DatacenterConfig
    from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like

    dev = torch.device("cuda")
    details: dict = {}

    # 1) the card
    card = card_line()
    log(f"card: {card}")
    details["card"] = card
    details["torch"] = torch.__version__
    details["cuda"] = torch.version.cuda

    # 2) build the kernels (one nvcc per source, all started together)
    t0 = time.time()
    try:
        _build.build()
    except (RuntimeError, OSError) as e:
        fail(f"kernel build: {e}")
    build_s = time.time() - t0
    log(f"build: {build_s:.1f} s")
    details["build_seconds"] = build_s
    details["ptxas"] = dict(_build.BUILD_LOG)

    # 3) each kernel against its plain version on the card
    errs: dict[str, float] = {"calib_mape_grid": 0.0, "des_readout": 0.0}
    for (b, t, h, c) in [(1, 144, 277, 64), (1, 144, 277, 9216),
                         (277, 144, 1, 64), (1, 97, 33, 130), (3, 300, 2500, 5)]:
        args = calib_inputs(torch, np, b, t, h, c, seed=b + t + h + c, device=dev)
        got = ops.calib_mape_grid(*args)
        torch.cuda.synchronize()
        want = ref.calib_mape_grid_ref(*args)
        again = ops.calib_mape_grid(*args)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
            fail(f"calib_mape_grid {(b, t, h, c)}: max |err| "
                 f"{float((got - want).abs().max())} beyond rtol 1e-4 atol 1e-3")
        if not torch.equal(got, again):
            fail(f"calib_mape_grid {(b, t, h, c)}: two runs differ bitwise")
        err = float((got - want).abs().max())
        errs["calib_mape_grid"] = max(errs["calib_mape_grid"], err)
        log(f"calib_mape_grid B={b} T={t} H={h} C={c}: max |err| {err:.3g} "
            "(rtol 1e-4, atol 1e-3), bitwise repeatable")
    zero_real = torch.zeros((1, 144), device=dev)
    u0, _, pi0, pm0, r0 = calib_inputs(torch, np, 1, 144, 277, 64, 0, dev)
    if not torch.isnan(ops.calib_mape_grid(u0, zero_real, pi0, pm0, r0)).all():
        fail("calib_mape_grid: an all-zero real window must give NaN")

    for (t, h) in [(36, 277), (97, 13), (2016, 277)]:
        for model in ("opendc", "linear", "sqrt", "cubic"):
            for precision in ("f32", "bf16"):
                u, kw = readout_case(torch, np, t, h, seed=t + h, device=dev)
                got = ops.des_readout(u, model=model, precision=precision, **kw)
                torch.cuda.synchronize()
                pu, operands = ops.pack_readout(u, model=model,
                                                precision=precision, **kw)
                want = ref.des_readout_ref(pu, **operands)
                for k in ref.READOUT_FIELDS:
                    g = got[k].double()
                    w = want[k].double()
                    if precision == "bf16" and k in ("tflops", "efficiency"):
                        tol = 2.0 ** -8 * w.abs()    # one bf16 ulp
                    else:
                        tol = 1e-5 * w.abs() + 1e-6
                    bad = (g - w).abs() > tol
                    if bool(bad.any()):
                        fail(f"des_readout {(t, h)} {model}/{precision} {k}: "
                             f"max |err| {float((g - w).abs().max())}")
                    if precision == "f32":
                        errs["des_readout"] = max(errs["des_readout"],
                                                  float((g - w).abs().max()))
        log(f"des_readout T={t} H={h}: 4 models x 2 precisions x 9 leaves "
            "within rtol 1e-5 atol 1e-6 (bf16 perf leaves within one bf16 ulp), "
            "every axis on")

    # 4) the main path: E2 at full size, kernels counted
    dc = DatacenterConfig()
    t_bins = int(E2_DAYS * BINS_PER_DAY)
    w = make_surf22_like(SurfTraceSpec(days=E2_DAYS, seed=E2_SEED), dc, device=dev)
    log(f"E2 workload: {w.num_jobs} jobs, {dc.num_hosts} hosts x "
        f"{dc.cores_per_host} cores, {t_bins} bins")
    joint_cfg = OrchestratorConfig(
        calibration=CalibrationSpec(mode="joint", refine_iters=1))
    runs, sims = {}, {}
    ops.reset_launches()
    t_main = time.time()
    for name, cal, cfg in (("uncalibrated", False, None),
                           ("calibrated", True, None),
                           ("joint", True, joint_cfg)):
        t0 = time.time()
        res, sims[name] = e2_run(w, dc, t_bins, calibrate=cal, cfg=cfg,
                                 device="cuda")
        wall = time.time() - t0
        runs[name] = res
        rep = res.slo_reports[0]
        per_win = float(np.mean([r.sim_seconds for r in res.records]))
        if not (np.isfinite(res.overall_mape) and len(res.records) == t_bins // 36):
            fail(f"E2 {name}: bad result (MAPE {res.overall_mape}, "
                 f"{len(res.records)} windows)")
        log(f"E2 {name}: MAPE {res.overall_mape:.6f} %, NFR1 compliance "
            f"{rep.compliance:.4f} (met={rep.met}), {per_win * 1e3:.3f} ms per "
            f"window, DES {res.des_seconds:.3f} s, wall {wall:.2f} s")
        details[f"e2_{name}"] = dict(
            overall_mape=res.overall_mape, nfr1_compliance=rep.compliance,
            nfr1_met=rep.met, under_estimation=res.under_estimation_fraction,
            seconds_per_window=per_win, des_seconds=res.des_seconds,
            wall_seconds=wall,
            per_window_mape=[float(x) for x in res.per_window_mape])
    launches = dict(ops.LAUNCHES)
    details["main_path_seconds"] = time.time() - t_main
    details["main_path_launches"] = launches
    log(f"main path launches: {launches}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    if not runs["calibrated"].overall_mape < runs["uncalibrated"].overall_mape:
        fail("E2: calibration did not lower the MAPE")

    # 5) the calibrated run again on the CPU: the schedule its windows were
    # predicted from and its parameter stream equal the card run's own
    t0 = time.time()
    cpu, sim_cpu = e2_run(w.to("cpu"), dc, t_bins, calibrate=True, cfg=None,
                          device="cpu")
    gpu, sim_gpu = runs["calibrated"], sims["calibrated"]
    for k in ("job_start", "job_host", "queue_len", "running"):
        if not torch.equal(getattr(sim_gpu, k).cpu(), getattr(sim_cpu, k)):
            fail(f"DES {k}: card and CPU schedules differ")
    for f in ("p_idle", "p_max", "r"):
        a = np.array([float(getattr(r.params, f)) for r in gpu.records])
        b = np.array([float(getattr(r.params, f)) for r in cpu.records])
        if not np.array_equal(a, b):
            fail(f"parameter stream {f}: card and CPU differ")
    if not np.allclose(gpu.per_window_mape, cpu.per_window_mape, rtol=1e-5,
                       atol=0.0, equal_nan=True):
        fail("MAPE stream: card and CPU beyond rtol 1e-5")
    u_equal = bool(torch.equal(sim_gpu.u_th.cpu(), sim_cpu.u_th))
    log(f"CPU rerun: schedule and parameter stream equal, MAPE stream within "
        f"rtol 1e-5 (max rel {float(np.nanmax(np.abs(gpu.per_window_mape - cpu.per_window_mape) / np.abs(cpu.per_window_mape))):.3g}), "
        f"u_th bitwise equal: {u_equal}, {time.time() - t0:.1f} s")
    details["cpu_rerun_u_th_bitwise"] = u_equal

    # 6) kernel times at the main path's shapes (device time, queue kept full)
    timer = DeviceTimer(torch)
    kernels, shapes = [], {}
    calib_lib = _build.load("calib_mape")
    readout_lib = _build.load("des_readout")
    stream = torch.cuda.current_stream().cuda_stream

    def timed(kernel, plain, **extra):
        k, p = timer.device_ms(kernel), timer.device_ms(plain)
        return dict(ms=k["ms"], plain_ms=p["ms"], kernel_rounds=k,
                    plain_rounds=p, **extra)

    def calib_case(b, t, h, c):
        u, real, pi, pm, r = calib_inputs(torch, np, b, t, h, c, 1, dev)
        out = torch.empty((b, c), device=dev)

        def kernel():
            if calib_lib.calib_mape_grid_launch(
                    u.data_ptr(), real.data_ptr(), pi.data_ptr(), pm.data_ptr(),
                    r.data_ptr(), out.data_ptr(), b, t, h, c, stream) != 0:
                fail("calib_mape_grid: the timed launch returned a CUDA error")

        return timed(
            kernel, lambda: ref.calib_mape_grid_ref(u, real, pi, pm, r),
            wrapper_wall_ms=timer.wall_ms(lambda: ops.calib_mape_grid(u, real, pi, pm, r)),
            bytes=4 * (b * t * h + b * t + 3 * c + b * c),
            ops=3 * b * t * h * c + 8 * b * t * c + 4 * b * t * h)

    def readout_case_timed(t, h):
        # the main path's operands: scalar params broadcast, no scenario axis
        call = dict(p_idle=70.0, p_max=350.0, r=2.0, peak_tflops=dc.peak_tflops)
        u, operands = ops.pack_readout(torch.rand((t, h), device=dev), **call)
        rows = [operands[k] for k in ("p_idle", "p_max", "r", "mask", "fail_start",
                                      "fail_end", "fail_kill", "cap", "intensity",
                                      "ambient", "price")]
        out = torch.empty((len(ref.READOUT_FIELDS), t), device=dev)

        def kernel():
            if readout_lib.des_readout_launch(
                    u.data_ptr(), *(x.data_ptr() for x in rows), out.data_ptr(), t, h,
                    0, 0, operands["peak_tflops"], 1.0, 0.0, 0.0, 18.0,
                    operands["dt_seconds"] / 3600.0, stream) != 0:
                fail("des_readout: the timed launch returned a CUDA error")

        return timed(
            kernel, lambda: ref.des_readout_ref(u, **operands),
            wrapper_wall_ms=timer.wall_ms(lambda: ops.des_readout(u, **call)),
            bytes=4 * (t * h + 7 * h + 4 * t + 9 * t),
            ops=14 * t * h + 30 * t)

    main = calib_case(1, 144, 277, 64)      # E2 calibration: 4 windows x 36 bins
    main_shapes = [main]
    kernels.append(dict(
        name="calib_mape_grid", route="cuda",
        source="src/repro_torch/kernels/csrc/calib_mape.cu",
        replaces="src/repro/kernels/calib_mape.py:79",
        launches=launches["calib_mape_grid"],
        max_abs_err=errs["calib_mape_grid"], ms=main["ms"],
        plain_ms=main["plain_ms"], **bound(main["bytes"], main["ops"]),
        library_ms=None))
    shapes["calib B=1 T=144 H=277 C=64 (E2 r_only)"] = main
    shapes["calib B=1 T=144 H=277 C=9216 (E2 joint)"] = calib_case(1, 144, 277, 9216)
    shapes["calib B=277 T=144 H=1 C=64 (per-host refit)"] = calib_case(277, 144, 1, 64)
    main = readout_case_timed(36, 277)      # E2 prediction window
    main_shapes.append(main)
    kernels.append(dict(
        name="des_readout", route="cuda",
        source="src/repro_torch/kernels/csrc/des_readout.cu",
        replaces="src/repro/kernels/des_readout.py:202",
        launches=launches["des_readout"],
        max_abs_err=errs["des_readout"], ms=main["ms"],
        plain_ms=main["plain_ms"], **bound(main["bytes"], main["ops"]),
        library_ms=None))
    shapes["readout T=36 H=277 (E2 window)"] = main
    shapes["readout T=2016 H=277 (E2 horizon)"] = readout_case_timed(2016, 277)
    for v in shapes.values():
        v.update(bound(v["bytes"], v["ops"]))
    for row, v in zip(kernels, main_shapes):
        k, p = v["kernel_rounds"], v["plain_rounds"]
        log(f"{row['name']}: {row['ms'] * 1e3:.2f} us (rounds {k['min_ms'] * 1e3:.2f}-"
            f"{k['max_ms'] * 1e3:.2f}; bound {row['bound_ms'] * 1e3:.3f} us, by "
            f"{row['bound_by']}), plain {row['plain_ms'] * 1e3:.2f} us (rounds "
            f"{p['min_ms'] * 1e3:.2f}-{p['max_ms'] * 1e3:.2f}, {p['reps']} calls "
            f"per round, {p['retries']} retries), {row['launches']} launches on the main path")
    for k, v in shapes.items():
        log(f"extra shape {k}: {json.dumps(v)}")
    details["kernels"] = kernels
    details["shapes"] = shapes

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if "--profile" in sys.argv[1:]:
        details["profile"] = profile_e2(torch, w, dc, t_bins)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def e2_run(w, dc, t_bins, *, calibrate, cfg, device):
    """``run_surf_experiment`` spelled out through the ``DigitalTwin``
    facade, so that the twin's own DES output (the schedule its windows
    were predicted from) can be read: returns the result and that output."""
    from repro_torch.core import DigitalTwin, OrchestratorConfig, TraceGroundTruth

    cfg = dataclasses.replace(cfg or OrchestratorConfig(), calibrate=calibrate,
                              device=device)
    twin = DigitalTwin(w, dc, t_bins, cfg)
    truth = TraceGroundTruth(twin.orchestrator.workload, dc, t_bins)
    return twin.run(truth.window), twin.orchestrator._ensure_sim()


def profile_e2(torch, w, dc, t_bins) -> dict:
    """Device busy time of the E2 calibrated run (``--profile`` only).

    ``torch.profiler`` traces the DES and the 56-window loop separately; the
    device's busy share is the summed device time of its kernels and copies
    over the host's wall time.
    """
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import DigitalTwin, OrchestratorConfig, TraceGroundTruth
    from repro_torch.core.desim import simulate_utilization

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                rows.append((ev.key, dev_us, ev.count))
        rows.sort(key=lambda x: -x[1])
        busy = sum(r[1] for r in rows) / 1e6
        return dict(wall_s=wall, device_busy_s=busy,
                    device_idle_share=1.0 - busy / wall if wall else None,
                    top=[dict(name=k[:80], device_ms=v / 1e3, count=n)
                         for k, v, n in rows[:12]])

    twin = DigitalTwin(w, dc, t_bins, OrchestratorConfig(device="cuda"))
    truth = TraceGroundTruth(w, dc, t_bins)
    twin.orchestrator._ensure_sim()       # the DES is traced on its own
    out = dict(
        des=traced(lambda: simulate_utilization(
            w, num_hosts=dc.num_hosts, cores_per_host=dc.cores_per_host,
            t_bins=t_bins)),
        calibrated_windows=traced(lambda: twin.run(truth.window)))
    for name, v in out.items():
        log(f"profile {name}: wall {v['wall_s']:.3f} s, device busy "
            f"{v['device_busy_s']:.4f} s, idle share {v['device_idle_share']:.4f}")
        for row in v["top"][:6]:
            log(f"    {row['device_ms']:.3f} ms x{row['count']}  {row['name']}")
    return out


def bound(n_bytes: float, n_ops: float) -> dict:
    """Least time for the work: bytes over HBM rate vs f32 ops over peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


if __name__ == "__main__":
    sys.exit(main())
