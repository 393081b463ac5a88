"""End-to-end driver on the PyTorch port: train an LM while the twin
watches the training cluster.

The counterpart of ``examples/live_twin_training.py``, with its flags
(plus ``--device``), windows, output lines and closing checks.  The
*physical twin* is the training job itself: every step emits telemetry
(step time, utilization, measured power from the host's meter,
synthesized from a hidden drifting power model, as in E1/E2).  The digital
twin ingests windows of telemetry, self-calibrates its power model
(``SelfCalibrator.observe`` runs the ``calib_mape_grid`` kernel on the
card), predicts the next window, and feeds SLO-aware proposals (straggler
restarts) through the HITL gate.  A mid-run crash is injected; training
restarts from the checkpoint WITH the twin's calibration state intact.

    PYTHONPATH=src python examples/live_twin_training_torch.py --steps 300
    PYTHONPATH=src python examples/live_twin_training_torch.py --device cpu --steps 50

Without ``--device cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.calibrate import CalibrationSpec, SelfCalibrator
from repro_torch.core.feedback import HITLGate
from repro_torch.core.power import PowerParams, mape, opendc_power
from repro_torch.core.slo import NFR1, SLOMonitor
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.launch.steps import make_train_step, param_specs_for
from repro_torch.launch.train import reduce_config
from repro_torch.models.common import init_params, spec_param_count
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.fault import FailureInjector, FaultConfig, run_with_restarts
from repro_torch.runtime.straggler import StragglerConfig, StragglerDetector

VIRTUAL_HOSTS = 4          # telemetry is reported per virtual worker
WINDOW_STEPS = 25          # steps per window of operation


class HostMeter:
    """Hidden power model of the training hosts (the 'measured reality')."""

    def __init__(self, seed: int = 9):
        self.rng = np.random.default_rng(seed)
        self.t = 0

    def read(self, utilization: float) -> float:
        # slow drift + noise, unknown to the twin (cf. traces/surf.py)
        r_true = 1.6 + 0.9 * min(self.t / 400.0, 1.0)
        self.t += 1
        p = float(opendc_power(torch.tensor([utilization], dtype=torch.float32),
                               PowerParams(72.0, 360.0, r_true))[0])
        return p * VIRTUAL_HOSTS * (1 + self.rng.normal(0, 0.03))


@dataclasses.dataclass
class LiveTwinResult:
    report: object                # the RunReport
    losses: list[float]
    window_mapes: list[float]
    proposals: list
    nfr1: object                  # the SLOReport


def main(argv=None) -> LiveTwinResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--reduce", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--fail-at", type=int, default=150)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "live_twin_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = reduce_config(get_config(args.arch), args.reduce)
    n_params = spec_param_count(param_specs_for(cfg))
    print(f"training {cfg.name} reduced x{args.reduce}: "
          f"{n_params/1e6:.1f}M params, {args.steps} steps "
          f"(crash injected at step {args.fail_at})", flush=True)

    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps)
    train = make_train_step(cfg, opt_cfg)
    pipe = TokenPipeline(DataConfig(cfg.vocab, args.seq, args.batch), device=dev)

    # -- digital twin side ---------------------------------------------------
    meter = HostMeter()
    calibrator = SelfCalibrator(CalibrationSpec(), PowerParams(), device=dev,
                                history_windows=3)
    monitor = SLOMonitor([NFR1])
    gate = HITLGate(policy=lambda p: True)     # auto-approve for the demo
    detector = StragglerDetector(VIRTUAL_HOSTS,
                                 StragglerConfig(min_samples=2, hysteresis=2))
    wrng = np.random.default_rng(4)
    telemetry = {"u": [], "p": [], "t": []}
    window_mapes: list[float] = []
    proposals = []
    best_step_t = [np.inf]

    def on_step(step: int, step_seconds: float) -> None:
        best_step_t[0] = min(best_step_t[0], step_seconds)
        util = float(np.clip(best_step_t[0] / step_seconds, 0.05, 1.0))
        telemetry["u"].append(util)
        telemetry["p"].append(meter.read(util))
        telemetry["t"].append(step_seconds)
        if (step + 1) % WINDOW_STEPS == 0:
            w = (step + 1) // WINDOW_STEPS - 1
            u = np.array(telemetry["u"][-WINDOW_STEPS:], np.float32)
            p = np.array(telemetry["p"][-WINDOW_STEPS:])
            u_th = torch.as_tensor(np.repeat(u[:, None], VIRTUAL_HOSTS, 1), device=dev)
            real = torch.as_tensor(p, dtype=torch.float32, device=dev)
            # twin predicts the window with the PREVIOUS calibration
            params = calibrator.params_for_next()
            pred = opendc_power(u_th, params).sum(1)
            m = float(mape(real, pred))
            window_mapes.append(m)
            monitor.observe("mape", [m])
            calibrator.observe(u_th, p)
            # per-host step times; host 2 degrades in the second half
            t_hosts = np.repeat(np.median(telemetry["t"][-WINDOW_STEPS:]),
                                VIRTUAL_HOSTS) * (1 + wrng.normal(
                                    0, 0.02, VIRTUAL_HOSTS))
            if step > args.steps * 0.55:
                t_hosts[2] *= 1.6
            fired = detector.observe(t_hosts, w)
            for prop in fired:
                gate.submit(prop)
            proposals.extend(gate.drain())
            if os.environ.get("TWIN_DEBUG"):
                print(f"    [dbg] w={w} t_hosts={np.round(t_hosts,3)} "
                      f"streak={detector.slow_streak} fired={len(fired)}",
                      flush=True)
            print(f"  [twin] window {w:2d} MAPE {m:5.2f}%  "
                  f"r={float(calibrator.params_for_next().r):.2f} "
                  f"util {u.mean():.2f}", flush=True)

    # -- training loop with fault tolerance -----------------------------------
    def make_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(param_specs_for(cfg), gen, getattr(torch, cfg.dtype), dev)
        return {"params": params, "opt": init_opt_state(params, opt_cfg),
                "twin_r": np.asarray(2.0)}

    losses = []

    def step_fn(state, step):
        t0 = time.perf_counter()
        batch = pipe.global_batch(step)
        params, opt, metrics = train(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        on_step(step, dt)
        if step % 25 == 0:
            print(f"step {step:4d} loss {loss:.4f} ({dt*1e3:.0f} ms)",
                  flush=True)
        # twin calibration state rides along in the job state
        return {"params": params, "opt": opt,
                "twin_r": np.asarray(float(calibrator.params_for_next().r))}, loss

    report = run_with_restarts(
        total_steps=args.steps,
        make_state=make_state,
        step_fn=step_fn,
        fault_cfg=FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50),
        injector=FailureInjector((args.fail_at,)),
    )

    print("\n=== summary ===")
    print(f"steps: {report.steps_done}  restarts: {report.restarts} "
          f"(restored from {report.restored_from})")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"twin windows: {len(window_mapes)}; "
          f"MAPE first/last: {window_mapes[0]:.2f}% / {window_mapes[-1]:.2f}%")
    rep = monitor.report()[0]
    print(f"NFR1: {rep.compliance:.1%} compliant -> "
          f"{'MET' if rep.met else 'MISSED'}")
    stragglers = [p for p in proposals
                  if p.kind.value == "restart_straggler"]
    print(f"straggler proposals approved: {len(stragglers)} "
          f"(host {stragglers[0].impact['host'] if stragglers else '-'})")
    assert report.restarts >= 1 and report.steps_done == args.steps
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    return LiveTwinResult(report, losses, window_mapes, proposals, rep)


if __name__ == "__main__":
    main()
