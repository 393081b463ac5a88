#!/usr/bin/env python3
"""Kernel time of ``des_readout``, ``power_sim``, ``des_place`` and ``flash_attention`` for checkouts of the port, in turns, on one card.

Run from the repository root with the roots of the checkouts to compare,
for example a parent commit unpacked into a directory that ``.gitignore``
lists (``git archive``) and this tree, in the order parent, this, this,
parent:

    python3 kernel_compare.py build/parent . . build/parent

Each argument runs in a process of its own, with that checkout's ``src/``
first on the path and its own kernel build, on the same seeded work:
the readout at ``chip_smoke.READOUT_TIMED``'s shapes (A and B as the twin
calls it: ``u [T, H]`` and scalar parameters; C and D with per-lane rows,
caps and scalars, ``chip_smoke.lanes_case``, on a random field) and
``power_sim`` at ``(2016, 277)`` with ``chip_smoke.POWER_KW``, and
``des_place`` at ``chip_smoke.place_cases``' E2 horizon, C and D.  Every
call goes through the checkout's own ``ops.des_readout``, ``ops.power_sim``
and ``ops.des_place``; a checkout whose readout takes no lane axis (it
raises on ``[S, T, H]``) makes S calls of ``[T, H]``, one lane each.

The time of a call is the device time of the kernels whose name holds
the kernel's, in a ``torch.profiler`` trace of ``--reps`` calls (of one
call where a call launches that many kernels): so the wrapper's host
work and the gaps between S launches do not count, and two designs
compare kernel against kernel.  ``--rounds`` traces give the median
round, the least and the greatest; the checkout's ``ops.LAUNCHES`` gives
the launches a call.  ``des_place`` is timed with CUDA events instead
(``chip_smoke.DeviceTimer``: the median of ``--rounds`` rounds of 5 calls,
the wrapper's scratch zeroing and packing included), since a trace of
the DES has lost its launch; its schedules' sums are printed beside, so
that the checkouts are seen to place alike.

``flash_attention``: the checkout's flash source is built alone (its
seconds, and the ``ptxas`` registers, stack and spills of each kernel
where it was not built before); every ``chip_smoke.FLASH_CASES`` case
whose head-dim pair the checkout takes (it raises ``ValueError`` on the
others) runs on ``chip_smoke.flash_inputs`` with the lse, and a digest of
its out and lse bytes is kept; the prefill shapes of ``FLASH_TIMED``
(bf16, causal) are timed with CUDA events as ``des_place`` is (traces of
the flash kernel lost launches: 18 of 20, eleven times in a row on an
H100), each beside its bound (``ops.flash_attention_flops`` over the bf16
tensor-core peak).  At the
end the digests of every case that two checkouts both ran must be equal,
bit for bit, or the script exits 1.

One JSON line per checkout.  The script needs a card: without one it
exits 2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent

#: power_sim's shape: the E2 horizon
POWER_SHAPE = (2016, 277)

#: traces taken again a shape, at most, where one lost a launch
MAX_RETRIES = 10

#: the readout's operands that ``chip_smoke.lanes_case`` shares between lanes
SHARED = ("intensity", "ambient", "price")

#: ``chip_smoke.place_cases`` labels timed for des_place, by the label's start
PLACE_TIMED = ("E2 week, the main path's", "C:", "D:")

#: flash prefill shapes timed, (b, hq, hkv, s, d, dv), bf16, causal: the
#: exact pairs of SmolLM-360M, MiniCPM3-4B and DeepSeek-V2-Lite at [4,
#: 2048] (``chip_smoke.PREFILL_FLASH*``), then padded pairs: MiniCPM3-4B and
#: StableLM-3B at --reduce 2, DeepSeek-V2-Lite at --reduce 4, and the
#: widest instantiation
FLASH_TIMED = ((4, 15, 5, 2048, 64, 64), (4, 40, 40, 2048, 96, 64),
               (4, 16, 16, 2048, 192, 128), (4, 20, 20, 2048, 48, 32),
               (4, 16, 16, 2048, 40, 40), (4, 4, 4, 2048, 48, 32),
               (4, 8, 8, 2048, 256, 256))


def kernel_us(torch, ops, fn, name: str, reps: int, rounds: int) -> dict:
    """Device us a call of ``fn`` in the kernels whose name holds ``name``:
    the median of ``rounds`` traces, the least and the greatest, and the
    launches a call, as the checkout's ``ops.LAUNCHES[name]`` counts them.
    A trace holds ``reps`` calls, or one where a call launches ``reps``
    kernels or more.  A trace that lost a launch (a trace on an H100 lost
    18 of 20) is taken again, up to ``MAX_RETRIES`` times a shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = ops.LAUNCHES[name]
    fn()
    torch.cuda.synchronize()
    launches = ops.LAUNCHES[name] - before
    reps = max(1, reps // launches)
    times, retries = [], 0
    while len(times) < rounds:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)), e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        seen = sum(n for _, n in rows)
        if seen == launches * reps:
            times.append(sum(us for us, _ in rows) / reps)
            continue
        retries += 1
        if retries > MAX_RETRIES:
            raise RuntimeError(f"{name}: a trace held {seen} of {launches * reps} "
                               f"launches, {retries} times")
    return dict(us=statistics.median(times), min_us=min(times), max_us=max(times),
                launches=launches, reps=reps, retries=retries)


def ptxas_rows(report: str) -> list:
    """``[kernel, stack bytes, spill stores, spill loads, registers]`` of
    each flash kernel in a ``-Xptxas -v`` report (a padded instantiation
    named so)."""
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"flash_(bf16|f32)_kernelILi(\d+)ELi(\d+)E(?:Lb([01])E)?", m.group(1))
            name = (f"{k.group(1)} ({k.group(2)}, {k.group(3)})"
                    f"{' padded' if k.group(4) == '1' else ''}") if k else m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows.append([name, *map(int, m.groups())])
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1].append(int(m.group(1)))
    return rows


def flash(torch, np, cs, ops, build, timer, reps: int, rounds: int) -> dict:
    """The checkout's flash kernel: its build, a digest of each
    ``FLASH_CASES`` case it takes, and ``FLASH_TIMED``'s device times."""
    t0 = time.time()
    build.build(("flash_attention",))
    out: dict = {"build_seconds": time.time() - t0, "digests": {}, "timed": {}}
    if "flash_attention" in build.BUILD_LOG:
        out["ptxas"] = ptxas_rows(build.BUILD_LOG["flash_attention"])
    dev = torch.device("cuda")
    for i, case in enumerate(cs.FLASH_CASES):
        q, k, v = cs.flash_inputs(torch, np, i, dev)
        try:
            o, lse = ops.flash_attention(q, k, v, causal=case[7], return_lse=True)
        except ValueError:          # a head-dim pair this checkout refuses
            continue
        digest = hashlib.sha256(o.float().cpu().numpy().tobytes())
        digest.update(lse.float().cpu().numpy().tobytes())
        out["digests"][str(case[:9])] = digest.hexdigest()[:16]
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, hq, hkv, s, d, dv in FLASH_TIMED:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv)))
        before = ops.LAUNCHES["flash_attention"]
        try:
            ops.flash_attention(q, k, v, causal=True)
        except ValueError:
            continue
        launches = ops.LAUNCHES["flash_attention"] - before
        stat = timer.device_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                               reps=reps, rounds=rounds)
        stat["launches"] = launches
        stat["bound_ms"] = (ops.flash_attention_flops(b, hq, s, s, d, dv, True)
                            / cs.PEAK_BF16_TC_FLOPS * 1e3)
        out["timed"][str((b, hq, hkv, s, d, dv))] = stat
    return out


def one(root: pathlib.Path, reps: int, rounds: int) -> dict:
    """The kernels through ``root``'s port on the same work."""
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops

    _build.build(("des_readout", "power_sim", "des_place"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    field = torch.as_tensor(rng.uniform(0.0, 1.15, (2016, 277)).astype(np.float32),
                            device=dev)
    out: dict = {"root": str(root), "readout": {}}
    for label, (s, t, h) in cs.READOUT_TIMED.items():
        if s == 1:
            u = field[:t, :h].contiguous()
            calls = [(u, dict(p_idle=70.0, p_max=350.0, r=2.0, peak_tflops=120.0))]
        else:   # lane i's window moved by 36 bins, as chip_smoke.py's C and D
            bins = (torch.arange(t, device=dev)[None, :]
                    + 36 * torch.arange(s, device=dev)[:, None]) % field.shape[0]
            u = field[bins][:, :, torch.arange(h, device=dev) % field.shape[1]].contiguous()
            hosts = [64 + 24 * i for i in range(s)] if (s, t, h) == (16, 576, 424) else None
            kw = cs.lanes_case(torch, np, u, seed=s + t + h, hosts=hosts)
            calls = [(u, kw)]
            try:
                ops.des_readout(u, **kw)
            except (ValueError, TypeError):     # no lane axis: a call a lane
                calls = [(u[i], {k: v if k in SHARED else
                                 float(v[i]) if v.dim() == 1 else v[i]
                                 for k, v in kw.items()}) for i in range(s)]
        outs = [ops.des_readout(x, **k) for x, k in calls]
        stat = kernel_us(torch, ops, lambda: [ops.des_readout(x, **k) for x, k in calls],
                         "des_readout", reps, rounds)
        stat["sum_power_w"] = float(sum(o["power_w"].double().sum() for o in outs))
        out["readout"][label] = stat
    u = field[:POWER_SHAPE[0], :POWER_SHAPE[1]].contiguous()
    out["power_sim"] = kernel_us(torch, ops, lambda: ops.power_sim(u, **cs.POWER_KW),
                                 "power_sim", reps, rounds)
    timer = cs.DeviceTimer(torch)
    out["des_place"] = {}
    for label, args, kw, _ in cs.place_cases(torch, np, dev):
        if label.startswith(PLACE_TIMED):
            start, host, attempts = ops.des_place(*args, **kw)
            stat = timer.device_ms(lambda: ops.des_place(*args, **kw), reps=5, rounds=rounds)
            stat.update(attempts_max=int(attempts.max()),
                        schedule_sums=[int(start.long().sum()), int(host.long().sum())])
            out["des_place"][label] = stat
    out["flash_attention"] = flash(torch, np, cs, ops, _build, timer, reps, rounds)
    return out


def flash_differences(results: list) -> list:
    """The ``FLASH_CASES`` keys whose digests differ between two checkouts
    that both ran them."""
    differ = set()
    for a in results:
        for b in results:
            da, db = a["flash_attention"]["digests"], b["flash_attention"]["digests"]
            differ.update(key for key in da.keys() & db.keys() if da[key] != db[key])
    return sorted(differ)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--reps", type=int, default=20, help="calls a trace")
    ap.add_argument("--rounds", type=int, default=5, help="traces a shape")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(pathlib.Path(args.roots[0]).resolve(), args.reps,
                             args.rounds)))
        return 0
    results = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--one", "--reps",
                               str(args.reps), "--rounds", str(args.rounds), root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"kernel_compare: {root} failed:\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        results.append(json.loads(line))
        print(line, flush=True)
    differ = flash_differences(results)
    shared = set.intersection(*(set(r["flash_attention"]["digests"]) for r in results))
    print(f"kernel_compare: flash, {len(shared) - len(differ)} of {len(shared)} "
          f"FLASH_CASES that every checkout takes equal bit for bit", flush=True)
    if differ:
        print(f"kernel_compare: flash outputs differ between checkouts at {differ}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
