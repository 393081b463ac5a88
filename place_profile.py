#!/usr/bin/env python3
"""Where ``des_place``'s deciding warp spends its cycles, on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 place_profile.py [--variant rounds1 | no-row-prefetch]

It copies ``src/repro_torch/kernels/csrc/des_place.cu``, puts ``clock64()``
reads around the segments of warp 0's loop (the bin's releases and
prefetch; an attempt's pick, its decision and placement, its advance to
the next head), summed in registers by thread 0 of block 0 and written
once at the end, builds the copy with the port's nvcc flags under
``build/place_profile/`` and launches it through ``des_place.launch`` at
``chip_smoke.place_cases``' E2 horizon, C and D (block 0: the first lane).
A variant changes one thing in the copy: ``rounds1`` scores one round of
host groups at a time (``kRounds = 1``), ``no-row-prefetch`` drops the
release row's prefetch (wrong schedules: a timing of what the prefetch
costs, nothing else).  Prints, per shape, cycles an attempt by segment,
cycles a bin, the total, and whether the schedule equals the built
kernel's; one JSON line at the end.  The reads cost a few cycles each, so
the total runs a few percent above the kernel's own time.  Without a card
it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent

#: (anchor in des_place.cu, text put in its place) for the clock reads
PROBES = (
    ("namespace {\n", "__device__ long long g_prof[8];\nnamespace {\n"),
    ("  int head = 0, attempts = 0;\n",
     "  const bool prof = blockIdx.x == 0 && threadIdx.x == 0;\n"
     "  long long c0 = 0, ca = 0, cb = 0, cc = 0, q0 = 0, q1 = 0, q2 = 0, q3 = 0;\n"
     "  const long long ck = clock64();\n  int head = 0, attempts = 0;\n"),
    ("    // 1) releases:", "    c0 = clock64();\n    // 1) releases:"),
    ("    late_rows = false;\n", "    late_rows = false;\n    q0 += clock64() - c0;\n"),
    ("      ++attempts;\n", "      ca = clock64();\n      ++attempts;\n"),
    ("      int jid = -1, d_sel = 0, host = p.host;\n",
     "      cb = clock64();\n      q1 += cb - ca;\n      int jid = -1, d_sel = 0, host = p.host;\n"),
    ("      ++placed;\n", "      cc = clock64();\n      q2 += cc - cb;\n      ++placed;\n"),
    ("      go = placed < a.max_starts && job.x <= t;\n",
     "      go = placed < a.max_starts && job.x <= t;\n      q3 += clock64() - cc;\n"),
    ("  if (lane == 0) a.attempts[s] = attempts;\n",
     "  if (prof) {\n    g_prof[0] = q0; g_prof[1] = q1; g_prof[2] = q2; g_prof[3] = q3;\n"
     "    g_prof[4] = clock64() - ck; g_prof[5] = attempts; g_prof[6] = T;\n  }\n"
     "  if (lane == 0) a.attempts[s] = attempts;\n"),
)

#: one change each, as (text, replacement) in des_place.cu
VARIANTS = {
    "rounds1": ("constexpr int kRounds = 4;", "constexpr int kRounds = 1;"),
    "no-row-prefetch": ("      if (t + 1 < T) cp_async16(rel4 + g, next_row + g);\n", ""),
}

READ = ('\nextern "C" int place_profile_read(long long* out) {\n'
        '  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)));\n}\n')

SEGMENTS = ("bin", "pick", "decide and place", "advance")


def instrumented(src: str, variant: str | None) -> str:
    for text, new in PROBES + ((VARIANTS[variant],) if variant else ()):
        if src.count(text) != 1:
            raise SystemExit(f"place_profile: des_place.cu no longer holds {text!r} once")
        src = src.replace(text, new)
    return src + READ


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("place_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import _build, des_place

    out_dir = HERE / "build" / "place_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "des_place_profiled.cu", out_dir / "des_place_profiled.so"
    cu.write_text(instrumented((_build._CSRC / "des_place.cu").read_text(), args.variant))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    entry = lib.des_place_launch
    entry.argtypes, entry.restype = _build.ENTRY_POINTS["des_place"][1], ctypes.c_int
    lib.place_profile_read.argtypes, lib.place_profile_read.restype = [ctypes.c_void_p], ctypes.c_int
    counts = (ctypes.c_longlong * 8)()
    dev = torch.device("cuda")
    result = {"variant": args.variant, "card": cs.card_line(), "shapes": {}}
    print(result["card"])
    for label, operands, kw, _ in cs.place_cases(torch, np, dev):
        if not label.startswith(("E2 week, the main path's", "C:", "D:")):
            continue
        fails = {k: kw[k] for k in ("fail_start", "fail_end", "fail_kill") if k in kw}
        o = des_place.operands(*operands, t_bins=kw["t_bins"], **fails)
        got = des_place.launch(entry, o, t_bins=kw["t_bins"], max_starts_per_bin=64,
                               max_backfill=kw["max_backfill"])
        torch.cuda.synchronize()
        if lib.place_profile_read(ctypes.addressof(counts)) != 0:
            raise RuntimeError("place_profile: reading the counters failed")
        want = des_place.des_place_cuda(*operands, **dict(kw, max_starts_per_bin=64))
        q = list(counts)
        attempts, bins = q[5], q[6]
        row = dict(cycles_total=q[4], attempts=attempts, bins=bins,
                   bin_cycles=q[0] / bins,
                   **{f"{name}_cycles_an_attempt": q[i] / attempts
                      for i, name in enumerate(SEGMENTS[1:], 1)},
                   same_schedule=all(torch.equal(a, b) for a, b in zip(got, want)))
        result["shapes"][label] = row
        print(f"{label}: {q[4]} cycles in lane 0; an attempt: "
              + ", ".join(f"{n} {row[f'{n}_cycles_an_attempt']:.0f}" for n in SEGMENTS[1:])
              + f"; a bin {row['bin_cycles']:.0f} ({attempts} attempts, {bins} bins); "
              f"schedule equal to the built kernel's: {row['same_schedule']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
