"""DES placement kernel: every what-if lane's schedule in one launch, CUDA
for Hopper.

Replaces: the placement scan of ``repro/core/desim.py``
(``simulate_utilization_masked``: ``lax.scan`` over bins around a
``while_loop`` of placement attempts, ``place_one``), which the JAX
package keeps on the device and vmaps over scenarios.  It has no Pallas
kernel; before this kernel the port ran it on the host with one
device read per attempt.

Bound on an H100: latency.  A lane's attempts form one dependent chain,
each reading the free cores the one before wrote, and so do its bins, so
a lane takes at least (attempts + bins) times one decision step (a
shared store, ``__syncwarp``, a load and two ``redux.sync``, timed alone
by :func:`step_launch`); lanes run side by side, a block each.

Design (``csrc/des_place.cu``): one block per lane, and one warp of it
decides, with the lane's state in registers: each lane of the warp owns
host groups of four, scores them from shared memory and the warp takes
the argmax with two ``redux.sync`` (the largest score, then the lowest
host holding it).  The job fields sit in a window of shared memory
refilled with ``cp.async`` (:func:`operands` packs them as ``[S, J, 4]``
int32: ready bin, duration, cores, 0), the failure rows beside the free
cores, and the next bin's release row is prefetched.  Backfill
candidates are scored, by up to 8 warps, only when the head fits
nowhere.
The release table (``[S, T, HP]`` int32 scratch, HP = H rounded up to 4,
zeroed here) takes an integer ``red.global.add`` per placement.
Integer arithmetic only: the kernel equals
:func:`repro_torch.kernels.ref.des_place_ref` bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

#: backfill candidates a lane may scan: the skip mask is 32 bits
MAX_BACKFILL = 31

#: a job's ready bin where it never starts (not valid)
NEVER = 2**31 - 1


class PlaceArgs(ctypes.Structure):
    """``PlaceArgs`` of ``csrc/des_place.cu``, field for field."""

    POINTERS = ("jobs", "mask", "cores_per_host", "policy", "depth", "fail_start",
                "fail_end", "fail_kill", "release", "job_start", "job_host", "attempts")
    _fields_ = ([(name, ctypes.c_void_p) for name in POINTERS]
                + [(name, ctypes.c_int) for name in (
                    "S", "J", "H", "T", "max_starts", "max_backfill")])


def max_hosts() -> int:
    """Hosts a lane may have: what the kernel's shared memory holds, as
    ``csrc/des_place.cu`` states it (``kMaxHosts``)."""
    return int(_build.load("des_place").des_place_max_hosts())


def _i32(x: Tensor) -> Tensor:
    return x.to(torch.int32).contiguous()


def _u8(x: Tensor) -> Tensor:
    return x.to(torch.bool).contiguous().view(torch.uint8)


def operands(submit, dur, cores, valid, host_mask, cores_per_host, policy_id,
             depth, *, t_bins: int, fail_start=None, fail_end=None,
             fail_kill=None) -> dict:
    """The kernel's operands as contiguous int32 / uint8 tensors: the job
    table ``[S, J, 4]`` (ready bin, the submit bin or :data:`NEVER` where
    not valid; duration; cores; 0), the zeroed release table ``[S, T,
    HP]`` (HP = H rounded up to 4) and the outputs (``job_start``/``job_host``
    -1, ``attempts`` 0), all on ``submit``'s device."""
    dev = submit.device
    s, j = submit.shape
    h = host_mask.shape[1]
    ready = torch.where(valid.to(torch.bool), submit.to(torch.int32), NEVER)
    jobs = torch.stack([ready, _i32(dur), _i32(cores), torch.zeros_like(ready)], dim=-1)
    out = dict(jobs=jobs, mask=_u8(host_mask),
               cores_per_host=_i32(cores_per_host), policy=_i32(policy_id),
               depth=_i32(depth))
    if fail_start is not None:
        out.update(fail_start=_i32(fail_start), fail_end=_i32(fail_end),
                   fail_kill=_u8(fail_kill))
    out.update(
        release=torch.zeros((s, t_bins, -(-h // 4) * 4), dtype=torch.int32, device=dev),
        job_start=torch.full((s, j), -1, dtype=torch.int32, device=dev),
        job_host=torch.full((s, j), -1, dtype=torch.int32, device=dev),
        attempts=torch.zeros((s,), dtype=torch.int32, device=dev))
    return out


def launch(entry, o: dict, *, t_bins: int, max_starts_per_bin: int,
           max_backfill: int) -> tuple[Tensor, Tensor, Tensor]:
    """Run the C entry point ``entry`` (``des_place_launch`` of a built
    library) on :func:`operands`' dict ``o``; returns ``(job_start,
    job_host, attempts)``.  Raises if the launch fails."""
    s, j = o["jobs"].shape[:2]
    ptr = lambda k: o[k].data_ptr() if k in o else None  # noqa: E731
    args = PlaceArgs(**{k: ptr(k) for k in PlaceArgs.POINTERS},
                     S=s, J=j, H=o["mask"].shape[1], T=t_bins,
                     max_starts=max_starts_per_bin, max_backfill=max_backfill)
    dev = o["jobs"].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"des_place launch failed: CUDA error {err}")
    return o["job_start"], o["job_host"], o["attempts"]


def des_place_cuda(submit: Tensor, dur: Tensor, cores: Tensor, valid: Tensor,
                   host_mask: Tensor, cores_per_host: Tensor, policy_id: Tensor,
                   depth: Tensor, *, t_bins: int, max_starts_per_bin: int,
                   max_backfill: int, fail_start=None, fail_end=None,
                   fail_kill=None) -> tuple[Tensor, Tensor, Tensor]:
    """``(job_start [S, J], job_host [S, J], attempts [S])`` int32 on the
    card, in one launch.

    Job arrays ``[S, J]`` (S, J > 0), ``host_mask`` ``[S, H]`` (and the failure arrays,
    all three or none), ``cores_per_host``/``policy_id``/``depth`` ``[S]``,
    all CUDA tensors on one device; H at most :func:`max_hosts`.
    """
    dev = submit.device
    if dev.type != "cuda":
        raise ValueError(f"des_place_cuda needs CUDA tensors, got {dev}")
    given = [submit, dur, cores, valid, host_mask, cores_per_host, policy_id,
             depth] + [x for x in (fail_start, fail_end, fail_kill) if x is not None]
    if any(x.device != dev for x in given):
        raise ValueError("des_place operands must all lie on one device")
    h = host_mask.shape[1]
    most = max_hosts()
    if h > most:
        raise ValueError(f"{h} hosts exceed the {most} a lane's shared memory holds")
    o = operands(submit, dur, cores, valid, host_mask, cores_per_host, policy_id,
                 depth, t_bins=t_bins, fail_start=fail_start, fail_end=fail_end,
                 fail_kill=fail_kill)
    entry = _build.load("des_place").des_place_launch
    return launch(entry, o, t_bins=t_bins, max_starts_per_bin=max_starts_per_bin,
                  max_backfill=max_backfill)


def barrier_launch(rounds: int, warps: int, out: Tensor) -> int:
    """Launch the kernel library's barrier probe (``rounds`` round trips of
    the earlier block design's attempt, two ``__syncthreads`` around a
    thread-0 write, in one block of ``warps`` warps, no work between);
    returns the CUDA error code."""
    lib = _build.load("des_place")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        return int(lib.des_place_barrier_launch(rounds, warps, out.data_ptr(), stream))


def step_launch(rounds: int, out: Tensor) -> int:
    """Launch the kernel library's decision-step probe (``rounds`` steps of
    one warp, each a shared store, ``__syncwarp``, a load and two
    ``redux.sync`` on the step before); returns the CUDA error code."""
    lib = _build.load("des_place")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        return int(lib.des_place_step_launch(rounds, out.data_ptr(), stream))
