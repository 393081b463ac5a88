"""Mamba-2 / SSD (state-space duality) block [arXiv:2405.21060].

Prefill: the chunked SSD algorithm.  The intra-chunk quadratic term and
the chunk-end states go through the ``ssd_chunk`` kernel
(:func:`repro_torch.kernels.ops.ssd_chunk`) on the ``[B * chunks, Q, H, P]``
view; the O(chunks) inter-chunk recurrence (a loop over chunks), its
``exp(csum)`` readout and the sum stay in torch.  The JAX package computes
the same function with the quadratic term in jnp; its own test
(``test_ssd_chunk_kernel_plus_interchunk_matches_full_ssd``) shows the
kernel to be a drop-in for that part.

Training: the kernel call is an autograd Function (:class:`SSDChunk`)
whose backward differentiates the kernel's plain version, as JAX
differentiates its jnp quadratic term; the recurrence's gradient is
torch's own.

Decode: the O(1) recurrent state update; the "cache" is a fixed-size
``[B, H, P, N]`` f32 state plus ``[B, K-1, channels]`` conv windows.

The JAX package's sharding constraints (``activation``) stand at their
counterparts: moving nothing on plain tensors, they place the DTensors of
the per-device dry-run (the heads over ``model``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.common import ParamSpec, dense, rms_norm
from repro_torch.parallel.sharding import (
    activation,
    channelwise,
    cumsum,
    is_dtensor,
    kernel_placements,
    on_shards,
    shard_einsum,
    splits,
)

Tensor = torch.Tensor


def mamba2_specs(cfg: ModelConfig, L: int) -> dict[str, ParamSpec]:
    d = cfg.d_model
    din = cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.d_state
    h = cfg.ssm_heads
    k = cfg.d_conv
    return {
        "norm_in": ParamSpec((L, d), (None, None), init="ones"),
        "wz": ParamSpec((L, d, din), (None, "embed", "ssm_inner")),
        "wx": ParamSpec((L, d, din), (None, "embed", "ssm_inner")),
        "wB": ParamSpec((L, d, gn), (None, "embed", None)),
        "wC": ParamSpec((L, d, gn), (None, "embed", None)),
        "wdt": ParamSpec((L, d, h), (None, "embed", None)),
        "conv_x_w": ParamSpec((L, k, din), (None, "conv", "ssm_inner"),
                              scale=0.5),
        "conv_x_b": ParamSpec((L, din), (None, "ssm_inner"), init="zeros"),
        "conv_B_w": ParamSpec((L, k, gn), (None, "conv", None), scale=0.5),
        "conv_B_b": ParamSpec((L, gn), (None, None), init="zeros"),
        "conv_C_w": ParamSpec((L, k, gn), (None, "conv", None), scale=0.5),
        "conv_C_b": ParamSpec((L, gn), (None, None), init="zeros"),
        "A_log": ParamSpec((L, h), (None, None), init="zeros"),
        "D": ParamSpec((L, h), (None, None), init="ones"),
        "dt_bias": ParamSpec((L, h), (None, None), init="zeros"),
        "norm_g": ParamSpec((L, din), (None, "ssm_inner"), init="ones"),
        "wo": ParamSpec((L, din, d), (None, "ssm_inner", "embed")),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over seq.  x [B,S,C], w [K,C], b [C].

    A sum of K shifted products, as the JAX package writes it (a float32
    ``conv1d`` would go through cuDNN in TF32 on the card).
    """
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _conv_step(state: Tensor, new: Tensor, w: Tensor, b: Tensor
               ) -> tuple[Tensor, Tensor]:
    """Single-token conv.  state [B,K-1,C], new [B,C] -> (out [B,C], state')."""
    window = torch.cat([state, new[:, None, :]], dim=1)          # [B,K,C]
    out = (window * w[None]).sum(dim=1) + b
    return out, window[:, 1:, :]


def _project(p: dict[str, Tensor], x: Tensor
             ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """x [B,S,d] -> (z, xs, B_, C_, dt) pre-conv, pre-activation."""
    z = dense(x, p["wz"])
    xs = dense(x, p["wx"])
    b_ = dense(x, p["wB"])
    c_ = dense(x, p["wC"])
    dt = dense(x, p["wdt"]).float()
    return z, xs, b_, c_, dt


class SSDChunk(torch.autograd.Function):
    """``ops.ssd_chunk`` with a gradient.

    ``forward`` is the kernel on a CUDA tensor (its plain version on a CPU
    one); ``backward`` recomputes the plain version
    (:func:`repro_torch.kernels.ref.ssd_chunk_ref`) under autograd and
    returns its vector-Jacobian product, so the forward runs the kernel
    once and the backward none.  On DTensors the operands are first placed
    as one of the operator's sharding strategies (:func:`_placements`) and
    the product is taken on each device's shards.
    """

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip):
        args = (x, dt, a_log, b, c, d_skip)
        if is_dtensor(x):
            ins = _placements(x, b)[0]
            args = tuple(t.redistribute(x.device_mesh, pl) for t, pl in zip(args, ins))
        ctx.save_for_backward(*args)
        return ops.ssd_chunk(*args)

    @staticmethod
    def backward(ctx, gy, gst):
        saved, need = ctx.saved_tensors, ctx.needs_input_grad
        if not is_dtensor(gy):
            return _vjp(saved, need, gy, gst)
        if not is_dtensor(gst):
            # no gradient reached the states (one chunk: the carry is never
            # read), and autograd made plain zeros of their global shape
            from torch.distributed.tensor import DTensor, Replicate

            dm = gy.device_mesh
            gst = DTensor.from_local(gst, dm, [Replicate()] * dm.ndim, run_check=False)
        ins, outs, grads = _placements(saved[0], saved[3])
        return on_shards(lambda *a: _vjp(a[:6], need, *a[6:]), [*saved, gy, gst],
                         ins + outs, [(pl, t.shape) for pl, t in zip(grads, saved)])


def _vjp(saved, need, gy: Tensor, gst: Tensor) -> tuple:
    """The plain version's vector-Jacobian product at ``saved`` (None for
    an input ``need`` leaves out)."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
    with torch.enable_grad():
        y, st = ref.ssd_chunk_ref(*inputs)
    wrt = [t for t, n in zip(inputs, need) if n]
    grads = iter(torch.autograd.grad((y, st), wrt, (gy, gst), allow_unused=True))
    return tuple(next(grads) if n else None for n in need)


def _placements(x, b) -> tuple[list, list, list]:
    """``(inputs, outputs, gradients)``: the placements, a list a mesh axis
    for each of ``ssd_chunk``'s six operands, two results and six
    gradients, of the strategy ``x``'s own placements select
    (``sharding.kernel_placements``): the SSM heads (``b``/``c`` on their
    groups where there is more than one, else replicated), the chunk
    rows, or replicated.  A gradient of an operand replicated over an axis
    the work splits is a partial sum there."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    g = b.shape[2]
    rep, s0, s1, s2, part = Replicate(), Shard(0), Shard(1), Shard(2), Partial()
    cols = {"ins": [], "outs": [], "grads": []}
    for p in kernel_placements(x, 2, g if g > 1 else 0):
        if p == s2:
            bc, gbc = (s2, s2) if g > 1 else (rep, part)
            row = ((s2, s2, s0, bc, bc, s0), (s2, s1), (s2, s2, s0, gbc, gbc, s0))
        elif p == s0:
            row = ((s0, s0, rep, s0, s0, rep), (s0, s0), (s0, s0, part, s0, s0, part))
        else:
            row = ((rep,) * 6, (rep, rep), (rep,) * 6)
        for k, r in zip(cols, row):
            cols[k].append(r)
    return tuple([[r[j] for r in col] for j in range(len(col[0]))]
                 for col in cols.values())


def ssd_chunked(
    xh: Tensor,      # [B, S, H, P] conv'd+SiLU'd inputs, head-split
    dt: Tensor,      # [B, S, H] post-softplus, f32
    a_log: Tensor,   # [H]
    b_: Tensor,      # [B, S, G, N]
    c_: Tensor,      # [B, S, G, N]
    d_skip: Tensor,  # [H]
    chunk: int,
) -> Tensor:
    """Chunked state-space-duality scan.  Returns y [B, S, H, P] in f32.

    The sequence is cut into ``max(S // chunk, 1)`` equal chunks, as in
    the JAX package; a length they do not divide raises.
    """
    bsz, s, h, pdim = xh.shape
    g, n = b_.shape[2], b_.shape[3]
    rep = h // g
    n_chunks = max(s // chunk, 1)
    chunk = s // n_chunks
    if s % chunk:
        raise ValueError(f"sequence length {s} is not {n_chunks} chunks of "
                         f"{chunk}")

    a = -torch.exp(a_log.float())                            # [H] negative
    da = dt.float() * a[None, None, :]                       # [B,S,H]
    csum = cumsum(da.reshape(bsz, n_chunks, chunk, h), dim=2)
    total = csum[:, :, -1, :]                                 # [B,c,H]

    bcq = bsz * n_chunks
    bf = b_.float()
    cf = c_.float()
    y_intra, states = SSDChunk.apply(
        activation(xh.float().reshape(bsz, n_chunks, chunk, h, pdim),
                   "batch", None, "seq", "ssm_heads", None).reshape(bcq, chunk, h, pdim),
        dt.float().reshape(bcq, chunk, h),
        a_log, bf.reshape(bcq, chunk, g, n), cf.reshape(bcq, chunk, g, n),
        d_skip)                              # y_intra holds D * x already
    states = states.reshape(bsz, n_chunks, h, pdim, n)

    # inter-chunk recurrence: the state entering each chunk
    state = activation(torch.zeros((bsz, h, pdim, n), dtype=torch.float32, device=xh.device),
                       "batch", "ssm_heads", None, None)
    prev = []
    for ci in range(n_chunks):
        prev.append(state)
        state = activation(state * torch.exp(total[:, ci])[:, :, None, None] + states[:, ci],
                           "batch", "ssm_heads", None, None)
    prev_states = torch.stack(prev, dim=1)                    # [B,c,H,P,N]

    # y_inter[q, h, p] = exp(csum[q, h]) * sum_n C[q, g(h), n] prev[h, p, n]
    cg = cf.reshape(bsz, n_chunks, chunk, g, n).permute(0, 1, 3, 2, 4)
    pv = prev_states.reshape(bsz, n_chunks, g, rep * pdim, n)
    y_inter = torch.matmul(cg, pv.transpose(-1, -2))          # [B,c,G,Q,rep*P]
    y_inter = y_inter.reshape(bsz, n_chunks, g, chunk, rep, pdim).permute(
        0, 1, 3, 2, 4, 5).reshape(bsz, n_chunks, chunk, h, pdim)
    y_inter = y_inter * torch.exp(csum)[..., None]

    y = y_intra.reshape(bsz, n_chunks, chunk, h, pdim) + y_inter
    return y.reshape(bsz, s, h, pdim)


def mamba2_forward(p: dict[str, Tensor], cfg: ModelConfig, x: Tensor) -> Tensor:
    """Full-sequence Mamba2 block.  x [B,S,d] -> [B,S,d]."""
    bsz, s, _ = x.shape
    h, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.d_state
    z, xs, b_, c_, dt = _project(p, x)
    xs = F.silu(channelwise(_causal_conv, xs, p["conv_x_w"], p["conv_x_b"]))
    b_ = F.silu(channelwise(_causal_conv, b_, p["conv_B_w"], p["conv_B_b"]))
    c_ = F.silu(channelwise(_causal_conv, c_, p["conv_C_w"], p["conv_C_b"]))
    dt = F.softplus(dt + p["dt_bias"][None, None].float())

    xh = activation(xs.reshape(bsz, s, h, pdim), "batch", "seq", "ssm_heads", None)
    bg = b_.reshape(bsz, s, cfg.ssm_ngroups, n)
    cg = c_.reshape(bsz, s, cfg.ssm_ngroups, n)
    y = ssd_chunked(xh, dt, p["A_log"], bg, cg, p["D"], cfg.ssd_chunk)
    y = y.reshape(bsz, s, h * pdim).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return dense(y, p["wo"])


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device: "str | torch.device" = "cuda") -> dict[str, Tensor]:
    """Zero decode state of one layer on ``device``: the f32 ``ssm`` state
    and the conv windows in ``dtype``."""
    device = resolve_device(device)
    h, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.d_state
    gn = cfg.ssm_ngroups * cfg.d_state
    k = cfg.d_conv
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    return {
        "ssm": z((batch, h, pdim, n), torch.float32),
        "conv_x": z((batch, k - 1, cfg.d_inner), dtype),
        "conv_B": z((batch, k - 1, gn), dtype),
        "conv_C": z((batch, k - 1, gn), dtype),
    }


def _state_rule(p):
    """:func:`parallel.sharding.shard_einsum`'s placements for the decode
    readout ``C [B, H, N]`` x state ``[B, H, P, N]`` on one mesh axis:
    ``C`` split as the state's rows or heads are."""
    from torch.distributed.tensor import Replicate, Shard

    if isinstance(p, Shard) and p.dim in (0, 1):
        return Shard(p.dim), p, Shard(p.dim)
    return Replicate(), Replicate(), Replicate()


def mamba2_decode(p: dict[str, Tensor], cfg: ModelConfig, x: Tensor,
                  state: dict[str, Tensor]
                  ) -> tuple[Tensor, dict[str, Any]]:
    """Single-token recurrent step.  x [B,1,d] -> (y [B,1,d], new state)."""
    bsz = x.shape[0]
    h, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.d_state
    z, xs, b_, c_, dt = _project(p, x)
    xs1, conv_x = _conv_step(state["conv_x"], xs[:, 0], p["conv_x_w"],
                             p["conv_x_b"])
    b1, conv_b = _conv_step(state["conv_B"], b_[:, 0], p["conv_B_w"],
                            p["conv_B_b"])
    c1, conv_c = _conv_step(state["conv_C"], c_[:, 0], p["conv_C_w"],
                            p["conv_C_b"])
    xs1 = F.silu(xs1).float()
    b1 = F.silu(b1).float()
    c1 = F.silu(c1).float()
    dt1 = F.softplus(dt[:, 0] + p["dt_bias"][None].float())   # [B,H]

    a = -torch.exp(p["A_log"].float())                         # [H]
    xh = xs1.reshape(bsz, h, pdim)
    rep = h // cfg.ssm_ngroups
    bh = b1.reshape(bsz, cfg.ssm_ngroups, n).repeat_interleave(rep, dim=1)
    ch = c1.reshape(bsz, cfg.ssm_ngroups, n).repeat_interleave(rep, dim=1)

    decay = torch.exp(dt1 * a[None])                           # [B,H]
    ssm = (state["ssm"] * decay[:, :, None, None]
           + (dt1[:, :, None] * xh)[..., None] * bh[:, :, None, :])
    if splits(ssm, 0, 1):   # per shard: no view merges the split B and H
        y = shard_einsum("bhn,bhpn->bhp", ch, ssm, _state_rule)
    else:
        y = torch.matmul(ssm, ch[..., None])[..., 0]           # [B,H,P]
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(bsz, 1, h * pdim).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return dense(y, p["wo"]), {
        "ssm": ssm, "conv_x": conv_x, "conv_B": conv_b, "conv_C": conv_c,
    }
