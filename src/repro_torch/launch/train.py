"""Training launcher: real steps on the card (or the CPU), fault-tolerant.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 100 --seq 256 --batch 8 --reduce 8 --device cpu

The flags are the JAX launcher's plus ``--device`` (default ``cuda``,
which needs a card).  Parameters are random, drawn from ``--seed`` by a
``torch.Generator`` on the device; batches come from the port's
``TokenPipeline``; ``run_with_restarts`` checkpoints every
``--ckpt-every`` steps and resumes from the latest checkpoint after each
failure injected with ``--fail-at``.  ``--reduce N`` divides layer count
and widths by N (:func:`reduce_config`, shared with the serving
launcher).  ``--ckpt-dir`` is not cleared first: a directory that holds
checkpoints resumes from them.  Every ``--arch`` of the registry
trains; the enc-dec and VLM batches carry the JAX launcher's stub
frontend inputs (:func:`frontend_inputs`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.launch.steps import make_train_step, param_specs_for
from repro_torch.models.common import init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.fault import (
    FailureInjector,
    FaultConfig,
    RunReport,
    run_with_restarts,
)


def reduce_config(cfg: ModelConfig, factor: int) -> ModelConfig:
    """Scale a config down by ~factor for CPU-scale end-to-end runs."""
    if factor <= 1:
        return cfg
    def sh(x, lo=1):
        return max(x // factor, lo)
    kv = max(sh(cfg.n_kv_heads, 1), 1)
    heads = max(sh(cfg.n_heads, 1), kv)
    heads = (heads // kv) * kv or kv
    repl = dataclasses.replace(
        cfg,
        num_layers=sh(cfg.num_layers, 2),
        d_model=sh(cfg.d_model, 64),
        d_ff=sh(cfg.d_ff, 64) if cfg.d_ff else 0,
        n_heads=heads if cfg.n_heads else 0,
        n_kv_heads=kv if cfg.n_kv_heads else 0,
        head_dim=max(sh(cfg.head_dim, 16), 16) if cfg.head_dim else 0,
        vocab=max(cfg.vocab // factor, 512),
        moe_d_ff=sh(cfg.moe_d_ff, 32) if cfg.moe_d_ff else 0,
        shared_d_ff=sh(cfg.shared_d_ff, 32) if cfg.shared_d_ff else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        q_lora=sh(cfg.q_lora, 16) if cfg.q_lora else 0,
        kv_lora=sh(cfg.kv_lora, 16) if cfg.kv_lora else 0,
        qk_nope_dim=max(sh(cfg.qk_nope_dim, 8), 8) if cfg.qk_nope_dim else 0,
        qk_rope_dim=max(sh(cfg.qk_rope_dim, 8), 8) if cfg.qk_rope_dim else 0,
        v_head_dim=max(sh(cfg.v_head_dim, 8), 8) if cfg.v_head_dim else 0,
        d_state=max(sh(cfg.d_state, 16), 16) if cfg.d_state else 0,
        ssm_headdim=max(sh(cfg.ssm_headdim, 16), 16) if cfg.d_state else 64,
        ssd_chunk=64,
        enc_layers=sh(cfg.enc_layers, 1) if cfg.enc_layers else 0,
        dec_layers=sh(cfg.dec_layers, 1) if cfg.dec_layers else 0,
        shared_attn_every=cfg.shared_attn_every,
        shared_attn_lora=sh(cfg.shared_attn_lora, 8) if cfg.shared_attn_lora else 0,
        num_patches=min(cfg.num_patches, 64) if cfg.num_patches else 0,
        mrope_sections=(
            tuple(int(x) for x in _scale_sections(cfg, factor))
            if cfg.mrope else cfg.mrope_sections),
    )
    return repl.validate()


def _scale_sections(cfg: ModelConfig, factor: int):
    hd = max(cfg.head_dim // factor, 16)
    half = hd // 2
    t = max(half // 4, 1)
    rest = half - t
    h = rest // 2
    w = rest - h
    return (t, h, w)


def frontend_inputs(cfg: ModelConfig, batch: int, seq: int, device
                    ) -> dict[str, torch.Tensor]:
    """The stub frontend's inputs the JAX launcher adds to every batch, in
    ``cfg.dtype`` on ``device``: the enc-dec's ``frames`` (``[B, 64, d]``
    at 0.02); the VLM's ``vision_embeds`` (``[B, P, d]`` at 0.02, ``P =
    cfg.num_patches``) on rows ``vision_pos`` = ``arange(P)`` and M-RoPE
    ``positions`` = ``arange(seq)`` in all three streams (``[3, B, S]``);
    nothing for the other families."""
    dt = getattr(torch, cfg.dtype)
    out = {}
    if cfg.family == "encdec":
        out["frames"] = torch.ones((batch, 64, cfg.d_model), dtype=dt, device=device) * 0.02
    if cfg.family == "vlm":
        p = cfg.num_patches
        out["vision_embeds"] = torch.ones((batch, p, cfg.d_model), dtype=dt,
                                          device=device) * 0.02
        out["vision_pos"] = torch.arange(p, dtype=torch.int32, device=device).expand(batch, p)
        out["positions"] = torch.arange(seq, dtype=torch.int32, device=device).expand(
            3, batch, seq)
    return out


@dataclasses.dataclass
class TrainResult:
    cfg: ModelConfig
    report: RunReport
    state: dict[str, Any]         # the final {"params", "opt"}


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduce", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduce_config(get_config(args.arch), args.reduce)
    print(f"arch={cfg.name} reduced x{args.reduce}: L={cfg.num_layers} "
          f"d={cfg.d_model} vocab={cfg.vocab}", flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 5),
                          total_steps=args.steps)
    train_step = make_train_step(cfg, opt_cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, seed=args.seed),
                         device=dev)

    def make_state():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = init_params(param_specs_for(cfg), gen, getattr(torch, cfg.dtype), dev)
        return {"params": params, "opt": init_opt_state(params, opt_cfg)}

    extra = frontend_inputs(cfg, args.batch, args.seq, dev)
    times = []

    def step_fn(state, step):
        batch = {**pipe.global_batch(step), **extra}
        t0 = time.perf_counter()
        params, opt, metrics = train_step(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        times.append(time.perf_counter() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{times[-1]*1e3:.0f} ms", flush=True)
        return {"params": params, "opt": opt}, loss

    final = {}

    def keep_last(step, state):
        final["state"] = state

    report = run_with_restarts(
        total_steps=args.steps,
        make_state=make_state,
        step_fn=step_fn,
        fault_cfg=FaultConfig(ckpt_dir=args.ckpt_dir,
                              ckpt_every=args.ckpt_every),
        injector=FailureInjector(tuple(args.fail_at)) if args.fail_at else None,
        on_window=keep_last,
    )
    print(f"done: {report.steps_done} steps, {report.restarts} restarts, "
          f"{report.checkpoints} checkpoints, "
          f"median step {np.median(times)*1e3:.0f} ms, "
          f"final loss {report.losses[-1]:.4f}", flush=True)
    return TrainResult(cfg, report, final.get("state"))


if __name__ == "__main__":
    main()
