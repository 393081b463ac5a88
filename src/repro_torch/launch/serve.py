"""Serving launcher: batched greedy decoding.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --reduce 8 --batch 4 --prompt-len 32 --gen 64 --device cpu

The flags are the JAX launcher's plus ``--device`` (default ``cuda``,
which needs a card) and ``--layers`` (keep the first N layers of a
decoder-only config at its full width: Command R+ 104B's 64 layers do
not fit one card).  Any ``--arch`` of the registry runs.  Parameters are
random, drawn from ``--seed``; the prompt is prefilled token by token
through the serve step, as the JAX launcher does, then ``--gen`` tokens
are decoded greedily.  M-RoPE configs (Qwen2-VL) get ``[3, B, 1]``
positions, each stream at the token's index; the enc-dec config
(Seamless) decodes against zero cross K/V, as the JAX launcher's zeroed
state holds them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import make_serve_step, param_specs_for, state_specs_for
from repro_torch.launch.train import reduce_config
from repro_torch.models.common import init_params

#: prompt tokens are drawn below this id (the JAX launcher's bound)
PROMPT_VOCAB = 1000


@dataclasses.dataclass
class ServeResult:
    cfg: ModelConfig
    tokens: torch.Tensor          # [B, gen] int32, on the host
    prefill_seconds: float
    decode_seconds: float

    @property
    def tokens_per_second(self) -> float:
        return self.tokens.numel() / self.decode_seconds


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduce", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduce_config(get_config(args.arch), args.reduce)
    if args.layers is not None:
        if cfg.family == "encdec" or not 0 < args.layers <= cfg.num_layers:
            raise ValueError(f"--layers {args.layers}: keeps 1..{cfg.num_layers} "
                             "layers of a decoder-only config")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    max_seq = args.prompt_len + args.gen
    cut = "" if args.layers is None else f", first {args.layers} layers"
    print(f"serving {cfg.name} (reduced x{args.reduce}{cut}) batch={args.batch} "
          f"cache={max_seq} on {dev}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtype = getattr(torch, cfg.dtype)
    params = init_params(param_specs_for(cfg), gen, dtype, dev)
    state = init_params(state_specs_for(cfg, args.batch, max_seq), gen, dtype,
                        dev)
    serve = make_serve_step(cfg)
    prompts = torch.randint(0, min(cfg.vocab, PROMPT_VOCAB),
                            (args.batch, args.prompt_len), generator=gen,
                            device=dev, dtype=torch.int32)

    def step(token, pos):
        cache_len = torch.full((args.batch,), pos, dtype=torch.int32, device=dev)
        batch = {"token": token, "cache_len": cache_len}
        if cfg.mrope:
            batch["positions"] = torch.full((3, args.batch, 1), pos,
                                            dtype=torch.int32, device=dev)
        return serve(params, state, batch)

    # prefill by stepping the prompt tokens (cache fills token-by-token)
    _sync(dev)
    t0 = time.perf_counter()
    tok = prompts[:, 0]
    for i in range(args.prompt_len):
        tok, state = step(prompts[:, i:i + 1], i)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    # generate
    out = []
    t0 = time.perf_counter()
    for i in range(args.gen):
        tok, state = step(tok[:, None], args.prompt_len + i)
        out.append(tok)
    toks = torch.stack(out, dim=1).cpu()
    dt = time.perf_counter() - t0
    res = ServeResult(cfg, toks, t_prefill, dt)
    print(f"prefill {args.prompt_len} steps in {t_prefill:.2f}s; "
          f"generated {args.gen} x {args.batch} tokens in {dt:.2f}s "
          f"({res.tokens_per_second:.1f} tok/s)", flush=True)
    print("sample:", toks[0][:16].tolist(), flush=True)
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise RuntimeError("generated token ids outside [0, vocab)")
    return res


if __name__ == "__main__":
    main()
