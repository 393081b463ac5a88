#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port of the twin on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(``--profile`` adds ``torch.profiler`` traces of the DES, of the
calibrated and the joint E2 runs, of one what-if call at D, of one
SmolLM-360M prefill call and of 16 serve steps, and of one Mamba2-370M
and one Zamba2-1.2B prefill call:
device busy time, idle share, top kernels, and the ``ssd_chunk`` and
flash-attention shares of the SSM prefills' busy time.)

Phases (each passes or the script exits non-zero without a result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at ragged ones (``calib_mape_grid`` at
   ``calib_cases``: the E2 window with 64 and 9216 random candidates, the
   E2 joint grid as built and shuffled, the per-host refit, T=97, T=1,
   C=1, H=2500, zero-real bins and an all-zero window, and the per-lane
   candidate rows of a fleet (``calib_lane_cases``: 64 lanes at E2's
   window, 16 lanes of refined joint grids, the per-host rows of 8 lanes),
   rtol 1e-4 atol 1e-3, with a fleet's lanes equal bit for bit to the
   calls each lane makes alone; flash attention at the JAX
   attention sweep's shapes, the bf16 tensor-core route at every head dim,
   ragged, decode, Skv > Sq and non-causal shapes, and SmolLM-360M's and
   Zamba2-1.2B's prefill shapes in bf16 and f32, the shapes phase
   13's runs give it, and phase 14's: each family's prefill attention in
   bf16 (Seamless's non-causal encoder and cross-attention), the QK/V
   head-dim pairs (80, 80), (96, 64) and (192, 128) in f32 at their
   prefill shapes and ragged on both routes, the padded pairs (no
   instantiation of their own, ``PADDED_FLASH_PAIRS``: the reduced MLA and
   StableLM configs' (16, 8), (20, 20), (24, 16), (40, 40), (48, 32), odd
   (36, 20) and (17, 9), and (256, 256)) on both routes, causal with
   Skv > Sq and non-causal, phase 16's training shapes
   (bf16 at full width, f32 at [1, 128], bf16 at ``--reduce 32`` and
   ``--reduce 8``) and phase 20's (each reduced config's prefill on the
   serving prompt, bf16; the reduced MLA configs' f32 prefill), each
   against the plain
   version in f32 at a bar set by the route's rounding (``FLASH_CASES``),
   and there with ``return_lse=True``: the same output bit for bit, the
   rows' lse against the plain version's (``LSE_RTOL``, ``LSE_ATOL``);
   ``des_readout`` at ``READOUT_2D`` and, with per-lane operands, at
   ``READOUT_LANES`` (the what-if batch, a week under 64 lanes, one lane,
   one bin, one host, five host chunks, every warp split, the serving
   fleet's window) and at the fleet's window as its step gives it
   (``[S, 1]`` rows or one number each, a per-lane carbon column), 4 power
   models x 2 precisions, rtol 1e-5 atol 1e-6 (bf16 performance leaves
   within one bf16 ulp);
   ``ssd_chunk`` at the JAX SSD sweep's shapes, at both Mamba2-family
   prefill shapes and at a ragged 200-row chunk, at those last three again
   with a long memory and at the longest chunks, 255 and 511 rows, rtol/atol
   1e-4; ``des_place`` at ``place_cases``: E2's week as the main path
   places it, under 4 policies x backfill {0, 8} and with a 16-host outage
   beside a degraded window, the what-if batches C and D, one host and one
   job, a bin that hits ``max_starts_per_bin``, backfill windows up to 31,
   700 hosts (more than the 512 whose scores a lane takes in one batch),
   ``job_start``/``job_host``/attempts equal to the plain version run on
   CPU copies), and run each kernel twice for bitwise-equal results;
4. drive the twin's main path, experiment E2 at the paper's SURF-SARA size
   (277 hosts x 16 cores, 7 days, seed 22): uncalibrated, calibrated
   (r only) and joint calibration with one refine round, with the kernels'
   launch counts reset just before and read just after (one
   ``des_readout`` launch a window, one ``des_place`` launch a horizon:
   two a run, the twin's DES and the ground-truth telemetry's);
   then the calibrated windows once
   more under ``torch.profiler``, whose host-to-device copies and
   device-to-host reads may not exceed ``WINDOW_TRANSFERS``;
5. rerun the calibrated experiment on the CPU and require that the DES
   schedule the twin predicted from and the parameter stream equal the
   card run's own, and the MAPE stream within rtol 1e-5;
6. the fleet power map (``ops.power_sim``, which no library path calls)
   on the calibrated card run's own utilization field, counted, and held
   against that run's DES readout;
7. the what-if path (``whatif_phase``): ``Orchestrator.evaluate_whatif``
   on the calibrated E2 twin with examples/whatif_scaling.py's 19
   candidates and a diurnal carbon trace (20 lanes, one ``des_place``
   launch), held against the CPU rerun's calibrated twin (schedules and
   counts equal, prediction within rtol 1e-5, summaries' integers and
   proposal kinds equal); ``run_scenarios(fused_readout=True)`` at C (16
   lanes of 64 + 24 i hosts over 2 days) and D (E2's week under 64 lanes),
   one ``des_place`` and one ``des_readout`` launch a call, held against
   the unfused readout on the card (rtol 2e-4, the oracle's bar) and
   against a CPU rerun (schedules equal, floats within rtol 1e-5; at D of
   16 of its 64 lanes, ``WHATIF_D_CPU_LANES``, one per cap, hosts, failure
   and backfill combination); wall
   seconds a call and the DES's share;
8. the LM serving paths at full width and depth in bf16, for SmolLM-360M
   (dense), Mamba2-370M (SSM) and Zamba2-1.2B (hybrid):
   ``make_prefill_step`` on ``[4, 2048]`` tokens with each call's kernel
   launches counted (``LM_PATHS``: 32 flash-attention; 48 ``ssd_chunk``;
   38 ``ssd_chunk`` and 6 flash-attention), then ``launch/serve.py``'s
   ``main`` at ``--reduce 1 --batch 4 --prompt-len 32 --gen 64``;
9. each LM at full width, cut in depth, f32 (``CARD_VS_CPU``): prefill
   logits (S=256) and 8 greedy serve steps on the card against the same
   on the CPU;
10. time each kernel, its plain version and, where one exists, the one
   PyTorch call that computes the same (SDPA for attention), at the main
   paths' shapes (device time, median of 5 rounds of up to 20 calls, with
   the rounds' spread; ``calib_mape_grid`` also at the joint grid's own
   candidates, with all 9216 r distinct, at the per-host refit, and with
   per-lane candidate rows at the fleet's window, 64 x ``[144, 277]``;
   ``des_readout`` at ``READOUT_TIMED``, the lane shapes on the calibrated
   run's own field; ``power_sim`` on the E2 horizon and on readout D's
   number of elements; ``des_place`` at the E2 horizon, C and D, and with
   no placement (the bins alone), its plain version by wall time at the
   E2 horizon), each beside its bound: bytes, FMA-pipe and
   special-function (expf, logf) floors, the largest of them
   (``des_place``'s: its longest lane's attempts plus its bins times one
   decision step, timed alone, or the earlier design's attempts times its
   block's barrier round trip, whichever is smaller); and an empty kernel
   (``torch.cuda._sleep(0)``, one thread), the launch floor of the same
   timer; flash attention also at MiniCPM3-4B's and DeepSeek-V2-Lite's
   prefill shapes (QK/V head dims 96/64 and 192/128), at a padded pair,
   MiniCPM3-4B's prefill at ``--reduce 2`` (48/32 on the (64, 64)
   instantiation), and at that shape with the exact 64/64; and the flash call
   split into ``FLASH_ROWS_TP`` blocks of query rows as the port runs it
   where ``model`` does not divide the kv heads
   (``models.attention.flash_rows``: a shard's rows and the causal prefix
   of the keys), at ``FLASH_ROWS_SHAPES`` in bf16: each shard's output
   and lse against the unsplit kernel call's rows and against the plain
   version on the card, at the bf16 bars of ``FLASH_CASES`` and
   ``LSE_RTOL``/``LSE_ATOL``, its launches counted and its ms timed;
11. (``search_phase``) the optimizer and stage 3 on the card, run before
   the kernel timings so that its launches count in the kernels line;
12. (``serve_phase``, also before the timings) the streaming twin service
   (paper stage 1) at E2's width: (a) a 64-lane ``TwinService``, 56
   synthetic tenants and 8 replaying E2's ground truth under the diurnal
   carbon trace with their own base parameters (so the lanes' candidate
   rows differ), events shuffled and submitted in chunks, then 16 tenants
   repeating synthetic streams from the cache: every window equals a solo
   card ``twin_step`` bit for bit, streams in order, one ``des_readout``
   and one ``calib_mape_grid`` launch a batch; (b) the joint grid with one
   refine round on 16 lanes, two ``calib_mape_grid`` a batch, lanes equal
   solo; (c) kill and restore through a ``SessionStore`` equal to the
   uninterrupted run; (d) (b) on the CPU, parameters and counts equal,
   floats within rtol 1e-5; (e) a state blob from the card to the CPU and
   back, and E2 checkpointed after window 28 and resumed equal to phase
   4's run; (f) ``run_fleet`` of the 8 replay tenants over E2's 56
   windows, 56 launches of each kernel; (g) wall seconds a batch, fill,
   warm tenant-windows a second at full fill, the host's time in
   ``encode_result`` and ``digest_arrays``, and one profiled batch,
   retaken while its trace is short of a copy the host issued (its busy
   time is then logged as a lower bound);
13. (``train_phase``, also before the timings) training on the card: (a)
   the flash-attention and SSD autograd Functions' outputs, lse and
   gradients at SmolLM-360M's train shape and a ragged Skv > Sq shape (bf16
   and f32) and at Mamba2-370M's chunk shape, against the same Function on
   f32 CPU copies and against the plain version's autograd on the card;
   (b) ``make_train_step`` on SmolLM-360M and Mamba2-370M at full width and
   depth, bf16, 6 steps on ``[8, 256]`` tokens (``wq``/``wk`` rescaled):
   loss, grad norm and lr finite and the loss falling, ms and tokens/s,
   peak memory, the forward alone, the forward and backward under the
   config's remat ``"dots"`` and under ``"full"`` (ms and peak apart), and
   every step's flash-attention /
   ``ssd_chunk`` launches (a forward and its recompute under remat: two a
   layer), step 0 taken twice from one state to see whether the backward
   is bitwise repeatable, and step 0's loss and gradients at full depth
   on the card (bf16 and f32) against the CPU in f32; (c)
   ``launch/train.main`` with a crash injected at step 5 (``TRAIN_MAIN_ARGV``,
   cut to ``--reduce 4`` because a full-size checkpoint takes minutes to
   compress; the codec's rate is measured and logged): one restart from
   the step-4 checkpoint, and against an uninterrupted run the losses,
   the final state and the checkpoint files equal bit for bit; (d) each
   LM at full width, cut in depth, f32, 3 train steps on the card against
   the CPU; (e) examples/live_twin_training_torch.py at its defaults;
14. (``family_phase``, also before the timings) the LM families at full
   width in bf16, one model at a time, its memory freed after
   (``FAMILY_PATHS``): Qwen1.5-MoE-A2.7B (MoE), DeepSeek-V2-Lite (MLA + MoE,
   a dense layer 0), MiniCPM3-4B (MLA), StableLM-3B (head dim 80),
   Qwen2-VL-7B (M-RoPE, 1024 random patch embeddings, [3, 4, 2048]
   positions), Seamless-M4T medium (enc-dec, 512 random frames) and
   Command R+ 104B cut to 8 of its 64 layers (the whole does not fit one
   card; its full-size parameter count is logged): (a) ``make_prefill_step``
   on ``[4, 2048]`` tokens, flash launches counted per call (24, 27, 62,
   32, 28, 36 and 8); (b) ``launch/serve.py`` at ``--reduce 1 --batch 4
   --prompt-len 32 --gen 16``; (c) each at full width and 2 layers in f32,
   prefill logits (S=256) and 8 greedy serve steps on the card against the
   CPU, the MoE configs' expert ids compared first, call by call (a
   difference only where the CPU's probabilities nearly tie,
   ``MOE_TIE_GAP``), Seamless's serve state with its encoder's cross K/V;
15. (``shard_phase``, also before the timings) lane sharding over the
   card mesh: every card, or ``cuda:0`` four times on a host with one
   (the shards then run in turn on that card): (a) phase 12 (a)'s
   service with ``ServeConfig(shard=True, mesh=...)``, every window equal
   to phase 12's unsharded one bit for bit; (b) phase 12 (f)'s
   ``run_fleet`` sharded, and over 3 entries (8 lanes padded to 9),
   equal to the unsharded run; (c) phase 7's fused what-if C and D
   sharded, schedules and floats equal; (d) two batches of phase 11's
   search, sharded and unsharded, histories and proposals equal; (e)
   ``des_place``'s two probes on each distinct device of the mesh;
   launches counted per part and given per mesh entry (one of each
   kernel a step an entry);
16. (``family_train_phase``, also before the timings) training the
   MoE, MLA, StableLM, Command R+, VLM and enc-dec families: (d) the
   flash-attention Function's gradients at QK/V 96/64, 192/128, 80/80 and
   Seamless's cross-attention shape (Sq 256, Skv 64, non-causal), bf16
   and f32, against its f32 CPU run and the plain version's autograd on
   the card; (a) each at full width in bf16 (``FAMILY_TRAIN``: Qwen1.5-MoE
   2 of 24 layers, DeepSeek-V2-Lite 3 of 27, MiniCPM3-4B 32 of 62,
   StableLM-3B 28 of 32, Qwen2-VL-7B 4 of 28 on [4, 2048], Seamless whole,
   [8, 256] otherwise; Command R+ 1 of 64 layers, loss and gradients
   only) with ``train.main``'s frames and patches: the loss and gradients
   twice from one state, bitwise equal (required of the MoE families),
   then 5 AdamW steps through ``make_train_step`` (loss, grad norm, lr
   finite, the loss falling, ms, tokens/s, peak memory, exactly 2 flash
   launches an attention call a step); (b) step 0's loss and every
   gradient at full width and 2 layers, f32, [1, 128], card against CPU
   at phase 13's bars, MoE routing compared call by call (Command R+ at
   ``reduce_config(cfg, 4)``); (c) ``train.main`` at ``--reduce 32``
   through a crash for Seamless, Qwen2-VL, Qwen1.5-MoE and
   DeepSeek-V2-Lite, bitwise equal to an uninterrupted run; (e)
   ``train.main`` at ``--reduce 8 --steps 4`` for MiniCPM3-4B,
   DeepSeek-V2-Lite and StableLM-3B (``FAMILY_REDUCED_TRAIN``), two flash
   launches an attention call a step; every flash shape (a)-(e) give the
   kernel is one phase 3 checks;
17. (``meta_phase``, also before the timings) the meta passes: (a) the
   expert-parallel MoE branch at Qwen1.5-MoE-A2.7B's width (one layer, x
   [4, 2048, 2048] on grids that make the router's logits exact), over
   ``cuda:0`` x 4 on ``("model",)`` against the one-shard ``moe_ffn``
   (routing ids, keep and slots of each shard exact, y rel L2 ``EP_REL_L2``,
   f32 and bf16) and over ``cuda:0`` x 8 on ``("data", "model")`` 2x4
   against the same call on the CPU (decisions exact, f32 at rtol
   ``EP_CPU_RTOL``), ms beside the one-shard call's; (b) Qwen1.5-MoE at 2
   layers of full width, f32, prefilled on ``[4, 2048]`` under
   ``ShardingCtx(mesh=<cuda:0 x 4>, mode="serve")`` (the step factory binds
   it with ``use_ctx``): last logits
   at phase 14's bar against the unsharded prefill, one flash launch an
   attention layer; (c) ``analysis.cost.trace_cost`` on ``meta`` and on the
   card (``META_CELLS``: SmolLM-360M, Mamba2-370M, Qwen1.5-MoE at 2 layers;
   a train step on [8, 256], a prefill of [4, 2048], a batch-4 decode step
   over a 2048 cache, bf16): FLOPs equal, bytes within 1 %, ops printed, the
   meta live bytes plus the arguments within [0.8, 1.2] of the card's
   peak, the H100 roofline bound at most the step's median ms; (d)
   ``python -m repro_torch.launch.dryrun`` (``DRYRUN_ARGV``: SmolLM-360M's
   four shapes and ``DRYRUN_CELLS``, the cells torch 2.11's DTensor once
   fell back on) in a subprocess started after the build, exit 0, its
   cells ``ok`` (``long_500k`` skipped for a full-attention arch), none
   with a DTensor fallback; (e) the per-device dry-run's count
   (``META_SHARDED``: SmolLM-360M, Mamba2-370M and StableLM-3B at 2
   layers, a train step on [8, 256] and a prefill of [4, 2048], bf16, over
   a ``(data 2, model 2)`` mesh, whose ``model`` divides their
   vocabularies; Seamless-M4T-medium's train step over ``(data 1, model
   4)``, which does not divide its 256206, so its CE splits the rows; each
   weight product's backward on the device's own shards,
   ``sharding.matmul``, and the CE's on the device's shard of the logits,
   ``sharding.nll_sum``) as DTensors in one ``fake`` process group, traced on
   ``meta`` shards and on ``cuda:0`` shards: FLOPs and ops equal, bytes
   within 1 %, collective counts and wire bytes equal, the meta live-byte
   peak within [0.8, 1.2] of the card's ``max_memory_allocated`` for the
   step less what it held before, and the shards' flash-attention /
   ``ssd_chunk`` launches counted (SmolLM's 5 kv heads do not split over
   ``model`` 2: its flash calls split their query rows), then the median
   ms of one device's shard step on the card (``shard_step_ms``; an op
   the count ran on gathered inputs, which runs nowhere else, fails the
   phase; ``shard_compare.py`` takes it for checkouts in turns); then
   (``META_DEPTH``) SmolLM-360M's train step on [8, 2048] at 2 and 4 layers under
   ``remat="full"`` and ``"dots"`` (each remat region keeps its residuals
   split over ``model``, ``sharding.checkpoint``), held meta = card as
   above, and its peak a layer on the card within [0.8, 1.2] of meta's; (f) one
   SmolLM-360M attention layer at full width on ``CP_X`` tokens, f32 and
   bf16, on the card: the flash call split into ``CP_TP`` blocks of query
   rows, each through the per-shard functions at its coordinate
   (``flash_rows``, ``flash_rows_backward``), the layer's outputs put
   together and dq put together, dk and dv summed over the shards,
   against the unsplit layer's (``FlashAttention``), relative L2 within
   ``CP_REL_L2``, one flash launch a shard;
18. (``examples_phase``, also before the timings) the five user-facing
   examples with a torch side (``EXAMPLES``: quickstart, E1's
   reproduce_footprinter, fleet_of_twins, whatif_scaling, twin_service),
   each ``main`` at its defaults, the JAX example's sizes, on the card and
   then on the CPU: the kernels each path must launch, counted from 0
   (``example_counts_diff``), every ``des_place`` schedule equal, the
   parameter streams exact, MAPE streams and the what-if sweep's summaries'
   floats within rtol 1e-5 and their integers equal, the service's cache
   hits and its restored state's bits equal (``example_diff``; the
   what-if example's CPU rerun is its sweep, ``WHATIF_EXAMPLE``); wall
   seconds and launches logged;
19. (``des_roofline_phase``, also before the timings) the DES roofline
   of ``analysis/roofline_torch.py`` at its default 2 days on the card,
   then its counts on the CPU: each phase's (placement, readout, total)
   FLOPs and bytes equal on the two, each card ``wall_s`` at least its
   ``bound_s``, the ``des_place`` launches counted; its table logged;
20. (``reduced_phase``, also before the timings) the reduced configs: (a)
   ``launch/serve.py``'s ``main`` at its defaults (``--reduce 8 --batch 4
   --prompt-len 32 --gen 64``) for all ten archs, and MiniCPM3-4B at
   ``--reduce 2`` and ``4``, DeepSeek-V2-Lite at ``4``, StableLM-3B at
   ``2`` and ``4`` (``REDUCED_SERVE``: with x8, every padded pair a
   registered config gives the flash kernel): the tokens in range and no
   flash launch (the launcher steps the prompt through the decode step),
   then the same config prefilled on ``[4, 32]`` tokens, exactly one flash
   launch an attention call and one ``ssd_chunk`` a Mamba layer; (b)
   MiniCPM3-4B x8 and DeepSeek-V2-Lite x4 at 2 layers, f32, prefill
   logits, 8 greedy serve steps and MoE ids on the card against the CPU at
   phase 14 (c)'s bars (``REDUCED_CVC``); every flash shape (a) and (b)
   give the kernel must be one of ``FLASH_CASES``, which phase 3 checks.

The seconds each phase took are logged after the kernel timings
(``phase seconds``).  The second-to-last line of standard output is the ``kernels`` JSON record,
the last line ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  The script needs no network and starts
no process that outlives it (``nvcc`` and ``nvidia-smi`` are waited for).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s,
#: float32 FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s, and
#: f32 products as a 3xTF32 split (TF32 tensor cores, 495 TFLOP/s, over
#: three passes: ssd_chunk's route)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_3XTF32_FLOPS = 495e12 / 3

#: experiment E2 at the paper's size
E2_DAYS = 7.0
E2_SEED = 22

#: the kernels the twin's E2 path launches
E2_KERNELS = ("calib_mape_grid", "des_readout", "des_place")

#: phase 11's search (examples/whatif_scaling.py:120-133): the objective's
#: weights, the carbon-aware cap and shift ranges, the optimizer's batches
SEARCH_OBJECTIVE = dict(w_gco2_kg=1.0, w_wait=0.5, w_unplaced=50.0, w_throttled=0.1)
SEARCH_RANGES = dict(carbon_cap_base_w=(35_000.0, 80_000.0), carbon_cap_slope=(-80.0, 0.0),
                     shift_bins=(0, 72))
SEARCH_CONFIG = dict(batch_size=16, generations=3)
#: (c), the search on the card against the CPU, cut in depth: E2's hosts
#: over 2 days, a 2-level grid and 2 refinement generations
SEARCH_CPU_DAYS, SEARCH_CPU_CONFIG = 2.0, dict(batch_size=16, generations=2, init_levels=2)
#: (d), stage 3: the window after which an approved scheduler change is
#: applied to the resident twin
STAGE3_APPLY_AT = 28

#: traces of E2's DES taken again, at most, where one lost its des_place
#: launch (``--profile``)
MAX_TRACE_RETRIES = 10
#: phase 12's profiled batch taken again, at most, where its trace is short
#: of a copy the host issued: a process whose traces lose the batch's
#: host-to-device copies has lost them in every retake, so few are tried
SERVE_TRACE_RETRIES = 2

#: the card every phase runs on
DEVICE = "cuda"

#: SmolLM-360M prefill: batch, sequence, timed calls after the first
PREFILL_B, PREFILL_S, PREFILL_CALLS = 4, 2048, 5

#: the serving launcher at full size
SERVE_ARGV = ["--reduce", "1", "--batch", "4", "--prompt-len", "32",
              "--gen", "64", "--device", DEVICE]

#: the prefills' attention shapes, (b, hq, hkv, sq, skv, d, dv): QK head
#: dim d, V head dim dv.  SmolLM-360M (GQA) and Zamba2-1.2B's shared block;
#: then phase 14's families: StableLM-3B (head dim 80), the MLA of
#: MiniCPM3-4B and DeepSeek-V2-Lite (QK nope + rope, V of its own width),
#: Qwen2-VL-7B and Command R+ (GQA, 128), Qwen1.5-MoE (128), and
#: Seamless-M4T's non-causal encoder (512 frames) and cross-attention
#: (2048 decoder queries against the 512 frames)
PREFILL_FLASH = (PREFILL_B, 15, 5, PREFILL_S, PREFILL_S, 64, 64)
PREFILL_FLASH_ZAMBA2 = (PREFILL_B, 32, 32, PREFILL_S, PREFILL_S, 64, 64)
PREFILL_FLASH_STABLELM = (PREFILL_B, 32, 32, PREFILL_S, PREFILL_S, 80, 80)
PREFILL_FLASH_MINICPM3 = (PREFILL_B, 40, 40, PREFILL_S, PREFILL_S, 96, 64)
PREFILL_FLASH_DEEPSEEK = (PREFILL_B, 16, 16, PREFILL_S, PREFILL_S, 192, 128)
PREFILL_FLASH_QWEN2VL = (PREFILL_B, 28, 4, PREFILL_S, PREFILL_S, 128, 128)
PREFILL_FLASH_QWEN_MOE = (PREFILL_B, 16, 16, PREFILL_S, PREFILL_S, 128, 128)
PREFILL_FLASH_COMMAND_R = (PREFILL_B, 96, 8, PREFILL_S, PREFILL_S, 128, 128)
#: MiniCPM3-4B's prefill at ``--reduce 2``: QK 48 / V 32, a padded pair
#: (run on the (64, 64) instantiation), timed in phase 10
PREFILL_FLASH_MINICPM3_X2 = (PREFILL_B, 20, 20, PREFILL_S, PREFILL_S, 48, 32)
#: the other padded prefills phase 10 times beside the plain version and
#: SDPA: StableLM-3B at ``--reduce 2`` (40 / 40), DeepSeek-V2-Lite at
#: ``--reduce 4`` (48 / 32) and the widest pair the kernel takes (256, 256)
PREFILL_FLASH_PADDED = {"StableLM-3B x2": (PREFILL_B, 16, 16, PREFILL_S, PREFILL_S, 40, 40),
                        "DeepSeek-V2-Lite x4": (PREFILL_B, 4, 4, PREFILL_S, PREFILL_S, 48, 32),
                        "(256, 256)": (PREFILL_B, 8, 8, PREFILL_S, PREFILL_S, 256, 256)}
#: the padded (QK, V) head-dim pairs phase 3 checks on both routes
PADDED_FLASH_PAIRS = ((16, 8), (20, 20), (24, 16), (40, 40), (48, 32), (36, 20),
                      (17, 9), (256, 256))
#: phase 10's row-split flash check: the blocks of query rows, and the
#: shapes (SmolLM-360M's prefill, MiniCPM3-4B's MLA pair)
FLASH_ROWS_TP = 4
FLASH_ROWS_SHAPES = (PREFILL_FLASH, PREFILL_FLASH_MINICPM3)
#: its bar, the bf16 one of ``FLASH_CASES``: ``rtol |want| + atol ||p||``
FLASH_ROWS_BAR = (1e-2, 1.5e-2)
SEAMLESS_ENC_FLASH = (PREFILL_B, 16, 16, 512, 512, 64, 64)
SEAMLESS_CROSS_FLASH = (PREFILL_B, 16, 16, PREFILL_S, 512, 64, 64)

#: flash-attention checks, (b, hq, hkv, sq, skv, d, dv, causal, bf16, rtol,
#: atol), each against the plain version in f32 on the same inputs: the
#: JAX package's sweep (tests/test_kernels.py), f32 at its bar, then the bf16
#: route (the tensor-core kernel every prefill runs) at the sweep's bf16
#: shapes, every head dim (16, 32, 128), ragged rows (100, 257), decode
#: (Sq=1), Skv > Sq, non-causal, SmolLM-360M's and Zamba2-1.2B's
#: prefill shapes, and those two again in f32; then the shapes phase 13's
#: training runs give the kernel where (a) does not check them: the
#: reduced SmolLM of ``launch/train.main --reduce 4`` ((c)) and of the
#: live-twin example (``--reduce 8``, (e)) in bf16, and SmolLM-360M's
#: width at (d)'s [2, 256] in f32.  Last, phase 14's LM families: each
#: prefill's attention shape in bf16 (Seamless's encoder and its
#: cross-attention non-causal), the MLA pairs and StableLM's head dim 80
#: again in f32 at their prefill shapes, and the three new pairs ragged
#: (Sq 100 < Skv 257) on both routes.  An f32 case is held to
#: ``atol + rtol |want|``: there the f32 kernel (not the main path's) holds
#: all 32 KV tiles of a row to f32 rounding.  A bf16 case is held to
#: ``rtol |want| + atol ||p||`` (``flash_bar_use``), ``||p||`` the L2 norm
#: of the row's softmax weights: the kernel rounds its output to bf16 (up
#: to 2^-8 |want|) and each weight to bf16 before ``P V``, whose error in
#: a row is a sum of one rounding per key and scales with ``||p||``
#: (1 for a row that sees one key, ~0.03 for 2048 keys).  The bf16 bars
#: sit at about twice the largest of the CPU model's readings
#: (tests/test_torch_kernel_precision.py).
FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, 64, True, False, 2e-5, 2e-4),
    (2, 8, 2, 100, 100, 32, 32, True, False, 2e-5, 2e-4),
    (2, 4, 1, 64, 64, 64, 64, False, False, 2e-5, 2e-4),
    (1, 6, 2, 1, 96, 64, 64, True, False, 2e-5, 2e-4),
    (2, 4, 2, 128, 128, 64, 64, True, True, 1e-2, 1.5e-2),
    (1, 4, 4, 257, 257, 16, 16, True, False, 2e-5, 2e-4),
    (2, 4, 2, 100, 100, 16, 16, True, True, 1e-2, 1.5e-2),
    (2, 4, 2, 100, 100, 32, 32, True, True, 1e-2, 1.5e-2),
    (2, 4, 2, 100, 100, 128, 128, True, True, 1e-2, 1.5e-2),
    (1, 4, 4, 257, 257, 64, 64, True, True, 1e-2, 1.5e-2),
    (1, 6, 2, 1, 96, 64, 64, True, True, 1e-2, 1.5e-2),
    (1, 4, 2, 64, 200, 64, 64, True, True, 1e-2, 1.5e-2),
    (2, 4, 1, 100, 130, 128, 128, False, True, 1e-2, 1.5e-2),
    (*PREFILL_FLASH, True, True, 1e-2, 1.5e-2),
    (*PREFILL_FLASH, True, False, 2e-5, 2e-4),
    (*PREFILL_FLASH_ZAMBA2, True, True, 1e-2, 1.5e-2),
    (*PREFILL_FLASH_ZAMBA2, True, False, 2e-5, 2e-4),
    (8, 3, 1, 256, 256, 16, 16, True, True, 1e-2, 1.5e-2),
    (4, 1, 1, 128, 128, 16, 16, True, True, 1e-2, 1.5e-2),
    (2, 15, 5, 256, 256, 64, 64, True, False, 2e-5, 2e-4),
    # the LM families of phase 14: each prefill's attention in bf16, the
    # new head-dim pairs (80, 80), (96, 64) and (192, 128) also in f32 and
    # ragged on both routes
    (*PREFILL_FLASH_STABLELM, True, True, 1e-2, 1.5e-2),
    (*PREFILL_FLASH_MINICPM3, True, True, 1e-2, 1.5e-2),
    (*PREFILL_FLASH_DEEPSEEK, True, True, 1e-2, 1.5e-2),
    (*PREFILL_FLASH_QWEN2VL, True, True, 1e-2, 1.5e-2),
    (*PREFILL_FLASH_QWEN_MOE, True, True, 1e-2, 1.5e-2),
    (*PREFILL_FLASH_COMMAND_R, True, True, 1e-2, 1.5e-2),
    (*SEAMLESS_ENC_FLASH, False, True, 1e-2, 1.5e-2),
    (*SEAMLESS_CROSS_FLASH, False, True, 1e-2, 1.5e-2),
    (*PREFILL_FLASH_STABLELM, True, False, 2e-5, 2e-4),
    (*PREFILL_FLASH_MINICPM3, True, False, 2e-5, 2e-4),
    (*PREFILL_FLASH_DEEPSEEK, True, False, 2e-5, 2e-4),
    (2, 4, 2, 100, 257, 80, 80, True, True, 1e-2, 1.5e-2),
    (2, 4, 2, 100, 257, 96, 64, True, True, 1e-2, 1.5e-2),
    (2, 4, 2, 100, 257, 192, 128, True, True, 1e-2, 1.5e-2),
    (2, 4, 2, 100, 257, 80, 80, True, False, 2e-5, 2e-4),
    (2, 4, 2, 100, 257, 96, 64, True, False, 2e-5, 2e-4),
    (2, 4, 2, 100, 257, 192, 128, False, False, 2e-5, 2e-4),
    # phase 16: (a) each family's training attention at [8, 256] in bf16
    # (Qwen2-VL's [4, 2048] is phase 14's), (b) each at [1, 128] in f32
    # (Seamless's 512 random frames; Command R+ at reduce_config(cfg, 4)),
    # (c) the --reduce 32 runs of train.main in bf16
    (8, 16, 16, 256, 256, 128, 128, True, True, 1e-2, 1.5e-2),
    (8, 16, 16, 256, 256, 192, 128, True, True, 1e-2, 1.5e-2),
    (8, 40, 40, 256, 256, 96, 64, True, True, 1e-2, 1.5e-2),
    (8, 32, 32, 256, 256, 80, 80, True, True, 1e-2, 1.5e-2),
    (8, 96, 8, 256, 256, 128, 128, True, True, 1e-2, 1.5e-2),
    (8, 16, 16, 64, 64, 64, 64, False, True, 1e-2, 1.5e-2),
    (8, 16, 16, 256, 256, 64, 64, True, True, 1e-2, 1.5e-2),
    (8, 16, 16, 256, 64, 64, 64, False, True, 1e-2, 1.5e-2),
    (1, 16, 16, 128, 128, 128, 128, True, False, 2e-5, 2e-4),
    (1, 16, 16, 128, 128, 192, 128, True, False, 2e-5, 2e-4),
    (1, 40, 40, 128, 128, 96, 64, True, False, 2e-5, 2e-4),
    (1, 32, 32, 128, 128, 80, 80, True, False, 2e-5, 2e-4),
    (1, 24, 2, 128, 128, 32, 32, True, False, 2e-5, 2e-4),
    (1, 28, 4, 128, 128, 128, 128, True, False, 2e-5, 2e-4),
    (1, 16, 16, 512, 512, 64, 64, False, False, 2e-5, 2e-4),
    (1, 16, 16, 128, 128, 64, 64, True, False, 2e-5, 2e-4),
    (1, 16, 16, 128, 512, 64, 64, False, False, 2e-5, 2e-4),
    (4, 1, 1, 64, 64, 16, 16, True, True, 1e-2, 1.5e-2),
    (4, 1, 1, 64, 64, 16, 16, False, True, 1e-2, 1.5e-2),
    # phase 17 (b): Qwen1.5-MoE's prefill in f32
    (*PREFILL_FLASH_QWEN_MOE, True, False, 2e-5, 2e-4),
    # the padded pairs (no instantiation of their own; the kernel runs the
    # one of least Dp + Dvp, its padding zero-filled): the reduced MLA and
    # StableLM configs' (16, 8), (20, 20), (24, 16), (40, 40), (48, 32),
    # two odd ones, (36, 20) and (17, 9) (a copy width of 4 and of 1, an odd
    # V store), and (256, 256), the largest, on both routes, causal, GQA,
    # Skv > Sq; then non-causal in bf16
    *((2, 4, 2, 100, 257, d, dv, True, bf16, *bar)
      for d, dv in PADDED_FLASH_PAIRS
      for bf16, bar in ((True, (1e-2, 1.5e-2)), (False, (2e-5, 2e-4)))),
    (2, 4, 1, 64, 130, 20, 20, False, True, 1e-2, 1.5e-2),
    (2, 4, 1, 64, 130, 17, 9, False, True, 1e-2, 1.5e-2),
    (2, 4, 1, 64, 130, 256, 256, False, True, 1e-2, 1.5e-2),
    # phase 10's padded prefill (MiniCPM3-4B at --reduce 2), and the
    # padded shapes phase 16 (e) and (c) give the kernel: train.main at
    # --reduce 8 (MiniCPM3-4B, DeepSeek-V2-Lite, StableLM-3B) and
    # DeepSeek-V2-Lite's restart at --reduce 32
    (*PREFILL_FLASH_MINICPM3_X2, True, True, 1e-2, 1.5e-2),
    (8, 5, 5, 256, 256, 16, 8, True, True, 1e-2, 1.5e-2),
    (8, 2, 2, 256, 256, 24, 16, True, True, 1e-2, 1.5e-2),
    (8, 4, 4, 256, 256, 16, 16, True, True, 1e-2, 1.5e-2),
    (4, 1, 1, 64, 64, 16, 8, True, True, 1e-2, 1.5e-2),
    # phase 20: (a) each reduced config's prefill on the serving launcher's
    # [4, 32] prompt (REDUCED_SERVE: the ten archs at --reduce 8, then
    # MiniCPM3-4B x2 and x4, DeepSeek-V2-Lite x4, StableLM-3B x2 and x4;
    # Seamless x8's encoder over its 512 frames and the cross-attention to
    # them), (b) REDUCED_CVC's f32 prefill at 2 layers on [2, 256]
    *((*shape, True, True, 1e-2, 1.5e-2) for shape in (
        (4, 1, 1, 32, 32, 16, 16), (4, 2, 2, 32, 32, 16, 16), (4, 2, 2, 32, 32, 24, 16),
        (4, 5, 5, 32, 32, 16, 8), (4, 4, 4, 32, 32, 16, 16), (4, 3, 1, 32, 32, 16, 16),
        (4, 12, 1, 32, 32, 16, 16), (4, 20, 20, 32, 32, 48, 32),
        (4, 10, 10, 32, 32, 24, 16), (4, 4, 4, 32, 32, 48, 32),
        (4, 16, 16, 32, 32, 40, 40), (4, 8, 8, 32, 32, 20, 20))),
    (4, 2, 2, 512, 512, 16, 16, False, True, 1e-2, 1.5e-2),
    (4, 2, 2, 32, 512, 16, 16, False, True, 1e-2, 1.5e-2),
    (2, 5, 5, 256, 256, 16, 8, True, False, 2e-5, 2e-4),
    (2, 4, 4, 256, 256, 48, 32, True, False, 2e-5, 2e-4),
]

#: calib_mape_grid checks on random candidates, (B, T, H, C): the E2
#: window with the r-only grid's 64 and the joint grid's 9216 candidates
#: (here every r distinct), the per-host refit (B=277, H=1), a ragged
#: window (T=97), one bin, one candidate, 2500 hosts (five host chunks
#: of the kernel), and the live-twin example's windows (phase 13 (e): 25,
#: 50 and 75 steps of 4 virtual hosts, the default 64-point grid);
#: ``calib_cases`` adds the E2 joint grid itself
#: the fleet's calibration window: 64 lanes of E2's history, 64 candidates
#: a lane (phase 12's service)
CALIB_FLEET = (64, 144, 277, 64)
CALIB_SHAPES = [(1, 144, 277, 64), (1, 144, 277, 9216), (277, 144, 1, 64),
                (1, 97, 33, 130), (2, 1, 277, 64), (1, 144, 277, 1),
                (3, 300, 2500, 5), (1, 25, 4, 64), (1, 50, 4, 64), (1, 75, 4, 64)]

#: the special-function units' rate (expf, logf): 16 results a clock per
#: SM on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
#: instructions), times the SMs and the clock ``nvidia-smi`` reads
SFU_PER_CLOCK_PER_SM = 16

#: power_sim shapes: the JAX sweep's, then the E2 horizon
POWER_SIM_SHAPES = [(96, 17), (300, 277), (1024, 64), (2016, 277)]

#: des_readout checks: [T, H] calls, (T, H): the E2 window, a ragged
#: window, the E2 horizon (every axis on, ``readout_case``)
READOUT_2D = [(36, 277), (97, 13), (2016, 277)]

#: des_readout checks with the lane axis, (S, T, H), per-lane operands
#: (``lanes_case``): the JAX package's what-if batch (16 scenarios of 64 +
#: 24 i hosts over 2 days, benchmarks/whatif_batch.py), a week of the
#: paper's cluster under 64 what-if lanes, one lane, one bin, one host,
#: five host chunks of the kernel (H = 5000), 33 hosts, 130 hosts, and the
#: serving fleet's window (64 lanes of 36 bins x 277 hosts); with
#: READOUT_2D they take every warp split (1, 2, 4, 8)
READOUT_LANES = [(16, 576, 424), (64, 2016, 277), (1, 36, 277), (5, 1, 277),
                 (7, 50, 1), (3, 40, 5000), (4, 97, 33), (2, 300, 130),
                 (64, 36, 277)]

#: the serving fleet's window as ``state.twin_step_lanes`` gives it to the
#: readout: (lanes, bins, hosts)
READOUT_FLEET = (64, 36, 277)

#: des_readout timings, label -> (S, T, H): A and B as the E2 path calls
#: the kernel (scalar parameters, no scenario axis, random u), C and D
#: with per-lane operands on the calibrated card run's own [2016, 277]
#: field, cut or tiled to (T, H), each lane's window moved by 36 bins
READOUT_TIMED = {
    "A: E2 window": (1, 36, 277),
    "B: E2 horizon": (1, 2016, 277),
    "C: what-if batch, 16 lanes of 64 + 24 i hosts, 2 days": (16, 576, 424),
    "D: a week under 64 what-if lanes": (64, 2016, 277),
}

#: host-to-device copies and device-to-host reads (pinned and pageable)
#: in the 56 calibrated E2 windows, as a trace counts them on an H100 since
#: the readout takes its scalar operands as kernel parameters (168 copies,
#: 3 a window, where there were 612; 339 + 170 reads): the window path may
#: not add any
WINDOW_TRANSFERS = {"HtoD": 168, "DtoH": 509}

#: the LM prefill paths at full width and depth, bf16, [4, 2048] tokens:
#: arch -> kernel launches per prefill call (one flash launch per attention
#: layer, one ssd_chunk launch per Mamba2 layer; Zamba2-1.2B: 38 Mamba2
#: layers under 6 invocations of its shared attention block)
LM_PATHS = {
    "smollm-360m": {"flash_attention": 32},
    "mamba2-370m": {"ssd_chunk": 48},
    "zamba2-1.2b": {"ssd_chunk": 38, "flash_attention": 6},
}

#: ssd_chunk at the prefill paths' shapes, (BC, Q, H, P, G, N): B=4 rows of
#: 2048 tokens in chunks of 128
SSD_MAMBA2 = (PREFILL_B * PREFILL_S // 128, 128, 32, 64, 1, 128)
SSD_ZAMBA2 = (PREFILL_B * PREFILL_S // 128, 128, 64, 64, 1, 64)

#: ssd_chunk checks against the plain version, (shape, long memory): the
#: JAX sweep's shapes (tests/test_kernels.py), both prefill shapes, and a
#: ragged chunk of 200 rows (one chunk of a 200-token sequence) at N=128,
#: all at the sweep's bar rtol/atol 1e-4.  The sweep's decay (about
#: exp(-0.5) per row) leaves only the last ~18 rows of a chunk above the
#: bar in the states and in att; so the last three shapes run again with
#: a long memory (``ssd_inputs``), where exp(csum) stays O(1) across the
#: chunk and every row and key tile counts, and so do a 255-row chunk,
#: the longest ``ssd_chunked`` makes at the configs' ``ssd_chunk`` of 128
#: (S = 255), and a 511-row chunk, the longest at upstream Mamba2's 256,
#: where the kernel takes fewer heads per block to fit shared memory.
#: Last, phase 13 (d)'s shape, Mamba2-370M's width at [2, 256] tokens, in
#: both forms.
SSD_RAGGED = (8, 200, 8, 64, 1, 128)
SSD_LONGEST = (4, 255, 8, 64, 1, 128)
SSD_LONGEST_256 = (2, 511, 8, 64, 1, 128)
SSD_CASES = [((2, 16, 2, 8, 1, 16), False), ((3, 32, 4, 16, 2, 24), False),
             ((1, 64, 8, 32, 4, 64), False), (SSD_MAMBA2, False),
             (SSD_ZAMBA2, False), (SSD_RAGGED, False), (SSD_MAMBA2, True),
             (SSD_ZAMBA2, True), (SSD_RAGGED, True), (SSD_LONGEST, True),
             (SSD_LONGEST_256, True), ((4, 128, 32, 64, 1, 128), False),
             ((4, 128, 32, 64, 1, 128), True)]
SSD_TOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def torch_version() -> str:
    """The installed torch's version (DTensor places ops by version)."""
    import torch

    return torch.__version__


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


def calib_cases(torch, np, dev) -> list:
    """``(label, operands)`` of the calib checks (``CALIB_SHAPES``): random
    candidates, the E2 joint grid as ``candidate_grid`` builds it (runs of
    144 equal r that cross the kernel's 256-candidate tiles) and the same
    grid shuffled, a window with every third bin's real power zero, and
    an all-zero window (NaN for every candidate)."""
    from repro_torch.core import CalibrationSpec
    from repro_torch.core.calibrate import candidate_grid
    from repro_torch.core.power import PowerParams

    cases = [(f"B={b} T={t} H={h} C={c}",
              calib_inputs(torch, np, b, t, h, c, seed=b + t + h + c, device=dev))
             for b, t, h, c in CALIB_SHAPES]
    u, real, pi, pm, r = calib_inputs(torch, np, 1, 144, 277, 64, seed=3, device=dev)
    grid = candidate_grid(CalibrationSpec(mode="joint"), PowerParams(), device=dev)
    joint = (grid.p_idle, grid.p_max, grid.r)
    perm = torch.as_tensor(np.random.default_rng(4).permutation(grid.r.shape[0]),
                           device=dev)
    some_zero = real.clone()
    some_zero[:, ::3] = 0.0
    return cases + [
        ("B=1 T=144 H=277 C=9216 E2 joint grid", (u, real, *joint)),
        ("B=1 T=144 H=277 C=9216 E2 joint grid shuffled",
         (u, real, *(x[perm].contiguous() for x in joint))),
        ("B=1 T=144 H=277 C=64 every third bin zero", (u, some_zero, pi, pm, r)),
        ("B=1 T=144 H=277 C=64 all bins zero", (u, torch.zeros_like(real), pi, pm, r)),
    ] + list(calib_lane_cases(torch, np, dev).items())


def calib_lane_cases(torch, np, dev) -> dict:
    """The per-lane (candidate row) calib cases of a fleet, by label: 64
    lanes at E2's window with random rows (``CALIB_FLEET``), 16 lanes of
    joint grids refined around their own incumbents (as a refine round of
    ``calibrate_traced_lanes`` builds them), and the per-host refit of 8
    lanes, ``[8 x 277]`` rows over 8 candidate rows."""
    from repro_torch.core import CalibrationSpec
    from repro_torch.core.calibrate import _grid_traced_lanes
    from repro_torch.core.power import PowerParams

    rng = np.random.default_rng(6)

    def rows(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=dev)

    b, t, h, c = CALIB_FLEET
    u, real = calib_inputs(torch, np, b, t, h, 1, seed=7, device=dev)[:2]
    spec = CalibrationSpec(mode="joint", refine_iters=1)
    best = PowerParams(p_idle=rows(60, 80, 16), p_max=rows(300, 400, 16), r=rows(1.5, 5.5, 16))
    span_r = (spec.r_hi - spec.r_lo) * spec.refine_shrink
    span_s = (spec.scale_hi - spec.scale_lo) * spec.refine_shrink
    grid = _grid_traced_lanes(spec, best, torch.clamp(best.r - span_r / 2, min=1.0),
                              best.r + span_r / 2, 1.0 - span_s / 2, 1.0 + span_s / 2)
    ph_u, ph_real = calib_inputs(torch, np, 8 * h, t, 1, 1, seed=8, device=dev)[:2]
    return {
        f"B={b} T={t} H={h} C={c} per-lane rows (the fleet)":
            (u, real, rows(50, 90, (b, c)), rows(250, 450, (b, c)), rows(1, 6, (b, c))),
        f"B=16 T={t} H={h} C={grid.r.shape[1]} refined joint rows":
            (u[:16], real[:16], grid.p_idle, grid.p_max, grid.r),
        f"B=8x{h} T={t} H=1 C={c} per-host refit rows [8, {c}]":
            (ph_u, ph_real, rows(50, 90, (8, c)), rows(250, 450, (8, c)), rows(1, 6, (8, c))),
    }


def calib_agrees(torch, got, want) -> tuple[float, bool]:
    """``(max |err|, within the bar)`` of calib MAPEs against the plain
    version: rtol 1e-4, atol 1e-3, NaN exactly where the plain version has
    NaN (an all-zero window)."""
    both_nan = torch.isnan(got) & torch.isnan(want)
    err = float(torch.where(both_nan, 0.0, (got - want).abs()).max())
    return err, got.shape == want.shape and bool(
        torch.allclose(got, want, rtol=1e-4, atol=1e-3, equal_nan=True))


def check_calib(torch, np, ops, ref, dev) -> float:
    """calib_mape_grid against its plain version at ``calib_cases``, twice
    each for bitwise-equal results.  Returns the largest absolute error."""
    worst = 0.0
    for label, args in calib_cases(torch, np, dev):
        got = ops.calib_mape_grid(*args)
        again = ops.calib_mape_grid(*args)
        torch.cuda.synchronize()
        err, ok = calib_agrees(torch, got, ref.calib_mape_grid_ref(*args))
        if not ok:
            fail(f"calib_mape_grid {label}: max |err| {err} beyond rtol 1e-4 atol 1e-3")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            fail(f"calib_mape_grid {label}: two runs differ bitwise")
        worst = max(worst, err)
        log(f"calib_mape_grid {label}: max |err| {err:.3g} (rtol 1e-4, atol 1e-3), "
            "bitwise repeatable")
    # a fleet's lane gives what that lane's own call gives: the solo window
    # [T, H] with [C] candidates, the solo per-host refit [H, T, 1]
    lanes = calib_lane_cases(torch, np, dev)
    u, real, pi, pm, r = next(iter(lanes.values()))
    fleet = ops.calib_mape_grid(u, real, pi, pm, r)
    for d in (0, 37, u.shape[0] - 1):
        if not torch.equal(fleet[d].view(torch.int32), ops.calib_mape_grid(
                u[d], real[d], pi[d], pm[d], r[d]).view(torch.int32)):
            fail(f"calib_mape_grid: lane {d} of B={u.shape[0]} differs from its B=1 call")
    u, real, pi, pm, r = list(lanes.values())[2]
    h = u.shape[0] // pi.shape[0]
    per_host = ops.calib_mape_grid(u, real, pi, pm, r)
    for d in (0, 5):
        rows = slice(d * h, (d + 1) * h)
        if not torch.equal(per_host[rows].view(torch.int32), ops.calib_mape_grid(
                u[rows], real[rows], pi[d], pm[d], r[d]).view(torch.int32)):
            fail(f"calib_mape_grid: lane {d}'s per-host rows differ from its own call")
    log("calib_mape_grid: lanes 0, 37 and 63 of the fleet call equal their B=1 calls, "
        "and lanes 0 and 5 of the per-host rows their B=277 calls, bit for bit")
    return worst


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


def lanes_case(torch, np, u, seed, hosts=None) -> dict:
    """Per-lane readout operands for ``u`` ``[S, T, H]``, every axis on, as
    the scenario engine batches them: host rows ``[S, H]`` (``p_idle``,
    ``p_max``, mask, failures), ``r`` ``[S, 1]``, caps ``[S, T]``, peak and
    PUE ``[S]``; carbon, ambient and price ``[T]``, shared by the lanes.
    Lane i's mask keeps its first ``hosts[i]`` hosts (80 % at random
    without ``hosts``)."""
    s, t, h = u.shape
    dev = u.device
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    p_idle = rng.uniform(40.0, 90.0, (s, h))
    p_max = rng.uniform(200.0, 420.0, (s, h))
    mask = (rng.uniform(size=(s, h)) < 0.8 if hosts is None
            else np.arange(h)[None, :] < np.asarray(hosts)[:, None])
    rough = (p_idle * mask).sum(1) + 0.4 * (p_max * mask).sum(1)
    fs = np.where(rng.uniform(size=(s, h)) < 0.4, rng.integers(0, max(t, 1), (s, h)),
                  np.iinfo(np.int32).max).astype(np.int32)
    fe = np.minimum(fs.astype(np.int64) + rng.integers(3, max(t // 2, 4), (s, h)),
                    np.iinfo(np.int32).max).astype(np.int32)
    return dict(
        p_idle=f(p_idle), p_max=f(p_max), r=f(rng.uniform(1.2, 3.4, (s, 1))),
        mask=torch.as_tensor(mask, device=dev),
        cap_t=f(rng.uniform(0.5, 1.1, (s, t)) * rough[:, None]),
        fail_start=torch.as_tensor(fs, device=dev),
        fail_end=torch.as_tensor(fe, device=dev),
        fail_kill=torch.as_tensor(rng.uniform(size=(s, h)) < 0.7, device=dev),
        peak_tflops=f(rng.uniform(100.0, 500.0, s)),
        pue_base=f(rng.uniform(1.05, 1.4, s)),
        pue_amb_coeff=f(rng.uniform(0.0, 0.05, s)),
        pue_amb_ref=f(rng.uniform(10.0, 22.0, s)),
        pue_load_coeff=f(rng.uniform(0.0, 0.25, s)),
        intensity=f(rng.uniform(50.0, 600.0, t)),
        ambient=f(rng.uniform(-5.0, 38.0, t)),
        price=f(rng.uniform(-0.05, 0.45, t)))


def readout_cases(torch, np, dev) -> list:
    """``(label, u, operands)`` of the des_readout checks: ``READOUT_2D``
    (``u`` ``[T, H]``) and ``READOUT_LANES`` (``[S, T, H]``, u uniform in
    [0, 1.15), per-lane operands); the what-if batch's lane i masks all
    but its first 64 + 24 i hosts.  Then two cases whose host rows are each
    one number, the kernel's path that stages none: the E2 window, and 3
    lanes with every host down in bins 10-19.  Last, the serving fleet's
    window (``READOUT_FLEET``) in the two forms a fleet step can give it:
    each lane's power parameters as ``[S, 1]`` rows, and one number for
    every lane, both under a per-lane carbon column ``[S, T]``."""
    cases = [(f"T={t} H={h}", *readout_case(torch, np, t, h, seed=t + h, device=dev))
             for t, h in READOUT_2D]
    for s, t, h in READOUT_LANES:
        rng = np.random.default_rng(s * t + h)
        u = torch.as_tensor(rng.uniform(0.0, 1.15, (s, t, h)).astype(np.float32),
                            device=dev)
        hosts = [64 + 24 * i for i in range(s)] if (s, t, h) == (16, 576, 424) else None
        cases.append((f"S={s} T={t} H={h}", u, lanes_case(torch, np, u, s + t + h, hosts)))
    rows = dict(p_idle=65.0, p_max=330.0, r=2.4, mask=1.0)
    u, kw = readout_case(torch, np, 36, 277, seed=5, device=dev)
    cases.append(("T=36 H=277 rows one number each", u, dict(kw, **rows, fail_start=None,
                                                             fail_end=None, fail_kill=None)))
    u = torch.as_tensor(np.random.default_rng(6).uniform(
        0.0, 1.15, (3, 40, 277)).astype(np.float32), device=dev)
    cases.append(("S=3 T=40 H=277 rows one number each, all hosts down in bins 10-19", u,
                  dict(lanes_case(torch, np, u, 7), **rows, fail_start=10, fail_end=20,
                       fail_kill=1.0)))
    s, t, h = READOUT_FLEET
    rng = np.random.default_rng(8)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    u = f(rng.uniform(0.0, 1.15, (s, t, h)))
    carbon = dict(intensity=f(rng.uniform(50.0, 600.0, (s, t))), peak_tflops=120.0)
    cases.append((f"S={s} T={t} H={h} the fleet step's operands: [S, 1] rows, carbon [S, T]",
                  u, dict(carbon, p_idle=f(rng.uniform(40.0, 90.0, (s, 1))),
                          p_max=f(rng.uniform(200.0, 420.0, (s, 1))),
                          r=f(rng.uniform(1.2, 3.4, (s, 1))))))
    cases.append((f"S={s} T={t} H={h} rows one number each, carbon [S, T]", u,
                   dict(carbon, p_idle=65.0, p_max=330.0, r=2.4)))
    return cases


#: the placement cases of E2's week: 4 policies x backfill {0, 8}, and a
#: 16-host outage (hosts 0-15, bins 576-720) beside a degraded window
#: (hosts 16-31, bins 300-900) under worst fit and best fit with backfill 4
E2_OUTAGE = ((0, 16, 576, 720, "outage"), (16, 32, 300, 900, "degraded"))

#: the what-if batches: C, the JAX package's (16 lanes of 64 + 24 i hosts
#: over 2 days, benchmarks/whatif_batch.py:70-77, padded to 424 hosts), and
#: D, E2's week under 64 lanes: 4 policies x backfill {0, 4} x {no failure,
#: hosts 0-15 out at bins 576-720} x hosts {277, 240} x {uncapped, capped at
#: WHATIF_D_CAP_W}; the capped half repeats the uncapped half's placement
WHATIF_C_DAYS, WHATIF_C_HOSTS = 2.0, 424
WHATIF_D_CAP_W = 45_000.0


def failures(fault, spec):
    """``HostFailure`` windows (``fault`` is ``repro_torch.runtime.fault``)
    from ``(first host, end host, start bin, end bin, kind)`` rows."""
    return tuple(fault.HostFailure(h, a, b, kind)
                 for lo, hi, a, b, kind in spec for h in range(lo, hi))


def whatif_c(psc) -> list:
    return [psc.Scenario(name=f"h{64 + 24 * i}", num_hosts=64 + 24 * i) for i in range(16)]


#: the lanes of D rerun on the CPU: one per (cap, hosts, failure, backfill)
#: combination, the policy cycling, so every axis value is held against the
#: CPU; cut from all 64 when phase 13 (training, ~70 s) came, which would
#: otherwise take the script past its earlier 333-417 s (the 64-lane rerun
#: took 78-100 s of phase 7)
WHATIF_D_CPU_LANES = [4 * i + i % 4 for i in range(16)]


def whatif_d(psc, fault) -> list:
    out = []
    for cap in (None, WHATIF_D_CAP_W):
        for hosts in (277, 240):
            for fail in ((), failures(fault, E2_OUTAGE[:1])):
                for depth in (0, 4):
                    for policy in ("first_fit", "best_fit", "worst_fit", "random_fit"):
                        out.append(psc.Scenario(
                            name=f"{policy}-b{depth}-h{hosts}{'-out' if fail else ''}"
                                 f"{'-cap' if cap else ''}",
                            num_hosts=hosts, policy=policy, backfill_depth=depth,
                            failures=fail, power_cap_w=cap))
    return out


def whatif_candidates(psc) -> list:
    """The 19 candidates of examples/whatif_scaling.py:59-72: 4 policies x
    hosts {64, 128, 200, 277} (backfill 8 except worst fit), a carbon-aware
    cap, and shifts of 3 h and 6 h."""
    cands = [psc.Scenario(name=f"{p}-h{h}", policy=p, num_hosts=h,
                          backfill_depth=0 if p == "worst_fit" else 8)
             for h in (64, 128, 200, 277)
             for p in ("best_fit", "first_fit", "random_fit", "worst_fit")]
    return cands + [
        psc.Scenario(name="carbon-cap", carbon_cap_base_w=48_000.0, carbon_cap_slope=-60.0),
        psc.Scenario(name="shift-3h", shift_bins=36),
        psc.Scenario(name="shift-6h", shift_bins=72)]


def place_inputs(ss) -> tuple[tuple, dict]:
    """``ops.des_place``'s operands of a ScenarioSet, as the DES passes them."""
    w = ss.workload
    kw = dict(max_backfill=ss.max_backfill)
    if ss.has_failures:
        kw.update(fail_start=ss.fail_start, fail_end=ss.fail_end, fail_kill=ss.fail_kill)
    return (w.submit_bin, w.duration_bins, w.cores, w.valid, ss.host_mask_s,
            ss.cores_per_host, ss.policy_id, ss.backfill_depth), kw


def random_place_case(torch, np, seed, s, j, h, t, mb, fails, dev) -> tuple[tuple, dict]:
    """Random placement operands: a contended trace a lane, 1..h active
    hosts, 6-11 cores a host, every policy, depths up to ``mb``, and with
    ``fails`` outage and drain windows on 40 % of the hosts."""
    rng = np.random.default_rng(seed)
    x = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    args = (x(np.sort(rng.integers(0, max(t // 2, 1), (s, j)), axis=1).astype(np.int32)),
            x(rng.integers(0, 9, (s, j)).astype(np.int32)),
            x(rng.integers(1, 9, (s, j)).astype(np.int32)),
            x(rng.uniform(size=(s, j)) < 0.95),
            x(np.arange(h)[None, :] < rng.integers(1, h + 1, (s, 1))),
            x(rng.integers(6, 12, s).astype(np.int32)),
            x(rng.integers(0, 4, s).astype(np.int32)),
            x(rng.integers(0, mb + 1, s).astype(np.int32)))
    kw = dict(max_backfill=mb)
    if fails:
        fs = np.where(rng.uniform(size=(s, h)) < 0.4, rng.integers(0, t, (s, h)),
                      np.iinfo(np.int32).max).astype(np.int32)
        fe = np.minimum(fs.astype(np.int64) + rng.integers(1, max(t // 2, 2), (s, h)),
                        np.iinfo(np.int32).max).astype(np.int32)
        kw.update(fail_start=x(fs), fail_end=x(fe), fail_kill=x(rng.uniform(size=(s, h)) < 0.6))
    return args, kw


def place_cases(torch, np, dev) -> list:
    """``(label, args, kw, unique)`` of the des_place checks: E2's week
    (the main path's one lane; 4 policies x backfill {0, 8}; the outage
    and degraded windows), the what-if batches C and D, one host and one
    job, a bin that hits ``max_starts_per_bin``, and backfill windows up
    to 31 with random failures, on up to 700 hosts (more than 512, the
    most whose scores a lane takes in one batch of registers).  ``unique``
    lanes lead; lane i repeats lane ``i % unique``."""
    from repro_torch.core import scenarios as psc
    from repro_torch.runtime import fault
    from repro_torch.traces.schema import DatacenterConfig, Workload
    from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like

    dc = DatacenterConfig()
    t_e2 = int(E2_DAYS * BINS_PER_DAY)
    w = make_surf22_like(SurfTraceSpec(days=E2_DAYS, seed=E2_SEED), dc, device=dev)
    w_c = make_surf22_like(SurfTraceSpec(days=WHATIF_C_DAYS), dc, device=dev)
    t_c = int(WHATIF_C_DAYS * BINS_PER_DAY)
    out = []

    def batch(label, wl, scs, t, unique=None, **build):
        ss = psc.build_scenario_set(wl, dc, scs, **build)
        args, kw = place_inputs(ss)
        out.append((label, args, dict(kw, t_bins=t), unique or len(scs)))

    batch("E2 week, the main path's lane (worst fit)", w, [psc.Scenario()], t_e2)
    batch("E2 week, 4 policies x backfill {0, 8}", w,
          [psc.Scenario(policy=p, backfill_depth=d) for d in (0, 8)
           for p in ("first_fit", "best_fit", "worst_fit", "random_fit")], t_e2)
    batch("E2 week, hosts 0-15 out, 16-31 degraded", w,
          [psc.Scenario(failures=failures(fault, E2_OUTAGE)),
           psc.Scenario(policy="best_fit", backfill_depth=4,
                        failures=failures(fault, E2_OUTAGE))], t_e2)
    batch("C: 16 lanes of 64 + 24 i hosts, 2 days", w_c, whatif_c(psc), t_c,
          max_hosts=WHATIF_C_HOSTS)
    batch("D: E2 week under 64 lanes", w, whatif_d(psc, fault), t_e2, unique=32)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    one = Workload(i32([[2]]), i32([[3]]), i32([[4]]), torch.ones((1, 1, 1), device=dev),
                   torch.ones((1, 1), dtype=torch.bool, device=dev))
    out.append(("H=1 J=1", (one.submit_bin, one.duration_bins, one.cores, one.valid,
                            torch.ones((1, 1), dtype=torch.bool, device=dev), i32([4]),
                            i32([0]), i32([0])), dict(max_backfill=0, t_bins=8), 1))
    crowd = (i32(np.zeros((2, 40))), i32(np.full((2, 40), 3)), i32(np.ones((2, 40))),
             torch.ones((2, 40), dtype=torch.bool, device=dev),
             torch.ones((2, 4), dtype=torch.bool, device=dev), i32([16, 16]), i32([2, 3]),
             i32([0, 2]))
    out.append(("a bin that hits max_starts_per_bin (5)", crowd,
                dict(max_backfill=2, t_bins=12, max_starts_per_bin=5), 2))
    for i, (s, j, h, t, mb, fails) in enumerate([(6, 400, 32, 72, 31, True),
                                                  (8, 60, 5, 40, 3, True),
                                                  (8, 120, 9, 64, 0, False),
                                                  (4, 500, 700, 96, 8, True)]):
        args, kw = random_place_case(torch, np, 300 + i, s, j, h, t, mb, fails, dev)
        out.append((f"random S={s} J={j} H={h} T={t} max_backfill={mb}"
                    f"{' with failures' if fails else ''}", args, dict(kw, t_bins=t), s))
    return out


def check_place(torch, np, ops, cases) -> tuple[float, dict]:
    """des_place on the card against its plain version on CPU copies of
    the same operands, at ``place_cases``: ``job_start`` and ``job_host``
    equal (``torch.equal``), and the attempts; twice each on the card for
    bitwise-equal results.  Returns the largest absolute difference (0)
    and each case's attempts."""
    attempts = {}
    for label, args, kw, unique in cases:
        got = ops.des_place(*args, **kw)
        again = ops.des_place(*args, **kw)
        torch.cuda.synchronize()
        cpu = {k: v[:unique].cpu() if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        want = ops.des_place(*(a[:unique].cpu() for a in args), **cpu)
        lanes = torch.arange(args[0].shape[0]) % unique
        for name, g, a, wv in zip(("job_start", "job_host", "attempts"), got, again, want):
            if not torch.equal(g.cpu(), wv[lanes]):
                fail(f"des_place {label} {name}: card and plain version differ in "
                     f"{int((g.cpu() != wv[lanes]).sum())} entries")
            if not torch.equal(g, a):
                fail(f"des_place {label} {name}: two runs differ")
        attempts[label] = got[2].tolist()
        log(f"des_place {label}: job_start, job_host and attempts equal to the plain "
            f"version (torch.equal), bitwise repeatable; attempts a lane "
            f"{min(attempts[label])}-{max(attempts[label])}")
    return 0.0, attempts


def readout_agrees(torch, got, want, precision) -> tuple[float, str | None]:
    """``(max |err| of the f32 leaves, the first leaf beyond its bar or
    None)``: rtol 1e-5 atol 1e-6, bf16 tflops/efficiency within one bf16
    ulp of the plain version."""
    worst = 0.0
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        bf16_leaf = precision == "bf16" and k in ("tflops", "efficiency")
        tol = 2.0 ** -8 * w.abs() if bf16_leaf else 1e-5 * w.abs() + 1e-6
        err = (g - w).abs()
        if g.shape != w.shape or bool((err > tol).any()) or not bool(torch.isfinite(g).all()):
            return float(err.max()), k
        if not bf16_leaf:
            worst = max(worst, float(err.max()))
    return worst, None


def check_readout(torch, np, ops, ref, dev) -> float:
    """des_readout against its plain version at ``readout_cases``, 4 power
    models x 2 precisions, twice each for bitwise-equal results.  Returns
    the largest absolute error of an f32 leaf."""
    worst = 0.0
    for label, u, kw in readout_cases(torch, np, dev):
        for model in ("opendc", "linear", "sqrt", "cubic"):
            for precision in ("f32", "bf16"):
                got = ops.des_readout(u, model=model, precision=precision, **kw)
                again = ops.des_readout(u, model=model, precision=precision, **kw)
                torch.cuda.synchronize()
                pu, operands = ops.pack_readout(u, model=model, precision=precision, **kw)
                want = ref.des_readout_ref(pu, **operands)
                if u.dim() == 2:
                    want = {k: v[0] for k, v in want.items()}
                err, bad = readout_agrees(torch, got, want, precision)
                if bad:
                    fail(f"des_readout {label} {model}/{precision} {bad}: max |err| {err}")
                if not all(torch.equal(got[k].view(torch.int32), again[k].view(torch.int32))
                           for k in got):
                    fail(f"des_readout {label} {model}/{precision}: two runs differ bitwise")
                worst = max(worst, err)
        log(f"des_readout {label}: 4 models x 2 precisions x 9 leaves within rtol "
            "1e-5 atol 1e-6 (bf16 perf leaves within one bf16 ulp), every axis on, "
            "bitwise repeatable")
    return worst


T_START = time.time()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler traces of E2 and the LM prefills")
    args = ap.parse_args()
    import torch

    # PyTorch's default, stated because the plain versions and the
    # card-vs-CPU checks need float32 matmuls in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail(f"the port's package is missing under {SRC}")
    sys.path.insert(0, str(SRC))

    import numpy as np

    from repro_torch.core import CalibrationSpec, OrchestratorConfig
    from repro_torch.core.calibrate import candidate_grid
    from repro_torch.core.power import PowerParams
    from repro_torch.kernels import _build, calib_mape, des_readout, ops, ref
    from repro_torch.kernels._launch import warp_split
    from repro_torch.traces.schema import DatacenterConfig
    from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like

    dev = torch.device("cuda")
    details: dict = {}
    phase_s: dict = {}
    since = [T_START]

    def phase_done(name: str) -> None:
        """Record the seconds since the last phase ended under ``name``."""
        now = time.time()
        phase_s[name] = now - since[0]
        since[0] = now

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
    # phase 17 (d)'s dry-run traces on the host's CPU from here on, beside
    # the card's phases
    dryrun = dryrun_start()
    phase_done("1-2 card and build")

    # 3) each kernel against its plain version on the card
    errs = {"calib_mape_grid": check_calib(torch, np, ops, ref, dev),
            "des_readout": check_readout(torch, np, ops, ref, dev)}
    errs["flash_attention"] = check_flash(torch, np, ops, ref, dev)
    errs["power_sim"] = check_power_sim(torch, np, ops, dev)
    errs["ssd_chunk"] = check_ssd(torch, np, ops, ref, dev)
    cases = place_cases(torch, np, dev)
    errs["des_place"], details["place_attempts"] = check_place(torch, np, ops, cases)
    phase_done("3 kernel checks")

    # 4) the main path: E2 at full size, kernels counted
    dc = DatacenterConfig()
    t_bins = int(E2_DAYS * BINS_PER_DAY)
    w = make_surf22_like(SurfTraceSpec(days=E2_DAYS, seed=E2_SEED), dc, device=dev)
    log(f"E2 workload: {w.num_jobs} jobs, {dc.num_hosts} hosts x "
        f"{dc.cores_per_host} cores, {t_bins} bins")
    joint_cfg = OrchestratorConfig(
        calibration=CalibrationSpec(mode="joint", refine_iters=1))
    runs, orchs = {}, {}
    ops.reset_launches()
    t_main = time.time()
    for name, cal, cfg in (("uncalibrated", False, None),
                           ("calibrated", True, None),
                           ("joint", True, joint_cfg)):
        t0 = time.time()
        res, orchs[name] = e2_run(w, dc, t_bins, calibrate=cal, cfg=cfg,
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
    for k in E2_KERNELS:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    if launches["des_readout"] != len(runs) * (t_bins // 36):
        fail(f"E2: {launches['des_readout']} des_readout launches, expected one a window")
    # two horizons a run: the twin's own DES and the DES behind the
    # ground-truth telemetry (TraceGroundTruth)
    if launches["des_place"] != 2 * len(runs):
        fail(f"E2: {launches['des_place']} des_place launches, expected one a horizon, "
             "two a run")
    if not runs["calibrated"].overall_mape < runs["uncalibrated"].overall_mape:
        fail("E2: calibration did not lower the MAPE")
    details["window_transfers"] = window_transfers(torch, w, dc, t_bins)
    phase_done("4 E2 on the card")

    # 5) the calibrated run again on the CPU: the schedule its windows were
    # predicted from and its parameter stream equal the card run's own
    t0 = time.time()
    cpu, cpu_orch = e2_run(w.to("cpu"), dc, t_bins, calibrate=True, cfg=None,
                           device="cpu")
    gpu, gpu_orch = runs["calibrated"], orchs["calibrated"]
    sim_cpu, sim_gpu = cpu_orch._ensure_sim(), gpu_orch._ensure_sim()
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
    phase_done("5 E2 on the CPU")

    # 6) the fleet power map on the card run's own horizon, counted
    launches.update(power_sim_path(torch, ops, sim_gpu.u_th, gpu.records[-1].params, dc))
    phase_done("6 power_sim path")

    # 7) the what-if path: evaluate_whatif on the calibrated twin, then the
    # fused run_scenarios at C and D, each call's launches counted from 0
    shard_refs: dict = {}        # unsharded results phase 15 holds its shards against
    details["whatif"] = whatif_phase(torch, np, ops, w, dc, t_bins, gpu_orch, cpu_orch,
                                     profile=args.profile, keep=shard_refs)
    for v in details["whatif"].values():
        for k in ("des_place", "des_readout"):
            launches[k] += v["launches"][k]
    phase_done("7 what-if")

    # 8) the LM serving paths at full size, each prefill counted
    for arch, per_call in LM_PATHS.items():
        run = details[f"lm_prefill {arch}"] = lm_prefill(torch, ops, arch, per_call)
        for k in per_call:
            launches[k] += run["launches"][k]
        details[f"lm_serve {arch}"] = lm_serve(torch, ops, arch)
    phase_done("8 LM serving paths")

    # 9) the LMs on the card against the LMs on the CPU, f32
    for arch in CARD_VS_CPU:
        details[f"lm_card_vs_cpu {arch}"] = lm_card_vs_cpu(torch, np, arch)
    phase_done("9 LM card vs CPU")

    # 11) the optimizer and stage 3 on the card (run before the kernel
    # timings, so that its launches count in the kernels line)
    details["search"] = search_phase(torch, np, ops, w, dc, t_bins, gpu_orch, gpu)
    for k, n in details["search"]["launches"].items():
        launches[k] += n
    phase_done("11 search and stage 3")

    # 12) the streaming twin service (paper stage 1) on the card, before the
    # kernel timings so that its launches count in the kernels line
    details["serve"] = serve_phase(torch, np, ops, w, dc, t_bins, gpu, keep=shard_refs)
    for k, n in details["serve"]["launches"].items():
        launches[k] += n
    phase_done("12 serving")

    # 13) training on the card (before the kernel timings, so that its
    # launches count in the kernels line)
    details["train"] = train_phase(torch, np, ops, ref, card)
    for k, n in details["train"]["launches"].items():
        launches[k] += n
    phase_done("13 training")

    # 14) the LM families (MoE, MLA, enc-dec, M-RoPE VLM, StableLM, Command
    # R+ cut in depth) at full width, before the kernel timings so that
    # their launches count in the kernels line
    details["families"] = family_phase(torch, np, ops)
    for k, n in details["families"]["launches"].items():
        launches[k] += n
    phase_done("14 LM families")

    # 15) lane sharding over the card mesh (every card, or cuda:0 four
    # times), before the kernel timings so that its launches count
    details["shard"] = shard_phase(torch, np, ops, w, dc, t_bins, gpu_orch, shard_refs)
    shard_refs.clear()
    for k, n in details["shard"]["launches"].items():
        launches[k] += n
    phase_done("15 lane sharding")

    # 16) training the LM families (MoE, MLA, StableLM, Command R+, VLM,
    # enc-dec), before the kernel timings so that its launches count
    details["family_train"] = family_train_phase(torch, np, ops, ref, card)
    for k, n in details["family_train"]["launches"].items():
        launches[k] += n
    phase_done("16 LM family training")

    # 17) the meta passes: expert parallelism, a prefill through it, the
    # meta count against card steps and the dry-run's CLI (before the
    # kernel timings, so that their launches count)
    details["meta"] = meta_phase(torch, ops, dryrun)
    for k, n in details["meta"]["launches"].items():
        launches[k] += n
    phase_done("17 meta passes")

    # 18) the five user-facing examples on the card and on the CPU (before
    # the kernel timings, so that their launches count)
    details["examples"] = examples_phase(torch, ops, card)
    for k, n in details["examples"]["launches"].items():
        launches[k] += n
    phase_done("18 examples")

    # 19) the DES roofline on the card, its counts against the CPU's (before
    # the kernel timings, so that its launches count)
    details["des_roofline"] = des_roofline_phase(torch, ops)
    for k, n in details["des_roofline"]["launches"].items():
        launches[k] += n
    phase_done("19 DES roofline")

    # 20) the reduced configs at the serving launcher's defaults, the padded
    # flash pairs among them, and the reduced MLA configs card vs CPU (before
    # the kernel timings, so that their launches count)
    details["reduced"] = reduced_phase(torch, np, ops)
    for k, n in details["reduced"]["launches"].items():
        launches[k] += n
    phase_done("20 reduced configs")

    # 10) kernel times at the main paths' shapes (device time, queue kept full)
    timer = DeviceTimer(torch)
    kernels, shapes = [], {}
    calib_lib = _build.load("calib_mape")
    readout_lib = _build.load("des_readout")
    stream = torch.cuda.current_stream().cuda_stream

    def timed(kernel, plain, plain_reps=20, **extra):
        k, p = timer.device_ms(kernel), timer.device_ms(plain, reps=plain_reps)
        return dict(ms=k["ms"], plain_ms=p["ms"], kernel_rounds=k,
                    plain_rounds=p, **extra)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_per_s = SFU_PER_CLOCK_PER_SM * sms * sm_max_clock_hz()

    def calib_case(u, real, pi, pm, r):
        b, t, h = u.shape
        c = r.shape[-1]
        group = calib_mape.candidate_group(b, r)
        tile = calib_mape.bin_tile(group, t, h, c)
        partial = torch.empty((b, -(-t // tile), c), device=dev)
        out = torch.empty((b, c), device=dev)

        def kernel():
            if calib_lib.calib_mape_grid_launch(
                    u.data_ptr(), real.data_ptr(), pi.data_ptr(), pm.data_ptr(),
                    r.data_ptr(), partial.data_ptr(), out.data_ptr(), b, t, h, c,
                    tile, group, stream) != 0:
                fail("calib_mape_grid: the timed launch returned a CUDA error")

        # one logf per (b, t, h), one expf per (b, t, h, distinct r of the
        # row's candidates)
        n_r = sum(int(torch.unique(row.view(torch.int32)).numel())
                  for row in r.reshape(-1, c))
        n_sfu = t * h * (b + group * n_r)
        # the plain version loops over candidate rows, one row's kernels
        # after another: two calls a round fill the stream's launch queue
        return timed(
            kernel, lambda: ref.calib_mape_grid_ref(u, real, pi, pm, r),
            plain_reps=2 if r.dim() == 2 else 20,
            wrapper_wall_ms=timer.wall_ms(lambda: ops.calib_mape_grid(u, real, pi, pm, r)),
            bin_tile=tile, group=group, distinct_r=n_r, sfu_ops=n_sfu,
            bytes=4 * (b * t * h + b * t + 3 * r.numel() + b * c),
            ops=2 * group * t * h * n_r + 8 * b * t * c + 4 * b * t * h)

    field = sim_gpu.u_th          # the calibrated card run's own [2016, 277] field

    def readout_inputs(s, t, h):
        """``(u, operands)`` of a ``READOUT_TIMED`` shape: one lane as the E2
        path calls the kernel, or per-lane operands on ``field``."""
        if s == 1:
            call = dict(p_idle=70.0, p_max=350.0, r=2.0, peak_tflops=dc.peak_tflops)
            return torch.rand((t, h), device=dev), call
        bins = (torch.arange(t, device=dev)[None, :]
                + 36 * torch.arange(s, device=dev)[:, None]) % field.shape[0]
        u = field[bins][:, :, torch.arange(h, device=dev) % field.shape[1]].contiguous()
        hosts = [64 + 24 * i for i in range(s)] if (s, t, h) == (16, 576, 424) else None
        return u, lanes_case(torch, np, u, seed=s + t + h, hosts=hosts)

    def readout_timed(s, t, h):
        u, kw = readout_inputs(s, t, h)
        pu, operands = ops.pack_readout(u, **kw)
        entry = readout_lib.des_readout_launch

        def kernel():
            return des_readout.launch(entry, pu, operands)

        def plain():
            return ref.des_readout_ref(pu, **operands)

        got = dict(zip(ref.READOUT_FIELDS, kernel().unbind(0)))
        err, bad = readout_agrees(torch, got, plain(), "f32")
        if bad:
            fail(f"des_readout S={s} T={t} H={h} timed case {bad}: max |err| {err}")
        out = timed(kernel, plain,
                    wrapper_wall_ms=timer.wall_ms(lambda: ops.des_readout(u, **kw)),
                    split=warp_split(s, t, h), max_abs_err=err,
                    bytes=readout_bytes(torch, pu, operands),
                    ops=14 * s * t * h + 30 * s * t, sfu_ops=2 * s * t * h)
        return out

    # E2 calibration: 4 windows x 36 bins of 277 hosts
    main = calib_case(*calib_inputs(torch, np, 1, 144, 277, 64, 1, dev))
    main_shapes = [main]
    kernels.append(dict(
        name="calib_mape_grid", route="cuda",
        source="src/repro_torch/kernels/csrc/calib_mape.cu",
        replaces="src/repro/kernels/calib_mape.py:79",
        launches=launches["calib_mape_grid"],
        max_abs_err=errs["calib_mape_grid"], ms=main["ms"],
        plain_ms=main["plain_ms"], **bound(main["bytes"], main["ops"],
                                           n_sfu=main["sfu_ops"], sfu_per_s=sfu_per_s),
        library_ms=None))
    shapes["calib B=1 T=144 H=277 C=64 (E2 r_only)"] = main
    u, real = calib_inputs(torch, np, 1, 144, 277, 1, 1, dev)[:2]
    grid = candidate_grid(CalibrationSpec(mode="joint"), PowerParams(), device=dev)
    shapes["calib B=1 T=144 H=277 C=9216 joint grid, 64 distinct r (E2 joint)"] = calib_case(
        u, real, grid.p_idle, grid.p_max, grid.r)
    shapes["calib B=1 T=144 H=277 C=9216 all r distinct"] = calib_case(
        *calib_inputs(torch, np, 1, 144, 277, 9216, 1, dev))
    shapes["calib B=277 T=144 H=1 C=64 (per-host refit)"] = calib_case(
        *calib_inputs(torch, np, 277, 144, 1, 64, 1, dev))
    fleet_case = next(iter(calib_lane_cases(torch, np, dev).values()))
    shapes["calib B=64 T=144 H=277 C=64 per-lane rows (the fleet's window)"] = calib_case(
        *fleet_case)
    floor = timer.device_ms(lambda: torch.cuda._sleep(0))
    details["launch_floor"] = floor
    log(f"launch floor (an empty kernel, torch.cuda._sleep(0)): {floor['ms'] * 1e3:.3f} us "
        f"(rounds {floor['min_ms'] * 1e3:.3f}-{floor['max_ms'] * 1e3:.3f})")
    readout_shapes = {label: readout_timed(*shape) for label, shape in READOUT_TIMED.items()}
    main = readout_shapes["A: E2 window"]
    main_shapes.append(main)
    kernels.append(dict(
        name="des_readout", route="cuda",
        source="src/repro_torch/kernels/csrc/des_readout.cu",
        replaces="src/repro/kernels/des_readout.py:202",
        launches=launches["des_readout"],
        max_abs_err=errs["des_readout"], ms=main["ms"],
        plain_ms=main["plain_ms"],
        **bound(main["bytes"], main["ops"], n_sfu=main["sfu_ops"], sfu_per_s=sfu_per_s),
        library_ms=None))
    for label, (s_, t_, h_) in READOUT_TIMED.items():
        shapes[f"readout {label} (S={s_} T={t_} H={h_})"] = readout_shapes[label]

    main = time_power_sim(torch, timer, ops, ref, _build, dev, 2016, 277)
    main_shapes.append(main)
    kernels.append(dict(
        name="power_sim", route="cuda",
        source="src/repro_torch/kernels/csrc/power_sim.cu",
        replaces="src/repro/kernels/power_sim.py:42",
        launches=launches["power_sim"],
        max_abs_err=errs["power_sim"], ms=main["ms"],
        plain_ms=main["plain_ms"],
        **bound(main["bytes"], main["ops"], n_sfu=main["sfu_ops"], sfu_per_s=sfu_per_s),
        library_ms=None))
    shapes["power_sim T=2016 H=277 (E2 horizon)"] = main
    # the same per-element logf/expf as readout D, without host rows or
    # float64 sums: what the readout's own per-host work costs beyond it
    shapes["power_sim T=129024 H=277 (readout D's elements)"] = time_power_sim(
        torch, timer, ops, ref, _build, dev, 64 * 2016, 277)
    main = time_flash(torch, timer, ref, _build, dev, *PREFILL_FLASH)
    main_shapes.append(main)
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:95",
        launches=launches["flash_attention"],
        max_abs_err=errs["flash_attention"], ms=main["ms"],
        plain_ms=main["plain_ms"],
        **bound(main["bytes"], main["ops"], PEAK_BF16_TC_FLOPS),
        library_ms=main["library_ms"]))
    shapes["flash B=4 Hq=15 Hkv=5 S=2048 D=64 bf16 causal (SmolLM prefill)"] = main
    details["flash_op_overhead"] = op_overhead(torch, timer, ops, dev)
    shapes["flash B=4 Hq=32 Hkv=32 S=2048 D=64 bf16 causal (Zamba2 prefill)"] = time_flash(
        torch, timer, ref, _build, dev, *PREFILL_FLASH_ZAMBA2)
    shapes["flash B=4 Hq=40 Hkv=40 S=2048 D=96 Dv=64 bf16 causal (MiniCPM3 prefill)"] = \
        time_flash(torch, timer, ref, _build, dev, *PREFILL_FLASH_MINICPM3)
    shapes["flash B=4 Hq=16 Hkv=16 S=2048 D=192 Dv=128 bf16 causal (DeepSeek-V2-Lite "
           "prefill)"] = time_flash(torch, timer, ref, _build, dev, *PREFILL_FLASH_DEEPSEEK)
    # a padded pair: MiniCPM3-4B at --reduce 2 (QK 48 / V 32 on the (64, 64)
    # instantiation), and the same shape at the exact (64, 64)
    shapes["flash B=4 Hq=20 Hkv=20 S=2048 D=48 Dv=32 bf16 causal (MiniCPM3-4B x2 "
           "prefill, padded to 64/64)"] = time_flash(torch, timer, ref, _build, dev,
                                                     *PREFILL_FLASH_MINICPM3_X2)
    shapes["flash B=4 Hq=20 Hkv=20 S=2048 D=64 Dv=64 bf16 causal (that shape at the "
           "exact 64/64)"] = time_flash(torch, timer, ref, _build, dev,
                                        *PREFILL_FLASH_MINICPM3_X2[:5], 64, 64)
    for tag, shape in PREFILL_FLASH_PADDED.items():
        shapes["flash B={} Hq={} Hkv={} S={} D={} Dv={} bf16 causal ({} prefill, "
               "padded)".format(*shape[:4], *shape[5:], tag)] = time_flash(
                   torch, timer, ref, _build, dev, *shape)
    details["flash_rows"] = {str(shape): flash_rows_check(torch, np, timer, ops, ref, dev, *shape)
                             for shape in FLASH_ROWS_SHAPES}
    main = time_ssd(torch, timer, ref, _build, dev, *SSD_MAMBA2)
    main_shapes.append(main)
    kernels.append(dict(
        name="ssd_chunk", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_chunk.cu",
        replaces="src/repro/kernels/ssd_chunk.py:65",
        launches=launches["ssd_chunk"],
        max_abs_err=errs["ssd_chunk"], ms=main["ms"],
        plain_ms=main["plain_ms"],
        **bound(main["bytes"], main["ops"], PEAK_3XTF32_FLOPS),
        library_ms=None))
    shapes["ssd BC=64 Q=128 H=32 P=64 G=1 N=128 (Mamba2-370M prefill)"] = main
    shapes["ssd BC=64 Q=128 H=64 P=64 G=1 N=64 (Zamba2-1.2B prefill)"] = time_ssd(
        torch, timer, ref, _build, dev, *SSD_ZAMBA2)
    details["place_times"] = place = time_place(torch, timer, ref, dev, cases)
    main = place["E2 week, the main path's lane (worst fit)"]
    kernels.append(dict(
        name="des_place", route="cuda",
        source="src/repro_torch/kernels/csrc/des_place.cu",
        replaces="src/repro/core/desim.py:308",
        launches=launches["des_place"],
        max_abs_err=errs["des_place"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None))
    for v in shapes.values():
        work = (v["bytes"], v["ops"], v.get("peak_ops", PEAK_F32_FLOPS),
                v.get("sfu_ops", 0), sfu_per_s)
        v.update(bound(*work), bound_terms_ms=bound_terms(*work))
    for row, v in zip(kernels, main_shapes):
        k, p = v["kernel_rounds"], v["plain_rounds"]
        log(f"{row['name']}: {row['ms'] * 1e3:.2f} us (rounds {k['min_ms'] * 1e3:.2f}-"
            f"{k['max_ms'] * 1e3:.2f}; bound {row['bound_ms'] * 1e3:.3f} us, by "
            f"{row['bound_by']}), plain {row['plain_ms'] * 1e3:.2f} us (rounds "
            f"{p['min_ms'] * 1e3:.2f}-{p['max_ms'] * 1e3:.2f}, {p['reps']} calls "
            f"per round, {p['retries']} retries), "
            + (f"library {row['library_ms'] * 1e3:.2f} us, "
               if row["library_ms"] is not None else "")
            + f"{row['launches']} launches on the main path")
    for k, v in shapes.items():
        if k.startswith(("readout", "power_sim")):
            log(f"{k}: {v['ms'] * 1e3:.3f} us, {v['ms'] / v['bound_ms']:.2f}x its bound "
                f"{v['bound_ms'] * 1e3:.3f} us (by {v['bound_by']}), "
                f"{v['ms'] / floor['ms']:.2f}x the launch floor")
        log(f"extra shape {k}: {json.dumps(v)}")
    details["kernels"] = kernels
    details["shapes"] = shapes
    phase_done("10 kernel timings")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if args.profile:
        details["profile"] = profile_e2(torch, w, dc, t_bins)
        details["profile_lm"] = profile_lm(torch)
        details["profile_ssm"] = profile_ssm(torch)
        phase_done("--profile traces")
    details["phase_seconds"] = phase_s
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    details["script_seconds"] = time.time() - T_START
    log(f"chip_smoke: {details['script_seconds']:.1f} s in all")
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
    were predicted from) and its calibrated state can be read: returns the
    result and the twin's orchestrator."""
    from repro_torch.core import DigitalTwin, OrchestratorConfig, TraceGroundTruth

    cfg = dataclasses.replace(cfg or OrchestratorConfig(), calibrate=calibrate,
                              device=device)
    twin = DigitalTwin(w, dc, t_bins, cfg)
    truth = TraceGroundTruth(twin.orchestrator.workload, dc, t_bins)
    return twin.run(truth.window), twin.orchestrator


def profile_e2(torch, w, dc, t_bins) -> dict:
    """Device busy time of the E2 calibrated and joint runs (``--profile``
    only).

    ``torch.profiler`` traces the DES and each 56-window loop separately; the
    device's busy share is the summed device time of its kernels and copies
    over the host's wall time.  A trace of the DES that lost its
    ``des_place`` launch is taken again, up to ``MAX_TRACE_RETRIES``
    times, so that its idle share is the DES's own.
    """
    from repro_torch.core import (
        CalibrationSpec, DigitalTwin, OrchestratorConfig, TraceGroundTruth)
    from repro_torch.core.desim import simulate_utilization

    twin = DigitalTwin(w, dc, t_bins, OrchestratorConfig(device="cuda"))
    joint = DigitalTwin(w, dc, t_bins, OrchestratorConfig(
        device="cuda", calibration=CalibrationSpec(mode="joint", refine_iters=1)))
    truth = TraceGroundTruth(w, dc, t_bins)
    for t in (twin, joint):
        t.orchestrator._ensure_sim()      # the DES is traced on its own

    def des():
        return simulate_utilization(w, num_hosts=dc.num_hosts,
                                    cores_per_host=dc.cores_per_host, t_bins=t_bins)

    for retries in range(MAX_TRACE_RETRIES + 1):
        des_trace = traced(torch, des, match=("des_place_kernel",))
        if des_trace["shares"]["des_place_kernel"] > 0:
            break
    else:
        fail(f"profile: {MAX_TRACE_RETRIES + 1} traces of E2's DES lost its des_place launch")
    des_trace["retries"] = retries
    out = dict(
        des=des_trace,
        calibrated_windows=traced(torch, lambda: twin.run(truth.window)),
        joint_windows=traced(torch, lambda: joint.run(truth.window)))
    log_profile(out)
    return out


def window_transfers(torch, w, dc, t_bins) -> dict:
    """Host-to-device copies and device-to-host reads of the 56 calibrated
    E2 windows (the DES run before), counted in a ``torch.profiler``
    trace; fails if a count exceeds ``WINDOW_TRANSFERS``."""
    from repro_torch.core import DigitalTwin, OrchestratorConfig, TraceGroundTruth

    twin = DigitalTwin(w, dc, t_bins, OrchestratorConfig(device="cuda"))
    truth = TraceGroundTruth(w, dc, t_bins)
    twin.orchestrator._ensure_sim()
    out = traced(torch, lambda: twin.run(truth.window))
    counts = out["transfers"]
    if out["device_busy_s"] <= 0:
        fail("window transfers: the trace saw no device activity")
    for k, most in WINDOW_TRANSFERS.items():
        if counts[k] > most:
            fail(f"E2 windows: {counts[k]} {k} transfers, more than {most}")
    log(f"E2 calibrated windows: {counts['HtoD']} host-to-device copies, "
        f"{counts['DtoH']} device-to-host reads (at most {WINDOW_TRANSFERS}), "
        f"device idle share {out['device_idle_share']:.4f}")
    return out


def profile_lm(torch) -> dict:
    """Device busy time of one SmolLM-360M prefill call (``[4, 2048]``,
    bf16) and of 16 greedy serve steps at batch 4 (``--profile`` only)."""
    from repro_torch.launch.steps import (
        make_prefill_step, make_serve_step, param_specs_for, state_specs_for)
    from repro_torch.models.common import init_params

    cfg = lm_config("smollm-360m")
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_params(param_specs_for(cfg), gen, dtype, DEVICE)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
    state = init_params(state_specs_for(cfg, PREFILL_B, 32), None, dtype, DEVICE)
    tok = tokens[:, 0]

    def decode(first, n):
        nonlocal tok, state
        for i in range(first, first + n):
            cache_len = torch.full((PREFILL_B,), i, dtype=torch.int32, device=DEVICE)
            tok, state = serve(params, state, {"token": tok[:, None],
                                               "cache_len": cache_len})

    prefill(params, {"tokens": tokens})              # warm
    decode(0, 4)
    out = dict(prefill=traced(torch, lambda: prefill(params, {"tokens": tokens}),
                              match=("flash_bf16_kernel",)),
               decode_16_steps=traced(torch, lambda: decode(4, 16)))
    log_profile(out)
    return out


def profile_ssm(torch) -> dict:
    """Device busy time of one Mamba2-370M and one Zamba2-1.2B prefill call
    (``[4, 2048]``, bf16), with the shares of ``ssd_chunk`` and flash
    attention in it (``--profile`` only)."""
    from repro_torch.launch.steps import make_prefill_step, param_specs_for
    from repro_torch.models.common import init_params

    out = {}
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        cfg = lm_config(arch)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        params = init_params(param_specs_for(cfg), gen, getattr(torch, cfg.dtype),
                             DEVICE)
        tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                               device=DEVICE, dtype=torch.int32)
        prefill = make_prefill_step(cfg)
        prefill(params, {"tokens": tokens})              # warm
        out[f"{arch} prefill"] = traced(
            torch, lambda: prefill(params, {"tokens": tokens}),
            match=("ssd_chunk_kernel", "flash_bf16_kernel"))
        del params
        torch.cuda.empty_cache()
    log_profile(out)
    return out


def traced(torch, fn, match: tuple[str, ...] = ()) -> dict:
    """``torch.profiler`` over ``fn``: wall time, the summed device time of
    its kernels and copies, the device's idle share, the number of
    host-to-device and device-to-host copies, the top kernels, and for
    each name in ``match`` the share of device busy time in the kernels
    whose name holds it.

    Only device-side events count (kernels, copies, memsets): a host-side
    operator also carries its kernels' device time, and counting both
    would count that time twice.  ``runtime_copies`` counts the copies the
    host issued (CUDA runtime ``cudaMemcpy*`` calls); the trace is
    ``complete`` when it holds a device copy event for each of them (a
    trace can lose device events, and then its busy time is a lower bound).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, runtime_copies = [], 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
        elif ev.device_type == DeviceType.CPU and ev.key.startswith(("cudaMemcpy", "cuMemcpy")):
            runtime_copies += ev.count
    rows.sort(key=lambda x: -x[1])
    busy = sum(r[1] for r in rows) / 1e6
    device_copies = sum(n for k, _, n in rows if k.startswith("Memcpy "))
    out = dict(wall_s=wall, device_busy_s=busy,
               device_idle_share=1.0 - busy / wall if wall else None,
               runtime_copies=runtime_copies, device_copies=device_copies,
               complete=runtime_copies > 0 and device_copies == runtime_copies,
               transfers={d: sum(n for k, _, n in rows if k.startswith(f"Memcpy {d}"))
                          for d in ("HtoD", "DtoH")},
               top=[dict(name=k[:80], device_ms=v / 1e3, count=n)
                    for k, v, n in rows[:12]])
    if match:
        out["shares"] = {m: sum(v for k, v, _ in rows if m in k) / 1e6 / busy
                         for m in match}
    return out


def log_profile(out: dict) -> None:
    for name, v in out.items():
        log(f"profile {name}: wall {v['wall_s']:.3f} s, device busy "
            f"{v['device_busy_s']:.4f} s, idle share {v['device_idle_share']:.4f}"
            + "".join(f", {m} {x:.4f} of busy" for m, x in v.get("shares", {}).items()))
        for row in v["top"][:6]:
            log(f"    {row['device_ms']:.3f} ms x{row['count']}  {row['name']}")


def flash_inputs(torch, np, i, device) -> tuple:
    """q, k, v of ``FLASH_CASES[i]``: N(0, 1) drawn in f32 from seed
    ``100 + i``, cast to the case's dtype."""
    b, hq, hkv, sq, skv, d, dv, _, bf16 = FLASH_CASES[i][:9]
    rng = np.random.default_rng(100 + i)
    dt = torch.bfloat16 if bf16 else torch.float32
    return tuple(torch.as_tensor(rng.normal(0, 1, (b, h, s, w)).astype(np.float32),
                                 device=device).to(dt)
                 for h, s, w in ((hq, sq, d), (hkv, skv, d), (hkv, skv, dv)))


def softmax_row_norm(torch, q, k, causal: bool):
    """``||p||``, the L2 norm of each query row's softmax weights
    ``[B, Hq, Sq, 1]``, from the same scaled scores and causal rule as the
    plain version."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[2]
    kf = k.float().repeat_interleave(hq // k.shape[1], dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float() * d ** -0.5, kf)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        keys = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(rows < keys, float("-inf"))
    return torch.softmax(logits, dim=-1).norm(dim=-1, keepdim=True)


def flash_bar_use(torch, ref, got, q, k, v, causal: bool, rtol: float,
                  atol: float) -> tuple[float, float]:
    """``(max |err|, bar used)`` of flash attention's output ``got`` against
    the plain version in f32 on the same inputs; bar used is the largest
    ``|err| / bar`` (at most 1 to pass).  The bar is ``atol + rtol |want|``
    for f32 inputs and ``rtol |want| + atol ||p||`` for bf16 inputs
    (``FLASH_CASES``)."""
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    err = (got.float() - want).abs()
    if q.dtype == torch.float32:
        bar = atol + rtol * want.abs()
    else:
        bar = rtol * want.abs() + atol * softmax_row_norm(torch, q, k, causal)
    return float(err.max()), float((err / bar).max())


#: the bar of the lse output (``return_lse=True``) against the plain
#: version's, both routes: ``LSE_ATOL + LSE_RTOL |want|``.  Both take the
#: row max and sum in float32 from products that are exact in float32 for
#: bf16 inputs, so they differ only in the order of the sums and in the
#: bf16 route's log2-unit max times ln 2
LSE_RTOL, LSE_ATOL = 1e-5, 1e-4


def check_flash(torch, np, ops, ref, dev) -> float:
    """Flash attention against its plain version at ``FLASH_CASES``, twice
    each for bitwise-equal results, and once more with ``return_lse=True``:
    the same output bit for bit, the lse against the plain version's at
    ``LSE_RTOL``/``LSE_ATOL``.  Returns the largest absolute error of the
    outputs (the lse's is logged)."""
    worst = 0.0
    for i, (b, hq, hkv, sq, skv, d, dv, causal, _, rtol, atol) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(torch, np, i, dev)
        got = ops.flash_attention(q, k, v, causal=causal)
        again = ops.flash_attention(q, k, v, causal=causal)
        with_lse, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        case = f"{(b, hq, hkv, sq, skv, d, dv, causal)} {str(q.dtype)[6:]}"
        err, used = flash_bar_use(torch, ref, got, q, k, v, causal, rtol, atol)
        if got.dtype != q.dtype or got.shape != (b, hq, sq, dv) or not used <= 1.0:
            fail(f"flash_attention {case}: max |err| {err}, bar used {used} "
                 f"(rtol {rtol}, atol {atol})")
        if not torch.equal(got, again):
            fail(f"flash_attention {case}: two runs differ bitwise")
        if not torch.equal(got, with_lse):
            fail(f"flash_attention {case}: return_lse=True changed the output")
        _, want_lse = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                              causal=causal, return_lse=True)
        lse_err = float((lse - want_lse).abs().max())
        if (lse.dtype != torch.float32 or lse.shape != want_lse.shape
                or not torch.allclose(lse, want_lse, rtol=LSE_RTOL, atol=LSE_ATOL)):
            fail(f"flash_attention {case} lse: max |err| {lse_err} beyond rtol "
                 f"{LSE_RTOL} atol {LSE_ATOL}")
        worst = max(worst, err)
        log(f"flash_attention {case}: max |err| {err:.3g}, bar used {used:.3f} "
            f"(rtol {rtol}, atol {atol}), bitwise repeatable; lse max |err| "
            f"{lse_err:.3g} (rtol {LSE_RTOL}, atol {LSE_ATOL}), output unchanged")
    return worst


#: the fleet power parameters of the power_sim checks
POWER_KW = dict(p_idle=70.0, p_max=350.0, r=2.3, peak_tflops=120.0,
                dt_seconds=300.0)


def check_power_sim(torch, np, ops, dev) -> float:
    """power_sim against its plain version (rtol 1e-4 / atol 1e-2, the JAX
    sweep's bar), twice each for bitwise-equal results."""
    worst = 0.0
    for t, h in POWER_SIM_SHAPES:
        u = torch.as_tensor(np.random.default_rng(t + h).uniform(
            0.0, 1.1, (t, h)).astype(np.float32), device=dev)
        got = ops.power_sim(u, **POWER_KW)
        again = ops.power_sim(u, **POWER_KW)
        torch.cuda.synchronize()
        want = ops.power_sim(u.cpu(), **POWER_KW)      # the plain version, CPU
        for name, g, a, w in zip(("power", "energy", "tflops"), got, again, want):
            err = float((g.cpu() - w).abs().max())
            if not torch.allclose(g.cpu(), w, rtol=1e-4, atol=1e-2):
                fail(f"power_sim {(t, h)} {name}: max |err| {err} beyond rtol "
                     "1e-4 atol 1e-2")
            if not torch.equal(g, a):
                fail(f"power_sim {(t, h)} {name}: two runs differ bitwise")
            worst = max(worst, err)
        log(f"power_sim T={t} H={h}: power/energy/tflops within rtol 1e-4 "
            "atol 1e-2 of the plain version, bitwise repeatable")
    return worst


def lanes_des(psc, ss, t_bins):
    """The DES of a ScenarioSet's lanes alone, as ``run_scenarios`` runs it."""
    fail = (dict(fail_start=ss.fail_start, fail_end=ss.fail_end, fail_kill=ss.fail_kill)
            if ss.has_failures else {})
    from repro_torch.core.desim import simulate_utilization_masked

    return simulate_utilization_masked(
        ss.workload, ss.host_mask_s, ss.cores_per_host, max_hosts=ss.max_hosts,
        t_bins=t_bins, policy_id=ss.policy_id, backfill_depth=ss.backfill_depth,
        max_backfill=ss.max_backfill, **fail)


def call_and_des_seconds(torch, call, des, turns: int = 3) -> tuple[float, float]:
    """Median wall seconds, each up to a device synchronize, of ``call``
    and of ``des`` (its DES alone), timed in turns."""
    times = ([], [])
    for _ in range(turns):
        for fn, out in zip((call, des), times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
    return statistics.median(times[0]), statistics.median(times[1])


def same_sim(torch, a, b, label, lanes=None) -> None:
    """``a``'s schedule (its lanes ``lanes``, all by default) equals ``b``'s."""
    for k in ("job_start", "job_host", "queue_len", "running"):
        x = getattr(a, k) if lanes is None else getattr(a, k)[lanes]
        if not torch.equal(x.cpu(), getattr(b, k).cpu()):
            fail(f"what-if {label}: {k} differs")


def close_pred(torch, got, want, rtol, label, atol=0.0, lanes=None) -> float:
    """Largest relative difference of the prediction leaves (``got``'s lanes
    ``lanes``, all by default); fails beyond ``rtol`` (``atol`` where a leaf
    is near 0)."""
    worst = 0.0
    for k in ("power_w", "energy_kwh", "tflops", "utilization", "efficiency", "gco2",
              "power_demand_w", "pue", "energy_cost"):
        g, w = getattr(got, k), getattr(want, k)
        if (g is None) != (w is None):
            fail(f"what-if {label}: leaf {k} present on one side only")
        if g is None:
            continue
        if lanes is not None:
            g = g[lanes]
        g, w = g.cpu().double(), w.cpu().double()
        if not torch.allclose(g, w, rtol=rtol, atol=atol):
            fail(f"what-if {label}: {k} max rel diff "
                 f"{float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())} beyond rtol {rtol}")
        worst = max(worst, float(((g - w).abs() / w.abs().clamp(min=1e-30)).max()))
    return worst


def summary_ints(s) -> tuple:
    return tuple(v for v in s.__dict__.values() if isinstance(v, (int, str)))


def whatif_phase(torch, np, ops, w, dc, t_bins, card_orch, cpu_orch,
                 profile: bool = False, keep=None) -> dict:
    """The what-if path on the card: (a) ``Orchestrator.evaluate_whatif`` on
    the calibrated E2 twin with the example's 19 candidates, against the
    CPU rerun's calibrated twin; (b) ``run_scenarios(fused_readout=True)``
    at C and D, against the unfused readout on the card and a CPU rerun;
    (c) wall seconds a call and the DES's share of them (medians of three
    turns; the DES timed alone on the same lanes).  Launches are counted
    per call, from 0.  With ``profile``, a ``torch.profiler`` trace of one
    call at D (device busy time, idle share, top kernels)."""
    from repro_torch.core import Orchestrator, OrchestratorConfig
    from repro_torch.core import scenarios as psc
    from repro_torch.core.power import PowerParams
    from repro_torch.runtime import fault
    from repro_torch.traces.carbon import make_diurnal_carbon
    from repro_torch.traces.price import make_diurnal_price
    from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like

    out = {}
    ci = make_diurnal_carbon(t_bins)
    twins = {}
    for dev, src in (("cuda", card_orch), ("cpu", cpu_orch)):
        twins[dev] = Orchestrator(w.to(dev), dc, t_bins, OrchestratorConfig(device=dev),
                                  carbon_intensity=ci)
        twins[dev].state = src.state        # the calibrated twin
    cands = whatif_candidates(psc)
    ops.reset_launches()
    card = twins["cuda"].evaluate_whatif(cands)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches["des_place"] != 1:
        fail(f"what-if (a): {launches['des_place']} des_place launches, expected 1")
    t0 = time.perf_counter()
    cpu = twins["cpu"].evaluate_whatif(cands)
    cpu_s = time.perf_counter() - t0
    same_sim(torch, card.sim, cpu.sim, "(a) card vs CPU")
    rel = close_pred(torch, card.prediction, cpu.prediction, 1e-5, "(a) card vs CPU")
    if [summary_ints(s) for s in card.summaries] != [summary_ints(s) for s in cpu.summaries]:
        fail("what-if (a): summaries' integer fields differ between card and CPU")
    kinds = [p.kind.value for p in card.proposals]
    if kinds != [p.kind.value for p in cpu.proposals]:
        fail("what-if (a): proposal kinds differ between card and CPU")
    ss = psc.build_scenario_set(twins["cuda"].workload, dc,
                                [psc.Scenario(name="baseline")] + cands,
                                twins["cuda"].state.params)
    wall, des = call_and_des_seconds(torch, lambda: twins["cuda"].evaluate_whatif(cands),
                                     lambda: lanes_des(psc, ss, t_bins))
    out["a"] = dict(lanes=len(cands) + 1, launches=launches, wall_s=wall, des_s=des,
                    des_share=des / wall, cpu_rerun_s=cpu_s, max_rel_pred=rel,
                    proposals=kinds)
    log(f"what-if (a) evaluate_whatif, {len(cands) + 1} lanes on the calibrated E2 twin: "
        f"schedules equal to the CPU rerun's, prediction within rtol 1e-5 (max rel "
        f"{rel:.3g}), {len(kinds)} proposals {sorted(set(kinds))}; launches {launches}; "
        f"{wall:.4f} s a call, DES {des:.4f} s (share {des / wall:.3f}); CPU rerun "
        f"{cpu_s:.1f} s")

    w_c = make_surf22_like(SurfTraceSpec(days=WHATIF_C_DAYS), dc, device="cpu")
    t_c = int(WHATIF_C_DAYS * BINS_PER_DAY)
    for label, wl, scs, t, mh, cpu_lanes in (
            ("C", w_c, whatif_c(psc), t_c, WHATIF_C_HOSTS, None),
            ("D", w.to("cpu"), whatif_d(psc, fault), t_bins, None, WHATIF_D_CPU_LANES)):
        traces = dict(carbon_intensity=make_diurnal_carbon(t), price=make_diurnal_price(t))
        cpu_scs = scs if cpu_lanes is None else [scs[i] for i in cpu_lanes]
        sets = {dev: psc.build_scenario_set(wl.to(dev), dc, lanes, PowerParams(), max_hosts=mh)
                for dev, lanes in (("cuda", scs), ("cpu", cpu_scs))}

        def run(dev, fused):
            s_ = sets[dev]
            return psc.run_scenarios(s_, max_hosts=s_.max_hosts, t_bins=t,
                                     fused_readout=fused, **traces)

        ops.reset_launches()
        sim, pred = run("cuda", True)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        if launches["des_place"] != 1 or launches["des_readout"] != 1:
            fail(f"what-if {label}: launches {launches}, expected one des_place and "
                 "one des_readout")
        if keep is not None:
            keep[f"whatif_{label}"] = dict(ss=sets["cuda"], t_bins=t, traces=traces,
                                          out=(sim, pred))
        sim_u, pred_u = run("cuda", False)
        same_sim(torch, sim, sim_u, f"{label} fused vs unfused")
        oracle = close_pred(torch, pred, pred_u, 2e-4, f"{label} fused vs unfused", atol=1e-6)
        t0 = time.perf_counter()
        sim_c, pred_c = run("cpu", True)
        cpu_s = time.perf_counter() - t0
        same_sim(torch, sim, sim_c, f"{label} card vs CPU", lanes=cpu_lanes)
        rel = close_pred(torch, pred, pred_c, 1e-5, f"{label} card vs CPU", lanes=cpu_lanes)
        wall, des = call_and_des_seconds(torch, lambda: run("cuda", True),
                                         lambda: lanes_des(psc, sets["cuda"], t))
        s_, j_ = sets["cuda"].workload.submit_bin.shape
        out[label] = dict(lanes=s_, jobs=j_, hosts=sets["cuda"].max_hosts, bins=t,
                          launches=launches, wall_s=wall, des_s=des, des_share=des / wall,
                          cpu_rerun_s=cpu_s, cpu_rerun_lanes=len(cpu_scs),
                          max_rel_vs_unfused=oracle,
                          max_rel_vs_cpu=rel)
        if profile and label == "D":
            out[label]["profile"] = traced(torch, lambda: run("cuda", True),
                                           match=("des_place_kernel", "des_readout_kernel"))
            log_profile({"what-if D call": out[label]["profile"]})
        log(f"what-if {label}: run_scenarios(fused_readout=True), {s_} lanes x {j_} jobs x "
            f"{sets['cuda'].max_hosts} hosts x {t} bins: launches {launches}; fused vs "
            f"unfused max rel {oracle:.3g} (rtol 2e-4), card vs CPU ({len(cpu_scs)} lanes) "
            f"schedules equal and max rel {rel:.3g} (rtol 1e-5); {wall:.4f} s a call, DES {des:.4f} s "
            f"(share {des / wall:.3f}); CPU rerun {cpu_s:.1f} s")
    return out


# -- phase 11: the optimizer and stage 3 --------------------------------------

def search_space(psc, opt):
    """examples/whatif_scaling.py:120-133's space: the 4 policies (backfill
    0 for worst fit, 8 for the others) under a carbon-aware cap and shifts."""
    from repro_torch.core.desim import PLACEMENT_POLICIES

    return opt.SearchSpace(
        structures=tuple(psc.Scenario(name=p, policy=p,
                                      backfill_depth=0 if p == "worst_fit" else 8)
                         for p in sorted(PLACEMENT_POLICIES)),
        **SEARCH_RANGES)


def knobs(sc):
    """A scenario's knobs: the scenario without its name."""
    return dataclasses.replace(sc, name="")


def history_rows(res) -> list:
    """Every evaluation of a search as comparable values (knobs, name,
    objective, feasibility, breakdown, generation, lane)."""
    return [(c.scenario, c.objective, c.feasible, tuple(c.breakdown.items()),
             c.generation, c.lane) for c in res.history]


class BatchProbe:
    """Wraps the optimizer's ``build_scenario_set`` and ``run_scenarios``
    while a search runs: each batch's peak ``torch.cuda.max_memory_allocated``
    (reset as the batch's set is built), the evaluator's wall seconds up to a
    device synchronize, and the batch's ScenarioSet (for its DES alone,
    timed afterwards)."""

    def __init__(self, torch, opt):
        self.torch, self.opt, self.batches = torch, opt, []

    def __enter__(self):
        torch, opt = self.torch, self.opt
        build, run = opt.build_scenario_set, opt.run_scenarios
        self._saved = build, run

        def probed_build(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.batches.append(dict(t0=time.perf_counter(),
                                     allocated_mb=torch.cuda.memory_allocated() / 2**20))
            ss = build(*a, **kw)
            self.batches[-1]["ss"] = ss
            return ss

        def probed_run(*a, **kw):
            t0 = time.perf_counter()
            out = run(*a, **kw)
            torch.cuda.synchronize()
            b = self.batches[-1]
            b["run_s"] = time.perf_counter() - t0
            b["peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
            return out

        opt.build_scenario_set, opt.run_scenarios = probed_build, probed_run
        return self

    def __exit__(self, *exc):
        self.opt.build_scenario_set, self.opt.run_scenarios = self._saved


def search_ties(a, b, rtol) -> str | None:
    """Where two searches' histories first part, whether a near-tie explains
    it: the incumbents up to that batch agree within ``rtol`` and two
    distinct feasible knob points already evaluated lie within ``rtol`` of
    each other at the incumbent's objective.  Returns a description of the
    tie, or ``None`` when the histories do not part."""
    for i, (x, y) in enumerate(zip(a.history, b.history)):
        if x.scenario == y.scenario:
            continue
        seen = [c for c in b.history[:i] if c.feasible]
        best = min(c.objective for c in seen)
        near = {knobs(c.scenario) for c in seen
                if abs(c.objective - best) <= rtol * abs(best)}
        if len(near) < 2:
            fail(f"search (c): evaluation {i} differs ({x.scenario.name} on the card, "
                 f"{y.scenario.name} on the CPU) with no near-tie behind it")
        return (f"histories part at evaluation {i}: {len(near)} knob points within "
                f"rtol {rtol} of the incumbent's objective {best!r}")
    return None


def search_phase(torch, np, ops, w, dc, t_bins, card_orch, card_run) -> dict:
    """Phase 11, the optimizer and stage 3 on the card.

    (a) ``Orchestrator.optimize_whatif`` on the calibrated E2 twin with
    examples/whatif_scaling.py's search, twice (histories equal bit for bit;
    the second run under ``torch.profiler`` for the device-to-host copies),
    with each batch's wall seconds, peak memory and DES alone; (b)
    ``optimize(fused_readout=True, generations=0)``: one ``des_readout`` and
    one ``des_place`` launch a batch, objectives within rtol 2e-4 of (a)'s
    at the same knobs; (c) the search at E2's width over 2 days on the card
    and on the CPU; (d) E2 calibrated with the resident DES equal to the
    external cache, then an approved scheduler change applied mid-run, on
    the card and on the CPU.  Returns the details and the launches counted
    on the path."""
    import importlib

    from repro_torch.core import DigitalTwin, Orchestrator, OrchestratorConfig, TraceGroundTruth
    from repro_torch.core import feedback as fb
    from repro_torch.core import scenarios as psc
    from repro_torch.core.power import PowerParams
    from repro_torch.traces.carbon import make_diurnal_carbon
    from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like

    opt = importlib.import_module("repro_torch.core.optimize")
    out, path_launches = {}, {k: 0 for k in ("des_place", "des_readout", "calib_mape_grid")}
    ci = make_diurnal_carbon(t_bins)
    space = search_space(psc, opt)
    objective = opt.ObjectiveSpec(**SEARCH_OBJECTIVE)
    config = opt.OptimizerConfig(**SEARCH_CONFIG)

    def twin():
        orch = Orchestrator(w, dc, t_bins, OrchestratorConfig(device="cuda"),
                            carbon_intensity=ci)
        orch.state = card_orch.state          # the calibrated E2 twin
        return orch

    # (a) the operator's search, at full size, twice
    orch = twin()
    ops.reset_launches()
    torch.cuda.synchronize()
    with BatchProbe(torch, opt) as probe:
        t0 = time.perf_counter()
        first = orch.optimize_whatif(space, objective, key=0, config=config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    res = first.result
    if launches["des_place"] != res.batches or launches["des_readout"] != 0:
        fail(f"search (a): launches {launches}, expected one des_place a batch "
             f"({res.batches}) and no des_readout (unfused)")
    for k in path_launches:
        path_launches[k] += launches[k]
    des = []                        # each batch's DES alone, synchronized
    for b in probe.batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lanes_des(psc, b["ss"], t_bins)
        torch.cuda.synchronize()
        des.append(time.perf_counter() - t0)
    ends = [b["t0"] for b in probe.batches[1:]] + [probe.batches[0]["t0"] + wall]
    batch_s = [e - b["t0"] for b, e in zip(probe.batches, ends)]
    held = {}
    prof = traced(torch, lambda: held.setdefault(
        "res", twin().optimize_whatif(space, objective, key=0, config=config).result))
    if history_rows(held["res"]) != history_rows(res):
        fail("search (a): two runs of the same search on the card differ")
    best, base = res.best, res.baseline
    kinds = [p.kind.value for p in first.proposals]
    out["a"] = dict(
        batches=res.batches, candidates=res.candidates, evaluations=res.evaluations,
        wall_s=wall, s_per_batch=wall / res.batches, batch_s=batch_s,
        run_scenarios_s=[b["run_s"] for b in probe.batches], des_s=des,
        des_share=sum(des) / wall, launches=launches,
        dtoh_per_batch=prof["transfers"]["DtoH"] / res.batches,
        htod_per_batch=prof["transfers"]["HtoD"] / res.batches,
        profiled_wall_s=prof["wall_s"], device_idle_share=prof["device_idle_share"],
        peak_mb=[b["peak_mb"] for b in probe.batches],
        allocated_before_mb=probe.batches[0]["allocated_mb"],
        winner=dict(name=best.scenario.name, policy=best.scenario.policy,
                    backfill_depth=best.scenario.backfill_depth,
                    carbon_cap_base_w=best.scenario.carbon_cap_base_w,
                    carbon_cap_slope=best.scenario.carbon_cap_slope,
                    shift_bins=best.scenario.shift_bins, objective=best.objective,
                    breakdown=best.breakdown),
        baseline=dict(objective=base.objective, breakdown=base.breakdown),
        incumbent_objective=res.incumbent_objective.tolist(), proposals=kinds)
    a = out["a"]
    log(f"search (a) optimize_whatif on the calibrated E2 twin: {res.batches} batches of "
        f"{config.batch_size} lanes, {res.candidates} candidates, {res.evaluations} "
        f"evaluations; {wall:.3f} s ({a['s_per_batch']:.4f} s a batch, batches "
        f"{min(batch_s):.4f}-{max(batch_s):.4f}); run_scenarios "
        f"{min(a['run_scenarios_s']):.4f}-{max(a['run_scenarios_s']):.4f} s; DES "
        f"{sum(des):.4f} s (share {a['des_share']:.3f}); launches {launches}; "
        f"{a['dtoh_per_batch']:.1f} device-to-host and {a['htod_per_batch']:.1f} "
        f"host-to-device copies a batch (profiled run {prof['wall_s']:.3f} s, idle share "
        f"{prof['device_idle_share']:.4f}); peak allocated {min(a['peak_mb']):.1f}-"
        f"{max(a['peak_mb']):.1f} MiB a batch ({a['allocated_before_mb']:.1f} MiB before)")
    log(f"search (a) winner {best.scenario.name}: {best.scenario.policy}/backfill "
        f"{best.scenario.backfill_depth}, carbon cap {best.scenario.carbon_cap_base_w!r} W "
        f"{best.scenario.carbon_cap_slope!r} W/(gCO2/kWh), shift {best.scenario.shift_bins}; "
        f"objective {best.objective!r} against the baseline's {base.objective!r} "
        f"(gCO2 {best.breakdown['gco2_kg']!r} / {base.breakdown['gco2_kg']!r} kg); "
        f"proposals {kinds}; the second run equal bit for bit")

    # (b) the fused readout on the search path: generation 0 of (a)
    ops.reset_launches()
    fused = opt.optimize(orch.workload, dc, space, objective, t_bins=t_bins,
                         base_params=orch.state.params, carbon_intensity=ci, key=0,
                         config=dataclasses.replace(config, generations=0),
                         fused_readout=True)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches["des_place"] != fused.batches or launches["des_readout"] != fused.batches:
        fail(f"search (b): launches {launches}, expected one des_place and one "
             f"des_readout a batch ({fused.batches})")
    for k in path_launches:
        path_launches[k] += launches[k]
    seen = {knobs(c.scenario): c for c in res.history if c.generation == 0}
    worst = 0.0
    for c in fused.history:
        ref_c = seen.get(knobs(c.scenario))
        if ref_c is None:
            fail(f"search (b): {c.scenario.name} has no generation-0 counterpart in (a)")
        if c.feasible != ref_c.feasible:
            fail(f"search (b): feasibility of {c.scenario.name} differs from (a)'s")
        rel = abs(c.objective - ref_c.objective) / abs(ref_c.objective)
        if not rel <= 2e-4:
            fail(f"search (b): {c.scenario.name} objective {c.objective!r} against "
                 f"{ref_c.objective!r}, beyond rtol 2e-4")
        worst = max(worst, rel)
    out["b"] = dict(batches=fused.batches, launches=launches, max_rel_objective=worst)
    log(f"search (b) fused readout, generation 0: {fused.batches} batches, launches "
        f"{launches}; objectives within rtol 2e-4 of (a)'s (max rel {worst:.3g}), "
        f"feasibility equal")

    # (c) card against CPU, E2's hosts over 2 days
    t_c = int(SEARCH_CPU_DAYS * BINS_PER_DAY)
    w_c = make_surf22_like(SurfTraceSpec(days=SEARCH_CPU_DAYS, seed=E2_SEED), dc, device="cpu")
    params = PowerParams(*(float(getattr(card_orch.state.params, f))
                           for f in ("p_idle", "p_max", "r")))
    cfg_c = opt.OptimizerConfig(**SEARCH_CPU_CONFIG)
    ci_c = make_diurnal_carbon(t_c)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = opt.optimize(w_c.to(dev), dc, space, objective, t_bins=t_c,
                                 base_params=params, carbon_intensity=ci_c, key=0,
                                 config=cfg_c)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev + "_s"] = time.perf_counter() - t0
    card, cpu = runs["cuda"], runs["cpu"]
    tie = search_ties(card, cpu, 1e-5)
    worst = 0.0
    for x, y in zip(card.history, cpu.history):
        if tie is not None and x.scenario != y.scenario:
            break
        if (x.scenario, x.feasible, x.generation, x.lane) != \
                (y.scenario, y.feasible, y.generation, y.lane):
            fail(f"search (c): {x.scenario.name}: knobs, feasibility or lane differ")
        for f in ("unplaced_jobs", "makespan_bins", "mean_wait_bins", "p99_wait_bins"):
            if x.breakdown[f] != y.breakdown[f]:
                fail(f"search (c): {x.scenario.name} {f} {x.breakdown[f]} on the card, "
                     f"{y.breakdown[f]} on the CPU")
        rel = abs(x.objective - y.objective) / abs(y.objective)
        if not rel <= 1e-5:
            fail(f"search (c): {x.scenario.name} objective beyond rtol 1e-5 ({rel:.3g})")
        worst = max(worst, rel)
    if tie is None and card.best.scenario != cpu.best.scenario:
        fail("search (c): the card's and the CPU's incumbents differ")
    out["c"] = dict(days=SEARCH_CPU_DAYS, bins=t_c, hosts=dc.num_hosts,
                    batches=card.batches, card_s=runs["cuda_s"], cpu_s=runs["cpu_s"],
                    max_rel_objective=worst, tie=tie,
                    card_best=card.best.scenario.name, cpu_best=cpu.best.scenario.name,
                    card_best_objective=card.best.objective,
                    cpu_best_objective=cpu.best.objective)
    log(f"search (c) card against CPU, {dc.num_hosts} hosts x {t_c} bins, "
        f"{card.batches} batches ({SEARCH_CPU_CONFIG}): knobs, names, feasibility and the "
        f"schedule's terms equal, objectives max rel {worst:.3g} (rtol 1e-5), incumbent "
        f"{card.best.scenario.name} / {cpu.best.scenario.name}"
        + (f" ({tie})" if tie else "")
        + f"; card {runs['cuda_s']:.2f} s, CPU {runs['cpu_s']:.1f} s")

    # (d) stage 3: the resident DES equals the external cache, then an
    # approved scheduler change applied mid-run, on the card and the CPU
    resident, res_orch = e2_run(w, dc, t_bins, calibrate=True,
                                cfg=OrchestratorConfig(sim_in_state=True), device="cuda")
    ext_field = card_orch._ensure_sim().u_th
    if not np.array_equal(resident.per_window_mape, card_run.per_window_mape):
        fail("stage 3 (d): the resident DES's MAPE stream differs from the external cache's")
    for f in ("p_idle", "p_max", "r"):
        a_ = [float(getattr(r.params, f)) for r in resident.records]
        b_ = [float(getattr(r.params, f)) for r in card_run.records]
        if a_ != b_:
            fail(f"stage 3 (d): parameter stream {f} differs from the external cache's")
    if not torch.equal(res_orch.state.sim_u, ext_field):
        fail("stage 3 (d): the resident DES field differs from the external cache's")
    proposal = next((p for p in first.proposals
                     if p.kind is fb.ProposalKind.SCHEDULER_CHANGE), None)
    source = "the search's winner"
    if proposal is None:
        source = "fixed"
        proposal = fb.Proposal(fb.ProposalKind.SCHEDULER_CHANGE, STAGE3_APPLY_AT, "fixed",
                               impact={"policy": "best_fit", "backfill_depth": 4})
    impact = dict(policy=proposal.impact["policy"],
                  backfill_depth=proposal.impact["backfill_depth"])
    stage3 = {}
    for dev in ("cuda", "cpu"):
        wl = w if dev == "cuda" else w.to("cpu")
        t0 = time.perf_counter()
        dt = DigitalTwin(wl, dc, t_bins, OrchestratorConfig(sim_in_state=True, device=dev))
        o = dt.orchestrator
        truth = TraceGroundTruth(wl, dc, t_bins)

        def windows(rng):
            for win in rng:
                o.store.ingest(truth.window(win, o.cfg.bins_per_window))
                o.run_window(win)

        windows(range(STAGE3_APPLY_AT))
        p = fb.Proposal(fb.ProposalKind.SCHEDULER_CHANGE, STAGE3_APPLY_AT, proposal.detail,
                        impact=dict(impact), approved=True)
        ops.reset_launches()
        o.apply_proposal(p)
        if dev == "cuda":
            torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        ops.reset_launches()
        windows(range(STAGE3_APPLY_AT, o.num_windows))
        if dev == "cuda":
            torch.cuda.synchronize()
        after = dict(ops.LAUNCHES)
        if dev == "cuda":
            rest = o.num_windows - STAGE3_APPLY_AT
            if counts["des_place"] != 1 or counts["des_readout"] != 0:
                fail(f"stage 3 (d): apply_proposal launched {counts}, expected one des_place")
            if after["des_readout"] != rest or after["calib_mape_grid"] != rest:
                fail(f"stage 3 (d): {after} over {rest} windows, expected one des_readout "
                     "and one calib_mape_grid a window")
            for k in path_launches:
                path_launches[k] += counts[k] + after[k]
        stage3[dev] = dict(orch=o, seconds=time.perf_counter() - t0, apply=counts,
                           after=after)
    g, c = stage3["cuda"]["orch"], stage3["cpu"]["orch"]
    for f in ("p_idle", "p_max", "r"):
        a_ = [float(getattr(r.params, f)) for r in g.records]
        b_ = [float(getattr(r.params, f)) for r in c.records]
        if a_ != b_:
            fail(f"stage 3 (d): parameter stream {f}: card and CPU differ")
    mg, mc = g.per_window_mape(), c.per_window_mape()
    if not np.allclose(mg, mc, rtol=1e-5, atol=0.0, equal_nan=True):
        fail("stage 3 (d): MAPE stream: card and CPU beyond rtol 1e-5")
    if not torch.equal(g.state.sim_u.cpu(), c.state.sim_u):
        fail("stage 3 (d): the re-run resident DES field differs between card and CPU")
    moved = not torch.equal(g.state.sim_u, ext_field)
    out["d"] = dict(
        resident_equals_external=True, proposal_source=source, impact=impact,
        apply_at=STAGE3_APPLY_AT, apply_launches=stage3["cuda"]["apply"],
        after_launches=stage3["cuda"]["after"], field_moved=moved,
        card_s=stage3["cuda"]["seconds"], cpu_s=stage3["cpu"]["seconds"],
        mape_after=[float(x) for x in mg[STAGE3_APPLY_AT:]],
        max_rel_mape=float(np.nanmax(np.abs(mg - mc) / np.abs(mc))),
        overall_mape=g.overall_mape())
    d = out["d"]
    log(f"stage 3 (d): E2 calibrated with the resident DES equals the external cache bit "
        f"for bit (MAPE stream, parameter stream, DES field); {source} scheduler change "
        f"{impact} applied after window {STAGE3_APPLY_AT}: apply launches "
        f"{d['apply_launches']}, then {d['after_launches']} over "
        f"{g.num_windows - STAGE3_APPLY_AT} windows; the field moved: {moved}; card and "
        f"CPU parameter streams equal, MAPE max rel {d['max_rel_mape']:.3g} (rtol 1e-5), "
        f"overall MAPE {d['overall_mape']:.6f} %; card {d['card_s']:.2f} s, CPU "
        f"{d['cpu_s']:.1f} s")
    out["launches"] = path_launches
    log(f"search and stage 3 launches: {path_launches}")
    return out


# -- phase 12: the streaming twin service --------------------------------------

#: phase 12's service (a): 64 lanes; 56 synthetic tenants of 8 windows each
#: and 8 tenants replaying E2's ground truth, each with its own base
#: parameters (p_idle and p_max scaled); then 16 tenants repeating the
#: first 16 synthetic streams, served from the cache
SERVE_LANES = 64
SERVE_SYNTH = 56
SERVE_SYNTH_WINDOWS = 8
SERVE_SCALES = tuple(0.90 + 0.04 * i for i in range(8))
SERVE_REPEATS = 16
#: events submitted between serving rounds (fill varies from 64 down to 8)
SERVE_CHUNK = 128
#: (b) the joint grid with one refine round: 16 lanes x 16 tenants x 4 windows
SERVE_JOINT = dict(tenants=16, windows=4)
#: (c) kill and restore: 16 tenants x 8 windows, checkpointed after window 3
SERVE_RESTORE = dict(tenants=16, windows=8, cut=4)
#: (e) the E2 orchestrator checkpointed after this window
SERVE_E2_CUT = 28


def serve_leaves(np, out) -> list:
    """A WindowOutput's leaves as numpy (None kept), in a fixed order:
    every prediction leaf, mape, calib_mape, params_used, params_next,
    window."""
    pred = [getattr(out.prediction, f.name) for f in dataclasses.fields(out.prediction)]
    rest = [out.mape, out.calib_mape]
    for g in (out.params_used, out.params_next):
        rest += [g.p_idle, g.p_max, g.r]
    rest.append(out.window)
    return [None if x is None else (x.detach().cpu().numpy() if hasattr(x, "detach")
                                   else np.asarray(x))
            for x in pred + rest]


def serve_equal(np, got: list, want: list) -> bool:
    """Bit for bit, NaN where NaN, the same absent leaves."""
    return len(got) == len(want) and all(
        (a is None) == (b is None) and (a is None or (
            a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()))
        for a, b in zip(got, want))


def serve_close(np, got: list, want: list, rtol: float) -> tuple[bool, float]:
    """Parameters and window (the last 7 leaves) exact, the rest within
    ``rtol``; the largest relative error of the rest."""
    worst, ok = 0.0, len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if (a is None) != (b is None):
            return False, float("inf")
        if a is None:
            continue
        if i >= len(got) - 7:
            ok &= bool(np.array_equal(a, b))
            continue
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        both = np.isnan(a64) & np.isnan(b64)
        rel = np.where(both, 0.0, np.abs(a64 - b64) / np.maximum(np.abs(b64), 1e-300))
        worst = max(worst, float(np.nanmax(rel)) if rel.size else 0.0)
        ok &= bool(np.allclose(a64, b64, rtol=rtol, atol=0.0, equal_nan=True))
    return ok, worst


def serve_shuffled(np, svc, events, seed=42, chunk=SERVE_CHUNK):
    """Submit ``events`` shuffled, in chunks, serving after each; the
    results emitted."""
    rng = np.random.default_rng(seed)
    events = list(events)
    rng.shuffle(events)
    for i in range(0, len(events), chunk):
        for ev in events[i:i + chunk]:
            if not svc.submit(ev):
                fail("serve: the bounded queue rejected an event")
        svc.run_until_idle(pump=False)
    return svc.drain()


def serve_phase(torch, np, ops, w, dc, t_bins, card_run, device="cuda",
                keep=None) -> dict:
    """Phase 12, the streaming twin service on the card (paper stage 1).

    (a) a 64-lane ``TwinService`` at E2's width and window: 56 synthetic
    tenants and 8 replaying E2's ground truth under the diurnal carbon
    trace, each replay with its own base parameters (so the lanes'
    candidate rows differ), events shuffled and submitted in chunks; then
    16 tenants repeating synthetic streams, from the cache.  Every window
    equals a solo card ``twin_step`` of its stream bit for bit; a batch
    launches one ``des_readout`` and one ``calib_mape_grid``.  (b) the
    joint grid with one refine round, 16 lanes: two ``calib_mape_grid`` a
    batch, lanes equal solo.  (c) kill and restore through a
    ``SessionStore``.  (d) (b) on the CPU.  (e) state blobs across
    devices, and the E2 orchestrator checkpointed after window 28 and
    resumed.  (f) ``run_fleet`` of the 8 replay tenants over E2's 56
    windows.  (g) wall seconds, fill, warm tenant-windows a second, and
    one profiled batch (device busy and idle, copies, host time in
    ``encode_result`` and ``digest_arrays``).  ``device`` is the card; the
    CPU (a rehearsal at a small ``dc``) runs the same checks.
    """
    import tempfile

    from repro_torch.core import (
        CalibrationSpec, DigitalTwin, OrchestratorConfig, TraceGroundTruth)
    from repro_torch.core.power import PowerParams
    from repro_torch.core.state import (
        SimSlice, TelemetrySlice, TwinConfig, init_twin_state, make_telemetry,
        state_from_bytes, state_leaves, state_to_bytes, twin_step)
    from repro_torch.core.twin import run_fleet, stack_twin_states
    from repro_torch.serve import ServeConfig, SyntheticProducer, TraceReplayProducer, TwinService
    from repro_torch.serve import service as service_mod
    from repro_torch.traces.carbon import make_diurnal_carbon

    out: dict = {}
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    bins = 36
    ci = np.asarray(make_diurnal_carbon(t_bins), np.float32)
    truth = TraceGroundTruth(w, dc, t_bins)
    n_e2 = t_bins // bins

    class CarbonSynthetic(SyntheticProducer):
        """A synthetic tenant whose windows carry the diurnal carbon column."""

        def _window_event(self, window):
            ev = super()._window_event(window)
            return dataclasses.replace(
                ev, carbon_intensity=ci[window * bins:(window + 1) * bins].copy())

    def twin_cfg(where=device, **kw):
        return TwinConfig(bins_per_window=bins, dc=dc, history_windows=4,
                          device=where, **kw)

    def serve_cfg(where=device, lanes=SERVE_LANES, **kw):
        return ServeConfig(twin=twin_cfg(where, **kw), lanes=lanes, queue_capacity=4096,
                           cache_entries=2048, columns=("carbon_intensity",))

    def synthetic(name, seed, windows):
        return CarbonSynthetic(name, hosts=dc.num_hosts, bins_per_window=bins,
                               num_windows=windows, seed=seed,
                               util_mean=0.3 + 0.02 * (seed % 10))

    def scaled(s):
        base = PowerParams()
        return PowerParams(p_idle=base.p_idle * s, p_max=base.p_max * s, r=base.r)

    def solo(cfg, base, events):
        """A tenant's stream through solo ``twin_step`` on ``cfg.device``."""
        st = init_twin_state(cfg, base)
        got = {}
        where = cfg.device
        for ev in sorted(events, key=lambda e: e.window):
            st, o = twin_step(st, make_telemetry(ev.u_th, ev.power_w, device=where),
                              SimSlice(u_th=torch.from_numpy(ev.sim_u).to(where),
                                       carbon_intensity=torch.from_numpy(
                                           ev.carbon_intensity).to(where)))
            got[ev.window] = serve_leaves(np, o)
        return got

    def check_order(results, lengths, label):
        by = {}
        for r in results:
            by.setdefault(r.tenant, []).append(r.window)
        for t, n in lengths.items():
            if by.get(t) != list(range(n)):
                fail(f"serve {label}: tenant {t} emitted windows {by.get(t)}, not 0..{n - 1}")
        return by

    # (a) the operator's service
    cfg_a = serve_cfg()
    streams, bases = {}, {}
    for i in range(SERVE_SYNTH):
        name = f"syn{i:02d}"
        streams[name] = synthetic(name, i, SERVE_SYNTH_WINDOWS).poll(float("inf"))
        bases[name] = PowerParams()
    for j, s in enumerate(SERVE_SCALES):
        name = f"e2-{j}"
        streams[name] = TraceReplayProducer(name, truth, bins, carbon_intensity=ci).poll(
            float("inf"))
        bases[name] = scaled(s)
    svc = TwinService(cfg_a)
    for t in streams:
        svc.admit(t, init_twin_state(cfg_a.twin, bases[t]))
    ops.reset_launches()
    sync()
    t0 = time.perf_counter()
    results = serve_shuffled(np, svc, [ev for evs in streams.values() for ev in evs])
    sync()
    wall = time.perf_counter() - t0
    if keep is not None:
        keep["serve_a"] = dict(cfg=cfg_a, streams=streams, bases=bases, results={
            (r.tenant, r.window): serve_leaves(np, r.output) for r in results})
    batches, fill = svc.stats.batches, svc.stats.fill_ratio
    launches = {k: ops.LAUNCHES[k] for k in ("des_readout", "calib_mape_grid")}
    if launches != {"des_readout": batches, "calib_mape_grid": batches}:
        fail(f"serve (a): {launches} over {batches} batches, not one of each a batch")
    if any(ops.LAUNCHES[k] for k in ops.LAUNCHES if k not in launches):
        fail(f"serve (a): launched other kernels: {dict(ops.LAUNCHES)}")
    # the second group: 16 tenants repeating synthetic streams, from the cache
    repeats = {}
    for i in range(SERVE_REPEATS):
        svc.evict(f"syn{i:02d}")
        name = f"rep{i:02d}"
        svc.admit(name)
        repeats[name] = [dataclasses.replace(ev, tenant=name) for ev in streams[f"syn{i:02d}"]]
        bases[name] = PowerParams()
    results += serve_shuffled(np, svc, [ev for evs in repeats.values() for ev in evs])
    if svc.stats.batches != batches or svc.stats.windows_cached != SERVE_REPEATS * SERVE_SYNTH_WINDOWS:
        fail(f"serve (a): the repeated streams took {svc.stats.batches - batches} batches and "
             f"{svc.stats.windows_cached} cache hits, not 0 and "
             f"{SERVE_REPEATS * SERVE_SYNTH_WINDOWS}")
    path_launches = dict(ops.LAUNCHES)
    lengths = {t: len(evs) for t, evs in {**streams, **repeats}.items()}
    check_order(results, lengths, "(a)")
    t_solo = time.perf_counter()
    refs = {t: solo(cfg_a.twin, bases[t], evs) for t, evs in streams.items()}
    for i in range(SERVE_REPEATS):
        refs[f"rep{i:02d}"] = refs[f"syn{i:02d}"]
    for r in results:
        if not serve_equal(np, serve_leaves(np, r.output), refs[r.tenant][r.window]):
            fail(f"serve (a): {r.tenant} window {r.window} ({'cached' if r.cached else 'computed'}) "
                 "differs from the solo card twin_step")
    out["a"] = dict(
        tenant_windows=len(results), batches=batches, fill_ratio=fill, wall_s=wall,
        s_per_batch=wall / batches, windows_cached=svc.stats.windows_cached,
        launches=launches, solo_s=time.perf_counter() - t_solo)
    log(f"serve (a): {len(results)} tenant-windows of {len(lengths)} tenants ({SERVE_LANES} "
        f"lanes, {dc.num_hosts} hosts x {bins} bins, 8 lanes with their own base parameters), "
        f"{batches} batches, fill {fill:.4f}, {wall:.2f} s ({wall / batches * 1e3:.1f} ms a "
        f"batch), {svc.stats.windows_cached} windows from the cache; launches {launches}: one "
        "des_readout and one calib_mape_grid a batch; every window equals the solo card "
        "twin_step bit for bit")

    # (e) a card state's blob loads on the CPU and back, dtype-exact
    lane_state = svc.evict("e2-3").state
    blob = state_to_bytes(lane_state)
    on_cpu = state_from_bytes(blob, device="cpu")
    back = state_from_bytes(state_to_bytes(on_cpu), device=device)
    for a, b, c in zip(state_leaves(lane_state), state_leaves(on_cpu), state_leaves(back)):
        if not (a.dtype == b.dtype == c.dtype and torch.equal(a.cpu(), b)
                and torch.equal(a, c)):
            fail("serve (e): a state blob does not cross card -> CPU -> card bit for bit")
    if state_to_bytes(on_cpu) != blob:
        fail("serve (e): the CPU copy's blob differs from the card state's")

    # (f) run_fleet: the 8 replay tenants over E2's 56 windows
    fleet = stack_twin_states([init_twin_state(cfg_a.twin, scaled(s)) for s in SERVE_SCALES])
    u = torch.from_numpy(np.stack([truth.u_th[k * bins:(k + 1) * bins] for k in range(n_e2)]))
    p = torch.from_numpy(np.stack([truth.power[k * bins:(k + 1) * bins]
                                   for k in range(n_e2)]).astype(np.float32))
    c = torch.from_numpy(np.stack([ci[k * bins:(k + 1) * bins] for k in range(n_e2)]))
    d = len(SERVE_SCALES)
    lane_axis = lambda x: x[:, None].expand(x.shape[0], d, *x.shape[1:]).contiguous().to(dev)  # noqa: E731
    ops.reset_launches()
    t0 = time.perf_counter()
    ffinal, fouts = run_fleet(
        fleet, TelemetrySlice(u_th=lane_axis(u), power_w=lane_axis(p),
                              valid=torch.ones((n_e2, d), dtype=torch.bool, device=dev)),
        SimSlice(u_th=lane_axis(u), carbon_intensity=lane_axis(c)))
    sync()
    fleet_s = time.perf_counter() - t0
    fl = {k: ops.LAUNCHES[k] for k in ("des_readout", "calib_mape_grid")}
    if fl != {"des_readout": n_e2, "calib_mape_grid": n_e2}:
        fail(f"serve (f): run_fleet launched {fl}, not {n_e2} of each")
    for k in fl:
        path_launches[k] += fl[k]
    host = serve_leaves(np, fouts)
    if keep is not None:
        keep["serve_f"] = dict(
            fleet=lambda: stack_twin_states([init_twin_state(cfg_a.twin, scaled(s))
                                             for s in SERVE_SCALES]),
            telemetry=TelemetrySlice(u_th=lane_axis(u), power_w=lane_axis(p),
                                     valid=torch.ones((n_e2, d), dtype=torch.bool, device=dev)),
            sims=SimSlice(u_th=lane_axis(u), carbon_intensity=lane_axis(c)), host=host,
            final=[x.cpu() for x in state_leaves(ffinal)])
    for j in range(d):
        for k in range(n_e2):
            got = [None if x is None else x[k, j] for x in host]
            if not serve_equal(np, got, refs[f"e2-{j}"][k]):
                fail(f"serve (f): run_fleet lane {j} window {k} differs from its solo run")
    out["f"] = dict(lanes=d, windows=n_e2, launches=fl, wall_s=fleet_s)
    log(f"serve (f): run_fleet of {d} lanes over {n_e2} windows: {fl} launches (not "
        f"{d} x {n_e2}), every lane equals its solo run bit for bit, {fleet_s:.2f} s")

    # (b) the joint grid with one refine round, and (d) the same on the CPU
    joint = CalibrationSpec(mode="joint", refine_iters=1)
    jt = {f"jt{i:02d}": (synthetic(f"jt{i:02d}", 100 + i, SERVE_JOINT["windows"]),
                         scaled(0.90 + 0.02 * i))
          for i in range(SERVE_JOINT["tenants"])}
    jt_events = {t: p_.poll(float("inf")) for t, (p_, _) in jt.items()}
    by_device = {}
    for where in (device, "cpu"):
        cfg_b = serve_cfg(where, lanes=SERVE_JOINT["tenants"], calibration=joint)
        svc_b = TwinService(cfg_b)
        for t, (_, base) in jt.items():
            svc_b.admit(t, init_twin_state(cfg_b.twin, base))
        ops.reset_launches()
        t0 = time.perf_counter()
        res = serve_shuffled(np, svc_b, [ev for evs in jt_events.values() for ev in evs])
        secs = time.perf_counter() - t0
        check_order(res, {t: SERVE_JOINT["windows"] for t in jt}, f"(b) {where}")
        finals = {t: [x.cpu() for x in state_leaves(svc_b.evict(t).state)] for t in jt}
        by_device[where] = (res, finals, svc_b.stats.batches, dict(ops.LAUNCHES), secs)
    res_b, finals_b, batches_b, launches_b, secs_b = by_device[device]
    want = {"des_readout": batches_b, "calib_mape_grid": 2 * batches_b}
    if {k: launches_b[k] for k in want} != want:
        fail(f"serve (b): {launches_b} over {batches_b} batches, not {want}")
    for k in want:
        path_launches[k] += launches_b[k]
    jrefs = {t: solo(twin_cfg(calibration=joint), jt[t][1], jt_events[t]) for t in jt}
    for r in res_b:
        if not serve_equal(np, serve_leaves(np, r.output), jrefs[r.tenant][r.window]):
            fail(f"serve (b): {r.tenant} window {r.window} differs from the solo card twin_step")
    res_d, finals_d, _, _, secs_d = by_device["cpu"]
    cpu_out = {(r.tenant, r.window): serve_leaves(np, r.output) for r in res_d}
    worst_d = 0.0
    for r in res_b:
        ok, rel = serve_close(np, serve_leaves(np, r.output), cpu_out[(r.tenant, r.window)], 1e-5)
        worst_d = max(worst_d, rel)
        if not ok:
            fail(f"serve (d): {r.tenant} window {r.window}: card and CPU differ beyond the "
                 "bar (parameters exact, floats rtol 1e-5)")
    for t in jt:
        if not all(torch.equal(a, b) for a, b in zip(finals_b[t], finals_d[t])):
            fail(f"serve (d): {t}'s final state (parameters, history, counts) differs "
                 "between card and CPU")
    out["b"] = dict(batches=batches_b, launches={k: launches_b[k] for k in want},
                    wall_s=secs_b)
    out["d"] = dict(cpu_s=secs_d, max_rel=worst_d)
    log(f"serve (b): joint grid + 1 refine round, {len(jt)} lanes x {SERVE_JOINT['windows']} "
        f"windows, {batches_b} batches, launches {out['b']['launches']} (two calib_mape_grid a "
        f"batch), lanes equal solo bit for bit, {secs_b:.2f} s; (d) the CPU rerun: parameter "
        f"streams and counts equal, floats max rel {worst_d:.3g} (rtol 1e-5), {secs_d:.1f} s")

    # (c) kill and restore through a SessionStore
    n_t, n_w, cut = SERVE_RESTORE["tenants"], SERVE_RESTORE["windows"], SERVE_RESTORE["cut"]
    r_events = {f"syn{i:02d}": synthetic(f"syn{i:02d}", i, n_w).poll(float("inf"))
                for i in range(n_t)}

    ref_svc = TwinService(cfg_a)
    for t in r_events:
        ref_svc.admit(t)
    ref_c = {(r.tenant, r.window): r for r in serve_shuffled(
        np, ref_svc, [ev for evs in r_events.values() for ev in evs], seed=7)}
    first = TwinService(cfg_a)
    for t in r_events:
        first.admit(t)
    got_c = serve_shuffled(np, first, [ev for evs in r_events.values() for ev in evs
                                       if ev.window < cut], seed=7)
    with tempfile.TemporaryDirectory() as root:
        first.checkpoint(root)
        del first
        restored = TwinService(cfg_a)
        if sorted(restored.restore(root)) != sorted(r_events):
            fail("serve (c): the restored service has other tenants")
        for i, t in enumerate(r_events):
            restored.attach(synthetic(t, i, n_w))
        got_c += restored.run_until_idle()
    if restored.stats.stale_dropped != n_t * cut:
        fail(f"serve (c): {restored.stats.stale_dropped} stale replays dropped, not {n_t * cut}")
    union = {(r.tenant, r.window): r for r in got_c}
    if set(union) != set(ref_c):
        fail("serve (c): the interrupted run emitted other windows than the uninterrupted one")
    for key, r in union.items():
        if not serve_equal(np, serve_leaves(np, r.output), serve_leaves(np, ref_c[key].output)):
            fail(f"serve (c): {key} after restore differs from the uninterrupted run")
    out["c"] = dict(tenants=n_t, windows=n_w, cut=cut, stale_dropped=restored.stats.stale_dropped)
    log(f"serve (c): {n_t} tenants x {n_w} windows, checkpointed after window {cut - 1} and "
        f"restored: the union equals the uninterrupted run bit for bit, "
        f"{restored.stats.stale_dropped} stale replays dropped")

    # (e) the calibrated E2 orchestrator checkpointed mid-run and resumed
    with tempfile.TemporaryDirectory() as root:
        path = f"{root}/e2.ckpt"
        head = DigitalTwin(w, dc, t_bins, OrchestratorConfig(device=device))
        head.run(truth.window, num_windows=SERVE_E2_CUT)
        head.orchestrator.save_state(path)
        tail = DigitalTwin(w, dc, t_bins, OrchestratorConfig(device=device))
        tail.orchestrator.restore_state(path)
    orch = tail.orchestrator
    for k in range(SERVE_E2_CUT, n_e2):
        orch.store.ingest(truth.window(k, bins))
        orch.run_window(k)
    full = card_run.records[SERVE_E2_CUT:]
    if not np.array_equal(np.array([r.mape for r in orch.records]),
                          np.array([r.mape for r in full])):
        fail("serve (e): the resumed E2 MAPE stream differs from the uninterrupted run")
    for f in ("p_idle", "p_max", "r"):
        if [float(getattr(r.params, f)) for r in orch.records] != \
                [float(getattr(r.params, f)) for r in full]:
            fail(f"serve (e): the resumed E2 parameter stream {f} differs")
    out["e"] = dict(cut=SERVE_E2_CUT, windows=len(full))
    log(f"serve (e): a card state's blob crosses to the CPU and back bit for bit; E2 "
        f"checkpointed after window {SERVE_E2_CUT - 1} resumes equal to phase 4's run "
        f"(parameter stream exact, MAPE bit for bit over {len(full)} windows)")

    # (g) warm throughput at full fill, the host's split, one profiled batch
    warm = TwinService(cfg_a)
    for t in streams:
        warm.admit(t, init_twin_state(cfg_a.twin, bases[t]))
    host_s = {"encode_result": 0.0, "digest_arrays": 0.0}
    saved = {k: getattr(service_mod, k) for k in host_s}

    def timed_host(name):
        fn = saved[name]

        def wrapper(*a, **kw):
            t1 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host_s[name] += time.perf_counter() - t1
        return wrapper

    events = [ev for evs in streams.values() for ev in evs if ev.window < SERVE_SYNTH_WINDOWS]
    try:
        for k in host_s:
            setattr(service_mod, k, timed_host(k))
        sync()
        t0 = time.perf_counter()
        for ev in events:
            warm.submit(ev)
        warm.run_until_idle(pump=False)
        sync()
        warm_s = time.perf_counter() - t0
    finally:
        for k, fn in saved.items():
            setattr(service_mod, k, fn)
    if warm.stats.batches != SERVE_SYNTH_WINDOWS or len(warm.drain()) != len(events):
        fail(f"serve (g): the warm run took {warm.stats.batches} batches")
    # a trace that lost device events is taken again on a fresh service:
    # busy time and idle share come from a trace that holds every copy
    lost = []
    for retries in range(SERVE_TRACE_RETRIES + 1):
        prof = TwinService(cfg_a)
        for t in streams:
            prof.admit(t, init_twin_state(cfg_a.twin, bases[t]))
        for t, evs in streams.items():
            prof.submit(evs[0])
        trace = traced(torch, lambda: prof.run_until_idle(pump=False))
        if prof.stats.batches != 1 or trace["device_busy_s"] <= 0:
            fail("serve (g): the profiled batch is not one batch on the device")
        if trace["complete"] or dev.type != "cuda":
            break
        lost.append(trace["runtime_copies"] - trace["device_copies"])
    trace["retries"], trace["copies_lost_by_retry"] = retries, lost
    out["g"] = dict(
        warm_tenant_windows=len(events), warm_s=warm_s,
        warm_tenant_windows_per_s=len(events) / warm_s, warm_batches=warm.stats.batches,
        warm_s_per_batch=warm_s / warm.stats.batches,
        host_s_per_batch={k: v / warm.stats.batches for k, v in host_s.items()},
        rest_s_per_batch=(warm_s - sum(host_s.values())) / warm.stats.batches,
        batch_trace=trace)
    g = out["g"]
    log(f"serve (g): warm, full fill: {len(events)} tenant-windows in {warm_s:.2f} s = "
        f"{g['warm_tenant_windows_per_s']:.1f} tenant-windows/s ({g['warm_s_per_batch'] * 1e3:.1f} "
        f"ms a 64-lane batch: encode_result {g['host_s_per_batch']['encode_result'] * 1e3:.1f} ms, "
        f"digest_arrays {g['host_s_per_batch']['digest_arrays'] * 1e3:.1f} ms, the rest "
        f"{g['rest_s_per_batch'] * 1e3:.1f} ms); one profiled batch: wall "
        f"{trace['wall_s'] * 1e3:.1f} ms, device busy {trace['device_busy_s'] * 1e3:.3f} ms"
        f"{'' if trace['complete'] else ' (a lower bound: the trace lost device events)'}, "
        f"idle share {trace['device_idle_share']:.4f}, {trace['transfers']['HtoD']} "
        f"host-to-device and {trace['transfers']['DtoH']} device-to-host copies, "
        f"{trace['device_copies']} of the {trace['runtime_copies']} copies the host issued "
        f"traced, {retries} retries")
    for row in trace["top"][:6]:
        log(f"    {row['device_ms']:.3f} ms x{row['count']}  {row['name']}")
    out["launches"] = path_launches
    log(f"serve launches: {path_launches}")
    return out

# -- phase 15: lane sharding over the card mesh --------------------------------

#: phase 15 (b)'s padding case: the 8 replays over this many entries
SHARD_PAD_ENTRIES = 3
#: phase 15 (c): the what-if batches split over the mesh (C: 16 lanes; D:
#: 64 lanes over E2's week)
SHARD_WHATIF = ("C", "D")
#: phase 15 (d): phase 11's search cut to two batches (a drawn generation 0
#: and one refinement)
SHARD_SEARCH = dict(batch_size=16, generations=1, init="random")


def card_mesh(torch, axis, entries=None, device="cuda"):
    """A 1-D mesh over ``axis``: every card when the host has more than one
    (``entries`` of them, taken in turn), else ``cuda:0`` repeated (4
    entries, or ``entries``); ``device="cpu"`` repeats the CPU."""
    from repro_torch.parallel.sharding import make_mesh_compat

    n = torch.cuda.device_count() if device == "cuda" else 0
    if entries is None:
        entries = n if n > 1 else 4
    devices = ([f"cuda:{i % n}" for i in range(entries)] if n > 1
               else [torch.device(device, 0) if device == "cuda" else "cpu"] * entries)
    return make_mesh_compat((entries,), (axis,), devices=devices)


def shard_phase(torch, np, ops, w, dc, t_bins, card_orch, keep, device="cuda") -> dict:
    """Phase 15, lane sharding over the card mesh: every card, or ``cuda:0``
    four times on a host with one (the shards then run in turn on that
    card).  (a) phase 12 (a)'s 64-lane service with ``ServeConfig(shard=True,
    mesh=...)``: every window equal to phase 12's unsharded one bit for
    bit, one ``des_readout`` and one ``calib_mape_grid`` a batch an entry;
    (b) phase 12 (f)'s ``run_fleet`` of the 8 replays sharded, and over
    ``SHARD_PAD_ENTRIES`` entries (padded to 9 lanes), outputs and final
    state equal to the unsharded run's; (c) phase 7's fused what-if C and D
    sharded: schedules and every float equal; (d) two batches of phase
    11's search, unsharded and sharded: histories and proposals equal; (e)
    ``des_place``'s two probes on each distinct device of the mesh.
    ``keep`` holds the unsharded results phases 7 and 12 kept.  Launches
    are counted per part, from 0, and given per mesh entry."""
    import importlib

    from repro_torch.core import Orchestrator, OrchestratorConfig
    from repro_torch.core import scenarios as psc
    from repro_torch.core import twin as ptwin
    from repro_torch.core.state import init_twin_state, state_leaves
    from repro_torch.kernels import des_place
    from repro_torch.parallel.sharding import lane_devices
    from repro_torch.serve import TwinService
    from repro_torch.traces.carbon import make_diurnal_carbon

    out, path_launches = {}, {k: 0 for k in ("des_place", "des_readout", "calib_mape_grid")}
    cards = torch.cuda.device_count() if device == "cuda" else 0
    mesh = card_mesh(torch, ptwin.FLEET_AXIS, device=device)
    smesh = card_mesh(torch, psc.SCENARIO_AXIS, device=device)
    entries = mesh.size
    where = (f"{entries} cards" if cards > 1 else
             f"{mesh.devices[0]} {entries} times (one card: the shards run in turn)")
    out.update(mesh=[str(d) for d in mesh.devices], entries=entries, cards=cards)
    log(f"shard: a mesh of {where}; the host has {cards} card(s)")

    def counted(fn):
        """``fn()``, its launches (added to the phase's) and wall seconds."""
        ops.reset_launches()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: ops.LAUNCHES[k] for k in path_launches}
        for k in got:
            path_launches[k] += got[k]
        return res, got, secs

    def per_entry(got, m):
        return {k: v / m.size for k, v in got.items()}

    # (a) the service
    a = keep["serve_a"]
    cfg = dataclasses.replace(a["cfg"], shard=True, mesh=mesh)
    svc = TwinService(cfg)
    for t in a["streams"]:
        svc.admit(t, init_twin_state(cfg.twin, a["bases"][t]))
    results, got, secs = counted(lambda: serve_shuffled(
        np, svc, [ev for evs in a["streams"].values() for ev in evs]))
    if sorted((r.tenant, r.window) for r in results) != sorted(a["results"]):
        fail("shard (a): the sharded service emitted other windows than phase 12 (a)")
    for r in results:
        if not serve_equal(np, serve_leaves(np, r.output), a["results"][(r.tenant, r.window)]):
            fail(f"shard (a): {r.tenant} window {r.window} differs from phase 12's "
                 "unsharded window")
    batches = svc.stats.batches
    want = {"des_place": 0, "des_readout": entries * batches,
            "calib_mape_grid": entries * batches}
    if device == "cuda" and got != want:
        fail(f"shard (a): launches {got} over {batches} batches, not {want}")
    out["a"] = dict(tenant_windows=len(results), batches=batches, launches=got,
                    launches_per_entry=per_entry(got, mesh), wall_s=secs)
    log(f"shard (a): the 64-lane service over {entries} entries, {len(results)} tenant-"
        f"windows in {batches} batches, every window equal to phase 12's bit for bit; "
        f"launches {got} ({per_entry(got, mesh)} an entry), {secs:.2f} s")

    # (b) run_fleet of the 8 replays, and the padding case
    f = keep["serve_f"]
    n_w = f["telemetry"].u_th.shape[0]
    out["b"] = {}
    for m in (mesh, card_mesh(torch, ptwin.FLEET_AXIS, SHARD_PAD_ENTRIES, device)):
        (final, fouts), got, secs = counted(lambda: ptwin.run_fleet(
            f["fleet"](), f["telemetry"], f["sims"], shard=True, mesh=m))
        label = f"{m.size} entries"
        if not serve_equal(np, serve_leaves(np, fouts), f["host"]):
            fail(f"shard (b): run_fleet over {label} differs from phase 12 (f)'s outputs")
        if not all(torch.equal(x.cpu(), y) for x, y in zip(state_leaves(final), f["final"])):
            fail(f"shard (b): run_fleet over {label}: the final fleet differs from phase "
                 "12 (f)'s")
        want = {"des_place": 0, "des_readout": n_w * m.size, "calib_mape_grid": n_w * m.size}
        if device == "cuda" and got != want:
            fail(f"shard (b): run_fleet over {label} launched {got}, not {want}")
        out["b"][label] = dict(launches=got, launches_per_entry=per_entry(got, m), wall_s=secs)
        log(f"shard (b): run_fleet of {len(SERVE_SCALES)} lanes x {n_w} windows over "
            f"{label}: outputs and final state equal to phase 12 (f)'s bit for bit; "
            f"launches {got} ({per_entry(got, m)} an entry), {secs:.2f} s")

    # (c) the fused what-if batches
    for label in SHARD_WHATIF:
        k = keep[f"whatif_{label}"]
        ss = k["ss"]
        (sim, pred), got, secs = counted(lambda: psc.run_scenarios(
            ss, max_hosts=ss.max_hosts, t_bins=k["t_bins"], fused_readout=True,
            shard=True, mesh=smesh, **k["traces"]))
        same_sim(torch, sim, k["out"][0], f"{label} sharded vs unsharded")
        for x, y in ((sim, k["out"][0]), (pred, k["out"][1])):
            for fld in dataclasses.fields(x):
                g, h = getattr(x, fld.name), getattr(y, fld.name)
                if (g is None) != (h is None) or (g is not None and not torch.equal(g, h)):
                    fail(f"what-if {label} sharded: {fld.name} differs from phase 7's")
        want = {"des_place": entries, "des_readout": entries, "calib_mape_grid": 0}
        if device == "cuda" and got != want:
            fail(f"shard (c): what-if {label} launched {got}, not {want}")
        out[f"c_{label}"] = dict(lanes=ss.num_scenarios, launches=got,
                                 launches_per_entry=per_entry(got, smesh), wall_s=secs)
        log(f"shard (c): what-if {label}, {ss.num_scenarios} lanes over {entries} entries: "
            f"schedules and every float equal to phase 7's; launches {got}, {secs:.3f} s")

    # (d) two batches of phase 11's search, unsharded and sharded
    opt = importlib.import_module("repro_torch.core.optimize")
    space = search_space(psc, opt)
    objective = opt.ObjectiveSpec(**SEARCH_OBJECTIVE)
    config = opt.OptimizerConfig(**SHARD_SEARCH)
    ci = make_diurnal_carbon(t_bins)

    def search(**kw):
        orch = Orchestrator(w, dc, t_bins, OrchestratorConfig(device=device),
                            carbon_intensity=ci)
        orch.state = card_orch.state
        return orch.optimize_whatif(space, objective, key=0, config=config, **kw)

    ref, got_r, secs_r = counted(search)
    sh, got, secs = counted(lambda: search(shard=True, mesh=smesh))
    if history_rows(sh.result) != history_rows(ref.result):
        fail("shard (d): the sharded search's history differs from the unsharded one's")
    props = lambda r: [(p.kind, p.detail, p.impact) for p in r.proposals]  # noqa: E731
    if props(sh) != props(ref):
        fail("shard (d): the sharded search proposes otherwise than the unsharded one")
    n_b = ref.result.batches
    if device == "cuda" and (got["des_place"], got_r["des_place"]) != (entries * n_b, n_b):
        fail(f"shard (d): des_place launches {got['des_place']} sharded and "
             f"{got_r['des_place']} unsharded over {n_b} batches")
    out["d"] = dict(batches=n_b, evaluations=ref.result.evaluations, launches=got,
                    launches_per_entry=per_entry(got, smesh), wall_s=secs,
                    unsharded_wall_s=secs_r, proposals=[p.kind.value for p in sh.proposals])
    log(f"shard (d): {n_b} batches of {config.batch_size} lanes of phase 11's search, "
        f"sharded and unsharded: histories ({ref.result.evaluations} evaluations) and "
        f"proposals equal; sharded launches {got} ({per_entry(got, smesh)} an entry), "
        f"{secs:.3f} s against {secs_r:.3f} s unsharded")

    # (e) the placement kernel's probes on each distinct device of the mesh
    probed = []
    if device == "cuda":
        for d in dict.fromkeys(lane_devices(mesh, ptwin.FLEET_AXIS)):
            o = torch.zeros(1, dtype=torch.int32, device=d)
            if des_place.barrier_launch(8, 2, o) != 0 or des_place.step_launch(8, o) != 0:
                fail(f"shard (e): a des_place probe failed on {d}")
            torch.cuda.synchronize(d)
            probed.append(str(d))
    out["e"] = dict(probed=probed)
    out["launches"] = path_launches
    log(f"shard (e): des_place's barrier and step probes launched on {probed}; "
        f"phase launches {path_launches}")
    return out


def time_place(torch, timer, ref, dev, cases) -> dict:
    """des_place at the E2 horizon (the main path's lane), C and D: device
    ms a launch (its scratch zeroing included), the same operands with
    ``max_starts_per_bin=0`` (the bins alone), the longest lane's
    attempts, us an attempt ((launch - bins alone) / those attempts), and
    two bounds, each raised to the bytes it must move where those take
    longer: (attempts + bins) x one decision step (``des_place.step_launch``,
    one warp, timed alone), and the earlier block design's, attempts x its
    barrier round trip (``des_place.barrier_launch``, a block of
    ``max_backfill + 1`` warps); ``bound_ms`` is the smaller.  The plain
    version's wall time on the card at the E2 horizon (it reads the card
    once per attempt, so only a host clock times it)."""
    from repro_torch.kernels import des_place

    probe = torch.zeros(1, dtype=torch.int32, device=dev)
    rounds = 100_000
    probes = {}

    def probe_ms(key, launch):
        if key not in probes:
            def run():
                if launch() != 0:
                    fail(f"des_place {key} probe: the launch returned a CUDA error")
            probes[key] = timer.device_ms(run, reps=5)["ms"] / rounds
        return probes[key]

    out = {}
    for label, args, kw, _ in cases:
        if not label.startswith(("E2 week, the main path's", "C:", "D:")):
            continue
        call = dict(kw, max_starts_per_bin=kw.get("max_starts_per_bin", 64))

        def kernel(c=call):
            return des_place.des_place_cuda(*args, **c)

        attempts = kernel()[2]
        k = timer.device_ms(kernel, reps=5)
        bins = timer.device_ms(lambda: kernel(dict(call, max_starts_per_bin=0)), reps=5)
        step = probe_ms("step", lambda: des_place.step_launch(rounds, probe))
        warps = kw["max_backfill"] + 1
        rt = probe_ms(f"barrier {warps}", lambda: des_place.barrier_launch(rounds, warps, probe))
        most, t_bins = int(attempts.max()), kw["t_bins"]
        n_bytes = (sum(a.element_size() * a.numel() for a in args)
                   + sum(v.element_size() * v.numel() for v in kw.values()
                         if isinstance(v, torch.Tensor))
                   + 8 * args[0].numel() + 4 * args[0].shape[0])
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        step_ms, barrier_ms = (most + t_bins) * step, most * rt
        bound_ms = max(min(step_ms, barrier_ms), bytes_ms)
        out[label] = dict(ms=k["ms"], kernel_rounds=k, bins_ms=bins["ms"], bins_rounds=bins,
                          lanes=args[0].shape[0], bins=t_bins,
                          attempts_total=int(attempts.sum()), attempts_max=most,
                          us_per_attempt=(k["ms"] - bins["ms"]) * 1e3 / most,
                          step_us=step * 1e3, barrier_round_trip_us=rt * 1e3,
                          bytes=n_bytes, step_bound_ms=max(step_ms, bytes_ms),
                          barrier_bound_ms=max(barrier_ms, bytes_ms), bound_ms=bound_ms,
                          x_bound=k["ms"] / bound_ms,
                          bound_by="operations" if min(step_ms, barrier_ms) >= bytes_ms
                          else "bytes")
        if label.startswith("E2"):
            plain = dict(kw, max_starts_per_bin=64)
            out[label]["plain_ms"] = timer.wall_ms(
                lambda: ref.des_place_ref(*args, **plain), reps=1)
        v = out[label]
        log(f"des_place {label}: {k['ms']:.3f} ms a launch (rounds {k['min_ms']:.3f}-"
            f"{k['max_ms']:.3f}), bins alone {bins['ms']:.3f} ms, {most} attempts in the "
            f"longest lane, {v['us_per_attempt']:.4f} us an attempt; decision step "
            f"{step * 1e3:.4f} us, bound {v['step_bound_ms']:.4f} ms; barrier round trip "
            f"{rt * 1e3:.4f} us ({warps} warps), bound {v['barrier_bound_ms']:.4f} ms; "
            f"{v['x_bound']:.1f}x the smaller ({v['bound_by']})"
            + (f"; plain version on the card {v['plain_ms']:.1f} ms"
               if "plain_ms" in v else ""))
    return out


def power_sim_path(torch, ops, u_th, params, dc) -> dict:
    """``ops.power_sim`` on the calibrated card run's own ``[T, H]`` field
    with its last window's parameters, counted, against the same run's
    fused readout (same power model, no scenario axis)."""
    kw = dict(p_idle=float(params.p_idle), p_max=float(params.p_max),
              r=float(params.r), peak_tflops=dc.peak_tflops, dt_seconds=300.0)
    ops.reset_launches()
    power, energy, tflops = ops.power_sim(u_th, **kw)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["power_sim"]
    if launches != 1:
        fail(f"power_sim path: {launches} launches, expected 1")
    want = ops.des_readout(u_th, p_idle=kw["p_idle"], p_max=kw["p_max"],
                           r=kw["r"], peak_tflops=dc.peak_tflops)
    for name, got, key in (("power", power, "power_w"),
                           ("energy", energy, "energy_kwh"),
                           ("tflops", tflops, "tflops")):
        if not torch.allclose(got, want[key], rtol=1e-4, atol=1e-2):
            fail(f"power_sim path {name}: max |diff| vs the DES readout "
                 f"{float((got - want[key]).abs().max())}")
    log(f"power_sim on the E2 horizon {tuple(u_th.shape)}: fleet energy "
        f"{float(energy.sum()):.3f} kWh, within rtol 1e-4 of the DES readout, "
        f"{launches} launch")
    return {"power_sim": launches}


def lm_config(arch, num_layers=None, dtype=None):
    """The arch's config, its depth cut to ``num_layers`` (an enc-dec's
    encoder and decoder each) and its dtype replaced where given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    repl = {k: v for k, v in (("num_layers", num_layers), ("dtype", dtype)) if v}
    if num_layers and cfg.family == "encdec":
        repl.update(enc_layers=num_layers, dec_layers=num_layers)
    return dataclasses.replace(cfg, **repl) if repl else cfg


def prefill_batch(torch, cfg, b: int, s: int, gen, dev) -> dict:
    """A prefill batch of random tokens ``[b, s]`` drawn from ``gen`` on
    ``dev``; for the VLM (Qwen2-VL) ``cfg.num_patches`` random patch
    embeddings at the first rows (at most half of ``s``) on a square
    grid, with [3, B, S] M-RoPE positions (t 0 and the grid's h, w over
    the patches; the text after from the grid's side on, in all three
    streams); for the enc-dec (Seamless) ``cfg.num_frames`` random frame
    embeddings."""
    dt = getattr(torch, cfg.dtype)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev, dtype=torch.int32)}
    if cfg.mrope:
        side = math.isqrt(min(cfg.num_patches, s // 2))
        n = side * side
        grid = torch.arange(n, device=dev)
        text = side + torch.arange(s - n, device=dev)
        pos = torch.stack([torch.cat([torch.zeros_like(grid), text]),
                           torch.cat([grid // side, text]),
                           torch.cat([grid % side, text])])
        batch["positions"] = pos.to(torch.int32)[:, None].expand(3, b, s)
        batch["vision_embeds"] = torch.randn((b, n, cfg.d_model), generator=gen,
                                             device=dev).to(dt)
        batch["vision_pos"] = grid.to(torch.int32).expand(b, n)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.num_frames, cfg.d_model),
                                      generator=gen, device=dev).to(dt)
    return batch


def lm_prefill(torch, ops, arch: str, per_call: dict, num_layers=None) -> dict:
    """``make_prefill_step`` at the arch's full width and depth (or its
    first ``num_layers``), bf16, on ``[4, 2048]`` seeded tokens (with the
    VLM's patches and the enc-dec's frames, ``prefill_batch``): one call,
    then ``PREFILL_CALLS`` timed ones, all counted.  ``per_call`` is the
    launches one call must make (every other kernel: none)."""
    from repro_torch.launch.steps import make_prefill_step, param_specs_for
    from repro_torch.models.common import init_params
    from repro_torch.models.lm import count_params_analytic

    cfg = lm_config(arch, num_layers=num_layers)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(param_specs_for(cfg), gen, getattr(torch, cfg.dtype), DEVICE)
    batch = prefill_batch(torch, cfg, PREFILL_B, PREFILL_S, gen, DEVICE)
    prefill = make_prefill_step(cfg)
    want = {k: per_call.get(k, 0) for k in ops.LAUNCHES}
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if ops.LAUNCHES != want:
        fail(f"prefill {arch}: launches per call {dict(ops.LAUNCHES)}, expected {want}")
    if logits.shape != (PREFILL_B, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill {arch}: logits {tuple(logits.shape)} not finite [B, vocab]")
    t0 = time.perf_counter()
    for _ in range(PREFILL_CALLS):
        prefill(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / PREFILL_CALLS
    launches = dict(ops.LAUNCHES)
    if launches != {k: v * (PREFILL_CALLS + 1) for k, v in want.items()}:
        fail(f"prefill {arch}: launches {launches} over {PREFILL_CALLS + 1} calls")
    tok_s = PREFILL_B * PREFILL_S / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    depth = (f"{cfg.enc_layers} + {cfg.dec_layers}" if cfg.family == "encdec"
             else str(cfg.num_layers))
    log(f"LM prefill {arch} ({depth} layers x {cfg.d_model}, bf16) "
        f"B={PREFILL_B} S={PREFILL_S}: {ms:.3f} ms per call ({tok_s:.0f} tokens/s; "
        f"first call {first_s:.3f} s), launches per call {per_call}, "
        f"{launches} over {PREFILL_CALLS + 1} calls, peak {peak:.2f} GiB")
    out = dict(ms_per_call=ms, tokens_per_second=tok_s, first_call_seconds=first_s,
               launches=launches, launches_per_call=per_call, peak_gib=peak,
               params=count_params_analytic(cfg), num_layers=num_layers)
    del params
    torch.cuda.empty_cache()
    return out


def lm_serve(torch, ops, arch: str, argv=SERVE_ARGV) -> dict:
    """``launch/serve.py``'s main on the card at full size (``--reduce 1``;
    ``argv`` gives the rest)."""
    from repro_torch.launch import serve

    ops.reset_launches()
    res = serve.main(["--arch", arch, *argv])
    toks = res.tokens
    gen = int(argv[argv.index("--gen") + 1])
    if toks.shape != (4, gen) or not bool(((toks >= 0) & (toks < res.cfg.vocab)).all()):
        fail(f"serve {arch}: tokens {tuple(toks.shape)} outside [0, {res.cfg.vocab})")
    log(f"LM serve {arch} {' '.join(argv)}: prompt {argv[argv.index('--prompt-len') + 1]} steps "
        f"{res.prefill_seconds:.3f} s, decode {res.tokens_per_second:.1f} tok/s "
        f"({res.decode_seconds:.3f} s for {gen} x 4), launches {dict(ops.LAUNCHES)}")
    torch.cuda.empty_cache()
    return dict(prefill_seconds=res.prefill_seconds,
                decode_seconds=res.decode_seconds,
                decode_tokens_per_second=res.tokens_per_second,
                sample=toks[0, :16].tolist())


#: the card-vs-CPU checks: arch -> (layers, batch, sequence, bar on the f32
#: logits as rtol and atol).  Mamba2's S=256 is two chunks of 128, so the
#: inter-chunk recurrence runs; Zamba2's 7 layers are one group of 6 under
#: the shared block (attention, LoRA, FFN) plus a tail of 1.  A bar is
#: 1e-4 where the reading on an H100 is at most 1e-5 (SmolLM 2.4e-6,
#: Zamba2 7.4e-6); Mamba2's (1.1e-5) is 2e-4, about ten times its reading.
CARD_VS_CPU = {
    "smollm-360m": (2, 2, 256, 1e-4),
    "mamba2-370m": (2, 2, 256, 2e-4),
    "zamba2-1.2b": (7, 2, 256, 1e-4),
}


#: the projections into attention scores, ``[L, d_in, heads, hd]`` leaves:
#: GQA's query and key, the enc-dec's cross-attention's, MLA's query (with
#: or without its LoRA) and its latent key/value expansion
QK_LEAVES = ("wq", "wk", "x_wq", "x_wk", "wq_b", "wkv_b")


def rescale_qk(cfg, params: dict) -> dict:
    """``params`` with every query/key projection (``QK_LEAVES``) scaled in
    place from the init's fan-in (the head count, ``shape[-2]``) to the
    ``d_in`` it contracts (``lm_card_vs_cpu`` says why): SmolLM's
    ``wq``/``wk`` by ``sqrt(heads / d_model)``, Zamba2's shared block's
    alike, and so on for the families of phase 14."""
    for k, v in params.items():
        if isinstance(v, dict):
            rescale_qk(cfg, v)
        elif k in QK_LEAVES and v.dim() == 4:
            v *= (v.shape[-2] / v.shape[-3]) ** 0.5
    return params


def lm_card_vs_cpu(torch, np, arch: str) -> dict:
    """The arch at full width, cut in depth (``CARD_VS_CPU``), f32: prefill
    logits and 8 greedy serve steps (tokens equal) on the card against the
    CPU (``main`` turns TF32 off).

    ``init_params`` takes the fan-in of ``wq [L, d, H, hd]`` and ``wk``
    from the head count, as the JAX package does, so random q and k have
    std 8 and 14 and a score has std ~111: softmax is then near argmax, and
    rounding noise in a score moves the output as far as a small fault
    would.  Here, and on both sides alike, ``wq`` and ``wk`` (SmolLM's
    layers, Zamba2's shared block) are rescaled to the fan-in of the
    d_model they contract, which gives scores of std about 1, as a trained
    model's are.
    """
    from repro_torch.launch.steps import (
        make_prefill_step, make_serve_step, param_specs_for, state_specs_for)
    from repro_torch.models.common import init_params

    layers, b, s, tol = CARD_VS_CPU[arch]
    cfg = lm_config(arch, num_layers=layers, dtype="float32")
    steps = 8
    p_cpu = rescale_qk(cfg, init_params(param_specs_for(cfg),
                                        torch.Generator().manual_seed(7),
                                        torch.float32, "cpu"))
    p_gpu = _tree_to(p_cpu, DEVICE)
    tokens = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))
    prefill = make_prefill_step(cfg)
    t0 = time.time()
    want = prefill(p_cpu, {"tokens": tokens})
    got = prefill(p_gpu, {"tokens": tokens.to(DEVICE)}).cpu()
    err = float((got - want).abs().max())
    # the bar's use: the worst element's |err| / (atol + rtol |want|), <= 1
    used = float(((got - want).abs() / (tol * (1 + want.abs()))).max())
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f"card vs CPU {arch} prefill logits: max |err| {err} beyond rtol "
             f"and atol {tol} (bar used {used:.3f})")
    serve = make_serve_step(cfg)
    runs = {"cpu": "cpu", "card": DEVICE}
    states = {run: init_params(state_specs_for(cfg, b, steps), None,
                               torch.float32, dev) for run, dev in runs.items()}
    tok = {run: torch.argmax(want, dim=-1).to(torch.int32).to(dev)
           for run, dev in runs.items()}
    params = {"cpu": p_cpu, "card": p_gpu}
    stream = []
    for i in range(steps):
        for run, dev in runs.items():
            batch = {"token": tok[run][:, None],
                     "cache_len": torch.full((b,), i, dtype=torch.int32, device=dev)}
            tok[run], states[run] = serve(params[run], states[run], batch)
        if not torch.equal(tok["card"].cpu(), tok["cpu"]):
            fail(f"card vs CPU {arch} serve step {i}: greedy tokens differ")
        stream.append(tok["cpu"].tolist())
    log(f"LM card vs CPU ({arch} width, {layers} layers, f32, S={s}): prefill "
        f"logits max |err| {err:.3g} (rtol and atol {tol}; bar used {used:.3f}), "
        f"{steps} greedy serve steps equal, {time.time() - t0:.1f} s")
    del p_gpu, states
    torch.cuda.empty_cache()
    return dict(prefill_max_abs_err=err, bar=tol, bar_used=used,
                greedy_tokens=stream)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def readout_bytes(torch, u, operands) -> int:
    """Bytes the readout must move: ``u`` and each operand tensor's own
    elements (a stride-0 axis counts once) read once, the 9 ``[S, T]``
    leaves written once."""
    s, t, _ = u.shape
    n = 4 * (u.numel() + 9 * s * t)
    for v in operands.values():
        if isinstance(v, torch.Tensor):
            n += v.element_size() * math.prod(d for d, st in zip(v.shape, v.stride()) if st)
    return n


def time_power_sim(torch, timer, ops, ref, build, dev, t, h) -> dict:
    """power_sim and its plain version on ``[t, h]``."""
    from repro_torch.kernels._launch import warp_split

    u = torch.rand((t, h), device=dev)
    consts = ref.power_sim_constants(h, p_idle=POWER_KW["p_idle"],
                                     p_max=POWER_KW["p_max"],
                                     peak_tflops=POWER_KW["peak_tflops"],
                                     dt_seconds=POWER_KW["dt_seconds"])
    scalars = (POWER_KW["r"], consts["base"], consts["span"], consts["e_factor"],
               consts["peak"])
    rows = torch.empty((3, t), device=dev)
    lib = build.load("power_sim")
    split = warp_split(1, t, h)
    stream = torch.cuda.current_stream().cuda_stream

    def kernel():
        if lib.power_sim_launch(u.data_ptr(), rows.data_ptr(), t, h, split,
                                *scalars, stream) != 0:
            fail("power_sim: the timed launch returned a CUDA error")

    k = timer.device_ms(kernel)
    p = timer.device_ms(lambda: ref.power_sim_ref(
        u, POWER_KW["p_idle"], POWER_KW["p_max"], POWER_KW["r"],
        peak_tflops=POWER_KW["peak_tflops"], dt_seconds=POWER_KW["dt_seconds"]))
    out = dict(ms=k["ms"], plain_ms=p["ms"], kernel_rounds=k, plain_rounds=p,
               wrapper_wall_ms=timer.wall_ms(lambda: ops.power_sim(u, **POWER_KW)),
               split=split, bytes=4 * (t * h + 3 * t), ops=9 * t * h + 6 * t,
               sfu_ops=2 * t * h)
    return out


def time_flash(torch, timer, ref, build, dev, b, hq, hkv, s, _skv, d, dv) -> dict:
    """The prefill shape in bf16: kernel, plain version, and SDPA (the one
    PyTorch call computing the same, timed beside, never on the path)."""
    import torch.nn.functional as F

    from repro_torch.kernels.ops import flash_attention_flops

    q = torch.randn((b, hq, s, d), device=dev).to(torch.bfloat16)
    k = torch.randn((b, hkv, s, d), device=dev).to(torch.bfloat16)
    v = torch.randn((b, hkv, s, dv), device=dev).to(torch.bfloat16)
    out = q.new_empty((b, hq, s, dv))
    lse = torch.empty((b, hq, s), device=dev)
    scale = d ** -0.5
    lib = build.load("flash_attention")
    stream = torch.cuda.current_stream().cuda_stream

    def kernel(lse_ptr=None):
        if lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      out.data_ptr(), lse_ptr, b, hq, hkv, s, s, d,
                                      dv, 1, 1, scale, stream) != 0:
            fail("flash_attention: the timed launch returned a CUDA error")

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale, enable_gqa=True)

    kernel()
    lib_err = float((library().float() - out.float()).abs().max())
    kt = timer.device_ms(kernel)
    # the training route's forward: the same launch writing the rows' lse
    lt_lse = timer.device_ms(lambda: kernel(lse.data_ptr()))
    pt = timer.device_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    lt = timer.device_ms(library)
    log(f"flash_attention at {(b, hq, hkv, s, d, dv)}: {kt['ms'] * 1e3:.2f} us, with "
        f"the lse output {lt_lse['ms'] * 1e3:.2f} us; SDPA {lt['ms'] * 1e3:.2f} us, "
        f"max |diff| {lib_err:.3g}")
    return dict(ms=kt["ms"], plain_ms=pt["ms"], library_ms=lt["ms"],
                lse_ms=lt_lse["ms"], lse_rounds=lt_lse,
                kernel_rounds=kt, plain_rounds=pt, library_rounds=lt,
                sdpa_max_abs_diff=lib_err,
                bytes=2 * (b * hq * s * (d + dv) + b * hkv * s * (d + dv)),
                ops=flash_attention_flops(b, hq, s, s, d, dv, True),
                peak_ops=PEAK_BF16_TC_FLOPS)


def flash_rows_check(torch, np, timer, ops, ref, dev, b, hq, hkv, s, _skv, d, dv) -> dict:
    """The prefill shape in bf16, its flash call split into
    ``FLASH_ROWS_TP`` blocks of query rows as the port runs it
    (``models.attention.flash_rows``): each shard's output and lse
    against the unsplit kernel call's rows and against the plain version
    on the card (module docstring), then each shard timed."""
    from repro_torch.kernels.ops import flash_attention_flops
    from repro_torch.models.attention import _prefix, flash_rows

    tp, (rtol, atol) = FLASH_ROWS_TP, FLASH_ROWS_BAR
    rng = np.random.default_rng(b + hq + d + dv)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, (b, h, s, w)).astype(np.float32),
                               device=dev).to(torch.bfloat16)
               for h, w in ((hq, d), (hkv, d), (hkv, dv)))
    scale = d ** -0.5
    full, full_lse = ops.flash_attention(q, k, v, causal=True, scale=scale, return_lse=True)
    m = s // tp
    tag = f"flash rows {(b, hq, hkv, s, d, dv)} bf16, {tp} shards"
    before = ops.LAUNCHES["flash_attention"]
    out = {"shards": []}
    for r in range(tp):
        rows, n = slice(r * m, (r + 1) * m), _prefix(m, s, r, tp, True)
        qr, kr, vr = q[:, :, rows], k[:, :, :n], v[:, :, :n]
        got, lse = flash_rows(qr, k, v, r, tp, causal=True, scale=scale, return_lse=True)
        torch.cuda.synchronize()
        # against the unsplit call's rows, at the bf16 bar of FLASH_CASES
        err = (got.float() - full[:, :, rows].float()).abs()
        bar = rtol * full[:, :, rows].float().abs() + atol * softmax_row_norm(torch, qr, kr, True)
        used_unsplit = float((err / bar).max())
        lse_unsplit = float((lse - full_lse[:, :, rows]).abs().max())
        bitwise = torch.equal(got, full[:, :, rows]) and torch.equal(lse, full_lse[:, :, rows])
        # against the plain version on the card, on the shard's rows and prefix
        err_plain, used_plain = flash_bar_use(torch, ref, got, qr, kr, vr, True, rtol, atol)
        _, want_lse = ref.flash_attention_ref(qr.float(), kr.float(), vr.float(), causal=True,
                                              scale=scale, return_lse=True)
        if (got.shape != (b, hq, m, dv) or not used_unsplit <= 1.0 or not used_plain <= 1.0
                or not torch.allclose(lse, full_lse[:, :, rows], rtol=LSE_RTOL, atol=LSE_ATOL)
                or not torch.allclose(lse, want_lse, rtol=LSE_RTOL, atol=LSE_ATOL)):
            fail(f"{tag}: shard {r} (keys [0, {n})): bar used {used_unsplit:.3f} against the "
                 f"unsplit call, {used_plain:.3f} against the plain version; lse max |err| "
                 f"{lse_unsplit:.3g} (rtol {LSE_RTOL}, atol {LSE_ATOL})")
        kt = timer.device_ms(lambda: flash_rows(qr, k, v, r, tp, causal=True, scale=scale))
        out["shards"].append(dict(
            r=r, keys=n, bar_used_unsplit=used_unsplit, bar_used_plain=used_plain,
            max_abs_err_plain=err_plain, lse_max_abs_err_unsplit=lse_unsplit,
            bitwise_equal_unsplit=bitwise, ms=kt["ms"], rounds=kt,
            flops=flash_attention_flops(b, hq, m, n, d, dv, True)))
    out["checked_launches"] = tp
    out["launches"] = ops.LAUNCHES["flash_attention"] - before
    log(f"{tag}: every shard within the bf16 bar against the unsplit call's rows (used "
        f"{max(x['bar_used_unsplit'] for x in out['shards']):.3f}; bitwise "
        f"{[x['bitwise_equal_unsplit'] for x in out['shards']]}) and against the plain "
        f"version (used {max(x['bar_used_plain'] for x in out['shards']):.3f}), lse within "
        f"rtol {LSE_RTOL} atol {LSE_ATOL}; ms a shard "
        f"{[round(x['ms'], 5) for x in out['shards']]} (keys "
        f"{[x['keys'] for x in out['shards']]}); {out['launches']} launches ({tp} checked, "
        f"the rest timed)")
    return out


def op_overhead(torch, timer, ops, dev) -> dict:
    """Host us a call of ``ops.flash_attention`` (the ``torch.library``
    operator: dispatch, then the launch) against ``flash_attention_cuda``
    called directly, at a shape whose kernel takes next to no device time,
    wall time up to a synchronize, 200 calls; the difference is the op's
    dispatch cost, paid once an attention layer a prefill."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = (torch.randn((1, 1, 16, 64), device=dev).to(torch.bfloat16) for _ in range(3))
    direct = timer.wall_ms(lambda: flash_attention_cuda(q, k, v, causal=True, scale=0.125),
                           reps=200) * 1e3
    via_op = timer.wall_ms(lambda: ops.flash_attention(q, k, v, scale=0.125), reps=200) * 1e3
    log(f"flash_attention host cost a call: through the operator {via_op:.2f} us, the "
        f"launch called directly {direct:.2f} us, dispatch {via_op - direct:.2f} us")
    return dict(op_us=via_op, direct_us=direct, dispatch_us=via_op - direct)


def ssd_inputs(torch, np, bc, q, h, p, g, n, seed, device, long_memory=False):
    """ssd_chunk operands as the JAX sweep draws them: x, B, C ~ N(0, 1),
    dt ~ U(0.1, 0.9), A_log ~ N(0, 0.3), D ~ N(0, 1), float32.  With
    ``long_memory``, dt ~ U(0.001, 0.02) and A_log ~ N(-1, 0.3): a row then
    decays by about exp(-0.004), so exp(csum) stays O(1) across a chunk."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
    dt_lo, dt_hi, a_mean = (0.001, 0.02, -1.0) if long_memory else (0.1, 0.9, 0.0)
    return (f(rng.normal(0, 1, (bc, q, h, p))), f(rng.uniform(dt_lo, dt_hi, (bc, q, h))),
            f(rng.normal(a_mean, 0.3, (h,))), f(rng.normal(0, 1, (bc, q, g, n))),
            f(rng.normal(0, 1, (bc, q, g, n))), f(rng.normal(0, 1, (h,))))


def check_ssd(torch, np, ops, ref, dev) -> float:
    """ssd_chunk against its plain version on the card at ``SSD_CASES``
    (rtol and atol ``SSD_TOL``, y and states), twice each for bitwise-equal
    results.  Returns the largest absolute error."""
    worst = 0.0
    for i, (shape, long_memory) in enumerate(SSD_CASES):
        args = ssd_inputs(torch, np, *shape, seed=200 + i, device=dev,
                          long_memory=long_memory)
        got = ops.ssd_chunk(*args)
        again = ops.ssd_chunk(*args)
        torch.cuda.synchronize()
        want = ref.ssd_chunk_ref(*args)
        tag = f"{shape}{' long memory' if long_memory else ''}"
        errs = []
        for name, g, a, w in zip(("y", "states"), got, again, want):
            err = float((g - w).abs().max())
            if g.dtype != torch.float32 or not torch.allclose(g, w, rtol=SSD_TOL,
                                                              atol=SSD_TOL):
                fail(f"ssd_chunk {tag} {name}: max |err| {err} beyond rtol and "
                     f"atol {SSD_TOL}")
            if not torch.equal(g, a):
                fail(f"ssd_chunk {tag} {name}: two runs differ bitwise")
            errs.append(err)
        worst = max(worst, *errs)
        log(f"ssd_chunk BC={shape[0]} Q={shape[1]} H={shape[2]} P={shape[3]} "
            f"G={shape[4]} N={shape[5]}{' long memory' if long_memory else ''}: "
            f"max |err| y {errs[0]:.3g} (|y| max "
            f"{float(want[0].abs().max()):.3g}), states {errs[1]:.3g} (rtol and "
            f"atol {SSD_TOL}), bitwise repeatable")
    return worst


def time_ssd(torch, timer, ref, build, dev, bc, q, h, p, g, n) -> dict:
    """ssd_chunk and its plain version at a prefill shape (no single
    PyTorch call computes the same: no library time).  ``ops`` counts the
    least work: ``C B^T`` once per (chunk, group) over the causal triangle,
    ``att @ x`` over it per head, the states, and the elementwise terms.
    The bound takes them at the kernel's route, f32 products as 3xTF32 on
    the tensor cores; ``bound_f32_ms`` at the f32 rate of the CUDA cores."""
    import numpy as np

    from repro_torch.kernels.ops import ssd_chunk_flops

    x, dt, a, b, c, d = ssd_inputs(torch, np, bc, q, h, p, g, n, seed=1, device=dev)
    y = torch.empty((bc, q, h, p), device=dev)
    st = torch.empty((bc, h, p, n), device=dev)
    lib = build.load("ssd_chunk")
    stream = torch.cuda.current_stream().cuda_stream

    def kernel():
        if lib.ssd_chunk_launch(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                                b.data_ptr(), c.data_ptr(), d.data_ptr(),
                                y.data_ptr(), st.data_ptr(), bc, q, h, p, g, n,
                                stream) != 0:
            fail("ssd_chunk: the timed launch returned a CUDA error")

    tri = q * (q + 1) // 2
    k = timer.device_ms(kernel)
    pt = timer.device_ms(lambda: ref.ssd_chunk_ref(x, dt, a, b, c, d))
    n_bytes = 4 * (2 * bc * q * h * p + bc * q * h + 2 * bc * q * g * n
                   + bc * h * p * n + 2 * h)
    n_ops = (ssd_chunk_flops(bc, q, h, p, g, n)
             + 4 * bc * h * tri + 2 * bc * q * h * p + 4 * bc * q * h)
    return dict(ms=k["ms"], plain_ms=pt["ms"], kernel_rounds=k, plain_rounds=pt,
                bytes=n_bytes, ops=n_ops, peak_ops=PEAK_3XTF32_FLOPS,
                bound_f32_ms=bound(n_bytes, n_ops)["bound_ms"])


def bound_terms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_FLOPS,
                n_sfu: float = 0, sfu_per_s: float | None = None) -> dict:
    """ms of each floor: bytes over HBM rate, ops over their peak (f32 on
    the FMA pipes unless ``peak_ops`` says otherwise), and ``n_sfu``
    special-function results (expf, logf) over ``sfu_per_s``."""
    return {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
            "fma": n_ops / peak_ops * 1e3,
            "sfu": n_sfu / sfu_per_s * 1e3 if n_sfu else 0.0}


def bound(*args, **kwargs) -> dict:
    """Least time for the work: the largest of ``bound_terms``, bound by
    bytes or by operations (either pipe)."""
    terms = bound_terms(*args, **kwargs)
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term],
                bound_by="bytes" if term == "bytes" else "operations")


def sm_max_clock_hz() -> float:
    """The SMs' maximum clock, as ``nvidia-smi`` reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# -- phase 13: training -----------------------------------------------------------

#: (a) the attention Function's gradient checks, (b, hq, hkv, sq, skv, d,
#: dv, causal, the backward's KV chunk): SmolLM-360M's train shape ([8,
#: 256] tokens, the model's chunk ``lm.KV_CHUNK``) and a ragged Skv > Sq
#: shape (KV chunks of 40, the last one short)
TRAIN_FLASH_CASES = [(8, 15, 5, 256, 256, 64, 64, True, 1024),
                     (2, 4, 2, 100, 130, 64, 64, True, 40)]
#: (a)'s bars against the f32 CPU run: f32 ``atol + rtol |want|``; bf16
#: ``2^-6`` of the tensor's largest value (the output and the gradients
#: are rounded to bf16, and the backward's delta reads the bf16 output)
TRAIN_F32_TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_BF16_FRAC = 2 ** -6
#: (a) the SSD Function at Mamba2-370M's chunk shape for [8, 256] tokens in
#: chunks of 128, (BC, Q, H, P, G, N), with a long memory (every row counts)
TRAIN_SSD = (8 * 256 // 128, 128, 32, 64, 1, 128)
#: (b) full-width training: batch, sequence, steps
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 256, 6
#: (b)'s step 0 held at full depth against the CPU in f32 (remat off), on
#: the first ``TRAIN_REF_B`` rows of its batch: the loss's relative error,
#: the whole gradient's relative L2 error and each gradient leaf's, for the
#: card in f32 and the card in bf16 (the route (b) times).  bf16 rounds
#: every activation, and a leaf whose gradient is a sum of many terms that
#: cancel (Mamba2's decay, conv and bias leaves) drifts with depth and
#: width: its bars only catch a gradient lost or turned (relative error
#: >= 1) and an overflow (inf, NaN); the f32 route's bars catch the rest.
TRAIN_REF_B = 1
TRAIN_REF_BARS = {"float32": dict(loss=1e-5, grad=1e-4, leaf=1e-3),
                  "bfloat16": dict(loss=2e-2, grad=0.75, leaf=0.75)}
#: (c) ``launch/train.main``: the crash, the checkpoints and the run's size.
#: ``--reduce 4``, not 1: a full-size SmolLM-360M job state (bf16 params,
#: f32 moments) is 3.6 GB a checkpoint, which the file format's zlib (level
#: 6; zstd where ``zstandard`` is installed) compresses at tens of MB/s on
#: one host core, minutes a save (the rate is measured and logged here)
TRAIN_MAIN_ARGV = ["--reduce", "4", "--steps", "8", "--ckpt-every", "2",
                   "--log-every", "1", "--device", DEVICE]
TRAIN_MAIN_FAIL = 5
#: (d) card against CPU in f32: arch -> (layers, batch, sequence); 3 steps
TRAIN_CARD_VS_CPU = {"smollm-360m": (2, 2, 256), "mamba2-370m": (2, 2, 256)}
TRAIN_CVC_STEPS = 3
#: (d)'s bars: losses, grad norms (rtol); parameters within 2 lr a step of
#: each other, and at most 1e-3 of them beyond 1e-5 (Adam's update is ~lr
#: sign(g): an element whose gradient is at rounding level can move either way)
TRAIN_CVC_LOSS_RTOL, TRAIN_CVC_GNORM_RTOL = 1e-5, 1e-4
#: (e) the live-twin example at its own defaults
LIVE_TWIN_ARGV = ["--device", DEVICE]


def _close_use(torch, got, want, dtype) -> tuple[float, float]:
    """``(max |err|, bar used)`` of a card tensor against its f32 CPU run at
    phase 13's bar for ``dtype`` (used <= 1 passes)."""
    got = got.float().cpu()
    err = (got - want).abs()
    if dtype == torch.float32:
        bar = TRAIN_F32_TOL["atol"] + TRAIN_F32_TOL["rtol"] * want.abs()
    else:
        bar = TRAIN_BF16_FRAC * float(want.abs().max())
    return float(err.max()), float((err / bar).max())


def train_flash(torch, np, ops, ref, cases, seed: int) -> dict:
    """The flash-attention autograd Function's output, lse and gradients on
    the card at ``cases`` (``TRAIN_FLASH_CASES``' layout; inputs drawn from
    ``seed + i``), bf16 and f32, against the same Function on f32 CPU
    copies and against the plain version's autograd on the card, at
    ``_close_use``'s bars; one kernel launch a call (not counted in the
    kernels line: a check).  The CPU runs take one intra-op thread: a
    process's first multithreaded ``torch.log`` on the CPU now and then
    returns values off by up to ~3e-5 (ROADMAP C), which moved the lse
    and so ``dk`` by 3x this bar when (d) ran first in a process."""
    from repro_torch.models.attention import FlashAttention

    out = {}
    for i, (b, hq, hkv, sq, skv, d, dv, causal, chunk) in enumerate(cases):
        rng = np.random.default_rng(seed + i)
        base = [torch.as_tensor(rng.normal(0, 1, s).astype(np.float32))
                for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, dv), (b, hq, sq, dv))]
        fn = lambda q, k, v: FlashAttention.apply(q, k, v, causal, d ** -0.5, chunk)  # noqa: E731
        for dt in (torch.float32, torch.bfloat16):
            card = [x.to(DEVICE, dt) for x in base]
            cpu = [x.float().cpu() for x in card]          # the card's inputs, in f32
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                want = _grads_run(torch, fn, cpu[:3], (cpu[3],))
                want_lse = ops.flash_attention(*cpu[:3], causal=causal, return_lse=True)[1]
            finally:
                torch.set_num_threads(threads)
            ops.reset_launches()
            got = _grads_run(torch, fn, card[:3], (card[3],))
            torch.cuda.synchronize()
            if ops.LAUNCHES["flash_attention"] != 1:
                fail(f"train flash {i}: {dict(ops.LAUNCHES)} launches, expected 1 flash")
            plain = _grads_run(torch, lambda q, k, v: ref.flash_attention_ref(
                q, k, v, causal=causal), [x.float() for x in card[:3]], (card[3].float(),))
            lse = ops.flash_attention(*card[:3], causal=causal, return_lse=True)[1]
            tag = f"{(b, hq, hkv, sq, skv, d, dv, causal)} {str(dt)[6:]}"
            rec = {}
            for name, g, w, p in zip(("out", "dq", "dk", "dv"), got, want, plain):
                err, used = _close_use(torch, g, w, dt)
                p_err, p_used = _close_use(torch, g, p.cpu(), dt)
                if (g.dtype != dt or g.shape != w.shape or not used <= 1.0
                        or not p_used <= 1.0):
                    fail(f"train flash {tag} {name}: vs CPU max |err| {err} (bar used "
                         f"{used}), vs plain autograd {p_err} (bar used {p_used})")
                rec[name] = dict(max_abs_err=err, bar_used=used, plain_max_abs_err=p_err,
                                 plain_bar_used=p_used)
            lse_err = float((lse.cpu() - want_lse).abs().max())
            if not torch.allclose(lse.cpu(), want_lse, rtol=LSE_RTOL, atol=LSE_ATOL):
                fail(f"train flash {tag} lse: max |err| {lse_err} against the CPU run")
            rec["lse_max_abs_err"] = lse_err
            out[f"flash {tag}"] = rec
            log(f"train flash {tag}: " + ", ".join(
                f"{k} {v['max_abs_err']:.3g} (bar used {v['bar_used']:.3f}; plain "
                f"autograd {v['plain_max_abs_err']:.3g})" for k, v in rec.items()
                if isinstance(v, dict)) + f", lse {lse_err:.3g}")
    return out


def _grads_run(torch, fn, inputs, cts) -> list:
    """``fn``'s outputs, then its inputs' gradients for cotangents ``cts``."""
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cts)
    return [o.detach() for o in outs] + [x.grad for x in xs]


def train_functions(torch, np, ops, ref) -> dict:
    """(a) the two autograd Functions' gradients on the card against the same
    Function on f32 CPU copies and against the plain version's autograd on
    the card; the lse against the CPU run's."""
    from repro_torch.models.mamba2 import SSDChunk

    out = train_flash(torch, np, ops, ref, TRAIN_FLASH_CASES, seed=300)
    bc, q, h, p, g, n = TRAIN_SSD
    args = [x.cpu() for x in ssd_inputs(torch, np, bc, q, h, p, g, n, seed=310,
                                        device=DEVICE, long_memory=True)]
    rng = np.random.default_rng(311)
    cts = [torch.as_tensor(rng.normal(0, 1, s).astype(np.float32))
           for s in ((bc, q, h, p), (bc, h, p, n))]
    want = _grads_run(torch, SSDChunk.apply, args, cts)
    ops.reset_launches()
    card_args, card_cts = [x.to(DEVICE) for x in args], [c.to(DEVICE) for c in cts]
    got = _grads_run(torch, SSDChunk.apply, card_args, card_cts)
    torch.cuda.synchronize()
    if ops.LAUNCHES["ssd_chunk"] != 1:
        fail(f"train ssd: {dict(ops.LAUNCHES)} launches, expected 1 ssd_chunk")
    plain = _grads_run(torch, ref.ssd_chunk_ref, card_args, card_cts)
    rec = {}
    names = ("y", "states", "dx", "ddt", "dA_log", "dB", "dC", "dD")
    for name, gv, w, pv in zip(names, got, want, plain):
        scale = float(w.abs().max())
        err = float((gv.cpu() - w).abs().max())
        p_err = float((gv - pv).abs().max())
        if not (err <= SSD_TOL * scale and p_err <= SSD_TOL * scale):
            fail(f"train ssd {name}: vs CPU max |err| {err}, vs plain autograd {p_err}, "
                 f"beyond {SSD_TOL} of max |want| {scale}")
        rec[name] = dict(max_abs_err=err, plain_max_abs_err=p_err, max_abs=scale)
    out[f"ssd {TRAIN_SSD}"] = rec
    log(f"train ssd BC={bc} Q={q} H={h} P={p} G={g} N={n} long memory: " + ", ".join(
        f"{k} {v['max_abs_err']:.3g} of {v['max_abs']:.3g}" for k, v in rec.items())
        + f" (bar {SSD_TOL} of each max; plain autograd on the card alike)")
    return out


def train_depth_reference(torch, cfg, params, batch, card: str) -> dict:
    """(b)'s step 0 at full depth against the CPU: the loss and every
    parameter's gradient at (b)'s initial params on the first
    ``TRAIN_REF_B`` rows of its first batch, on the card in f32 and in the
    params' own dtype (the route (b) runs), each against the CPU in f32
    with remat off (the kernels' plain versions in the forward), at
    ``TRAIN_REF_BARS``.  Its launches are not counted: a check, not the
    path."""
    from repro_torch._tree import flatten
    from repro_torch.launch.steps import param_specs_for
    from repro_torch.models import lm
    from repro_torch.models.common import spec_leaves

    flat, unflatten = flatten(params)
    names = [k for k, _ in spec_leaves(param_specs_for(cfg))]
    rows = {k: v[:TRAIN_REF_B] for k, v in batch.items()}

    def loss_and_grads(c, dev, f32: bool):
        xs = [x.detach().to(dev, torch.float32 if f32 else x.dtype).requires_grad_(True)
              for x in flat]
        loss = lm.loss_fn(c, unflatten(xs), {k: v.to(dev) for k, v in rows.items()})[0]
        grads = torch.autograd.grad(loss, xs)
        return float(loss.detach()), [g.float().cpu() for g in grads]

    t0 = time.time()
    want_loss, want = loss_and_grads(
        dataclasses.replace(cfg, dtype="float32", remat="none"), "cpu", True)
    cpu_s = time.time() - t0
    want_norm = math.sqrt(sum(float(w.square().sum()) for w in want))
    out = dict(rows=TRAIN_REF_B, cpu_loss=want_loss, cpu_grad_norm=want_norm,
               cpu_seconds=cpu_s)
    for dtype, c, f32 in (("float32", dataclasses.replace(cfg, dtype="float32"), True),
                          (cfg.dtype, cfg, False)):
        loss, got = loss_and_grads(c, DEVICE, f32)
        norm = math.sqrt(sum(float(g.square().sum()) for g in got))
        diff = [float((g - w).norm()) for g, w in zip(got, want)]
        leaf = sorted(((d / max(float(w.norm()), 1e-30), n)
                       for d, w, n in zip(diff, want, names, strict=True)), reverse=True)
        rec = dict(loss=loss, loss_rel=abs(loss - want_loss) / abs(want_loss),
                   grad_norm=norm, grad_norm_rel=abs(norm - want_norm) / want_norm,
                   grad_rel=math.sqrt(sum(d * d for d in diff)) / want_norm,
                   grad_leaf_rel_max=leaf[0][0], worst_leaves=leaf[:3])
        bar = TRAIN_REF_BARS[dtype]
        if not (rec["loss_rel"] <= bar["loss"] and rec["grad_rel"] <= bar["grad"]
                and rec["grad_leaf_rel_max"] <= bar["leaf"]):
            fail(f"train {cfg.name} step 0 at full depth, card {dtype} vs CPU f32: {rec} "
                 f"(bars {bar})")
        out[dtype] = rec
        log(f"train {cfg.name} step 0 at full depth ({cfg.num_layers} layers, "
            f"[{TRAIN_REF_B}, {rows['tokens'].shape[1]}]), card {dtype} vs CPU f32 (remat "
            f"off): loss {loss:.6f} vs {want_loss:.6f} (rel {rec['loss_rel']:.3g}, bar "
            f"{bar['loss']}), grad norm {norm:.6g} vs {want_norm:.6g} (rel "
            f"{rec['grad_norm_rel']:.3g}), gradient's relative L2 error {rec['grad_rel']:.3g} "
            f"(bar {bar['grad']}), worst leaves " + ", ".join(
                f"{n} {r:.3g}" for r, n in leaf[:3]) + f" (bar {bar['leaf']}); CPU "
            f"{cpu_s:.1f} s ({card})")
    return out


def train_full_width(torch, np, ops, arch: str, card: str) -> dict:
    """(b) ``make_train_step`` on the arch at full width and depth, bf16,
    ``TRAIN_STEPS`` steps on ``[TRAIN_B, TRAIN_S]`` tokens, ``wq``/``wk``
    rescaled (``rescale_qk``: at the random init's scale the dense
    family's gradient norm grows ~30x every two layers, and clipping
    leaves ``lr sign(g)``): per step the loss, grad norm and lr (finite),
    ms, tokens/s, peak memory and the kernel launches, and the loss falls
    over the steps.  Step 0 is taken twice from one state (bitwise
    repeatable?) and held at full depth against the CPU
    (``train_depth_reference``).  The forward alone, the forward and
    backward, and the AdamW update are timed apart after the steps (their
    kernels are not counted: checks, not the path)."""
    from repro_torch._tree import flatten, leaves
    from repro_torch.data.tokens import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step, param_specs_for
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_opt_state

    cfg = lm_config(arch)
    kernel = "ssd_chunk" if cfg.family == "ssm" else "flash_attention"
    # a forward and its recompute under remat: two launches a layer a step
    per_step = cfg.num_layers * (1 if cfg.remat == "none" else 2)
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = rescale_qk(cfg, init_params(param_specs_for(cfg), gen,
                                         getattr(torch, cfg.dtype), DEVICE))
    opt = init_opt_state(params, opt_cfg)
    pipe = TokenPipeline(DataConfig(cfg.vocab, TRAIN_S, TRAIN_B, seed=1), device=DEVICE)
    reference = train_depth_reference(torch, cfg, params, pipe.global_batch(0), card)
    step = make_train_step(cfg, opt_cfg)
    rows = []
    for i in range(TRAIN_STEPS):
        batch = pipe.global_batch(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        if i == 0:
            again = step(params, opt, batch)
        params, opt, m = step(params, opt, batch)
        vals = {k: float(m[k]) for k in ("loss", "grad_norm", "lr")}
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.LAUNCHES)
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"train {arch} step {i}: metrics {vals}")
        want = {k: (per_step * (2 if i == 0 else 1) if k == kernel else 0) for k in launches}
        if launches != want:
            fail(f"train {arch} step {i}: launches {launches}, expected {want}")
        if i == 0:
            repeat = all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(again[0])))
            ms /= 2
            del again
        rows.append(dict(step=i, ms=ms, tokens_per_second=TRAIN_B * TRAIN_S / ms * 1e3,
                         peak_bytes=torch.cuda.max_memory_allocated(), launches=launches,
                         **vals))
        log(f"train {arch} step {i}: loss {vals['loss']:.4f} grad_norm "
            f"{vals['grad_norm']:.4g} lr {vals['lr']:.3g}, {ms:.1f} ms "
            f"({rows[-1]['tokens_per_second']:.0f} tokens/s), peak "
            f"{rows[-1]['peak_bytes'] / 2**30:.2f} GiB allocated, launches {launches}")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        fail(f"train {arch}: the loss did not fall in {TRAIN_STEPS} steps: "
             f"{[r['loss'] for r in rows]}")
    peak = max(r["peak_bytes"] for r in rows)
    batch = pipe.global_batch(0)
    flat, unflatten = flatten(params)

    def forward():
        with torch.no_grad():
            return float(lm.loss_fn(cfg, params, batch)[0])

    def gradients(c=cfg):
        xs = [x.detach().requires_grad_(True) for x in flat]
        grads = torch.autograd.grad(lm.loss_fn(c, unflatten(xs), batch)[0], xs)
        torch.cuda.synchronize()
        return unflatten(list(grads))

    grads = gradients()

    def update():
        apply_updates(params, grads, opt, opt_cfg)
        torch.cuda.synchronize()

    # the backward also under remat "full" (the whole region recomputed),
    # beside the config's "dots", in the same process: ms and peak
    full = dataclasses.replace(cfg, remat="full")
    split, peaks = {}, {}
    for name, fn in (("forward", forward), ("forward_backward", gradients),
                     ("forward_backward_full", lambda: gradients(full)),
                     ("optimizer", update)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        split[name] = (time.perf_counter() - t0) * 1e3 / 3
        peaks[name] = torch.cuda.max_memory_allocated()
    del grads
    warm = statistics.median(r["ms"] for r in rows[1:])
    log(f"train {arch} ({cfg.num_layers} layers x {cfg.d_model}, {cfg.dtype}, remat "
        f"{cfg.remat!r}) [{TRAIN_B}, {TRAIN_S}]: median {warm:.1f} ms a step "
        f"({TRAIN_B * TRAIN_S / warm * 1e3:.0f} tokens/s); apart: forward {split['forward']:.1f} "
        f"ms, forward + backward (recompute included) {split['forward_backward']:.1f} ms, "
        f"AdamW {split['optimizer']:.1f} ms; peak {peak / 2**30:.2f} GiB allocated, "
        f"{per_step} {kernel} launches a step, step 0 twice from one state bitwise "
        f"equal: {repeat}; forward + backward under remat 'full' "
        f"{split['forward_backward_full']:.1f} ms, peak "
        f"{peaks['forward_backward_full'] / 2**30:.2f} GiB against "
        f"{peaks['forward_backward'] / 2**30:.2f} ({card})")
    del params, opt
    torch.cuda.empty_cache()
    return dict(steps=rows, median_ms=warm, split_ms=split, split_peak_bytes=peaks,
                peak_bytes=peak,
                launches_per_step=per_step, kernel=kernel, bitwise_repeatable=repeat,
                depth_reference=reference,
                launches={kernel: sum(r["launches"][kernel] for r in rows)})


def codec_rate(torch, np) -> dict:
    """zlib/zstd throughput of the checkpoint codec on 8 MB of random bf16
    weights: what one save of a full-size SmolLM-360M job state (bf16
    params, f32 moments) would take on this host."""
    from repro_torch.core import codec
    from repro_torch.launch.steps import param_specs_for
    from repro_torch.models.common import spec_param_count

    n = spec_param_count(param_specs_for(lm_config("smollm-360m")))
    state_bytes = n * (2 + 4 + 4)
    sample = torch.randn(4 * 2**20).to(torch.bfloat16).view(torch.int16).numpy().tobytes()
    t0 = time.perf_counter()
    codec.compress(sample, level=3)
    s = time.perf_counter() - t0
    rate = len(sample) / s
    return dict(codec=codec.default_codec().hex(), params=n, state_bytes=state_bytes,
                bytes_per_second=rate, seconds_per_save=state_bytes / rate)


def train_main_phase(torch, np, ops, card: str) -> dict:
    """(c) ``launch/train.main`` with a crash at step ``TRAIN_MAIN_FAIL``
    (``train_main_restart``), the checkpoint codec's rate logged first."""
    rate = codec_rate(torch, np)
    log(f"checkpoint codec {rate['codec']}: {rate['bytes_per_second'] / 1e6:.1f} MB/s on "
        f"8 MB of bf16 weights; a full-size SmolLM-360M job state ({rate['params']} "
        f"params, {rate['state_bytes'] / 1e9:.2f} GB) would take "
        f"{rate['seconds_per_save']:.0f} s a save ({card})")
    return dict(train_main_restart(torch, ops, TRAIN_MAIN_ARGV, TRAIN_MAIN_FAIL, card),
                codec=rate)


def train_main_restart(torch, ops, argv: list, fail_at: int, card: str) -> dict:
    """``launch/train.main`` with ``argv`` and a crash at step ``fail_at``:
    one restart from the latest checkpoint before it (step ``fail_at``
    rounded down to ``--ckpt-every``), every step done.  An uninterrupted
    run with the same checkpoints is the reference: the two runs' losses
    are equal bit for bit, before the crash and after the restart, and so
    are their final params and moments and their checkpoint files (the
    last three kept; the file format is deterministic).  The failed run's
    launches are counted."""
    import tempfile

    from repro_torch._tree import leaves
    from repro_torch.launch import train

    steps = int(argv[argv.index("--steps") + 1])
    every = int(argv[argv.index("--ckpt-every") + 1])
    restored = fail_at // every * every
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        ops.reset_launches()
        t0 = time.time()
        res = train.main(argv + ["--fail-at", str(fail_at), "--ckpt-dir", f"{tmp}/fail"])
        wall = time.time() - t0
        launches = dict(ops.LAUNCHES)
        clean = train.main(argv + ["--ckpt-dir", f"{tmp}/clean"])
        files = {run: {f.name: f.read_bytes() for f in pathlib.Path(tmp, run).glob("ckpt_*")}
                 for run in ("fail", "clean")}
    rep = res.report
    what = f"train.main {' '.join(argv)} --fail-at {fail_at}"
    if not (rep.restarts == 1 and rep.restored_from == [restored] and rep.steps_done == steps):
        fail(f"{what}: {rep.restarts} restarts from {rep.restored_from}, "
             f"{rep.steps_done} steps")
    # the failed run's losses: steps 0..fail_at - 1, then restored.. again
    before, after = rep.losses[:fail_at], rep.losses[fail_at:]
    want = clean.report.losses
    if (clean.report.restarts != 0 or before != want[:fail_at] or after != want[restored:]
            or not all(math.isfinite(x) for x in want)):
        fail(f"{what}: losses {before} + {after} against the uninterrupted run's {want}")
    states_equal = all(torch.equal(a, b) for a, b in zip(leaves(res.state),
                                                         leaves(clean.state)))
    if not states_equal or len(leaves(res.state)) != len(leaves(clean.state)):
        fail(f"{what}: the final params/moments differ from the uninterrupted run's")
    if len(files["fail"]) != min(3, steps // every) or files["fail"] != files["clean"]:
        fail(f"{what}: checkpoint files {sorted(files['fail'])} differ from the "
             f"uninterrupted run's {sorted(files['clean'])}")
    log(f"{what}: {rep.steps_done} steps, {rep.restarts} restart from {rep.restored_from}, "
        f"{rep.checkpoints} checkpoints; against an uninterrupted run: losses before the "
        f"crash and after the restart bitwise equal, final params and moments bitwise "
        f"equal ({len(leaves(res.state))} leaves), checkpoint files {sorted(files['fail'])} "
        f"byte for byte equal; {wall:.1f} s, launches {launches} ({card})")
    return dict(restarts=rep.restarts, restored_from=rep.restored_from,
                steps_done=rep.steps_done, checkpoints=rep.checkpoints,
                losses=rep.losses, clean_losses=want, losses_bitwise=True,
                states_bitwise=True, checkpoint_files=sorted(files["fail"]),
                seconds=wall, launches=launches)


def train_card_vs_cpu(torch, np, arch: str, card: str) -> dict:
    """(d) the arch at full width, cut in depth, f32 (TF32 off on both sides):
    ``TRAIN_CVC_STEPS`` train steps from the same weights on the same
    batches on the card and on the CPU; wq/wk rescaled as in
    ``lm_card_vs_cpu``."""
    from repro_torch._tree import leaves
    from repro_torch.data.tokens import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step, param_specs_for
    from repro_torch.models.common import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    layers, b, s = TRAIN_CARD_VS_CPU[arch]
    cfg = lm_config(arch, num_layers=layers, dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_CVC_STEPS)
    p_cpu = rescale_qk(cfg, init_params(param_specs_for(cfg),
                                        torch.Generator().manual_seed(7),
                                        torch.float32, "cpu"))
    state = {"cpu": (p_cpu, init_opt_state(p_cpu, opt_cfg))}
    p_gpu = _tree_to(p_cpu, DEVICE)
    state["card"] = (p_gpu, init_opt_state(p_gpu, opt_cfg))
    pipe = TokenPipeline(DataConfig(cfg.vocab, s, b, seed=9), device="cpu")
    step = make_train_step(cfg, opt_cfg)
    t0 = time.time()
    rows = []
    for i in range(TRAIN_CVC_STEPS):
        batch = pipe.global_batch(i)
        m = {}
        for run, dev in (("cpu", "cpu"), ("card", DEVICE)):
            p, o, mm = step(*state[run], {k: v.to(dev) for k, v in batch.items()})
            state[run] = (p, o)
            m[run] = {k: float(mm[k]) for k in ("loss", "grad_norm")}
        rows.append(m)
        for k, tol in (("loss", TRAIN_CVC_LOSS_RTOL), ("grad_norm", TRAIN_CVC_GNORM_RTOL)):
            if not abs(m["card"][k] - m["cpu"][k]) <= tol * abs(m["cpu"][k]):
                fail(f"train card vs CPU {arch} step {i} {k}: {m['card'][k]} vs {m['cpu'][k]}")
    diffs = torch.cat([(a.cpu() - b_).abs().ravel() for a, b_ in
                       zip(leaves(state["card"][0]), leaves(state["cpu"][0]))])
    max_diff, frac = float(diffs.max()), float((diffs > 1e-5).double().mean())
    if not (max_diff <= 2 * opt_cfg.lr * TRAIN_CVC_STEPS and frac <= 1e-3):
        fail(f"train card vs CPU {arch}: params max |diff| {max_diff}, {frac} beyond 1e-5")
    rel = {k: max(abs(r["card"][k] - r["cpu"][k]) / abs(r["cpu"][k]) for r in rows)
           for k in ("loss", "grad_norm")}
    log(f"train card vs CPU ({arch} width, {layers} layers, f32, [{b}, {s}], "
        f"{TRAIN_CVC_STEPS} steps): loss max rel {rel['loss']:.3g} (bar "
        f"{TRAIN_CVC_LOSS_RTOL}), grad_norm max rel {rel['grad_norm']:.3g} (bar "
        f"{TRAIN_CVC_GNORM_RTOL}), params max |diff| {max_diff:.3g} (bar "
        f"{2 * opt_cfg.lr * TRAIN_CVC_STEPS:.3g}), {frac:.3g} of them beyond 1e-5, "
        f"{time.time() - t0:.1f} s ({card})")
    del p_gpu, state
    torch.cuda.empty_cache()
    return dict(steps=rows, max_rel=rel, params_max_abs_diff=max_diff,
                params_frac_beyond_1e5=frac)


def live_twin_phase(torch, ops, card: str) -> dict:
    """(e) examples/live_twin_training_torch.py at its defaults on the card
    (its own closing checks hold), with the kernels it launched."""
    import tempfile

    mod = load_example("live_twin_training_torch")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        ops.reset_launches()
        t0 = time.time()
        res = mod.main(LIVE_TWIN_ARGV + ["--ckpt-dir", tmp])
        wall = time.time() - t0
        launches = dict(ops.LAUNCHES)
    strag = [dict(window=p.window, **p.impact) for p in res.proposals
             if p.kind.value == "restart_straggler"]
    if launches["calib_mape_grid"] < len(res.window_mapes) or launches["flash_attention"] <= 0:
        fail(f"live twin: launches {launches} for {len(res.window_mapes)} windows")
    log(f"live twin (defaults): {res.report.steps_done} steps, {res.report.restarts} "
        f"restart (restored from {res.report.restored_from}), loss {res.losses[0]:.3f} -> "
        f"{res.losses[-1]:.3f}, window MAPEs {[round(m, 2) for m in res.window_mapes]}, "
        f"NFR1 {res.nfr1.compliance:.3f}, straggler proposals {strag}, {wall:.1f} s, "
        f"launches {launches} ({card})")
    return dict(steps_done=res.report.steps_done, restarts=res.report.restarts,
                restored_from=res.report.restored_from, first_loss=res.losses[0],
                last_loss=res.losses[-1], window_mapes=res.window_mapes,
                nfr1_compliance=res.nfr1.compliance, stragglers=strag, seconds=wall,
                launches=launches)


def train_phase(torch, np, ops, ref, card: str) -> dict:
    """Phase 13: (a)-(e), each run's launches counted from 0."""
    out = {"functions": train_functions(torch, np, ops, ref)}
    launches = {k: 0 for k in ops.LAUNCHES}
    for arch in ("smollm-360m", "mamba2-370m"):
        run = out[f"full width {arch}"] = train_full_width(torch, np, ops, arch, card)
        for k, n in run["launches"].items():
            launches[k] += n
    out["main"] = train_main_phase(torch, np, ops, card)
    for arch in TRAIN_CARD_VS_CPU:
        out[f"card vs CPU {arch}"] = train_card_vs_cpu(torch, np, arch, card)
    out["live_twin"] = live_twin_phase(torch, ops, card)
    for run in (out["main"], out["live_twin"]):
        for k, n in run["launches"].items():
            launches[k] += n
    out["launches"] = launches
    return out


# -- phase 14: the LM families ------------------------------------------------------

#: phase 14's architectures at full width, bf16, [4, 2048] tokens: arch ->
#: (layers kept, None for all; flash-attention launches per prefill call:
#: one per attention layer, Seamless's 12 encoder, 12 decoder self and 12
#: cross).  Command R+ 104B keeps 8 of its 64 layers: 3.1 GB of bf16
#: weights a layer and 12.6 GB of embedding and unembedding, ~38 GB, where
#: the whole model (~208 GB) does not fit one 80 GB card
FAMILY_PATHS = {
    "qwen2-moe-a2.7b": (None, 24),
    "deepseek-v2-lite-16b": (None, 27),
    "minicpm3-4b": (None, 62),
    "stablelm-3b": (None, 32),
    "qwen2-vl-7b": (None, 28),
    "seamless-m4t-medium": (None, 36),
    "command-r-plus-104b": (8, 8),
}
#: (b) the serving launcher at full width (Command R+ at its cut depth)
FAMILY_SERVE_ARGV = ["--reduce", "1", "--batch", "4", "--prompt-len", "32",
                     "--gen", "16", "--device", DEVICE]
#: (c) card against CPU in f32 at full width: layers (DeepSeek's 2 are its
#: dense layer 0 and one MoE layer; Seamless's encoder and decoder 2 each),
#: batch, sequence, greedy serve steps, and the bar on the prefill logits
#: (rtol and atol, the LM bar of phase 9)
FAMILY_CVC = dict(layers=2, b=2, s=256, steps=8, tol=1e-4)
#: (c) a MoE decision (a token's top-k experts, in order) may differ between
#: the card and the CPU only where, on the CPU, two of its k + 1 largest
#: router probabilities lie closer than this: f32 rounding moves a
#: probability (~1/60 at the init's router scale) by ~1e-8, so this bar
#: sits ~100x above the noise and ~30x below a typical neighbour's gap
MOE_TIE_GAP = 1e-6


class RouteProbe:
    """Records each ``moe.route`` call's ``(probs, ids)`` on the host, in
    call order, while installed (``with RouteProbe(moe) as probe:``); the
    routing itself is unchanged."""

    def __init__(self, moe_mod):
        self.mod, self.calls = moe_mod, []

    def __enter__(self):
        self.route = self.mod.route

        def recording(x, router, cfg, e_pad):
            out = self.route(x, router, cfg, e_pad)
            self.calls.append((out[0].cpu(), out[2].cpu()))
            return out

        self.mod.route = recording
        return self

    def __exit__(self, *exc):
        self.mod.route = self.route


def route_agreement(torch, arch: str, where: str, card: list, cpu: list) -> dict:
    """Expert ids of each routing call, card against CPU: equal, or a
    decision whose CPU gap between two of its k + 1 largest probabilities
    is below ``MOE_TIE_GAP`` (a near tie); fails on any other difference.
    Returns the counts of decisions, near ties and near-tie mismatches."""
    if len(card) != len(cpu):
        fail(f"card vs CPU {arch} {where}: {len(card)} routing calls on the card, "
             f"{len(cpu)} on the CPU")
    n = ties = mism = 0
    for (_, ids_g), (probs, ids_c) in zip(card, cpu):
        k = ids_c.shape[1]
        top = torch.sort(probs, dim=-1, descending=True).values[:, :k + 1]
        near = (top[:, :-1] - top[:, 1:]).min(dim=-1).values < MOE_TIE_GAP
        differ = (ids_g != ids_c).any(dim=-1)
        if bool((differ & ~near).any()):
            fail(f"card vs CPU {arch} {where}: expert ids differ where no near tie "
                 f"(gap >= {MOE_TIE_GAP}) explains it")
        n += ids_c.shape[0]
        ties += int(near.sum())
        mism += int(differ.sum())
    return dict(decisions=n, near_ties=ties, near_tie_mismatches=mism)


def family_card_vs_cpu(torch, np, arch: str, factor: int = 1) -> dict:
    """Phase 14 (c): the arch at full width (or ``reduce_config(cfg,
    factor)``, phase 20 (b)), cut to ``FAMILY_CVC["layers"]``,
    f32: prefill logits and greedy serve steps on the card against the CPU
    (TF32 off), on weights drawn on the card (seed 0, query and key
    projections rescaled, ``rescale_qk``) and copied to the host.  The VLM's
    patches and positions and the enc-dec's frames as ``prefill_batch``
    draws them; the enc-dec's serve state takes its encoder's cross K/V
    (``encdec.cross_kv``); MoE routing compared call by call first
    (``route_agreement``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (
        make_prefill_step, make_serve_step, param_specs_for, state_specs_for)
    from repro_torch.launch.train import reduce_config
    from repro_torch.models import encdec
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import init_params

    c = FAMILY_CVC
    b, s, steps, tol = c["b"], c["s"], c["steps"], c["tol"]
    cfg = lm_config(arch, num_layers=c["layers"], dtype="float32")
    if factor > 1:
        cfg = dataclasses.replace(reduce_config(get_config(arch), factor),
                                  num_layers=c["layers"], dtype="float32")
    t0 = time.time()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = {"card": rescale_qk(cfg, init_params(param_specs_for(cfg), gen,
                                                  torch.float32, DEVICE))}
    params["cpu"] = _tree_to(params["card"], "cpu")
    batch = {"card": prefill_batch(torch, cfg, b, s, gen, DEVICE)}
    batch["cpu"] = _tree_to(batch["card"], "cpu")
    runs = {"cpu": "cpu", "card": DEVICE}
    prefill = make_prefill_step(cfg)
    logits, probes, secs = {}, {}, {}
    for run in runs:
        t1 = time.time()
        with RouteProbe(moe_mod) as probes[run]:
            logits[run] = prefill(params[run], batch[run]).cpu()
        secs[run] = time.time() - t1
    out = {"prefill_seconds": secs}
    if cfg.moe:
        out["prefill_routing"] = route_agreement(torch, arch, "prefill",
                                                 probes["card"].calls, probes["cpu"].calls)
    got, want = logits["card"], logits["cpu"]
    err = float((got - want).abs().max())
    used = float(((got - want).abs() / (tol * (1 + want.abs()))).max())
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f"card vs CPU {arch} prefill logits: max |err| {err} beyond rtol "
             f"and atol {tol} (bar used {used:.3f})")
    serve = make_serve_step(cfg)
    states = {run: init_params(state_specs_for(cfg, b, steps), None, torch.float32, dev)
              for run, dev in runs.items()}
    if cfg.family == "encdec":
        for run in runs:
            states[run]["cross"] = encdec.cross_kv(cfg, params[run], encdec.encode(
                cfg, params[run], batch[run]["frames"]))
    tok = {run: torch.argmax(want, dim=-1).to(torch.int32).to(dev)
           for run, dev in runs.items()}
    stream, serve_probes = [], {run: RouteProbe(moe_mod) for run in runs}
    for i in range(steps):
        for run, dev in runs.items():
            step_batch = {"token": tok[run][:, None],
                          "cache_len": torch.full((b,), i, dtype=torch.int32, device=dev)}
            if cfg.mrope:
                step_batch["positions"] = torch.full((3, b, 1), s + i, dtype=torch.int32,
                                                     device=dev)
            with serve_probes[run]:
                tok[run], states[run] = serve(params[run], states[run], step_batch)
        if not torch.equal(tok["card"].cpu(), tok["cpu"]):
            fail(f"card vs CPU {arch} serve step {i}: greedy tokens differ")
        stream.append(tok["cpu"].tolist())
    if cfg.moe:
        out["serve_routing"] = route_agreement(torch, arch, "serve",
                                               serve_probes["card"].calls,
                                               serve_probes["cpu"].calls)
    routing = "; ".join(f"{k} {v['decisions']} decisions, {v['near_ties']} near ties, "
                        f"{v['near_tie_mismatches']} differ"
                        for k, v in out.items() if k.endswith("routing"))
    width = f"reduce_config(cfg, {factor})" if factor > 1 else "width"
    log(f"LM card vs CPU ({arch} {width}, {c['layers']} layers, f32, S={s}): prefill "
        f"logits max |err| {err:.3g} (rtol and atol {tol}; bar used {used:.3f}), "
        f"{steps} greedy serve steps equal; CPU prefill {secs['cpu']:.1f} s, "
        f"{time.time() - t0:.1f} s in all" + (f"; routing: {routing}" if routing else ""))
    del params, states, batch
    torch.cuda.empty_cache()
    return dict(out, prefill_max_abs_err=err, bar=tol, bar_used=used,
                greedy_tokens=stream, seconds=time.time() - t0)


def family_phase(torch, np, ops) -> dict:
    """Phase 14: the MoE, MLA, enc-dec, M-RoPE VLM, StableLM and Command R+
    configs, one model at a time, its memory freed after: (a) the prefill
    at full width (``FAMILY_PATHS``), launches counted; (b) the serving
    launcher; (c) card against CPU.  Command R+'s full-size parameter count
    is logged from its specs (the CPU tests hold it equal to the JAX
    package's)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import active_param_count, param_count

    out, launches = {}, {k: 0 for k in ops.LAUNCHES}
    for arch, (layers, flash) in FAMILY_PATHS.items():
        t0 = time.time()
        full = get_config(arch)
        run = out[f"prefill {arch}"] = lm_prefill(torch, ops, arch,
                                                  {"flash_attention": flash}, layers)
        for k, n in run["launches"].items():
            launches[k] += n
        argv = FAMILY_SERVE_ARGV + (["--layers", str(layers)] if layers else [])
        out[f"serve {arch}"] = lm_serve(torch, ops, arch, argv)
        out[f"card vs CPU {arch}"] = family_card_vs_cpu(torch, np, arch)
        out[f"params {arch}"] = dict(total=param_count(full), active=active_param_count(full))
        log(f"phase 14 {arch}: {param_count(full) / 1e9:.3f} B parameters at full size "
            f"({active_param_count(full) / 1e9:.3f} B active)"
            + (f", run at {layers} of {full.num_layers} layers" if layers else "")
            + f", {time.time() - t0:.1f} s")
    out["launches"] = launches
    return out


# -- phase 20: the reduced configs at the launchers' defaults -----------------------

#: (a) ``launch/serve.main`` at its default cut, ``--reduce 8``, for every
#: arch of the registry, then the reduced MLA and StableLM configs at the
#: other factors whose head dims are padded pairs of the flash kernel:
#: MiniCPM3-4B x2 (QK 48 / V 32) and x4 (24 / 16), DeepSeek-V2-Lite x4
#: (48 / 32), StableLM-3B x2 (40 / 40) and x4 (20 / 20); (arch, factor)
REDUCED_SERVE = (*((arch, 8) for arch in (
    "smollm-360m", "mamba2-370m", "zamba2-1.2b", "qwen2-moe-a2.7b",
    "deepseek-v2-lite-16b", "minicpm3-4b", "stablelm-3b", "qwen2-vl-7b",
    "seamless-m4t-medium", "command-r-plus-104b")),
    ("minicpm3-4b", 2), ("minicpm3-4b", 4), ("deepseek-v2-lite-16b", 4),
    ("stablelm-3b", 2), ("stablelm-3b", 4))
#: the serving launcher's own defaults besides ``--reduce``
REDUCED_SERVE_ARGV = ["--batch", "4", "--prompt-len", "32", "--gen", "64",
                      "--device", DEVICE]
#: (b) card against CPU in f32 at ``FAMILY_CVC``'s depth and bars for the
#: reduced MLA configs: arch -> reduction factor
REDUCED_CVC = {"minicpm3-4b": 8, "deepseek-v2-lite-16b": 4}


def reduced_prefill(torch, ops, arch: str, factor: int, b: int, s: int) -> dict:
    """``make_prefill_step`` on ``reduce_config(arch, factor)`` in its own
    dtype, seed 0, ``prefill_batch``'s ``[b, s]`` tokens (with the VLM's
    patches and the enc-dec's frames): one call, exactly one flash launch
    an attention call (``attention_calls``) and one ``ssd_chunk`` a Mamba
    layer, finite logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, param_specs_for
    from repro_torch.launch.train import reduce_config
    from repro_torch.models.common import init_params

    cfg = reduce_config(get_config(arch), factor)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_params(param_specs_for(cfg), gen, getattr(torch, cfg.dtype), DEVICE)
    batch = prefill_batch(torch, cfg, b, s, gen, DEVICE)
    mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    want = {k: 0 for k in ops.LAUNCHES}
    want.update(flash_attention=attention_calls(cfg), ssd_chunk=mamba)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.LAUNCHES)
    if launches != want:
        fail(f"reduced prefill {arch} x{factor}: launches {launches}, expected {want}")
    if logits.shape != (b, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"reduced prefill {arch} x{factor}: logits {tuple(logits.shape)} not finite")
    del params
    return dict(ms=ms, launches=launches, pair=flash_pair(cfg))


def flash_pair(cfg):
    """The (QK, V) head dims ``cfg``'s attention gives the flash kernel and
    the instantiation that runs them, or None without attention."""
    from repro_torch.kernels.flash_attention import instantiation_for

    if cfg.family == "ssm":
        return None
    d, dv = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) if cfg.attn_kind == "mla"
             else (cfg.head_dim, cfg.head_dim))
    return dict(d=d, dv=dv, instantiation=instantiation_for(d, dv))


def reduced_phase(torch, np, ops) -> dict:
    """Phase 20: (a) ``launch/serve.main`` at ``REDUCED_SERVE`` (its own
    defaults otherwise, ``REDUCED_SERVE_ARGV``), which steps the prompt
    through the decode step and launches no flash kernel, then the same
    reduced config prefilled at once on the prompt's ``[4, 32]``
    (``reduced_prefill``: one flash launch an attention call); (b) the
    reduced MLA configs at 2 layers, f32, card against CPU
    (``REDUCED_CVC``: greedy tokens and MoE ids equal, phase 14's bars).
    Every flash shape (a) and (b) give the kernel must be one of
    ``FLASH_CASES`` (phase 3 held each against the plain version)."""
    out, launches = {}, {k: 0 for k in ops.LAUNCHES}
    b = int(REDUCED_SERVE_ARGV[REDUCED_SERVE_ARGV.index("--batch") + 1])
    s = int(REDUCED_SERVE_ARGV[REDUCED_SERVE_ARGV.index("--prompt-len") + 1])
    with FlashShapes(ops) as shapes:
        for arch, factor in REDUCED_SERVE:
            key = f"{arch} x{factor}"
            run = lm_serve(torch, ops, arch, ["--reduce", str(factor)] + REDUCED_SERVE_ARGV)
            if ops.LAUNCHES["flash_attention"]:
                fail(f"serve {key}: {ops.LAUNCHES['flash_attention']} flash launches; the "
                     "decode step has none")
            run["launches"] = dict(ops.LAUNCHES)
            run["prefill"] = reduced_prefill(torch, ops, arch, factor, b, s)
            for part in (run["launches"], run["prefill"]["launches"]):
                for k, n in part.items():
                    launches[k] += n
            log(f"reduced {key}: head dims {run['prefill']['pair']}, prefill [{b}, {s}] "
                f"{run['prefill']['ms']:.1f} ms with launches {run['prefill']['launches']}")
            out[f"serve {key}"] = run
            torch.cuda.empty_cache()
        for arch, factor in REDUCED_CVC.items():
            out[f"card vs CPU {arch} x{factor}"] = family_card_vs_cpu(torch, np, arch, factor)
    checked = {case[:9] for case in FLASH_CASES}
    if not shapes.seen <= checked:
        fail(f"phase 20 gave flash_attention shapes phase 3 does not check: "
             f"{sorted(shapes.seen - checked)}")
    out["flash_shapes"] = sorted(shapes.seen)
    out["launches"] = launches
    return out


# -- phase 16: training the LM families ----------------------------------------------

#: (a) each family at full width, bf16, through ``make_train_step``: arch ->
#: (layers kept, None for all; batch; sequence; AdamW steps, 0 for the loss
#: and gradients alone).  Depths are cut from the step's peak: a pure step
#: holds the old and the new parameters and moments beside the gradient,
#: 22 bytes a parameter (bf16 parameters and gradients, f32 moments), plus
#: AdamW's f32 temporaries of the largest leaf (a layer stack; ~20 bytes an
#: element) and the CE chunk's logits, reckoned at 44-61 GiB to keep 18 GiB
#: of the 80 GB free.  Command R+ 104B takes no AdamW step: its untied
#: 256000 x 12288 embedding and unembedding alone are 6.3 B parameters, one
#: layer 7.86 B, 173 GB with moments and the update's copies
FAMILY_TRAIN = {
    "qwen2-moe-a2.7b": (2, 8, 256, 5),
    "deepseek-v2-lite-16b": (3, 8, 256, 5),
    "minicpm3-4b": (32, 8, 256, 5),
    "stablelm-3b": (28, 8, 256, 5),
    "qwen2-vl-7b": (4, 4, 2048, 5),
    "seamless-m4t-medium": (None, 8, 256, 5),
    "command-r-plus-104b": (1, 8, 256, 0),
}
#: (a)'s peak learning rate (2 warmup steps, then cosine decay): at 3e-4,
#: phase 13's, MiniCPM3-4B's loss rose from 11.80 to 12.05 in 5 steps on
#: an H100 (10.0 after the first, 14.0 at the fourth)
FAMILY_TRAIN_LR = 1e-4
#: (b) step 0's loss and every gradient, card against CPU in f32 with remat
#: off (``TRAIN_REF_BARS["float32"]``): each family at full width and 2
#: layers (DeepSeek: its dense layer 0 and one MoE layer; Seamless 2 + 2),
#: [1, 128] tokens with ``prefill_batch``'s patches and frames.  Command R+
#: at ``reduce_config(cfg, 4)``: at full width its f32 embedding and
#: unembedding are 25 GB, their gradients 25 GB more on the host, beside
#: the card's copies on the way back
FAMILY_CVC_SHAPE = dict(layers=2, b=1, s=128)
FAMILY_CVC_REDUCE = {"command-r-plus-104b": 4}
#: (c) ``launch/train.main`` through a crash: the enc-dec, the VLM and both
#: MoE archs (DeepSeek-V2-Lite's MLA at QK 16 / V 8 at --reduce 32, a
#: padded pair of the flash kernel).  --reduce 32: at --reduce 4 a Qwen2-VL
#: job state is 1.6 GB a checkpoint, and the codec writes ~8 MB/s on the
#: card host (phase 13 (c)'s reading)
FAMILY_MAIN_ARCHS = ("seamless-m4t-medium", "qwen2-vl-7b", "qwen2-moe-a2.7b",
                     "deepseek-v2-lite-16b")
FAMILY_MAIN_ARGV = ["--reduce", "32", "--steps", "4", "--ckpt-every", "2", "--seq", "64",
                    "--batch", "4", "--log-every", "1", "--device", DEVICE]
FAMILY_MAIN_FAIL = 3
#: (e) ``launch/train.main`` at its default width cut (``--reduce 8``),
#: batch and sequence ([8, 256]) for the archs whose reduced head dims are
#: padded pairs of the flash kernel: MiniCPM3-4B (QK 16 / V 8),
#: DeepSeek-V2-Lite (24 / 16) and StableLM-3B (16 / 16 at x8; its padded
#: 40 / 40 and 20 / 20 are x2 and x4, which phase 20 serves)
FAMILY_REDUCED_TRAIN = ("minicpm3-4b", "deepseek-v2-lite-16b", "stablelm-3b")
FAMILY_REDUCED_ARGV = ["--reduce", "8", "--steps", "4", "--log-every", "1",
                       "--device", DEVICE]
#: (d) the flash Function's gradients (``train_flash``) at (a)'s distinct
#: and new head dims: MiniCPM3-4B (QK 96 / V 64), DeepSeek-V2-Lite (192 /
#: 128) and StableLM-3B (80) at [8, 256], Seamless's cross-attention (256
#: decoder queries against 64 frames, non-causal), and two ragged shapes
#: with KV chunks of 40 in the backward
FAMILY_TRAIN_FLASH_CASES = [(8, 40, 40, 256, 256, 96, 64, True, 1024),
                            (8, 16, 16, 256, 256, 192, 128, True, 1024),
                            (8, 32, 32, 256, 256, 80, 80, True, 1024),
                            (8, 16, 16, 256, 64, 64, 64, False, 1024),
                            (2, 4, 2, 100, 130, 96, 64, True, 40),
                            (2, 4, 2, 100, 130, 192, 128, False, 40)]


class FlashShapes:
    """Records the ``FLASH_CASES`` key ``(b, hq, hkv, sq, skv, d, dv,
    causal, bf16)`` of each ``ops.flash_attention`` call on a card tensor
    while installed; the calls themselves are unchanged."""

    def __init__(self, ops):
        self.ops, self.seen = ops, set()

    def __enter__(self):
        self.real = self.ops.flash_attention

        def recording(q, k, v, **kw):
            if q.is_cuda:
                self.seen.add((*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                               v.shape[3], bool(kw.get("causal", True)),
                               str(q.dtype) == "torch.bfloat16"))
            return self.real(q, k, v, **kw)

        self.ops.flash_attention = recording
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.real


def attention_calls(cfg) -> int:
    """Flash-attention calls in one forward: one an attention layer; the
    enc-dec's encoder self-attention, decoder self- and cross-attention;
    the hybrid's shared block once every ``shared_attn_every`` layers; none
    in an SSM."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers


def family_train_full_width(torch, np, ops, arch: str, card: str) -> dict:
    """(a) the arch at full width, cut in depth (``FAMILY_TRAIN``), bf16,
    ``wq``/``wk`` rescaled (``rescale_qk``), on the port's token pipeline
    with ``train.frontend_inputs`` (the JAX launcher's frames and patches).
    First the loss and every gradient twice from one state: equal bit for
    bit (required of the MoE families, whose dispatch gathers rows back
    with repeated indices; logged for the others), then the AdamW steps
    through ``make_train_step``: per step the loss, grad norm and lr
    (finite), ms, tokens/s, peak ``max_memory_allocated`` and the
    flash-attention launches, exactly two an attention call (a forward
    and its remat recompute); the loss falls over the steps.  Command R+
    (no steps) is the gradient pass alone."""
    from repro_torch._tree import flatten
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, TokenPipeline
    from repro_torch.launch.steps import loss_for, make_train_step, param_specs_for
    from repro_torch.launch.train import frontend_inputs
    from repro_torch.models.common import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    layers, b, s, n_steps = FAMILY_TRAIN[arch]
    cfg = lm_config(arch, num_layers=layers)
    per_step = attention_calls(cfg) * (1 if cfg.remat == "none" else 2)
    want = {k: per_step if k == "flash_attention" else 0 for k in ops.LAUNCHES}
    launches = {k: 0 for k in ops.LAUNCHES}
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = rescale_qk(cfg, init_params(param_specs_for(cfg), gen,
                                         getattr(torch, cfg.dtype), DEVICE))
    pipe = TokenPipeline(DataConfig(cfg.vocab, s, b, seed=1), device=DEVICE)
    extra = frontend_inputs(cfg, b, s, DEVICE)
    loss_fn = loss_for(cfg)

    def counted(what: str, fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = dict(ops.LAUNCHES)
        if got != want:
            fail(f"train {arch} {what}: launches {got}, expected {want}")
        for k, n in got.items():
            launches[k] += n
        return out, ms

    def gradients():
        flat, unflatten = flatten(params)
        xs = [x.detach().requires_grad_(True) for x in flat]
        loss = loss_fn(cfg, unflatten(xs), {**pipe.global_batch(0), **extra})[0]
        grads = torch.autograd.grad(loss, xs)
        return float(loss.detach()), grads

    (loss0, g0), grad_ms = counted("gradients", gradients)
    # in f32 a slab at a time: an f32 copy of Command R+'s embedding
    # gradient alone is 11.7 GiB
    gnorm = math.sqrt(sum(float(c.float().square().sum())
                          for g in g0 for c in g.reshape(-1).split(1 << 26)))
    (_, g1), _ = counted("gradients again", gradients)
    repeat = all(torch.equal(a, c) for a, c in zip(g0, g1, strict=True))
    del g0, g1
    if cfg.moe and not repeat:
        fail(f"train {arch}: two backward passes from one state differ bitwise")
    if not (math.isfinite(loss0) and math.isfinite(gnorm)):
        fail(f"train {arch}: loss {loss0}, grad norm {gnorm}")
    grad_peak = torch.cuda.max_memory_allocated()
    out = dict(layers=layers, batch=b, seq=s, loss=loss0, grad_norm=gnorm,
               gradients_ms=grad_ms, gradients_peak_bytes=grad_peak,
               bitwise_repeatable=repeat, launches_per_step=per_step)
    rows = []
    if n_steps:
        opt_cfg = AdamWConfig(lr=FAMILY_TRAIN_LR, warmup_steps=2, total_steps=n_steps)
        opt = init_opt_state(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        for i in range(n_steps):
            batch = {**pipe.global_batch(i), **extra}
            torch.cuda.reset_peak_memory_stats()
            (params, opt, m), ms = counted(f"step {i}", lambda: step(params, opt, batch))
            vals = {k: float(m[k]) for k in ("loss", "grad_norm", "lr")}
            if not all(math.isfinite(v) for v in vals.values()):
                fail(f"train {arch} step {i}: metrics {vals}")
            rows.append(dict(step=i, ms=ms, tokens_per_second=b * s / ms * 1e3,
                             peak_bytes=torch.cuda.max_memory_allocated(), **vals))
            log(f"train {arch} step {i}: loss {vals['loss']:.4f} grad_norm "
                f"{vals['grad_norm']:.4g} lr {vals['lr']:.3g}, {ms:.1f} ms "
                f"({rows[-1]['tokens_per_second']:.0f} tokens/s), peak "
                f"{rows[-1]['peak_bytes'] / 2**30:.2f} GiB allocated")
        if not rows[-1]["loss"] < rows[0]["loss"]:
            fail(f"train {arch}: the loss did not fall in {n_steps} steps: "
                 f"{[r['loss'] for r in rows]}")
        del opt
    peak = max([grad_peak] + [r["peak_bytes"] for r in rows])
    warm = statistics.median(r["ms"] for r in rows[1:]) if rows else grad_ms
    depth = (f"{cfg.enc_layers} + {cfg.dec_layers}" if cfg.family == "encdec"
             else f"{cfg.num_layers} of {get_config(arch).num_layers}")
    log(f"train {arch} ({depth} layers x {cfg.d_model}, {cfg.dtype}, remat {cfg.remat!r}) "
        f"[{b}, {s}]: " + (f"{n_steps} AdamW steps, median {warm:.1f} ms a step "
                           f"({b * s / warm * 1e3:.0f} tokens/s), loss {rows[0]['loss']:.4f}"
                           f" -> {rows[-1]['loss']:.4f}; " if rows else
                           "loss and gradients only (no AdamW step); ")
        + f"loss and gradients {grad_ms:.1f} ms, loss {loss0:.4f}, grad norm {gnorm:.4g}, "
        f"twice from one state bitwise equal: {repeat}; peak {peak / 2**30:.2f} GiB "
        f"allocated; {per_step} flash launches a step ({attention_calls(cfg)} attention "
        f"calls, forward and remat recompute) ({card})")
    del params
    torch.cuda.empty_cache()
    return dict(out, steps=rows, median_ms=warm, peak_bytes=peak, launches=launches)


def family_train_card_vs_cpu(torch, np, arch: str, card: str) -> dict:
    """(b) step 0's loss and every parameter's gradient on the card against
    the CPU, f32, remat off (``FAMILY_CVC_SHAPE``; TF32 off on both
    sides), on weights drawn on the card (seed 0, ``rescale_qk``) and
    copied to the host, ``prefill_batch``'s tokens, patches and frames and
    the tokens shifted as labels; the MoE families' expert ids compared
    call by call (``route_agreement``) first.  Bars:
    ``TRAIN_REF_BARS["float32"]``."""
    from repro_torch._tree import flatten
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_for, param_specs_for
    from repro_torch.launch.train import reduce_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import init_params, spec_leaves

    c = FAMILY_CVC_SHAPE
    base = get_config(arch)
    factor = FAMILY_CVC_REDUCE.get(arch, 1)
    depth = (dict(enc_layers=c["layers"], dec_layers=c["layers"])
             if base.family == "encdec" else dict(num_layers=c["layers"]))
    cfg = dataclasses.replace(reduce_config(base, factor), dtype="float32", remat="none",
                              **depth)
    t0 = time.time()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = {"card": rescale_qk(cfg, init_params(param_specs_for(cfg), gen,
                                                  torch.float32, DEVICE))}
    batch = prefill_batch(torch, cfg, c["b"], c["s"], gen, DEVICE)
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    batches = {"card": batch, "cpu": _tree_to(batch, "cpu")}
    params["cpu"] = _tree_to(params["card"], "cpu")
    names = [k for k, _ in spec_leaves(param_specs_for(cfg))]
    loss_fn = loss_for(cfg)
    res, secs = {}, {}
    for run in ("cpu", "card"):
        t1 = time.time()
        flat, unflatten = flatten(params[run])
        xs = [x.detach().requires_grad_(True) for x in flat]
        with RouteProbe(moe_mod) as probe:
            loss = loss_fn(cfg, unflatten(xs), batches[run])[0]
        grads = [g.cpu() for g in torch.autograd.grad(loss, xs)]
        res[run] = (float(loss.detach()), grads, probe.calls)
        secs[run] = time.time() - t1
        del xs, flat
    want_loss, want, cpu_calls = res["cpu"]
    loss, got, card_calls = res["card"]
    out = dict(layers=c["layers"], reduce=factor, seconds=secs)
    if cfg.moe:
        out["routing"] = route_agreement(torch, arch, "train step 0", card_calls, cpu_calls)
    want_norm = math.sqrt(sum(float(w.square().sum()) for w in want))
    diff = [float((g - w).norm()) for g, w in zip(got, want, strict=True)]
    leaf = sorted(((d / max(float(w.norm()), 1e-30), n)
                   for d, w, n in zip(diff, want, names, strict=True)), reverse=True)
    rec = dict(loss=loss, cpu_loss=want_loss, loss_rel=abs(loss - want_loss) / abs(want_loss),
               grad_norm=want_norm, grad_rel=math.sqrt(sum(d * d for d in diff)) / want_norm,
               grad_leaf_rel_max=leaf[0][0], worst_leaves=leaf[:3])
    bar = TRAIN_REF_BARS["float32"]
    if not (rec["loss_rel"] <= bar["loss"] and rec["grad_rel"] <= bar["grad"]
            and rec["grad_leaf_rel_max"] <= bar["leaf"]):
        fail(f"train card vs CPU {arch} step 0: {rec} (bars {bar}); routing "
             f"{out.get('routing')}")
    routing = out.get("routing")
    log(f"train card vs CPU ({arch}" + (f" reduce_config(cfg, {factor})" if factor > 1
                                        else " full width")
        + f", {c['layers']} layers, f32, [{c['b']}, {c['s']}], step 0): loss {loss:.6f} vs "
        f"{want_loss:.6f} (rel {rec['loss_rel']:.3g}, bar {bar['loss']}), gradient's relative "
        f"L2 error {rec['grad_rel']:.3g} (bar {bar['grad']}), worst leaves " + ", ".join(
            f"{n} {r:.3g}" for r, n in leaf[:3]) + f" (bar {bar['leaf']})"
        + (f"; routing {routing['decisions']} decisions, {routing['near_ties']} near ties, "
           f"{routing['near_tie_mismatches']} differ" if routing else "")
        + f"; CPU {secs['cpu']:.1f} s, card {secs['card']:.2f} s, {time.time() - t0:.1f} s "
        f"in all ({card})")
    del params, res, batches, got, want
    torch.cuda.empty_cache()
    return dict(out, **rec)


def train_main_reduced(torch, ops, arch: str, card: str) -> dict:
    """(e) ``launch/train.main`` for ``arch`` at ``FAMILY_REDUCED_ARGV``:
    every step done with no restart, the losses finite, exactly two flash
    launches an attention call a step (a forward and its remat
    recompute) and no other kernel."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    argv = ["--arch", arch] + FAMILY_REDUCED_ARGV
    steps = int(argv[argv.index("--steps") + 1])
    cfg = train.reduce_config(get_config(arch), int(argv[argv.index("--reduce") + 1]))
    per_step = attention_calls(cfg) * (1 if cfg.remat == "none" else 2)
    want = {k: per_step * steps if k == "flash_attention" else 0 for k in ops.LAUNCHES}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        ops.reset_launches()
        t0 = time.time()
        res = train.main(argv + ["--ckpt-dir", tmp])
        wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    rep = res.report
    what = f"train.main {' '.join(argv)}"
    if rep.steps_done != steps or rep.restarts != 0 or not all(
            math.isfinite(x) for x in rep.losses):
        fail(f"{what}: {rep.steps_done} steps, {rep.restarts} restarts, losses {rep.losses}")
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")
    log(f"{what}: {rep.steps_done} steps, losses {[round(x, 4) for x in rep.losses]}, "
        f"{wall:.1f} s, launches {launches} ({per_step} flash a step) ({card})")
    return dict(steps_done=rep.steps_done, losses=rep.losses, seconds=wall,
                launches=launches)


def family_train_phase(torch, np, ops, ref, card: str) -> dict:
    """Phase 16: training the MoE, MLA, StableLM, Command R+, VLM and enc-dec
    families: (d) the flash Function's gradients at their head dims, (a)
    each at full width (``FAMILY_TRAIN``), (b) card against CPU, (c)
    ``train.main`` through a crash, (e) ``train.main`` at ``--reduce 8``
    (``FAMILY_REDUCED_TRAIN``).  (a)'s, (c)'s and (e)'s launches are
    counted; every flash shape they and (b) give the kernel must be one of
    ``FLASH_CASES`` (phase 3 held each against the plain version)."""
    out = {"flash": train_flash(torch, np, ops, ref, FAMILY_TRAIN_FLASH_CASES, seed=320)}
    launches = {k: 0 for k in ops.LAUNCHES}
    with FlashShapes(ops) as shapes:
        for arch in FAMILY_TRAIN:
            run = out[f"full width {arch}"] = family_train_full_width(torch, np, ops, arch, card)
            for k, n in run["launches"].items():
                launches[k] += n
        for arch in FAMILY_TRAIN:
            out[f"card vs CPU {arch}"] = family_train_card_vs_cpu(torch, np, arch, card)
        for arch in FAMILY_MAIN_ARCHS:
            run = out[f"main {arch}"] = train_main_restart(
                torch, ops, ["--arch", arch] + FAMILY_MAIN_ARGV, FAMILY_MAIN_FAIL, card)
            for k, n in run["launches"].items():
                launches[k] += n
        for arch in FAMILY_REDUCED_TRAIN:
            run = out[f"reduced main {arch}"] = train_main_reduced(torch, ops, arch, card)
            for k, n in run["launches"].items():
                launches[k] += n
    checked = {case[:9] for case in FLASH_CASES}
    if not shapes.seen <= checked:
        fail(f"phase 16 gave flash_attention shapes phase 3 does not check: "
             f"{sorted(shapes.seen - checked)}")
    out["flash_shapes"] = sorted(shapes.seen)
    out["launches"] = launches
    return out


#: phase 17 (a): Qwen1.5-MoE-A2.7B's MoE layer at full width (d 2048, 60
#: experts padded to 64, top 4, 4 shared experts), x [B, S, d]
EP_X = (4, 2048)
#: (a)'s bars: the expert-parallel y against the one-shard y on the card
#: (relative L2; bf16 sums the shards' partial outputs in another order),
#: and the 2x4 mesh on the card against the same call on the CPU (f32)
EP_REL_L2 = {"float32": 1e-6, "bfloat16": 1e-2}
EP_CPU_RTOL = 1e-5
#: (b): Qwen1.5-MoE's first layers, f32, prefilled over the (a) model mesh
EP_PREFILL_LAYERS = 2
#: (c): the meta pass against the card, arch -> layers (None: all of them),
#: each a train step on [8, 256], a prefill of [4, 2048] and a batch-4
#: decode step over a 2048 cache, bf16
META_CELLS = {"smollm-360m": None, "mamba2-370m": None, "qwen2-moe-a2.7b": 2}
META_TRAIN, META_PREFILL, META_DECODE = (8, 256), (4, 2048), (4, 2048)
#: timed runs of each step after the counted one
META_TIMED = {"train": 3, "prefill": 5, "decode": 20}
META_BYTES_RTOL = 0.01
META_PEAK_RANGE = (0.8, 1.2)
#: (d): the dry-run's CLI on the single mesh: SmolLM-360M's four shapes
#: (``long_500k`` skipped for a full-attention arch), then the cells that
#: torch 2.11's DTensor once could not place (the cumsum's backward flip,
#: the embedding's backward index_put, the greedy argmax, the decode's
#: head regroups): each traced with no DTensor fallback
DRYRUN_CELLS = ([("smollm-360m", s) for s in ("train_4k", "prefill_32k", "decode_32k",
                                               "long_500k")]
                + [("seamless-m4t-medium", "decode_32k"), ("command-r-plus-104b", "decode_32k"),
                   ("minicpm3-4b", "decode_32k"), ("zamba2-1.2b", "long_500k"),
                   ("mamba2-370m", "train_4k"), ("zamba2-1.2b", "train_4k"),
                   ("minicpm3-4b", "train_4k"), ("seamless-m4t-medium", "train_4k")])
DRYRUN_ARGV = ["--mesh", "single", "--cells", ",".join(f"{a}:{s}" for a, s in DRYRUN_CELLS)]
#: phase 17 (e): the archs traced per device on meta and card shards, each
#: with the kernel a shard must launch, its ``(data, model)`` mesh and its
#: steps; their depth.  ``model`` 2 divides SmolLM's, Mamba2's and
#: StableLM's vocabularies (the CE's logits split on it); 4 does not divide
#: Seamless's 256206 (the CE's rows split instead)
META_SHARDED = {"smollm-360m": ("flash_attention", (2, 2), ("train", "prefill")),
                "mamba2-370m": ("ssd_chunk", (2, 2), ("train", "prefill")),
                "stablelm-3b": ("flash_attention", (2, 2), ("train", "prefill")),
                "seamless-m4t-medium": ("flash_attention", (1, 4), ("train",))}
META_SHARDED_LAYERS = 2
#: phase 17 (e): an arch's train step at two depths under each remat policy
#: on a mesh: ``(arch, kernel, (data, model), (batch, seq), (depths),
#: (policies))``; its peak a layer (the deeper cut's less the shallower's,
#: over the layers between) on the card within ``META_PEAK_RANGE`` of
#: meta's.  2048 tokens a row, so a layer's residuals (~7.5 MiB a device
#: under "full", ~68 under "dots") stand well above the allocator's rounding
META_DEPTH = ("smollm-360m", "flash_attention", (2, 2), (8, 2048), (2, 4), ("full", "dots"))
#: phase 17 (f): one SmolLM-360M attention layer at full width on [B, S]
#: tokens, its flash call split into CP_TP blocks of query rows; the bars
#: of the put-together output and gradients against the unsplit layer's
#: (relative L2: f32 sums reordered; bf16 rounds each shard's dk and dv
#: before they are summed)
CP_X = (2, 2048)
CP_TP = 4
CP_REL_L2 = {"float32": 1e-5, "bfloat16": 1e-2}
#: phase 19: the days of the DES roofline (``analysis/roofline_torch.py``'s default)
DES_ROOFLINE_DAYS = 2.0


class DispatchProbe:
    """Records each ``moe.route`` call's ids and each ``moe.dispatch``
    call's ``(keep, slot_idx, e0)`` on the host, in call order, while
    installed; the routing itself is unchanged."""

    def __init__(self, moe_mod):
        self.mod, self.ids, self.slots = moe_mod, [], []

    def __enter__(self):
        self.route, self.dispatch = self.mod.route, self.mod.dispatch

        def rows(t):                    # [blocks, T, k] or [T, k] as [T', k]
            return t.reshape(-1, t.shape[-1]).cpu()

        def route(x, router, cfg, e_pad):
            out = self.route(x, router, cfg, e_pad)
            self.ids.append(rows(out[2]))
            return out

        def dispatch(ids, el, e0, cap):
            keep, slot = self.dispatch(ids, el, e0, cap)
            self.slots.append((rows(keep), rows(slot), e0, el, cap))
            return keep, slot

        self.mod.route, self.mod.dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        self.mod.route, self.mod.dispatch = self.route, self.dispatch


def ep_inputs(torch, cfg, dtype, dev, seed: int):
    """One MoE layer of ``cfg`` (its ``moe_specs`` at L=1, drawn on ``dev``)
    and ``x [EP_X, d]``.  The router and x sit on grids (k/64, k/4) on
    which every product and partial sum of the router's logits is exact in
    float32, so the card and the CPU route alike in any order of sums."""
    from repro_torch.models import moe
    from repro_torch.models.common import init_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {k: v[0] for k, v in init_params(moe.moe_specs(cfg, 1), gen, torch.float32,
                                        dev).items()}
    p["router"] = torch.round(torch.randn(p["router"].shape, generator=gen, device=dev)
                              * 3) / 64
    x = torch.round(torch.randn((*EP_X, cfg.d_model), generator=gen, device=dev) * 4) / 4
    return {k: v.to(dtype) for k, v in p.items()}, x.to(dtype)


def ep_decisions_split(torch, full, shards, label: str) -> int:
    """The one-shard call's decisions against the model shards': each shard
    routes alike, keeps exactly the kept (token, slot)s of its experts, at
    the same position of its own buffer.  Returns the kept count."""
    ids_full, (keep_full, slot_full, _, _, cap) = full
    kept = torch.zeros_like(keep_full, dtype=torch.int64)
    for ids, (keep, slot, e0, el, cap_k) in shards:
        if not torch.equal(ids, ids_full) or cap_k != cap:
            fail(f"phase 17 (a) {label}: shard {e0 // el} routes unlike the one-shard call")
        own = keep_full & (ids_full >= e0) & (ids_full < e0 + el)
        if not torch.equal(keep, own) or not torch.equal(slot[own], slot_full[own] - e0 * cap):
            fail(f"phase 17 (a) {label}: shard {e0 // el}'s keep or slots differ from "
                 "the one-shard call's")
        kept += keep
    if not torch.equal(kept, keep_full.long()):
        fail(f"phase 17 (a) {label}: a kept (token, slot) is not kept by exactly one shard")
    return int(keep_full.sum())


def ep_phase(torch, timer) -> dict:
    """Phase 17 (a): the expert-parallel branch at Qwen1.5-MoE-A2.7B's
    width: over ``cuda:0`` x 4 on ``("model",)`` against the one-shard
    ``moe_ffn`` (f32 and bf16), and over ``cuda:0`` x 8 on ``("data",
    "model")`` 2x4 against the same call on the CPU (f32)."""
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import ShardingCtx, make_mesh_compat

    cfg = lm_config("qwen2-moe-a2.7b")
    mesh4 = make_mesh_compat((4,), ("model",), devices=[DEVICE] * 4)
    mesh8 = make_mesh_compat((2, 4), ("data", "model"), devices=[DEVICE] * 8)
    out = {}
    for dtype in ("float32", "bfloat16"):
        p, x = ep_inputs(torch, cfg, getattr(torch, dtype), DEVICE, seed=170)
        with DispatchProbe(moe) as one:
            y1, aux1 = moe.moe_ffn(cfg, p, x)
        with DispatchProbe(moe) as four:
            y4, aux4 = moe.moe_ffn(cfg, p, x, ShardingCtx(mesh=mesh4))
        kept = ep_decisions_split(torch, (one.ids[0], one.slots[0]),
                                  list(zip(four.ids, four.slots)), f"{dtype} model x4")
        rel = float((y4.float() - y1.float()).norm() / y1.float().norm())
        if not rel <= EP_REL_L2[dtype] or not torch.allclose(aux4, aux1, rtol=1e-6, atol=0):
            fail(f"phase 17 (a) {dtype}: model x4 y rel L2 {rel:.3g} (bar "
                 f"{EP_REL_L2[dtype]}), aux {float(aux4)} vs one shard {float(aux1)}")
        ms = {"one shard": timer.wall_ms(lambda: moe.moe_ffn(cfg, p, x), reps=3),
              "model x4": timer.wall_ms(
                  lambda: moe.moe_ffn(cfg, p, x, ShardingCtx(mesh=mesh4)), reps=3),
              "2x4": timer.wall_ms(
                  lambda: moe.moe_ffn(cfg, p, x, ShardingCtx(mesh=mesh8)), reps=3)}
        row = dict(kept=kept, decisions=int(one.ids[0].numel()), rel_l2=rel,
                   aux=float(aux1), ms=ms)
        if dtype == "float32":
            t0 = time.time()
            cpu_mesh = make_mesh_compat((2, 4), ("data", "model"), devices=["cpu"] * 8)
            with DispatchProbe(moe) as card:
                y8, aux8 = moe.moe_ffn(cfg, p, x, ShardingCtx(mesh=mesh8))
            with DispatchProbe(moe) as cpu:
                yc, auxc = moe.moe_ffn(cfg, {k: v.cpu() for k, v in p.items()}, x.cpu(),
                                       ShardingCtx(mesh=cpu_mesh))
            if len(card.ids) != len(cpu.ids) or not all(
                    torch.equal(a, b) for a, b in zip(card.ids, cpu.ids)) or not all(
                    torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                    for a, b in zip(card.slots, cpu.slots)):
                fail("phase 17 (a) 2x4: card and CPU routing decisions differ")
            err = float((y8.cpu() - yc).abs().max())
            if not torch.allclose(y8.cpu(), yc, rtol=EP_CPU_RTOL,
                                  atol=EP_CPU_RTOL * float(yc.abs().max())) or \
                    not torch.allclose(aux8.cpu(), auxc, rtol=EP_CPU_RTOL, atol=0):
                fail(f"phase 17 (a) 2x4: card vs CPU y max |err| {err}, aux "
                     f"{float(aux8)} vs {float(auxc)} beyond rtol {EP_CPU_RTOL}")
            row.update(mesh_2x4_vs_cpu_max_abs_err=err, aux_2x4=float(aux8),
                       cpu_seconds=time.time() - t0,
                       blocks_differ_from_one_shard=float((y8 - y1).abs().max()))
        log(f"phase 17 (a) expert parallel, Qwen1.5-MoE layer x {list(x.shape)} {dtype}: "
            f"model x4 decisions equal the one-shard call's ({kept} of "
            f"{row['decisions']} kept), y rel L2 {rel:.3g} (bar {EP_REL_L2[dtype]}), aux "
            f"{float(aux4):.6f}; ms one shard {ms['one shard']:.2f}, model x4 "
            f"{ms['model x4']:.2f}, 2x4 {ms['2x4']:.2f} (one card runs the shards in turn)"
            + (f"; 2x4 vs CPU: decisions equal, y max |err| {row['mesh_2x4_vs_cpu_max_abs_err']:.3g}"
               f", aux {row['aux_2x4']:.6f} (one shard {float(aux1):.6f}), CPU "
               f"{row['cpu_seconds']:.1f} s" if dtype == "float32" else ""))
        out[dtype] = row
        del p, x, y1, y4
    torch.cuda.empty_cache()
    return out


def ep_prefill(torch, ops) -> dict:
    """Phase 17 (b): Qwen1.5-MoE at ``EP_PREFILL_LAYERS`` layers of full
    width, f32, ``[4, 2048]``, prefilled with its experts over ``cuda:0`` x
    4 on ``("model",)`` (``make_prefill_step(cfg, ShardingCtx(...))``, which
    binds it with ``use_ctx``), against the unsharded prefill: last
    logits at phase 14's bar, routing call by call (``route_agreement``),
    one flash launch an attention layer each."""
    from repro_torch.launch.steps import make_prefill_step, param_specs_for
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import init_params
    from repro_torch.parallel.sharding import ShardingCtx, make_mesh_compat

    cfg = lm_config("qwen2-moe-a2.7b", num_layers=EP_PREFILL_LAYERS, dtype="float32")
    tol = FAMILY_CVC["tol"]
    gen = torch.Generator(device=DEVICE).manual_seed(171)
    params = rescale_qk(cfg, init_params(param_specs_for(cfg), gen, torch.float32, DEVICE))
    batch = prefill_batch(torch, cfg, *META_PREFILL, gen, DEVICE)
    mesh = make_mesh_compat((4,), ("model",), devices=[DEVICE] * 4)
    # the factory binds its ShardingCtx with use_ctx for the step
    prefill = {"unsharded": make_prefill_step(cfg),
               "sharded": make_prefill_step(cfg, ShardingCtx(mesh=mesh, mode="serve"))}
    logits, probes, flash = {}, {}, {}
    for run in ("unsharded", "sharded"):
        ops.reset_launches()
        with RouteProbe(moe_mod) as probes[run]:
            logits[run] = prefill[run](params, batch)
        torch.cuda.synchronize()
        flash[run] = ops.LAUNCHES["flash_attention"]
        if flash[run] != cfg.num_layers:
            fail(f"phase 17 (b) {run}: {flash[run]} flash launches, expected one an "
                 f"attention layer ({cfg.num_layers})")
    shards = mesh.shape["model"]
    # the branch routes [blocks, T, d]: its calls as [T, k] rows
    sharded = [(pr.reshape(-1, pr.shape[-1]), ids.reshape(-1, ids.shape[-1]))
               for pr, ids in probes["sharded"].calls]
    if len(sharded) != shards * len(probes["unsharded"].calls) or not all(
            torch.equal(sharded[i][1], sharded[i - i % shards][1]) for i in range(len(sharded))):
        fail("phase 17 (b): the model shards of a layer route unlike each other")
    routing = route_agreement(torch, "qwen2-moe-a2.7b", "phase 17 (b)", sharded[::shards],
                              probes["unsharded"].calls)
    got, want = logits["sharded"].cpu(), logits["unsharded"].cpu()
    err = float((got - want).abs().max())
    used = float(((got - want).abs() / (tol * (1 + want.abs()))).max())
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f"phase 17 (b): sharded prefill logits max |err| {err} beyond rtol and atol {tol}")
    log(f"phase 17 (b) prefill through the expert-parallel branch (Qwen1.5-MoE "
        f"{cfg.num_layers} layers x {cfg.d_model}, f32, {list(META_PREFILL)}, experts over "
        f"{DEVICE} x {shards}): last logits max |err| {err:.3g} against the unsharded "
        f"prefill (rtol and atol {tol}; bar used {used:.3f}), {routing['decisions']} "
        f"routing decisions, {routing['near_tie_mismatches']} differ at near ties; flash "
        f"launches {flash}")
    del params, batch
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, bar=tol, bar_used=used, routing=routing,
                flash_launches=flash)


def to_meta(torch, tree):
    """``tree`` (dicts, tuples and NamedTuples of tensors) as ``meta``
    tensors of the same shapes and dtypes."""
    from repro_torch._tree import tree_map

    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def arg_bytes(torch, *trees) -> int:
    """Bytes of the distinct storages the tensors of ``trees`` hold."""
    from repro_torch._tree import leaves

    seen = {}
    for t in leaves(list(trees)):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def meta_cell(torch, ops, arch: str, layers) -> dict:
    """Phase 17 (c) for one arch: a train step, a prefill and a decode step
    at full width (first ``layers``), bf16, counted by ``trace_cost`` on
    ``meta`` and on the card: FLOPs equal, bytes within ``META_BYTES_RTOL``,
    ops printed; the meta pass's live bytes plus the step's argument bytes
    within ``META_PEAK_RANGE`` of the card's peak (``max_memory_allocated``,
    reset before the step, less what the card held beside the arguments);
    the H100 roofline bound of the meta count at most the step's median
    ms."""
    from repro_torch.analysis.cost import trace_cost
    from repro_torch.analysis.roofline import make_roofline, model_flops_for
    from repro_torch.launch import shapes
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step, make_train_step,
                                          param_specs_for, state_specs_for)
    from repro_torch.models.common import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    cfg = lm_config(arch, num_layers=layers)
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(172)
    params = rescale_qk(cfg, init_params(param_specs_for(cfg), gen, dt, DEVICE))
    opt_cfg = AdamWConfig()
    cells = {}
    for kind in ("train", "prefill", "decode"):
        b, s = {"train": META_TRAIN, "prefill": META_PREFILL, "decode": META_DECODE}[kind]
        shape = shapes.ShapeSpec(kind, kind, s, b)
        batch = shapes.concrete_inputs(cfg, shape, seed=173, device=DEVICE)
        if kind == "train":
            step = make_train_step(cfg, opt_cfg)
            args = (params, init_opt_state(params, opt_cfg), batch)
        elif kind == "prefill":
            step, args = make_prefill_step(cfg), (params, batch)
        else:
            state = init_params(state_specs_for(cfg, b, s), None, dt, DEVICE)
            step, args = make_serve_step(cfg), (params, state, batch)
        meta = trace_cost(step, *to_meta(torch, args))
        n_args = arg_bytes(torch, *args)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - n_args
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        card = trace_cost(step, *args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        del card["out"], meta["out"]
        times = []
        for _ in range(META_TIMED[kind]):
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        mf = model_flops_for(cfg, kind, b, s, kind == "train")
        roof = make_roofline(meta, mf, 1)
        row = dict(flops_meta=meta["flops_per_device"], flops_card=card["flops_per_device"],
                   bytes_meta=meta["bytes_per_device"], bytes_card=card["bytes_per_device"],
                   ops_meta=meta["num_ops"], ops_card=card["num_ops"],
                   peak_live_meta=meta["peak_live_bytes"], arg_bytes=n_args,
                   peak_card=peak, launches=launches, ms=ms, ms_runs=times,
                   bound_ms=roof.bound_s * 1e3, dominant=roof.dominant,
                   model_flops=mf)
        row["bytes_ratio"] = row["bytes_meta"] / row["bytes_card"]
        row["peak_ratio"] = (row["peak_live_meta"] + n_args) / peak
        row["bound_over_ms"] = row["bound_ms"] / ms
        tag = f"phase 17 (c) {arch} {kind}"
        if row["flops_meta"] != row["flops_card"]:
            fail(f"{tag}: FLOPs meta {row['flops_meta']} != card {row['flops_card']}")
        if abs(row["bytes_ratio"] - 1) > META_BYTES_RTOL:
            fail(f"{tag}: bytes meta / card {row['bytes_ratio']:.4f} beyond {META_BYTES_RTOL}")
        if not META_PEAK_RANGE[0] <= row["peak_ratio"] <= META_PEAK_RANGE[1]:
            fail(f"{tag}: (meta live + arguments) / card peak {row['peak_ratio']:.3f} outside "
                 f"{META_PEAK_RANGE}")
        if row["bound_ms"] > ms:
            fail(f"{tag}: roofline bound {row['bound_ms']:.3f} ms above the measured "
                 f"{ms:.3f} ms: a count is wrong")
        log(f"{tag} ({cfg.num_layers} layers x {cfg.d_model}, bf16, [{b}, {s}]): FLOPs "
            f"{row['flops_meta']:.6g} on both; bytes meta/card {row['bytes_ratio']:.5f}; ops "
            f"meta {row['ops_meta']} card {row['ops_card']}; (live {row['peak_live_meta'] / 2**30:.3f}"
            f" + args {n_args / 2**30:.3f} GiB) / card peak {peak / 2**30:.3f} GiB = "
            f"{row['peak_ratio']:.3f}; bound {row['bound_ms']:.3f} ms ({roof.dominant}) / "
            f"median {ms:.3f} ms = {row['bound_over_ms']:.4f}; launches {launches}")
        cells[kind] = row
        del args, batch
        if kind == "decode":
            del state
    del params
    torch.cuda.empty_cache()
    return cells


def dryrun_start() -> tuple:
    """Phase 17 (d), started: ``python -m repro_torch.launch.dryrun`` at
    ``DRYRUN_ARGV`` into a temporary directory, in a process of its own that
    traces on the host's CPU while the card's phases run (started after the
    build; killed, and its directory removed, when this script exits).
    Returns ``(process, start time, directory)``."""
    import atexit
    import os
    import shutil
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    # its output goes to files: a pipe nobody reads for minutes could fill
    with open(os.path.join(out_dir, "log"), "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGV,
             "--out", os.path.join(out_dir, "cells")],
            stdout=log_file, stderr=subprocess.STDOUT, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(SRC)))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)

    atexit.register(stop)
    return proc, time.time(), out_dir


def dryrun_finish(proc, t0: float, out_dir: str) -> dict:
    """Phase 17 (d), waited for: exit 0, each of ``DRYRUN_CELLS`` ``ok``
    but a skip ``cell_supported`` names, and no ok cell with an op this
    host's DTensor could not place (``dtensor_fallbacks``)."""
    from repro_torch.launch.shapes import cell_supported

    waited = time.time()
    proc.wait(timeout=900)
    secs, waited = time.time() - t0, time.time() - waited
    out = pathlib.Path(out_dir)
    if proc.returncode != 0:
        fail(f"phase 17 (d): the dry-run exited {proc.returncode}: "
             f"{(out / 'log').read_text()[-2000:]}")
    cells = {p.name: json.loads(p.read_text()) for p in sorted((out / "cells").iterdir())}
    status = {f"{c['arch']}:{c['shape']}": c["status"] for c in cells.values()}
    want = {f"{a}:{s}": "ok" if cell_supported(a, s)[0] else "skipped" for a, s in DRYRUN_CELLS}
    if status != want:
        fail(f"phase 17 (d): dry-run cells {status}, expected {want}")
    fallbacks = {f"{c['arch']}:{c['shape']}": c["cost"]["dtensor_fallbacks"]
                 for c in cells.values() if c["status"] == "ok"}
    if any(fallbacks.values()):
        fail(f"phase 17 (d): DTensor fallbacks under torch {torch_version()}: "
             f"{ {k: v for k, v in fallbacks.items() if v} }")
    terms = {f"{c['arch']}:{c['shape']}": (c["cost"]["collective_wire_bytes_per_device"],
                                           c["roofline"]["dominant"],
                                           c["roofline"]["bound_s"] * 1e3)
             for c in cells.values() if c["status"] == "ok"}
    log(f"phase 17 (d) dry-run CLI {' '.join(DRYRUN_ARGV)}: exit 0, {secs:.1f} s beside "
        f"phases 3-17 ({waited:.1f} s waited for in 17), torch {torch_version()}, cells "
        f"{status}, no DTensor fallback; (wire B a device, dominant term, bound ms) {terms}")
    return dict(seconds=secs, waited=waited, status=status, torch=torch_version(),
                cells={k: dict(roofline=v.get("roofline"), memory=v.get("memory"),
                               trace_s=v.get("trace_s"),
                               fallbacks=v.get("cost", {}).get("dtensor_fallbacks"),
                               wire=v.get("cost", {}).get("collective_wire_bytes_per_device"))
                       for k, v in cells.items()})


def shard_step_ms(torch, step, args, runs: int) -> float:
    """The median wall ms of ``runs`` calls of a step on one device's card
    shards (DTensors under ``implicit_replication``), each synchronized;
    the launches they make are not counted (``ops.LAUNCHES`` is read
    before)."""
    from torch.distributed.tensor.experimental import implicit_replication

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        with implicit_replication():
            step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _meta_card_cell(torch, ops, cfg, kernel: str, grid, kind: str, size, timed: bool,
                    tag: str) -> dict:
    """One step of phase 17 (e) on ``size`` ``(batch, seq)`` through
    ``launch.dryrun.step_parts`` over ``grid``, the arguments DTensors on
    ``meta`` shards, then on ``cuda:0`` shards, held meta = card (module
    docstring); with ``timed``, also the ms of one device's shard step on
    the card.  ``{"meta": row, "card": row}``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.analysis.cost import trace_cost
    from repro_torch.launch import dryrun, shapes
    from repro_torch.parallel import sharding

    axes = ("data", "model")
    meshes = {"meta": sharding.abstract_mesh_compat(grid, axes),
              "card": sharding.make_mesh_compat(grid, axes, devices=[DEVICE] * math.prod(grid))}
    b, s = size
    shape = shapes.ShapeSpec(kind, kind, s, b)
    mode = "train" if kind == "train" else "serve"
    rows = {}
    for where, mesh in meshes.items():
        parts = dryrun.step_parts(cfg, shape, mesh, mode)
        args = [dryrun.place_args(a, sh) for a, sh in zip(parts["args"], parts["shards"])]

        def step(*a, parts=parts):
            res = parts["step"](*a)
            return dryrun.place_outputs(res, parts["out_shards"](res))

        if where == "card":
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
        t0 = time.time()
        with implicit_replication():
            row = trace_cost(step, *args)
        if where == "card":
            torch.cuda.synchronize()
            row["peak_card"] = torch.cuda.max_memory_allocated() - held
            row["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
        row["trace_s"] = time.time() - t0
        if where == "card":
            # an op this torch's DTensor cannot place runs only under
            # the count's gathered fallback, which runs nowhere else
            if row["dtensor_fallbacks"]:
                fail(f"{tag}: DTensor fallbacks under torch {torch_version()}: "
                     f"{row['dtensor_fallbacks']}")
            row["step_ms"] = (shard_step_ms(torch, step, args, META_TIMED[kind]) if timed
                              else None)
        del row["out"], args
        rows[where] = row
    meta, card = rows["meta"], rows["card"]
    if meta["flops_per_device"] != card["flops_per_device"]:
        fail(f"{tag}: FLOPs meta {meta['flops_per_device']} != card "
             f"{card['flops_per_device']}")
    ratio = meta["bytes_per_device"] / card["bytes_per_device"]
    if abs(ratio - 1) > META_BYTES_RTOL:
        fail(f"{tag}: bytes meta / card {ratio:.5f} beyond {META_BYTES_RTOL}")
    if meta["num_ops"] != card["num_ops"]:
        diff = {k: (meta["op_counts"].get(k, 0), card["op_counts"].get(k, 0))
                for k in set(meta["op_counts"]) | set(card["op_counts"])
                if meta["op_counts"].get(k, 0) != card["op_counts"].get(k, 0)}
        fail(f"{tag}: ops meta {meta['num_ops']} != card {card['num_ops']} "
             f"(by name, meta / card: {diff}; fallbacks {meta['dtensor_fallbacks']} / "
             f"{card['dtensor_fallbacks']})")
    if (meta["collective_counts"] != card["collective_counts"]
            or meta["collective_wire_bytes_per_device"]
            != card["collective_wire_bytes_per_device"]):
        fail(f"{tag}: collectives meta {meta['collective_counts']} "
             f"{meta['collective_wire_bytes_per_device']} != card "
             f"{card['collective_counts']} {card['collective_wire_bytes_per_device']}")
    peak = meta["peak_live_bytes"] / card["peak_card"]
    if not META_PEAK_RANGE[0] <= peak <= META_PEAK_RANGE[1]:
        fail(f"{tag}: meta peak / card peak {peak:.3f} outside {META_PEAK_RANGE}")
    if card["launches"].get(kernel, 0) <= 0:
        fail(f"{tag}: no {kernel} launch on the card shards")
    step_ms = ("" if card["step_ms"] is None else
               f", one device's shard step {card['step_ms']:.2f} ms (median of "
               f"{META_TIMED[kind]})")
    log(f"{tag} (mesh {grid}, bf16, [{b}, {s}]): per device FLOPs "
        f"{meta['flops_per_device']:.6g}, bytes meta/card {ratio:.5f}, ops "
        f"{meta['num_ops']} on both, collectives {meta['collective_counts']} "
        f"wire {meta['collective_wire_bytes_per_device']:.6g} B on both, peak meta "
        f"{meta['peak_live_bytes'] / 2**30:.4f} / card {card['peak_card'] / 2**30:.4f} "
        f"GiB = {peak:.3f}, launches {card['launches']}, fallbacks "
        f"{card['dtensor_fallbacks']}, trace s meta {meta['trace_s']:.1f} card "
        f"{card['trace_s']:.1f}{step_ms}")
    out = {where: {k: r[k] for k in ("flops_per_device", "bytes_per_device", "num_ops",
                                     "collective_counts", "collective_wire_bytes_per_device",
                                     "peak_live_bytes", "dtensor_fallbacks", "trace_s")}
           for where, r in rows.items()}
    out["card"].update(peak_card=card["peak_card"], launches=card["launches"],
                       step_ms=card["step_ms"])
    return out


def meta_sharded(torch, ops) -> dict:
    """Phase 17 (e): each ``META_SHARDED`` arch's steps through
    ``launch.dryrun.step_parts`` over its mesh, the arguments DTensors on
    ``meta`` shards, then on ``cuda:0`` shards; then ``META_DEPTH``'s
    train step at two depths under each remat policy, its peak a layer on
    the card beside meta's (module docstring)."""
    from repro_torch.parallel import sharding

    out: dict = {}
    launches = {k: 0 for k in ops.LAUNCHES}
    try:
        cells = [(arch, kernel, grid, kind, META_TRAIN if kind == "train" else META_PREFILL,
                  None, META_SHARDED_LAYERS, True)
                 for arch, (kernel, grid, kinds) in META_SHARDED.items() for kind in kinds]
        arch, kernel, grid, size, depths, policies = META_DEPTH
        cells += [(arch, kernel, grid, "train", size, remat, layers, False)
                  for remat in policies for layers in depths]
        for arch, kernel, grid, kind, size, remat, layers, timed in cells:
            cfg = lm_config(arch, num_layers=layers)
            name = f"{arch} {kind}"
            if remat is not None:
                cfg = dataclasses.replace(cfg, remat=remat)
                name += f" {remat} {layers} layers"
            out[name] = _meta_card_cell(torch, ops, cfg, kernel, grid, kind, size, timed,
                                        f"phase 17 (e) {name}")
            for k, v in out[name]["card"]["launches"].items():
                launches[k] += v
        arch, _, _, _, (lo, hi), policies = META_DEPTH
        for remat in policies:
            cut = [out[f"{arch} train {remat} {n} layers"] for n in (lo, hi)]

            def per_layer(where: str, key: str, cut=cut) -> float:
                return (cut[1][where][key] - cut[0][where][key]) / (hi - lo)

            meta, card = per_layer("meta", "peak_live_bytes"), per_layer("card", "peak_card")
            ratio = meta / card
            out[f"{arch} train {remat} a layer"] = dict(meta=meta, card=card, ratio=ratio)
            log(f"phase 17 (e) {arch} train {remat}: peak a layer ({lo} -> {hi} layers) meta "
                f"{meta / 2**20:.3f} / card {card / 2**20:.3f} MiB = {ratio:.3f}")
            if not META_PEAK_RANGE[0] <= ratio <= META_PEAK_RANGE[1]:
                fail(f"phase 17 (e) {arch} train {remat}: meta / card peak a layer "
                     f"{ratio:.3f} outside {META_PEAK_RANGE}")
    finally:
        sharding.close_fake_world()
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def cp_layer(torch, ops) -> dict:
    """Phase 17 (f): one SmolLM-360M attention layer (``wq``/``wk`` scaled
    as ``rescale_qk`` does) at full width on ``CP_X`` tokens on the card,
    in f32 and bf16: the unsplit layer through ``FlashAttention`` and
    ``wo``, then its flash call split into ``CP_TP`` blocks of query rows,
    each shard through ``flash_rows`` and ``flash_rows_backward`` at its
    coordinate with the unsplit call's upstream gradient of its rows
    (module docstring)."""
    from repro_torch.models import attention, blocks
    from repro_torch.models.common import dense, init_params

    cfg = lm_config("smollm-360m")
    b, s = CP_X
    m, scale = s // CP_TP, cfg.head_dim ** -0.5
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        gen = torch.Generator(device=DEVICE).manual_seed(28)
        p = rescale_qk(cfg, init_params(blocks.attn_specs(cfg, 1), gen, dtype, DEVICE))
        p = {k: t[0] for k, t in p.items()}
        x = torch.randn((b, s, cfg.d_model), generator=gen, device=DEVICE).to(dtype)
        positions = torch.arange(s, device=DEVICE)[None].expand(b, s)
        with torch.no_grad():
            q, k = blocks._rope_q_k(cfg, dense(x, p["wq"]), dense(x, p["wk"]), positions)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, dense(x, p["wv"])))
        before = ops.LAUNCHES["flash_attention"]
        leaves = [t.requires_grad_() for t in (qt.clone(), kt.clone(), vt.clone())]
        o = attention.FlashAttention.apply(*leaves, True, scale, 1024)
        y = blocks._out_proj(o.transpose(1, 2), p["wo"], dtype)
        dy = torch.randn(y.shape, generator=gen, device=DEVICE).to(dtype)
        dout, *want = torch.autograd.grad(y, [o] + leaves, dy)
        got = {"y": [], "dq": [], "dk": 0, "dv": 0}
        with torch.no_grad():
            for r in range(CP_TP):
                rows = slice(r * m, (r + 1) * m)
                o_r, lse_r = attention.flash_rows(qt[:, :, rows], kt, vt, r, CP_TP, causal=True,
                                                  scale=scale, return_lse=True)
                got["y"].append(blocks._out_proj(o_r.transpose(1, 2), p["wo"], dtype))
                dq, dk, dv = attention.flash_rows_backward(
                    qt[:, :, rows], kt, vt, o_r, lse_r, dout[:, :, rows], r, CP_TP,
                    causal=True, scale=scale)
                got["dq"].append(dq)
                got["dk"], got["dv"] = got["dk"] + dk.float(), got["dv"] + dv.float()
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["flash_attention"] - before
        if launches != 1 + CP_TP:
            fail(f"phase 17 (f) {name}: {launches} flash launches, expected one unsplit "
                 f"and one a shard ({1 + CP_TP})")
        pairs = {"y": (torch.cat(got["y"], dim=1), y), "dq": (torch.cat(got["dq"], dim=2), want[0]),
                 "dk": (got["dk"], want[1]), "dv": (got["dv"], want[2])}
        rel = {k_: float((a.float() - w.detach().float()).norm() / w.detach().float().norm())
               for k_, (a, w) in pairs.items()}
        bar = CP_REL_L2[name]
        if not all(e <= bar for e in rel.values()):
            fail(f"phase 17 (f) {name}: shards put together against the unsplit layer, "
                 f"rel L2 {rel} beyond {bar}")
        log(f"phase 17 (f) SmolLM-360M attention layer {name} [{b}, {s}], {CP_TP} row shards "
            f"on the card: rel L2 against the unsplit layer {rel} (bar {bar}); flash launches "
            f"{launches}")
        out[name] = dict(rel_l2=rel, bar=bar, launches=launches)
    out["launches"] = {"flash_attention": sum(v["launches"] for v in out.values())}
    return out


def meta_phase(torch, ops, dryrun: tuple) -> dict:
    """Phase 17: the meta passes. (a) the expert-parallel MoE branch, (b) a
    prefill through it, (c) the meta pass's count against card steps,
    (d) the dry-run's CLI, in a process of its own started after the build
    (``dryrun``: :func:`dryrun_start`'s), (e) the per-device count on meta
    and card shards, (f) an attention layer's row shards on the card.
    Every kernel launch of (b), (c), (e) and (f) counted."""
    timer = DeviceTimer(torch)
    log("meta passes: phase 17")
    out = {"expert_parallel": ep_phase(torch, timer)}
    out["prefill"] = ep_prefill(torch, ops)
    launches = {k: 0 for k in ops.LAUNCHES}
    launches["flash_attention"] += sum(out["prefill"]["flash_launches"].values())
    for arch, layers in META_CELLS.items():
        cells = out[f"cost {arch}"] = meta_cell(torch, ops, arch, layers)
        for row in cells.values():
            for k, n in row["launches"].items():
                launches[k] += n
    out["sharded"] = meta_sharded(torch, ops)
    for k, n in out["sharded"]["launches"].items():
        launches[k] += n
    out["context_parallel"] = cp_layer(torch, ops)
    launches["flash_attention"] += out["context_parallel"]["launches"]["flash_attention"]
    out["dryrun"] = dryrun_finish(*dryrun)
    out["launches"] = launches
    return out


# -- phase 18: the twin's user-facing examples ---------------------------------

#: the examples of ``examples/`` with a torch side that phase 18 runs, each
#: by its ``main`` at its defaults (the JAX example's sizes), with the kernels
#: it must launch on the card
EXAMPLES = {
    "quickstart_torch": ("calib_mape_grid", "des_readout", "des_place"),
    "reproduce_footprinter_torch": ("des_readout", "des_place"),
    "fleet_of_twins_torch": ("calib_mape_grid", "des_readout"),
    "whatif_scaling_torch": ("des_place",),
    "twin_service_torch": ("calib_mape_grid", "des_readout"),
}
#: arguments beyond ``--device`` (none: each example's own defaults)
EXAMPLE_ARGV: dict = {}
#: the what-if example's CPU rerun is its sweep alone (``setup`` and
#: ``sweep``): the 19 candidates' summaries.  Its search, at the same size
#: and space, is held card against CPU in phase 11 (c); rerun here on the
#: CPU it took 60 s more on the card host
WHATIF_EXAMPLE = "whatif_scaling_torch"


def des_roofline_phase(torch, ops) -> dict:
    """Phase 19: ``analysis/roofline_torch.py`` on the card at
    ``DES_ROOFLINE_DAYS``, then its counts on the CPU (module docstring)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("roofline_torch",
                                                  ROOT / "analysis" / "roofline_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ops.reset_launches()
    t0 = time.time()
    card = mod.analyze_des_hot_path(DES_ROOFLINE_DAYS, device=DEVICE)
    launches = dict(ops.LAUNCHES)
    card_s = time.time() - t0
    t0 = time.time()
    cpu = mod.phase_costs(DES_ROOFLINE_DAYS, device="cpu")
    cpu_s = time.time() - t0
    log(f"phase 19 DES roofline, {card['t_bins']} bins x {card['num_hosts']} hosts, "
        f"{card['jobs']} jobs, on the card ({card_s:.1f} s; the CPU's counts {cpu_s:.1f} s):")
    for line in mod.table(card).splitlines():
        log(f"  {line}")
    for p in card["phases"]:
        c = cpu[p["name"]]
        if (p["flops"], p["bytes"]) != (c["flops_per_device"], c["bytes_per_device"]):
            fail(f"phase 19 {p['name']}: card FLOPs/bytes {p['flops']} / {p['bytes']} != CPU "
                 f"{c['flops_per_device']} / {c['bytes_per_device']}")
        if p["wall_s"] < p["bound_s"]:
            fail(f"phase 19 {p['name']}: wall {p['wall_s']} s under its bound {p['bound_s']} s")
    if launches["des_place"] <= 0:
        fail("phase 19: no des_place launch")
    log(f"phase 19: FLOPs and bytes equal on the card and the CPU in every phase, wall >= "
        f"bound; launches {({k: v for k, v in launches.items() if v})}")
    return dict(result=card, cpu={k: {f: v[f] for f in ("flops_per_device", "bytes_per_device",
                                                       "num_ops")} for k, v in cpu.items()},
                launches=launches, card_s=card_s, cpu_s=cpu_s)


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(torch, ops, fn, device: str) -> dict:
    """``fn(device)`` (an example's ``main`` or part of it), its printed
    lines kept: the result, wall seconds, kernel launches (reset just
    before, read just after) and the schedule (``job_start``,
    ``job_host``) of every ``des_place`` call."""
    import contextlib
    import io

    schedules, real = [], ops.des_place

    def recorded(*args, **kw):
        out = real(*args, **kw)
        schedules.append(out[:2])
        return out

    buf = io.StringIO()
    ops.des_place = recorded
    try:
        ops.reset_launches()
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            res = fn(device)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        ops.des_place = real
    return dict(result=res, wall_s=wall, launches=launches, lines=buf.getvalue().splitlines(),
                schedules=[[t.cpu() for t in pair] for pair in schedules])


def _close(a, b, rtol=1e-5) -> bool:
    import numpy as np

    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return a.shape == b.shape and bool(np.allclose(a, b, rtol=rtol, atol=0.0, equal_nan=True))


def _run_params(records):
    import numpy as np

    return np.array([[float(getattr(r.params, f)) for f in ("p_idle", "p_max", "r")]
                     for r in records])


def _summary_diff(a, b) -> "str | None":
    """The first field where two ``ScenarioSummary`` differ: integers and
    strings exactly, floats at rtol 1e-5 (NaN where NaN)."""
    for f, va in a.__dict__.items():
        vb = b.__dict__[f]
        if isinstance(vb, float):
            if not _close(va, vb):
                return f"{a.name}.{f}: {va} vs {vb}"
        elif va != vb:
            return f"{a.name}.{f}: {va} vs {vb}"
    return None


def example_diff(torch, name: str, card: dict, cpu: dict) -> "str | None":
    """Where the card's run of an example departs from the CPU rerun's, or
    None: schedules equal, parameter streams exact, MAPE streams and other
    floats within rtol 1e-5, counts and cache hits equal, the service's
    evicted (restored) state equal bit for bit."""
    import numpy as np

    a, b = card["result"], cpu["result"]
    # the what-if example's CPU rerun is its sweep: the card's first call
    n = 1 if name == WHATIF_EXAMPLE else len(card["schedules"])
    if len(cpu["schedules"]) != n or not all(
            torch.equal(x, y) for p, q in zip(card["schedules"], cpu["schedules"])
            for x, y in zip(p, q)):
        return "des_place schedules differ"
    if name == "quickstart_torch":
        a, b = a.result, b.result
        if len(a.records) != len(b.records):
            return "windows differ"
        if not np.array_equal(_run_params(a.records), _run_params(b.records)):
            return "parameter stream differs"
        if not _close(a.per_window_mape, b.per_window_mape):
            return "MAPE stream beyond rtol 1e-5"
        if [r.met for r in a.slo_reports] != [r.met for r in b.slo_reports]:
            return "SLO verdicts differ"
    elif name == "reproduce_footprinter_torch":
        for k in ("per_window_mape", "footprinter_mape", "opendt_mape", "mean_utilization",
                  "peak_tflops_hour", "best_efficiency_tflops_per_kwh"):
            if not _close(a[k], b[k]):
                return f"{k} beyond rtol 1e-5"
    elif name == "fleet_of_twins_torch":
        if not _close(a.mape, b.mape):
            return "MAPE streams beyond rtol 1e-5"
        for f in ("p_idle", "p_max", "r"):
            if not torch.equal(getattr(a.outputs.params_next, f).cpu(),
                               getattr(b.outputs.params_next, f)):
                return f"parameter stream {f} differs"
    elif name == WHATIF_EXAMPLE:
        if len(a.summaries) != len(b) or len(b) != 19:
            return f"{len(a.summaries)} and {len(b)} summaries, not 19"
        for x, y in zip(a.summaries, b):
            bad = _summary_diff(x, y)
            if bad:
                return f"summary {bad}"
    elif name == "twin_service_torch":
        counts = ("windows_cached", "hit_rate", "restored", "new_windows", "stale_dropped",
                  "next_window", "bitwise_same")
        for k in counts:
            if getattr(a, k) != getattr(b, k):
                return f"{k}: {getattr(a, k)} vs {getattr(b, k)}"
        for ra, rb in zip(a.results_a + a.results_b, b.results_a + b.results_b):
            if (ra.tenant, ra.window, ra.cached) != (rb.tenant, rb.window, rb.cached):
                return "served windows differ"
            pa, pb = ra.output.params_next, rb.output.params_next
            if any(not np.array_equal(getattr(pa, f), getattr(pb, f))
                   for f in ("p_idle", "p_max", "r")):
                return f"{ra.tenant} w{ra.window}: parameters differ"
            if not _close(ra.output.mape, rb.output.mape):
                return f"{ra.tenant} w{ra.window}: MAPE beyond rtol 1e-5"
        for run in (a, b):
            if not all(np.array_equal(x, y) for x, y in zip(run.evicted, run.checkpointed)):
                return "an evicted state differs from its checkpoint"
        if not all(np.array_equal(x, y) for x, y in zip(a.evicted, b.evicted)):
            return "restored states differ in their bits"
    return None


def example_counts_diff(name: str, run: dict) -> "str | None":
    """The launches each example's path must make on the card, or None."""
    n, res = run["launches"], run["result"]
    if any(n[k] <= 0 for k in EXAMPLES[name]):
        return f"launches {n}: each of {EXAMPLES[name]} expected"
    want = {}
    if name == "quickstart_torch":
        want = dict(des_place=2, des_readout=len(res.result.records))
    elif name == "reproduce_footprinter_torch":
        want = dict(des_place=3, des_readout=len(res["per_window_mape"]))
    elif name == "fleet_of_twins_torch":
        want = dict(des_readout=res.mape.shape[0], calib_mape_grid=res.mape.shape[0])
    elif name == WHATIF_EXAMPLE:
        want = dict(des_place=1 + res.search.batches, des_readout=0)
    elif name == "twin_service_torch":
        want = dict(calib_mape_grid=n["des_readout"])
    bad = {k: (n[k], v) for k, v in want.items() if n[k] != v}
    return f"launches {n}, expected {want}" if bad else None


def examples_phase(torch, ops, card: str) -> dict:
    """Phase 18: each example's ``main`` on the card at its defaults, then
    on the CPU, held against each other (``example_diff``), with its wall
    seconds and kernel launches."""
    log("user-facing examples: phase 18")
    out: dict = {}
    launches = {k: 0 for k in ops.LAUNCHES}
    for name in EXAMPLES:
        mod = load_example(name)
        argv = EXAMPLE_ARGV.get(name, [])

        def main_on(device, mod=mod, argv=argv):
            return mod.main(["--device", device] + argv)

        def sweep_on(device, mod=mod, argv=argv):
            days = float(argv[argv.index("--days") + 1]) if "--days" in argv else mod.DAYS
            return mod.sweep(*mod.setup(days, device))

        gpu = run_example(torch, ops, main_on, DEVICE)
        bad = example_counts_diff(name, gpu)
        if bad:
            fail(f"phase 18 {name}: {bad}")
        cpu = run_example(torch, ops, sweep_on if name == WHATIF_EXAMPLE else main_on, "cpu")
        bad = example_diff(torch, name, gpu, cpu)
        if bad:
            fail(f"phase 18 {name}: card and CPU rerun differ: {bad}")
        for k, v in gpu["launches"].items():
            launches[k] += v
        shown = [line for line in gpu["lines"] if line.strip()][-3:]
        log(f"phase 18 {name}: card {gpu['wall_s']:.3f} s, CPU rerun {cpu['wall_s']:.3f} s, "
            f"launches {gpu['launches']}, equal to the CPU rerun ({card}); last lines: "
            + " | ".join(shown))
        out[name] = dict(wall_s=gpu["wall_s"], cpu_wall_s=cpu["wall_s"],
                         launches=gpu["launches"], des_place_calls=len(gpu["schedules"]),
                         lines=gpu["lines"])
    out["launches"] = launches
    return out


if __name__ == "__main__":
    sys.exit(main())
