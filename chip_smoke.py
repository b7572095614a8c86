#!/usr/bin/env python3
"""Smoke run of the PyTorch port (align_anything_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one H100

Phases (any failure raises and the run exits non-zero):
  0. require a CUDA device; print the card's name and power limit, and
     whether Pillow imports;
  1. build the hand-written kernels from csrc/ with nvcc (sm_90a), one nvcc
     per source, started together; count the tensor-core instructions
     (HMMA) in each instance of K2's kernel and of its A/B variants v1 and
     v2, the same kernel body (``cuobjdump -sass``), which must have some,
     and print each instance's registers and spills;
  2. hold the int4 matmul kernel against its plain PyTorch version at the
     serving path's shapes (Llama-3-8B widths) and M 1-128, with each
     launch repeated bit for bit and the split of K printed, and time
     both, beside the bound and PyTorch's own int4 GEMM; time the 'o'
     projection in ``quantize_decoder_int4``'s layout (grouped over heads,
     dequantized per call) against the flattened layout K2 takes;
  2ab. the A/B variants of that kernel (``scripts/bench/
     bench_int4_kernel_ab.py``, v1 and v2): each held against its plain
     version at the A/B's three shapes and M 1, 32 and 128 (the split of
     K printed), two launches bit-equal, two negative controls refused by
     the same check (K2's output against v1's plain version; v2 without
     its correction); then the timed A/B at M 32 through the bench's own
     ``run``;
  3. build Llama-3-8B-geometry int4-COMPUTE weights on the card from a seed,
     layer by layer, without holding the fp model;
  4. serve ~48 requests through the continuous-batching engine's serving
     mode in a worker thread, as the HTTP server's worker does; check every
     request's budget, the kernel's launch count, and one decode step
     against the plain int4 path;
  5. report the flash-attention kernels' registers, spills and shared
     memory, and count the tensor-core instructions (HMMA / HGMMA) in each
     kernel's SASS (``cuobjdump -sass``): the bf16 forward, dK/dV and dQ
     kernels at D 64 and D 128 must have some;
  6. hold the flash-attention forward (out, lse) and backward (dq, dk, dv)
     against their plain versions at the training shapes, at the edges
     of the kernels' tiles and at PPO's mask pattern (leading and trailing
     pads; query rows that see no key give exact zeros; text PPO's and
     phase 20's scoring shape, ``ti2t_ppo``: L 1152 at LLaVA's heads),
     check that the backward repeats bit for bit, and time kernel, plain
     version and ``scaled_dot_product_attention`` (a yardstick only) at the
     two main shapes, at phase 16's (Qwen2.5-0.5B's heads), at phase 18's
     tower (full attention at L 577), at ``ti2t_ppo`` and at Gemma-3-1B's
     DPO micro-batch (L 2048, 4 / 1 heads of 256) with the window 512 and
     without;
  7. DPO training at Llama-3-8B widths, depth cut to 4 layers (fp32 params,
     grads and AdamW moments of all 32 layers would not fit in 80 GB):
     4 steps of ``DPOStep.step`` with remat 'dots_saveable'; step 1's
     loss is ln 2, the attention kernels run on every layer of every step,
     and step 1 recomputed with the kernels patched to their plain versions
     agrees;
  8. ``bench.py``'s DPO config at its shape (0.4 B params, 6 pairs, seq
     1024), timed: tokens/s per GPU and MFU;
  9. the trainer harness at phase 7's shape: a Llama-3-8B-width checkpoint
     cut to 4 layers written from a seed with the port's ``save_params``
     (bf16 safetensors in HF layout) and PKU-SafeRLHF-schema rows in a
     ``.jsonl``, then DPO through ``trainer_main`` with a user's command
     line (remat 'dots_saveable' from the port's one-GPU parallel config,
     ``MESH_FILE``); step 1's loss is ln 2, every loss and grad norm
     finite, the attention kernels run on every layer of every step; the
     step time, tokens/s and peak memory beside phase 7's;
 10. the harness at bench.py's widths cut to 2 layers: the HF slice export
     read back bit-equal, a run resumed from its step-2 train state
     against the uninterrupted run (bit-equal, or within phase 7's 2e-4),
     SFT's step 1 against a plain recompute, ORPO and SimPO;
 11. the reward model at Llama-3-8B widths cut to 2 layers through
     ``trainer_main(RMTrainer, ...)`` (a bf16 checkpoint written from a
     seed, 8 pairs in the 512 bucket, 4 steps): every loss and grad norm
     finite, the attention kernels on every layer of every step, step 1's
     end scores against a plain recompute, the slice and ``score_head.npy``
     written, and ``rm_score`` over the export against the trained model;
 12. PPO at the same widths through ``trainer_main(PPOTrainer, ...)``: the
     actor from phase 11's checkpoint, reward and critic from its export;
     16 prompts in the 128 bucket, 8 a round, 128 new tokens, micro-batch
     4: two rounds on the 'batch' rollout, then one on 'continuous'; round
     1's KL exactly 0, every metric finite, round 1's scoring pass against
     a plain recompute, the kernels on every layer of every model pass; the
     round's wall clock split into rollout, scoring and update, generated
     tokens/s and peak memory;
 13. at bench.py's widths, 2 layers: the cost model, PPO with the
     generation eval, PPO with PTX, and multi-sample PPO with RLOO;
 14. KTO through ``trainer_main(KTOTrainer, ...)`` on phase 9's checkpoint
     and rows (Llama-3-8B widths, 4 layers, 4 steps of 2 pairs, the KL
     baseline refreshed before step 3): the baseline at init exactly 0,
     step 1's loss 0 to 1e-6, the refreshed baseline finite and >= 0, the
     attention kernels on every layer of every pass (the KL passes too),
     exactly, and step 1's log-prob sums against a plain recompute; the
     step time, the refresh step's extra time and peak memory;
 15. GRPO from phase 11's checkpoint and export (4 prompts x 4
     generations a round, 128 new tokens, 2 rounds): round 1's KL 0 to
     1e-6, every metric finite, the kernels' launches exact, round 1's
     reward end scores against a plain recompute; the round's split,
     generated tokens/s and peak memory;
 16. Safe-RLHF at Qwen2.5-0.5B's full size (24 layers, D 64, 14 / 2
     heads; six models; 8 prompts a round, micro-batch 4, 2 rounds): round
     1's KL exactly 0, ``log_lambda`` after round 1 against its closed
     form, every metric finite, the kernels' launches exact, round 1's
     log-prob sums, reward, cost and value scores against a plain
     recompute; the round's split, generated tokens/s and peak memory;
 17. at bench.py's widths, 2 layers: PPO against the port's reward server
     (stdlib, a daemon thread on a free port of 127.0.0.1) for one round,
     each reward the ``example_length`` rule over the decoded texts; PPO
     with the continuous rollout by default for one round (round 1's KL
     exactly 0); one step each of KTO and GRPO;
 18. TI2T DPO through ``trainer_main(TI2TDPOTrainer, ...)`` at
     LLaVA-1.5-7B widths (the language model cut to 4 layers, the CLIP
     ViT-L/14-336 tower at its 24 layers, frozen): a bf16 LLaVA-layout
     checkpoint written from a seed with the port's exporter, AA_TI2T rows
     with 336x336 images (PNG files where Pillow imports, else arrays), 4
     steps of 2 pairs in the 1024 bucket: step 1's loss ln 2, the tower
     bit-equal after the run while the language model and projector move,
     the attention kernels' launches exact, step 1's log-prob sums against
     a plain recompute; the step time, tokens/s and peak memory;
 18b. TI2T SFT at the same widths, 2 text and 4 tower layers: with the
     tower trained (its full-mode backward launched) and with the tower and
     projector frozen (both bit-equal); launches exact;
 19. the TI2T reward model through ``trainer_main(TI2TRMTrainer, ...)`` at
     LLaVA-1.5-7B widths, the text model cut to 2 layers, the 24-layer
     tower frozen: 8 AA_TI2T preference rows with PNG images, 4 steps of 2
     pairs in the 1024 bucket; every loss finite, the tower bit-equal,
     step 1's end scores against a plain recompute, launches exact, 576
     image tokens a row (ROADMAP R12), the export and ``score_head.npy``
     written; step time, peak memory and the bytes written;
 20. TI2T PPO through ``trainer_main(TI2TPPOTrainer, ...)`` at the same
     widths: the actor from phase 19's checkpoint, reward model and critic
     from its export; 24 image prompts, 8 a round, 128 new tokens,
     micro-batch 4, three rounds; round 1's KL exactly 0, 576 image tokens
     a prompt, the image prefill's first decode logits against the model
     without a cache, round 1's scoring log-prob sums and rewards against a
     plain recompute, launches exact, and every module of actor and critic
     moved (the tower too, as in JAX: ROADMAP R13); the round split into
     rollout, scoring and update, generated tokens/s and peak memory;
 21. at phase 18b's depth: the TI2T cost model, Safe-RLHF-V (round 1's
     ``log_lambda`` = ``lambda_lr`` x episode cost), GRPO with 2
     generations a prompt (round 1's KL 0), KTO, ORPO and SimPO through
     their entry points; every metric finite, launches exact;
 22. QLoRA DPO at Llama-3-8B's full size, all 32 layers, through
     ``trainer_main(DPOTrainer, ...)`` from the 'llama-3-8b' preset (fp32
     weights from the trainer's seed on the card), the base quantized by
     ``init_peft``: int4 (group 64, weight-only, the head int4, the
     embedding fp32), adapters on q_proj and v_proj (r 16, alpha 16),
     phase 9's rows, 2 pairs in the 1024 bucket, 4 steps at a LoRA
     learning rate, remat 'dots_saveable'; then 2 steps over an int8 base.
     Step 1's loss ln 2, the base bit-unchanged and every adapter moved,
     launches exact; the trained adapters' forward through the kernels
     against the plain attention (``check_sums``) and, in fp32, against
     ``merge_lora``'s dense tree; the step time, tokens/s, peak memory
     and the base, adapter and AdamW bytes;
 23. at phase 10's depth: the int8-COMPUTE product exact at 8B shapes;
     SFT, DPO, ORPO, SimPO, KTO (no KL batch), the RM, the cost model, PPO
     on 'batch', ``ppo_vllm`` on 'continuous' and multi-PPO with LoRA, and
     DPO, the RM and PPO over int4 and int8 bases, through their entry
     points: step 1's invariants (DPO ln 2, PPO's KL exactly 0), every B
     moved, the base equal to a fresh quantization of the checkpoint, the
     merged exports read back as ``merge_lora`` of the trained adapters, a
     QLoRA resume against the uninterrupted run; KTO with a KL batch,
     Safe-RLHF and remote-RM PPO refuse LoRA, as JAX's trainers fail;
 24. DPO at Gemma-3-1B's full size (google/gemma-3-1b-pt's config.json,
     26 layers, 22 of them sliding with the window 512) through
     ``trainer_main(DPOTrainer, ...)``: a bf16 checkpoint from a seed under
     HF's Gemma3 tensor names, 2 pairs in the 2048 bucket, 4 steps, remat
     'dots_saveable'; the loaded tree bit-equal to the written one, step
     1's loss ln 2, launches exact and split by window, step 1's log-prob
     sums against a plain recompute; step time, tokens/s and peak memory;
 25. greedy generation from that checkpoint, 16 prompts of 600-900 tokens
     and 64 new tokens, through ``generate`` and the continuous engine (8
     slots, max_len 1024): the batch prefill's last logits against the
     training forward through the kernel with the window, within the plain
     pass's bf16 noise; both engines give the same tokens in fp32 compute;
     generated tokens/s and peak memory (bf16);
 26. the ten remat policies at phase 7's shape, 1 warm-up and 2 timed steps
     each: losses and grad norms within phase 7's limit of 'none''s,
     launches exact (the policies that keep the kernel's (out, lse) re-run
     no forward); step time and peak memory per policy;
 27. at phase 10's widths, DPO through the trainer's loop with the train
     state (1.2 GB) saved at step 3 with ``wait=True`` and at step 6 with
     ``wait=False``: the save call's time and the loop's step time with
     each, and each save restored bit-equal to the state at its call.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit from nvidia-smi, and the one before that a
JSON summary of each kernel.

    python3 chip_smoke.py --profile [dpo ppo ti2t qlora gemma3]
                                      # instead: trace one DPO step of the
                                      # phase 7 and phase 8 configs, one
                                      # PPO round of phase 12's, one TI2T
                                      # DPO step of phase 18's, one
                                      # QLoRA DPO step of phase 22's and
                                      # one Gemma-3-1B DPO step and
                                      # generate call of phases 24-25's (the
                                      # ones named; all by default)

``--profile`` runs no checks: after a warm-up step it traces one step of
each DPO config with ``torch.profiler`` and prints device time by kernel,
grouped, and the device's idle share of the step; then, after a warm-up
round, a PPO round at phase 12's config in three windows (the rollout's
``generate``, the scoring pass, the update).

    python3 chip_smoke.py --planted-faults

builds three broken copies of ``flash_attention.cu`` (64 keys or one
64-row query tile skipped for the second half of the rows, in the bf16
tensor-core forward, dQ or dK/dV kernel) into the gitignored build
directory, and fails unless phase 6's check passes
the kernel as written and fails each broken copy; it also prints phase
7's step-1 recompute under each build.

    python3 chip_smoke.py --tile-sweep 'FMB=1,KMB=1,QMB=1/' '/FMI=1'

builds the kernels once per spec, each overriding fields of the tensor-
core kernels' ``WgTiles<64>`` / ``WgTiles<128>`` (D 64 fields / D 128
fields), and times each kernel at phase 6's two timed shapes.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import sys
import tempfile
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

import align_anything_tpu_torch
from align_anything_tpu_torch.generation import (ContinuousBatchingEngine,
                                                 GenerationConfig)
from align_anything_tpu_torch.models import llama_config, transformer
from align_anything_tpu_torch.models import quantization as q
from align_anything_tpu_torch.ops import flash_attention as fa
from align_anything_tpu_torch.ops import int4_matmul as k2
from align_anything_tpu_torch.scripts.bench import bench_int4_kernel_ab as ab
from align_anything_tpu_torch.scripts.bench.timing_utils import (
    PEAK_FLOPS, bound, gpu_name_and_power, int4_library_ms, l2_flush_buffer,
    time_ms)
from align_anything_tpu_torch.trainers.optimizer import (global_norm,
                                                          make_optimizer)
from align_anything_tpu_torch.trainers.text_to_text.dpo import DPOStep
from align_anything_tpu_torch.utils.tools import param_leaves, tree_map

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DECODE_SLOTS = 32
MAX_LEN = 256
CHUNK_STEPS = 8
NEW_TOKENS = 64
N_BATCHES, PER_BATCH = 3, 16   # requests arrive in 3 batches of 16
GROUP = 64
# (name, K, N) of every int4 matmul in one decode step at Llama-3-8B widths
SHAPES = [('qkv', 4096, 6144), ('o', 4096, 4096), ('gate_up', 4096, 28672),
          ('down', 14336, 4096), ('head', 4096, 128256)]
TOL = {'bfloat16': 1e-2, 'float32': 1e-4}   # x max|plain|
# phase 2's row counts: each checked against the plain version with a
# bit-for-bit repeat; the decode step is timed at TIMED_ROWS
CHECK_ROWS = (1, 16, 17, 32, 33, 128)
TIMED_ROWS = (1, 32, 128)
# the A/B's relerr (max|o - o0| / max|fp32 reference|): v1 and v2 round
# the scale to bf16 where v0 does not, so they sit a few bf16 ulps from
# v0 at the max; v2 without its correction reads about 1
AB_RELERR_TOL = 2e-2
# flash attention at the training path's shapes, then at the edges of the
# tensor-core kernels' 64-row tiles: (name, B, L, H, KH, D, causal,
# window, padded rows, padded keys per such row (None: 100-200 from the
# seed), dtype, timed)
FLASH_SHAPES = [
    ('bench', 12, 1024, 16, 8, 64, True, None, 0, None, torch.bfloat16, True),
    ('llama8b', 4, 1024, 32, 8, 128, True, None, 2, None, torch.bfloat16,
     True),
    ('d256', 2, 512, 8, 4, 256, True, None, 1, None, torch.bfloat16, False),
    ('window256', 2, 1024, 16, 8, 64, True, 256, 1, None, torch.bfloat16,
     False),
    ('full', 2, 1024, 16, 8, 128, False, None, 1, None, torch.bfloat16,
     False),
    ('ragged1000', 2, 1000, 16, 8, 128, True, None, 1, None, torch.bfloat16,
     False),
    ('fp32', 2, 512, 8, 4, 128, True, None, 1, None, torch.float32, False),
    ('L17', 2, 17, 16, 8, 128, True, None, 1, 5, torch.bfloat16, False),
    ('L129', 2, 129, 16, 8, 64, True, None, 1, 9, torch.bfloat16, False),
    ('window200', 2, 1024, 16, 8, 128, True, 200, 1, None, torch.bfloat16,
     False),
    ('G1', 2, 512, 8, 8, 128, True, None, 1, None, torch.bfloat16, False),
    ('G8', 2, 512, 16, 2, 64, True, None, 1, None, torch.bfloat16, False),
    # the last row's last key tile is all padding, the tile before it none
    ('padtile', 2, 1024, 16, 8, 128, True, None, 1, 64, torch.bfloat16,
     False),
    # phase 16's micro-batch: Qwen2.5-0.5B's heads (a GQA group of 7)
    ('qwen05b', 4, 256, 14, 2, 64, True, None, 2, None, torch.bfloat16,
     True),
    # phase 18's tower: CLIP ViT-L/14 at 336 px, full (non-causal)
    # attention over 576 patches + the class token (not a multiple of the
    # kernels' tiles: only the kernels' key bounds hide the keys past L)
    ('vit336', 8, 577, 16, 16, 64, False, None, 0, None, torch.bfloat16,
     True),
    # phase 24's micro-batch: Gemma-3-1B's heads (one KV head for four
    # query heads, D 256: the CUDA-core kernels), its 22 sliding layers'
    # window 512 and its 4 full layers
    ('gemma3_1b_w512', 4, 2048, 4, 1, 256, True, 512, 2, None,
     torch.bfloat16, True),
    ('gemma3_1b', 4, 2048, 4, 1, 256, True, None, 2, None, torch.bfloat16,
     True),
]
# x each row's max|plain| (row_scaled_error).  bf16: kernel and plain
# version round P (and dS) to bf16 at K1a's places, but the forward kernel
# rounds P = exp(s - m) against its running max m and the plain version
# against the row's final max, and their fp32 sums run in other orders:
# some of P's roundings differ in the last place, and the results, each
# rounded to bf16 once, differ by about one ulp, 2^-8 to 2^-7 of the
# row's max.  The limit leaves 2.5x room over that; a skipped tile reads
# 0.8 or more (--planted-faults).
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3
DPO_LAYERS, DPO_PAIRS, DPO_SEQ, DPO_STEPS = 4, 2, 1024, 4
# step 1 through the kernels against the same step through the plain
# attention, relative: per-sequence response log-prob sums, and the grad
# norm.  The grad norm follows the forward: the tensor cores' S (bf16
# products summed in fp32 inside the MMA) moves it by about 1e-4 against
# the plain fp32 einsum (the CUDA-core kernel read 7e-7), so its limit is
# 2e-4, not 2e-5; with 64 keys (or one 64-row query tile) skipped in any
# one attention kernel for half the rows (--planted-faults) it moved by
# 2e-3 or more, 10x that.
DPO_SUM_TOL, DPO_NORM_TOL = 2e-4, 2e-4
BENCH_PAIRS, BENCH_SEQ, BENCH_STEPS = 6, 1024, 4      # bench.py:82, :124


def log(msg: str) -> None:
    print(msg, flush=True)


def check_kernel(dev) -> dict:
    """Phase 2: kernel against plain at every serving shape."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = l2_flush_buffer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    step_ms = {'kernel': 0.0, 'plain': 0.0, 'bound': 0.0, 'library': 0.0}
    bound_kind: dict = {}           # 'bytes' / 'operations' -> ms
    n_layers = llama_config().num_layers
    for name, k, n in SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev,
                        dtype=torch.bfloat16) * (k ** -0.5)
        qw = q.quantize_int4(w, (0,), group_size=GROUP, compute=True)
        del w
        g = k // GROUP
        vals, sc = qw.values, qw.scales.reshape(g, n)
        for m in CHECK_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            splits = k2.split_plan(m, k, n, GROUP // 2, sms)
            for dtype in (torch.bfloat16, torch.float32):
                got = k2.int4_matmul_cuda(x, vals, sc, dtype)
                again = k2.int4_matmul_cuda(x, vals, sc, dtype)
                ref = k2.int4_matmul_reference(x, vals, sc, dtype).float()
                torch.cuda.synchronize()
                same = torch.equal(got, again)
                got = got.float()
                err = float((got - ref).abs().max())
                scale = float(ref.abs().max())
                tol = TOL[str(dtype).split('.')[-1]]
                ok = (bool(torch.isfinite(got).all()) and err <= tol * scale
                      and same)
                line = (f'phase2 {name:8s} M={m:<4d} K={k:<6d} N={n:<7d} '
                        f'out={str(dtype)[6:]:9s} splits={splits:<3d} '
                        f'max_abs_err={err:.3e} max|plain|={scale:.3e} '
                        f'tol={tol:g} repeats bit for bit: {same}')
                if m in TIMED_ROWS:
                    kms = time_ms(lambda: k2.int4_matmul_cuda(
                        x, vals, sc, dtype), 10, flush)
                    pms = time_ms(lambda: k2.int4_matmul_reference(
                        x, vals, sc, dtype), 3, flush)
                    bms, by = bound(
                        2 * m * k * n, vals.numel() + sc.numel() * 4
                        + x.numel() * 2
                        + m * n * (4 if dtype == torch.float32 else 2),
                        torch.bfloat16)
                    line += (f' kernel_ms={kms:.4f} plain_ms={pms:.4f} '
                             f'bound_ms={bms:.4f} ({by})')
                log(f'{line} {"ok" if ok else "FAIL"}')
                if not ok:
                    raise AssertionError(
                        f'int4 kernel disagrees at {name} M={m} {dtype}')
                worst = max(worst, err)
                # one decode step at 32 slots: 32 layers' bf16 matmuls and
                # the fp32-out head
                if m == DECODE_SLOTS and (
                        (name == 'head') == (dtype == torch.float32)):
                    reps = 1 if name == 'head' else n_layers
                    lms, note = int4_library_ms(x, vals, sc, flush)
                    log(f'phase2 library {name:8s} M={m} '
                        f'torch._weight_int4pack_mm ms='
                        f'{"none" if lms is None else f"{lms:.4f}"} ({note})')
                    step_ms['kernel'] += reps * kms
                    step_ms['plain'] += reps * pms
                    step_ms['bound'] += reps * bms
                    bound_kind[by] = bound_kind.get(by, 0.0) + reps * bms
                    step_ms['library'] = (None if lms is None
                                          or step_ms['library'] is None
                                          else step_ms['library'] + reps * lms)
        if name in ('gate_up', 'down'):
            # crossover: kernel against the dense path that _wmm takes above
            # KERNEL_MAX_ROWS (dequantize to bf16, bf16 matmul)
            for m in (32, 64, 128, 256, 512, 2048):
                x = torch.randn((m, k), generator=gen, device=dev,
                                dtype=torch.bfloat16)
                kms = time_ms(lambda: k2.int4_matmul_cuda(
                    x, vals, sc, torch.bfloat16), 10, flush)
                dms = time_ms(lambda: x @ qw.dequantize(
                    torch.bfloat16), 5, flush)
                log(f'crossover {name:8s} M={m:<5d} kernel_ms={kms:.4f} '
                    f'dense_ms={dms:.4f}')
        del qw, vals, sc

    # K2b: the layer-indexed TPU kernel is K2 on the view values[li]
    k, n, nl = 4096, 4096, 3
    w = torch.randn((nl, k, n), generator=gen, device=dev,
                    dtype=torch.bfloat16) * (k ** -0.5)
    qs = q.quantize_int4(w, (1,), group_size=GROUP, compute=True)
    x = torch.randn((DECODE_SLOTS, k), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    for li in range(nl):
        lw = qs.layer(li)
        vals, sc = lw.values, lw.scales.reshape(k // GROUP, n)
        got = k2.int4_matmul_cuda(x, vals, sc, torch.float32)
        own = k2.int4_matmul_cuda(x, vals.clone(), sc.clone(), torch.float32)
        ref = k2.int4_matmul_reference(x, vals, sc, torch.float32)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        log(f'phase2 layer-view li={li} max_abs_err={err:.3e} '
            f'equal_to_copy={bool(torch.equal(got, own))}')
        if not (torch.equal(got, own)
                and err <= TOL['float32'] * float(ref.abs().max())):
            raise AssertionError(f'int4 kernel on layer view {li} disagrees')
        worst = max(worst, err)
    lib = step_ms['library']
    log(f'phase2 one decode step (32 slots, 4x32 layer matmuls + head): '
        f'kernel_ms={step_ms["kernel"]:.3f} plain_ms={step_ms["plain"]:.3f} '
        f'bound_ms={step_ms["bound"]:.3f} '
        f'library_ms={"none" if lib is None else f"{lib:.3f}"}')
    return {'max_abs_err': worst, 'ms': step_ms['kernel'],
            'plain_ms': step_ms['plain'], 'bound_ms': step_ms['bound'],
            'bound_by': max(bound_kind, key=bound_kind.get),
            'library_ms': lib}


def o_projection(dev) -> None:
    """Phase 2: the 'o' projection at 32 slots in ``quantize_decoder_int4``'s
    layout, (H, D, E) grouped over heads only, where K2 declines and
    ``_wmm`` dequantizes the layer's whole weight on every call, against the
    flattened (H*D, E) layout that phase 4 serves, which K2 takes."""
    cfg = llama_config()
    h, d, e = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    flush = l2_flush_buffer(dev)
    w = torch.randn((1, h, d, e), generator=gen, device=dev,
                    dtype=torch.bfloat16) * (h * d) ** -0.5
    leaves = {
        'heads': q.quantize_int4(w, (1, 2), group_size=GROUP,
                                 compute=True).layer(0),
        'flat': q.quantize_int4(w.reshape(1, h * d, e), (1,),
                                group_size=GROUP, compute=True).layer(0)}
    attn = torch.randn((DECODE_SLOTS, 1, h, d), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    ms, launched = {}, {}
    for name, leaf in leaves.items():
        def call(leaf=leaf):
            return transformer._wmm('blhd,hde->ble', attn, leaf,
                                    torch.bfloat16, n_contract=2)
        before = k2.int4_matmul_cuda.launches
        call()
        launched[name] = k2.int4_matmul_cuda.launches > before
        ms[name] = time_ms(call, 10, flush)
    n = cfg.num_layers
    log(f'phase2 o projection at {DECODE_SLOTS} slots: grouped over heads '
        f'(K2 declines: dequantize + einsum) {ms["heads"]:.4f} ms per layer, '
        f'{n * ms["heads"]:.3f} ms per decode step; flattened (K2) '
        f'{ms["flat"]:.4f} ms per layer, {n * ms["flat"]:.3f} ms per step')
    if launched != {'heads': False, 'flat': True}:
        raise AssertionError(f'o projection routes: K2 launched {launched}')


def check_ab(dev, smi) -> dict:
    """Phase 2ab: the A/B variants v1 and v2 of K2 against their plain
    versions, the negative controls, then the timed A/B (the bench's
    ``run``, the path whose launches are counted)."""
    worst = {'v1': 0.0, 'v2': 0.0}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (name, k, n) in enumerate(ab.SHAPES):
        gen = torch.Generator(device=dev).manual_seed(SEED + 50 + i)
        wts = ab.make_weights(k, n, gen)
        vals, sc = wts['values'], wts['scales']
        v2v, v2s = wts['v2_values'], wts['v2_scales']
        for m in (1, 32, 128):
            x = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            corr = ab.v2_correction(x, v2s, ab.GS)
            splits = k2.split_plan(m, k, n, ab.GS // 2, sms)
            cases = {   # tag -> (kernel, plain version, negative control)
                'v1': (lambda: ab.int4_matmul_v1_cuda(x, vals, sc),
                       ab.int4_matmul_v1_reference(x, vals, sc),
                       k2.int4_matmul_cuda(x, vals, sc, torch.bfloat16)),
                'v2': (lambda: ab.int4_matmul_v2_cuda(x, v2v, v2s, corr),
                       ab.int4_matmul_v2_reference(x, v2v, v2s, corr),
                       ab.int4_matmul_v2_cuda(x, v2v, v2s,
                                              torch.zeros_like(corr)))}
            for tag, (kernel, ref, control) in cases.items():
                got, again = kernel(), kernel()
                torch.cuda.synchronize()
                share, diff, scale = ab.agreement(got, ref)
                same = torch.equal(got, again)
                cshare, cdiff, _ = ab.agreement(control, ref)
                caught = not ab.agrees(control, ref)
                log(f'phase2ab {tag} {name:8s} M={m:<4d} K={k:<6d} N={n:<6d} '
                    f'splits={splits:<3d} bit-equal {share:.6f} '
                    f'(min {ab.MIN_BIT_EQUAL:g}) '
                    f'max_abs_err={diff:.3e} max|plain|={scale:.3e} (tol '
                    f'{ab.MAX_DIFF:g} x) repeats bit for bit: {same}; '
                    f'negative control '
                    f'({"v0" if tag == "v1" else "no correction"}): '
                    f'bit-equal {cshare:.6f} max_abs_err={cdiff:.3e} '
                    f'refused: {caught}')
                if not (ab.agrees(got, ref) and same):
                    raise AssertionError(f'{tag} kernel disagrees at {name} '
                                         f'M={m}')
                if not caught:
                    raise AssertionError(f'the {tag} check passed its '
                                         f'negative control at {name} M={m}')
                worst[tag] = max(worst[tag], diff)
        del wts, vals, sc, v2v, v2s
    ab.int4_matmul_v1_cuda.launches = 0
    ab.int4_matmul_v2_cuda.launches = 0
    results = ab.run(dev)
    launches = {'v1': ab.int4_matmul_v1_cuda.launches,
                'v2': ab.int4_matmul_v2_cuda.launches}
    total = ab.sum_of_shapes(results)
    bound_kind: dict = {}           # 'bytes' / 'operations' -> ms
    for name, r in results.items():
        bound_kind[r['bound_by']] = bound_kind.get(r['bound_by'], 0.0) \
            + r['bound']
        log(f'phase2ab A/B {name:8s} M={r["M"]} K={r["K"]} N={r["N"]} '
            + ' '.join(f'{tag}_ms={r[tag]}' for tag in ab.TIMED)
            + f' ({r["bound_by"]}) relerr v1={r["relerr"]["v1"]:.3e} '
            f'v2={r["relerr"]["v2"]:.3e} (tol {AB_RELERR_TOL:g}); library: '
            f'{r["library_note"]}; card {smi}')
        if max(r['relerr'].values()) > AB_RELERR_TOL:
            raise AssertionError(f'A/B relerr too large at {name}')
    log(f'phase2ab A/B sum of the three shapes at M 32: '
        + ' '.join(f'{tag}_ms={total[tag]}' for tag in ab.TIMED)
        + f'; launches in the timed A/B: v1 {launches["v1"]} v2 '
        f'{launches["v2"]}')
    for tag, n in launches.items():
        if n == 0:
            raise AssertionError(f'the {tag} kernel was not launched in the '
                                 'timed A/B')
    return {'worst': worst, 'launches': launches, 'total': total,
            'bound_by': max(bound_kind, key=bound_kind.get)}


def build_params(cfg, dev) -> dict:
    """Phase 3: Llama-geometry int4-COMPUTE params from a seed, one layer at
    a time (bf16 draw, quantize, drop the fp copy); q/k/v and gate/up fused,
    o stored with its (H*D, E) contraction flattened, int4-COMPUTE head."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    e, h, kh, d, f = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.mlp_dim)
    shapes = {'qkv': [(e, h * d), (e, kh * d), (e, kh * d)],
              'o': [(h * d, e)], 'gate_up': [(e, f), (e, f)],
              'down': [(f, e)]}
    stacked = {name: ([], []) for name in shapes}
    for _ in range(cfg.num_layers):
        for name, parts in shapes.items():
            leaves = []
            for shape in parts:
                w = torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.bfloat16) * (shape[0] ** -0.5)
                leaves.append(q.quantize_int4(w[None], (1,), group_size=GROUP,
                                              compute=True))
                del w
            fused = q._fuse_int4(leaves) if len(leaves) > 1 else leaves[0]
            stacked[name][0].append(fused.values[0])
            stacked[name][1].append(fused.scales[0])
    layers = {name: {'w': q.Int4Weight(torch.stack(v), torch.stack(s), True)}
              for name, (v, s) in stacked.items()}
    del stacked
    ones = torch.ones((cfg.num_layers, e), device=dev)
    layers['attn_norm'] = {'w': ones}
    layers['mlp_norm'] = {'w': ones.clone()}
    emb = torch.randn((cfg.vocab_size, e), generator=gen, device=dev,
                      dtype=torch.bfloat16) * 0.02
    head = torch.randn((e, cfg.vocab_size), generator=gen, device=dev,
                       dtype=torch.bfloat16) * (e ** -0.5)
    head_q = q.quantize_int4(head, (0,), group_size=GROUP, compute=True)
    del head
    return {'embedding': emb, 'layers': layers,
            'final_norm': {'w': torch.ones(e, device=dev)}, 'lm_head': head_q}


def make_batches(cfg) -> list:
    rng = np.random.default_rng(SEED + 2)
    batches, rid = [], 0
    for _ in range(N_BATCHES):
        batch = []
        for _ in range(PER_BATCH):
            req = {'input_ids': rng.integers(
                       5, cfg.vocab_size - 1,
                       size=int(rng.integers(112, 129))).tolist(),
                   'max_new_tokens': NEW_TOKENS,
                   # two sampled requests, the rest greedy
                   'temperature': 0.7 if rid in (5, 21) else 0.0}
            batch.append((rid, req))
            rid += 1
        batches.append(batch)
    return batches


def serve(engine, params, gen_cfg, batches, dev) -> dict:
    """Phase 4: the engine's serving mode in a worker thread; each batch
    arrives once the previous one has streamed its first tokens."""
    lock = threading.Lock()
    cond = threading.Condition()
    pending: deque = deque()
    streamed: set = set()
    results: dict = {}
    errors: list = []
    stop = threading.Event()
    total = sum(len(b) for b in batches)

    def feed():
        with lock:
            items = list(pending)
            pending.clear()
        return items

    def on_tokens(rid, toks):
        with cond:
            streamed.add(rid)
            cond.notify_all()

    def on_finish(rid, toks):
        with cond:
            results[rid] = toks
            cond.notify_all()

    def run():
        try:
            engine.generate(
                params, [], gen_cfg,
                torch.Generator(device=dev).manual_seed(SEED + 3),
                chunk_steps=CHUNK_STEPS, request_feed=feed,
                on_finish=on_finish, on_tokens=on_tokens,
                should_stop=stop.is_set)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
            with cond:
                cond.notify_all()

    worker = threading.Thread(target=run, daemon=True)
    t0 = time.perf_counter()
    worker.start()
    try:
        for i, batch in enumerate(batches):
            with lock:
                pending.extend(batch)
            rids = {rid for rid, _ in batch}
            want = (lambda: rids <= streamed) if i + 1 < len(batches) else (
                lambda: len(results) == total)
            with cond:
                if not cond.wait_for(lambda: errors or want(), timeout=600):
                    raise TimeoutError(f'serving stalled at batch {i}')
            if errors:
                raise errors[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        stop.set()
        worker.join(timeout=120)
    if worker.is_alive():
        raise RuntimeError('engine worker did not stop')
    if errors:
        raise errors[0]
    return {'results': results, 'seconds': seconds}


def recompute_step(params, cfg, prompt, out, dev):
    """One decode step of one request, through the kernel and through the
    plain int4 path, on the same cache."""
    j = len(out) // 2
    ids = prompt + out[:j]
    cache = transformer.init_cache(cfg, 1, MAX_LEN, dtype=torch.bfloat16,
                                   device=dev)
    ids_t = torch.tensor([ids], device=dev)
    transformer.forward(params, cfg, ids_t,
                        positions=torch.arange(len(ids), device=dev)[None],
                        cache=cache, cache_offset=0, need_logits=False)
    tok = torch.tensor([[out[j]]], device=dev)
    pos = torch.tensor([[len(ids)]], device=dev)

    def step():
        return transformer.forward(params, cfg, tok, positions=pos,
                                   cache=cache,
                                   cache_offset=len(ids)).logits[0, 0]

    kern = step()
    with mock.patch.object(k2, 'int4_matmul_cuda', k2.int4_matmul_reference):
        plain = step()
    torch.cuda.synchronize()
    return kern.float(), plain.float(), out[j + 1]


def build_kernels() -> dict:
    """Phase 1: one nvcc per source, all started together."""
    libs = {'int4_matmul': k2.LIBRARY, 'flash_attention': fa.LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(lib.load) for name, lib in libs.items()}
        for fut in futures.values():
            fut.result()
    log(f'phase1 built {", ".join(libs)} in {time.perf_counter() - t0:.1f} s')
    return libs


def ptxas_lines(build_log: str) -> list[str]:
    return [line.strip() for line in build_log.splitlines()
            if 'registers' in line or 'spill' in line]


def check_k2_tensor_cores(lib) -> None:
    """Phase 1: every instance of K2's kernel, and of its A/B variants v1
    and v2 (the same kernel body), multiplies on the tensor cores (HMMA in
    its SASS); print each instance's registers and spills beside it."""
    res = lib.ptxas_resources()
    counts: dict = {}
    for name, n in sorted(lib.tensor_core_counts().items()):
        tag = k2.variant_of(name)
        if tag is None:
            continue
        counts.setdefault(tag, []).append(n)
        info = res.get(name, {})
        log(f'phase1 int4_matmul {tag} HMMA={n:<4d} '
            f'registers={info.get("registers", "not reported")} '
            f'spill_stores={info.get("spill_stores", "not reported")} '
            f'spill_loads={info.get("spill_loads", "not reported")} {name}')
    if sorted(counts) != ['v0', 'v1', 'v2'] or min(
            min(n) for n in counts.values()) == 0:
        raise AssertionError('an instance of K2 or of its A/B variants has '
                             f'no tensor-core instruction ({counts})')


def check_tensor_cores(lib) -> None:
    """Phase 5: the bf16 forward, dK/dV and dQ kernels at D 64 and 128
    run their products on the tensor cores."""
    counts = lib.tensor_core_counts()
    for name, n in sorted(counts.items()):
        log(f'phase5 flash_attention SASS tensor-core instructions {n:5d} '
            f'in {name}')
    for role in ('fwd', 'dkdv', 'dq'):
        for d in fa.TENSOR_CORE_HEAD_DIMS:
            tag = f'{role}_wgmma_kernelILi{d}E'
            found = [n for name, n in counts.items() if tag in name]
            if not found or min(found) == 0:
                raise AssertionError(f'no tensor-core instruction in the bf16 '
                                     f'{role} kernel at D {d} ({found})')


def flash_inputs(b, l, h, kh, d, pad_rows, pad_len, dtype, dev, seed):
    """q, k, v, mask, dout from a seed; the last ``pad_rows`` rows end
    ``pad_len`` (None: 100-200, from the seed) tokens early."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v, dout = rnd(b, l, h, d), rnd(b, l, kh, d), rnd(b, l, kh, d), \
        rnd(b, l, h, d)
    mask = None
    if pad_rows:
        rng = np.random.default_rng(seed)
        mask = torch.ones((b, l), dtype=torch.int32, device=dev)
        for r in range(b - pad_rows, b):
            n = pad_len if pad_len is not None else int(rng.integers(100,
                                                                     201))
            mask[r, l - n:] = 0
    return q, k, v, mask, dout


def flash_bounds(b, l, h, kh, d, causal, window, mask, dtype, dev):
    """(fwd, bwd) bounds, each (ms, kind), for this run's inputs, and the
    FLOPs of the forward: 4*D per visible (query, key) pair and head
    forward, 10*D backward (five products); each input read once, each
    output written once."""
    i = torch.arange(l, device=dev)[:, None]
    j = torch.arange(l, device=dev)[None, :]
    vis = torch.ones((l, l), dtype=torch.bool, device=dev)
    if causal:
        vis &= j <= i
    if window:
        vis &= (i - j) < window
    keys = (mask.bool() if mask is not None
            else torch.ones((b, l), dtype=torch.bool, device=dev))
    pairs = int((vis[None] & keys[:, None, :]).sum()) * h
    e = torch.empty((), dtype=dtype).element_size()
    qo, kv, lse = b * l * h * d * e, b * l * kh * d * e, b * h * l * 4
    extra = lse + (0 if mask is None else b * l)
    return (bound(4 * d * pairs, 2 * qo + 2 * kv + extra, dtype),
            bound(10 * d * pairs, 4 * qo + 4 * kv + extra, dtype),
            4 * d * pairs)


def sdpa_ms(q, k, v, dout, causal, flush) -> tuple[float, float]:
    """The library yardstick, timed only: PyTorch's fused attention on the
    same q, k, v (heads-first views), causal, no padding mask."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    with torch.no_grad():
        fwd_ms = time_ms(fwd, 10, flush)
    out = fwd()
    g = dout.transpose(1, 2)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g,
                                                 retain_graph=True), 10, flush)
    return fwd_ms, bwd_ms


def plain_flash():
    """The flash kernels patched to their plain versions."""
    return mock.patch.multiple(
        fa, flash_attention_fwd_cuda=fa.flash_attention_fwd_reference,
        flash_attention_bwd_cuda=fa.flash_attention_bwd_reference)


def reset_flash_counts() -> None:
    fa.flash_attention_fwd_cuda.launches = 0
    fa.flash_attention_bwd_cuda.launches = 0


def flash_counts() -> dict:
    return {'fwd': fa.flash_attention_fwd_cuda.launches,
            'bwd': fa.flash_attention_bwd_cuda.launches}


def check_launches(tag: str, launches: dict, need: dict,
                   exact: bool = False) -> None:
    """At least ``need`` launches of each kernel; exactly that many when
    ``exact``."""
    for kind in need:
        if launches[kind] < need[kind] or (exact
                                           and launches[kind] != need[kind]):
            raise AssertionError(f'{tag}: flash {kind} launched '
                                 f'{launches[kind]} times, expected '
                                 f'{"" if exact else ">= "}{need[kind]}')


def check_flash(dev) -> dict:
    """Phase 6: the flash kernels against their plain versions."""
    flush = l2_flush_buffer(dev)
    worst = {'fwd': 0.0, 'bwd': 0.0}
    timed = {}
    for seed, (name, b, l, h, kh, d, causal, window, pad_rows, pad_len,
               dtype, is_timed) in enumerate(FLASH_SHAPES):
        q, k, v, mask, dout = flash_inputs(b, l, h, kh, d, pad_rows, pad_len,
                                           dtype, dev, SEED + 20 + seed)
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, mask, causal, window)
        grads = fa.flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout,
                                            causal, window)
        again = fa.flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout,
                                            causal, window)
        rout, rlse = fa.flash_attention_fwd_reference(q, k, v, mask, causal,
                                                      window)
        rgrads = fa.flash_attention_bwd_reference(q, k, v, mask, out, lse,
                                                  dout, causal, window)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        parts = []
        for label, got, ref in (('out', out, rout),
                                ('dq', grads[0], rgrads[0]),
                                ('dk', grads[1], rgrads[1]),
                                ('dv', grads[2], rgrads[2])):
            err = float((got.float() - ref.float()).abs().max())
            rel = fa.row_scaled_error(got, ref)
            parts.append(f'{label} {rel:.2e} (abs {err:.2e})')
            if not (bool(torch.isfinite(got).all()) and rel <= tol):
                raise AssertionError(f'flash {label} disagrees at {name}: '
                                     f'{rel} > {tol} x the row max|plain|')
            key = 'fwd' if label == 'out' else 'bwd'
            worst[key] = max(worst[key], err)
        lse_err = float((lse - rlse).abs().max())
        same = all(torch.equal(g1, g2) for g1, g2 in zip(grads, again))
        log(f'phase6 {name:10s} B={b} L={l} H={h} KH={kh} D={d} '
            f'causal={causal} window={window} pad_rows={pad_rows} '
            f'{str(dtype)[6:]}: max over rows of max|kernel-plain|/max|plain| '
            f'{", ".join(parts)} (tol {tol:g}); lse {lse_err:.2e} '
            f'(tol {LSE_TOL:g}); backward repeats bit for bit: {same}')
        if not lse_err <= LSE_TOL:
            raise AssertionError(f'flash lse disagrees at {name}: {lse_err}')
        if not same:
            raise AssertionError(f'flash backward not deterministic at {name}')
        if is_timed:
            (fb, fby), (bb, bby), flops = flash_bounds(
                b, l, h, kh, d, causal, window, mask, dtype, dev)
            lib_f, lib_b = sdpa_ms(q, k, v, dout, causal, flush)
            t = {'ms': time_ms(lambda: fa.flash_attention_fwd_cuda(
                     q, k, v, mask, causal, window), 10, flush),
                 'bwd_ms': time_ms(lambda: fa.flash_attention_bwd_cuda(
                     q, k, v, mask, out, lse, dout, causal, window), 10,
                     flush),
                 'plain_ms': time_ms(lambda: fa.flash_attention_fwd_reference(
                     q, k, v, mask, causal, window), 3, flush),
                 'plain_bwd_ms': time_ms(
                     lambda: fa.flash_attention_bwd_reference(
                         q, k, v, mask, out, lse, dout, causal, window), 3,
                     flush),
                 'bound_ms': fb, 'bound_by': fby, 'bwd_bound_ms': bb,
                 'bwd_bound_by': bby, 'library_ms': lib_f,
                 'library_bwd_ms': lib_b}
            timed[name] = t
            log(f'phase6 {name:10s} time: forward kernel_ms={t["ms"]:.4f} '
                f'({flops / t["ms"] / 1e9:.1f} TFLOP/s) '
                f'plain_ms={t["plain_ms"]:.4f} sdpa_ms={lib_f:.4f} '
                f'bound_ms={fb:.4f} ({fby}); backward kernel_ms='
                f'{t["bwd_ms"]:.4f} ({2.5 * flops / t["bwd_ms"] / 1e9:.1f} '
                f'TFLOP/s at 10*D per pair) '
                f'plain_ms={t["plain_bwd_ms"]:.4f} '
                f'sdpa_ms={lib_b:.4f} bound_ms={bb:.4f} ({bby})')
        del q, k, v, mask, dout, out, lse, grads, again, rout, rlse, rgrads
    return {'worst': worst, 'timed': timed}

# PPO's mask pattern: left-padded prompts followed by completions padded
# after EOS.  (name, B, L, H, KH, D, leading pads [lo, hi), trailing pads
# [lo, hi), whether one row holds a single token, timed)
FLASH_PPO = [
    ('ppo_mask', 8, 256, 32, 8, 128, (0, 101), (0, 61), True, False),
    # phase 20's scoring pass: a round's 8 rows at LLaVA-1.5-7B's text
    # heads (MHA), image prompts of 20-60 words + 576 image tokens left-
    # padded in the 1024 bucket, then up to 128 new tokens
    ('ti2t_ppo', 8, 1024 + 128, 32, 32, 128, (350, 431), (0, 128), False,
     True),
]


def check_flash_ppo(dev, case: tuple, seed: int) -> tuple:
    """Phase 6, PPO's mask pattern (a ``FLASH_PPO`` case), causal, bf16:
    rows with leading and trailing pads from the case's ranges (the first
    row at their low ends, the second at their high ends), and where the
    case says so one row that is all pad but one token.  Against the plain
    versions per row; a query row that sees no key must give out = 0 and
    dq = 0 exactly, a pad key dk = dv = 0 exactly; nothing NaN; the
    backward repeats bit for bit.  Returns (worst errors, timings or
    None)."""
    name, b, l, h, kh, d, lead_range, trail_range, lone_row, timed = case
    dtype = torch.bfloat16
    q, k, v, _, dout = flash_inputs(b, l, h, kh, d, 0, None, dtype, dev,
                                    seed)
    rng = np.random.default_rng(seed)
    lead = rng.integers(*lead_range, size=b)
    trail = rng.integers(*trail_range, size=b)
    lead[:2] = lead_range[0], lead_range[1] - 1
    trail[:2] = trail_range[0], trail_range[1] - 1
    mask = torch.ones((b, l), dtype=torch.int32, device=dev)
    for r in range(b):
        mask[r, :lead[r]] = 0
        mask[r, l - trail[r]:] = 0
    first = torch.as_tensor(lead, device=dev)
    if lone_row:
        lone = 131                             # the row with one token
        mask[b - 1] = 0
        mask[b - 1, lone] = 1
        first[b - 1] = lone
    blind = torch.arange(l, device=dev)[None] < first[:, None]   # (B, L)
    pad_keys = mask == 0
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, mask, True, None)
    grads = fa.flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout, True,
                                        None)
    again = fa.flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout, True,
                                        None)
    rout, rlse = fa.flash_attention_fwd_reference(q, k, v, mask, True, None)
    rgrads = fa.flash_attention_bwd_reference(q, k, v, mask, out, lse, dout,
                                              True, None)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    parts, worst = [], {'fwd': 0.0, 'bwd': 0.0}
    for label, got, ref in (('out', out, rout), ('dq', grads[0], rgrads[0]),
                            ('dk', grads[1], rgrads[1]),
                            ('dv', grads[2], rgrads[2])):
        rel = fa.row_scaled_error(got, ref)
        err = float((got.float() - ref.float()).abs().max())
        worst['fwd' if label == 'out' else 'bwd'] = max(
            worst['fwd' if label == 'out' else 'bwd'], err)
        parts.append(f'{label} {rel:.2e} (abs {err:.2e})')
        if not (bool(torch.isfinite(got).all()) and rel <= tol):
            raise AssertionError(f'flash {label} disagrees at {name}: '
                                 f'{rel} > {tol} x the row max|plain|')
    zeros = {'out': bool((out[blind] == 0).all()),
             'dq': bool((grads[0][blind] == 0).all()),
             'lse': bool((lse.transpose(1, 2)[blind] == 0).all()),
             'dk': bool((grads[1][pad_keys] == 0).all()),
             'dv': bool((grads[2][pad_keys] == 0).all())}
    lse_err = float((lse - rlse).abs().max())
    same = all(torch.equal(g1, g2) for g1, g2 in zip(grads, again))
    rows = b - 1 if lone_row else b
    log(f'phase6 {name:10s} B={b} L={l} H={h} KH={kh} D={d} causal, leading '
        f'pads {lead[:rows].tolist()}'
        f'{" + one row with one token" if lone_row else ""}, trailing pads '
        f'{trail[:rows].tolist()}, {int(blind.sum())} query rows see no key: '
        f'max over rows of max|kernel-plain|/max|plain| {", ".join(parts)} '
        f'(tol {tol:g}); lse {lse_err:.2e} (tol {LSE_TOL:g}); exact zeros '
        f'(blind rows: out, dq, lse; pad keys: dk, dv) {zeros}; backward '
        f'repeats bit for bit: {same}')
    if not all(zeros.values()):
        raise AssertionError(f'flash: nonzero where no key is seen at '
                             f'{name} {zeros}')
    if not lse_err <= LSE_TOL:
        raise AssertionError(f'flash lse disagrees at {name}: {lse_err}')
    if not same:
        raise AssertionError(f'flash backward not deterministic at {name}')
    t = None
    if timed:
        flush = l2_flush_buffer(dev)
        (fb, fby), (bb, bby), flops = flash_bounds(b, l, h, kh, d, True, None,
                                                   mask, dtype, dev)
        lib_f, lib_b = sdpa_ms(q, k, v, dout, True, flush)
        t = {'ms': time_ms(lambda: fa.flash_attention_fwd_cuda(
                 q, k, v, mask, True, None), 10, flush),
             'bwd_ms': time_ms(lambda: fa.flash_attention_bwd_cuda(
                 q, k, v, mask, out, lse, dout, True, None), 10, flush),
             'plain_ms': time_ms(lambda: fa.flash_attention_fwd_reference(
                 q, k, v, mask, True, None), 3, flush),
             'plain_bwd_ms': time_ms(
                 lambda: fa.flash_attention_bwd_reference(
                     q, k, v, mask, out, lse, dout, True, None), 3, flush),
             'bound_ms': fb, 'bound_by': fby, 'bwd_bound_ms': bb,
             'bwd_bound_by': bby, 'library_ms': lib_f,
             'library_bwd_ms': lib_b}
        log(f'phase6 {name:10s} time: forward kernel_ms={t["ms"]:.4f} '
            f'({flops / t["ms"] / 1e9:.1f} TFLOP/s of the masked pairs) '
            f'plain_ms={t["plain_ms"]:.4f} sdpa_ms={lib_f:.4f} (causal, no '
            f'padding mask) bound_ms={fb:.4f} ({fby}); backward kernel_ms='
            f'{t["bwd_ms"]:.4f} plain_ms={t["plain_bwd_ms"]:.4f} '
            f'sdpa_ms={lib_b:.4f} bound_ms={bb:.4f} ({bby})')
    return worst, t


def dpo_flops_per_token(n_params: int, seq: int, hidden: int,
                        layers: int) -> float:
    """``bench.py:68``: PaLM-convention FLOPs per trained token of a DPO
    step, policy fwd+bwd (6N + 12*L*h*layers) + frozen reference fwd
    (2N + 4*L*h*layers)."""
    return 8 * n_params + 16 * seq * hidden * layers


def dpo_batch(cfg, pairs: int, seq: int, dev, seed: int,
              pad: bool) -> dict:
    """Better rows above worse; ``pad``: the worse rows end 64-192 tokens
    early.  The response is the second half (``bench.py:98-100``)."""
    rng = np.random.default_rng(seed)
    b = 2 * pairs
    ids = rng.integers(0, min(cfg.vocab_size, 32000), size=(b, seq))
    mask = np.ones((b, seq), np.int64)
    if pad:
        for r in range(pairs, b):
            n = int(rng.integers(64, 193))
            mask[r, seq - n:] = 0
            ids[r, seq - n:] = cfg.pad_token_id
    rmask = (np.arange(seq - 1)[None, :] >= seq // 2) & (mask[:, 1:] == 1)
    return {'input_ids': torch.as_tensor(ids, device=dev),
            'attention_mask': torch.as_tensor(mask, device=dev),
            'response_mask': torch.as_tensor(rmask, dtype=torch.float32,
                                             device=dev)}


def dpo_setup(cfg, dev, seed: int, **opt):
    """fp32 params from a seed, the reference as a bf16 copy
    (``bench.py:88``), the trainer and its state."""
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    ref = tree_map(lambda t: t.detach().to(torch.bfloat16), params)
    tx, schedule = make_optimizer(1e-6, max_grad_norm=1.0, **opt)
    trainer = DPOStep(cfg, tx, schedule)
    return trainer, trainer.init_state(params), ref


def step1_quantities(trainer, params, ref, batch) -> tuple:
    """Per-sequence response log-prob sums and the gradient norm of the
    DPO loss at ``params`` (step 1's, recomputed)."""
    for p in param_leaves(params):
        p.grad = None
    logp = trainer.compute_token_logprobs(params, batch)
    with torch.no_grad():
        ref_logp = trainer.compute_token_logprobs(ref, batch)
    trainer.preference_loss(logp, ref_logp, batch)['loss'].backward()
    norm = global_norm([p.grad for p in param_leaves(params)])
    sums = (logp.detach() * batch['response_mask']).sum(-1)
    return sums.double().cpu(), float(norm)


def train_dpo(dev, smi) -> dict:
    """Phase 7: DPO at Llama-3-8B widths, 4 layers."""
    cfg = llama_config(layers=DPO_LAYERS).replace(
        compute_dtype='bfloat16', remat='dots_saveable')
    trainer, state, ref = dpo_setup(cfg, dev, SEED + 10)
    init = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                    state.params)
    n_params = sum(t.numel() for t in param_leaves(state.params))
    batch = dpo_batch(cfg, DPO_PAIRS, DPO_SEQ, dev, SEED + 11, pad=True)
    tokens = 2 * DPO_PAIRS * DPO_SEQ
    log(f'phase7 config: Llama-3-8B widths (vocab {cfg.vocab_size}, hidden '
        f'{cfg.hidden_size}, {cfg.num_heads} heads, {cfg.num_kv_heads} KV '
        f'heads, D {cfg.head_dim}, MLP {cfg.mlp_dim}), {cfg.num_layers} '
        f'layers (cut from 32), {n_params / 1e9:.3f} B params, remat '
        f'{cfg.remat}; {DPO_PAIRS} pairs x seq {DPO_SEQ}, worse rows padded')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    losses, norms, seconds = [], [], []
    for i in range(DPO_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, ref, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(metrics['train/loss']))
        norms.append(float(metrics['train/grad_norm']))
        log(f'phase7 step {i + 1}: loss={losses[-1]:.9f} '
            f'grad_norm={norms[-1]:.6e} reward_accuracy='
            f'{float(metrics["train/reward_accuracy"]):.3f} '
            f'seconds={seconds[-1]:.4f}')
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    need = {'fwd': DPO_STEPS * 3 * cfg.num_layers,
            'bwd': DPO_STEPS * cfg.num_layers}
    step_s = statistics.median(seconds[1:])
    tps = tokens / step_s
    mfu = tps * dpo_flops_per_token(n_params, DPO_SEQ, cfg.hidden_size,
                                    cfg.num_layers) \
        / PEAK_FLOPS[torch.bfloat16]
    log(f'phase7 step time {step_s:.4f} s (median of steps 2-{DPO_STEPS}), '
        f'{tps:.1f} tokens/s, peak memory {peak / 1e9:.3f} GB, MFU '
        f'{mfu:.4f} (bench.py convention, 989 TFLOP/s); flash launches '
        f'fwd {launches["fwd"]} (need >= {need["fwd"]}) bwd '
        f'{launches["bwd"]} (need >= {need["bwd"]}); card {smi}')
    if abs(losses[0] - math.log(2)) > 1e-6:
        raise AssertionError(f'step 1 loss {losses[0]} != ln 2')
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError('non-finite loss or grad norm')
    if len(set(losses)) == 1:
        raise AssertionError('the loss did not move over the steps')
    check_launches('DPO', launches, need)

    del state
    torch.cuda.empty_cache()
    sums, norm = step1_quantities(trainer, init, ref, batch)
    with plain_flash():
        psums, pnorm = step1_quantities(trainer, init, ref, batch)
    diff = (sums - psums).abs()
    rel = float((diff / psums.abs().clamp_min(1e-30)).max())
    norm_rel = abs(norm - pnorm) / abs(pnorm)
    log(f'phase7 step 1 recomputed: log-prob sums kernel {sums.tolist()} '
        f'plain {psums.tolist()} (max rel diff {rel:.3e}, tol '
        f'{DPO_SUM_TOL:g}); grad norm kernel {norm:.9e} plain {pnorm:.9e} '
        f'(rel diff {norm_rel:.3e}, tol {DPO_NORM_TOL:g}; step 1 reported '
        f'{norms[0]:.9e})')
    if not (bool((diff <= DPO_SUM_TOL * psums.abs()).all())
            and norm_rel <= DPO_NORM_TOL):
        raise AssertionError('DPO step 1 disagrees with the plain attention')
    return {'launches': launches, 'step_s': step_s, 'tokens_per_s': tps,
            'peak_gb': peak / 1e9, 'mfu': mfu}


def bench_dpo(dev, smi) -> dict:
    """Phase 8: ``bench.py``'s ``bench_t2t_dpo`` config and shape, timed:
    ~0.4 B params, 6 pairs, seq 1024, remat 'dots_saveable', the optax
    AdamW defaults ``bench.py`` runs (b2 0.999, weight decay 1e-4)."""
    cfg = llama_config(vocab_size=32768, hidden=1024, layers=20, heads=16,
                       kv_heads=8, mlp=4096, max_pos=2048).replace(
        compute_dtype='bfloat16', remat='dots_saveable')
    trainer, state, ref = dpo_setup(cfg, dev, SEED + 30,
                                    adam_betas=(0.9, 0.999),
                                    weight_decay=1e-4)
    n_params = sum(t.numel() for t in param_leaves(state.params))
    pairs, seq, steps = BENCH_PAIRS, BENCH_SEQ, BENCH_STEPS
    batch = dpo_batch(cfg, pairs, seq, dev, SEED + 31, pad=False)
    state, metrics = trainer.step(state, ref, batch)          # warm-up
    first = float(metrics['train/loss'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.step(state, ref, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tps = 2 * pairs * seq * steps / dt
    mfu = tps * dpo_flops_per_token(n_params, seq, cfg.hidden_size,
                                    cfg.num_layers) \
        / PEAK_FLOPS[torch.bfloat16]
    last = float(metrics['train/loss'])
    log(f'phase8 bench_t2t_dpo: {n_params / 1e9:.3f} B params, {pairs} '
        f'pairs x seq {seq}, {steps} steps in {dt:.4f} s: '
        f'tokens_per_sec_per_gpu={tps:.1f} mfu={mfu:.4f} step_time_s='
        f'{dt / steps:.4f} peak memory '
        f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; loss {first:.6f}'
        f' -> {last:.6f}; card {smi}')
    if not (math.isfinite(last) and abs(first - math.log(2)) <= 1e-6):
        raise AssertionError('bench DPO loss is off')
    return {'tokens_per_s': tps, 'mfu': mfu}


# phases 9-10: the trainer harness through its entry point
# (``trainer_main``).  Phase 9 runs phase 7's shape: 2 pairs a step,
# padded to the 1024 bucket, 4 steps, remat 'dots_saveable' from the port's
# one-GPU parallel config.  Phase 10 runs bench.py's widths cut to 2 layers.
HARNESS_MESH = 'single_gpu_dots_saveable.json'
SMALL = dict(vocab_size=32768, hidden=1024, layers=2, heads=16, kv_heads=8,
             mlp=4096, max_pos=2048)


def words(rng, n: int) -> str:
    return ' '.join(f'w{int(i)}' for i in rng.integers(0, 10 ** 6, size=n))


def write_jsonl(path: str, rows: list) -> str:
    with open(path, 'w') as f:
        for row in rows:
            f.write(json.dumps(row) + '\n')
    return path


def preference_rows(seed: int, n: int, prompt_len: int,
                    response_lens: tuple) -> list:
    """PKU-SafeRLHF-schema rows of random words.  Under the default chat
    format and ``HashTokenizer`` a row is prompt + response + 5 tokens."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        better = int(rng.integers(0, 2))
        rows.append({
            'prompt': words(rng, prompt_len),
            'response_0': words(rng, int(rng.integers(*response_lens))),
            'response_1': words(rng, int(rng.integers(*response_lens))),
            'is_response_0_safe': True, 'is_response_1_safe': False,
            'better_response_id': better, 'safer_response_id': 0})
    return rows


def run_trainer(trainer_cls, task: str, argv: list,
                mesh_file: str | None = None) -> tuple:
    """``trainer_main(trainer_cls, task, argv)`` on the default device,
    recording each step's logged metrics and the checkpoint load time."""
    from align_anything_tpu_torch.trainers import base  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.cli import trainer_main  # noqa: PLC0415
    from align_anything_tpu_torch.utils.logger import Logger  # noqa: PLC0415

    steps, timing = [], {}
    load = base.load_params

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        out = load(*args, **kwargs)
        torch.cuda.synchronize()
        timing['load_s'] = time.perf_counter() - t0
        return out

    env = {'MESH_FILE': mesh_file} if mesh_file else {}
    with mock.patch.dict(os.environ, env), \
            mock.patch.object(base, 'load_params', timed_load), \
            mock.patch.object(Logger, 'log',
                              lambda self, metrics, step: steps.append(
                                  dict(metrics))):
        trainer = trainer_main(trainer_cls, task, argv)
    return trainer, steps, timing


def harness_full(dev, smi, bare: dict, tmp: str) -> dict:
    """Phase 9: DPO from an 8B-width checkpoint on disk through
    ``trainer_main``, beside phase 7's bare step."""
    from align_anything_tpu_torch.models.hf_loader import save_params  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: PLC0415
        DPOTrainer)

    cfg = llama_config(layers=DPO_LAYERS)
    ckpt = os.path.join(tmp, 'llama8b_4layers')
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 50), device=dev)
    t0 = time.perf_counter()
    save_params(ckpt, params, cfg, dtype=torch.bfloat16)
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(ckpt, 'model.safetensors'))
    del params
    torch.cuda.empty_cache()
    # prompt 400 words, responses 150-600: 555-1005 tokens, the 1024 bucket
    data = write_jsonl(os.path.join(tmp, 'pref_8b.jsonl'), preference_rows(
        SEED + 51, DPO_STEPS * DPO_PAIRS, 400, (150, 601)))
    # no --output_dir: an fp32 export of this model is 7.7 GB of disk
    # writes that nothing reads (phase 12 exports at these widths, phase 10
    # reads its export back), and the card's machine ends a run past 45 GiB
    argv = ['--model_name_or_path', ckpt, '--train_datasets', data,
            '--train_template', 'PKUSafeRLHF',
            '--save_checkpoint', 'False', '--epochs', '1',
            '--per_device_train_batch_size', str(DPO_PAIRS)]
    log(f'phase9 wrote the checkpoint ({cfg.num_layers} layers at Llama-3-8B '
        f'widths, bf16 safetensors in HF layout): {nbytes / 1e9:.3f} GB in '
        f'{write_s:.2f} s; {DPO_STEPS * DPO_PAIRS} preference rows; argv '
        f'{" ".join(argv[2:])}; MESH_FILE={HARNESS_MESH}')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    t0 = time.perf_counter()
    trainer, steps, timing = run_trainer(DPOTrainer, 'text_to_text/dpo',
                                         argv, HARNESS_MESH)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    shape = next(trainer.train_iterator.epoch_batches(0))['input_ids'].shape
    mcfg = trainer.model_cfg
    del trainer
    torch.cuda.empty_cache()
    losses = [m['train/loss'] for m in steps]
    norms = [m['train/grad_norm'] for m in steps]
    seconds = [m['perf/step_time_s'] for m in steps]
    for i, m in enumerate(steps):
        log(f'phase9 step {i + 1}: loss={losses[i]:.9f} grad_norm='
            f'{norms[i]:.6e} reward_accuracy={m["train/reward_accuracy"]:.3f}'
            f' lr={m["train/lr"]:.3e} seconds={seconds[i]:.4f}')
    step_s = statistics.median(seconds[1:])
    tps = shape[0] * shape[1] / step_s
    need = {'fwd': DPO_STEPS * 3 * cfg.num_layers,
            'bwd': DPO_STEPS * cfg.num_layers}
    log(f'phase9 harness: checkpoint load {timing["load_s"]:.2f} s '
        f'({nbytes / timing["load_s"] / 1e9:.3f} GB/s of bf16 file, fp32 on '
        f'the card); batch {tuple(shape)}; remat {mcfg.remat}, compute '
        f'{mcfg.compute_dtype}; trainer_main {total_s:.2f} s in all (load, '
        f'{len(steps)} steps, no export)')
    log(f'phase9 harness step time {step_s:.4f} s (median of steps 2-'
        f'{len(steps)}, the loop\'s own clock: collation, pinned copy, '
        f'step, metrics) vs phase 7 bare step {bare["step_s"]:.4f} s '
        f'(ratio {step_s / bare["step_s"]:.4f}); {tps:.1f} tokens/s vs '
        f'{bare["tokens_per_s"]:.1f}; peak memory {peak / 1e9:.3f} GB vs '
        f'{bare["peak_gb"]:.3f} GB; flash launches fwd {launches["fwd"]} '
        f'(need >= {need["fwd"]}) bwd {launches["bwd"]} (need >= '
        f'{need["bwd"]}); card {smi}')
    if tuple(shape) != (2 * DPO_PAIRS, DPO_SEQ):
        raise AssertionError(f'harness batch {tuple(shape)} is not phase 7\'s')
    if (mcfg.remat, mcfg.compute_dtype) != ('dots_saveable', 'bfloat16'):
        raise AssertionError(f'harness config {mcfg.remat} / '
                             f'{mcfg.compute_dtype} is not phase 7\'s')
    if len(steps) != DPO_STEPS:
        raise AssertionError(f'{len(steps)} harness steps, not {DPO_STEPS}')
    if abs(losses[0] - math.log(2)) > 1e-6:
        raise AssertionError(f'harness step 1 loss {losses[0]} != ln 2')
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError('harness: non-finite loss or grad norm')
    check_launches('harness', launches, need)
    return {'launches': launches, 'step_s': step_s, 'tokens_per_s': tps,
            'peak_gb': peak / 1e9}


def leaves_by_path(tree, prefix: str = '') -> dict:
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in leaves_by_path(v, f'{prefix}/{k}').items()}
    return {prefix: tree.detach()}


def harness_small(dev, smi, tmp: str) -> None:
    """Phase 10 at bench.py's widths, 2 layers: the HF slice export read
    back, resume against an uninterrupted run, SFT step 1 against a plain
    recompute, ORPO and SimPO."""
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_params, save_params)
    from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: PLC0415
        DPOTrainer)
    from align_anything_tpu_torch.trainers.text_to_text.orpo import (  # noqa: PLC0415
        ORPOTrainer)
    from align_anything_tpu_torch.trainers.text_to_text.sft import (  # noqa: PLC0415
        SupervisedTrainer)
    from align_anything_tpu_torch.trainers.text_to_text.simpo import (  # noqa: PLC0415
        SimPOTrainer)

    cfg = llama_config(**SMALL)
    ckpt = os.path.join(tmp, 'small')
    save_params(ckpt, transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 60), device=dev),
        cfg)
    # 85-185 tokens: the 256 bucket
    pref = write_jsonl(os.path.join(tmp, 'pref_small.jsonl'),
                       preference_rows(SEED + 61, 8, 60, (20, 121)))
    rng = np.random.default_rng(SEED + 62)
    sft = write_jsonl(os.path.join(tmp, 'sft_small.jsonl'), [
        {'instruction': words(rng, 40), 'input': words(rng, 10),
         'output': words(rng, int(rng.integers(20, 120)))}
        for _ in range(4)])

    def argv(data, template, out, *extra):
        # out None: no output dir, so no export at the end (the SFT, ORPO
        # and SimPO runs read none: 0.39 GB of disk writes each)
        return ['--model_name_or_path', ckpt, '--train_datasets', data,
                '--train_template', template,
                *(('--output_dir', os.path.join(tmp, out)) if out else ()),
                '--epochs', '1', '--per_device_train_batch_size', '2',
                *extra]

    # 4 uninterrupted steps, the train state saved at step 2 and 4
    full, full_steps, _ = run_trainer(
        DPOTrainer, 'text_to_text/dpo',
        argv(pref, 'PKUSafeRLHF', 'full', '--save_checkpoint', 'True',
             '--save_interval', '2', '--save_total_limit', '3'))
    got = leaves_by_path(full.state.params)
    back, _ = load_params(os.path.join(tmp, 'full', 'slice_4'), device=dev)
    back = leaves_by_path(back)
    exported = set(got) == set(back) and all(
        torch.equal(got[p], back[p]) for p in got)
    log(f'phase10 export: slice_4 read back with load_params, {len(back)} '
        f'leaves, bit-equal to the trainer\'s params: {exported}')
    if not exported:
        raise AssertionError('the HF slice does not read back bit-equal')

    # resume: a new trainer from the step-2 train state, 2 more steps
    os.makedirs(os.path.join(tmp, 'resumed', 'checkpoints'))
    shutil.copytree(os.path.join(tmp, 'full', 'checkpoints', 'step_2'),
                    os.path.join(tmp, 'resumed', 'checkpoints', 'step_2'))
    resumed, resumed_steps, _ = run_trainer(
        DPOTrainer, 'text_to_text/dpo',
        argv(pref, 'PKUSafeRLHF', 'resumed', '--save_checkpoint', 'False',
             '--load_checkpoint', 'True'))
    want = [(m['train/loss'], m['train/grad_norm']) for m in full_steps[2:]]
    have = [(m['train/loss'], m['train/grad_norm']) for m in resumed_steps]
    mine = leaves_by_path(resumed.state.params)
    bit_equal = have == want and all(torch.equal(got[p], mine[p])
                                     for p in got)
    param_diff = max(float((got[p].float() - mine[p].float()).abs().max())
                     for p in got)
    rel = max((abs(h - w) / abs(w) for hw, ww in zip(have, want)
               for h, w in zip(hw, ww)), default=math.inf)
    log(f'phase10 resume: steps 3-4 after resuming at step '
        f'{resumed.global_step - len(resumed_steps)}: (loss, grad norm) '
        f'{have} vs uninterrupted {want}; bit-equal (metrics and params): '
        f'{bit_equal}; max rel diff {rel:.3e} (limit {DPO_SUM_TOL:g}); '
        f'params max abs diff {param_diff:.3e}')
    if len(have) != 2 or not (bit_equal or rel <= DPO_SUM_TOL):
        raise AssertionError('resume disagrees with the uninterrupted run')
    del full, resumed, got, back, mine
    torch.cuda.empty_cache()

    # SFT: step 1 against a plain recompute (plain attention, torch CE)
    trainer, steps, _ = run_trainer(
        SupervisedTrainer, 'text_to_text/sft',
        argv(sft, 'Alpaca', None, '--save_checkpoint', 'False'))
    batch = trainer.put_batch(next(trainer.train_iterator.epoch_batches(0)))
    params, _ = load_params(ckpt, device=dev)
    with torch.no_grad(), \
            mock.patch.object(fa, 'flash_attention_fwd_cuda',
                              fa.flash_attention_fwd_reference):
        logits = transformer.forward(
            params, trainer.model_cfg, batch['input_ids'],
            attention_mask=batch['attention_mask']).logits
        plain = float(F.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            batch['labels'][:, 1:].reshape(-1).long(), ignore_index=-100))
    losses = [m['train/loss'] for m in steps]
    rel = abs(losses[0] - plain) / abs(plain)
    log(f'phase10 sft: {len(losses)} steps, losses {losses}; step 1 '
        f'recomputed with the plain attention and F.cross_entropy {plain:.9f}'
        f' (rel diff {rel:.3e}, limit {DPO_SUM_TOL:g}); batch '
        f'{tuple(batch["input_ids"].shape)}')
    if not (len(losses) == 2 and rel <= DPO_SUM_TOL
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError('SFT step 1 disagrees with the plain recompute')
    del trainer, batch, params, logits
    torch.cuda.empty_cache()

    for cls, task in ((ORPOTrainer, 'orpo'), (SimPOTrainer, 'simpo')):
        _, steps, _ = run_trainer(
            cls, f'text_to_text/{task}',
            argv(pref, 'PKUSafeRLHF', None, '--save_checkpoint', 'False',
                 '--train_size', '4'))
        losses = [m['train/loss'] for m in steps]
        log(f'phase10 {task}: losses {losses}')
        if not (len(losses) == 2 and all(math.isfinite(x) for x in losses)
                and losses[0] != losses[1]):
            raise AssertionError(f'{task}: the loss is not finite or did not '
                                 'move')
    log(f'phase10 done; card {smi}')


# phases 11-13: the reward model and the PPO round through their entry
# points.  Phases 11-12 run Llama-3-8B widths cut to 2 layers: PPO holds
# four models, and actor and critic train with fp32 params, grads and two
# moments (16 B/param) while reference and reward stay fp32 copies (4
# B/param): at 2 layers (1.486 B params each) that is 23.8 + 23.8 + 5.9 +
# 5.9 = 59.4 GB before activations; 4 layers (1.923 B) would need 77 GB.
RL_LAYERS = 2
RM_ROWS, RM_PAIRS, RM_STEPS = 16, 2, 4
PPO_PROMPTS, PPO_ROUND, PPO_BUCKET, PPO_NEW, PPO_MICRO = 16, 8, 128, 128, 4
# step 1 / round 1 recomputed with the plain attention: phase 7's limit,
# for sums of log-probs.  A score (an end score, a value) is one dot
# product of the 4096-wide bf16 hidden state with the head, so bf16's
# rounding moves it by about 1 % of its size, and the kernels' results and
# the plain version's, each rounded its own way, differ by as much (step 1
# of phase 11 read 1.2e-2 of the largest score).  A score is held instead
# to SCORE_NOISE x the plain version's own distance from the same pass in
# fp32 compute, measured in the same run.
RL_TOL = DPO_SUM_TOL
SCORE_NOISE = 3.0


def free_memory() -> None:
    """Collect the trainers of earlier phases (a trainer holds itself
    through its step closures, so ``del`` alone leaves it for the cyclic
    collector) and return their blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def check_scores(tag: str, got: torch.Tensor, plain: torch.Tensor,
                 fp32: torch.Tensor) -> str:
    """``got`` (the kernels, bf16 compute) against ``plain`` (the plain
    attention, bf16) within SCORE_NOISE x max|plain - fp32| (the plain
    attention in fp32 compute), floored at RL_TOL x max|fp32|."""
    got, plain, fp32 = (t.double() for t in (got, plain, fp32))
    noise = float((plain - fp32).abs().max())
    gap = float((got - plain).abs().max())
    limit = max(SCORE_NOISE * noise, RL_TOL * float(fp32.abs().max()))
    msg = (f'{tag}: max|kernel - plain| {gap:.3e}, bf16 noise max|plain - '
           f'fp32| {noise:.3e}, max|kernel - fp32| '
           f'{float((got - fp32).abs().max()):.3e}, max|fp32| '
           f'{float(fp32.abs().max()):.3e}, limit {limit:.3e}')
    if not gap <= limit:
        raise AssertionError(f'{msg}: the kernels disagree with the plain '
                             'attention')
    return msg


def all_finite(steps: list) -> bool:
    return all(math.isfinite(v) for m in steps for v in m.values()
               if isinstance(v, (int, float)))


def prompt_rows(seed: int, n: int, words_range: tuple) -> list:
    """PKU-SafeRLHF-schema rows whose prompts are ``words_range`` words
    long (the prompt-only set reads the prompt only)."""
    rng = np.random.default_rng(seed)
    return [{'prompt': words(rng, int(rng.integers(*words_range))),
             'response_0': 'a', 'response_1': 'b', 'better_response_id': 0}
            for _ in range(n)]


def rm_full(dev, smi, tmp: str, config=None) -> dict:
    """Phase 11: the reward model at Llama-3-8B widths, 2 layers, through
    ``trainer_main(RMTrainer, ...)``, then ``rm_score`` over its export."""
    from align_anything_tpu_torch.models import score_model  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_params, save_params)
    from align_anything_tpu_torch.trainers.text_to_text.rm import (  # noqa: PLC0415
        RMTrainer)
    from align_anything_tpu_torch.trainers.text_to_text.rm_score import (  # noqa: PLC0415
        RMScoreTrainer)

    cfg = config or llama_config(layers=RL_LAYERS)
    free_memory()
    resident = torch.cuda.memory_allocated()
    ckpt = os.path.join(tmp, 'llama8b_2layers')
    save_params(ckpt, transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 70), device=dev),
        cfg, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    # prompt 200 words, responses 60-300: 265-505 tokens, the 512 bucket
    rows = preference_rows(SEED + 71, RM_ROWS, 200, (60, 301))
    pref = write_jsonl(os.path.join(tmp, 'pref_rm.jsonl'), rows)
    # the same rows as prompt + better response, for rm_score
    sft = write_jsonl(os.path.join(tmp, 'sft_rm.jsonl'), [
        {'instruction': r['prompt'], 'input': '',
         'output': r[f'response_{r["better_response_id"]}']} for r in rows])
    out = os.path.join(tmp, 'out_rm')
    argv = ['--model_name_or_path', ckpt, '--train_datasets', pref,
            '--train_template', 'PKUSafeRLHF', '--output_dir', out,
            '--save_checkpoint', 'False', '--epochs', '1',
            '--train_size', str(RM_STEPS * RM_PAIRS),
            '--per_device_train_batch_size', str(RM_PAIRS)]
    first: dict = {}
    end_scores = RMTrainer.end_scores

    def recording(self, params, batch):
        better, worse = end_scores(self, params, batch)
        if not first:
            first.update(batch={k: v.clone() for k, v in batch.items()},
                         head=params['score_head']['w'].detach().clone(),
                         scores=torch.cat([better, worse]).detach().float())
        return better, worse

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    t0 = time.perf_counter()
    with mock.patch.object(RMTrainer, 'end_scores', recording):
        trainer, steps, timing = run_trainer(RMTrainer, 'text_to_text/rm',
                                             argv, HARNESS_MESH)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    shape = tuple(first['batch']['input_ids'].shape)
    n_params = sum(t.numel() for t in param_leaves(trainer.state.params))
    for i, m in enumerate(steps):
        log(f'phase11 step {i + 1}: loss={m["train/loss"]:.9f} accuracy='
            f'{m["train/accuracy"]:.3f} grad_norm={m["train/grad_norm"]:.6e} '
            f'seconds={m["perf/step_time_s"]:.4f}')
    # every layer of every step: the forward, its recompute under
    # 'dots_saveable', and the backward
    need = {'fwd': 2 * RM_STEPS * cfg.num_layers,
            'bwd': RM_STEPS * cfg.num_layers}
    log(f'phase11 config: Llama-3-8B widths, {cfg.num_layers} layers (cut '
        f'from 32), {n_params / 1e9:.3f} B params with the score head; batch '
        f'{shape}; remat {trainer.model_cfg.remat}; trainer_main {total_s:.2f}'
        f' s (load {timing["load_s"]:.2f} s, {len(steps)} steps, fp32 slice '
        f'save); step time {statistics.median(m["perf/step_time_s"] for m in steps[1:]):.4f} s '
        f'(median of steps 2-{len(steps)}); peak memory {peak / 1e9:.3f} GB '
        f'({resident / 1e9:.3f} GB resident before); '
        f'flash launches fwd {launches["fwd"]} (need >= {need["fwd"]}) bwd '
        f'{launches["bwd"]} (need >= {need["bwd"]}); card {smi}')
    if len(steps) != RM_STEPS or shape != (2 * RM_PAIRS, 512):
        raise AssertionError(f'{len(steps)} RM steps at {shape}')
    if not all(math.isfinite(m[k]) for m in steps
               for k in ('train/loss', 'train/grad_norm')):
        raise AssertionError('RM: non-finite loss or grad norm')
    check_launches('RM', launches, need)
    slice_dir = os.path.join(out, f'slice_{RM_STEPS}')
    written = sorted(os.listdir(slice_dir))
    log(f'phase11 export {slice_dir}: {written}')
    if not {'config.json', 'model.safetensors',
            'score_head.npy'} <= set(written):
        raise AssertionError('RM export lacks the slice or score_head.npy')

    # step 1 recomputed from the checkpoint and step 1's head, plain
    # attention, in bf16 and in fp32 compute
    params, mcfg = load_params(ckpt, device=dev)
    params['score_head'] = {'w': first['head']}
    plain = {}
    with torch.no_grad(), plain_flash():
        for dtype in ('bfloat16', 'float32'):
            plain[dtype] = score_model.forward(
                params, mcfg.replace(compute_dtype=dtype),
                first['batch']['input_ids'],
                attention_mask=first['batch']['attention_mask']
            ).end_scores.squeeze(-1).float()
    del params
    log(f'phase11 step 1 end scores: kernel {first["scores"].tolist()}, '
        f'plain {plain["bfloat16"].tolist()}, plain fp32 '
        f'{plain["float32"].tolist()}')
    log('phase11 ' + check_scores('step 1 end scores', first['scores'],
                                  plain['bfloat16'], plain['float32']))

    # rm_score over the export: the trained model's end scores
    score_argv = ['--model_name_or_path', slice_dir, '--train_datasets', sft,
                  '--train_template', 'Alpaca',
                  '--output_dir', os.path.join(tmp, 'out_rm_score'),
                  '--per_device_eval_batch_size', '4']
    scorer, _, _ = run_trainer(RMScoreTrainer, 'text_to_text/rm', score_argv)
    with open(os.path.join(tmp, 'out_rm_score', 'scores.jsonl')) as f:
        written = [json.loads(line)['score'] for line in f]
    want = []
    with torch.no_grad():
        for batch in scorer.train_iterator.epoch_batches(0):
            batch = trainer.put_batch(batch)
            want += score_model.forward(
                trainer.state.params, trainer.model_cfg, batch['input_ids'],
                attention_mask=batch['attention_mask']
            ).end_scores.squeeze(-1).float().tolist()
    diff = max(abs(a - b) for a, b in zip(written, want))
    scale = max(abs(b) for b in want)
    log(f'phase11 rm_score: {len(written)} rows in scores.jsonl; max|diff| '
        f'against the trained model\'s end scores {diff:.3e} (max|score| '
        f'{scale:.3e}, tol {RL_TOL:g} x that)')
    if len(written) != RM_ROWS or not diff <= RL_TOL * scale:
        raise AssertionError('rm_score disagrees with the trained model')
    del trainer, scorer
    free_memory()
    return {'launches': launches, 'ckpt': ckpt, 'slice': slice_dir,
            'peak_gb': peak / 1e9}


def ppo_argv(actor: str, reward: str, data: str, out: str | None,
             *extra) -> list:
    """A PPO command line; with no ``out`` the run exports nothing."""
    return ['--actor_model_name_or_path', actor,
            '--reward_model_name_or_path', reward,
            '--train_datasets', data, '--train_template', 'PKUSafeRLHF',
            *(('--output_dir', out) if out else ()),
            '--save_checkpoint', 'False', '--epochs', '1', *extra]


def ppo_full(dev, smi, tmp: str, rm: dict) -> dict:
    """Phase 12: PPO at Llama-3-8B widths, 2 layers, through
    ``trainer_main(PPOTrainer, ...)``: the actor from phase 11's base
    checkpoint, reward and critic from its export; two rounds on the
    'batch' backend, then one on 'continuous'."""
    from align_anything_tpu_torch.models import score_model  # noqa: PLC0415
    from align_anything_tpu_torch.ops.logprobs import token_logprobs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.ppo import (  # noqa: PLC0415
        PPOTrainer)

    # prompts of 15-115 words: 20-121 tokens, the 128 bucket, so rows carry
    # 7-108 leading pads
    data = write_jsonl(os.path.join(tmp, 'prompts_8b.jsonl'),
                       prompt_rows(SEED + 72, PPO_PROMPTS, (15, 116)))
    common = ('--per_device_prompt_batch_size', str(PPO_ROUND),
              '--per_device_train_batch_size', str(PPO_MICRO),
              '--max_new_tokens', str(PPO_NEW), '--temperature', '1.0',
              '--update_iters', '1', '--padding_buckets', f'[{PPO_BUCKET}]')
    first: dict = {}
    score_rollout = PPOTrainer.score_rollout

    def recording(self, seq, mask):
        out = score_rollout(self, seq, mask)
        if not first:
            first.update(seq=seq.clone(), mask=mask.clone(),
                         **{k: v.clone() for k, v in out.items()})
        return out

    n_micro = PPO_ROUND // PPO_MICRO
    per_round = {'fwd': (4 + 2 * n_micro) * RL_LAYERS,
                 'bwd': 2 * n_micro * RL_LAYERS}
    runs = {}
    # the second run exports nothing: 6 GB more of disk writes (see phase
    # 9) for the same save the first run makes
    for backend, rounds, extra, out in (
            ('batch', 2, (), os.path.join(tmp, 'out_ppo_batch')),
            ('continuous', 1, ('--rollout_backend', 'continuous',
                               '--rollout_num_slots', '8',
                               '--train_size', str(PPO_ROUND)), None)):
        free_memory()
        resident = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        t0 = time.perf_counter()
        with mock.patch.object(PPOTrainer, 'score_rollout', recording):
            trainer, steps, timing = run_trainer(
                PPOTrainer, 'text_to_text/ppo', ppo_argv(
                    rm['ckpt'], rm['slice'], data, out, *common, *extra))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = flash_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = [m for m in steps if 'train/actor_loss' in m]
        for i, m in enumerate(steps):
            tps = m['perf/generated_tokens'] / m['perf/rollout_s']
            log(f'phase12 {backend} round {i + 1}: kl={m["train/kl_divergence"]!r}'
                f' actor_loss={m["train/actor_loss"]:.6e} critic_loss='
                f'{m["train/reward_critic_loss"]:.6e} reward='
                f'{m["train/reward"]:.6e} generated={m["perf/generated_tokens"]}'
                f' tokens; seconds: round {m["perf/step_time_s"]:.4f} = '
                f'rollout {m["perf/rollout_s"]:.4f} + scoring '
                f'{m["perf/scoring_s"]:.4f} + update {m["perf/update_s"]:.4f}'
                f' (+ loop); generated tokens/s {tps:.1f}')
        need = {k: rounds * v for k, v in per_round.items()}
        log(f'phase12 {backend}: trainer_main {total_s:.2f} s (4 models '
            f'loaded, {len(steps)} rounds, '
            f'{"fp32 actor slice saved" if out else "no export"}); peak '
            f'memory {peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB resident '
            f'before); flash launches fwd '
            f'{launches["fwd"]} (need >= {need["fwd"]}) bwd '
            f'{launches["bwd"]} (need >= {need["bwd"]}); card {smi}')
        if len(steps) != rounds or not all_finite(steps):
            raise AssertionError(f'PPO {backend}: {len(steps)} rounds, or a '
                                 'metric is not finite')
        check_launches(f'PPO {backend}', launches, need)
        runs[backend] = {'steps': steps, 'launches': launches,
                         'peak_gb': peak / 1e9}
        if backend != 'batch':
            del trainer
            free_memory()
            continue
        if steps[0]['train/kl_divergence'] != 0.0:
            raise AssertionError(f'round 1 KL {steps[0]["train/kl_divergence"]!r}'
                                 ' != 0.0')
        # round 1's scoring pass recomputed with the plain attention: the
        # actor's params then were the reference's, the critic's the
        # reward model's (the same export and head)
        seq, mask = first['seq'], first['mask']
        start = PPO_BUCKET - 1
        m = mask[:, 1:].float()[:, start:]
        with torch.no_grad(), plain_flash():
            logp = token_logprobs(trainer.ref_params, trainer.model_cfg, seq,
                                  attention_mask=mask)
            scores = {dtype: score_model.forward(
                trainer.reward_params,
                trainer.reward_cfg.replace(compute_dtype=dtype), seq,
                attention_mask=mask) for dtype in ('bfloat16', 'float32')}
        sums = {}
        for key in ('log_probs', 'ref_log_probs'):
            got = (first[key][:, start:] * m).sum(-1).double()
            want = (logp[:, start:] * m).sum(-1).double()
            sums[key] = float(((got - want).abs() / want.abs()).max())
        log(f'phase12 round 1 scoring pass recomputed with the plain '
            f'attention: masked log-prob sums, max relative diff per '
            f'sequence: ' + ', '.join(f'{k} {r:.3e}' for k, r in sums.items())
            + f' (tol {RL_TOL:g}); sequences {tuple(seq.shape)}, completion '
            f'lengths {m.sum(-1).int().tolist()}')
        if not all(r <= RL_TOL for r in sums.values()):
            raise AssertionError('PPO round 1 log-probs disagree with the '
                                 'plain attention')
        log('phase12 ' + check_scores(
            'round 1 reward', first['reward'],
            *(s.end_scores.squeeze(-1) for s in scores.values())))
        log('phase12 ' + check_scores(
            'round 1 values (masked)', first['reward_values'][:, start:] * m,
            *(s.scores.squeeze(-1)[:, :-1][:, start:] * m
              for s in scores.values())))
        first.clear()
        del trainer, logp, scores
    return {'launches': {k: sum(r['launches'][k] for r in runs.values())
                         for k in ('fwd', 'bwd')}, 'runs': runs}


def rl_small(dev, smi, tmp: str) -> str:
    """Phase 13 at bench.py's widths, 2 layers (phase 10's checkpoint and
    data): the cost model; PPO with eval_datasets (the generation eval);
    PPO with ptx_datasets; multi_ppo with 2 samples a prompt and RLOO.
    Returns the cost model's export."""
    from align_anything_tpu_torch.trainers.text_to_text.cost_model import (  # noqa: PLC0415
        CostModelTrainer)
    from align_anything_tpu_torch.trainers.text_to_text.multi_ppo import (  # noqa: PLC0415
        MultiPPOTrainer)
    from align_anything_tpu_torch.trainers.text_to_text.ppo import (  # noqa: PLC0415
        PPOTrainer)

    ckpt = os.path.join(tmp, 'small')
    out = os.path.join(tmp, 'cost')
    _, steps, _ = run_trainer(CostModelTrainer, 'text_to_text/rm', [
        '--model_name_or_path', ckpt,
        '--train_datasets', os.path.join(tmp, 'pref_small.jsonl'),
        '--train_template', 'PKUSafeRLHF', '--output_dir', out,
        '--save_checkpoint', 'False', '--epochs', '1',
        '--per_device_train_batch_size', '2'])
    cost = os.path.join(out, f'slice_{len(steps)}')
    log(f'phase13 cost model: losses {[m["train/loss"] for m in steps]}, '
        f'accuracy {[m["train/accuracy"] for m in steps]}; export '
        f'{sorted(os.listdir(cost))}')
    if not (len(steps) == 4 and all_finite(steps)
            and os.path.exists(os.path.join(cost, 'score_head.npy'))):
        raise AssertionError('cost model run failed')
    free_memory()

    data = write_jsonl(os.path.join(tmp, 'prompts_small.jsonl'),
                       prompt_rows(SEED + 73, 8, (10, 50)))
    common = ('--per_device_prompt_batch_size', '4',
              '--per_device_train_batch_size', '2', '--max_new_tokens', '32',
              '--padding_buckets', '[64]')
    cases = (
        ('eval', PPOTrainer, {}, ('--eval_datasets', data, '--eval_size', '4',
                                  '--per_device_eval_batch_size', '4')),
        ('ptx', PPOTrainer, {}, ('--ptx_datasets',
                                 os.path.join(tmp, 'sft_small.jsonl'),
                                 '--ptx_template', 'Alpaca')),
        # neither key is in ppo.yaml and a command-line override adds no
        # key (ROADMAP R9): the environment overrides reach them
        ('multi_ppo rloo', MultiPPOTrainer,
         {'ENV_PREFIX__TRAIN_CFGS__N_SAMPLES_PER_PROMPT': '2',
          'ENV_PREFIX__TRAIN_CFGS__ADVANTAGE_ESTIMATOR': 'rloo'}, ()))
    for name, cls, env, extra in cases:
        with mock.patch.dict(os.environ, env):
            trainer, steps, _ = run_trainer(cls, 'text_to_text/ppo', ppo_argv(
                ckpt, cost, data, os.path.join(tmp, f'ppo_{name[:3]}'),
                *common, *extra))
        rounds = [m for m in steps if 'train/actor_loss' in m]
        evals = [m for m in steps if 'eval/reward' in m]
        log(f'phase13 {name}: {len(rounds)} rounds, round 1 kl '
            f'{rounds[0]["train/kl_divergence"]!r}, actor_loss '
            f'{[m["train/actor_loss"] for m in rounds]}, '
            f'{rounds[0]["perf/generated_tokens"]} tokens generated in round 1'
            + (f', eval {evals}' if evals else '')
            + (f', ptx_loss {[m["train/ptx_loss"] for m in rounds]}'
               if name == 'ptx' else ''))
        ok = (len(rounds) == 2 and all_finite(steps)
              and rounds[0]['train/kl_divergence'] == 0.0)
        if name == 'eval':
            ok = ok and len(evals) == 1
        if name == 'ptx':
            ok = ok and all('train/ptx_loss' in m for m in rounds)
        if name.startswith('multi'):
            ok = ok and trainer.n_samples_per_prompt == 2
        if not ok:
            raise AssertionError(f'phase 13 {name} failed')
        del trainer
        free_memory()
    log(f'phase13 done; card {smi}')
    return cost


# phases 14-17: KTO, GRPO, Safe-RLHF and the two PPO variants around the
# remote reward model, through their entry points.  Phase 14 runs phase
# 9's model and data; phase 15 phase 11's models and phase 12's prompts;
# phase 16 Qwen2.5-0.5B at its full size: six models at Llama-3-8B widths
# would hold 3 x 23.8 + 3 x 5.9 = 89 GB of state at 2 layers and 76 GB at
# 1 layer, more than the card; at 0.494 B params three trained models (16
# B/param) and three frozen ones (4 B/param) hold 29.6 GB.  These phases
# pass no --output_dir, so they write no fp32 export: phases 9-13 hold the
# export, and the card's machine ends a run whose disk writes pass 45 GiB
# (phases 9-13 with their checkpoints and exports come near it).
KTO_KL_STEPS, KTO_KL_BATCH = 2, 2
GRPO_PROMPTS, GRPO_ROUND, GRPO_GROUP, GRPO_ROUNDS = 8, 4, 4, 2
SAFE_PROMPTS, SAFE_ROUND, SAFE_MICRO, SAFE_ROUNDS = 16, 8, 4, 2
# the multiplier after round 1 against its closed form, float64 on the host
LAMBDA_TOL = 1e-6


def qwen05b_config():
    """Qwen/Qwen2.5-0.5B's published ``config.json``: the port's
    'qwen2-0.5b' preset (vocab 151936, hidden 896, 24 layers, 14 / 2 heads,
    D 64, MLP 4864, QKV bias) with tied embeddings."""
    from align_anything_tpu_torch.models.config import PRESETS  # noqa: PLC0415

    return PRESETS['qwen2-0.5b']().replace(tie_word_embeddings=True)


def masked_sums(logp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (logp.detach() * mask).sum(-1).double()


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def check_sums(tag: str, got: torch.Tensor, want: torch.Tensor,
               fp32: torch.Tensor | None = None) -> str:
    """Per-sequence log-prob sums against a plain recompute, relative,
    within RL_TOL; given the plain recompute in fp32 compute too, within
    SCORE_NOISE x the plain bf16 pass's own relative distance from it
    where that is larger (as ``check_scores`` holds a score)."""
    rel = relative_gap(got, want)
    limit, noise = RL_TOL, ''
    if fp32 is not None:
        bf16_noise = relative_gap(want, fp32)
        limit = max(RL_TOL, SCORE_NOISE * bf16_noise)
        noise = (f', bf16 noise (plain against fp32) {bf16_noise:.3e}, '
                 f'kernel against fp32 {relative_gap(got, fp32):.3e}')
    msg = (f'{tag}: max relative diff per sequence {rel:.3e}{noise} (limit '
           f'{limit:.3e})')
    if not rel <= limit:
        raise AssertionError(f'{msg}: the kernels disagree with the plain '
                             'attention')
    return msg


def kto_full(dev, smi, tmp: str) -> dict:
    """Phase 14: KTO through ``trainer_main(KTOTrainer, ...)`` on phase 9's
    checkpoint (Llama-3-8B widths, 4 layers) and rows, with the KL baseline
    refreshed before step 3."""
    from align_anything_tpu_torch.models.hf_loader import load_params  # noqa: PLC0415
    from align_anything_tpu_torch.ops.logprobs import token_logprobs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.kto import (  # noqa: PLC0415
        KTOTrainer)

    t_phase = time.perf_counter()
    free_memory()
    resident = torch.cuda.memory_allocated()
    ckpt = os.path.join(tmp, 'llama8b_4layers')
    argv = ['--model_name_or_path', ckpt,
            '--train_datasets', os.path.join(tmp, 'pref_8b.jsonl'),
            '--train_template', 'PKUSafeRLHF',
            '--save_checkpoint', 'False', '--epochs', '1',
            '--per_device_train_batch_size', str(DPO_PAIRS),
            '--kl_steps', str(KTO_KL_STEPS),
            '--per_device_kl_batch_size', str(KTO_KL_BATCH)]
    first: dict = {}
    refreshes: list = []
    preference_loss, refresh_kl = (KTOTrainer.preference_loss,
                                   KTOTrainer.refresh_kl)

    def recording(self, logp, ref_logp, batch):
        if not first:
            m = batch['divergence_mask']
            first.update(batch={k: batch[k].clone() for k in (
                'input_ids', 'attention_mask', 'divergence_mask')},
                sums=masked_sums(logp, m), ref_sums=masked_sums(ref_logp, m))
        return preference_loss(self, logp, ref_logp, batch)

    def timed_refresh(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refresh_kl(self)
        torch.cuda.synchronize()
        refreshes.append((self.global_step, self.kl,
                          time.perf_counter() - t0))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    with mock.patch.object(KTOTrainer, 'preference_loss', recording), \
            mock.patch.object(KTOTrainer, 'refresh_kl', timed_refresh):
        trainer, steps, timing = run_trainer(KTOTrainer, 'text_to_text/kto',
                                             argv, HARNESS_MESH)
    torch.cuda.synchronize()
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    mcfg = trainer.model_cfg
    del trainer
    free_memory()
    shape = tuple(first['batch']['input_ids'].shape)
    layers = mcfg.num_layers
    seconds = [m['perf/step_time_s'] for m in steps]
    for i, m in enumerate(steps):
        log(f'phase14 step {i + 1}: loss={m["train/loss"]!r} kl_baseline='
            f'{m["train/kl_baseline"]!r} grad_norm={m["train/grad_norm"]:.6e}'
            f' seconds={seconds[i]:.4f}')
    # every layer of every pass: the policy's forward and its recompute
    # under 'dots_saveable' and the reference's forward each step, the
    # backward, and the two no-grad passes of each KL estimate
    need = {'fwd': (3 * DPO_STEPS + 2 * len(refreshes)) * layers,
            'bwd': DPO_STEPS * layers}
    plain_steps = [s for i, s in enumerate(seconds) if i not in (0, 2)]
    step_s = statistics.median(plain_steps)
    log(f'phase14 KTO: batch {shape}, remat {mcfg.remat}; KL refreshes '
        f'(global_step, baseline, seconds) {refreshes}; step time '
        f'{step_s:.4f} s (median of steps 2 and 4), the refresh step 3 '
        f'{seconds[2]:.4f} s ({seconds[2] - step_s:+.4f} s); trainer_main '
        f'load {timing["load_s"]:.2f} s; peak memory {peak / 1e9:.3f} GB '
        f'({resident / 1e9:.3f} GB resident before); flash launches fwd '
        f'{launches["fwd"]} (need {need["fwd"]}) bwd {launches["bwd"]} '
        f'(need {need["bwd"]}); card {smi}')
    if len(steps) != DPO_STEPS or shape != (2 * DPO_PAIRS, DPO_SEQ):
        raise AssertionError(f'KTO: {len(steps)} steps at {shape}')
    if [g for g, _, _ in refreshes] != [0, KTO_KL_STEPS]:
        raise AssertionError(f'KTO: KL refreshes at {refreshes}')
    if steps[0]['train/kl_baseline'] != 0.0 or refreshes[0][1] != 0.0:
        raise AssertionError('KTO: the baseline at init is '
                             f'{refreshes[0][1]!r}, not 0.0')
    kl = steps[2]['train/kl_baseline']
    if not (math.isfinite(kl) and kl >= 0 and kl == refreshes[1][1]
            and steps[1]['train/kl_baseline'] == 0.0):
        raise AssertionError(f'KTO: refreshed baseline {kl!r}')
    if abs(steps[0]['train/loss']) > 1e-6:
        raise AssertionError(f'KTO step 1 loss {steps[0]["train/loss"]!r} '
                             'is not 0')
    if not all(math.isfinite(m[k]) for m in steps
               for k in ('train/loss', 'train/grad_norm')):
        raise AssertionError('KTO: non-finite loss or grad norm')
    check_launches('KTO', launches, need, exact=True)

    # step 1 recomputed from the checkpoint with the plain attention
    params, _ = load_params(ckpt, device=dev)
    b = first['batch']
    with torch.no_grad(), plain_flash():
        sums = masked_sums(token_logprobs(
            params, mcfg, b['input_ids'], attention_mask=b['attention_mask']),
            b['divergence_mask'])
    del params
    free_memory()
    log('phase14 step 1 recomputed with the plain attention, response '
        'log-prob sums: ' + check_sums('policy', first['sums'], sums)
        + '; ' + check_sums('reference', first['ref_sums'], sums))
    log(f'phase14 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'step_s': step_s,
            'refresh_s': seconds[2] - step_s, 'peak_gb': peak / 1e9}


def grpo_full(dev, smi, tmp: str, rm: dict) -> dict:
    """Phase 15: GRPO through ``trainer_main(GRPOTrainer, ...)``: the actor
    from phase 11's checkpoint (Llama-3-8B widths, 2 layers), the reward
    model from its export; 8 prompts in the 128 bucket, 4 a round, 4
    generations each, 128 new tokens, 2 rounds."""
    from align_anything_tpu_torch.models import score_model  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.grpo import (  # noqa: PLC0415
        GRPOTrainer)

    t_phase = time.perf_counter()
    free_memory()
    resident = torch.cuda.memory_allocated()
    argv = ['--actor_model_name_or_path', rm['ckpt'],
            '--reward_model_name_or_path', rm['slice'],
            '--train_datasets', os.path.join(tmp, 'prompts_8b.jsonl'),
            '--train_template', 'PKUSafeRLHF',
            '--save_checkpoint', 'False', '--epochs', '1',
            '--train_size', str(GRPO_PROMPTS),
            '--per_device_prompt_batch_size', str(GRPO_ROUND),
            '--num_generations', str(GRPO_GROUP),
            '--max_new_tokens', str(PPO_NEW), '--temperature', '1.0',
            '--padding_buckets', f'[{PPO_BUCKET}]']
    first: dict = {}
    reward_scores = GRPOTrainer.reward_scores

    def recording(self, seq, mask):
        out = reward_scores(self, seq, mask)
        if not first:
            first.update(seq=seq.clone(), mask=mask.clone(),
                         scores=out.detach().float().clone())
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    with mock.patch.object(GRPOTrainer, 'reward_scores', recording):
        trainer, steps, timing = run_trainer(GRPOTrainer, 'text_to_text/grpo',
                                             argv)
    torch.cuda.synchronize()
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    layers = trainer.model_cfg.num_layers
    for i, m in enumerate(steps):
        tps = m['perf/generated_tokens'] / m['perf/rollout_s']
        log(f'phase15 round {i + 1}: kl={m["train/kl"]!r} loss='
            f'{m["train/loss"]:.6e} reward={m["train/reward"]:.6e} grad_norm='
            f'{m["train/grad_norm"]:.6e} generated={m["perf/generated_tokens"]}'
            f' tokens; seconds: round {m["perf/step_time_s"]:.4f} = rollout '
            f'{m["perf/rollout_s"]:.4f} + scoring {m["perf/scoring_s"]:.4f} + '
            f'update {m["perf/update_s"]:.4f} (+ loop); generated tokens/s '
            f'{tps:.1f}')
    # a round: the reward model's, the policy's and the reference's
    # forward ('save_flash' keeps the policy's), the policy's backward
    need = {'fwd': GRPO_ROUNDS * 3 * layers, 'bwd': GRPO_ROUNDS * layers}
    log(f'phase15 GRPO: {GRPO_ROUND} prompts x {GRPO_GROUP} generations a '
        f'round, sequences {tuple(first["seq"].shape)}, remat '
        f'{trainer.model_cfg.remat}; load {timing["load_s"]:.2f} s; peak '
        f'memory {peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB resident '
        f'before); flash launches fwd {launches["fwd"]} (need {need["fwd"]}) '
        f'bwd {launches["bwd"]} (need {need["bwd"]}); card {smi}')
    if len(steps) != GRPO_ROUNDS or not all_finite(steps):
        raise AssertionError(f'GRPO: {len(steps)} rounds, or a metric is not '
                             'finite')
    if tuple(first['seq'].shape) != (GRPO_ROUND * GRPO_GROUP,
                                     PPO_BUCKET + PPO_NEW):
        raise AssertionError(f'GRPO rollout {tuple(first["seq"].shape)}')
    if not abs(steps[0]['train/kl']) <= 1e-6:
        raise AssertionError(f'GRPO round 1 KL {steps[0]["train/kl"]!r} is '
                             'not 0')
    check_launches('GRPO', launches, need, exact=True)
    with torch.no_grad(), plain_flash():
        plain = {dtype: score_model.forward(
            trainer.reward_params,
            trainer.reward_cfg.replace(compute_dtype=dtype), first['seq'],
            attention_mask=first['mask']).end_scores.squeeze(-1)
            for dtype in ('bfloat16', 'float32')}
    log('phase15 ' + check_scores('round 1 reward', first['scores'],
                                  *plain.values()))
    del trainer, plain
    first.clear()
    free_memory()
    log(f'phase15 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'steps': steps, 'peak_gb': peak / 1e9}


def saferlhf_full(dev, smi, tmp: str) -> dict:
    """Phase 16: Safe-RLHF through ``trainer_main(SafeRLHFTrainer, ...)`` at
    Qwen2.5-0.5B's full size: actor, reward and cost checkpoints written
    from seeds (bf16), the reward and cost heads fresh fp32 heads from
    seeds beside them, so each critic starts as its model; 16 prompts in
    the 128 bucket, 8 a round, 128 new tokens, micro-batch 4, 2 rounds."""
    from align_anything_tpu_torch.models import score_model  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import save_params  # noqa: PLC0415
    from align_anything_tpu_torch.ops.logprobs import token_logprobs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.saferlhf import (  # noqa: PLC0415
        SafeRLHFTrainer)

    t_phase = time.perf_counter()
    free_memory()
    cfg = qwen05b_config()
    ckpts = {}
    for i, name in enumerate(('actor', 'reward', 'cost')):
        ckpts[name] = os.path.join(tmp, f'qwen05b_{name}')
        save_params(ckpts[name], transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED + 80 + i),
            device=dev), cfg, dtype=torch.bfloat16)
        if name != 'actor':
            np.save(os.path.join(ckpts[name], 'score_head.npy'),
                    np.random.default_rng(SEED + 83 + i).standard_normal(
                        (cfg.hidden_size, 1)).astype(np.float32)
                    / math.sqrt(cfg.hidden_size))
    free_memory()
    resident = torch.cuda.memory_allocated()
    data = write_jsonl(os.path.join(tmp, 'prompts_qwen.jsonl'),
                       prompt_rows(SEED + 86, SAFE_PROMPTS, (15, 116)))
    argv = ['--actor_model_name_or_path', ckpts['actor'],
            '--reward_model_name_or_path', ckpts['reward'],
            '--cost_model_name_or_path', ckpts['cost'],
            '--train_datasets', data, '--train_template', 'PKUSafeRLHF',
            '--save_checkpoint', 'False', '--epochs', '1',
            '--per_device_prompt_batch_size', str(SAFE_ROUND),
            '--per_device_train_batch_size', str(SAFE_MICRO),
            '--max_new_tokens', str(PPO_NEW), '--temperature', '1.0',
            '--update_iters', '1', '--padding_buckets', f'[{PPO_BUCKET}]']
    first: dict = {}
    score_rollout, score_cost = (SafeRLHFTrainer.score_rollout,
                                 SafeRLHFTrainer.score_cost)

    def recording_rollout(self, seq, mask, reward=None):
        out = score_rollout(self, seq, mask, reward)
        if 'seq' not in first:
            first.update(seq=seq.clone(), mask=mask.clone(),
                         **{k: v.clone() for k, v in out.items()})
        return out

    def recording_cost(self, seq, mask, **media):
        out = score_cost(self, seq, mask, **media)
        if 'cost' not in first:
            first.update({k: v.clone() for k, v in out.items()})
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    with mock.patch.object(SafeRLHFTrainer, 'score_rollout',
                           recording_rollout), \
            mock.patch.object(SafeRLHFTrainer, 'score_cost', recording_cost):
        trainer, steps, timing = run_trainer(
            SafeRLHFTrainer, 'text_to_text/saferlhf', argv)
    torch.cuda.synchronize()
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    mcfg = trainer.model_cfg
    n_params = sum(t.numel() for t in param_leaves(trainer.ref_params))
    for i, m in enumerate(steps):
        tps = m['perf/generated_tokens'] / m['perf/rollout_s']
        log(f'phase16 round {i + 1}: kl={m["train/kl_divergence"]!r} '
            f'actor_loss={m["train/actor_loss"]:.6e} reward_critic_loss='
            f'{m["train/reward_critic_loss"]:.6e} cost_critic_loss='
            f'{m["train/cost_critic_loss"]:.6e} reward={m["train/reward"]:.6e}'
            f' cost={m["train/cost"]:.6e} lambda={m["train/lambda"]!r} '
            f'log_lambda={m["train/log_lambda"]!r} episode_cost='
            f'{m["train/episode_cost"]!r} generated='
            f'{m["perf/generated_tokens"]} tokens; seconds: round '
            f'{m["perf/step_time_s"]:.4f} = rollout {m["perf/rollout_s"]:.4f}'
            f' + scoring {m["perf/scoring_s"]:.4f} + update '
            f'{m["perf/update_s"]:.4f} (+ loop); generated tokens/s '
            f'{tps:.1f}')
    n_micro = SAFE_ROUND // SAFE_MICRO
    # a round: 6 scoring passes (actor, reference, reward, critic, cost,
    # cost critic), then per micro-batch the actor's, the critic's and the
    # cost critic's forward ('save_flash') and backward
    need = {'fwd': SAFE_ROUNDS * (6 + 3 * n_micro) * mcfg.num_layers,
            'bwd': SAFE_ROUNDS * 3 * n_micro * mcfg.num_layers}
    log(f'phase16 Safe-RLHF config: Qwen2.5-0.5B (vocab {mcfg.vocab_size}, '
        f'hidden {mcfg.hidden_size}, {mcfg.num_layers} layers, '
        f'{mcfg.num_heads} / {mcfg.num_kv_heads} heads, D {mcfg.head_dim}, '
        f'MLP {mcfg.mlp_dim}, QKV bias, tied embeddings), {n_params / 1e9:.3f}'
        f' B params a model, six models; sequences '
        f'{tuple(first["seq"].shape)}, micro-batch {SAFE_MICRO}, remat '
        f'{mcfg.remat}; load {timing["load_s"]:.2f} s; peak memory '
        f'{peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB resident before); '
        f'flash launches fwd {launches["fwd"]} (need {need["fwd"]}) bwd '
        f'{launches["bwd"]} (need {need["bwd"]}); card {smi}')
    if len(steps) != SAFE_ROUNDS or not all_finite(steps):
        raise AssertionError(f'Safe-RLHF: {len(steps)} rounds, or a metric '
                             'is not finite')
    if steps[0]['train/kl_divergence'] != 0.0:
        raise AssertionError('Safe-RLHF round 1 KL '
                             f'{steps[0]["train/kl_divergence"]!r} != 0.0')
    check_launches('Safe-RLHF', launches, need, exact=True)
    # the multiplier after round 1 in closed form from that round's costs
    lam0 = 1.0
    mean_cost = float(np.mean(first['cost'].float().cpu().tolist()))
    want = math.log(lam0) + trainer.lambda_lr * float(np.clip(
        (mean_cost - trainer.threshold) * lam0, -1e6, 1e6))
    if trainer.lambda_max:
        want = min(want, math.log(float(trainer.lambda_max)))
    got = steps[0]['train/log_lambda']
    log(f'phase16 log_lambda after round 1 {got!r}, closed form {want!r} '
        f'(mean cost {mean_cost!r}, lambda_lr {trainer.lambda_lr}, lambda_max'
        f' {trainer.lambda_max}; tol {LAMBDA_TOL:g})')
    if not abs(got - want) <= LAMBDA_TOL:
        raise AssertionError('Safe-RLHF log_lambda disagrees with its '
                             'closed form')

    # round 1's scoring passes recomputed with the plain attention: the
    # actor then was the reference, each critic its model
    seq, mask = first['seq'], first['mask']
    start = PPO_BUCKET - 1
    m = mask[:, 1:].float()[:, start:]
    with torch.no_grad(), plain_flash():
        logp = {dtype: token_logprobs(
            trainer.ref_params, mcfg.replace(compute_dtype=dtype), seq,
            attention_mask=mask) for dtype in ('bfloat16', 'float32')}
        scores = {name: {dtype: score_model.forward(
            params, cfg_.replace(compute_dtype=dtype), seq,
            attention_mask=mask) for dtype in ('bfloat16', 'float32')}
            for name, params, cfg_ in (
                ('reward', trainer.reward_params, trainer.reward_cfg),
                ('cost', trainer.cost_params, trainer.cost_cfg))}
    # 24 layers of bf16: the plain pass's own distance from fp32 compute
    # bounds how far two bf16 passes that round differently may sit apart
    want_sums = [masked_sums(x[:, start:], m) for x in logp.values()]
    log('phase16 round 1 scoring recomputed with the plain attention: '
        + check_sums('log_probs', masked_sums(first['log_probs'][:, start:],
                                              m), *want_sums)
        + '; ' + check_sums('ref_log_probs', masked_sums(
            first['ref_log_probs'][:, start:], m), *want_sums))
    for name, end_key, values_key in (('reward', 'reward', 'reward_values'),
                                      ('cost', 'cost', 'cost_values')):
        s = scores[name]
        log('phase16 ' + check_scores(
            f'round 1 {name}', first[end_key],
            *(o.end_scores.squeeze(-1) for o in s.values())))
        log('phase16 ' + check_scores(
            f'round 1 {values_key} (masked)', first[values_key][:, start:] * m,
            *(o.scores.squeeze(-1)[:, :-1][:, start:] * m
              for o in s.values())))
    del trainer, logp, scores
    first.clear()
    free_memory()
    log(f'phase16 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'steps': steps, 'peak_gb': peak / 1e9}


def free_port() -> int:
    import socket  # noqa: PLC0415

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def start_reward_server(reward_fn: str) -> str:
    """The port's stdlib reward server in a daemon thread on a free port of
    127.0.0.1, polled until it accepts; returns its endpoint."""
    import socket  # noqa: PLC0415

    from align_anything_tpu_torch.models.remote_rm import server  # noqa: PLC0415

    port = free_port()
    threading.Thread(target=server.start_server, kwargs={
        'host': '127.0.0.1', 'port': port, 'reward_fn_name': reward_fn,
        'use_flask': False}, daemon=True).start()
    deadline = time.monotonic() + 30
    while True:
        try:
            socket.create_connection(('127.0.0.1', port), timeout=1).close()
            return f'http://127.0.0.1:{port}/get_reward'
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.01)


def rl_variants_small(dev, smi, tmp: str, cost: str) -> dict:
    """Phase 17 at bench.py's widths, 2 layers (phase 10's checkpoint, phase
    13's cost model as the reward model): PPO against the port's reward
    server for one round, PPO with the continuous rollout by default for
    one round, and one step each of KTO and GRPO."""
    from align_anything_tpu_torch.models.remote_rm import get_reward_function  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.grpo import (  # noqa: PLC0415
        GRPOTrainer)
    from align_anything_tpu_torch.trainers.text_to_text.kto import (  # noqa: PLC0415
        KTOTrainer)
    from align_anything_tpu_torch.trainers.text_to_text.ppo_remote_rm import (  # noqa: PLC0415
        PPORemoteRMTrainer)
    from align_anything_tpu_torch.trainers.text_to_text.ppo_vllm import (  # noqa: PLC0415
        PPOVLLMTrainer)

    t_phase = time.perf_counter()
    free_memory()
    reset_flash_counts()
    ckpt = os.path.join(tmp, 'small')
    data = os.path.join(tmp, 'prompts_small.jsonl')
    common = ('--per_device_prompt_batch_size', '4',
              '--per_device_train_batch_size', '2', '--max_new_tokens', '32',
              '--padding_buckets', '[64]', '--train_size', '4')

    endpoint = start_reward_server('example_length')
    rollouts = []
    rollout = PPORemoteRMTrainer.rollout

    def recording(self, prompt_batch):
        out = rollout(self, prompt_batch)
        rollouts.append((self, {k: v for k, v in out.items()}))
        return out

    with mock.patch.object(PPORemoteRMTrainer, 'rollout', recording):
        trainer, steps, _ = run_trainer(
            PPORemoteRMTrainer, 'text_to_text/ppo', ppo_argv(
                ckpt, cost, data, None, *common,
                '--reward_server_endpoint', endpoint))
    (_, r), = rollouts
    start = int(r['start'])
    prompts, responses = trainer.decode_rollout(
        r['input_ids'][:, :start + 1].cpu().numpy(),
        r['input_ids'][:, start + 1:].cpu().numpy())
    want = np.asarray(get_reward_function('example_length')(
        prompts, responses), np.float32).tolist()
    got = r['reward'].cpu().tolist()
    log(f'phase17 ppo_remote_rm against {endpoint}: {len(steps)} round, '
        f'kl {steps[0]["train/kl_divergence"]!r}, rewards {got} (the rule '
        f'over the decoded texts: {want}), actor_loss '
        f'{steps[0]["train/actor_loss"]:.6e}')
    if not (len(steps) == 1 and all_finite(steps) and got == want
            and r['reward'].dtype == torch.float32
            and steps[0]['train/kl_divergence'] == 0.0):
        raise AssertionError('phase 17 ppo_remote_rm failed')
    del trainer, rollouts, r
    free_memory()

    trainer, steps, _ = run_trainer(PPOVLLMTrainer, 'text_to_text/ppo',
                                    ppo_argv(ckpt, cost, data, None, *common))
    log(f'phase17 ppo_vllm: backend {trainer.rollout_backend}, {len(steps)} '
        f'round, kl {steps[0]["train/kl_divergence"]!r}, '
        f'{steps[0]["perf/generated_tokens"]} tokens generated')
    if not (trainer.rollout_backend == 'continuous'
            and trainer._cont_engine is not None and len(steps) == 1
            and all_finite(steps)
            and steps[0]['train/kl_divergence'] == 0.0):
        raise AssertionError('phase 17 ppo_vllm failed')
    del trainer
    free_memory()

    _, steps, _ = run_trainer(KTOTrainer, 'text_to_text/kto', [
        '--model_name_or_path', ckpt,
        '--train_datasets', os.path.join(tmp, 'pref_small.jsonl'),
        '--train_template', 'PKUSafeRLHF', '--epochs', '1',
        '--save_checkpoint', 'False', '--train_size', '2',
        '--per_device_train_batch_size', '2',
        '--per_device_kl_batch_size', '2'])
    log(f'phase17 kto: {len(steps)} step, loss {steps[0]["train/loss"]!r}, '
        f'kl_baseline {steps[0]["train/kl_baseline"]!r}')
    if not (len(steps) == 1 and all_finite(steps)
            and abs(steps[0]['train/loss']) <= 1e-6
            and steps[0]['train/kl_baseline'] == 0.0):
        raise AssertionError('phase 17 kto failed')
    free_memory()

    _, steps, _ = run_trainer(GRPOTrainer, 'text_to_text/grpo', [
        '--actor_model_name_or_path', ckpt,
        '--reward_model_name_or_path', cost, '--train_datasets', data,
        '--train_template', 'PKUSafeRLHF', '--epochs', '1',
        '--save_checkpoint', 'False', '--train_size', '2',
        '--per_device_prompt_batch_size', '2', '--num_generations', '2',
        '--max_new_tokens', '32', '--padding_buckets', '[64]'])
    log(f'phase17 grpo: {len(steps)} round, kl {steps[0]["train/kl"]!r}, '
        f'loss {steps[0]["train/loss"]:.6e}, reward '
        f'{steps[0]["train/reward"]:.6e}')
    if not (len(steps) == 1 and all_finite(steps)
            and abs(steps[0]['train/kl']) <= 1e-6):
        raise AssertionError('phase 17 grpo failed')
    free_memory()
    launches = flash_counts()
    log(f'phase17 done in {time.perf_counter() - t_phase:.1f} s; flash '
        f'launches fwd {launches["fwd"]} bwd {launches["bwd"]}; card {smi}')
    if not (launches['fwd'] and launches['bwd']):
        raise AssertionError('phase 17 launched no flash kernel')
    return {'launches': launches}


# phase 18: text-image-to-text DPO at LLaVA-1.5-7B widths through its
# entry point; 18b: TI2T SFT with the tower trained and frozen.  The widths
# are llava-hf/llava-1.5-7b-hf's config.json: a Llama-2-7B-width language
# model (vocab 32064, hidden 4096, 32 heads of 128, MLP 11008, RMS eps
# 1e-5, rope theta 10000) cut to 4 layers, so that its fp32 params, grads
# and AdamW moments fit one card as phase 7's do; the CLIP ViT-L/14 tower
# at 336 px at its full 24 layers (hidden 1024, 16 heads of 64, MLP 4096,
# quick_gelu; features from layer -2, the class token dropped: 576 image
# tokens a row); the 2-layer GELU projector; image token 32000.  The
# tower is frozen (the YAML's freeze_vision_tower), so it runs forward
# only: 23 layers a pass, for the policy and the reference.
TI2T_TEXT_LAYERS, TI2T_PAIRS, TI2T_STEPS, TI2T_BUCKET = 4, 2, 4, 1024
TI2T_SMALL_TEXT_LAYERS, TI2T_SMALL_TOWER_LAYERS = 2, 4
TI2T_SMALL_ROWS, TI2T_SMALL_BATCH = 4, 2


def llava_config(text_layers: int = TI2T_TEXT_LAYERS,
                 tower_layers: int = 24):
    """llava-hf/llava-1.5-7b-hf's published widths, depth cut to
    ``text_layers`` / ``tower_layers``."""
    from align_anything_tpu_torch.models.config import ModelConfig  # noqa: PLC0415
    from align_anything_tpu_torch.models.multimodal import (  # noqa: PLC0415
        MultimodalConfig)
    from align_anything_tpu_torch.models.vision import ViTConfig  # noqa: PLC0415

    text = ModelConfig(vocab_size=32064, hidden_size=4096,
                       num_layers=text_layers, num_heads=32, num_kv_heads=32,
                       head_dim=128, mlp_dim=11008,
                       max_position_embeddings=4096, rope_theta=10000.0,
                       norm_eps=1e-5, bos_token_id=1, eos_token_id=2,
                       pad_token_id=32001)
    tower = ViTConfig(image_size=336, patch_size=14, hidden_size=1024,
                      num_layers=tower_layers, num_heads=16, mlp_dim=4096,
                      activation='quick_gelu', feature_layer=-2,
                      feature_select='default')
    return MultimodalConfig(text=text, vision=tower, image_token_id=32000)


def pillow_available() -> bool:
    try:
        import PIL.Image  # noqa: F401, PLC0415
    except ImportError:
        return False
    return True


def ti2t_images(tmp: str, n: int, size: int, seed: int) -> list:
    """``n`` random RGB images at the tower's size, written as PNG files
    (the data layer opens an image file with Pillow, which must import)."""
    from PIL import Image  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        arr = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
        path = os.path.join(tmp, f'ti2t_{seed}_{i}.png')
        Image.fromarray(arr).save(path)
        paths.append(path)
    return paths


def ti2t_rows(images: list, seed: int, preference: bool) -> list:
    """AA_TI2T rows of random words over ``images``: a question of 100-150
    words and responses of 50-250, so a row (576 image tokens, the chat
    format's words) fits the 1024 bucket."""
    rng = np.random.default_rng(seed)
    rows = []
    for image in images:
        row = {'question': words(rng, int(rng.integers(100, 151))),
               'image': image}
        if preference:
            row.update(response_1=words(rng, int(rng.integers(50, 251))),
                       response_2=words(rng, int(rng.integers(50, 251))),
                       overall_response=int(rng.integers(1, 3)))
        else:
            row['response'] = words(rng, int(rng.integers(50, 251)))
        rows.append(row)
    return rows


def run_ti2t(trainer_cls, task: str, argv: list,
             mesh_file: str | None = None) -> tuple:
    """``run_trainer`` for a TI2T trainer, timing the LLaVA checkpoints'
    loads (summed where the trainer loads several)."""
    from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: PLC0415
        sft as ti2t_sft)

    timing = {'load_s': 0.0}
    load = ti2t_sft.load_multimodal_params

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        out = load(*args, **kwargs)
        torch.cuda.synchronize()
        timing['load_s'] += time.perf_counter() - t0
        return out

    with mock.patch.object(ti2t_sft, 'load_multimodal_params', timed_load):
        trainer, steps, _ = run_trainer(trainer_cls, task, argv, mesh_file)
    return trainer, steps, timing


def write_llava(cfg, path: str, seed: int, dev) -> dict:
    """A LLaVA checkpoint of ``cfg`` with random weights from ``seed``,
    written in bf16 by the port's exporter: params per module, seconds and
    bytes."""
    from align_anything_tpu_torch.models import multimodal  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        save_multimodal_params)

    params = multimodal.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    n_params = {m: sum(t.numel() for t in param_leaves(params[m]))
                for m in params}
    t0 = time.perf_counter()
    save_multimodal_params(path, params, cfg, dtype=torch.bfloat16)
    write_s = time.perf_counter() - t0
    del params
    free_memory()
    return {'n_params': n_params, 'write_s': write_s,
            'bytes': os.path.getsize(os.path.join(path, 'model.safetensors'))}


def changed_modules(params: dict, start: dict) -> dict:
    """module -> whether any leaf of it differs from ``start``."""
    return {m: any(not torch.equal(a, start[m][k])
                   for k, a in leaves_by_path(params[m]).items())
            for m in params}


def ti2t_dpo_assets(cfg, dev, tmp: str) -> tuple:
    """Phase 18's checkpoint (seeded), its AA_TI2T preference rows and the
    command line: (checkpoint dir, what was written, images, argv)."""
    path = os.path.join(tmp, 'llava7b')
    w = write_llava(cfg, path, SEED + 80, dev)
    n = w['n_params']
    images = ti2t_images(tmp, TI2T_STEPS * TI2T_PAIRS,
                         cfg.vision.image_size, SEED + 81)
    data = write_jsonl(os.path.join(tmp, 'pref_llava.jsonl'),
                       ti2t_rows(images, SEED + 82, preference=True))
    argv = ['--model_name_or_path', path, '--train_datasets', data,
            '--train_template', 'AA_TI2T', '--save_checkpoint', 'False',
            '--epochs', '1', '--per_device_train_batch_size',
            str(TI2T_PAIRS), '--padding_buckets', f'[{TI2T_BUCKET}]']
    line = (f'wrote the checkpoint (LLaVA-1.5-7B widths, text '
            f'{cfg.text.num_layers} layers, tower {cfg.vision.num_layers} '
            f'layers; params language_model '
            f'{n["language_model"] / 1e9:.3f} B, vision_tower '
            f'{n["vision_tower"] / 1e9:.3f} B, projector '
            f'{n["projector"] / 1e9:.4f} B; bf16 safetensors in LLaVA '
            f'layout): {w["bytes"] / 1e9:.3f} GB in {w["write_s"]:.2f} s')
    return path, line, images, argv


def ti2t_full(dev, smi, tmp: str) -> dict:
    """Phase 18: TI2T DPO through ``trainer_main(TI2TDPOTrainer, ...)``
    (``python -m ...text_image_to_text.dpo``) at LLaVA-1.5-7B widths, from
    a bf16 LLaVA-layout checkpoint written by the port's exporter."""
    from align_anything_tpu_torch.models import multimodal  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_multimodal_params)
    from align_anything_tpu_torch.trainers.text_image_to_text.dpo import (  # noqa: PLC0415
        TI2TDPOTrainer)

    t_phase = time.perf_counter()
    free_memory()
    cfg = llava_config()
    ckpt, written, images, argv = ti2t_dpo_assets(cfg, dev, tmp)
    log(f'phase18 {written}; {len(images)} AA_TI2T preference rows over '
        f'PNG files; argv '
        f'{" ".join(argv[2:])}; MESH_FILE={HARNESS_MESH}')
    first: dict = {}
    preference_loss = TI2TDPOTrainer.preference_loss

    def recording(self, logp, ref_logp, batch):
        if not first:
            m = batch['response_mask']
            first.update(batch={k: batch[k].clone() for k in (
                'input_ids', 'attention_mask', 'response_mask',
                'pixel_values')},
                sums=masked_sums(logp, m), ref_sums=masked_sums(ref_logp, m))
        return preference_loss(self, logp, ref_logp, batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_flash_counts()
    t0 = time.perf_counter()
    with mock.patch.object(TI2TDPOTrainer, 'preference_loss', recording):
        trainer, steps, timing = run_ti2t(
            TI2TDPOTrainer, 'text_image_to_text/dpo', argv, HARNESS_MESH)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    mcfg = trainer.model_cfg
    start, _ = load_multimodal_params(ckpt, device=dev)
    moved = changed_modules(trainer.state.params,
                            {m: leaves_by_path(start[m]) for m in start})
    del trainer, start
    free_memory()
    b = first['batch']
    shape = tuple(b['input_ids'].shape)
    n_image = (b['input_ids'] == cfg.image_token_id).sum(-1).tolist()
    losses = [m['train/loss'] for m in steps]
    seconds = [m['perf/step_time_s'] for m in steps]
    for i, m in enumerate(steps):
        log(f'phase18 step {i + 1}: loss={losses[i]!r} grad_norm='
            f'{m["train/grad_norm"]:.6e} reward_accuracy='
            f'{m["train/reward_accuracy"]:.3f} seconds={seconds[i]:.4f}')
    step_s = statistics.median(seconds[1:])
    tps = shape[0] * shape[1] / step_s
    tower = cfg.vision.layers_run
    layers = mcfg.text.num_layers
    # each step: the tower's forward (frozen: no backward) for the policy
    # and for the reference, the language model's forward for both and
    # its recompute under 'dots_saveable', and its backward
    need = {'fwd': TI2T_STEPS * (2 * tower + 3 * layers),
            'bwd': TI2T_STEPS * layers}
    log(f'phase18 TI2T DPO: batch {shape} with pixel_values '
        f'{tuple(b["pixel_values"].shape)}; image tokens per row {n_image} '
        f'(576 patches: a row with more holds a text word that hashes to the '
        f'image token, ROADMAP R12); remat {mcfg.text.remat}, compute '
        f'{mcfg.text.compute_dtype}; trainer_main {total_s:.2f} s (load '
        f'{timing["load_s"]:.2f} s, {len(steps)} steps); step time '
        f'{step_s:.4f} s (median of steps 2-{len(steps)}), {tps:.1f} '
        f'tokens/s; peak memory {peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB '
        f'resident before); modules moved {moved}; flash launches fwd '
        f'{launches["fwd"]} (need {need["fwd"]}) bwd {launches["bwd"]} (need '
        f'{need["bwd"]}); card {smi}')
    if len(steps) != TI2T_STEPS or shape != (2 * TI2T_PAIRS, TI2T_BUCKET):
        raise AssertionError(f'TI2T DPO: {len(steps)} steps at {shape}')
    if abs(losses[0] - math.log(2)) > 1e-6:
        raise AssertionError(f'TI2T DPO step 1 loss {losses[0]!r} != ln 2')
    if not all_finite(steps):
        raise AssertionError('TI2T DPO: a non-finite metric')
    if moved != {'language_model': True, 'vision_tower': False,
                 'projector': True}:
        raise AssertionError(f'TI2T DPO: modules moved {moved}; the frozen '
                             'tower must stay bit-equal, the rest train')
    check_launches('TI2T DPO', launches, need, exact=True)

    # step 1 recomputed from the checkpoint with the plain attention, in
    # bf16 compute and in fp32 (the bf16 noise through 23 + 4 layers)
    params, _ = load_multimodal_params(ckpt, device=dev)
    sums = {}
    with torch.no_grad(), plain_flash():
        for dtype in ('bfloat16', 'float32'):
            sums[dtype] = masked_sums(multimodal.token_logprobs(
                params, mcfg.replace(compute_dtype=dtype), b['input_ids'],
                attention_mask=b['attention_mask'],
                pixel_values=b['pixel_values']), b['response_mask'])
    del params
    free_memory()
    log('phase18 step 1 recomputed with the plain attention, response '
        'log-prob sums: ' + check_sums('policy', first['sums'],
                                       sums['bfloat16'], sums['float32'])
        + '; ' + check_sums('reference', first['ref_sums'], sums['bfloat16'],
                            sums['float32']))
    log(f'phase18 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'step_s': step_s, 'tokens_per_s': tps,
            'peak_gb': peak / 1e9}


def ti2t_small(dev, smi, tmp: str) -> dict:
    """Phase 18b: TI2T SFT through ``trainer_main(TI2TSupervisedTrainer,
    ...)`` at LLaVA-1.5-7B widths, 2 text layers and 4 tower layers, the
    default remat ('save_flash'): once with the tower trained (its full-
    mode backward launched), once with the tower and the projector frozen
    (both bit-equal)."""
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_multimodal_params)
    from align_anything_tpu_torch.trainers.text_image_to_text.sft import (  # noqa: PLC0415
        TI2TSupervisedTrainer)

    t_phase = time.perf_counter()
    free_memory()
    cfg = llava_config(TI2T_SMALL_TEXT_LAYERS, TI2T_SMALL_TOWER_LAYERS)
    ckpt = os.path.join(tmp, 'llava7b_small')
    write_llava(cfg, ckpt, SEED + 85, dev)
    images = ti2t_images(tmp, TI2T_SMALL_ROWS, cfg.vision.image_size,
                         SEED + 86)
    data = write_jsonl(os.path.join(tmp, 'sft_llava.jsonl'),
                       ti2t_rows(images, SEED + 87, preference=False))
    base_argv = ['--model_name_or_path', ckpt, '--train_datasets', data,
                 '--train_template', 'AA_TI2T', '--save_checkpoint', 'False',
                 '--epochs', '1', '--per_device_train_batch_size',
                 str(TI2T_SMALL_BATCH), '--padding_buckets',
                 f'[{TI2T_BUCKET}]', '--learning_rate', '1e-4']
    n_steps = TI2T_SMALL_ROWS // TI2T_SMALL_BATCH
    tower, layers = cfg.vision.layers_run, cfg.text.num_layers
    total = {'fwd': 0, 'bwd': 0}
    runs = (('tower trained', ('--freeze_vision_tower', 'False'),
             {'language_model': True, 'vision_tower': True,
              'projector': True}, {'fwd': tower + layers,
                                   'bwd': tower + layers}),
            ('tower and projector frozen',
             ('--freeze_vision_tower', 'True', '--freeze_mm_proj', 'True'),
             {'language_model': True, 'vision_tower': False,
              'projector': False}, {'fwd': tower + layers, 'bwd': layers}))
    for name, flags, want_moved, per_step in runs:
        torch.cuda.synchronize()
        reset_flash_counts()
        trainer, steps, _ = run_ti2t(
            TI2TSupervisedTrainer, 'text_image_to_text/sft',
            base_argv + list(flags))
        torch.cuda.synchronize()
        launches = flash_counts()
        start, _ = load_multimodal_params(ckpt, device=dev)
        moved = changed_modules(trainer.state.params,
                                {m: leaves_by_path(start[m]) for m in start})
        remat = trainer.model_cfg.text.remat
        del trainer, start
        free_memory()
        need = {k: n_steps * v for k, v in per_step.items()}
        log(f'phase18b TI2T SFT, {name}: losses '
            f'{[m["train/loss"] for m in steps]}; remat {remat}; modules '
            f'moved {moved}; flash launches fwd {launches["fwd"]} (need '
            f'{need["fwd"]}) bwd {launches["bwd"]} (need {need["bwd"]}, the '
            f'tower\'s full-mode backward {launches["bwd"] - n_steps * layers})'
            f'; card {smi}')
        if len(steps) != n_steps or not all_finite(steps):
            raise AssertionError(f'TI2T SFT ({name}): {len(steps)} steps, '
                                 'or a non-finite metric')
        if moved != want_moved:
            raise AssertionError(f'TI2T SFT ({name}): modules moved {moved}'
                                 f', expected {want_moved}')
        check_launches(f'TI2T SFT ({name})', launches, need, exact=True)
        for k in total:
            total[k] += launches[k]
    log(f'phase18b done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': total, 'ckpt': ckpt}


# phases 19-21: the image-text reward model and RL trainers through their
# entry points.  Phases 19-20 run LLaVA-1.5-7B widths with the text model
# cut to 2 layers: PPO holds four LLaVA trees, and as in JAX its TI2T
# trainers freeze nothing (ROADMAP §3 R13), so actor and critic train all
# 0.99 B params at 16 B/param while reference and reward model hold 4
# B/param, about 40 GB; 4 text layers would be about 56 GB before
# activations.  The RL trainers take the compute dtype and no remat, as
# JAX's do.
TI2T_RM_ROWS, TI2T_RM_PAIRS, TI2T_RM_STEPS = 8, 2, 4
TI2T_PPO_PROMPTS, TI2T_PPO_ROUND, TI2T_PPO_MICRO = 24, 8, 4
TI2T_PPO_NEW, TI2T_PPO_WORDS = 128, (20, 61)
TI2T_SMALL_PROMPTS, TI2T_SMALL_NEW = 4, 16


def ti2t_prompt_rows(images: list, seed: int, words_range: tuple) -> list:
    """AA_TI2T prompt rows (the prompt-only set reads the question and the
    image) with questions of ``words_range`` words."""
    rng = np.random.default_rng(seed)
    return [{'question': words(rng, int(rng.integers(*words_range))),
             'image': image, 'response_1': 'a', 'response_2': 'b',
             'overall_response': 1} for image in images]


def disk_written() -> float:
    """GB this process has passed to ``write`` so far (``wchar`` of Linux
    ``/proc/self/io``, files and pipes alike; the card's machine ends a
    call past 45 GiB of disk writes); nan where the kernel has no such
    file.  A reading for the log, not a check."""
    try:
        with open('/proc/self/io') as f:
            fields = dict(line.split(': ') for line in f.read().splitlines())
    except OSError:
        return float('nan')
    return int(fields['wchar']) / 1e9


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def ti2t_rm_full(dev, smi, tmp: str) -> dict:
    """Phase 19: the TI2T reward model through ``trainer_main(
    TI2TRMTrainer, ...)`` at LLaVA-1.5-7B widths (text 2 layers, the
    24-layer tower frozen by rm.yaml) from a bf16 checkpoint written from a
    seed; 8 AA_TI2T preference rows with PNG images, 2 pairs a step in the
    1024 bucket, 4 steps, exported for phase 20."""
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_multimodal_params)
    from align_anything_tpu_torch.trainers.text_image_to_text.rm import (  # noqa: PLC0415
        TI2TRMTrainer, multimodal_end_scores)

    t_phase = time.perf_counter()
    free_memory()
    cfg = llava_config(RL_LAYERS)
    ckpt = os.path.join(tmp, 'llava7b_rl')
    w = write_llava(cfg, ckpt, SEED + 90, dev)
    images = ti2t_images(tmp, TI2T_RM_ROWS, cfg.vision.image_size,
                         SEED + 91)
    data = write_jsonl(os.path.join(tmp, 'pref_llava_rm.jsonl'),
                       ti2t_rows(images, SEED + 92, preference=True))
    out = os.path.join(tmp, 'out_ti2t_rm')
    argv = ['--model_name_or_path', ckpt, '--train_datasets', data,
            '--train_template', 'AA_TI2T', '--output_dir', out,
            '--save_checkpoint', 'False', '--epochs', '1',
            '--per_device_train_batch_size', str(TI2T_RM_PAIRS),
            '--padding_buckets', f'[{TI2T_BUCKET}]']
    first: dict = {}
    end_scores = TI2TRMTrainer.end_scores

    def recording(self, params, batch):
        better, worse = end_scores(self, params, batch)
        if not first:
            first.update(batch={k: v.clone() for k, v in batch.items()},
                         head=params['score_head']['w'].detach().clone(),
                         scores=torch.cat([better, worse]).detach().float())
        return better, worse

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_flash_counts()
    with mock.patch.object(TI2TRMTrainer, 'end_scores', recording):
        trainer, steps, timing = run_ti2t(TI2TRMTrainer,
                                          'text_image_to_text/rm', argv)
    torch.cuda.synchronize()
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    mcfg = trainer.model_cfg
    start, _ = load_multimodal_params(ckpt, device=dev)
    moved = changed_modules(
        {m: trainer.state.params[m] for m in start},
        {m: leaves_by_path(start[m]) for m in start})
    del trainer, start
    free_memory()
    b = first['batch']
    shape = tuple(b['input_ids'].shape)
    n_image = (b['input_ids'] == cfg.image_token_id).sum(-1).tolist()
    seconds = [m['perf/step_time_s'] for m in steps]
    for i, m in enumerate(steps):
        log(f'phase19 step {i + 1}: loss={m["train/loss"]:.9f} accuracy='
            f'{m["train/accuracy"]:.3f} grad_norm={m["train/grad_norm"]:.6e} '
            f'seconds={seconds[i]:.4f}')
    tower, layers = cfg.vision.layers_run, cfg.text.num_layers
    # a step: the frozen tower's forward, the language model's forward and
    # backward (no remat)
    need = {'fwd': TI2T_RM_STEPS * (tower + layers),
            'bwd': TI2T_RM_STEPS * layers}
    slice_dir = os.path.join(out, f'slice_{TI2T_RM_STEPS}')
    written = sorted(os.listdir(slice_dir)) if os.path.isdir(slice_dir) \
        else []
    disk = w['bytes'] + dir_bytes(slice_dir) + sum(
        os.path.getsize(i) for i in images)
    log(f'phase19 TI2T RM: batch {shape} with pixel_values '
        f'{tuple(b["pixel_values"].shape)}; image tokens per row {n_image}; '
        f'remat {mcfg.text.remat}, compute {mcfg.text.compute_dtype}; load '
        f'{timing["load_s"]:.2f} s; step time '
        f'{statistics.median(seconds[1:]):.4f} s (median of steps '
        f'2-{len(steps)}); peak memory {peak / 1e9:.3f} GB '
        f'({resident / 1e9:.3f} GB resident before); modules moved {moved}; '
        f'flash launches fwd {launches["fwd"]} (need {need["fwd"]}) bwd '
        f'{launches["bwd"]} (need {need["bwd"]}); export {written}; bytes '
        f'written {disk / 1e9:.3f} GB (checkpoint, export, images), '
        f'{disk_written():.3f} GB by the run so far; card {smi}')
    if len(steps) != TI2T_RM_STEPS or shape != (2 * TI2T_RM_PAIRS,
                                                TI2T_BUCKET):
        raise AssertionError(f'TI2T RM: {len(steps)} steps at {shape}')
    if set(n_image) != {cfg.vision.num_patches}:
        raise AssertionError(f'TI2T RM: image tokens per row {n_image}, not '
                             'one per patch (ROADMAP R12)')
    if not all_finite(steps):
        raise AssertionError('TI2T RM: a non-finite metric')
    if moved != {'language_model': True, 'vision_tower': False,
                 'projector': True}:
        raise AssertionError(f'TI2T RM: modules moved {moved}; the frozen '
                             'tower must stay bit-equal, the rest train')
    check_launches('TI2T RM', launches, need, exact=True)
    if not {'config.json', 'model.safetensors',
            'score_head.npy'} <= set(written):
        raise AssertionError('TI2T RM export lacks the slice or '
                             'score_head.npy')

    # step 1 recomputed from the checkpoint and step 1's head, plain
    # attention, in bf16 and in fp32 compute
    params, _ = load_multimodal_params(ckpt, device=dev)
    params['score_head'] = {'w': first['head']}
    with torch.no_grad(), plain_flash():
        plain = [multimodal_end_scores(
            params, mcfg.replace(compute_dtype=dtype), b).float()
            for dtype in ('bfloat16', 'float32')]
    del params
    free_memory()
    log('phase19 ' + check_scores('step 1 end scores', first['scores'],
                                  *plain))
    log(f'phase19 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'ckpt': ckpt, 'slice': slice_dir,
            'peak_gb': peak / 1e9}


def ti2t_ppo_full(dev, smi, tmp: str, rm: dict) -> dict:
    """Phase 20: TI2T PPO through ``trainer_main(TI2TPPOTrainer, ...)`` at
    LLaVA-1.5-7B widths, 2 text layers: the actor from phase 19's base
    checkpoint, reward model and critic from its export; 24 AA_TI2T
    prompts with PNG images in the 1024 bucket, 8 a round, 128 new tokens,
    micro-batch 4, three rounds; no export."""
    from align_anything_tpu_torch.models import multimodal  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_multimodal_params)
    from align_anything_tpu_torch.models.score_model import (  # noqa: PLC0415
        load_score_head)
    from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: PLC0415
        ppo as ti2t_ppo)
    from align_anything_tpu_torch.trainers.text_image_to_text.rm import (  # noqa: PLC0415
        multimodal_end_scores)

    t_phase = time.perf_counter()
    free_memory()
    cfg = llava_config(RL_LAYERS)
    images = ti2t_images(tmp, TI2T_PPO_PROMPTS, cfg.vision.image_size,
                         SEED + 93)
    data = write_jsonl(os.path.join(tmp, 'prompts_llava.jsonl'),
                       ti2t_prompt_rows(images, SEED + 94, TI2T_PPO_WORDS))
    argv = ['--actor_model_name_or_path', rm['ckpt'],
            '--reward_model_name_or_path', rm['slice'],
            '--train_datasets', data, '--train_template', 'AA_TI2T',
            '--save_checkpoint', 'False', '--epochs', '1',
            '--per_device_prompt_batch_size', str(TI2T_PPO_ROUND),
            '--per_device_train_batch_size', str(TI2T_PPO_MICRO),
            '--max_new_tokens', str(TI2T_PPO_NEW), '--temperature', '1.0',
            '--update_iters', '1', '--padding_buckets', f'[{TI2T_BUCKET}]']
    first: dict = {}
    trainer_cls = ti2t_ppo.TI2TPPOTrainer
    generate, score_rollout = ti2t_ppo.generate, trainer_cls.score_rollout

    def recording_generate(*args, **kwargs):
        prefill = kwargs['prefill_forward']

        def recording_prefill(params, cfg, ids, **kw):
            out = prefill(params, cfg, ids, **kw)
            if 'prefill' not in first:
                first['prefill'] = {
                    'ids': ids.clone(), 'pixels': kw['pixel_values'].clone(),
                    'mask': kw['attention_mask'][:, :ids.shape[1]].clone(),
                    'logits': out.logits[:, -1].float().clone()}
            return out

        return generate(*args, **dict(kwargs,
                                      prefill_forward=recording_prefill))

    def recording_scores(self, seq, mask, pixel_values):
        out = score_rollout(self, seq, mask, pixel_values)
        if 'seq' not in first:
            first.update(seq=seq.clone(), mask=mask.clone(),
                         **{k: v.clone() for k, v in out.items()})
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_flash_counts()
    t0 = time.perf_counter()
    with mock.patch.object(ti2t_ppo, 'generate', recording_generate), \
            mock.patch.object(trainer_cls, 'score_rollout',
                              recording_scores):
        trainer, steps, timing = run_ti2t(trainer_cls,
                                          'text_image_to_text/ppo', argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = [m for m in steps if 'train/actor_loss' in m]
    rounds = TI2T_PPO_PROMPTS // TI2T_PPO_ROUND
    for i, m in enumerate(steps):
        tps = m['perf/generated_tokens'] / m['perf/rollout_s']
        log(f'phase20 round {i + 1}: kl={m["train/kl_divergence"]!r} '
            f'actor_loss={m["train/actor_loss"]:.6e} critic_loss='
            f'{m["train/reward_critic_loss"]:.6e} reward='
            f'{m["train/reward"]:.6e} generated={m["perf/generated_tokens"]}'
            f' tokens; seconds: round {m["perf/step_time_s"]:.4f} = rollout '
            f'{m["perf/rollout_s"]:.4f} + scoring {m["perf/scoring_s"]:.4f} '
            f'+ update {m["perf/update_s"]:.4f} (+ loop); generated tokens/s '
            f'{tps:.1f}')
    tower, layers = cfg.vision.layers_run, cfg.text.num_layers
    n_micro = TI2T_PPO_ROUND // TI2T_PPO_MICRO
    # a round: the tower in the rollout's prefill (the text prefill and
    # decode run the cache path, no kernel); four scoring passes; per
    # micro-batch the actor's and the critic's forward and backward, the
    # tower's too (R13)
    model = tower + layers
    need = {'fwd': rounds * (tower + 4 * model + 2 * n_micro * model),
            'bwd': rounds * 2 * n_micro * model}
    pre = first['prefill']
    lead = (pre['mask'] == 0).sum(-1).tolist()
    n_image = (pre['ids'] == cfg.image_token_id).sum(-1).tolist()
    log(f'phase20 TI2T PPO: prompts {tuple(pre["ids"].shape)} (leading pads '
        f'{lead}; image tokens per row {n_image}), sequences '
        f'{tuple(first["seq"].shape)}, remat {trainer.model_cfg.text.remat}; '
        f'trainer_main {total_s:.2f} s (4 LLaVA trees loaded in '
        f'{timing["load_s"]:.2f} s, {len(steps)} rounds, no export); peak '
        f'memory {peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB resident '
        f'before); flash launches fwd {launches["fwd"]} (need {need["fwd"]}) '
        f'bwd {launches["bwd"]} (need {need["bwd"]}); card {smi}')
    if len(steps) != rounds or not all_finite(steps):
        raise AssertionError(f'TI2T PPO: {len(steps)} rounds, or a metric '
                             'is not finite')
    if tuple(first['seq'].shape) != (TI2T_PPO_ROUND,
                                     TI2T_BUCKET + TI2T_PPO_NEW):
        raise AssertionError(f'TI2T PPO rollout {tuple(first["seq"].shape)}')
    if set(n_image) != {cfg.vision.num_patches}:
        raise AssertionError(f'TI2T PPO: image tokens per prompt {n_image}, '
                             'not one per patch (ROADMAP R12)')
    if steps[0]['train/kl_divergence'] != 0.0:
        raise AssertionError(f'TI2T PPO round 1 KL '
                             f'{steps[0]["train/kl_divergence"]!r} != 0.0')
    check_launches('TI2T PPO', launches, need, exact=True)

    # R13: the YAML freezes the tower; JAX trains it, and so does the port
    start, _ = load_multimodal_params(rm['ckpt'], device=dev)
    critic0, _ = load_multimodal_params(rm['slice'], device=dev)
    critic0['score_head'] = {'w': load_score_head(
        rm['slice'], cfg.text.hidden_size, None, device=dev)}
    moved = {
        'actor': changed_modules(trainer.actor_state.params,
                                 {m: leaves_by_path(start[m])
                                  for m in start}),
        'critic': changed_modules(trainer.critic_state.params,
                                  {m: leaves_by_path(critic0[m])
                                   for m in critic0})}
    del start, critic0
    free_memory()
    log(f'phase20 modules moved after {rounds} rounds (freeze_vision_tower '
        f'{trainer.cfgs.train_cfgs.freeze_vision_tower}, which JAX\'s TI2T '
        f'PPO does not apply, ROADMAP R13): {moved}')
    if not all(all(m.values()) for m in moved.values()):
        raise AssertionError(f'TI2T PPO: modules moved {moved}; as in JAX, '
                             'every module of actor and critic trains')

    # round 1 recomputed with the plain attention (the actor's params then
    # were the reference's): the prefill's last logits against the model
    # without a cache, the scoring pass's log-prob sums and reward scores
    seq, mask = first['seq'], first['mask']
    start_pos = TI2T_BUCKET - 1
    cmask = mask[:, 1:].float()[:, start_pos:]
    batch = {'input_ids': seq, 'attention_mask': mask,
             'pixel_values': pre['pixels']}
    plain = {}
    with torch.no_grad(), plain_flash():
        for dtype in ('bfloat16', 'float32'):
            c = trainer.model_cfg.replace(compute_dtype=dtype)
            plain[dtype] = {
                'logits': multimodal.forward(
                    trainer.ref_params, c, pre['ids'],
                    attention_mask=pre['mask'],
                    pixel_values=pre['pixels']).logits[:, -1].float(),
                'sums': masked_sums(multimodal.token_logprobs(
                    trainer.ref_params, c, seq, attention_mask=mask,
                    pixel_values=pre['pixels'])[:, start_pos:], cmask),
                'reward': multimodal_end_scores(
                    trainer.reward_params,
                    trainer.reward_cfg.replace(compute_dtype=dtype),
                    batch).float()}
    del trainer
    free_memory()
    log('phase20 round 1 recomputed with the plain attention: ' + '; '.join((
        check_scores('first decode logits (image prefill, cache) against '
                     'the model without a cache', pre['logits'],
                     plain['bfloat16']['logits'],
                     plain['float32']['logits']),
        check_sums('scoring log_probs', masked_sums(
            first['log_probs'][:, start_pos:], cmask),
            plain['bfloat16']['sums'], plain['float32']['sums']),
        check_sums('scoring ref_log_probs', masked_sums(
            first['ref_log_probs'][:, start_pos:], cmask),
            plain['bfloat16']['sums'], plain['float32']['sums']),
        check_scores('scoring reward', first['reward'],
                     plain['bfloat16']['reward'],
                     plain['float32']['reward']))))
    first.clear()
    free_memory()
    log(f'phase20 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written():.3f} GB written by the run so far')
    return {'launches': launches, 'steps': steps, 'peak_gb': peak / 1e9}


def ti2t_rl_small(dev, smi, tmp: str, small: dict) -> dict:
    """Phase 21 at LLaVA-1.5-7B widths, 2 text and 4 tower layers (phase
    18b's checkpoint): through their entry points, the TI2T cost model,
    Safe-RLHF-V (one round), GRPO with 2 generations a prompt, KTO, ORPO
    and SimPO; every metric finite, every launch count exact, Safe-RLHF-V's
    first multiplier step in closed form and the RL trainers' round-1 KL
    0."""
    from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: PLC0415
        cost_model, grpo, kto, orpo, saferlhf, simpo)

    t_phase = time.perf_counter()
    free_memory()
    cfg = llava_config(TI2T_SMALL_TEXT_LAYERS, TI2T_SMALL_TOWER_LAYERS)
    tower, layers = cfg.vision.layers_run, cfg.text.num_layers
    model = tower + layers
    ckpt = small['ckpt']
    images = ti2t_images(tmp, TI2T_SMALL_ROWS, cfg.vision.image_size,
                         SEED + 95)
    pref = write_jsonl(os.path.join(tmp, 'pref_llava_small.jsonl'),
                       ti2t_rows(images, SEED + 96, preference=True))
    prompts = write_jsonl(os.path.join(tmp, 'prompts_llava_small.jsonl'),
                          ti2t_prompt_rows(images, SEED + 97, (20, 61)))
    common = ['--train_template', 'AA_TI2T', '--save_checkpoint', 'False',
              '--epochs', '1', '--padding_buckets', f'[{TI2T_BUCKET}]']
    pref_argv = ['--model_name_or_path', ckpt, '--train_datasets', pref,
                 '--per_device_train_batch_size', str(TI2T_SMALL_BATCH),
                 *common]
    # the score models are the base checkpoint with fresh heads: phases
    # 19-20 hold the RM export's handoff, and an export here would add
    # 3 GB of disk writes that nothing else reads
    rl_argv = ['--actor_model_name_or_path', ckpt,
               '--reward_model_name_or_path', ckpt,
               '--train_datasets', prompts, '--max_new_tokens',
               str(TI2T_SMALL_NEW), *common]
    n_steps = TI2T_SMALL_ROWS // TI2T_SMALL_BATCH
    safe_micro = 2            # micro-batches a Safe-RLHF-V round
    runs = (
        # (name, class, task, argv, launches: the cost model's frozen tower
        # runs forward only; Safe-RLHF-V's round: the prefill's tower, six
        # scoring passes, three models' forward and backward per
        # micro-batch; GRPO's round: the prefill's tower, the reward's,
        # policy's and reference's passes, the policy's backward; KTO: the
        # policy and the reference a step, its KL estimate at start-up two
        # text-only passes (R14); ORPO and SimPO: the policy alone; their
        # text YAMLs freeze nothing, so the tower runs backward too)
        ('cost model', cost_model.TI2TCostModelTrainer,
         'text_image_to_text/rm', pref_argv,
         {'fwd': n_steps * model, 'bwd': n_steps * layers}),
        ('Safe-RLHF-V', saferlhf.TI2TSafeRLHFTrainer,
         'text_image_to_text/saferlhf',
         [*rl_argv, '--train_size', str(safe_micro),
          '--per_device_prompt_batch_size', str(safe_micro),
          '--per_device_train_batch_size', '1'],
         {'fwd': tower + 6 * model + 3 * safe_micro * model,
          'bwd': 3 * safe_micro * model}),
        ('GRPO', grpo.TI2TGRPOTrainer, 'text_image_to_text/grpo',
         [*rl_argv, '--train_size', '2', '--per_device_prompt_batch_size',
          '2', '--num_generations', '2'],
         {'fwd': tower + 3 * model, 'bwd': model}),
        ('KTO', kto.TI2TKTOTrainer, 'text_to_text/kto',
         [*pref_argv, '--per_device_kl_batch_size', str(TI2T_SMALL_BATCH)],
         {'fwd': n_steps * 2 * model + 2 * layers, 'bwd': n_steps * model}),
        ('ORPO', orpo.TI2TORPOTrainer, 'text_to_text/orpo', pref_argv,
         {'fwd': n_steps * model, 'bwd': n_steps * model}),
        ('SimPO', simpo.TI2TSimPOTrainer, 'text_to_text/simpo', pref_argv,
         {'fwd': n_steps * model, 'bwd': n_steps * model}))
    total = {'fwd': 0, 'bwd': 0}
    for name, cls, task, argv, need in runs:
        torch.cuda.synchronize()
        reset_flash_counts()
        t0 = time.perf_counter()
        trainer, steps, _ = run_ti2t(cls, task, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = flash_counts()
        steps = [m for m in steps if any(k.startswith('train/loss')
                                         or k == 'train/actor_loss'
                                         for k in m)]
        loss_key = ('train/actor_loss' if 'train/actor_loss' in steps[0]
                    else 'train/loss')
        log(f'phase21 TI2T {name}: {len(steps)} steps, {loss_key} '
            f'{[m[loss_key] for m in steps]}; trainer_main {seconds:.2f} s; '
            f'flash launches fwd {launches["fwd"]} (need {need["fwd"]}) bwd '
            f'{launches["bwd"]} (need {need["bwd"]}); card {smi}')
        if not steps or not all_finite(steps):
            raise AssertionError(f'TI2T {name}: no step, or a non-finite '
                                 'metric')
        check_launches(f'TI2T {name}', launches, need, exact=True)
        if name == 'Safe-RLHF-V':
            m = steps[0]
            want = trainer.lambda_lr * m['train/episode_cost']
            log(f'phase21 Safe-RLHF-V round 1: log_lambda '
                f'{m["train/log_lambda"]!r}, lambda_lr x episode_cost '
                f'{want!r}; kl {m["train/kl_divergence"]!r}')
            if not (abs(m['train/log_lambda'] - want) <= 1e-9
                    and m['train/kl_divergence'] == 0.0):
                raise AssertionError('Safe-RLHF-V round 1: log_lambda is '
                                     'not lambda_lr x episode_cost, or KL '
                                     '!= 0')
        if name == 'GRPO' and not abs(steps[0]['train/kl']) <= 1e-6:
            raise AssertionError(f'TI2T GRPO step 1 KL '
                                 f'{steps[0]["train/kl"]!r} is not 0')
        del trainer
        free_memory()
        for k in total:
            total[k] += launches[k]
    log(f'phase21 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written():.3f} GB written by the run so far')
    return {'launches': total}


# phases 22-23: LoRA and QLoRA through the trainers' entry points.  Phase
# 22 runs DPO at Llama-3-8B's full size, all 32 layers, from the port's
# 'llama-3-8b' preset (fp32 weights drawn from the trainer's seed on the
# card), its base quantized in place by ``init_peft``: int4 (group 64,
# weight-only, the head int4, the embedding fp32), then int8; adapters on
# q_proj and v_proj, r 16, alpha 16 (the YAML's), over phase 9's rows.  No
# checkpoint or export is written at this size: an 8B bf16 checkpoint is 16
# GB, and a full run already writes 41 GB of the card machine's 45 GiB.
# Phase 23 runs every LoRA trainer at phase 10's depth.
QLORA_PRESET = 'llama-3-8b'
QLORA_STEPS, QLORA_INT8_STEPS = 4, 2
# a LoRA learning rate (dpo.yaml's 2e-5 is a full fine-tune's): in 4 steps
# the adapters move the policy's log-probs well past the bf16 noise, which
# the merge check needs to see them
QLORA_LR = 1e-4
LORA_FLAGS = {'lora': ('--use_lora', 'True'),
              'int4': ('--use_lora', 'True', '--use_bnb', 'True',
                       '--load_in_4bit', 'True'),
              'int8': ('--use_lora', 'True', '--use_bnb', 'True')}


def base_tensors(tree) -> list:
    """Every tensor of a (possibly quantized) param tree."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in base_tensors(v)]
    return q.weight_tensors(tree)


def tree_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# attached against merged, both in fp32 compute through the plain
# attention: the same sums in another order (2e-8 on the CPU at tiny
# widths); a wrong scaling or layout of the adapters' path reads about
# the adapters' own share, 1e-3 or more after phase 22's steps
MERGE_TOL = 1e-5


def merge_check(tag: str, trainer, batch: dict) -> list:
    """The trained adapters attached to the quantized base: (1) through the
    kernels in bf16 against the plain attention, per-sequence response
    log-prob sums within ``check_sums`` (3x the plain pass's own bf16 noise
    against fp32 compute); (2) in fp32 compute against ``merge_lora``'s
    dense tree (the base dequantized to fp32 plus s * A @ B), both through
    the plain attention, within MERGE_TOL."""
    from align_anything_tpu_torch.ops.logprobs import token_logprobs  # noqa: PLC0415

    cfg = trainer.model_cfg
    cfg32 = cfg.replace(compute_dtype='float32')
    ids, mask = batch['input_ids'], batch['attention_mask']

    def sums(params, c):
        return masked_sums(token_logprobs(params, c, ids,
                                          attention_mask=mask),
                           batch['response_mask'])

    with torch.no_grad():
        policy = trainer.lora_policy(trainer.state.params, trainer.base_params)
        got, base = sums(policy, cfg), sums(trainer.base_params, cfg)
        with plain_flash():
            want, fp32 = sums(policy, cfg), sums(policy, cfg32)
            merged = trainer.merged_params(trainer.state.params)
            merged32 = sums(merged, cfg32)
    del merged
    torch.cuda.empty_cache()
    msgs = [check_sums(f'{tag} attached, kernels against plain', got, want,
                       fp32)]
    gap = relative_gap(fp32, merged32)
    msgs.append(f'{tag} attached against merge_lora\'s dense tree, fp32: '
                f'max relative diff per sequence {gap:.3e} (limit '
                f'{MERGE_TOL:g}); the adapters move the sums by '
                f'{relative_gap(got, base):.3e} from the base\'s')
    if not gap <= MERGE_TOL:
        raise AssertionError(f'{msgs[-1]}: the attached adapters disagree '
                             'with the merged model')
    return msgs


def qlora_full(dev, smi, tmp: str, bits: int, steps: int) -> dict:
    """Phase 22: QLoRA DPO at Llama-3-8B's full 32 layers through
    ``trainer_main(DPOTrainer, ...)`` on a ``bits``-bit base."""
    from align_anything_tpu_torch.trainers.base import TrainerBase  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: PLC0415
        DPOTrainer)

    tag = f'phase22 int{bits}'
    argv = ['--model_name_or_path', QLORA_PRESET,
            '--train_datasets', os.path.join(tmp, 'pref_8b.jsonl'),
            '--train_template', 'PKUSafeRLHF', '--save_checkpoint', 'False',
            '--epochs', '1', '--per_device_train_batch_size', str(DPO_PAIRS),
            '--train_size', str(steps * DPO_PAIRS),
            '--learning_rate', str(QLORA_LR), *LORA_FLAGS[f'int{bits}']]
    seen: dict = {}
    train = TrainerBase.train

    def measured_train(self):
        # what the build left on the card, and the base and adapters as
        # they start, on the host; then the run's own peak and launches
        torch.cuda.synchronize()
        seen['build_peak'] = torch.cuda.max_memory_allocated()
        seen['resident'] = torch.cuda.memory_allocated()
        seen['base'] = [t.to('cpu', copy=True)
                        for t in base_tensors(self.base_params)]
        seen['adapters'] = [t.detach().to('cpu', copy=True)
                            for t in param_leaves(self.state.params)]
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        seen['t0'] = time.perf_counter()
        train(self)
        torch.cuda.synchronize()
        seen['train_s'] = time.perf_counter() - seen['t0']
        seen['peak'] = torch.cuda.max_memory_allocated()
        seen['launches'] = flash_counts()

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(TrainerBase, 'train', measured_train):
        trainer, metrics, _ = run_trainer(DPOTrainer, 'text_to_text/dpo',
                                          argv, HARNESS_MESH)
    build_s = seen['t0'] - t0
    cfg = trainer.model_cfg
    batch = trainer.put_batch(next(trainer.train_iterator.epoch_batches(0)))
    shape = tuple(batch['input_ids'].shape)
    kind = q.Int4Weight if bits == 4 else q.Int8Weight
    leaf = trainer.base_params['layers']['q']['w']
    losses = [m['train/loss'] for m in metrics]
    seconds = [m['perf/step_time_s'] for m in metrics]
    for i, m in enumerate(metrics):
        log(f'{tag} step {i + 1}: loss={losses[i]:.9f} grad_norm='
            f'{m["train/grad_norm"]:.6e} reward_accuracy='
            f'{m["train/reward_accuracy"]:.3f} seconds={seconds[i]:.4f}')
    step_s = statistics.median(seconds[1:])
    tps = shape[0] * shape[1] / step_s
    base_now = [t.cpu() for t in base_tensors(trainer.base_params)]
    base_same = len(base_now) == len(seen['base']) and all(
        torch.equal(a, b) for a, b in zip(base_now, seen['base']))
    adapters = param_leaves(trainer.state.params)
    moved = [not torch.equal(t.detach().cpu(), t0_)
             for t, t0_ in zip(adapters, seen['adapters'])]
    opt_bytes = tree_bytes(t for st in trainer.state.optimizer.state.values()
                           for t in st.values()
                           if isinstance(t, torch.Tensor) and t.ndim)
    need = {'fwd': steps * 3 * cfg.num_layers, 'bwd': steps * cfg.num_layers}
    launches = seen['launches']
    log(f'{tag} config: {cfg.num_layers} layers (not cut), vocab '
        f'{cfg.vocab_size}, hidden {cfg.hidden_size}, {cfg.num_heads} / '
        f'{cfg.num_kv_heads} heads of {cfg.head_dim}, MLP {cfg.mlp_dim}; '
        f'base leaves {type(leaf).__name__} (compute={leaf.compute}), head '
        f'{type(trainer.base_params["lm_head"]).__name__}, embedding '
        f'{trainer.base_params["embedding"].dtype}; adapters '
        f'{trainer.lora_targets} r {trainer.lora_r} alpha '
        f'{trainer.lora_alpha}; remat {cfg.remat}; batch {shape}')
    log(f'{tag} bytes: base {q.quantized_bytes(trainer.base_params) / 1e9:.3f}'
        f' GB (quantized_bytes), adapters {tree_bytes(adapters) / 1e6:.3f} '
        f'MB, AdamW moments {opt_bytes / 1e6:.3f} MB; after the build '
        f'{seen["resident"] / 1e9:.3f} GB resident, build peak '
        f'{seen["build_peak"] / 1e9:.3f} GB in {build_s:.1f} s (the '
        f'preset\'s fp32 draw and the quantization)')
    log(f'{tag} step time {step_s:.4f} s (median of steps 2-{len(seconds)}, '
        f'the loop\'s clock), {tps:.1f} tokens/s, training peak '
        f'{seen["peak"] / 1e9:.3f} GB, {len(metrics)} steps in '
        f'{seen["train_s"]:.2f} s; flash launches fwd {launches["fwd"]} '
        f'(need {need["fwd"]}) bwd {launches["bwd"]} (need {need["bwd"]}); '
        f'base bit-unchanged: {base_same}; adapters moved: {moved}; card '
        f'{smi}')
    if not (isinstance(leaf, kind) and not leaf.compute
            and isinstance(trainer.base_params['lm_head'], kind)
            and cfg.num_layers == 32 and shape == (2 * DPO_PAIRS, DPO_SEQ)):
        raise AssertionError(f'{tag}: not the QLoRA configuration asked for')
    if len(metrics) != steps or not all_finite(metrics):
        raise AssertionError(f'{tag}: {len(metrics)} steps, or a non-finite '
                             'metric')
    if abs(losses[0] - math.log(2)) > 1e-6:
        raise AssertionError(f'{tag}: step 1 loss {losses[0]} != ln 2')
    if not base_same or not all(moved):
        raise AssertionError(f'{tag}: the base moved or an adapter did not')
    check_launches(tag, launches, need, exact=True)
    for msg in merge_check(tag, trainer, batch):
        log(msg)
    out = {'launches': launches, 'step_s': step_s, 'tokens_per_s': tps,
           'peak_gb': seen['peak'] / 1e9}
    del trainer, batch, adapters
    free_memory()
    return out


def int8_product_check(dev) -> None:
    """The int8-COMPUTE product (``transformer.int8_product``, padded where
    the card's ``torch._int_mm`` needs it) exactly against an fp64 product
    (every sum below 2^53) at Llama-3-8B's shapes, decode rows included."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 140)
    for m, k, n in ((1, 4096, 6144), (16, 4096, 4096), (33, 14336, 4096),
                    (4096, 4096, 14336)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        got = transformer.int8_product(a, b)
        want = (a.double() @ b.double()).to(torch.int64)
        if got.dtype != torch.int32 or not torch.equal(got.long(), want):
            raise AssertionError(f'int8 product M {m} K {k} N {n} is not '
                                 'exact')
    log('phase23 int8 product exact at M 1 / 16 / 33 / 4096 against fp64')


def lora_small(dev, smi, tmp: str, cost: str) -> dict:
    """Phase 23 at bench.py's widths, 2 layers (phase 10's checkpoint and
    rows, phase 13's cost model as the reward model): every trainer that
    takes LoRA, with LoRA and DPO, RM and PPO also over int4 and int8
    bases; the invariants, the base against a fresh quantization of the
    checkpoint, the merged exports, a resume; and the trainers that refuse
    LoRA, as JAX's fail."""
    from align_anything_tpu_torch.models import lora as lora_lib  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import load_params  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text import (  # noqa: PLC0415
        cost_model, dpo, kto, multi_ppo, orpo, ppo, ppo_remote_rm, ppo_vllm,
        rm, saferlhf, sft, simpo)

    t_phase, disk0 = time.perf_counter(), disk_written()
    int8_product_check(dev)
    ckpt = os.path.join(tmp, 'small')
    pref = os.path.join(tmp, 'pref_small.jsonl')
    sft_data = os.path.join(tmp, 'sft_small.jsonl')
    prompts = os.path.join(tmp, 'prompts_small.jsonl')
    loaded, _ = load_params(ckpt, device=dev)
    loaded = tree_map(torch.Tensor.float, loaded)
    with torch.no_grad():
        fresh = {'lora': loaded,
                 'int4': q.quantize_decoder_int4(loaded),
                 'int8': q.quantize_decoder_int8(loaded)}

    def argv(data, template, out, *extra):
        return ['--model_name_or_path', ckpt, '--train_datasets', data,
                '--train_template', template, '--epochs', '1',
                '--per_device_train_batch_size', '2', '--save_checkpoint',
                'False', *(('--output_dir', os.path.join(tmp, out))
                           if out else ()), *extra]

    ppo_common = ('--per_device_prompt_batch_size', '4',
                  '--per_device_train_batch_size', '2', '--max_new_tokens',
                  '32', '--padding_buckets', '[64]', '--train_size', '4')
    rloo = {'ENV_PREFIX__TRAIN_CFGS__N_SAMPLES_PER_PROMPT': '2',
            'ENV_PREFIX__TRAIN_CFGS__ADVANTAGE_ESTIMATOR': 'rloo'}
    # (name, class, task, argv, environment, mode); an ``out`` directory
    # exports the merged model, checked below
    cases = [('sft', sft.SupervisedTrainer, 'text_to_text/sft',
              argv(sft_data, 'Alpaca', 'lora_sft'), {}, 'lora')]
    for mode in ('lora', 'int4', 'int8'):
        cases.append((f'dpo {mode}', dpo.DPOTrainer, 'text_to_text/dpo',
                      argv(pref, 'PKUSafeRLHF', None), {}, mode))
    cases += [
        ('orpo', orpo.ORPOTrainer, 'text_to_text/orpo',
         argv(pref, 'PKUSafeRLHF', None, '--train_size', '4'), {}, 'lora'),
        ('simpo', simpo.SimPOTrainer, 'text_to_text/simpo',
         argv(pref, 'PKUSafeRLHF', None, '--train_size', '4'), {}, 'lora'),
        # a KL batch larger than the rows: no KL estimate, which JAX's LoRA
        # KTO cannot take (R18)
        ('kto', kto.KTOTrainer, 'text_to_text/kto',
         argv(pref, 'PKUSafeRLHF', None, '--per_device_kl_batch_size', '64'),
         {}, 'lora')]
    for mode in ('lora', 'int4', 'int8'):
        cases.append((f'rm {mode}', rm.RMTrainer, 'text_to_text/rm',
                      argv(pref, 'PKUSafeRLHF',
                           'lora_rm' if mode == 'int4' else None), {}, mode))
    cases.append(('cost model', cost_model.CostModelTrainer,
                  'text_to_text/rm', argv(pref, 'PKUSafeRLHF', None), {},
                  'lora'))
    for mode in ('lora', 'int4', 'int8'):
        cases.append((f'ppo batch {mode}', ppo.PPOTrainer, 'text_to_text/ppo',
                      ppo_argv(ckpt, cost, prompts,
                               os.path.join(tmp, 'lora_ppo')
                               if mode == 'int4' else None, *ppo_common),
                      {}, mode))
    cases += [
        ('ppo_vllm continuous', ppo_vllm.PPOVLLMTrainer, 'text_to_text/ppo',
         ppo_argv(ckpt, cost, prompts, None, *ppo_common), {}, 'lora'),
        ('multi_ppo rloo', multi_ppo.MultiPPOTrainer, 'text_to_text/ppo',
         ppo_argv(ckpt, cost, prompts, None, *ppo_common), rloo, 'lora')]

    total = {'fwd': 0, 'bwd': 0}
    for name, cls, task, args, env, mode in cases:
        reset_flash_counts()
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, env):
            trainer, steps, _ = run_trainer(cls, task,
                                            args + list(LORA_FLAGS[mode]))
        seconds = time.perf_counter() - t0
        launches = flash_counts()
        rl = 'actor_state' in vars(trainer)
        state = trainer.actor_state if rl else trainer.state
        adapters = state.params['lora'] if 'lora' in state.params \
            else state.params
        base = trainer.base_params
        want = fresh[mode]
        same = all(torch.equal(a, b) for k in ('layers', 'lm_head',
                                               'embedding')
                   for a, b in zip(base_tensors(base[k]),
                                   base_tensors(want[k])))
        b_moved = all(bool(adapters[m]['b'].detach().ne(0).any())
                      for m in adapters)
        rounds = [m for m in steps if 'train/actor_loss' in m]
        first = (rounds or steps)[0]
        loss_key = 'train/actor_loss' if rounds else 'train/loss'
        log(f'phase23 {name}: {len(rounds or steps)} steps, {loss_key} '
            f'{[m[loss_key] for m in (rounds or steps)]}'
            + (f', round 1 kl {first["train/kl_divergence"]!r}' if rounds
               else '')
            + f'; base {type(base["layers"]["q"]["w"]).__name__}, equal to '
            f'a fresh quantization of the checkpoint: {same}; every B moved: '
            f'{b_moved}; flash fwd {launches["fwd"]} bwd {launches["bwd"]}; '
            f'{seconds:.2f} s')
        layers = trainer.model_cfg.num_layers
        ok = (trainer.use_lora and steps and all_finite(steps) and same
              and b_moved and launches['fwd'] >= layers * len(steps)
              and launches['bwd'] >= layers * len(rounds or steps))
        if name.startswith('dpo'):
            ok = ok and abs(first['train/loss'] - math.log(2)) <= 1e-6
        if rounds:
            ok = ok and first['train/kl_divergence'] == 0.0
        if not ok:
            raise AssertionError(f'phase 23 {name} failed')
        out = trainer.cfgs.logger_cfgs.output_dir
        if out:
            n = trainer.global_step
            back, _ = load_params(os.path.join(out, f'slice_{n}'),
                                  device=dev)
            merged = trainer.merged_params(adapters)
            got = leaves_by_path(back)
            exp = leaves_by_path({k: v for k, v in merged.items()
                                  if k != 'score_head'})
            exported = set(got) == set(exp) and all(
                torch.equal(got[p], exp[p]) for p in exp)
            head = True
            if 'score_head' in state.params:
                head = np.array_equal(
                    np.load(os.path.join(out, f'slice_{n}',
                                         'score_head.npy')),
                    state.params['score_head']['w'].detach().cpu().numpy())
            log(f'phase23 {name}: slice_{n} read back bit-equal to '
                f'merge_lora of the trained adapters: {exported}'
                + ('' if head is True else f'; score_head.npy: {head}'))
            if not (exported and head):
                raise AssertionError(f'phase 23 {name}: the merged export '
                                     'does not read back')
            del back, merged, got, exp
        for k in total:
            total[k] += launches[k]
        del trainer, state, adapters, base
        free_memory()

    # resume: QLoRA DPO saved at step 2, resumed for steps 3-4, against the
    # uninterrupted run's metrics and adapters
    full, full_steps, _ = run_trainer(
        dpo.DPOTrainer, 'text_to_text/dpo',
        argv(pref, 'PKUSafeRLHF', 'lora_full', '--save_checkpoint', 'True',
             '--save_interval', '2', '--save_total_limit', '3',
             *LORA_FLAGS['int4']))
    os.makedirs(os.path.join(tmp, 'lora_resumed', 'checkpoints'))
    shutil.copytree(os.path.join(tmp, 'lora_full', 'checkpoints', 'step_2'),
                    os.path.join(tmp, 'lora_resumed', 'checkpoints',
                                 'step_2'))
    resumed, resumed_steps, _ = run_trainer(
        dpo.DPOTrainer, 'text_to_text/dpo',
        argv(pref, 'PKUSafeRLHF', 'lora_resumed', '--load_checkpoint',
             'True', *LORA_FLAGS['int4']))
    want = [(m['train/loss'], m['train/grad_norm']) for m in full_steps[2:]]
    have = [(m['train/loss'], m['train/grad_norm']) for m in resumed_steps]
    a, b = (leaves_by_path(t.state.params) for t in (full, resumed))
    bit_equal = have == want and all(torch.equal(a[p], b[p]) for p in a)
    rel = max((abs(h - w) / abs(w) for hw, ww in zip(have, want)
               for h, w in zip(hw, ww)), default=math.inf)
    log(f'phase23 resume (QLoRA int4 DPO, the adapter state of step 2): '
        f'(loss, grad norm) of steps 3-4 {have} vs uninterrupted {want}; '
        f'bit-equal (metrics and adapters): {bit_equal}; max rel diff '
        f'{rel:.3e} (limit {DPO_SUM_TOL:g})')
    if len(have) != 2 or not (bit_equal or rel <= DPO_SUM_TOL):
        raise AssertionError('phase 23: the LoRA resume disagrees with the '
                             'uninterrupted run')
    del full, resumed, a, b
    free_memory()

    # where JAX's trainers fail with LoRA, the port's refuse the config
    refused = []
    for name, cls, task, args in (
            ('kto with a KL batch', kto.KTOTrainer, 'text_to_text/kto',
             argv(pref, 'PKUSafeRLHF', None, '--per_device_kl_batch_size',
                  '2')),
            ('saferlhf', saferlhf.SafeRLHFTrainer, 'text_to_text/saferlhf',
             ppo_argv(ckpt, cost, prompts, None, '--cost_model_name_or_path',
                      cost, *ppo_common)),
            ('ppo_remote_rm', ppo_remote_rm.PPORemoteRMTrainer,
             'text_to_text/ppo', ppo_argv(ckpt, cost, prompts, None,
                                          *ppo_common))):
        try:
            run_trainer(cls, task, args + list(LORA_FLAGS['lora']))
        except ValueError as e:
            refused.append(f'{name}: {str(e)[:60]}...')
        else:
            raise AssertionError(f'phase 23 {name} ran with LoRA')
        free_memory()
    log(f'phase23 refused with LoRA, as JAX fails (ROADMAP R18): {refused}')
    del fresh, loaded
    free_memory()
    log(f'phase23 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written() - disk0:.3f} GB written by the phase; card {smi}')
    return {'launches': total}


# phases 24-25: Gemma-3-1B at its full published size (google/gemma-3-1b-pt's
# config.json), random weights from a seed in a bf16 checkpoint under HF's
# Gemma3 tensor names: DPO through ``trainer_main`` with 2 pairs in the 2048
# bucket (the 22 sliding layers run K1 with the window 512, the 4 full ones
# without), then greedy generation through both engines from the same
# checkpoint.  The port's ``save_params`` writes Gemma3 as JAX's does, as
# another model (ROADMAP R21), so the phase writes the tensors itself.
GEMMA3_1B = {
    'architectures': ['Gemma3ForCausalLM'], 'attention_bias': False,
    'attention_dropout': 0.0, 'attn_logit_softcapping': None,
    'bos_token_id': 2, 'cache_implementation': 'hybrid', 'eos_token_id': 1,
    'final_logit_softcapping': None, 'head_dim': 256,
    'hidden_activation': 'gelu_pytorch_tanh', 'hidden_size': 1152,
    'initializer_range': 0.02, 'intermediate_size': 6912,
    'max_position_embeddings': 32768, 'model_type': 'gemma3_text',
    'num_attention_heads': 4, 'num_hidden_layers': 26,
    'num_key_value_heads': 1, 'pad_token_id': 0,
    'query_pre_attn_scalar': 256, 'rms_norm_eps': 1e-06,
    'rope_local_base_freq': 10000, 'rope_scaling': None,
    'rope_theta': 1000000, 'sliding_window': 512,
    'sliding_window_pattern': 6, 'torch_dtype': 'bfloat16',
    'use_cache': True, 'vocab_size': 262144}
GEMMA_PAIRS, GEMMA_STEPS = 2, 4
# prompt 800 words, responses 300-1200: 1105-2005 tokens, the 2048 bucket
GEMMA_PROMPT, GEMMA_RESPONSES, GEMMA_SEQ = 800, (300, 1201), 2048
GEN_REQUESTS, GEN_PROMPTS, GEN_NEW = 16, (600, 901), 64
GEN_SLOTS, GEN_MAX_LEN = 8, 1024


def gemma3_hf_tensors(p: dict, c) -> dict:
    """A Gemma3 param tree under ``transformers``' Gemma3ForCausalLM
    tensor names (the inverse of the port's loader; tied embeddings)."""
    e, h, kh, d = c.hidden_size, c.num_heads, c.num_kv_heads, c.head_dim
    lp = p['layers']
    out = {'model.embed_tokens.weight': p['embedding'],
           'model.norm.weight': p['final_norm']['w']}
    for i in range(c.num_layers):
        pre = f'model.layers.{i}.'
        out.update({
            pre + 'input_layernorm.weight': lp['attn_norm']['w'][i],
            pre + 'self_attn.q_proj.weight': lp['q']['w'][i].reshape(
                e, h * d).T,
            pre + 'self_attn.k_proj.weight': lp['k']['w'][i].reshape(
                e, kh * d).T,
            pre + 'self_attn.v_proj.weight': lp['v']['w'][i].reshape(
                e, kh * d).T,
            pre + 'self_attn.o_proj.weight': lp['o']['w'][i].reshape(
                h * d, e).T,
            pre + 'self_attn.q_norm.weight': lp['q_norm']['w'][i],
            pre + 'self_attn.k_norm.weight': lp['k_norm']['w'][i],
            pre + 'post_attention_layernorm.weight':
                lp['post_attn_norm']['w'][i],
            pre + 'pre_feedforward_layernorm.weight': lp['mlp_norm']['w'][i],
            pre + 'post_feedforward_layernorm.weight':
                lp['post_mlp_norm']['w'][i],
            pre + 'mlp.gate_proj.weight': lp['gate']['w'][i].T,
            pre + 'mlp.up_proj.weight': lp['up']['w'][i].T,
            pre + 'mlp.down_proj.weight': lp['down']['w'][i].T})
    return out


def write_gemma3(path: str, dev, seed: int) -> dict:
    """``config.json`` and a bf16 ``model.safetensors`` drawn from
    ``seed``; returns the written tree (bf16, on the card), the config, the
    bytes and the seconds."""
    from align_anything_tpu_torch.models.config import config_from_hf  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        write_safetensors)

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(GEMMA3_1B, f, indent=2)
    cfg = config_from_hf(path)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    # Gemma's (1 + w) norms start at w = 0; small random w instead, so that
    # every norm weight is read
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for name in ('attn_norm', 'mlp_norm', 'post_attn_norm', 'post_mlp_norm',
                 'q_norm', 'k_norm'):
        w = params['layers'][name]['w']
        w.copy_(torch.randn(w.shape, generator=gen, device=dev) * 0.1)
    params['final_norm']['w'].zero_()
    src = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    t0 = time.perf_counter()
    write_safetensors(os.path.join(path, 'model.safetensors'),
                      gemma3_hf_tensors(src, cfg), metadata={'format': 'pt'})
    return {'tree': src, 'config': cfg,
            'bytes': os.path.getsize(os.path.join(path, 'model.safetensors')),
            'write_s': time.perf_counter() - t0}


class WindowSplit:
    """A flash wrapper ``fn`` that records each call's window (its argument
    ``at``).  ``fn`` counts its launches under its module name, which this
    object takes while it is patched in, so ``launches`` reads and writes
    ``fn``'s own count."""

    def __init__(self, fn, at: int):
        self.fn, self.at, self.windows = fn, at, []

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n

    def __call__(self, *args):
        out = self.fn(*args)
        self.windows.append(args[self.at])
        return out


def launches_by_window(fwd: list, bwd: list) -> dict:
    return {f'{kind} {"window " + str(w) if w else "full"}': n
            for kind, calls in (('fwd', fwd), ('bwd', bwd))
            for w, n in sorted(Counter(calls).items(),
                               key=lambda kv: kv[0] or 0)}


def gemma3_dpo(dev, smi, tmp: str) -> dict:
    """Phase 24: DPO at Gemma-3-1B's full size through
    ``trainer_main(DPOTrainer, ...)``."""
    from align_anything_tpu_torch.models.hf_loader import load_params  # noqa: PLC0415
    from align_anything_tpu_torch.ops.logprobs import token_logprobs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers import base  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: PLC0415
        DPOTrainer)

    t_phase, disk0 = time.perf_counter(), disk_written()
    free_memory()
    ckpt = os.path.join(tmp, 'gemma3_1b')
    w = write_gemma3(ckpt, dev, SEED + 240)
    cfg = w['config']
    n_params = sum(t.numel() for t in param_leaves(w['tree']))
    data = write_jsonl(os.path.join(tmp, 'pref_gemma3.jsonl'),
                       preference_rows(SEED + 241, GEMMA_STEPS * GEMMA_PAIRS,
                                       GEMMA_PROMPT, GEMMA_RESPONSES))
    argv = ['--model_name_or_path', ckpt, '--train_datasets', data,
            '--train_template', 'PKUSafeRLHF', '--save_checkpoint', 'False',
            '--epochs', '1', '--per_device_train_batch_size',
            str(GEMMA_PAIRS)]
    log(f'phase24 config: google/gemma-3-1b-pt\'s config.json (vocab '
        f'{cfg.vocab_size}, hidden {cfg.hidden_size}, {cfg.num_layers} layers'
        f' ({sum(cfg.layer_is_sliding)} sliding, window '
        f'{cfg.sliding_window}, local rope theta {cfg.rope_local_theta}), '
        f'{cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, MLP '
        f'{cfg.mlp_dim}, tied), not cut: {n_params / 1e9:.3f} B params; '
        f'wrote {w["bytes"] / 1e9:.3f} GB of bf16 safetensors in '
        f'{w["write_s"]:.2f} s; argv {" ".join(argv[2:])}; '
        f'MESH_FILE={HARNESS_MESH}')
    loaded: dict = {}
    load = base.load_params

    def checked_load(*args, **kwargs):
        params, mcfg = load(*args, **kwargs)
        got, want = leaves_by_path(params), leaves_by_path(w['tree'])
        loaded['equal'] = set(got) == set(want) and all(
            torch.equal(got[k].float(), want[k].float()) for k in want)
        loaded['leaves'] = len(got)
        return params, mcfg

    first: dict = {}
    preference_loss = DPOTrainer.preference_loss

    def recording(self, logp, ref_logp, batch):
        if not first:
            m = batch['response_mask']
            first.update(batch={k: batch[k].clone() for k in (
                'input_ids', 'attention_mask', 'response_mask')},
                sums=masked_sums(logp, m), ref_sums=masked_sums(ref_logp, m))
        return preference_loss(self, logp, ref_logp, batch)

    fwd = WindowSplit(fa.flash_attention_fwd_cuda, 5)
    bwd = WindowSplit(fa.flash_attention_bwd_cuda, 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    with mock.patch.object(base, 'load_params', checked_load), \
            mock.patch.object(DPOTrainer, 'preference_loss', recording), \
            mock.patch.object(fa, 'flash_attention_fwd_cuda', fwd), \
            mock.patch.object(fa, 'flash_attention_bwd_cuda', bwd):
        trainer, steps, timing = run_trainer(DPOTrainer, 'text_to_text/dpo',
                                             argv, HARNESS_MESH)
    torch.cuda.synchronize()
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    mcfg = trainer.model_cfg
    del trainer
    free_memory()
    shape = tuple(first['batch']['input_ids'].shape)
    losses = [m['train/loss'] for m in steps]
    seconds = [m['perf/step_time_s'] for m in steps]
    for i, m in enumerate(steps):
        log(f'phase24 step {i + 1}: loss={losses[i]:.9f} grad_norm='
            f'{m["train/grad_norm"]:.6e} reward_accuracy='
            f'{m["train/reward_accuracy"]:.3f} seconds={seconds[i]:.4f}')
    step_s = statistics.median(seconds[1:])
    tps = shape[0] * shape[1] / step_s
    layers, sliding = mcfg.num_layers, sum(mcfg.layer_is_sliding)
    # every layer of the policy's forward, its recompute under
    # 'dots_saveable' and the reference's forward; the backward once
    need = {'fwd': 3 * GEMMA_STEPS * layers, 'bwd': GEMMA_STEPS * layers}
    split = launches_by_window(fwd.windows, bwd.windows)
    want_split = {
        f'fwd window {mcfg.sliding_window}': 3 * GEMMA_STEPS * sliding,
        'fwd full': 3 * GEMMA_STEPS * (layers - sliding),
        f'bwd window {mcfg.sliding_window}': GEMMA_STEPS * sliding,
        'bwd full': GEMMA_STEPS * (layers - sliding)}
    log(f'phase24 Gemma-3-1B DPO: batch {shape}, remat {mcfg.remat}, '
        f'compute {mcfg.compute_dtype}; the loaded tree ({loaded["leaves"]} '
        f'leaves) bit-equal to the written one: {loaded["equal"]}; '
        f'checkpoint load {timing["load_s"]:.2f} s; step time {step_s:.4f} s '
        f'(median of steps 2-{len(steps)}, the loop\'s clock), {tps:.1f} '
        f'tokens/s, peak memory {peak / 1e9:.3f} GB; flash launches fwd '
        f'{launches["fwd"]} (need {need["fwd"]}) bwd {launches["bwd"]} (need '
        f'{need["bwd"]}), by window {split}; card {smi}')
    if shape != (2 * GEMMA_PAIRS, GEMMA_SEQ) or (
            mcfg.remat, mcfg.compute_dtype) != ('dots_saveable', 'bfloat16'):
        raise AssertionError(f'phase24: batch {shape}, {mcfg.remat}, '
                             f'{mcfg.compute_dtype}')
    if not loaded['equal']:
        raise AssertionError('phase24: the loaded tree is not the written one')
    if len(steps) != GEMMA_STEPS or not all_finite(steps):
        raise AssertionError(f'phase24: {len(steps)} steps, or a non-finite '
                             'metric')
    if abs(losses[0] - math.log(2)) > 1e-6:
        raise AssertionError(f'phase24: step 1 loss {losses[0]} != ln 2')
    check_launches('phase24', launches, need, exact=True)
    if split != want_split:
        raise AssertionError(f'phase24: launches by window {split}, expected '
                             f'{want_split}')

    # step 1's policy forward recomputed from the checkpoint with the plain
    # attention, in bf16 and in fp32
    params, _ = load_params(ckpt, device=dev)
    b = first['batch']
    with torch.no_grad(), plain_flash():
        plain = masked_sums(token_logprobs(
            params, mcfg, b['input_ids'], attention_mask=b['attention_mask']),
            b['response_mask'])
        fp32 = masked_sums(token_logprobs(
            params, mcfg.replace(compute_dtype='float32'), b['input_ids'],
            attention_mask=b['attention_mask']), b['response_mask'])
    del params
    free_memory()
    log('phase24 step 1 recomputed with the plain attention, response '
        'log-prob sums: ' + check_sums('policy', first['sums'], plain, fp32)
        + '; ' + check_sums('reference', first['ref_sums'], plain, fp32))
    log(f'phase24 done in {time.perf_counter() - t_phase:.1f} s, '
        f'{disk_written() - disk0:.3f} GB written by the phase')
    return {'launches': launches, 'step_s': step_s, 'tokens_per_s': tps,
            'peak_gb': peak / 1e9, 'ckpt': ckpt}


def gen_prompts(vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=int(rng.integers(*GEN_PROMPTS)))
            .tolist() for _ in range(GEN_REQUESTS)]


def left_padded(prompts: list, pad: int, dev) -> tuple:
    p = max(len(x) for x in prompts)
    ids = torch.full((len(prompts), p), pad, dtype=torch.long)
    mask = torch.zeros((len(prompts), p), dtype=torch.long)
    for i, x in enumerate(prompts):
        ids[i, p - len(x):] = torch.as_tensor(x)
        mask[i, p - len(x):] = 1
    return ids.to(dev), mask.to(dev)


def last_logits(params, cfg, ids, mask) -> torch.Tensor:
    """The training forward (no cache): the last position's fp32 logits."""
    out = transformer.forward(params, cfg, ids, attention_mask=mask,
                              need_logits=False)
    return transformer._head_logits(cfg, params,
                                    out.last_hidden_state[:, -1:])[:, 0]


def run_engines(params, cfg, prompts, dev) -> dict:
    """``generate`` over all prompts at once, left-padded, and the
    continuous engine; greedy, ``GEN_NEW`` tokens each.  Wall clock, peak
    memory, tokens, and the batch prefill's last logits."""
    from align_anything_tpu_torch.generation.engine import generate  # noqa: PLC0415

    gen_cfg = GenerationConfig(max_new_tokens=GEN_NEW, greedy=True,
                               eos_token_id=-1, pad_token_id=cfg.pad_token_id)
    ids, mask = left_padded(prompts, cfg.pad_token_id, dev)
    prefill: dict = {}

    def recording(*args, **kwargs):
        out = transformer.forward(*args, **kwargs)
        if 'logits' not in prefill:
            prefill['logits'] = out.logits[:, -1].clone()
        return out

    out = {}
    for name in ('generate', 'continuous'):
        free_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if name == 'generate':
            toks = generate(params, cfg, gen_cfg, ids, mask,
                            prefill_forward=recording)['completions'].tolist()
        else:
            engine = ContinuousBatchingEngine(cfg, num_slots=GEN_SLOTS,
                                              max_len=GEN_MAX_LEN)
            toks = engine.generate(params, prompts, gen_cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[name] = {'tokens': toks, 's': dt,
                     'tokens_per_s': GEN_REQUESTS * GEN_NEW / dt,
                     'peak_gb': torch.cuda.max_memory_allocated() / 1e9}
    out['prefill_logits'] = prefill['logits']
    out['ids'], out['mask'] = ids, mask
    return out


def gemma3_generation(dev, smi, ckpt: str) -> dict:
    """Phase 25: greedy generation at Gemma-3-1B's full size through both
    engines, prompts longer than the window."""
    from align_anything_tpu_torch.models.hf_loader import load_params  # noqa: PLC0415

    t_phase = time.perf_counter()
    free_memory()
    params, cfg = load_params(ckpt, device=dev)
    prompts = gen_prompts(cfg.vocab_size, SEED + 250)
    lens = [len(x) for x in prompts]
    bf16 = run_engines(params, cfg, prompts, dev)
    same = [a == b for a, b in zip(bf16['generate']['tokens'],
                                   bf16['continuous']['tokens'])]
    for name in ('generate', 'continuous'):
        r = bf16[name]
        log(f'phase25 {name} (bf16): {GEN_REQUESTS} requests x {GEN_NEW} '
            f'tokens in {r["s"]:.3f} s = {r["tokens_per_s"]:.1f} generated '
            f'tokens/s, peak memory {r["peak_gb"]:.3f} GB')
    log(f'phase25 prompts {min(lens)}-{max(lens)} tokens (window '
        f'{cfg.sliding_window}); continuous engine {GEN_SLOTS} slots, '
        f'max_len {GEN_MAX_LEN}; bf16 requests with equal tokens in both '
        f'engines: {sum(same)} of {len(same)}')

    # the prefill's last logits against the training forward (K1 with the
    # window), within the plain pass's own bf16 noise (against fp32)
    ids, mask = bf16['ids'], bf16['mask']
    reset_flash_counts()
    with torch.no_grad():
        kernel = last_logits(params, cfg, ids, mask)
        torch.cuda.synchronize()
        launches = flash_counts()
        with plain_flash():
            plain = last_logits(params, cfg, ids, mask)
            fp32 = last_logits(params, cfg.replace(compute_dtype='float32'),
                               ids, mask)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    noise = rel(plain, fp32)
    limit = max(RL_TOL, SCORE_NOISE * noise)
    err, kerr = rel(bf16['prefill_logits'], kernel), rel(kernel, fp32)
    need = {'fwd': cfg.num_layers, 'bwd': 0}
    log(f'phase25 the batch prefill\'s last logits against the training '
        f'forward through K1: max|diff| / max|logit| {err:.3e} (limit '
        f'{limit:.3e}: {SCORE_NOISE:g} x the plain bf16 pass against fp32, '
        f'{noise:.3e}; K1 against fp32 {kerr:.3e}); flash launches fwd '
        f'{launches["fwd"]} (need {need["fwd"]})')
    if not (bool(torch.isfinite(bf16['prefill_logits']).all())
            and err <= limit):
        raise AssertionError('phase25: the prefill disagrees with the '
                             'training forward')
    check_launches('phase25', launches, need, exact=True)
    del bf16, kernel, plain, fp32

    # fp32: the two engines give the same greedy tokens
    fp = run_engines(params, cfg.replace(compute_dtype='float32'), prompts,
                     dev)
    same32 = fp['generate']['tokens'] == fp['continuous']['tokens']
    log(f'phase25 fp32: generate {fp["generate"]["tokens_per_s"]:.1f} and '
        f'continuous {fp["continuous"]["tokens_per_s"]:.1f} generated '
        f'tokens/s; the same tokens from both engines: {same32}; card {smi}')
    toks = fp['generate']['tokens']
    if not (same32 and all(len(t) == GEN_NEW for t in toks)
            and all(0 <= x < cfg.vocab_size for t in toks for x in t)):
        raise AssertionError('phase25: the engines disagree in fp32')
    del params, fp
    free_memory()
    log(f'phase25 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches}


def remat_sweep(dev, smi) -> dict:
    """Phase 26: the ten remat policies at phase 7's shape: 1 warm-up and 2
    timed steps each, from the same weights and batch."""
    t_phase = time.perf_counter()
    total = {'fwd': 0, 'bwd': 0}
    rows, base = {}, None
    for policy in transformer.REMAT_POLICIES:
        free_memory()
        cfg = llama_config(layers=DPO_LAYERS).replace(
            compute_dtype='bfloat16', remat=policy)
        trainer, state, ref = dpo_setup(cfg, dev, SEED + 10)
        batch = dpo_batch(cfg, DPO_PAIRS, DPO_SEQ, dev, SEED + 11, pad=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        losses, norms, seconds = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            state, m = trainer.step(state, ref, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(float(m['train/loss']))
            norms.append(float(m['train/grad_norm']))
        peak = torch.cuda.max_memory_allocated()
        # what the policy keeps for the backward: the memory that one more
        # forward (policy and reference) leaves held by its graph; the
        # steps' peak is AdamW's, the same for every policy
        before = torch.cuda.memory_allocated()
        loss, _ = trainer.loss_fn(state.params, ref, batch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        del loss
        launches = flash_counts()
        keeps = policy in ('none', 'save_flash', 'dots_flash',
                           'dots_saveable_flash', 'dots_mlp_lean_flash')
        need = {'fwd': (3 * (2 if keeps else 3) + 2) * cfg.num_layers,
                'bwd': 3 * cfg.num_layers}
        check_launches(f'phase26 {policy}', launches, need, exact=True)
        for k in total:
            total[k] += launches[k]
        if base is None:
            base = (losses, norms)
        gap = max(max(abs(a - b) / abs(b) for a, b in zip(losses, base[0])),
                  max(abs(a - b) / abs(b) for a, b in zip(norms, base[1])))
        rows[policy] = {'step_s': statistics.mean(seconds[1:]),
                        'peak_gb': peak / 1e9, 'held_gb': held / 1e9}
        log(f'phase26 remat {policy:20s} step time {rows[policy]["step_s"]:.4f}'
            f' s (mean of steps 2-3; warm-up {seconds[0]:.4f}), peak memory '
            f'{peak / 1e9:.3f} GB, held by a forward for its backward '
            f'{held / 1e9:.3f} GB, losses {losses}, grad norms {norms}; max '
            f'relative gap to none {gap:.3e} (limit {DPO_NORM_TOL:g}); flash '
            f'launches {launches}')
        if not (all(math.isfinite(x) for x in losses + norms)
                and gap <= DPO_NORM_TOL):
            raise AssertionError(f'phase26: remat {policy} disagrees with '
                                 'none')
        del trainer, state, ref, batch
    log(f'phase26 done in {time.perf_counter() - t_phase:.1f} s; card {smi}')
    return {'launches': total, 'rows': rows}


SAVE_STEPS, SAVE_EVERY = 8, 3


def async_save(dev, smi, tmp: str) -> dict:
    """Phase 27: DPO at phase 10's widths (``small``) through the trainer's
    loop, 8 steps, the train state saved at step 3 with ``wait=True`` and at
    step 6 with ``wait=False``; each save restored against the state at its
    call, bit for bit."""
    from align_anything_tpu_torch import checkpoint as ckpt_lib  # noqa: PLC0415
    from align_anything_tpu_torch.trainers import cli  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: PLC0415
        DPOTrainer)
    from align_anything_tpu_torch.utils.logger import Logger  # noqa: PLC0415

    t_phase, disk0 = time.perf_counter(), disk_written()
    free_memory()
    out = os.path.join(tmp, 'save27')
    data = write_jsonl(os.path.join(tmp, 'pref_save.jsonl'), preference_rows(
        SEED + 270, 2 * SAVE_STEPS, 60, (20, 121)))
    cfgs, pc = cli.parse_cfgs('text_to_text/dpo', [
        '--model_name_or_path', os.path.join(tmp, 'small'),
        '--train_datasets', data, '--train_template', 'PKUSafeRLHF',
        '--output_dir', out, '--epochs', '1',
        '--per_device_train_batch_size', '2', '--save_checkpoint', 'True',
        '--save_interval', str(SAVE_EVERY), '--save_total_limit', '3'])
    saves: list = []
    save, host_copy = ckpt_lib.save_train_state, ckpt_lib._host_copy
    copies: list = []

    def timed_copy(tree):
        t0 = time.perf_counter()
        out = host_copy(tree)
        copies.append(time.perf_counter() - t0)
        return out

    def measured(output_dir, step, state, keep=None, wait=True):
        # the state at the call, on the card; the first save waits, the
        # second is the loop's own (wait=False)
        snap = ([t.detach().clone() for t in param_leaves(state.params)],
                state.optimizer.state_dict()['state'])
        snap = (snap[0], {i: {k: v.clone() for k, v in s.items()}
                          for i, s in snap[1].items()})
        wait = not saves
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(output_dir, step, state, keep=keep, wait=wait)
        saves.append({'step': step, 'wait': wait, 'path': path, 'snap': snap,
                      'call_s': time.perf_counter() - t0})
        return path

    steps: list = []
    # the HF slice export that goes with each save is synchronous with or
    # without wait and 0.39 GB of disk writes a save: left out
    with mock.patch.object(ckpt_lib, 'save_train_state', measured), \
            mock.patch.object(ckpt_lib, '_host_copy', timed_copy), \
            mock.patch.object(ckpt_lib, 'save_hf_slice',
                              lambda out_dir, tag, *a, **k: out_dir), \
            mock.patch.object(Logger, 'log', lambda self, metrics, step:
                              steps.append(dict(metrics))):
        trainer = DPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
        reset_flash_counts()
        trainer.train()                   # waits for the save in flight
        torch.cuda.synchronize()
        launches = flash_counts()
    seconds = [m['perf/step_time_s'] for m in steps]
    state_bytes = sum(os.path.getsize(os.path.join(s['path'],
                                                   ckpt_lib._STATE_FILE))
                      for s in saves) / len(saves)
    plain = statistics.median(s for i, s in enumerate(seconds)
                              if i % SAVE_EVERY != 0)
    for i, s in enumerate(seconds):
        log(f'phase27 step {i + 1}: the loop\'s step time {s:.4f} s'
            + (f' (holds the step-{i} save)' if i and i % SAVE_EVERY == 0
               else ''))
    equal = []
    for s in saves:
        ckpt_lib.restore_train_state(s['path'], trainer.state)
        params, moments = s['snap']
        now = trainer.state.optimizer.state_dict()['state']
        equal.append(
            all(torch.equal(a, b) for a, b in zip(
                param_leaves(trainer.state.params), params))
            and now.keys() == moments.keys()
            and all(torch.equal(now[i][k].to(moments[i][k].device),
                                moments[i][k])
                    for i in moments for k in moments[i])
            and trainer.state.step == s['step'])
    stalls = {s['wait']: seconds[s['step']] - plain for s in saves}
    log(f'phase27 async save: train state {state_bytes / 1e9:.3f} GB a save '
        f'(params and AdamW moments, fp32); the save call '
        + ', '.join(f'{"wait=True" if s["wait"] else "wait=False"} at step '
                    f'{s["step"]} {s["call_s"]:.4f} s (of it the host copy '
                    f'{c:.4f} s)' for s, c in zip(saves, copies))
        + ' (the first save of the process allocates the pinned host '
        'buffers, which the second reuses)'
        + f'; the loop\'s step with the save {stalls[True] + plain:.4f} s '
        f'(wait=True) and {stalls[False] + plain:.4f} s (wait=False) against '
        f'{plain:.4f} s without (median): stall {stalls[True]:.4f} s and '
        f'{stalls[False]:.4f} s; the steps after the async save '
        f'{[round(x, 4) for x in seconds[2 * SAVE_EVERY + 1:]]}; restored '
        f'bit-equal to the state at each call: {equal}; '
        f'{disk_written() - disk0:.3f} GB written by the phase; card {smi}')
    if [s['wait'] for s in saves] != [True, False] or len(steps) != \
            SAVE_STEPS:
        raise AssertionError(f'phase27: saves {[s["wait"] for s in saves]}, '
                             f'{len(steps)} steps')
    if not all(equal):
        raise AssertionError('phase27: a save does not restore to the state '
                             'at its call')
    del trainer, saves
    shutil.rmtree(out, ignore_errors=True)
    free_memory()
    log(f'phase27 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'stalls': stalls, 'plain_s': plain}


# --planted-faults: flash_attention.cu with 64 keys (or one 64-row query
# tile) skipped for the second half of the rows, in the tensor-core
# kernels (bf16, the main path).  (name, loop text, the broken loop,
# which occurrence)
PLANTED_FAULTS = (
    ('forward skips its last 64 keys', 'k0 = k_first; k0 < k_hi; k0 += BK',
     'k0 = k_first; k0 < k_hi - (q0 >= L / 2 ? 64 : 0); k0 += BK', 0),
    ('dQ skips its last 64 keys', 'k0 = k_first; k0 < k_hi; k0 += BK',
     'k0 = k_first; k0 < k_hi - (q0 >= L / 2 ? 64 : 0); k0 += BK', 1),
    ('dK/dV skips the last query tile of each head',
     'const int nqt = (q_hi - q_first + BQ - 1) / BQ;',
     'const int nqt = (q_hi - q_first + BQ - 1) / BQ - (k0 >= L / 2);', 0),
)


def planted_source(src: str, loop: str, broken: str, which: int) -> str:
    at = -1
    for _ in range(which + 1):
        at = src.index(loop, at + 1)
    return src[:at] + broken + src[at + len(loop):]


def build_variants(sources: dict, subdir: str) -> dict:
    """Build edited copies of ``flash_attention.cu`` (name -> source text)
    into the gitignored build directory, one nvcc each, all together."""
    from align_anything_tpu_torch.ops import _cuda_build  # noqa: PLC0415

    libs = {}
    for i, (name, text) in enumerate(sources.items()):
        path = _cuda_build.BUILD_DIR / subdir / f'variant{i}.cu'
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        lib = _cuda_build.CudaLibrary('flash_attention', fa._bind)
        lib.source = path
        libs[name] = lib
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs.values()))
    return libs


def planted_faults(dev, smi) -> None:
    """``--planted-faults``: build the kernel with each fault of
    ``PLANTED_FAULTS`` and show that phase 6's per-row check fails on it at
    the two main shapes where the kernel as written passes; report the
    whole-tensor measure it replaced and phase 7's step-1 recompute under
    each build."""
    src = fa.LIBRARY.source.read_text()
    builds = {'as written': fa.LIBRARY, **build_variants(
        {name: planted_source(src, loop, broken, which)
         for name, loop, broken, which in PLANTED_FAULTS}, 'planted')}
    for name, lib in builds.items():
        with mock.patch.object(fa, 'LIBRARY', lib):
            for si, shape in enumerate(FLASH_SHAPES[:2]):
                (sname, b, l, h, kh, d, causal, window, pad_rows, pad_len,
                 dtype, _) = shape
                q, k, v, mask, dout = flash_inputs(
                    b, l, h, kh, d, pad_rows, pad_len, dtype, dev,
                    SEED + 20 + si)
                out, lse = fa.flash_attention_fwd_cuda(q, k, v, mask, causal)
                grads = fa.flash_attention_bwd_cuda(q, k, v, mask, out, lse,
                                                    dout, causal)
                rout, _ = fa.flash_attention_fwd_reference(q, k, v, mask,
                                                           causal)
                rgrads = fa.flash_attention_bwd_reference(
                    q, k, v, mask, out, lse, dout, causal)
                rows, parts = {}, []
                for label, got, ref in zip(('out', 'dq', 'dk', 'dv'),
                                           (out, *grads), (rout, *rgrads)):
                    whole = float((got.float() - ref.float()).abs().max()
                                  / ref.float().abs().max())
                    rows[label] = fa.row_scaled_error(got, ref)
                    parts.append(f'{label} per row {rows[label]:.3e} whole '
                                 f'{whole:.3e}')
                log(f'planted [{name}] {sname}: {", ".join(parts)} (limit '
                    f'{FLASH_TOL[dtype]:g} on both)')
                caught = any(r > FLASH_TOL[dtype] for r in rows.values())
                if caught != (lib is not builds['as written']):
                    raise AssertionError(f'the phase 6 check is wrong on '
                                         f'[{name}] at {sname}')
    cfg = llama_config(layers=DPO_LAYERS).replace(
        compute_dtype='bfloat16', remat='dots_saveable')
    trainer, state, ref = dpo_setup(cfg, dev, SEED + 10)
    batch = dpo_batch(cfg, DPO_PAIRS, DPO_SEQ, dev, SEED + 11, pad=True)
    with plain_flash():
        psums, pnorm = step1_quantities(trainer, state.params, ref, batch)
    for name, lib in builds.items():
        with mock.patch.object(fa, 'LIBRARY', lib):
            sums, norm = step1_quantities(trainer, state.params, ref, batch)
        rel = float(((sums - psums).abs() / psums.abs()).max())
        log(f'planted [{name}] phase 7 step-1 recompute: log-prob sums max '
            f'rel diff {rel:.3e} (limit {DPO_SUM_TOL:g}; max abs '
            f'{float((sums - psums).abs().max()):.4f} nats), grad norm rel '
            f'diff {abs(norm - pnorm) / pnorm:.3e} (limit {DPO_NORM_TOL:g}); '
            f'card {smi}')


def tiles_source(src: str, spec: str) -> str:
    """``flash_attention.cu`` with fields of ``WgTiles<64>`` and
    ``WgTiles<128>`` overridden: spec 'FMB=1,QMB=1/FMI=1' (the D 64 fields,
    then the D 128 fields)."""
    for d, fields in zip((64, 128), spec.split('/')):
        at = src.index(f'struct WgTiles<{d}> {{')
        end = src.index('};', at)
        body = src[at:end]
        for field in filter(None, fields.split(',')):
            key, val = field.split('=')
            body, n = re.subn(rf'\b{key} = \d+', f'{key} = {int(val)}', body)
            if n != 1:
                raise ValueError(f'no field {key} in WgTiles<{d}>')
        src = src[:at] + body + src[end:]
    return src


def tile_sweep(dev, smi, specs: list) -> None:
    """``--tile-sweep SPEC ...``: build the kernels once per spec of
    ``tiles_source`` and time the forward and each backward kernel (device
    time from ``torch.profiler``) at phase 6's two timed shapes, beside
    their registers and the worst per-row error against the plain
    versions; the builds run in turn, the kernel as written first and
    last."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    src = fa.LIBRARY.source.read_text()
    libs = {'as written': fa.LIBRARY,
            **build_variants({sp: tiles_source(src, sp) for sp in specs},
                             'sweep')}
    flush = l2_flush_buffer(dev)
    for name in [*libs, 'as written']:
        with mock.patch.object(fa, 'LIBRARY', libs[name]):
            for si, shape in enumerate(FLASH_SHAPES[:2]):
                (sname, b, l, h, kh, d, causal, _, pad_rows, pad_len, dtype,
                 _) = shape
                q, k, v, mask, dout = flash_inputs(
                    b, l, h, kh, d, pad_rows, pad_len, dtype, dev,
                    SEED + 20 + si)
                out, lse = fa.flash_attention_fwd_cuda(q, k, v, mask, causal)

                def bwd():
                    return fa.flash_attention_bwd_cuda(q, k, v, mask, out,
                                                       lse, dout, causal)

                grads = bwd()
                refs = (fa.flash_attention_fwd_reference(
                    q, k, v, mask, causal)[0],
                    *fa.flash_attention_bwd_reference(
                        q, k, v, mask, out, lse, dout, causal))
                err = max(fa.row_scaled_error(g, r)
                          for g, r in zip((out, *grads), refs))
                fwd_ms = time_ms(lambda: fa.flash_attention_fwd_cuda(
                    q, k, v, mask, causal), 20, flush)
                bwd_ms = time_ms(bwd, 20, flush)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        flush.zero_()
                        bwd()
                    torch.cuda.synchronize()
                per = {role: sum(e.self_device_time_total
                                 for e in prof.key_averages() if tag in e.key)
                       / 5e3 for role, tag in (('delta', 'delta_kernel'),
                                               ('dk_dv', 'dkdv_'),
                                               ('dq', 'dq_'))}
                regs = {kn: i['registers'] for kn, i in
                        fa.kernel_info(d, dtype).items()}
                log(f'sweep [{name}] {sname}: forward_ms={fwd_ms:.4f} '
                    f'backward_ms={bwd_ms:.4f} ('
                    + ' '.join(f'{r}={ms:.4f}' for r, ms in per.items())
                    + f'); registers {regs}; worst row error {err:.2e}; '
                    f'card {smi}')


KERNEL_GROUPS = (   # (group, substrings of the kernel name), first match
    ('flash attention (this port)', ('fwd_wgmma_kernel', 'dkdv_wgmma_kernel',
                                     'dq_wgmma_kernel', 'fwd_kernel',
                                     'dkdv_kernel', 'dq_kernel',
                                     'delta_kernel')),
    ('matmul (cuBLAS)', ('gemm', 'xmma', 'cutlass', 'nvjet', 'ampere_',
                         'sm90_')),
    ('optimizer (foreach)', ('multi_tensor_apply',)),
    ('softmax / logsumexp / reductions', ('softmax', 'reduce', 'logsumexp')),
)


def report_trace(name: str, prof, wall: float, smi: str, top: int = 25
                 ) -> None:
    """Device time by kernel group and the idle share of a traced window
    that took ``wall`` seconds (ending in a synchronize)."""
    # device-side events only: kernels, copies and fills on the card (a
    # CPU op's entry repeats the time of the kernels it launched, and a
    # span such as 'Optimizer.step#AdamW.step' covers them)
    kernels = {evt.key: (evt.self_device_time_total, evt.count)
               for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and evt.self_device_time_total > 0
               and not getattr(evt, 'is_user_annotation', False)
               and not evt.key.startswith(('Optimizer.', 'ProfilerStep',
                                           'Command Buffer'))}
    busy = sum(us for us, _ in kernels.values()) / 1e6
    groups: dict = {}
    for key, (us, _) in kernels.items():
        group = next((g for g, subs in KERNEL_GROUPS
                      if any(x in key.lower() for x in subs)),
                     'other (elementwise, casts, copies)')
        groups[group] = groups.get(group, 0.0) + us / 1e6
    log(f'profile {name}: {wall:.4f} s (traced), device busy {busy:.4f} s, '
        f'idle share {1 - busy / wall:.4f}; card {smi}')
    for group, sec in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f'profile {name} group {group}: {sec:.4f} s '
            f'({sec / wall:.4f} of the window)')
    for key, (us, count) in sorted(kernels.items(),
                                   key=lambda kv: -kv[1][0])[:top]:
        log(f'profile {name} kernel {us / 1e3:10.3f} ms x{count:<6d} '
            f'{key[:110]}')


def traced(fn):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA), ended by a
    synchronize: (result, profile, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof, wall


def profile_dpo(dev, smi) -> None:
    """``--profile``: device time by kernel of one DPO step per config."""
    configs = {
        'llama8b_4layers': (llama_config(layers=DPO_LAYERS).replace(
            compute_dtype='bfloat16', remat='dots_saveable'), DPO_PAIRS,
            DPO_SEQ, True),
        'bench': (llama_config(vocab_size=32768, hidden=1024, layers=20,
                               heads=16, kv_heads=8, mlp=4096,
                               max_pos=2048).replace(
            compute_dtype='bfloat16', remat='dots_saveable'), BENCH_PAIRS,
            BENCH_SEQ, False)}
    for name, (cfg, pairs, seq, pad) in configs.items():
        trainer, state, ref = dpo_setup(cfg, dev, SEED + 40)
        batch = dpo_batch(cfg, pairs, seq, dev, SEED + 41, pad=pad)
        state, _ = trainer.step(state, ref, batch)              # warm-up
        (state, _), prof, wall = traced(
            lambda: trainer.step(state, ref, batch))
        report_trace(f'{name} step', prof, wall, smi)
        del trainer, state, ref, batch, prof
        torch.cuda.empty_cache()


def profile_ppo(dev, smi, tmp: str) -> None:
    """``--profile``: one PPO round of phase 12's config (a 2-layer
    checkpoint at Llama-3-8B widths for all four models, fresh heads)
    after a warm-up round, traced in three windows: the rollout's
    ``generate``, the scoring pass and the update."""
    from align_anything_tpu_torch.generation import generate  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import save_params  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.cli import parse_cfgs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.ppo import (  # noqa: PLC0415
        PPOTrainer)

    cfg = llama_config(layers=RL_LAYERS)
    ckpt = os.path.join(tmp, 'llama8b_2layers')
    save_params(ckpt, transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 70), device=dev),
        cfg, dtype=torch.bfloat16)
    free_memory()
    data = write_jsonl(os.path.join(tmp, 'prompts_8b.jsonl'),
                       prompt_rows(SEED + 72, PPO_PROMPTS, (15, 116)))
    cfgs, pc = parse_cfgs('text_to_text/ppo', ppo_argv(
        ckpt, ckpt, data, os.path.join(tmp, 'out_ppo'),
        '--per_device_prompt_batch_size', str(PPO_ROUND),
        '--per_device_train_batch_size', str(PPO_MICRO),
        '--max_new_tokens', str(PPO_NEW), '--padding_buckets',
        f'[{PPO_BUCKET}]'))
    trainer = PPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    warm, batch = list(trainer.train_iterator.epoch_batches(0))[:2]
    trainer.train_step(warm)
    prompts = trainer.put_batch(batch)
    gen, prof, wall = traced(lambda: generate(
        trainer.actor_state.params, trainer.model_cfg, trainer.gen_cfg,
        prompts['input_ids'], prompts['attention_mask'], trainer.next_rng()))
    steps = int(gen['completion_mask'].sum(0).gt(0).sum())
    report_trace(f'ppo rollout ({steps} decode steps)', prof, wall, smi)
    seq, mask = gen['sequences'], gen['attention_mask']
    scores, prof, wall = traced(lambda: trainer.score_rollout(seq, mask))
    report_trace('ppo scoring', prof, wall, smi)
    rollout = {'input_ids': seq, 'attention_mask': mask, **scores}

    def update():
        for micro in trainer._micro_batches(rollout):
            trainer.rl_step(micro, PPO_BUCKET - 1)

    _, prof, wall = traced(update)
    report_trace(f'ppo update ({PPO_ROUND // PPO_MICRO} micro-batches)', prof,
                 wall, smi)
    del trainer, gen, scores, rollout, prof
    free_memory()


def profile_ti2t(dev, smi, tmp: str) -> None:
    """``--profile``: one TI2T DPO step of phase 18's config after a warm-up
    step, traced whole, then the tower and projector's forward over the
    step's images alone (a step runs it twice: policy and reference)."""
    from align_anything_tpu_torch.models import multimodal  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.cli import parse_cfgs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_image_to_text.dpo import (  # noqa: PLC0415
        TI2TDPOTrainer)

    cfg = llava_config()
    argv = ti2t_dpo_assets(cfg, dev, tmp)[3]
    with mock.patch.dict(os.environ, {'MESH_FILE': HARNESS_MESH}):
        cfgs, pc = parse_cfgs('text_image_to_text/dpo', argv)
    trainer = TI2TDPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    warm, batch = list(trainer.train_iterator.epoch_batches(0))[:2]
    trainer.train_step(warm)
    _, prof, wall = traced(lambda: trainer.train_step(batch))
    report_trace('ti2t dpo step', prof, wall, smi)
    pixels = trainer.put_batch(batch)['pixel_values']
    with torch.no_grad():
        _, prof, wall = traced(lambda: multimodal.project_image_features(
            trainer.state.params, trainer.model_cfg, pixels))
    report_trace(f'ti2t tower + projector forward ({pixels.shape[0]} '
                 'images)', prof, wall, smi)
    del trainer, prof
    free_memory()


def profile_qlora(dev, smi, tmp: str) -> None:
    """``--profile``: one QLoRA DPO step of phase 22's config (Llama-3-8B, 32
    layers, the int4 base) after a warm-up step, traced whole."""
    from align_anything_tpu_torch.trainers.cli import parse_cfgs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: PLC0415
        DPOTrainer)

    data = write_jsonl(os.path.join(tmp, 'pref_8b.jsonl'), preference_rows(
        SEED + 51, DPO_STEPS * DPO_PAIRS, 400, (150, 601)))
    with mock.patch.dict(os.environ, {'MESH_FILE': HARNESS_MESH}):
        cfgs, pc = parse_cfgs('text_to_text/dpo', [
            '--model_name_or_path', QLORA_PRESET, '--train_datasets', data,
            '--train_template', 'PKUSafeRLHF', '--epochs', '1',
            '--per_device_train_batch_size', str(DPO_PAIRS),
            '--learning_rate', str(QLORA_LR), *LORA_FLAGS['int4']])
    trainer = DPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    warm, batch = list(trainer.train_iterator.epoch_batches(0))[:2]
    trainer.train_step(warm)
    _, prof, wall = traced(lambda: trainer.train_step(batch))
    report_trace('qlora int4 step (32 layers)', prof, wall, smi)
    del trainer, prof
    free_memory()


def profile_gemma3(dev, smi, tmp: str) -> None:
    """``--profile``: one DPO step of phase 24's config (Gemma-3-1B) after a
    warm-up step, traced whole; then phase 25's ``generate`` (bf16, its
    prompts, 8 new tokens) after a warm-up call."""
    from align_anything_tpu_torch.generation.engine import generate  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.cli import parse_cfgs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: PLC0415
        DPOTrainer)

    ckpt = os.path.join(tmp, 'gemma3_1b')
    cfg = write_gemma3(ckpt, dev, SEED + 240)['config']
    free_memory()
    data = write_jsonl(os.path.join(tmp, 'pref_gemma3.jsonl'),
                       preference_rows(SEED + 241, GEMMA_STEPS * GEMMA_PAIRS,
                                       GEMMA_PROMPT, GEMMA_RESPONSES))
    with mock.patch.dict(os.environ, {'MESH_FILE': HARNESS_MESH}):
        cfgs, pc = parse_cfgs('text_to_text/dpo', [
            '--model_name_or_path', ckpt, '--train_datasets', data,
            '--train_template', 'PKUSafeRLHF', '--epochs', '1',
            '--per_device_train_batch_size', str(GEMMA_PAIRS)])
    trainer = DPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    warm, batch = list(trainer.train_iterator.epoch_batches(0))[:2]
    trainer.train_step(warm)
    _, prof, wall = traced(lambda: trainer.train_step(batch))
    report_trace('gemma3_1b DPO step', prof, wall, smi)
    params = trainer.state.params
    del trainer, prof
    free_memory()
    ids, mask = left_padded(gen_prompts(cfg.vocab_size, SEED + 250),
                            cfg.pad_token_id, dev)
    gen_cfg = GenerationConfig(max_new_tokens=8, greedy=True,
                               eos_token_id=-1, pad_token_id=cfg.pad_token_id)
    with torch.no_grad():
        generate(params, cfg, gen_cfg, ids, mask)
        _, prof, wall = traced(lambda: generate(params, cfg, gen_cfg, ids,
                                                mask))
    report_trace('gemma3_1b generate (16 prompts, prefill + 8 decode steps)',
                 prof, wall, smi)
    del params, prof
    free_memory()


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on the GPU',
              file=sys.stderr)
        return 1
    if not os.path.abspath(align_anything_tpu_torch.__file__).startswith(
            REPO + os.sep):
        raise RuntimeError('align_anything_tpu_torch must be imported from '
                           'this checkout')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    smi = gpu_name_and_power()
    log(f'phase0 device={torch.cuda.get_device_name(0)} '
        f'count={torch.cuda.device_count()} torch={torch.__version__} '
        f'cuda={torch.version.cuda}')
    log(f'phase0 nvidia-smi: {smi}')
    log(f'phase0 Pillow (PIL) imports: {pillow_available()}')

    libs = build_kernels()
    if sys.argv[1:2] == ['--profile']:
        which = sys.argv[2:] or ['dpo', 'ppo', 'ti2t', 'qlora', 'gemma3']
        if 'dpo' in which:
            profile_dpo(dev, smi)
        tmp = tempfile.mkdtemp(prefix='chip_smoke_profile_')
        try:
            for name, fn in (('ppo', profile_ppo), ('ti2t', profile_ti2t),
                             ('qlora', profile_qlora),
                             ('gemma3', profile_gemma3)):
                if name in which:
                    fn(dev, smi, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0
    if '--planted-faults' in sys.argv[1:]:
        planted_faults(dev, smi)
        return 0
    if sys.argv[1:2] == ['--tile-sweep']:
        tile_sweep(dev, smi, sys.argv[2:])
        return 0
    check_k2_tensor_cores(libs['int4_matmul'])

    kstats = check_kernel(dev)
    o_projection(dev)
    abstats = check_ab(dev, smi)
    torch.cuda.empty_cache()

    cfg = llama_config().replace(compute_dtype='bfloat16')
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_params(cfg, dev)
    torch.cuda.synchronize()
    weight_bytes = sum(
        t.numel() * t.element_size()
        for sub in params['layers'].values() for leaf in sub.values()
        for t in ((leaf.values, leaf.scales)
                  if isinstance(leaf, q.Int4Weight) else (leaf,)))
    weight_bytes += sum(t.numel() * t.element_size() for t in (
        params['embedding'], params['final_norm']['w'],
        params['lm_head'].values, params['lm_head'].scales))
    log(f'phase3 built int4 Llama-3-8B-geometry params in '
        f'{time.perf_counter() - t0:.1f} s: weights {weight_bytes / 1e9:.3f} '
        f'GB, resident {torch.cuda.memory_allocated() / 1e9:.3f} GB')

    engine = ContinuousBatchingEngine(cfg, num_slots=DECODE_SLOTS,
                                      max_len=MAX_LEN, prompt_buckets=(128,))
    gen_cfg = GenerationConfig(max_new_tokens=NEW_TOKENS, temperature=1.0,
                               eos_token_id=-1)
    batches = make_batches(cfg)
    requests = {rid: req for batch in batches for rid, req in batch}
    torch.cuda.reset_peak_memory_stats()
    k2.int4_matmul_cuda.launches = 0
    served = serve(engine, params, gen_cfg, batches, dev)
    launches = k2.int4_matmul_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    results = served['results']
    steps = engine.stats['total_steps']
    n_tok = sum(len(t) for t in results.values())
    need = steps * (4 * cfg.num_layers + 1)
    log(f'phase4 served {len(results)}/{len(requests)} requests, {n_tok} '
        f'tokens in {served["seconds"]:.2f} s = {n_tok / served["seconds"]:.1f}'
        f' tokens/s; decode steps {steps}; int4 launches {launches} '
        f'(need >= {need}); peak memory {peak / 1e9:.3f} GB; card {smi}')
    if len(results) != len(requests):
        raise AssertionError('not every request finished')
    for rid, toks in results.items():
        if len(toks) != NEW_TOKENS:
            raise AssertionError(f'request {rid}: {len(toks)} tokens, '
                                 f'budget {NEW_TOKENS}')
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f'request {rid}: token out of vocab')
    if launches < need:
        raise AssertionError(f'int4 kernel launched {launches} times, '
                             f'expected >= {need}')

    kern, plain, next_tok = recompute_step(
        params, cfg, requests[0]['input_ids'], results[0], dev)
    err = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    same = int(kern.argmax()) == int(plain.argmax())
    log(f'phase4 recomputed decode step: max|kernel-plain|={err:.4e} '
        f'max|logit|={scale:.4e} greedy kernel={int(kern.argmax())} '
        f'plain={int(plain.argmax())} engine={next_tok}')
    if not (torch.isfinite(kern).all() and err <= 2e-2 * scale and same):
        raise AssertionError('decode step disagrees with the plain int4 path')

    del params, engine, served
    torch.cuda.empty_cache()

    for line in ptxas_lines(libs['flash_attention'].build_log):
        log(f'phase5 flash_attention ptxas: {line}')
    for d in fa.SUPPORTED_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            route = ('tensor cores (wgmma)' if dtype == torch.bfloat16
                     and d in fa.TENSOR_CORE_HEAD_DIMS else 'CUDA cores')
            for kname, info in fa.kernel_info(d, dtype).items():
                log(f'phase5 flash_attention {kname:7s} D={d:<3d} '
                    f'{str(dtype)[6:]:8s} route='
                    f'{"CUDA cores" if kname == "delta" else route} '
                    f'registers={info["registers"]} '
                    f'spill_bytes={info["spill_bytes"]} '
                    f'smem_bytes={info["smem_bytes"]}')
    check_tensor_cores(libs['flash_attention'])

    fstats = check_flash(dev)
    for seed, case in enumerate(FLASH_PPO):
        worst, timed = check_flash_ppo(dev, case, SEED + 40 + seed)
        for kind, err in worst.items():
            fstats['worst'][kind] = max(fstats['worst'][kind], err)
        if timed:
            fstats['timed'][case[0]] = timed
    dpo = train_dpo(dev, smi)
    torch.cuda.empty_cache()
    bench_dpo(dev, smi)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_harness_')
    try:
        harness = harness_full(dev, smi, dpo, tmp)
        torch.cuda.empty_cache()
        harness_small(dev, smi, tmp)
        free_memory()
        rm = rm_full(dev, smi, tmp)
        ppo = ppo_full(dev, smi, tmp, rm)
        cost = rl_small(dev, smi, tmp)
        kto = kto_full(dev, smi, tmp)
        grpo = grpo_full(dev, smi, tmp, rm)
        safe = saferlhf_full(dev, smi, tmp)
        variants = rl_variants_small(dev, smi, tmp, cost)
        ti2t = ti2t_full(dev, smi, tmp)
        ti2t_sft = ti2t_small(dev, smi, tmp)
        ti2t_rm = ti2t_rm_full(dev, smi, tmp)
        ti2t_ppo = ti2t_ppo_full(dev, smi, tmp, ti2t_rm)
        ti2t_rl = ti2t_rl_small(dev, smi, tmp, ti2t_sft)
        qlora4 = qlora_full(dev, smi, tmp, 4, QLORA_STEPS)
        qlora8 = qlora_full(dev, smi, tmp, 8, QLORA_INT8_STEPS)
        lora = lora_small(dev, smi, tmp, cost)
        gemma = gemma3_dpo(dev, smi, tmp)
        gemma_gen = gemma3_generation(dev, smi, gemma['ckpt'])
        shutil.rmtree(gemma['ckpt'], ignore_errors=True)
        remat = remat_sweep(dev, smi)
        saves = async_save(dev, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    log(f'done: {disk_written():.3f} GB written by the run')
    t8 = fstats['timed']['llama8b']
    vit = fstats['timed']['vit336']
    mm_ppo = fstats['timed']['ti2t_ppo']
    g3 = {name: fstats['timed'][name]
          for name in ('gemma3_1b', 'gemma3_1b_w512')}
    main_path = (dpo, harness, rm, ppo, kto, grpo, safe, variants, ti2t,
                 ti2t_sft, ti2t_rm, ti2t_ppo, ti2t_rl, qlora4, qlora8, lora,
                 gemma, gemma_gen, remat, saves)
    flash = {'route': 'cuda',
             'source': 'align_anything_tpu_torch/csrc/flash_attention.cu',
             'ms_is': 'B4 L1024 H32 KH8 D128 causal, 2 rows padded '
                      '(Llama-3-8B widths); library_ms: '
                      'scaled_dot_product_attention, causal, no padding; '
                      'vit336: B8 L577 H16 KH16 D64 full (the CLIP '
                      'ViT-L/14-336 tower), SDPA full; ti2t_ppo: B8 L1152 '
                      'H32 KH32 D128 causal with leading and trailing pads '
                      '(phase 20\'s scoring pass), SDPA causal, no padding; '
                      'gemma3_1b: B4 L2048 H4 KH1 D256 causal, 2 rows padded '
                      '(Gemma-3-1B\'s full layers), gemma3_1b_w512 the same '
                      'with the window 512 (its sliding layers), SDPA over '
                      'the whole causal square, no window',
             'launches_are': 'phase 7 (4 bare DPO steps) + phase 9 (4 DPO '
                             'steps through trainer_main) + phase 11 (4 RM '
                             'steps) + phase 12 (3 PPO rounds) + phase 14 '
                             '(4 KTO steps, 2 KL estimates) + phase 15 (2 '
                             'GRPO rounds) + phase 16 (2 Safe-RLHF rounds) '
                             '+ phase 17 (remote-RM PPO, PPO on the '
                             'continuous rollout, KTO and GRPO, small) + '
                             'phase 18 (4 TI2T DPO steps at LLaVA-1.5-7B '
                             'widths: the 23-layer tower forward twice a '
                             'step) + phase 18b (TI2T SFT, tower trained and '
                             'frozen, small) + phase 19 (4 TI2T RM steps) + '
                             'phase 20 (3 TI2T PPO rounds: the tower in the '
                             'prefill, 4 scoring passes, actor and critic '
                             'updates, towers trained) + phase 21 (TI2T cost '
                             'model, Safe-RLHF-V, GRPO, KTO, ORPO, SimPO, '
                             'small) + phase 22 (QLoRA DPO at Llama-3-8B\'s '
                             'full 32 layers: 4 steps on the int4 base, 2 on '
                             'the int8 base) + phase 23 (every LoRA trainer, '
                             'LoRA and QLoRA, small) + phase 24 (4 DPO steps '
                             'at Gemma-3-1B\'s full size) + phase 25 (its '
                             'training forward beside the generation, which '
                             'runs no kernel) + phase 26 (3 DPO steps under '
                             'each of the ten remat policies) + phase 27 (8 '
                             'DPO steps around two saves, small)'}
    print(json.dumps({'kernels': [{
        'name': 'int4_matmul', 'route': 'cuda',
        'source': 'align_anything_tpu_torch/csrc/int4_matmul.cu',
        'replaces': 'align_anything_tpu/ops/int4_matmul.py:124',
        'also_replaces': 'align_anything_tpu/ops/int4_matmul.py:153',
        'launches': launches, 'max_abs_err': kstats['max_abs_err'],
        'ms': kstats['ms'], 'plain_ms': kstats['plain_ms'],
        'bound_ms': kstats['bound_ms'], 'bound_by': kstats['bound_by'],
        'library_ms': kstats['library_ms'],
        'ms_is': 'one decode step at 32 slots: 4x32 layer matmuls + head; '
                 'library_ms: torch._weight_int4pack_mm'}, *({
        'name': f'int4_matmul_{tag}', 'route': 'cuda',
        'source': 'align_anything_tpu_torch/csrc/int4_matmul.cu',
        'replaces': f'scripts/bench/bench_int4_kernel_ab.py:{line}',
        'also_replaces': f'scripts/bench/bench_int4_kernel_ab.py:{body}',
        'launches': abstats['launches'][tag],
        'max_abs_err': abstats['worst'][tag],
        'ms': abstats['total'][tag], 'plain_ms': abstats['total'][
            f'{tag}_plain'],
        'bound_ms': abstats['total']['bound'],
        'bound_by': abstats['bound_by'],
        'library_ms': abstats['total']['library'],
        'ms_is': 'sum of qkv + down + gate_up at M 32 (Llama-3-8B widths), '
                 "v2's with its -8 correction (torch); library_ms: "
                 'torch._weight_int4pack_mm on the v0 weights'}
        for tag, line, body in (('v1', 177, 65), ('v2', 152, 107))), {
        'name': 'flash_attention_fwd', **flash,
        'replaces': 'align_anything_tpu/ops/attention.py:87',
        'also_replaces': 'align_anything_tpu/ops/attention.py:73, '
                         'align_anything_tpu/ops/attention.py:186, '
                         'align_anything_tpu/ops/attention.py:225',
        'launches': sum(x['launches']['fwd'] for x in main_path),
        'max_abs_err': fstats['worst']['fwd'], 'ms': t8['ms'],
        'plain_ms': t8['plain_ms'], 'bound_ms': t8['bound_ms'],
        'bound_by': t8['bound_by'], 'library_ms': t8['library_ms'],
        'vit336': {k: vit[k] for k in ('ms', 'plain_ms', 'library_ms',
                                       'bound_ms', 'bound_by')},
        'ti2t_ppo': {k: mm_ppo[k] for k in ('ms', 'plain_ms', 'library_ms',
                                            'bound_ms', 'bound_by')},
        **{name: {k: t[k] for k in ('ms', 'plain_ms', 'library_ms',
                                    'bound_ms', 'bound_by')}
           for name, t in g3.items()}}, {
        'name': 'flash_attention_bwd', **flash,
        'replaces': 'align_anything_tpu/ops/attention.py:99',
        'also_replaces': 'align_anything_tpu/ops/attention.py:186, '
                         'align_anything_tpu/ops/attention.py:225',
        'launches': sum(x['launches']['bwd'] for x in main_path),
        'max_abs_err': fstats['worst']['bwd'], 'ms': t8['bwd_ms'],
        'plain_ms': t8['plain_bwd_ms'], 'bound_ms': t8['bwd_bound_ms'],
        'bound_by': t8['bwd_bound_by'],
        'library_ms': t8['library_bwd_ms'],
        'vit336': {'ms': vit['bwd_ms'], 'plain_ms': vit['plain_bwd_ms'],
                   'library_ms': vit['library_bwd_ms'],
                   'bound_ms': vit['bwd_bound_ms'],
                   'bound_by': vit['bwd_bound_by']},
        'ti2t_ppo': {'ms': mm_ppo['bwd_ms'],
                     'plain_ms': mm_ppo['plain_bwd_ms'],
                     'library_ms': mm_ppo['library_bwd_ms'],
                     'bound_ms': mm_ppo['bwd_bound_ms'],
                     'bound_by': mm_ppo['bwd_bound_by']},
        **{name: {'ms': t['bwd_ms'], 'plain_ms': t['plain_bwd_ms'],
                  'library_ms': t['library_bwd_ms'],
                  'bound_ms': t['bwd_bound_ms'],
                  'bound_by': t['bwd_bound_by']}
           for name, t in g3.items()}}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
