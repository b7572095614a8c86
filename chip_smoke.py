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
     without, at phase 31's decoder (``llava_next``: L 4096 at
     LLaVA's heads), at phase 34's (``qwen2_vl_2b``: L 1024 at
     Qwen2-VL-2B's 12 / 2 heads), at phase 36's tower
     (``qwen2_audio_tower``: full attention at L 1500, 20 heads of 64) and
     at phase 41's decoder (``qwen3_moe``: L 1024 at qwen3-moe-30b-a3b's
     32 / 4 heads of 64);
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
     SFT's step 1 against a plain recompute, ORPO and SimPO (the saves
     that no check reads are not written: ``unread_saves_skipped``);
 11. the reward model at Llama-3-8B widths cut to 2 layers through
     ``trainer_main(RMTrainer, ...)`` (phase 9's bf16 checkpoint read at 2
     layers through a hard link, 8 pairs in the 512 bucket, 4 steps):
     every loss and grad norm
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
     heads; six models, the cost model's backbone the reward model's
     through a hard link; 8 prompts a round, micro-batch 4, 2 rounds): round
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
     LLaVA-1.5-7B widths, the text model cut to 2 layers (phase 18's
     checkpoint through a hard link), the 24-layer tower frozen: 8 AA_TI2T
     preference rows with PNG images, 4 steps of 2
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
 28. (beside phase 4, on phase 3's params) the first 32 of phase 4's
     requests (its first two batches) through
     the paged pool (page size 16): (a) the full pool, ``1 + 32 x 16``
     pages, (b) half of it, where every request still finishes with fewer
     than 32 live at once, then bench.py's prefix pattern (a 48-token shared
     prefix, each prompt cut to keep its length) (c) dense and (d) paged;
     every request's budget, K2's launches per decode step as phase 4's,
     one paged decode step against the plain int4 path, and each
     prefix-cached request's first next-token logits against its uncached
     prefill, both in fp32 on the dequantized weights (1e-4 x
     max|logit|, the same greedy token; the bf16 distance logged);
     tokens/s, peak memory, the prefill seconds the prefix saves and time
     to first token (p50 / max);
 29. ``scripts/bench/bench_int4_7b.py``'s ``run`` at Llama-3-8B's 32
     layers: int4 (128 slots, ``o`` flattened, an int8-COMPUTE head) and
     int8-COMPUTE (64 slots), each dense and paged, one wave of requests
     (as many as slots); every request's 64 tokens, K2's launches (those
     on ``o`` apart), resident and peak GB;
 30. (after phase 25, on phase 24's checkpoint) the OpenAI-compatible HTTP
     server (``serve/api_server.py``, ``make_stdlib_server`` on a free port
     of 127.0.0.1), dense, then paged with a 48-word system text as its
     cached prefix: 16 concurrent clients mixing ``/health``,
     ``/v1/models``, completions and chat, plain and streamed (SSE), with
     prompts of 520-550 tokens (longer than the window 512) and 32 new
     tokens a request; every reply
     200 and every stream ending in ``[DONE]``; in fp32 the server's greedy
     ids equal a direct ``engine.generate`` of the same prompts and a
     streamed completion joins into the non-streamed text; bf16 timed:
     generated tokens/s, time to first token from the streams, peak
     memory, and how many greedy ids equal the engine's.
 31. (after phase 21) TI2T DPO through ``trainer_main(TI2TDPOTrainer,
     ...)`` on LLaVA-Next AnyRes at llava-v1.6-vicuna-7b widths (phase
     18's tensors hard-linked, text 4 layers, the 24-layer tower frozen,
     ``image_newline`` and the pinpoints; the geometry held against
     transformers' ``LlavaNextConfig()``): 8 AA_TI2T pairs over 672 x 672,
     336 x 1008 and 1008 x 336 PNGs (five crops, up to 2928 image tokens a
     row), 2 pairs a step in the 4096 bucket, 4 steps: step 1's loss ln 2,
     each row's image tokens equal to its ``num_tokens``, the tower
     bit-equal while the language model, projector and newline move,
     launches exact, step 1's log-prob sums against a plain recompute;
     step time, tokens/s and peak memory;
 32. TV2T SFT and DPO through their entry points on LLaVA-NeXT-Video at
     LLaVA-NeXT-Video-7B widths (the same tensors hard-linked; video token
     32000, image token 32001, stride 2, a pad that is neither; the
     geometry held against ``LlavaNextVideoConfig()``), ``.npy`` videos:
     SFT 8 frames a row (1152 pooled video tokens) in the 2048 bucket, DPO
     as JAX's (ROADMAP R26: 4 frames x 576 image tokens, the frames merged
     nowhere) in the 4096 bucket; each row's token counts, launches exact,
     step 1 against a plain recompute, the modules that move;
 33. at phase 10's text widths (1 layer) under a 2-layer tower: AnyRes
     TI2T SFT and its bf16 export read back (LLaVA-Next tensor names), the
     TV2T reward model and its export (LLaVA-NeXT-Video) read back, TV2T
     PPO from that export (5-D frames through ``generate``'s prefill) and
     TV2T GRPO; every metric finite, launches exact, the RL trainers'
     round-1 KL 0.
 34. (after phase 33) TI2T DPO through ``trainer_main(TI2TDPOTrainer,
     ...)`` on Qwen2-VL at Qwen2-VL-2B-Instruct's published widths (the
     text cut to 4 of its 28 layers, the 32-block tower, which trains:
     ROADMAP R27), a bf16 checkpoint from a seed written by the port's
     exporter, 4 ``Qwen2-VL``-template pairs over PNGs of four sizes at
     dynamic resolution (``--dynamic_resolution True``: 242-256 image
     tokens, two grids in each batch), 2 pairs in the 1024 bucket, 2 steps:
     step 1's loss ln 2, each row's image tokens equal to its grid's, the
     m-rope streams equal to a row-by-row host recomputation (h and w
     differ in each span), the tower and the trunk moved, launches exact,
     step 1's log-prob sums against a plain recompute; step time,
     tokens/s, MFU and peak memory;
 35. at phase 10's text widths (2 layers) under published-width towers of
     2 (Qwen2-VL) and 4 blocks (Qwen2.5-VL, windows of 112 px and a full
     block): TI2T SFT on Qwen2-VL at 224 px and at dynamic resolution,
     Qwen2.5-VL SFT and DPO at dynamic resolution, 2 steps each, launches
     exact; then greedy ``generate`` of 16 tokens from 2 Qwen2-VL image
     prompts with ``prefill_positions`` / ``position_offset`` (fp32
     compute): every id the argmax of a no-cache forward over the grown
     sequence.
 36. (after phase 35) TA2T DPO through ``trainer_main(TA2TDPOTrainer,
     ...)`` on Qwen2-Audio at Qwen2-Audio-7B-Instruct's published widths
     (the text cut to 4 of its 32 layers, the 32-layer Whisper-style tower
     whole and frozen), a bf16 checkpoint from a seed written by the port's
     exporter and read by ``load_audio_params``, 4 AA_TA2T pairs over 30 s
     16-bit wav clips made from the seed, 2 pairs a step in the 1024
     bucket, 2 steps: step 1's loss ln 2, each row's <audio> span 750
     tokens, the tower bit-equal while the trunk and projector move,
     launches exact, the card's log-mel within 2e-4 of the CPU's, step 1's
     log-prob sums against a plain recompute; step time, tokens/s, MFU,
     peak memory and the bytes written;
 37. at phase 10's text widths (1 layer, Qwen2) under a 2-layer tower of
     the published widths, clips of 2-30 s: TA2T SFT and its export read
     back through ``load_audio_params``, the RM, one PPO round and one
     GRPO round (the rollout's prefill takes the clips; round 1's KL 0;
     the towers train, R13), and SFT over a fresh encoder on phase 10's
     text checkpoint; launches exact.
 38. (after phase 37) TI2T DPO through ``trainer_main(TI2TDPOTrainer,
     ...)`` on Mllama at Llama-3.2-11B-Vision-Instruct's published widths
     (the text cut to 5 of its 40 layers, layer 3 the cross layer; the
     tower cut to 8 local and 2 global layers, the five taps remapped
     inside them, so the feature stays 7680 wide), a bf16 checkpoint from
     a seed (the gates drawn from it) written by ``save_mllama_params`` and
     read by ``load_mllama_params``, 4 AA_TI2T pairs over PNGs of 560 x
     560, 560 x 1120, 1120 x 1120 and 1120 x 560 (1, 2, 4 and 2 tiles), 2
     pairs a step in the 1024 bucket, 2 steps: step 1's loss ln 2, one
     image token a row, the cross mask from it onward over the row's valid
     tiles, the tile metadata equal to the processor's run again on the
     host, every module moved (the tower too: ROADMAP R30), launches exact
     (the self-attention layers; the tower's attention and the cross layer
     are plain PyTorch, as in JAX), step 1's log-prob sums against a plain
     recompute; step time, tokens/s, MFU (the tower's FLOPs counted) and
     peak memory; the checkpoint deleted after its last reader;
 39. at phase 10's text widths (2 layers, layer 1 cross) under a tower of
     the published widths (2 local + 1 global layers): Mllama TI2T SFT and
     its bf16 export read back through ``load_mllama_params``, KTO, ORPO
     and SimPO one step each, launches exact; greedy ``generate`` of 16
     tokens from 2 image prompts with ``init_cache_fn=mllama.init_cache``
     (fp32 compute): every id the argmax of a no-cache forward over the
     grown sequence.
 40. (after phase 39) MoE serving at the repo's 'qwen3-moe-30b-a3b' preset
     (JAX's: 64 experts of 768, top 8, hidden 2048, 32 / 4 heads of 64,
     vocab 151936) at its full 24 layers, seeded random weights,
     int4-COMPUTE as ``quantize_decoder_int4`` leaves an MoE tree (experts
     fp32; router, q / k / v / o and head int4): 8 requests of 112-128
     prompt tokens and 32 new ones through ``generate`` and the continuous
     engine, dense and paged cache, each ``moe_impl``; in fp32 over the
     dequantized tree the three paths' greedy ids equal, in bf16 tokens/s,
     K2's launches and peak memory; the prefill logits and aux loss of the
     sparse dispatch against the dense one in bf16 (within 3x the bf16
     noise) and in fp32 (99 % of positions within 1e-3 x max|logit|);
 41. SFT through ``trainer_main(SupervisedTrainer, ...)`` from that preset
     at its widths, cut to 4 layers: 2 rows x 1024, 2 steps with each
     ``moe_impl``, remat 'save_flash': step 1's loss,
     ``train/router_aux_loss`` and per-module gradient norms through the
     kernels against the plain attention (``check_sums``, in fp32 and in
     bf16), the two dispatches' step-1 losses against each other, the
     router and every expert moved, launches exact; step time, tokens/s,
     MFU and peak memory; then ``bench.py``'s ``bench_moe_extra`` config
     (32 experts of 1408, top 2, 4 layers at width 1024, 8 x 512 tokens)
     timed, dense against sparse dispatch;
 42. at small widths (hidden 256, 2 layers, 4 experts, top 2): the int8
     tree (experts on their axis 2) and the forward over it, int4
     ``fuse=True`` refused (ROADMAP R31), SFT through ``trainer_main``
     with its export (written as JAX writes it, with the R34 warning) and
     a resume from its step-2 train state, one DPO step (ln 2).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit from nvidia-smi, and the one before that a
JSON summary of each kernel.

    python3 chip_smoke.py --profile [dpo ppo ti2t qlora gemma3 qwen2vl
                                     ta2t mllama]
                                      # instead: trace one DPO step of the
                                      # phase 7 and phase 8 configs, one
                                      # PPO round of phase 12's, one TI2T
                                      # DPO step of phase 18's, one
                                      # QLoRA DPO step of phase 22's, one
                                      # Gemma-3-1B DPO step and
                                      # generate call of phases 24-25's,
                                      # one Qwen2-VL DPO step of phase 34's
                                      # with its tower and the tower's
                                      # attention alone, one TA2T DPO
                                      # step of phase 36's with its encoder
                                      # and log-mel frontend alone, and one
                                      # Mllama DPO step of phase 38's with
                                      # its tower, the tower's attention
                                      # and the cross layer alone (the
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

import functools
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
from align_anything_tpu_torch.serve import api_server
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
# (name, K, N) of every int4 matmul K2 takes on phase 40's path at
# qwen3-moe-30b-a3b's widths (q, k and v, the head; the experts stay fp):
# checked, untimed, at CHECK_ROWS and at phase 40's 8 decode slots
MOE_K2_SHAPES = [('moe_q', 2048, 2048), ('moe_kv', 2048, 256),
                 ('moe_head', 2048, 151936)]
MOE_CHECK_ROWS = (1, 8, 16, 17, 32, 33, 128)
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
    # phase 31's decoder: LLaVA-Next AnyRes DPO rows (up to 2928 image
    # tokens) in the 4096 bucket at llava-v1.6-vicuna-7b's heads, trailing
    # pads on two rows
    ('llava_next', 4, 4096, 32, 32, 128, True, None, 2, None,
     torch.bfloat16, True),
    # phase 34's decoder: Qwen2-VL-2B's heads (12 / 2, a GQA group of 6)
    # over its DPO rows in the 1024 bucket, trailing pads on two rows
    ('qwen2_vl_2b', 4, 1024, 12, 2, 128, True, None, 2, None,
     torch.bfloat16, True),
    # phase 36's tower: Qwen2-Audio-7B's Whisper-style encoder, full
    # attention over the 1500 frames of a 30 s clip at 20 heads of 64 (a
    # ragged tail: 1500 = 23 x 64 + 28), the DPO step's 4 rows
    ('qwen2_audio_tower', 4, 1500, 20, 20, 64, False, None, 0, None,
     torch.bfloat16, True),
    # phase 41's decoder: qwen3-moe-30b-a3b's heads (32 / 4 of 64, a GQA
    # group of 8) over its SFT rows in the 1024 bucket, trailing pads on
    # two rows
    ('qwen3_moe', 2, 1024, 32, 4, 64, True, None, 2, None, torch.bfloat16,
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
    for name, k, n, rows, timed in (
            [(*s, CHECK_ROWS, True) for s in SHAPES]
            + [(*s, MOE_CHECK_ROWS, False) for s in MOE_K2_SHAPES]):
        w = torch.randn((k, n), generator=gen, device=dev,
                        dtype=torch.bfloat16) * (k ** -0.5)
        qw = q.quantize_int4(w, (0,), group_size=GROUP, compute=True)
        del w
        g = k // GROUP
        vals, sc = qw.values, qw.scales.reshape(g, n)
        for m in rows:
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
                if timed and m in TIMED_ROWS:
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
                if timed and m == DECODE_SLOTS and (
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


# phases 28-29: the paged pool, the prefix cache and the 8B int4 / int8
# serving bench.  Phase 28 serves phase 4's 48 requests on phase 3's params
# (32 slots, max_len 256) through the paged pool, full and halved, and
# bench.py's prefix pattern (``bench_continuous``: a 48-token shared prefix,
# each prompt cut so its length stays) dense and paged.  Time to first token
# is the host clock from the call's start to the chunk boundary where a
# request's first token reaches ``on_tokens``: the engine streams per chunk.
PREFIX_LEN = 48
PREFIX_BUCKETS = (64, 96, 128)
HALF_POOL = 1 + 16 * (MAX_LEN // 16)
# phase 28 serves phase 4's first two batches: one wave of decode at 32
# slots on the full pool (48 requests took two, and the phase 75.1 s on
# an H100 80GB HBM3 at 700 W; 32 take 45.4-49.8 s); the half pool (b) and
# the paged prefix run on 16 slots (d) still admit requests into released
# slots and pages
PAGED_REQUESTS = 2 * PER_BATCH
# prefix-cached against uncached first logits in fp32: max|diff| /
# max|logit|; fp32 rounding over 32 layers sits orders of magnitude below
PREFIX_TOL = 1e-4
PREFILLS = ('_prefill_dense', '_prefill_paged')


def live_at_once(stats: dict) -> int:
    """The most requests live in one decode step, from the engine's
    admission and finish steps."""
    spans = [(stats['admit_step'][r], stats['finish_step'][r])
             for r in stats['admit_step']]
    return max(sum(a <= s < f for a, f in spans)
               for s in range(stats['total_steps']))


def quantiles(xs: list) -> str:
    return (f'p50 {statistics.median(xs):.3f} s, max {max(xs):.3f} s '
            f'over {len(xs)}')


def serve_timed(engine, params, requests: list, gen_cfg, dev,
                seed: int) -> dict:
    """One ``generate`` call over every request at once: wall clock, peak
    memory, K2's launches, each request's time to first token, and the
    seconds its prefills took on the stream (CUDA events around each
    prefill call, read after the run: no host synchronization in the
    timed window, so the engine runs as it does untimed)."""
    marks: list = []

    def timed(fn):
        def call(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn(*args, **kwargs)
            end.record()
            marks.append((start, end))
        return call

    for name in PREFILLS:
        setattr(engine, name, timed(getattr(engine, name)))
    first: dict = {}
    free_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k2.int4_matmul_cuda.launches = 0
    try:
        t0 = time.perf_counter()
        outs = engine.generate(
            params, requests, gen_cfg,
            torch.Generator(device=dev).manual_seed(seed),
            chunk_steps=CHUNK_STEPS,
            on_tokens=lambda rid, toks: first.setdefault(
                rid, time.perf_counter() - t0))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        for name in PREFILLS:
            delattr(engine, name)
    return {'outputs': outs, 'seconds': seconds,
            'tokens': sum(len(o) for o in outs),
            'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
            'launches': k2.int4_matmul_cuda.launches,
            'ttft': [first[r] for r in range(len(requests))],
            'prefill_s': sum(a.elapsed_time(b) for a, b in marks) / 1e3,
            'steps': engine.stats['total_steps'],
            'live': live_at_once(engine.stats),
            'late': sum(s > 0 for s in engine.stats['admit_step'].values())}


def recompute_paged_step(params, cfg, prompt, out, dev):
    """One decode step of one request through the page pool, through the
    kernel and through the plain int4 path, from the same pool."""
    eng = ContinuousBatchingEngine(cfg, num_slots=1, max_len=MAX_LEN,
                                   cache_mode='paged')
    st = eng._init_state(dev)
    j = len(out) // 2
    ids = prompt + out[:j]
    eng._prefill_paged(params, st, 0, ids,
                       list(range(1, eng.max_pages_per_slot + 1)), 0.0,
                       len(ids), cfg.pad_token_id)
    lengths, live = st.lengths.clone(), ~st.done
    tok = torch.tensor([[out[j]]], device=dev)
    k0, v0 = st.cache.k.clone(), st.cache.v.clone()

    def step():
        st.cache.k.copy_(k0)
        st.cache.v.copy_(v0)
        return transformer.forward(
            params, cfg, tok, positions=lengths[:, None],
            cache=st.cache.step(lengths, live),
            cache_offset=lengths).logits[0, 0]

    kern = step()
    with mock.patch.object(k2, 'int4_matmul_cuda', k2.int4_matmul_reference):
        plain = step()
    torch.cuda.synchronize()
    return kern.float(), plain.float(), out[j + 1]


def check_decode_step(tag: str, kern, plain, next_tok) -> None:
    """Phase 4's limit: 2e-2 x max|logit|, the same greedy token."""
    err = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    same = int(kern.argmax()) == int(plain.argmax())
    log(f'{tag} recomputed decode step: max|kernel-plain|={err:.4e} '
        f'max|logit|={scale:.4e} greedy kernel={int(kern.argmax())} '
        f'plain={int(plain.argmax())} engine={next_tok}')
    if not (torch.isfinite(kern).all() and err <= 2e-2 * scale and same):
        raise AssertionError(f'{tag}: decode step disagrees with the plain '
                             'int4 path')


def wave_logits(engine, params, rows: list, cached: bool, pad: int,
                dev) -> torch.Tensor:
    """The first next-token logits of one wave of prompts (at most the
    engine's slots) through the engine's prefill: over ``rows``' tails
    after the cached prefix when ``cached``, else over them whole."""
    from align_anything_tpu_torch.utils.tools import bucket_length  # noqa: PLC0415

    st = engine._init_state(dev)
    n = engine._prefix['len'] if cached else 0
    rows = [r[n:] for r in rows]
    if engine.cache_mode == 'paged':
        pages = list(range(1, engine.max_pages_per_slot + 1))
        for slot, toks in enumerate(rows):
            engine._prefill_paged(
                params, st, slot, toks, pages, 0.0,
                bucket_length(len(toks), engine.prompt_buckets), pad, n)
    else:
        by_bucket: dict = {}
        for slot, toks in enumerate(rows):
            by_bucket.setdefault(bucket_length(
                len(toks), engine.prompt_buckets), []).append(slot)
        for bucket, slots in by_bucket.items():
            engine._prefill_dense(params, st, slots, [rows[s] for s in slots],
                                  [0.0] * len(slots), bucket, pad, n)
    return st.next_logits[:len(rows)].float()


def prefix_logits(engine, params, cfg, prefix: list, requests: list,
                  dev) -> dict:
    """Every request's first next-token logits through the engine's prefix
    prefill against its uncached prefill, in waves of the engine's slots.

    The check runs in fp32 compute on an engine of the same cache mode and
    prefix, every int4 product on the dequantized weight (K2 takes bf16
    activations, and the two paths' products differ in size, so in bf16
    they round along different routes): a wrong rope offset or stale prefix
    K/V shows far above fp32's rounding.  The bf16 engine's two paths are
    timed (synchronized host clock) and their distance logged."""
    fp32 = ContinuousBatchingEngine(
        cfg.replace(compute_dtype='float32'), num_slots=engine.num_slots,
        max_len=engine.max_len, prompt_buckets=engine.prompt_buckets,
        cache_mode=engine.cache_mode, num_pages=engine.num_pages)
    with mock.patch.object(k2, 'KERNEL_MAX_ROWS', 0):
        fp32.register_prefix(params, prefix)
    pad = cfg.pad_token_id
    worst, worst_bf16, same, same_bf16 = 0.0, 0.0, 0, 0
    secs = {True: 0.0, False: 0.0}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for start in range(0, len(requests), engine.num_slots):
        rows = [r['input_ids'] for r in requests[start:start
                                                 + engine.num_slots]]
        bf16 = {}
        for cached in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bf16[cached] = wave_logits(engine, params, rows, cached, pad, dev)
            torch.cuda.synchronize()
            secs[cached] += time.perf_counter() - t0
        with mock.patch.object(k2, 'KERNEL_MAX_ROWS', 0):
            exact = {cached: wave_logits(fp32, params, rows, cached, pad, dev)
                     for cached in (True, False)}
        for got, want in zip(exact[True], exact[False]):
            if not torch.isfinite(got).all():
                raise AssertionError('phase28: non-finite prefix logits')
            worst = max(worst, rel(got, want))
            same += int(got.argmax()) == int(want.argmax())
        for got, want in zip(bf16[True], bf16[False]):
            worst_bf16 = max(worst_bf16, rel(got, want))
            same_bf16 += int(got.argmax()) == int(want.argmax())
    return {'worst': worst, 'limit': PREFIX_TOL, 'same_argmax': same,
            'worst_bf16': worst_bf16, 'same_argmax_bf16': same_bf16,
            'cached_s': secs[True], 'plain_s': secs[False]}


def page_ops_ms(cfg, dev) -> dict:
    """Device time of one decode step's page operations at 32 slots and
    max_len 256 (CUDA events, L2 flushed): each layer gathers its K and V
    pages into (S, KH, T, D) and scatters one token into them; times the
    layers.  The dense cache reads its rows in place, so this is what the
    pool adds to a step's device time."""
    from align_anything_tpu_torch.generation import continuous  # noqa: PLC0415

    mp = MAX_LEN // 16
    pages = torch.randn((cfg.num_kv_heads, 1 + DECODE_SLOTS * mp, 16,
                         cfg.head_dim), device=dev, dtype=torch.bfloat16)
    tables = (1 + torch.randperm(DECODE_SLOTS * mp, device=dev)).reshape(
        DECODE_SLOTS, mp)
    lengths = torch.randint(112, 192, (DECODE_SLOTS,), device=dev)
    new = torch.randn((DECODE_SLOTS, cfg.num_kv_heads, cfg.head_dim),
                      device=dev, dtype=torch.bfloat16)
    live = torch.ones(DECODE_SLOTS, dtype=torch.bool, device=dev)
    flush = l2_flush_buffer(dev)
    gather = time_ms(lambda: continuous._gather_pages(pages, tables), 10,
                     flush)
    scatter = time_ms(lambda: continuous._scatter_token(
        pages, tables, lengths, new, live), 10, flush)
    per_step = 2 * cfg.num_layers
    return {'gather_ms': per_step * gather, 'scatter_ms': per_step * scatter}


def paged_serving(params, cfg, requests: dict, dev, smi) -> dict:
    """Phase 28: phase 4's first ``PAGED_REQUESTS`` requests through (a) the
    paged pool, (b) half of it, (c) dense and (d) paged on 16 slots with a
    48-token shared prefix."""
    t_phase = time.perf_counter()
    reqs = [requests[rid] for rid in sorted(requests)][:PAGED_REQUESTS]
    prefix = np.random.default_rng(SEED + 280).integers(
        5, cfg.vocab_size - 1, size=PREFIX_LEN).tolist()
    pre_reqs = [dict(r, input_ids=prefix + r['input_ids'][
        :len(r['input_ids']) - PREFIX_LEN]) for r in reqs]
    gen_cfg = GenerationConfig(max_new_tokens=NEW_TOKENS, temperature=1.0,
                               eos_token_id=-1)
    need_per_step = 4 * cfg.num_layers + 1
    runs = {
        'a_paged': (dict(cache_mode='paged', prompt_buckets=(128,)), reqs),
        'b_paged_half': (dict(cache_mode='paged', num_pages=HALF_POOL,
                              prompt_buckets=(128,)), reqs),
        'c_dense_prefix': (dict(cache_mode='dense',
                                prompt_buckets=PREFIX_BUCKETS), pre_reqs),
        # half the slots: the second batch enters slots and pages that
        # finished requests released, beside the pages of the prefix
        'd_paged_prefix': (dict(cache_mode='paged', num_slots=PER_BATCH,
                                prompt_buckets=PREFIX_BUCKETS), pre_reqs)}
    rows, launches = {}, 0
    for i, (name, (kw, rq)) in enumerate(runs.items()):
        engine = ContinuousBatchingEngine(
            cfg, max_len=MAX_LEN, **{'num_slots': DECODE_SLOTS, **kw})
        if name.endswith('prefix'):
            engine.register_prefix(params, prefix)
        r = serve_timed(engine, params, rq, gen_cfg, dev, SEED + 281 + i)
        launches += r['launches']
        need = r['steps'] * need_per_step
        log(f'phase28 {name}: {len(rq)} requests, {r["tokens"]} tokens in '
            f'{r["seconds"]:.3f} s = {r["tokens"] / r["seconds"]:.1f} '
            f'tokens/s; decode steps {r["steps"]}; most live at once '
            f'{r["live"]}, admitted after step 0 {r["late"]}; '
            + (f'pages {engine.num_pages}' if kw['cache_mode'] == 'paged'
               else 'dense cache') + '; time to '
            f'first token {quantiles(r["ttft"])}; prefill {r["prefill_s"]:.3f}'
            f' s; peak memory {r["peak_gb"]:.3f} GB; int4 launches '
            f'{r["launches"]} (need >= {need}); card {smi}')
        if not all(len(o) == NEW_TOKENS for o in r['outputs']):
            raise AssertionError(f'phase28 {name}: a request fell short of '
                                 'its budget')
        if not all(0 <= t < cfg.vocab_size for o in r['outputs'] for t in o):
            raise AssertionError(f'phase28 {name}: token out of vocab')
        if r['launches'] < need:
            raise AssertionError(f'phase28 {name}: int4 kernel launched '
                                 f'{r["launches"]} times, expected >= {need}')
        if name.endswith('prefix'):
            chk = prefix_logits(engine, params, cfg, prefix, rq, dev)
            r['prefix'] = chk
            log(f'phase28 {name}: prefix {engine._prefix["len"]} tokens '
                f'cached; first next-token logits against the uncached '
                f'prefill in fp32: worst max|diff| / max|logit| '
                f'{chk["worst"]:.3e} (limit {chk["limit"]:.0e}), same greedy '
                f'token {chk["same_argmax"]}/{len(rq)}; in bf16 (logged '
                f'only) {chk["worst_bf16"]:.3e}, same greedy token '
                f'{chk["same_argmax_bf16"]}/{len(rq)}; bf16 prefill '
                f'{chk["cached_s"]:.3f} s with the prefix, '
                f'{chk["plain_s"]:.3f} s without: '
                f'{chk["plain_s"] - chk["cached_s"]:.3f} s saved')
            if not (chk['worst'] <= chk['limit']
                    and chk['same_argmax'] == len(rq)):
                raise AssertionError(f'phase28 {name}: prefix-cached logits '
                                     'disagree with the uncached prefill')
        rows[name] = r
        del engine
    if not rows['b_paged_half']['live'] < DECODE_SLOTS:
        raise AssertionError('phase28: the half pool ran every slot at once')
    if not rows['d_paged_prefix']['late'] >= PAGED_REQUESTS - PER_BATCH:
        raise AssertionError('phase28: the prefix run admitted no request '
                             'into a released slot')
    half, full = rows['b_paged_half'], rows['a_paged']
    log(f'phase28 half pool against full: peak {half["peak_gb"]:.3f} / '
        f'{full["peak_gb"]:.3f} GB, tokens/s '
        f'{half["tokens"] / half["seconds"]:.1f} / '
        f'{full["tokens"] / full["seconds"]:.1f}')
    ops = page_ops_ms(cfg, dev)
    step_ms = 1e3 * (full['seconds'] - full['prefill_s']) / full['steps']
    log(f'phase28 page operations of one decode step at {DECODE_SLOTS} '
        f'slots ({cfg.num_layers} layers x K and V, device time): gather '
        f'{ops["gather_ms"]:.3f} ms, token scatter {ops["scatter_ms"]:.3f} '
        f'ms; run (a)\'s decode step {step_ms:.2f} ms of wall clock')
    kern, plain, next_tok = recompute_paged_step(
        params, cfg, reqs[0]['input_ids'], rows['a_paged']['outputs'][0], dev)
    check_decode_step('phase28 paged', kern, plain, next_tok)
    log(f'phase28 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'rows': rows, 'page_ops': ops}


def bench_int4_8b(dev, smi) -> dict:
    """Phase 29: ``scripts/bench/bench_int4_7b.py``'s ``run`` at Llama-3-8B's
    32 layers, int4 (128 slots) and int8 (64, as its ``main`` caps them),
    each dense and paged, one wave of requests (as many as slots; the
    script's default serves two); K2's launches counted, those on ``o``
    apart."""
    from align_anything_tpu_torch.scripts.bench import bench_int4_7b  # noqa: PLC0415

    t_phase = time.perf_counter()
    cfg = llama_config()
    o_shape = (cfg.num_heads * cfg.head_dim, cfg.hidden_size)
    launches, rows = 0, {}
    for mode, slots in (('int4', 128), ('int8', 64)):
        for cache_mode in ('dense', 'paged'):
            free_memory()
            on_o = [0]
            real = k2.int4_matmul

            def counting(x, w, dtype=torch.bfloat16, real=real, on_o=on_o):
                # a call on o: K2 launched on a (H * D, E) layer weight
                before = k2.int4_matmul_cuda.launches
                out = real(x, w, dtype)
                g, half = w.values.shape[:2]
                if (k2.int4_matmul_cuda.launches > before
                        and (g * 2 * half, math.prod(w.values.shape[2:]))
                        == o_shape):
                    on_o[0] += 1
                return out

            k2.int4_matmul_cuda.launches = 0
            with mock.patch.object(k2, 'int4_matmul', counting):
                r = bench_int4_7b.run(mode, slots=slots,
                                      cache_mode=cache_mode, device=dev,
                                      n_requests=slots)
            n = k2.int4_matmul_cuda.launches
            launches += n
            outs = r.pop('outputs')
            rows[f'{mode}_{cache_mode}'] = dict(r, k2_launches=n,
                                                k2_launches_o=on_o[0])
            log(f'phase29 {mode} {cache_mode}: {r["requests"]} requests, '
                f'{r["tokens"]} tokens in {r["decode_s"]} s = '
                f'{r["tokens_per_sec"]} tokens/s at {r["lanes"]} slots '
                f'(first call {r["first_call_s"]} s, init {r["init_s"]} s); '
                f'weights {r["weights_gb"]} GiB + KV {r["kv_gb"]} GiB = '
                f'resident {r["hbm_resident_gb"]} GiB, peak '
                f'{r["peak_bytes_gb"]} GiB; K2 launches {n} (on o {on_o[0]}); '
                f'card {smi}')
            if not (len(outs) == r['requests']
                    and all(len(o) == r['new_tokens'] for o in outs)):
                raise AssertionError(f'phase29 {mode} {cache_mode}: a request '
                                     'fell short of its 64 tokens')
            if mode == 'int4' and not (n > 0 and on_o[0] > 0):
                raise AssertionError(f'phase29 int4 {cache_mode}: K2 was not '
                                     'launched on o')
            del outs, r
    log(f'phase29 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'rows': rows}


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


def nudged_plain_flash(seed: int = SEED + 99):
    """The flash kernels patched to their plain versions, each element of
    the forward's bf16 output moved by at most one ulp, up or down at
    random (x (1 +- 2^-8), rounded): a second sample of the plain pass's
    own bf16 noise, without a bias."""
    gens: dict = {}

    def fwd(*args, **kwargs):
        out, lse = fa.flash_attention_fwd_reference(*args, **kwargs)
        gen = gens.setdefault(out.device, torch.Generator(
            device=out.device).manual_seed(seed))
        sign = torch.randint(0, 2, out.shape, generator=gen,
                             device=out.device) * 2 - 1
        return (out.float() * (1 + sign * 2 ** -8)).to(out.dtype), lse

    return mock.patch.multiple(
        fa, flash_attention_fwd_cuda=fwd,
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


def unread_saves_skipped(state_steps: tuple = (), slice_steps: tuple = ()):
    """A patch of the trainers' checkpoint writers that writes only what a
    later check reads: the train state of ``state_steps`` and the HF slice
    of ``slice_steps``, each once.  A run that saves at an interval writes
    both at every interval step and again at its last step (the interval's
    save and ``trainer_main``'s final one); the rest is disk writes that
    nothing reads, which count toward the card's 45 GiB."""
    from align_anything_tpu_torch import checkpoint as ckpt_lib  # noqa: PLC0415

    written: set = set()

    def writer(kind: str, real, wanted: tuple, path):
        def write(output_dir, step, *args, **kwargs):
            if step in wanted and (kind, step) not in written:
                written.add((kind, step))
                return real(output_dir, step, *args, **kwargs)
            return path(output_dir, step)
        return write

    return mock.patch.multiple(
        ckpt_lib,
        save_train_state=writer(
            'state', ckpt_lib.save_train_state, state_steps,
            lambda out, step: os.path.join(out, 'checkpoints',
                                           f'step_{step}')),
        save_hf_slice=writer(
            'slice', ckpt_lib.save_hf_slice, slice_steps,
            lambda out, step: os.path.join(out, f'slice_{step}')))


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
            'peak_gb': peak / 1e9, 'ckpt': ckpt}


def leaves_by_path(tree, prefix: str = '') -> dict:
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in leaves_by_path(v, f'{prefix}/{k}').items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree)
                for p, t in leaves_by_path(v, f'{prefix}/{i}').items()}
    return {prefix: tree.detach()}


def linked_checkpoint(base: str, path: str, edit=None) -> str:
    """A checkpoint directory ``path`` whose ``model.safetensors`` is a hard
    link of ``base``'s (``os.link`` writes no data: the card's machine
    counts disk writes) beside ``base``'s ``config.json``, changed by
    ``edit(hf_config)`` (a shallower depth: the loaders read the layers a
    config names and leave the rest of the file unread)."""
    os.makedirs(path, exist_ok=True)
    os.link(os.path.join(base, 'model.safetensors'),
            os.path.join(path, 'model.safetensors'))
    with open(os.path.join(base, 'config.json')) as f:
        hf = json.load(f)
    if edit is not None:
        edit(hf)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(hf, f, indent=2)
    return path


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

    # 4 uninterrupted steps, saving at steps 2 and 4 and at the end: only
    # the step-2 train state (the resume's) and the step-4 slice (the
    # export check's) are written, once each; the other 3.1 GB at these
    # widths (the step-4 train state twice, slices 2 and 4 again) would be
    # read by nothing
    with unread_saves_skipped(state_steps=(2,), slice_steps=(4,)):
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
    with unread_saves_skipped():      # its final slice: read by nothing
        resumed, resumed_steps, _ = run_trainer(
            DPOTrainer, 'text_to_text/dpo',
            argv(pref, 'PKUSafeRLHF', 'resumed', '--save_checkpoint',
                 'False', '--load_checkpoint', 'True'))
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


def rm_full(dev, smi, tmp: str, config=None, base: str | None = None
            ) -> dict:
    """Phase 11: the reward model at Llama-3-8B widths, 2 layers, through
    ``trainer_main(RMTrainer, ...)``, then ``rm_score`` over its export.
    ``base``: phase 9's checkpoint (4 layers at these widths), whose first
    2 layers are read through a hard link instead of a new 3 GB file."""
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
    if base is not None:
        linked_checkpoint(base, ckpt, lambda hf: hf.update(
            num_hidden_layers=cfg.num_layers))
    else:
        save_params(ckpt, transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED + 70),
            device=dev), cfg, dtype=torch.bfloat16)
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
    # neither run exports: the actor's fp32 slice at these widths is 6 GB
    # of disk writes that no later phase reads (phase 13 checks PPO's
    # export at bench.py's widths)
    for backend, rounds, extra, out in (
            ('batch', 2, (), None),
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
    # no output dir: each run's fp32 actor slice (0.39 GB) would be read by
    # nothing
    for name, cls, env, extra in cases:
        with mock.patch.dict(os.environ, env):
            trainer, steps, _ = run_trainer(cls, 'text_to_text/ppo', ppo_argv(
                ckpt, cost, data, None, *common, *extra))
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
    Qwen2.5-0.5B's full size: actor and reward checkpoints written from
    seeds (bf16), the cost model the reward model's backbone through a hard
    link, the reward and cost heads fresh fp32 heads from seeds beside
    them, so each critic starts as its model; 16 prompts in the 128
    bucket, 8 a round, 128 new tokens, micro-batch 4, 2 rounds."""
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
        if name == 'cost':
            # the reward model's backbone through a hard link, under its
            # own head: 1 GB less of disk writes
            linked_checkpoint(ckpts['reward'], ckpts[name])
        else:
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
    return png_images(tmp, ((size, size),) * n, seed)


def png_images(tmp: str, sizes: tuple, seed: int) -> list:
    """Random RGB PNG files of the given (h, w), drawn from ``seed``."""
    from PIL import Image  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        path = os.path.join(tmp, f'image_{seed}_{i}.png')
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3),
                                     dtype=np.uint8)).save(path)
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
    """``run_trainer`` for a TI2T trainer, timing the LLaVA, Qwen-VL and
    Mllama checkpoints' loads (summed where the trainer loads several)."""
    from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: PLC0415
        sft as ti2t_sft)

    timing = {'load_s': 0.0}

    def timed(load):
        def timed_load(*args, **kwargs):
            t0 = time.perf_counter()
            out = load(*args, **kwargs)
            torch.cuda.synchronize()
            timing['load_s'] += time.perf_counter() - t0
            return out
        return timed_load

    loaders = {k: (timed(load), module)
               for k, (load, module) in ti2t_sft.VISION_LM_LOADERS.items()}
    with mock.patch.object(ti2t_sft, 'load_multimodal_params',
                           timed(ti2t_sft.load_multimodal_params)), \
            mock.patch.dict(ti2t_sft.VISION_LM_LOADERS, loaders):
        trainer, steps, _ = run_trainer(trainer_cls, task, argv, mesh_file)
    return trainer, steps, timing


def recording_loss(cls, name: str, first: dict, keys: tuple):
    """A patch of ``cls.name`` (a loss taking (self, ..., batch)) that keeps
    step 1's batch entries ``keys`` and, for DPO, its response log-prob
    sums."""
    original = getattr(cls, name)

    def recording(self, *args):
        batch = args[-1]
        if not first:
            first['batch'] = {k: batch[k].clone() for k in keys if k in batch}
            if name == 'preference_loss':
                m = batch['response_mask']
                first['sums'] = masked_sums(args[0], m)
                first['ref_sums'] = masked_sums(args[1], m)
        return original(self, *args)

    return mock.patch.object(cls, name, recording)


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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_flash_counts()
    t0 = time.perf_counter()
    with recording_loss(TI2TDPOTrainer, 'preference_loss', first, (
            'input_ids', 'attention_mask', 'response_mask', 'pixel_values')):
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
            'peak_gb': peak / 1e9, 'ckpt': ckpt}


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


def ti2t_rm_full(dev, smi, tmp: str, base: str | None = None) -> dict:
    """Phase 19: the TI2T reward model through ``trainer_main(
    TI2TRMTrainer, ...)`` at LLaVA-1.5-7B widths (text 2 layers, the
    24-layer tower frozen by rm.yaml) from a bf16 checkpoint written from a
    seed (``base``: phase 18's checkpoint, text 4 layers, read through a
    hard link at 2); 8 AA_TI2T preference rows with PNG images, 2 pairs a
    step in the 1024 bucket, 4 steps, exported for phase 20."""
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_multimodal_params)
    from align_anything_tpu_torch.trainers.text_image_to_text.rm import (  # noqa: PLC0415
        TI2TRMTrainer, multimodal_end_scores)

    t_phase = time.perf_counter()
    free_memory()
    cfg = llava_config(RL_LAYERS)
    ckpt = os.path.join(tmp, 'llava7b_rl')
    if base is not None:
        linked_checkpoint(base, ckpt, lambda hf: hf['text_config'].update(
            num_hidden_layers=cfg.text.num_layers))
        w = {'bytes': 0}
    else:
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
        f'written {disk / 1e9:.3f} GB (checkpoint'
        f'{" linked" if base is not None else ""}, export, images), '
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


# phases 31-33: LLaVA-Next AnyRes and LLaVA-NeXT-Video.  Phases 31-32 run
# the published widths of llava-hf/llava-v1.6-vicuna-7b-hf and
# llava-hf/LLaVA-NeXT-Video-7B-hf: phase 18's LLaVA-1.5-7B geometry (the
# text cut to 4 layers, the 24-layer tower frozen) plus ``image_newline``,
# the AnyRes pinpoints and, for video, the token ids and the pool stride
# (transformers' LlavaNextConfig / LlavaNextVideoConfig defaults, checked
# at run time).  No 7B-width checkpoint is written again: each phase's
# directory hard-links phase 18's ``model.safetensors`` (``os.link`` writes
# nothing) beside its own ``config.json`` and a small safetensors file with
# ``image_newline``; the loader reads every ``.safetensors`` file of a
# directory without an index.  Phase 33 runs the rest at phase 10's text
# widths (1 layer) under the CLIP ViT-L/14-336 tower cut to 2 layers, so
# that its checkpoint and two exports stay within the disk budget (the run
# writes 47 GB of the card machine's 48.3).
ANYRES_PINPOINTS = ((336, 672), (672, 336), (672, 672), (1008, 336),
                    (336, 1008))
# (h, w) of phase 31's images: 672 x 672 takes all five crops and 2928
# image tokens; 336 x 1008 and 1008 x 336 take four crops, 2328 and 2376
ANYRES_SIZES = ((672, 672), (336, 1008), (672, 672), (1008, 336))
ANYRES_PAIRS, ANYRES_STEPS, ANYRES_BUCKET = 2, 4, 4096
# LLaVA-NeXT-Video-7B: video token 32000, image token 32001; phase 18's pad
# (32001) would merge pads as image slots, so the text takes another
VIDEO_TOKEN, VIDEO_IMAGE_TOKEN, VIDEO_PAD, VIDEO_STRIDE = (32000, 32001,
                                                           32002, 2)
TV2T_SFT_FRAMES, TV2T_DPO_FRAMES, TV2T_FRAMES_STORED = 8, 4, 12
TV2T_ROWS, TV2T_BATCH, TV2T_SFT_BUCKET = 4, 2, 2048
LNEXT_SMALL_TEXT_LAYERS, LNEXT_SMALL_TOWER_LAYERS = 1, 2
LNEXT_SMALL_FRAMES, LNEXT_SMALL_BUCKET, LNEXT_SMALL_NEW = 2, 2048, 16


def llava_next_hf_config(base: dict, video: bool) -> dict:
    """Phase 18's ``config.json`` (``base``, model_type 'llava') as a
    LLaVA-Next one: the pinpoints, and for video the token ids, the pool
    stride and a pad that is neither token."""
    hf = json.loads(json.dumps(base))
    hf['image_grid_pinpoints'] = [list(p) for p in ANYRES_PINPOINTS]
    if video:
        hf.update(architectures=['LlavaNextVideoForConditionalGeneration'],
                  model_type='llava_next_video',
                  image_token_index=VIDEO_IMAGE_TOKEN,
                  video_token_index=VIDEO_TOKEN, spatial_pool_mode='average',
                  spatial_pool_stride=VIDEO_STRIDE)
        hf['text_config']['pad_token_id'] = VIDEO_PAD
    else:
        hf.update(architectures=['LlavaNextForConditionalGeneration'],
                  model_type='llava_next')
    return hf


def link_llava_next(base: str, path: str, video: bool,
                    newline: str | None = None, seed: int = 0) -> str:
    """A LLaVA-Next (or -Video) checkpoint directory over ``base``'s
    tensors: ``model.safetensors`` hard-linked, the config of
    ``llava_next_hf_config``, and ``image_newline`` (bf16, drawn from
    ``seed``, or hard-linked from ``newline``'s file)."""
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        write_safetensors)

    os.makedirs(path)
    os.link(os.path.join(base, 'model.safetensors'),
            os.path.join(path, 'model.safetensors'))
    with open(os.path.join(base, 'config.json')) as f:
        hf = llava_next_hf_config(json.load(f), video)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(hf, f, indent=2)
    target = os.path.join(path, 'image_newline.safetensors')
    if newline is not None:
        os.link(newline, target)
    else:
        e = hf['text_config']['hidden_size']
        t = torch.randn((e,), generator=torch.Generator().manual_seed(seed))
        write_safetensors(target, {'image_newline': t / math.sqrt(e)},
                          metadata={'format': 'pt'}, dtype=torch.bfloat16)
    return target


def check_published_geometry(cfg, video: bool) -> str:
    """``cfg`` (the loaded config) against transformers' LlavaNextConfig /
    LlavaNextVideoConfig defaults, the published 7B geometry: the
    pinpoints, token ids, stride, feature layer and the tower's and text's
    widths (the vocab is the published 32064, not the Llama default)."""
    import transformers  # noqa: PLC0415

    hf = (transformers.LlavaNextVideoConfig() if video
          else transformers.LlavaNextConfig())
    vc, tc = hf.vision_config, hf.text_config
    want = {
        'pinpoints': tuple(tuple(p) for p in hf.image_grid_pinpoints),
        'image_token': hf.image_token_index,
        'video_token': getattr(hf, 'video_token_index', None),
        'stride': getattr(hf, 'spatial_pool_stride', None),
        'feature_layer': hf.vision_feature_layer,
        'tower': (vc.image_size, vc.patch_size, vc.hidden_size,
                  vc.num_hidden_layers, vc.num_attention_heads,
                  vc.intermediate_size),
        'text': (tc.hidden_size, tc.num_attention_heads,
                 tc.intermediate_size),
    }
    v, t = cfg.vision, cfg.text
    got = {
        'pinpoints': cfg.image_grid_pinpoints,
        'image_token': cfg.image_token_id,
        'video_token': cfg.video_token_id,
        'stride': cfg.spatial_pool_stride,
        'feature_layer': v.feature_layer,
        'tower': (v.image_size, v.patch_size, v.hidden_size, v.num_layers,
                  v.num_heads, v.mlp_dim),
        'text': (t.hidden_size, t.num_heads, t.mlp_dim),
    }
    if got != want:
        raise AssertionError(f'geometry {got} is not transformers\' '
                             f'{type(hf).__name__}() {want}')
    return (f'the geometry equals transformers {transformers.__version__} '
            f'{type(hf).__name__}()\'s defaults {want}')


def tv2t_videos(tmp: str, n: int, frames: int, size: int, seed: int) -> list:
    """``n`` random videos of ``frames`` RGB frames, ``.npy`` files."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        path = os.path.join(tmp, f'video_{seed}_{i}.npy')
        np.save(path, rng.integers(0, 256, size=(frames, size, size, 3),
                                   dtype=np.uint8))
        paths.append(path)
    return paths


def tv2t_rows(videos: list, seed: int, words_range: tuple = (100, 151),
              response_range: tuple = (50, 251)) -> list:
    """AA_TV2T rows of random words over ``videos`` with the supervised,
    preference and prompt-only fields."""
    rng = np.random.default_rng(seed)
    return [{'question': words(rng, int(rng.integers(*words_range))),
             'response': words(rng, int(rng.integers(*response_range))),
             'response_1': words(rng, int(rng.integers(*response_range))),
             'response_2': words(rng, int(rng.integers(*response_range))),
             'overall_response': int(rng.integers(1, 3)), 'video': video}
            for video in videos]


def anyres_token_counts(batch: dict, image_token: int) -> tuple:
    """(image tokens per row, ``num_tokens`` per row from ``select_idx``:
    its nonzero entries and the base crop's index 0)."""
    n_image = (batch['input_ids'] == image_token).sum(-1).tolist()
    n_sel = ((batch['select_idx'] != 0).sum(-1) + 1).tolist()
    return n_image, n_sel


def step_report(tag: str, steps: list, shape: tuple, loss_key: str) -> tuple:
    """Log each step and return (median step time of steps 2+, tokens/s)."""
    seconds = [m['perf/step_time_s'] for m in steps]
    for i, m in enumerate(steps):
        log(f'{tag} step {i + 1}: {loss_key}={m[loss_key]!r} grad_norm='
            f'{m.get("train/grad_norm", math.nan):.6e} '
            f'seconds={seconds[i]:.4f}')
    step_s = statistics.median(seconds[1:] or seconds)
    return step_s, shape[0] * shape[1] / step_s


def anyres_full(dev, smi, tmp: str, base: str) -> dict:
    """Phase 31: TI2T DPO through ``trainer_main(TI2TDPOTrainer, ...)`` on
    LLaVA-Next AnyRes at llava-v1.6-vicuna-7b widths (text 4 layers, the
    24-layer tower frozen), phase 18's tensors hard-linked: 8 AA_TI2T
    preference rows over 672 x 672, 336 x 1008 and 1008 x 336 PNGs, 2
    pairs a step in the 4096 bucket, 4 steps."""
    from align_anything_tpu_torch.data.image import AnyResProcessor  # noqa: PLC0415
    from align_anything_tpu_torch.models import multimodal  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_multimodal_params)
    from align_anything_tpu_torch.trainers.text_image_to_text.dpo import (  # noqa: PLC0415
        TI2TDPOTrainer)

    t_phase = time.perf_counter()
    free_memory()
    written0 = disk_written()
    ckpt = os.path.join(tmp, 'llava_next7b')
    newline = link_llava_next(base, ckpt, video=False, seed=SEED + 130)
    images = png_images(tmp, ANYRES_SIZES * 2, SEED + 131)
    data = write_jsonl(os.path.join(tmp, 'pref_anyres.jsonl'),
                       ti2t_rows(images, SEED + 132, preference=True))
    argv = ['--model_name_or_path', ckpt, '--train_datasets', data,
            '--train_template', 'AA_TI2T', '--save_checkpoint', 'False',
            '--epochs', '1', '--per_device_train_batch_size',
            str(ANYRES_PAIRS), '--padding_buckets', f'[{ANYRES_BUCKET}]']
    first: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_flash_counts()
    t0 = time.perf_counter()
    with recording_loss(TI2TDPOTrainer, 'preference_loss', first, (
            'input_ids', 'attention_mask', 'response_mask', 'pixel_values',
            'select_idx')):
        trainer, steps, timing = run_ti2t(
            TI2TDPOTrainer, 'text_image_to_text/dpo', argv, HARNESS_MESH)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    mcfg = trainer.model_cfg
    geometry = check_published_geometry(mcfg, video=False)
    start, _ = load_multimodal_params(ckpt, device=dev)
    moved = changed_modules(trainer.state.params,
                            {m: leaves_by_path(start[m]) for m in start})
    del trainer, start
    free_memory()
    b = first['batch']
    shape = tuple(b['input_ids'].shape)
    n_image, n_sel = anyres_token_counts(b, mcfg.image_token_id)
    most = AnyResProcessor(mcfg.vision, ANYRES_PINPOINTS).max_tokens
    losses = [m['train/loss'] for m in steps]
    step_s, tps = step_report('phase31', steps, shape, 'train/loss')
    tower, layers = mcfg.vision.layers_run, mcfg.text.num_layers
    # as phase 18: the frozen tower forward over every row's five crops
    # (one launch a layer) for the policy and the reference, the language
    # model's forward for both and its recompute, and its backward
    need = {'fwd': ANYRES_STEPS * (2 * tower + 3 * layers),
            'bwd': ANYRES_STEPS * layers}
    log(f'phase31 {geometry}')
    log(f'phase31 TI2T DPO on LLaVA-Next AnyRes: batch {shape} with '
        f'pixel_values {tuple(b["pixel_values"].shape)} and select_idx '
        f'{tuple(b["select_idx"].shape)}; image tokens per row {n_image} '
        f'(num_tokens {n_sel}); remat {mcfg.text.remat}, compute '
        f'{mcfg.text.compute_dtype}; trainer_main {total_s:.2f} s (load '
        f'{timing["load_s"]:.2f} s, {len(steps)} steps); step time '
        f'{step_s:.4f} s (median of steps 2-{len(steps)}), {tps:.1f} '
        f'tokens/s; peak memory {peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB '
        f'resident before); modules moved {moved}; flash launches fwd '
        f'{launches["fwd"]} (need {need["fwd"]}) bwd {launches["bwd"]} (need '
        f'{need["bwd"]}); card {smi}')
    if len(steps) != ANYRES_STEPS or shape != (2 * ANYRES_PAIRS,
                                                ANYRES_BUCKET):
        raise AssertionError(f'AnyRes DPO: {len(steps)} steps at {shape}')
    if tuple(b['pixel_values'].shape[1:3]) != (5, 3):
        raise AssertionError('AnyRes DPO: not five crops a row')
    if n_image != n_sel or max(n_image) != most:
        raise AssertionError(f'AnyRes DPO: image tokens per row {n_image}, '
                             f'num_tokens {n_sel} (ROADMAP R12), or no row '
                             f'of {most}')
    if abs(losses[0] - math.log(2)) > 1e-6:
        raise AssertionError(f'AnyRes DPO step 1 loss {losses[0]!r} != ln 2')
    if not all_finite(steps):
        raise AssertionError('AnyRes DPO: a non-finite metric')
    if moved != {'language_model': True, 'vision_tower': False,
                 'projector': True, 'image_newline': True}:
        raise AssertionError(f'AnyRes DPO: modules moved {moved}; the frozen '
                             'tower must stay bit-equal, the rest train')
    check_launches('AnyRes DPO', launches, need, exact=True)

    params, _ = load_multimodal_params(ckpt, device=dev)
    sums = {}
    with torch.no_grad(), plain_flash():
        for dtype in ('bfloat16', 'float32'):
            sums[dtype] = masked_sums(multimodal.token_logprobs(
                params, mcfg.replace(compute_dtype=dtype), b['input_ids'],
                attention_mask=b['attention_mask'],
                pixel_values=b['pixel_values'], select_idx=b['select_idx']),
                b['response_mask'])
    del params
    free_memory()
    log('phase31 step 1 recomputed with the plain attention, response '
        'log-prob sums: ' + check_sums('policy', first['sums'],
                                       sums['bfloat16'], sums['float32'])
        + '; ' + check_sums('reference', first['ref_sums'], sums['bfloat16'],
                            sums['float32']))
    log(f'phase31 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written() - written0:.4f} GB written by the phase')
    return {'launches': launches, 'step_s': step_s, 'tokens_per_s': tps,
            'peak_gb': peak / 1e9, 'newline': newline}


def video_token_counts(ids: torch.Tensor) -> dict:
    return {'video': (ids == VIDEO_TOKEN).sum(-1).tolist(),
            'image': (ids == VIDEO_IMAGE_TOKEN).sum(-1).tolist()}


def tv2t_full(dev, smi, tmp: str, base: str, newline: str) -> dict:
    """Phase 32: TV2T SFT and DPO through their entry points on
    LLaVA-NeXT-Video at LLaVA-NeXT-Video-7B widths (text 4 layers, the
    tower frozen), phase 18's tensors and phase 31's newline hard-linked:
    4 AA_TV2T rows over ``.npy`` videos; SFT 8 frames a row (8 x 144
    pooled tokens of the video token) in the 2048 bucket; DPO as JAX's
    (R26: 4 frames x 576 tokens of the image token, the frames dropped) in
    the 4096 bucket; 2 rows (pairs) a step, 2 steps each."""
    from align_anything_tpu_torch.models import multimodal  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_multimodal_params)
    from align_anything_tpu_torch.trainers.text_video_to_text.dpo import (  # noqa: PLC0415
        TV2TDPOTrainer)
    from align_anything_tpu_torch.trainers.text_video_to_text.sft import (  # noqa: PLC0415
        TV2TSupervisedTrainer)
    from align_anything_tpu_torch.losses import cross_entropy_loss  # noqa: PLC0415

    t_phase = time.perf_counter()
    free_memory()
    written0 = disk_written()
    ckpt = os.path.join(tmp, 'llava_next_video7b')
    link_llava_next(base, ckpt, video=True, newline=newline)
    videos = tv2t_videos(tmp, TV2T_ROWS, TV2T_FRAMES_STORED, 336, SEED + 140)
    data = write_jsonl(os.path.join(tmp, 'tv2t.jsonl'),
                       tv2t_rows(videos, SEED + 141))
    common = ['--model_name_or_path', ckpt, '--train_datasets', data,
              '--train_template', 'AA_TV2T', '--save_checkpoint', 'False',
              '--epochs', '1', '--per_device_train_batch_size',
              str(TV2T_BATCH)]
    n_steps = TV2T_ROWS // TV2T_BATCH
    out = {'fwd': 0, 'bwd': 0}
    report = {}
    for algo, cls, loss_name, frames, bucket, mesh in (
            ('sft', TV2TSupervisedTrainer, 'loss_fn', TV2T_SFT_FRAMES,
             TV2T_SFT_BUCKET, None),
            ('dpo', TV2TDPOTrainer, 'preference_loss', TV2T_DPO_FRAMES,
             ANYRES_BUCKET, HARNESS_MESH)):
        argv = [*common, '--n_frames', str(frames), '--padding_buckets',
                f'[{bucket}]']
        first: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        t0 = time.perf_counter()
        with recording_loss(cls, loss_name, first, (
                'input_ids', 'attention_mask', 'labels', 'response_mask',
                'pixel_values')):
            trainer, steps, timing = run_ti2t(
                cls, f'text_video_to_text/{algo}', argv, mesh)
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
        counts = video_token_counts(b['input_ids'])
        step_s, tps = step_report(f'phase32 {algo}', steps, shape,
                                  'train/loss')
        tower, layers = mcfg.vision.layers_run, mcfg.text.num_layers
        pooled = (mcfg.vision.image_size // mcfg.vision.patch_size
                  // VIDEO_STRIDE) ** 2
        if algo == 'sft':
            # the frozen tower's forward over every frame, the language
            # model's forward (remat 'save_flash' keeps the kernel's
            # output) and backward
            need = {'fwd': n_steps * (tower + layers),
                    'bwd': n_steps * layers}
            want = {'video': [frames * pooled] * shape[0],
                    'image': [0] * shape[0]}
            want_moved = {'language_model': True, 'vision_tower': False,
                          'projector': True, 'image_newline': False}
        else:
            # as phase 18 (the tower runs, its features merge nowhere)
            need = {'fwd': n_steps * (2 * tower + 3 * layers),
                    'bwd': n_steps * layers}
            want = {'video': [0] * shape[0],
                    'image': [frames * mcfg.vision.num_patches] * shape[0]}
            # R26: no video token in the rows, so the projector gets no
            # gradient (and dpo.yaml's weight decay is 0)
            want_moved = {'language_model': True, 'vision_tower': False,
                          'projector': False, 'image_newline': False}
        if algo == 'sft':
            check_published_geometry(mcfg, video=True)
        log(f'phase32 TV2T {algo.upper()} on LLaVA-NeXT-Video: batch {shape} '
            f'with pixel_values {tuple(b["pixel_values"].shape)}; per row, '
            f'tokens of id {VIDEO_TOKEN} (video) {counts["video"]} and of '
            f'id {VIDEO_IMAGE_TOKEN} (image) {counts["image"]}; pad '
            f'{mcfg.pad_token_id}; remat {mcfg.text.remat}; trainer_main '
            f'{total_s:.2f} s (load {timing["load_s"]:.2f} s, {len(steps)} '
            f'steps); step time {step_s:.4f} s, {tps:.1f} tokens/s; peak '
            f'memory {peak / 1e9:.3f} GB; modules moved {moved}; flash '
            f'launches fwd {launches["fwd"]} (need {need["fwd"]}) bwd '
            f'{launches["bwd"]} (need {need["bwd"]}); card {smi}')
        if len(steps) != n_steps or shape != (
                TV2T_BATCH * (2 if algo == 'dpo' else 1), bucket):
            raise AssertionError(f'TV2T {algo}: {len(steps)} steps at '
                                 f'{shape}')
        if tuple(b['pixel_values'].shape[1:3]) != (frames, 3):
            raise AssertionError(f'TV2T {algo}: not {frames} frames a row')
        if counts != want:
            raise AssertionError(f'TV2T {algo}: token counts {counts}, want '
                                 f'{want} (ROADMAP R12, R26)')
        if not all_finite(steps):
            raise AssertionError(f'TV2T {algo}: a non-finite metric')
        if algo == 'dpo' and abs(steps[0]['train/loss'] - math.log(2)) > 1e-6:
            raise AssertionError(f'TV2T DPO step 1 loss '
                                 f'{steps[0]["train/loss"]!r} != ln 2')
        if moved != want_moved:
            raise AssertionError(f'TV2T {algo}: modules moved {moved}, '
                                 f'expected {want_moved}')
        check_launches(f'TV2T {algo}', launches, need, exact=True)

        params, _ = load_multimodal_params(ckpt, device=dev)
        plain = {}
        with torch.no_grad(), plain_flash():
            for dtype in ('bfloat16', 'float32'):
                c = mcfg.replace(compute_dtype=dtype)
                if algo == 'sft':
                    logits = multimodal.forward(
                        params, c, b['input_ids'],
                        attention_mask=b['attention_mask'],
                        pixel_values=b['pixel_values']).logits
                    plain[dtype] = cross_entropy_loss(
                        logits, b['labels'])['loss'].double().reshape(1)
                else:
                    plain[dtype] = masked_sums(multimodal.token_logprobs(
                        params, c, b['input_ids'],
                        attention_mask=b['attention_mask'],
                        pixel_values=b['pixel_values']), b['response_mask'])
        del params
        free_memory()
        if algo == 'sft':
            msg = check_sums('loss', torch.tensor(
                [steps[0]['train/loss']], dtype=torch.float64,
                device=plain['float32'].device), plain['bfloat16'],
                plain['float32'])
        else:
            msg = (check_sums('policy', first['sums'], plain['bfloat16'],
                              plain['float32']) + '; '
                   + check_sums('reference', first['ref_sums'],
                                plain['bfloat16'], plain['float32']))
        log(f'phase32 {algo} step 1 recomputed with the plain attention: '
            f'{msg}')
        for k in out:
            out[k] += launches[k]
        report[algo] = {'step_s': step_s, 'tokens_per_s': tps,
                        'peak_gb': peak / 1e9}
    log(f'phase32 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written() - written0:.4f} GB written by the phase')
    return {'launches': out, **report}


def llava_next_small(dev, smi, tmp: str) -> dict:
    """Phase 33 at phase 10's text widths (1 layer) under the CLIP
    ViT-L/14-336 tower cut to 2 layers, LLaVA-Next and -Video configs over
    one bf16 checkpoint written from a seed: AnyRes TI2T SFT and its
    export (bf16, LLaVA-Next tensor names) read back; the TV2T reward model
    with its export (the LLaVA-NeXT-Video slice and ``score_head.npy``)
    read back; TV2T PPO from that export (the rollout's prefill takes 5-D
    pixels through ``generate``); TV2T GRPO.  Every metric finite, every
    launch count exact."""
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_multimodal_params, read_safetensors, save_multimodal_params)
    from align_anything_tpu_torch.trainers.text_image_to_text.sft import (  # noqa: PLC0415
        TI2TSupervisedTrainer)
    from align_anything_tpu_torch.trainers.text_video_to_text import (  # noqa: PLC0415
        grpo as tv2t_grpo, ppo as tv2t_ppo, rm as tv2t_rm)
    from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: PLC0415
        ppo as ti2t_ppo)

    t_phase = time.perf_counter()
    free_memory()
    written0 = disk_written()
    cfg = llava_config(LNEXT_SMALL_TEXT_LAYERS, LNEXT_SMALL_TOWER_LAYERS)
    cfg = cfg.replace(vocab_size=SMALL['vocab_size'],
                      hidden_size=SMALL['hidden'], num_heads=SMALL['heads'],
                      num_kv_heads=SMALL['kv_heads'],
                      head_dim=SMALL['hidden'] // SMALL['heads'],
                      mlp_dim=SMALL['mlp'], max_position_embeddings=8192)
    base = os.path.join(tmp, 'llava_small_base')
    w = write_llava(cfg, base, SEED + 150, dev)
    anyres = os.path.join(tmp, 'llava_next_small')
    newline = link_llava_next(base, anyres, video=False, seed=SEED + 151)
    video = os.path.join(tmp, 'llava_next_video_small')
    link_llava_next(base, video, video=True, newline=newline)
    tower, layers = cfg.vision.layers_run, cfg.text.num_layers
    model = tower + layers
    total = {'fwd': 0, 'bwd': 0}

    def run(tag, cls, task, argv, need, env=None):
        torch.cuda.synchronize()
        reset_flash_counts()
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, env or {}):
            trainer, steps, _ = run_ti2t(cls, task, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = flash_counts()
        steps = [m for m in steps if 'train/loss' in m
                 or 'train/actor_loss' in m]
        key = 'train/actor_loss' if 'train/actor_loss' in steps[0] \
            else 'train/loss'
        log(f'phase33 {tag}: {len(steps)} steps, {key} '
            f'{[m[key] for m in steps]}; trainer_main {seconds:.2f} s; flash '
            f'launches fwd {launches["fwd"]} (need {need["fwd"]}) bwd '
            f'{launches["bwd"]} (need {need["bwd"]}); card {smi}')
        if not steps or not all_finite(steps):
            raise AssertionError(f'{tag}: no step, or a non-finite metric')
        check_launches(tag, launches, need, exact=True)
        for k in total:
            total[k] += launches[k]
        return trainer, steps

    def reads_back(tag, path, params, model_type, dtype):
        """The export's config and HF tensor names, and the port's loader
        reading it back equal to ``params`` rounded to ``dtype``."""
        with open(os.path.join(path, 'config.json')) as f:
            hf = json.load(f)
        names = set()
        for fname in os.listdir(path):
            if fname.endswith('.safetensors'):
                names |= set(read_safetensors(os.path.join(path, fname)))
        need_names = {'image_newline',
                      'language_model.model.embed_tokens.weight',
                      'language_model.lm_head.weight',
                      'multi_modal_projector.linear_1.weight',
                      'vision_tower.vision_model.encoder.layers.0.'
                      'self_attn.q_proj.weight'}
        back, bcfg = load_multimodal_params(path, device=dev)
        want = {m: {k: v.to(dtype).float() for k, v in
                    leaves_by_path({m: params[m]}).items()}
                for m in back}
        same = all(torch.equal(v.float(), want[m][k])
                   for m in back
                   for k, v in leaves_by_path({m: back[m]}).items())
        log(f'phase33 {tag} export: model_type {hf["model_type"]}, '
            f'{len(names)} tensors, {dir_bytes(path) / 1e9:.4f} GB; read '
            f'back equal: {same}')
        if not (hf['model_type'] == model_type and need_names <= names
                and same and set(back) == set(params) - {'score_head'}):
            raise AssertionError(f'{tag}: the export does not read back')
        return bcfg

    # AnyRes TI2T SFT (tower frozen by sft.yaml), then its export in bf16
    images = png_images(tmp, ((672, 672), (500, 700), (336, 1008),
                                 (900, 400)), SEED + 152)
    sft_data = write_jsonl(os.path.join(tmp, 'sft_anyres_small.jsonl'),
                           ti2t_rows(images, SEED + 153, preference=False))
    first: dict = {}
    with recording_loss(TI2TSupervisedTrainer, 'loss_fn', first,
                        ('input_ids', 'select_idx', 'pixel_values')):
        trainer, _ = run(
            'AnyRes TI2T SFT', TI2TSupervisedTrainer,
            'text_image_to_text/sft',
            ['--model_name_or_path', anyres, '--train_datasets', sft_data,
             '--train_template', 'AA_TI2T', '--save_checkpoint', 'False',
             '--epochs', '1', '--per_device_train_batch_size', '2',
             '--padding_buckets', f'[{ANYRES_BUCKET}]'],
            {'fwd': 2 * model, 'bwd': 2 * layers})
    n_image, n_sel = anyres_token_counts(first['batch'], cfg.image_token_id)
    log(f'phase33 AnyRes SFT: crops {tuple(first["batch"]["pixel_values"].shape)}'
        f'; image tokens per row {n_image}, num_tokens {n_sel}')
    if n_image != n_sel:
        raise AssertionError(f'AnyRes SFT: image tokens {n_image} != '
                             f'num_tokens {n_sel} (ROADMAP R12)')
    out_anyres = os.path.join(tmp, 'export_llava_next_small')
    save_multimodal_params(out_anyres, trainer.state.params, trainer.model_cfg,
                           dtype=torch.bfloat16)
    acfg = reads_back('AnyRes', out_anyres, trainer.state.params,
                      'llava_next', torch.bfloat16)
    if acfg.image_grid_pinpoints != ANYRES_PINPOINTS:
        raise AssertionError('AnyRes export lost its pinpoints')
    del trainer
    free_memory()

    # the TV2T reward model with its export, then PPO and GRPO from it
    videos = tv2t_videos(tmp, 4, 6, 336, SEED + 154)
    rows = tv2t_rows(videos, SEED + 155, (20, 61), (10, 41))
    data = write_jsonl(os.path.join(tmp, 'tv2t_small.jsonl'), rows)
    frames = ['--n_frames', str(LNEXT_SMALL_FRAMES)]
    rm_out = os.path.join(tmp, 'out_tv2t_rm')
    common = ['--train_template', 'AA_TV2T', '--save_checkpoint', 'False',
              '--epochs', '1', '--padding_buckets',
              f'[{LNEXT_SMALL_BUCKET}]', '--train_datasets', data]
    trainer, _ = run(
        'TV2T RM', tv2t_rm.TV2TRMTrainer, 'text_video_to_text/rm',
        ['--model_name_or_path', video, '--output_dir', rm_out,
         '--per_device_train_batch_size', '2', *frames, *common],
        {'fwd': 2 * model, 'bwd': 2 * layers})
    slice_dir = os.path.join(rm_out, 'slice_2')
    trained = trainer.state.params
    vcfg = reads_back('TV2T RM', slice_dir, trained, 'llava_next_video',
                      torch.float32)
    head = np.load(os.path.join(slice_dir, 'score_head.npy'))
    if not (np.array_equal(head, trained['score_head']['w'].detach().cpu()
                           .numpy())
            and (vcfg.video_token_id, vcfg.spatial_pool_stride) == (
                VIDEO_TOKEN, VIDEO_STRIDE)):
        raise AssertionError('TV2T RM export: the head or the video fields '
                             'differ')
    del trainer, trained
    free_memory()

    rl = ['--actor_model_name_or_path', video,
          '--reward_model_name_or_path', slice_dir, '--max_new_tokens',
          str(LNEXT_SMALL_NEW), *common]
    prefill_pixels = []
    generate = ti2t_ppo.generate

    def recording_generate(*args, **kwargs):
        prefill_pixels.append(tuple(kwargs['pixel_values'].shape))
        return generate(*args, **kwargs)

    with mock.patch.object(ti2t_ppo, 'generate', recording_generate):
        # a round of 4 prompts: the prefill's tower, four scoring passes,
        # actor and critic forward and backward per micro-batch (R13)
        _, steps = run(
            'TV2T PPO', tv2t_ppo.TV2TPPOTrainer, 'text_video_to_text/ppo',
            [*rl, '--per_device_prompt_batch_size', '4',
             '--per_device_train_batch_size', '2', '--update_iters', '1',
             *frames],
            {'fwd': tower + 4 * model + 2 * 2 * model,
             'bwd': 2 * 2 * model})
        if steps[0]['train/kl_divergence'] != 0.0:
            raise AssertionError('TV2T PPO round 1 KL is not 0')
        # GRPO reads text_image_to_text/grpo, which has no n_frames key:
        # the environment adds it (a command-line override adds no key)
        _, steps = run(
            'TV2T GRPO', tv2t_grpo.TV2TGRPOTrainer, 'text_image_to_text/grpo',
            [*rl, '--train_size', '2', '--per_device_prompt_batch_size', '2',
             '--num_generations', '2'],
            {'fwd': tower + 3 * model, 'bwd': model},
            env={'ENV_PREFIX__TRAIN_CFGS__N_FRAMES':
                 str(LNEXT_SMALL_FRAMES)})
        if not abs(steps[0]['train/kl']) <= 1e-6:
            raise AssertionError('TV2T GRPO step 1 KL is not 0')
    log(f'phase33 the rollouts\' prefill pixel_values {prefill_pixels}')
    if not prefill_pixels or any(len(s) != 5 or s[1] != LNEXT_SMALL_FRAMES
                                 for s in prefill_pixels):
        raise AssertionError('TV2T rollouts: the prefill took no 5-D frames')
    log(f'phase33 done in {time.perf_counter() - t_phase:.1f} s (base '
        f'checkpoint {w["bytes"] / 1e9:.4f} GB); '
        f'{disk_written() - written0:.4f} GB written by the phase, '
        f'{disk_written():.3f} GB by the run so far')
    return {'launches': total}


# phases 34-35: Qwen2-VL and Qwen2.5-VL through the TI2T entry points.
# Phase 34 runs Qwen/Qwen2-VL-2B-Instruct's published config.json: the
# text trunk (vocab 151936, hidden 1536, 12 / 2 heads of 128, MLP 8960,
# tied embeddings, QKV bias, rope theta 1e6, m-rope sections 16 / 24 / 24)
# cut to 4 of its 28 layers, the tower at its full 32 blocks (1280 wide, 16
# heads of 80, MLP ratio 4, patches of 14 merged 2 x 2, 2 frames).  The
# TI2T YAMLs' freeze_vision_tower names 'vision_tower', which the Qwen2-VL
# tree does not hold (its tower is 'visual'), so the tower and merger train
# (ROADMAP §3 R27), as in JAX.  Dynamic resolution is a key of dpo.yaml, so
# the command line switches it on; smart_resize's default 256 x 28^2 pixels
# give at most 1024 patches, 256 image tokens an image.
QWEN2_VL_2B = dict(vocab_size=151936, hidden_size=1536, num_heads=12,
                   num_kv_heads=2, head_dim=128, mlp_dim=8960,
                   max_position_embeddings=32768, rope_theta=1000000.0,
                   norm_eps=1e-6, qkv_bias=True, tie_word_embeddings=True,
                   mrope_section=(16, 24, 24), bos_token_id=151643,
                   eos_token_id=151645, pad_token_id=151643)
QWEN2_VL_2B_VISION = dict(depth=32, embed_dim=1280, num_heads=16,
                          patch_size=14, spatial_merge_size=2,
                          temporal_patch_size=2, mlp_ratio=4.0)
QWEN2_VL_IMAGE_TOKEN = 151655
QWEN2_VL_TEXT_LAYERS, QWEN2_VL_PAIRS, QWEN2_VL_STEPS = 4, 2, 2
QWEN2_VL_BUCKET = 1024
# four grids (smart_resize at its default max of 200704 pixels): 32 x 32,
# 22 x 44, 44 x 22 and 28 x 36 patches, 256, 242, 242 and 252 image tokens:
# every batch of two rows holds two grids
QWEN2_VL_SIZES = ((448, 448), (336, 672), (672, 336), (392, 504))
# phase 35: phase 10's text widths (2 layers; head dim 64, sections
# 8 / 12 / 12) under towers at their published widths, 2 blocks (Qwen2-VL)
# and 4 (Qwen2.5-VL: windows of 112 px, full attention at block 3)
QWEN_SMALL_IMAGE_TOKEN = 32000
QWEN_SMALL_ROWS, QWEN_SMALL_BATCH, QWEN_SMALL_BUCKET = 4, 2, 1024
QWEN_SMALL_SIZES = ((224, 224), (168, 336), (336, 168), (280, 224))
QWEN_GEN_PROMPTS, QWEN_GEN_NEW = 2, 16


def qwen2_vl_config(text_layers: int = QWEN2_VL_TEXT_LAYERS):
    """Qwen2-VL-2B-Instruct's published widths, the text cut to
    ``text_layers``."""
    from align_anything_tpu_torch.models.config import ModelConfig  # noqa: PLC0415
    from align_anything_tpu_torch.models.qwen2_vl import (  # noqa: PLC0415
        Qwen2VLConfig, Qwen2VLVisionConfig)

    return Qwen2VLConfig(
        text=ModelConfig(num_layers=text_layers, **QWEN2_VL_2B),
        vision=Qwen2VLVisionConfig(**QWEN2_VL_2B_VISION),
        image_token_id=QWEN2_VL_IMAGE_TOKEN)


def qwen_small_configs() -> tuple:
    """(Qwen2-VL, Qwen2.5-VL) configs of phase 35."""
    from align_anything_tpu_torch.models.config import ModelConfig  # noqa: PLC0415
    from align_anything_tpu_torch.models.qwen2_5_vl import (  # noqa: PLC0415
        Qwen25VLConfig, Qwen25VLVisionConfig)
    from align_anything_tpu_torch.models.qwen2_vl import (  # noqa: PLC0415
        Qwen2VLConfig, Qwen2VLVisionConfig)

    s = SMALL
    text = ModelConfig(
        vocab_size=s['vocab_size'], hidden_size=s['hidden'],
        num_layers=s['layers'], num_heads=s['heads'],
        num_kv_heads=s['kv_heads'], head_dim=s['hidden'] // s['heads'],
        mlp_dim=s['mlp'], max_position_embeddings=s['max_pos'],
        rope_theta=1000000.0, norm_eps=1e-6, qkv_bias=True,
        tie_word_embeddings=True, mrope_section=(8, 12, 12),
        bos_token_id=1, eos_token_id=2, pad_token_id=0)
    q2 = Qwen2VLConfig(text=text, vision=Qwen2VLVisionConfig(
        **{**QWEN2_VL_2B_VISION, 'depth': 2}),
        image_token_id=QWEN_SMALL_IMAGE_TOKEN)
    q25 = Qwen25VLConfig(text=text, vision=Qwen25VLVisionConfig(
        depth=4, embed_dim=1280, num_heads=16, intermediate_size=3420,
        window_size=112, fullatt_block_indexes=(3,)),
        image_token_id=QWEN_SMALL_IMAGE_TOKEN)
    return q2, q25


def write_qwen_vl(cfg, path: str, seed: int, dev) -> dict:
    """A Qwen2-VL or Qwen2.5-VL checkpoint of ``cfg`` with random weights
    from ``seed``, written in bf16 by the port's exporter: params per
    module, seconds and bytes."""
    from align_anything_tpu_torch.models import qwen2_5_vl, qwen2_vl  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        save_qwen2_5_vl_params, save_qwen2_vl_params)

    family = hasattr(cfg.vision, 'window_size')
    module = qwen2_5_vl if family else qwen2_vl
    save = save_qwen2_5_vl_params if family else save_qwen2_vl_params
    params = module.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    n_params = {m: sum(t.numel() for t in param_leaves(params[m]))
                for m in params}
    t0 = time.perf_counter()
    save(path, params, cfg, dtype=torch.bfloat16)
    write_s = time.perf_counter() - t0
    del params
    free_memory()
    return {'n_params': n_params, 'write_s': write_s,
            'bytes': os.path.getsize(os.path.join(path, 'model.safetensors'))}


def mrope_streams_host(ids: np.ndarray, image_token: int,
                       grids: np.ndarray, merge: int) -> np.ndarray:
    """HF ``get_rope_index`` for rows with one image span, row by row in
    plain Python: (3, B, L) int64.  Text counts up on all three streams;
    the span's tokens sit at the span's start plus (0, row, column) of the
    merged grid; the text after it continues from the start plus the
    grid's larger side."""
    out = np.zeros((3,) + ids.shape, np.int64)
    for r, row in enumerate(ids.tolist()):
        gh, gw = int(grids[r, 1]) // merge, int(grids[r, 2]) // merge
        start = row.index(image_token) if image_token in row else len(row)
        nxt = 0
        for i in range(len(row)):
            if i < start:
                out[:, r, i] = i
                nxt = i + 1
            elif i < start + gh * gw:
                k = i - start
                out[:, r, i] = (start, start + k // gw, start + k % gw)
                nxt = start + max(gh, gw)
            else:
                out[:, r, i] = nxt
                nxt += 1
    return out


def qwen2_vl_dpo_assets(cfg, dev, tmp: str) -> tuple:
    """Phase 34's checkpoint (seeded), its ``Qwen2-VL`` preference rows
    over PNG files and the command line: (checkpoint dir, what was
    written, argv)."""
    ckpt = os.path.join(tmp, 'qwen2_vl_2b')
    w = write_qwen_vl(cfg, ckpt, SEED + 340, dev)
    images = png_images(tmp, QWEN2_VL_SIZES, SEED + 341)
    data = write_jsonl(os.path.join(tmp, 'pref_qwen2_vl.jsonl'),
                       ti2t_rows(images, SEED + 342, preference=True))
    argv = ['--model_name_or_path', ckpt, '--train_datasets', data,
            '--train_template', 'Qwen2-VL', '--save_checkpoint', 'False',
            '--epochs', '1', '--per_device_train_batch_size',
            str(QWEN2_VL_PAIRS), '--padding_buckets', f'[{QWEN2_VL_BUCKET}]',
            '--dynamic_resolution', 'True']
    return ckpt, w, argv


def qwen2_vl_dpo_full(dev, smi, tmp: str) -> dict:
    """Phase 34: TI2T DPO through ``trainer_main(TI2TDPOTrainer, ...)``
    (``python -m ...text_image_to_text.dpo``) at Qwen2-VL-2B widths, from a
    bf16 Qwen2-VL checkpoint written by the port's exporter, at dynamic
    resolution."""
    from align_anything_tpu_torch.models import qwen2_vl  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_qwen2_vl_params)
    from align_anything_tpu_torch.trainers.text_image_to_text.dpo import (  # noqa: PLC0415
        TI2TDPOTrainer)

    t_phase, written0 = time.perf_counter(), disk_written()
    free_memory()
    cfg = qwen2_vl_config()
    ckpt, w, argv = qwen2_vl_dpo_assets(cfg, dev, tmp)
    n = w['n_params']
    log(f'phase34 wrote the checkpoint (Qwen2-VL-2B widths, text '
        f'{cfg.text.num_layers} layers, tower {cfg.vision.depth} blocks; '
        f'params language_model {n["language_model"] / 1e9:.3f} B, visual '
        f'{n["visual"] / 1e9:.3f} B; bf16 safetensors in Qwen2-VL layout): '
        f'{w["bytes"] / 1e9:.3f} GB in {w["write_s"]:.2f} s; '
        f'{len(QWEN2_VL_SIZES)} preference rows over PNG files of '
        f'{QWEN2_VL_SIZES}; argv {" ".join(argv[2:])}; '
        f'MESH_FILE={HARNESS_MESH}')
    first: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_flash_counts()
    t0 = time.perf_counter()
    with recording_loss(TI2TDPOTrainer, 'preference_loss', first, (
            'input_ids', 'attention_mask', 'response_mask', 'pixel_values',
            'image_grid_thw')):
        trainer, steps, timing = run_ti2t(
            TI2TDPOTrainer, 'text_image_to_text/dpo', argv, HARNESS_MESH)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    mcfg = trainer.model_cfg
    start, _ = load_qwen2_vl_params(ckpt, device=dev)
    moved = changed_modules(trainer.state.params,
                            {m: leaves_by_path(start[m]) for m in start})
    del trainer, start
    free_memory()
    b = first['batch']
    shape = tuple(b['input_ids'].shape)
    ids = b['input_ids'].cpu().numpy()
    grids = b['image_grid_thw'].cpu().numpy()
    m = cfg.vision.spatial_merge_size
    n_image = (ids == cfg.image_token_id).sum(-1).tolist()
    want_image = [int(g[1] * g[2]) // (m * m) for g in grids]
    # the m-rope streams the forward used, against the host's
    streams = qwen2_vl.default_positions(mcfg, b['input_ids'],
                                         b['image_grid_thw']).cpu().numpy()
    host = mrope_streams_host(ids, cfg.image_token_id, grids, m)
    span = ids == cfg.image_token_id
    hw_differ = [bool((streams[1, r][span[r]] != streams[2, r][span[r]])
                      .any()) for r in range(shape[0])]
    losses = [s['train/loss'] for s in steps]
    step_s, tps = step_report('phase34', steps, shape, 'train/loss')
    layers = mcfg.text.num_layers
    need = {'fwd': QWEN2_VL_STEPS * 3 * layers,
            'bwd': QWEN2_VL_STEPS * layers}
    # FLOPs of a step: the text's by bench.py's convention over the padded
    # rows, the tower's 8 x its params a patch (policy forward and
    # backward, reference forward: it trains, R27) and its attention, 16 x
    # N^2 x width a block and row, over the padded patch rows
    n_text = n['language_model']
    n_pad = b['pixel_values'].shape[1]
    tower_flops = shape[0] * (8 * n['visual'] * n_pad + 16 * n_pad ** 2
                              * cfg.vision.embed_dim * cfg.vision.depth)
    step_flops = (shape[0] * shape[1] * dpo_flops_per_token(
        n_text, shape[1], cfg.text.hidden_size, layers) + tower_flops)
    mfu = step_flops / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f'phase34 Qwen2-VL TI2T DPO: batch {shape} with pixel_values '
        f'{tuple(b["pixel_values"].shape)}, image_grid_thw '
        f'{grids.tolist()}; image tokens per row {n_image} (the grids give '
        f'{want_image}); m-rope streams equal to the host\'s: '
        f'{bool(np.array_equal(streams, host))}, h and w streams differ in '
        f'each image span: {hw_differ}; remat {mcfg.text.remat}, compute '
        f'{mcfg.text.compute_dtype}; trainer_main {total_s:.2f} s (load '
        f'{timing["load_s"]:.2f} s, {len(steps)} steps); step time '
        f'{step_s:.4f} s (step 2), {tps:.1f} tokens/s, MFU {mfu:.4f} '
        f'({step_flops / 1e12:.2f} TFLOP a step, the tower '
        f'{tower_flops / 1e12:.2f}, against 989 TFLOP/s); peak memory '
        f'{peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB resident before); '
        f'modules moved {moved}; flash launches fwd {launches["fwd"]} (need '
        f'{need["fwd"]}) bwd {launches["bwd"]} (need {need["bwd"]}); card '
        f'{smi}')
    if len(steps) != QWEN2_VL_STEPS or shape != (2 * QWEN2_VL_PAIRS,
                                                 QWEN2_VL_BUCKET):
        raise AssertionError(f'Qwen2-VL DPO: {len(steps)} steps at {shape}')
    if abs(losses[0] - math.log(2)) > 1e-6:
        raise AssertionError(f'Qwen2-VL DPO step 1 loss {losses[0]!r} != '
                             'ln 2')
    if not all_finite(steps):
        raise AssertionError('Qwen2-VL DPO: a non-finite metric')
    if n_image != want_image or len({tuple(g) for g in grids[:QWEN2_VL_PAIRS]
                                     .tolist()}) != 2:
        raise AssertionError('Qwen2-VL DPO: image tokens off their grids, '
                             'or a batch of one grid')
    if not (np.array_equal(streams, host) and all(hw_differ)):
        raise AssertionError('Qwen2-VL DPO: the m-rope streams disagree '
                             'with the host\'s')
    if moved != {'language_model': True, 'visual': True}:
        raise AssertionError(f'Qwen2-VL DPO: modules moved {moved}; under '
                             'R27 the tower trains')
    check_launches('Qwen2-VL DPO', launches, need, exact=True)

    # step 1 recomputed from the checkpoint with the plain attention, in
    # bf16 compute and in fp32
    params, _ = load_qwen2_vl_params(ckpt, device=dev)
    sums = {}
    with torch.no_grad(), plain_flash():
        for dtype in ('bfloat16', 'float32'):
            sums[dtype] = masked_sums(qwen2_vl.token_logprobs(
                params, mcfg.replace(compute_dtype=dtype), b['input_ids'],
                attention_mask=b['attention_mask'],
                pixel_values=b['pixel_values'],
                image_grid_thw=b['image_grid_thw']), b['response_mask'])
    del params
    free_memory()
    log('phase34 step 1 recomputed with the plain attention, response '
        'log-prob sums: ' + check_sums('policy', first['sums'],
                                       sums['bfloat16'], sums['float32'])
        + '; ' + check_sums('reference', first['ref_sums'], sums['bfloat16'],
                            sums['float32']))
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f'phase34 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written() - written0:.3f} GB written by the phase, '
        f'{disk_written():.3f} GB by the run so far')
    return {'launches': launches, 'step_s': step_s, 'tokens_per_s': tps,
            'mfu': mfu, 'peak_gb': peak / 1e9}


def qwen_vl_generation(cfg, ckpt: str, images: list, dev) -> dict:
    """Greedy ``generate`` of ``QWEN_GEN_NEW`` tokens from image prompts at
    the fixed grid, with m-rope prefill positions and the decode offset as
    JAX's eval pipeline computes them, in fp32 compute: each generated id
    is the argmax of a no-cache forward over the grown sequence."""
    from align_anything_tpu_torch.generation import generate  # noqa: PLC0415
    from align_anything_tpu_torch.models import qwen2_vl  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_qwen2_vl_params)

    params, loaded = load_qwen2_vl_params(ckpt, device=dev)
    gcfg = loaded.replace(compute_dtype='float32')
    proc = qwen2_vl.PatchProcessor(gcfg.vision)
    px = torch.as_tensor(np.stack([proc(p) for p in images]), device=dev)
    rng = np.random.default_rng(SEED + 355)
    n_img = gcfg.vision.num_patches
    prompts = [[1] + list(rng.integers(3, 30000, 5)) + [
        gcfg.image_token_id] * n_img + list(rng.integers(3, 30000, 9))
        for _ in images]
    ids = torch.as_tensor(prompts, device=dev)
    mask = torch.ones_like(ids)
    pos3 = qwen2_vl.mrope_positions(ids, gcfg.image_token_id,
                                    gcfg.vision.grid_side // 2,
                                    gcfg.vision.grid_side // 2)
    offset = pos3.amax(dim=(0, 2)) + 1 - mask.sum(-1)
    gen = GenerationConfig(max_new_tokens=QWEN_GEN_NEW, greedy=True,
                           eos_token_id=-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, gcfg, gen, ids, mask, pixel_values=px,
                   prefill_forward=qwen2_vl.forward,
                   step_forward=qwen2_vl.decode_forward,
                   prefill_positions=pos3, position_offset=offset)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    seqs, p = out['sequences'], ids.shape[1]
    agree = 0
    with torch.no_grad():
        for t in range(QWEN_GEN_NEW):
            logits = qwen2_vl.forward(params, gcfg, seqs[:, :p + t],
                                      pixel_values=px).logits[:, -1]
            agree += int((logits.argmax(-1) == seqs[:, p + t]).sum())
    del params
    return {'gen_s': gen_s, 'agree': agree,
            'total': QWEN_GEN_NEW * len(images),
            'offset': offset.tolist(), 'ids': seqs[:, p:].tolist()}


def qwen_vl_small(dev, smi, tmp: str) -> dict:
    """Phase 35: at phase 10's text widths, TI2T SFT on Qwen2-VL at the
    fixed 224 px grid and at dynamic resolution, Qwen2.5-VL SFT and DPO at
    dynamic resolution (window and full blocks), then greedy m-rope
    generation from Qwen2-VL image prompts."""
    from align_anything_tpu_torch.trainers.text_image_to_text.dpo import (  # noqa: PLC0415
        TI2TDPOTrainer)
    from align_anything_tpu_torch.trainers.text_image_to_text.sft import (  # noqa: PLC0415
        TI2TSupervisedTrainer)

    t_phase, written0 = time.perf_counter(), disk_written()
    free_memory()
    q2, q25 = qwen_small_configs()
    ckpts = {}
    for name, cfg, seed in (('qwen2_vl', q2, SEED + 350),
                            ('qwen2_5_vl', q25, SEED + 351)):
        ckpts[name] = os.path.join(tmp, f'{name}_small')
        write_qwen_vl(cfg, ckpts[name], seed, dev)
    images = png_images(tmp, QWEN_SMALL_SIZES, SEED + 352)
    sft_data = write_jsonl(os.path.join(tmp, 'sft_qwen.jsonl'),
                           ti2t_rows(images, SEED + 353, preference=False))
    pref_data = write_jsonl(os.path.join(tmp, 'pref_qwen.jsonl'),
                            ti2t_rows(images, SEED + 354, preference=True))
    n_steps = QWEN_SMALL_ROWS // QWEN_SMALL_BATCH
    layers = q2.text.num_layers
    dynamic = ('--dynamic_resolution', 'True')
    total = {'fwd': 0, 'bwd': 0}
    # the default remat ('save_flash') keeps the kernel's output: SFT runs
    # one forward a layer and step, DPO two (policy and reference)
    runs = (('Qwen2-VL SFT, 224 px', 'qwen2_vl', TI2TSupervisedTrainer,
             'text_image_to_text/sft', sft_data, (), 1),
            ('Qwen2-VL SFT, dynamic', 'qwen2_vl', TI2TSupervisedTrainer,
             'text_image_to_text/sft', sft_data, dynamic, 1),
            ('Qwen2.5-VL SFT, dynamic', 'qwen2_5_vl', TI2TSupervisedTrainer,
             'text_image_to_text/sft', sft_data, dynamic, 1),
            ('Qwen2.5-VL DPO, dynamic', 'qwen2_5_vl', TI2TDPOTrainer,
             'text_image_to_text/dpo', pref_data, dynamic, 2))
    for tag, family, cls, task, data, flags, fwd_per_layer in runs:
        argv = ['--model_name_or_path', ckpts[family], '--train_datasets',
                data, '--train_template', 'Qwen2-VL', '--save_checkpoint',
                'False', '--epochs', '1', '--per_device_train_batch_size',
                str(QWEN_SMALL_BATCH), '--padding_buckets',
                f'[{QWEN_SMALL_BUCKET}]', '--learning_rate', '1e-4', *flags]
        first: dict = {}
        name = 'preference_loss' if cls is TI2TDPOTrainer else 'loss_fn'
        keys = ('input_ids', 'image_grid_thw', 'pixel_values')
        torch.cuda.synchronize()
        reset_flash_counts()
        with recording_loss(cls, name, first, keys):
            trainer, steps, _ = run_ti2t(cls, task, argv)
        torch.cuda.synchronize()
        launches = flash_counts()
        mm = trainer.mm.__name__.rsplit('.', 1)[-1]
        del trainer
        free_memory()
        need = {'fwd': n_steps * fwd_per_layer * layers,
                'bwd': n_steps * layers}
        b = first['batch']
        grids = (b['image_grid_thw'].tolist() if 'image_grid_thw' in b
                 else None)
        losses = [m['train/loss'] for m in steps]
        log(f'phase35 {tag}: model {mm}; batch {tuple(b["input_ids"].shape)}'
            f', pixel_values {tuple(b["pixel_values"].shape)}, grids '
            f'{grids}; losses {losses}; flash launches fwd {launches["fwd"]} '
            f'(need {need["fwd"]}) bwd {launches["bwd"]} (need '
            f'{need["bwd"]}); card {smi}')
        if mm != family or len(steps) != n_steps or not all_finite(steps):
            raise AssertionError(f'{tag}: {mm}, {len(steps)} steps, or a '
                                 'non-finite metric')
        if (grids is None) == bool(flags):
            raise AssertionError(f'{tag}: image_grid_thw {grids}')
        if cls is TI2TDPOTrainer and abs(losses[0] - math.log(2)) > 1e-6:
            raise AssertionError(f'{tag}: step 1 loss {losses[0]!r} != ln 2')
        check_launches(tag, launches, need, exact=True)
        for k in total:
            total[k] += launches[k]
    gen = qwen_vl_generation(q2, ckpts['qwen2_vl'],
                             png_images(tmp, ((224, 224), (300, 200)),
                                        SEED + 356), dev)
    log(f'phase35 Qwen2-VL generate (fp32 compute, 224 px, '
        f'{QWEN_GEN_NEW} new tokens from {QWEN_GEN_PROMPTS} image prompts, '
        f'decode offset {gen["offset"]}): {gen["gen_s"]:.3f} s; ids equal '
        f'to the argmax of the no-cache forward over the grown sequence '
        f'{gen["agree"]}/{gen["total"]}; ids {gen["ids"]}')
    if gen['agree'] != gen['total']:
        raise AssertionError('Qwen2-VL generate: ids off the no-cache '
                             'argmax')
    for path in ckpts.values():
        shutil.rmtree(path, ignore_errors=True)
    log(f'phase35 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written() - written0:.3f} GB written by the phase')
    return {'launches': total}


# phase 36: Qwen2-Audio-7B-Instruct's published config.json
# (Qwen/Qwen2-Audio-7B-Instruct: its text_config's vocab 156032,
# intermediate 11008, rope_theta 10000 and rms_norm_eps 1e-5 over Qwen2's
# defaults, hidden 4096, 32 layers, 32 / 32 heads, untied; bos / eos / pad
# Qwen2's 151643 / 151645 / 151643; its audio_config's d_model 1280, 32
# layers, 20 heads, ffn 5120, 128 mel bins, 1500 source positions;
# audio_token_index 151646).  transformers' Qwen2AudioConfig() defaults are
# not these (text intermediate 22016, vocab 151936).  The text is cut to 4
# of its 32 layers for fp32 AdamW; the 32-layer tower is whole and frozen
# (the YAML's freeze_audio_tower).  4 pairs over 30 s clips, 2 a step in
# the 1024 bucket: 750 audio tokens a row
QWEN2_AUDIO_7B = dict(vocab_size=156032, hidden_size=4096, num_heads=32,
                      num_kv_heads=32, head_dim=128, mlp_dim=11008,
                      max_position_embeddings=8192, rope_theta=10000.0,
                      norm_eps=1e-5, qkv_bias=True,
                      tie_word_embeddings=False, bos_token_id=151643,
                      eos_token_id=151645, pad_token_id=151643)
QWEN2_AUDIO_7B_TOWER = dict(n_mels=128, hidden_size=1280, num_layers=32,
                            num_heads=20, mlp_dim=5120, max_frames=3000)
QWEN2_AUDIO_TOKEN = 151646
QWEN2_AUDIO_TEXT_LAYERS = 4
TA2T_ROWS, TA2T_PAIRS, TA2T_BUCKET = 4, 2, 1024
TA2T_STEPS = TA2T_ROWS // TA2T_PAIRS
CLIP_RATE, CLIP_SAMPLES = 16000, 480000      # 30 s: waveform_len's default
# the card's log-mel (cuFFT) against the CPU's (pocketfft), fp32: each sits
# within 6e-5 of a float64 recompute on tests/test_torch_audio.py's clips
MEL_CARD_TOL = 2e-4
# phase 37: phase 10's text widths, 1 layer, as a Qwen2 trunk (qkv bias),
# under the published tower widths cut to 2 layers; clips of 2-30 s, each
# padded to 30 s (750 audio tokens a row), the 1024 bucket
TA2T_SMALL_TOWER_LAYERS, TA2T_SMALL_TOKEN = 2, 32000
TA2T_SMALL_NEW = 16
FRESH_TOWER = ('--n_mels', '128', '--audio_hidden_size', '256',
               '--audio_layers', '2', '--audio_heads', '4',
               '--audio_mlp_dim', '1024', '--audio_max_frames', '3000',
               '--audio_token_id', str(TA2T_SMALL_TOKEN))


def qwen2_audio_config(text_layers: int = QWEN2_AUDIO_TEXT_LAYERS):
    """Qwen2-Audio-7B-Instruct's published widths, the text cut to
    ``text_layers``."""
    from align_anything_tpu_torch.models.audio import (  # noqa: PLC0415
        AudioEncoderConfig, AudioLMConfig)
    from align_anything_tpu_torch.models.config import ModelConfig  # noqa: PLC0415

    return AudioLMConfig(
        text=ModelConfig(num_layers=text_layers, **QWEN2_AUDIO_7B),
        audio=AudioEncoderConfig(**QWEN2_AUDIO_7B_TOWER),
        audio_token_id=QWEN2_AUDIO_TOKEN)


def qwen2_audio_small_config():
    """Phase 37's model: phase 10's text widths (1 layer, Qwen2) under the
    published tower cut to ``TA2T_SMALL_TOWER_LAYERS``."""
    from align_anything_tpu_torch.models.audio import (  # noqa: PLC0415
        AudioEncoderConfig, AudioLMConfig)
    from align_anything_tpu_torch.models.config import ModelConfig  # noqa: PLC0415

    s = SMALL
    return AudioLMConfig(
        text=ModelConfig(
            vocab_size=s['vocab_size'], hidden_size=s['hidden'], num_layers=1,
            num_heads=s['heads'], num_kv_heads=s['kv_heads'],
            head_dim=s['hidden'] // s['heads'], mlp_dim=s['mlp'],
            max_position_embeddings=s['max_pos'], rope_theta=10000.0,
            norm_eps=1e-5, qkv_bias=True, tie_word_embeddings=False,
            bos_token_id=1, eos_token_id=2, pad_token_id=0),
        audio=AudioEncoderConfig(**{**QWEN2_AUDIO_7B_TOWER,
                                    'num_layers': TA2T_SMALL_TOWER_LAYERS}),
        audio_token_id=TA2T_SMALL_TOKEN)


def write_audio_lm(cfg, path: str, seed: int, dev) -> dict:
    """A Qwen2-Audio checkpoint of ``cfg`` with random weights from
    ``seed``, written in bf16 by the port's exporter: params per module,
    seconds and bytes."""
    from align_anything_tpu_torch.models import audio  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        save_audio_params)

    params = audio.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    n_params = {m: sum(t.numel() for t in param_leaves(params[m]))
                for m in params}
    t0 = time.perf_counter()
    save_audio_params(path, params, cfg, dtype=torch.bfloat16)
    write_s = time.perf_counter() - t0
    del params
    free_memory()
    return {'n_params': n_params, 'write_s': write_s,
            'bytes': os.path.getsize(os.path.join(path, 'model.safetensors'))}


def write_wav(path: str, samples: np.ndarray) -> str:
    """16-bit mono PCM at 16 kHz through the standard library."""
    import wave  # noqa: PLC0415

    pcm = np.clip(samples * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(path, 'wb') as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(CLIP_RATE)
        f.writeframes(pcm.tobytes())
    return path


def audio_clips(tmp: str, seconds: list, seed: int) -> list:
    """16-bit wav files of ``seconds`` each, made from ``seed``: two tones
    of 100-4000 Hz whose loudness swells, under noise."""
    rng = np.random.default_rng(seed)
    paths = []
    for i, sec in enumerate(seconds):
        t = np.arange(int(sec * CLIP_RATE)) / CLIP_RATE
        clip = sum(rng.uniform(0.1, 0.3) * np.sin(
            2 * np.pi * rng.uniform(100, 4000) * t + rng.uniform(0, 6.3))
            for _ in range(2)) * (0.6 + 0.4 * np.sin(
                2 * np.pi * rng.uniform(0.1, 1.0) * t))
        clip = clip + 0.02 * rng.standard_normal(len(t))
        paths.append(write_wav(os.path.join(tmp, f'clip_{seed}_{i}.wav'),
                               clip.astype(np.float32)))
    return paths


def ta2t_rows(clips: list, seed: int, words_range: tuple) -> list:
    """AA_TA2T rows, one a clip: a question, a response, and a preference
    pair of responses, each of ``words_range`` words."""
    rng = np.random.default_rng(seed)

    def text():
        return words(rng, int(rng.integers(*words_range)))

    return [{'question': text(), 'response': text(), 'response_1': text(),
             'response_2': text(), 'overall_response': int(rng.integers(1, 3)),
             'audio': clip} for clip in clips]


def run_ta2t(trainer_cls, task: str, argv: list,
             mesh_file: str | None = None) -> tuple:
    """``run_trainer`` for a TA2T trainer, timing its Qwen2-Audio
    checkpoint's load."""
    from align_anything_tpu_torch.trainers.text_audio_to_text import (  # noqa: PLC0415
        sft as ta2t_sft)

    timing = {'load_s': 0.0}
    load = ta2t_sft.load_audio_params

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        out = load(*args, **kwargs)
        torch.cuda.synchronize()
        timing['load_s'] += time.perf_counter() - t0
        return out

    with mock.patch.object(ta2t_sft, 'load_audio_params', timed_load):
        trainer, steps, _ = run_trainer(trainer_cls, task, argv, mesh_file)
    return trainer, steps, timing


def audio_token_spans(ids: np.ndarray, token: int) -> tuple:
    """(audio tokens a row, the longest run of them a row: the <audio>
    span; the difference is the hash tokenizer's words that fell on the
    audio token, ROADMAP R12)."""
    counts, spans = [], []
    for row in ids.tolist():
        run = best = 0
        for t in row:
            run = run + 1 if t == token else 0
            best = max(best, run)
        counts.append(row.count(token))
        spans.append(best)
    return counts, spans


def ta2t_dpo_assets(cfg, dev, tmp: str) -> tuple:
    """Phase 36's checkpoint (seeded), its AA_TA2T preference rows over
    30 s wav clips and the command line: (checkpoint dir, what was
    written, argv)."""
    ckpt = os.path.join(tmp, 'qwen2_audio_7b')
    w = write_audio_lm(cfg, ckpt, SEED + 360, dev)
    clips = audio_clips(tmp, [CLIP_SAMPLES / CLIP_RATE] * TA2T_ROWS,
                        SEED + 361)
    # 40-90 words a question and response: 750 audio tokens and at most
    # 190 words of text with the chat format, inside the 1024 bucket
    data = write_jsonl(os.path.join(tmp, 'pref_ta2t.jsonl'),
                       ta2t_rows(clips, SEED + 362, (40, 91)))
    argv = ['--model_name_or_path', ckpt, '--train_datasets', data,
            '--train_template', 'AA_TA2T', '--save_checkpoint', 'False',
            '--epochs', '1', '--per_device_train_batch_size',
            str(TA2T_PAIRS), '--padding_buckets', f'[{TA2T_BUCKET}]']
    return ckpt, w, argv


def ta2t_dpo_full(dev, smi, tmp: str) -> dict:
    """Phase 36: TA2T DPO through ``trainer_main(TA2TDPOTrainer, ...)``
    (``python -m ...text_audio_to_text.dpo``) at Qwen2-Audio-7B widths,
    from a bf16 Qwen2-Audio checkpoint written by the port's exporter (the
    ``load_audio_params`` path), over 30 s clips."""
    from align_anything_tpu_torch.models import audio  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_audio_params)
    from align_anything_tpu_torch.ops.audio import log_mel_spectrogram  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_audio_to_text.dpo import (  # noqa: PLC0415
        TA2TDPOTrainer)

    t_phase, written0 = time.perf_counter(), disk_written()
    free_memory()
    cfg = qwen2_audio_config()
    ckpt, w, argv = ta2t_dpo_assets(cfg, dev, tmp)
    n = w['n_params']
    log(f'phase36 wrote the checkpoint (Qwen2-Audio-7B widths, text '
        f'{cfg.text.num_layers} of 32 layers, tower {cfg.audio.num_layers} '
        f'layers; params language_model {n["language_model"] / 1e9:.3f} B, '
        f'audio_tower {n["audio_tower"] / 1e9:.3f} B, projector '
        f'{n["projector"] / 1e9:.4f} B; bf16 safetensors in Qwen2-Audio '
        f'layout): {w["bytes"] / 1e9:.3f} GB in {w["write_s"]:.2f} s; '
        f'{TA2T_ROWS} AA_TA2T preference rows over 30 s 16-bit wav clips; '
        f'argv {" ".join(argv[2:])}')
    first: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_flash_counts()
    t0 = time.perf_counter()
    with recording_loss(TA2TDPOTrainer, 'preference_loss', first, (
            'input_ids', 'attention_mask', 'response_mask', 'audio_values')):
        trainer, steps, timing = run_ta2t(
            TA2TDPOTrainer, 'text_audio_to_text/dpo', argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    mcfg = trainer.model_cfg
    start, _ = load_audio_params(ckpt, device=dev)
    moved = changed_modules(trainer.state.params,
                            {m: leaves_by_path(start[m]) for m in start})
    del trainer, start
    free_memory()
    b = first['batch']
    shape = tuple(b['input_ids'].shape)
    counts, spans = audio_token_spans(b['input_ids'].cpu().numpy(),
                                      cfg.audio_token_id)
    per_clip = cfg.audio.num_audio_tokens
    losses = [s['train/loss'] for s in steps]
    step_s, tps = step_report('phase36', steps, shape, 'train/loss')
    t_layers, layers = cfg.audio.num_layers, cfg.text.num_layers
    # a step: the tower and the trunk forward for the policy and for the
    # reference; the trunk backward (the tower is frozen and its input
    # needs no gradient); no remat (the checkpoint's config)
    need = {'fwd': TA2T_STEPS * 2 * (t_layers + layers),
            'bwd': TA2T_STEPS * layers}
    # FLOPs of a step: the trained text's by bench.py's convention over
    # the padded rows (projector included); the frozen tower's forward
    # twice (policy and reference), 2 x its params a frame and 4 x
    # frames^2 x width a layer for the attention, over each row's 1500
    # frames
    n_text = n['language_model'] + n['projector']
    frames = cfg.audio.max_frames // 2
    tower_flops = 2 * shape[0] * (
        2 * n['audio_tower'] * frames
        + 4 * frames ** 2 * cfg.audio.hidden_size * t_layers)
    step_flops = (shape[0] * shape[1] * dpo_flops_per_token(
        n_text, shape[1], cfg.text.hidden_size, layers) + tower_flops)
    mfu = step_flops / step_s / PEAK_FLOPS[torch.bfloat16]
    waves = b['audio_values']
    mel = log_mel_spectrogram(waves, n_mels=cfg.audio.n_mels)
    mel_cpu = log_mel_spectrogram(waves.cpu(), n_mels=cfg.audio.n_mels)
    mel_err = float((mel.cpu() - mel_cpu).abs().max())
    log(f'phase36 Qwen2-Audio TA2T DPO: batch {shape} with audio_values '
        f'{tuple(waves.shape)} ({waves.shape[1] / CLIP_RATE:.0f} s a row); '
        f'audio tokens a row {counts}, the <audio> span {spans} (need '
        f'{per_clip} a clip; words that hash to the audio token: '
        f'{[c - s for c, s in zip(counts, spans)]}); remat '
        f'{mcfg.text.remat}, compute {mcfg.text.compute_dtype}; log-mel on '
        f'the card against the CPU\'s: max|diff| {mel_err:.3e} (tol '
        f'{MEL_CARD_TOL:g}) over {tuple(mel.shape)}; trainer_main '
        f'{total_s:.2f} s (load {timing["load_s"]:.2f} s, {len(steps)} '
        f'steps); step time {step_s:.4f} s (step 2), {tps:.1f} tokens/s, MFU '
        f'{mfu:.4f} ({step_flops / 1e12:.2f} TFLOP a step, the tower '
        f'{tower_flops / 1e12:.2f}, against 989 TFLOP/s); peak memory '
        f'{peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB resident before); '
        f'modules moved {moved}; flash launches fwd {launches["fwd"]} (need '
        f'{need["fwd"]}) bwd {launches["bwd"]} (need {need["bwd"]}); card '
        f'{smi}')
    if len(steps) != TA2T_STEPS or shape != (2 * TA2T_PAIRS, TA2T_BUCKET):
        raise AssertionError(f'TA2T DPO: {len(steps)} steps at {shape}')
    if abs(losses[0] - math.log(2)) > 1e-6:
        raise AssertionError(f'TA2T DPO step 1 loss {losses[0]!r} != ln 2')
    if not all_finite(steps):
        raise AssertionError('TA2T DPO: a non-finite metric')
    if spans != [per_clip] * shape[0]:
        raise AssertionError(f'TA2T DPO: <audio> spans {spans}, not '
                             f'{per_clip} a row')
    if not (torch.isfinite(mel).all() and mel_err <= MEL_CARD_TOL):
        raise AssertionError(f'TA2T DPO: the card\'s log-mel is {mel_err} '
                             'from the CPU\'s')
    if moved != {'language_model': True, 'audio_tower': False,
                 'projector': True}:
        raise AssertionError(f'TA2T DPO: modules moved {moved}; the tower '
                             'is frozen, the rest trains')
    check_launches('TA2T DPO', launches, need, exact=True)

    # step 1 recomputed from the checkpoint with the plain attention, in
    # bf16 compute and in fp32
    params, _ = load_audio_params(ckpt, device=dev)
    sums = {}
    with torch.no_grad(), plain_flash():
        for dtype in ('bfloat16', 'float32'):
            sums[dtype] = masked_sums(audio.token_logprobs(
                params, mcfg.replace(compute_dtype=dtype), b['input_ids'],
                attention_mask=b['attention_mask'],
                audio_values=b['audio_values']), b['response_mask'])
    del params
    free_memory()
    log('phase36 step 1 recomputed with the plain attention, response '
        'log-prob sums: ' + check_sums('policy', first['sums'],
                                       sums['bfloat16'], sums['float32'])
        + '; ' + check_sums('reference', first['ref_sums'], sums['bfloat16'],
                            sums['float32']))
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f'phase36 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written() - written0:.3f} GB written by the phase, '
        f'{disk_written():.3f} GB by the run so far')
    return {'launches': launches, 'step_s': step_s, 'tokens_per_s': tps,
            'mfu': mfu, 'peak_gb': peak / 1e9}


def ta2t_small(dev, smi, tmp: str) -> dict:
    """Phase 37: at phase 10's text widths (1 layer) under a 2-layer tower
    of the published widths, through the entry points' ``trainer_main``:
    TA2T SFT and its export read back, the RM, one PPO round and one GRPO
    round (the audio prefill in the rollout), then SFT on the fresh-encoder
    path over phase 10's text checkpoint."""
    from align_anything_tpu_torch.models import audio  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_audio_params)
    from align_anything_tpu_torch.trainers.text_audio_to_text import (  # noqa: PLC0415
        grpo as ta2t_grpo, ppo as ta2t_ppo, rm as ta2t_rm, sft as ta2t_sft)

    t_phase, written0 = time.perf_counter(), disk_written()
    free_memory()
    cfg = qwen2_audio_small_config()
    ckpt = os.path.join(tmp, 'qwen2_audio_small')
    write_audio_lm(cfg, ckpt, SEED + 370, dev)
    rng = np.random.default_rng(SEED + 371)
    clips = audio_clips(tmp, rng.uniform(2, 30, 8).round(2).tolist(),
                        SEED + 372)
    data = write_jsonl(os.path.join(tmp, 'ta2t_small.jsonl'),
                       ta2t_rows(clips, SEED + 373, (10, 61)))
    start = load_audio_params(ckpt, device=dev)[0]
    start = {m: leaves_by_path(start[m]) for m in start}
    t_layers, layers = cfg.audio.num_layers, cfg.text.num_layers
    per_clip = cfg.audio.num_audio_tokens
    common = ['--train_datasets', data, '--train_template', 'AA_TA2T',
              '--epochs', '1', '--save_checkpoint', 'False',
              '--padding_buckets', f'[{TA2T_BUCKET}]']
    rollout_calls: list = []
    generate = ta2t_ppo.generate

    def recording_generate(*args, **kwargs):
        rollout_calls.append((kwargs['prefill_forward'],
                              tuple(kwargs['media']['audio_values'].shape)))
        return generate(*args, **kwargs)

    out = os.path.join(tmp, 'ta2t_sft')
    # (tag, class, task, argv, steps or rounds, launches a step or round)
    runs = (
        ('SFT', ta2t_sft.TA2TSupervisedTrainer, 'text_audio_to_text/sft',
         ['--model_name_or_path', ckpt, *common, '--output_dir', out,
          '--train_size', '4', '--per_device_train_batch_size', '2'], 2,
         {'fwd': t_layers + layers, 'bwd': layers}),
        ('RM', ta2t_rm.TA2TRMTrainer, 'text_audio_to_text/rm',
         ['--model_name_or_path', ckpt, *common, '--train_size', '4',
          '--per_device_train_batch_size', '2'], 2,
         {'fwd': t_layers + layers, 'bwd': layers}),
        # a round: the tower in the prefill (the decode steps and the
        # prefill's trunk run the cache path), 4 scoring passes, and for
        # each of 2 micro-batches the actor and the critic forward and
        # backward; the towers train (R13)
        ('PPO', ta2t_ppo.TA2TPPOTrainer, 'text_audio_to_text/ppo',
         ['--model_name_or_path', ckpt, *common, '--train_size', '4',
          '--per_device_prompt_batch_size', '4',
          '--per_device_train_batch_size', '2',
          '--max_new_tokens', str(TA2T_SMALL_NEW)], 1,
         {'fwd': t_layers + 8 * (t_layers + layers),
          'bwd': 4 * (t_layers + layers)}),
        # 2 prompts x 4 generations (ppo.yaml has no num_generations): the
        # tower in the prefill, the reward pass, the actor's and the
        # reference's forward, the actor's backward
        ('GRPO', ta2t_grpo.TA2TGRPOTrainer, 'text_audio_to_text/ppo',
         ['--model_name_or_path', ckpt, *common, '--train_size', '2',
          '--per_device_prompt_batch_size', '2',
          '--max_new_tokens', str(TA2T_SMALL_NEW)], 1,
         {'fwd': t_layers + 3 * (t_layers + layers),
          'bwd': t_layers + layers}),
        # the fresh encoder (2 layers of 256, 4 heads of 64) over phase
        # 10's Llama trunk (2 layers; remat 'save_flash' keeps the kernel's
        # output), the tower frozen
        ('SFT, fresh encoder', ta2t_sft.TA2TSupervisedTrainer,
         'text_audio_to_text/sft',
         ['--model_name_or_path', os.path.join(tmp, 'small'), *common,
          '--train_size', '4', '--per_device_train_batch_size', '2',
          *FRESH_TOWER], 2, {'fwd': 2 + SMALL['layers'],
                             'bwd': SMALL['layers']}))
    total = {'fwd': 0, 'bwd': 0}
    for tag, cls, task, argv, n_steps, per in runs:
        torch.cuda.synchronize()
        reset_flash_counts()
        rollout_calls.clear()
        with mock.patch.object(ta2t_ppo, 'generate', recording_generate):
            trainer, steps, timing = run_ta2t(cls, task, argv)
        torch.cuda.synchronize()
        launches = flash_counts()
        steps = [m for m in steps if 'train/reward' in m or 'train/loss' in m
                 or 'train/actor_loss' in m]
        mcfg = trainer.model_cfg
        params = (trainer.actor_state if hasattr(trainer, 'actor_state')
                  else trainer.state).params
        need = {k: n_steps * v for k, v in per.items()}
        first = next(iter(trainer.train_iterator.epoch_batches(0)))
        counts, spans = audio_token_spans(first['input_ids'],
                                          mcfg.audio_token_id)
        info = ''
        if tag == 'SFT':
            back, _ = load_audio_params(os.path.join(out, f'slice_{n_steps}'),
                                        device=dev)
            got, back = leaves_by_path(params), leaves_by_path(back)
            exported = set(got) == set(back) and all(
                torch.equal(got[p], back[p]) for p in got)
            info = f'; slice_{n_steps} read back bit-equal: {exported}'
            if not exported:
                raise AssertionError('TA2T SFT: the export does not read '
                                     'back through load_audio_params')
            del back, got
        if tag in ('SFT', 'RM', 'PPO', 'GRPO'):
            moved = changed_modules(
                {m: params[m] for m in start}, start)
            info += f'; modules moved {moved}'
            tower_trains = tag in ('PPO', 'GRPO')          # R13
            if moved != {'language_model': True, 'projector': True,
                         'audio_tower': tower_trains}:
                raise AssertionError(f'TA2T {tag}: modules moved {moved}')
        if rollout_calls:
            info += (f'; rollout prefill {rollout_calls[0][0].__module__}.'
                     f'{rollout_calls[0][0].__name__} with audio_values '
                     f'{rollout_calls[0][1]}')
            if not (rollout_calls[0][0] is audio.forward
                    and rollout_calls[0][1][1] == CLIP_SAMPLES):
                raise AssertionError(f'TA2T {tag}: the rollout prefill '
                                     'took no clips')
        kl = [m.get('train/kl_divergence', m.get('train/kl'))
              for m in steps][:1]
        log(f'phase37 {tag}: batch {first["input_ids"].shape}; audio tokens '
            f'a row {counts}, spans {spans} (need {per_clip}); '
            f'{len(steps)} steps, losses '
            f'{[m.get("train/loss", m.get("train/actor_loss")) for m in steps]}'
            + (f', round 1 KL {kl[0]!r}' if tag in ('PPO', 'GRPO') else '')
            + f'; load {timing["load_s"]:.2f} s; flash launches fwd '
            f'{launches["fwd"]} (need {need["fwd"]}) bwd {launches["bwd"]} '
            f'(need {need["bwd"]}){info}; card {smi}')
        if len(steps) != n_steps or not all_finite(steps):
            raise AssertionError(f'TA2T {tag}: {len(steps)} steps or a '
                                 'non-finite metric')
        if tag in ('PPO', 'GRPO') and kl != [0.0]:
            raise AssertionError(f'TA2T {tag}: round 1 KL {kl}')
        if tag in ('PPO', 'GRPO') and not rollout_calls:
            raise AssertionError(f'TA2T {tag}: no rollout')
        if spans != [per_clip] * len(spans):
            raise AssertionError(f'TA2T {tag}: <audio> spans {spans}')
        check_launches(f'TA2T {tag}', launches, need, exact=True)
        for k in total:
            total[k] += launches[k]
        del trainer, params
        free_memory()
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f'phase37 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written() - written0:.3f} GB written by the phase')
    return {'launches': total}


# phase 38: meta-llama/Llama-3.2-11B-Vision-Instruct's published
# config.json (text_config: vocab 128256, hidden 4096, 40 layers with the
# cross-attention layers [3, 8, 13, 18, 23, 28, 33, 38], 32 / 8 heads of
# 128, intermediate 14336, rope_theta 500000 with llama3 scaling (factor
# 8, low 1, high 4, original 8192), 131072 positions, rms_norm_eps 1e-5,
# bos 128000, eos 128001 (the first of [128001, 128008, 128009]), pad
# 128004; vision_config: hidden 1280, intermediate 5120, 32 local and 8
# global layers, 16 heads, image 560, patch 14, 4 tiles, 8 aspect ratios,
# taps [3, 7, 15, 23, 30], output 7680; image_token_index 128256).  Cut
# for fp32 AdamW on one card: the text to 5 of its 40 layers with layer 3
# the cross layer (the published first), the tower to 8 local and 2
# global layers with the five taps remapped inside them (i x 8 // 32:
# layers 0, 1, 3, 5, 7), so that the feature stays 7680 wide and the
# projector 7680 -> 4096.  transformers initialises the cross layers' and
# the tile embeddings' gates at 0, which would keep the image from the
# text and the tower from any gradient; the checkpoint draws them from
# the seed, as a trained model holds them non-zero.  The TI2T YAMLs'
# freeze_vision_tower names 'vision_tower', which an Mllama tree does not
# hold (its tower is 'vision_model'): the tower trains (ROADMAP §3 R30),
# as in JAX.  4 pairs over PNGs of 560 x 560, 560 x 1120, 1120 x 1120 and
# 1120 x 560 (1, 2, 4 and 2 tiles), 2 a step in the 1024 bucket.
MLLAMA_11B = dict(vocab_size=128256, hidden_size=4096, num_heads=32,
                  num_kv_heads=8, head_dim=128, mlp_dim=14336,
                  max_position_embeddings=131072, rope_theta=500000.0,
                  rope_llama3=(8.0, 1.0, 4.0, 8192), norm_eps=1e-5,
                  bos_token_id=128000, eos_token_id=128001,
                  pad_token_id=128004)
MLLAMA_11B_VISION = dict(hidden_size=1280, intermediate_size=5120,
                         num_heads=16, image_size=560, patch_size=14,
                         max_num_tiles=4, max_aspect_ratio_id=8,
                         norm_eps=1e-5)
MLLAMA_IMAGE_TOKEN = 128256
MLLAMA_TEXT_LAYERS, MLLAMA_CROSS = 5, (3,)
MLLAMA_LOCAL, MLLAMA_GLOBAL, MLLAMA_TAPS = 8, 2, (0, 1, 3, 5, 7)
MLLAMA_ROWS, MLLAMA_PAIRS, MLLAMA_BUCKET = 4, 2, 1024
MLLAMA_STEPS = MLLAMA_ROWS // MLLAMA_PAIRS
MLLAMA_SIZES = ((560, 560), (560, 1120), (1120, 1120), (1120, 560))
MLLAMA_TILES = (1, 2, 4, 2)
# phase 39: phase 10's text widths, 2 layers (layer 1 cross), under the
# published tower widths cut to 2 local and 1 global layers (taps 0 and 1:
# the feature 3840 wide)
MLLAMA_SMALL_TOKEN = 32768
MLLAMA_SMALL_BATCH = 2
MLLAMA_GEN_NEW = 16


def mllama_11b_config():
    """Llama-3.2-11B-Vision-Instruct's published widths, cut as above."""
    from align_anything_tpu_torch.models.config import ModelConfig  # noqa: PLC0415
    from align_anything_tpu_torch.models.mllama import (  # noqa: PLC0415
        MllamaConfig, MllamaVisionConfig)

    return MllamaConfig(
        text=ModelConfig(num_layers=MLLAMA_TEXT_LAYERS, **MLLAMA_11B),
        vision=MllamaVisionConfig(
            num_layers=MLLAMA_LOCAL, num_global_layers=MLLAMA_GLOBAL,
            intermediate_layers_indices=MLLAMA_TAPS, **MLLAMA_11B_VISION),
        cross_attention_layers=MLLAMA_CROSS,
        image_token_id=MLLAMA_IMAGE_TOKEN)


def mllama_small_config():
    """Phase 39's config."""
    from align_anything_tpu_torch.models.config import ModelConfig  # noqa: PLC0415
    from align_anything_tpu_torch.models.mllama import (  # noqa: PLC0415
        MllamaConfig, MllamaVisionConfig)

    s = SMALL
    text = ModelConfig(
        vocab_size=s['vocab_size'], hidden_size=s['hidden'],
        num_layers=s['layers'], num_heads=s['heads'],
        num_kv_heads=s['kv_heads'], head_dim=s['hidden'] // s['heads'],
        mlp_dim=s['mlp'], max_position_embeddings=s['max_pos'],
        rope_theta=500000.0, rope_llama3=(8.0, 1.0, 4.0, 8192),
        norm_eps=1e-5, bos_token_id=1, eos_token_id=2, pad_token_id=0)
    return MllamaConfig(
        text=text, vision=MllamaVisionConfig(
            num_layers=2, num_global_layers=1,
            intermediate_layers_indices=(0, 1), **MLLAMA_11B_VISION),
        cross_attention_layers=(1,), image_token_id=MLLAMA_SMALL_TOKEN)


def write_mllama(cfg, path: str, seed: int, dev) -> dict:
    """An Mllama checkpoint of ``cfg`` with random weights from ``seed``
    (the gates drawn from it too, N(0, 1)), written in bf16 by the port's
    exporter: params per module, seconds and bytes."""
    from align_anything_tpu_torch.models import mllama  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        save_mllama_params)

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = mllama.init_params(cfg, gen, device=dev)
    vp = params['vision_model']
    gates = [vp[k]['gate'] for k in ('pos_embed', 'pre_tile', 'post_tile')]
    gates += [lp[k] for lp in params['language_model']['layers']
              for k in ('attn_gate', 'mlp_gate') if k in lp]
    for g in gates:
        g.copy_(torch.randn(g.shape, generator=gen, device=dev))
    n_params = {m: sum(t.numel() for t in param_leaves(params[m]))
                for m in params}
    t0 = time.perf_counter()
    save_mllama_params(path, params, cfg, dtype=torch.bfloat16)
    write_s = time.perf_counter() - t0
    del params
    free_memory()
    return {'n_params': n_params, 'write_s': write_s,
            'bytes': os.path.getsize(os.path.join(path, 'model.safetensors'))}


def mllama_cross_mask_host(ids: np.ndarray, image_token: int,
                           tiles: list) -> np.ndarray:
    """The cross mask a row's tokens should carry, row by row in plain
    Python: (B, L, 1, max_tiles) int, 1 from the row's image token onward
    over its first ``tiles[r]`` tiles."""
    out = np.zeros(ids.shape + (1, MLLAMA_11B_VISION['max_num_tiles']),
                   np.int64)
    for r, row in enumerate(ids.tolist()):
        if image_token in row:
            out[r, row.index(image_token):, 0, :tiles[r]] = 1
    return out


def mllama_dpo_assets(cfg, dev, tmp: str) -> tuple:
    """Phase 38's checkpoint (seeded), its AA_TI2T preference rows over
    PNG files and the command line: (checkpoint dir, what was written,
    argv, the image files)."""
    ckpt = os.path.join(tmp, 'mllama_11b')
    w = write_mllama(cfg, ckpt, SEED + 380, dev)
    images = png_images(tmp, MLLAMA_SIZES, SEED + 381)
    data = write_jsonl(os.path.join(tmp, 'pref_mllama.jsonl'),
                       ti2t_rows(images, SEED + 382, preference=True))
    argv = ['--model_name_or_path', ckpt, '--train_datasets', data,
            '--train_template', 'AA_TI2T', '--save_checkpoint', 'False',
            '--epochs', '1', '--per_device_train_batch_size',
            str(MLLAMA_PAIRS), '--padding_buckets', f'[{MLLAMA_BUCKET}]']
    return ckpt, w, argv, images


def mllama_step_flops(cfg, n: dict, shape: tuple) -> tuple:
    """(the step's FLOPs, the tower's part) of a DPO step that trains
    everything: the text by bench.py's convention over the padded rows
    (``dpo_flops_per_token`` over the self layers) plus the cross layers'
    attention over each row's vision tokens (16 x S x hidden a token and
    layer: policy forward and backward, reference forward); the tower's 8
    x its matmul params (its layers, the patch embedding, the projector) a
    vision token and its attention, 16 x S^2 x width a layer and row, over
    the padded sequence of 4 tiles (the tile embeddings are lookups)."""
    vc, tc = cfg.vision, cfg.text
    p1 = vc.num_patches
    s_pad = vc.max_num_tiles * (p1 + (8 - p1 % 8) % 8)
    s_vis = vc.max_num_tiles * p1
    n_layers = vc.num_layers + vc.num_global_layers
    self_layers = tc.num_layers - len(cfg.cross_attention_layers)
    tower_flops = shape[0] * (8 * n['tower_matmul'] * s_pad
                              + 16 * s_pad ** 2 * vc.hidden_size * n_layers)
    text_flops = shape[0] * shape[1] * (
        dpo_flops_per_token(n['language_model'], shape[1], tc.hidden_size,
                            self_layers)
        + 16 * s_vis * tc.hidden_size * len(cfg.cross_attention_layers))
    return text_flops + tower_flops, tower_flops


def mllama_dpo_full(dev, smi, tmp: str) -> dict:
    """Phase 38: TI2T DPO through ``trainer_main(TI2TDPOTrainer, ...)``
    (``python -m ...text_image_to_text.dpo``) on Mllama at
    Llama-3.2-11B-Vision widths, from a bf16 checkpoint written by the
    port's ``save_mllama_params`` and read by ``load_mllama_params``."""
    from align_anything_tpu_torch.data.image import MllamaTileProcessor  # noqa: PLC0415
    from align_anything_tpu_torch.models import mllama  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_mllama_params)
    from align_anything_tpu_torch.trainers.text_image_to_text.dpo import (  # noqa: PLC0415
        TI2TDPOTrainer)

    t_phase, written0 = time.perf_counter(), disk_written()
    free_memory()
    cfg = mllama_11b_config()
    ckpt, w, argv, images = mllama_dpo_assets(cfg, dev, tmp)
    n = w['n_params']
    log(f'phase38 wrote the checkpoint (Llama-3.2-11B-Vision widths, text '
        f'{cfg.text.num_layers} of 40 layers with cross layer '
        f'{list(cfg.cross_attention_layers)}, tower {cfg.vision.num_layers} '
        f'local + {cfg.vision.num_global_layers} global layers, taps '
        f'{list(cfg.vision.intermediate_layers_indices)}; params '
        f'language_model {n["language_model"] / 1e9:.3f} B, vision_model '
        f'{n["vision_model"] / 1e9:.3f} B, projector '
        f'{n["projector"] / 1e9:.4f} B; bf16 safetensors in Mllama layout): '
        f'{w["bytes"] / 1e9:.3f} GB in {w["write_s"]:.2f} s; '
        f'{MLLAMA_ROWS} AA_TI2T preference rows over PNG files of '
        f'{MLLAMA_SIZES}; argv {" ".join(argv[2:])}')
    first: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_flash_counts()
    t0 = time.perf_counter()
    with recording_loss(TI2TDPOTrainer, 'preference_loss', first, (
            'input_ids', 'attention_mask', 'response_mask', 'pixel_values',
            'aspect_ratio_ids', 'aspect_ratio_mask')):
        trainer, steps, timing = run_ti2t(
            TI2TDPOTrainer, 'text_image_to_text/dpo', argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    mcfg = trainer.model_cfg
    frozen = trainer.frozen_modules()
    start, _ = load_mllama_params(ckpt, device=dev)
    moved = changed_modules(trainer.state.params,
                            {m: leaves_by_path(start[m]) for m in start})
    del trainer, start
    free_memory()
    b = first['batch']
    shape = tuple(b['input_ids'].shape)
    ids = b['input_ids'].cpu().numpy()
    n_image = (ids == cfg.image_token_id).sum(-1).tolist()
    # the tile metadata of each row against the processor run again on the
    # host, the row's image found by its pixels
    proc = MllamaTileProcessor(cfg.vision)
    want = [proc(p) for p in images]
    px = b['pixel_values'].cpu().numpy()
    row_image = [next((j for j, o in enumerate(want)
                       if np.array_equal(px[r], o['pixel_values'])), None)
                 for r in range(shape[0])]
    meta_equal = None not in row_image and all(
        np.array_equal(b['aspect_ratio_ids'][r].cpu().numpy(),
                       want[j]['aspect_ratio_ids'])
        and np.array_equal(b['aspect_ratio_mask'][r].cpu().numpy(),
                           want[j]['aspect_ratio_mask'])
        for r, j in enumerate(row_image))
    tiles = [int(b['aspect_ratio_mask'][r].sum()) for r in range(shape[0])]
    want_tiles = [MLLAMA_TILES[j] if j is not None else None
                  for j in row_image]
    xmask = mllama.default_cross_attention_mask(
        mcfg, b['input_ids'], b['aspect_ratio_mask']).cpu().numpy()
    host_mask = mllama_cross_mask_host(ids, cfg.image_token_id, tiles)
    losses = [s['train/loss'] for s in steps]
    step_s, tps = step_report('phase38', steps, shape, 'train/loss')
    self_layers = cfg.text.num_layers - len(cfg.cross_attention_layers)
    # a step: the self layers' forward for the policy and the reference,
    # their backward; the remat policy ('save_flash') keeps the kernel's
    # output, so the recompute launches no forward
    need = {'fwd': MLLAMA_STEPS * 2 * self_layers,
            'bwd': MLLAMA_STEPS * self_layers}
    vc = cfg.vision
    n['tower_matmul'] = (
        (vc.num_layers + vc.num_global_layers)
        * (4 * vc.hidden_size ** 2 + 2 * vc.hidden_size
           * vc.intermediate_size)
        + 3 * vc.patch_size ** 2 * vc.hidden_size + n['projector'])
    step_flops, tower_flops = mllama_step_flops(cfg, n, shape)
    mfu = step_flops / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f'phase38 Mllama TI2T DPO: batch {shape} with pixel_values '
        f'{tuple(b["pixel_values"].shape)}, aspect_ratio_ids '
        f'{b["aspect_ratio_ids"].flatten().tolist()}, valid tiles a row '
        f'{tiles} (the images give {want_tiles}); tile metadata equal to the '
        f'host processor\'s: {meta_equal}; image tokens a row {n_image}; the '
        f'cross mask equal to the host\'s (from the image token on, over the '
        f'valid tiles): {bool(np.array_equal(xmask, host_mask))}; frozen '
        f'{frozen} (the tree holds {sorted(moved)}); remat '
        f'{mcfg.text.remat}, compute {mcfg.text.compute_dtype}; trainer_main '
        f'{total_s:.2f} s (load {timing["load_s"]:.2f} s, {len(steps)} '
        f'steps); step time {step_s:.4f} s (step 2), {tps:.1f} tokens/s, MFU '
        f'{mfu:.4f} ({step_flops / 1e12:.2f} TFLOP a step, the tower '
        f'{tower_flops / 1e12:.2f}, against 989 TFLOP/s); peak memory '
        f'{peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB resident before); '
        f'modules moved {moved}; flash launches fwd {launches["fwd"]} (need '
        f'{need["fwd"]}) bwd {launches["bwd"]} (need {need["bwd"]}); card '
        f'{smi}')
    if len(steps) != MLLAMA_STEPS or shape != (2 * MLLAMA_PAIRS,
                                               MLLAMA_BUCKET):
        raise AssertionError(f'Mllama DPO: {len(steps)} steps at {shape}')
    if abs(losses[0] - math.log(2)) > 1e-6:
        raise AssertionError(f'Mllama DPO step 1 loss {losses[0]!r} != ln 2')
    if not all_finite(steps):
        raise AssertionError('Mllama DPO: a non-finite metric')
    if n_image != [1] * shape[0]:
        raise AssertionError(f'Mllama DPO: image tokens a row {n_image}')
    if not (meta_equal and tiles == want_tiles):
        raise AssertionError('Mllama DPO: the tile metadata is not the '
                             'processor\'s')
    if not np.array_equal(xmask, host_mask):
        raise AssertionError('Mllama DPO: the cross mask is not the row\'s '
                             'image token onward over its valid tiles')
    if moved != {'vision_model': True, 'language_model': True,
                 'projector': True}:
        raise AssertionError(f'Mllama DPO: modules moved {moved}; under R30 '
                             'the tower trains')
    check_launches('Mllama DPO', launches, need, exact=True)

    # step 1 recomputed from the checkpoint with the plain attention, in
    # bf16 compute and in fp32
    params, _ = load_mllama_params(ckpt, device=dev)
    sums = {}
    with torch.no_grad(), plain_flash():
        for dtype in ('bfloat16', 'float32'):
            sums[dtype] = masked_sums(mllama.token_logprobs(
                params, mcfg.replace(compute_dtype=dtype), b['input_ids'],
                attention_mask=b['attention_mask'],
                pixel_values=b['pixel_values'],
                aspect_ratio_ids=b['aspect_ratio_ids'],
                aspect_ratio_mask=b['aspect_ratio_mask']),
                b['response_mask'])
    del params
    free_memory()
    log('phase38 step 1 recomputed with the plain attention, response '
        'log-prob sums: ' + check_sums('policy', first['sums'],
                                       sums['bfloat16'], sums['float32'])
        + '; ' + check_sums('reference', first['ref_sums'], sums['bfloat16'],
                            sums['float32']))
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f'phase38 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written() - written0:.3f} GB written by the phase (the '
        f'checkpoint {w["bytes"] / 1e9:.3f} GB, deleted), '
        f'{disk_written():.3f} GB by the run so far')
    return {'launches': launches, 'step_s': step_s, 'tokens_per_s': tps,
            'mfu': mfu, 'peak_gb': peak / 1e9, 'images': images}


def mllama_generation(cfg, ckpt: str, images: list, dev) -> dict:
    """Greedy ``generate`` of ``MLLAMA_GEN_NEW`` tokens from two image
    prompts with ``init_cache_fn=mllama.init_cache`` (the self cache, then
    the cross K/V from the prefill), in fp32 compute: each generated id is
    the argmax of a no-cache forward over the grown sequence."""
    from align_anything_tpu_torch.data.image import MllamaTileProcessor  # noqa: PLC0415
    from align_anything_tpu_torch.generation import generate  # noqa: PLC0415
    from align_anything_tpu_torch.models import mllama  # noqa: PLC0415
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_mllama_params)

    params, loaded = load_mllama_params(ckpt, device=dev)
    gcfg = loaded.replace(compute_dtype='float32')
    proc = MllamaTileProcessor(gcfg.vision)
    outs = [proc(p) for p in images]
    media = {k: torch.as_tensor(np.stack([o[k] for o in outs]), device=dev)
             for k in ('pixel_values', 'aspect_ratio_ids',
                       'aspect_ratio_mask')}
    rng = np.random.default_rng(SEED + 395)
    top = min(30000, gcfg.vocab_size)
    prompts = [[1] + list(rng.integers(3, top, 5)) + [gcfg.image_token_id]
               + list(rng.integers(3, top, 9)) for _ in images]
    ids = torch.as_tensor(prompts, device=dev)
    mask = torch.ones_like(ids)
    gen = GenerationConfig(max_new_tokens=MLLAMA_GEN_NEW, greedy=True,
                           eos_token_id=-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, gcfg, gen, ids, mask, media=media,
                   prefill_forward=mllama.forward,
                   step_forward=mllama.decode_forward,
                   init_cache_fn=mllama.init_cache)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    seqs, p = out['sequences'], ids.shape[1]
    agree = 0
    with torch.no_grad():
        for t in range(MLLAMA_GEN_NEW):
            logits = mllama.forward(params, gcfg, seqs[:, :p + t],
                                    **media).logits[:, -1]
            agree += int((logits.argmax(-1) == seqs[:, p + t]).sum())
    del params
    return {'gen_s': gen_s, 'agree': agree,
            'total': MLLAMA_GEN_NEW * len(images),
            'tiles': media['aspect_ratio_mask'].sum(-1).flatten().tolist(),
            'ids': seqs[:, p:].tolist()}


def mllama_small(dev, smi, tmp: str, images: list) -> dict:
    """Phase 39: at phase 10's text widths (2 layers, layer 1 cross) under
    a tower of the published widths (2 local + 1 global layers), through
    the entry points' ``trainer_main``: TI2T SFT and its bf16 export read
    back through ``load_mllama_params``, KTO, ORPO and SimPO one step
    each, then greedy ``generate`` with ``init_cache_fn``; ``images`` are
    phase 38's PNG files."""
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        load_mllama_params, save_mllama_params)
    from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: PLC0415
        kto, orpo, simpo)
    from align_anything_tpu_torch.trainers.text_image_to_text.sft import (  # noqa: PLC0415
        TI2TSupervisedTrainer)

    t_phase, written0 = time.perf_counter(), disk_written()
    free_memory()
    cfg = mllama_small_config()
    ckpt = os.path.join(tmp, 'mllama_small')
    w = write_mllama(cfg, ckpt, SEED + 390, dev)
    sft_data = write_jsonl(os.path.join(tmp, 'sft_mllama.jsonl'),
                           ti2t_rows(images, SEED + 391, preference=False))
    pref_data = write_jsonl(os.path.join(tmp, 'pref_mllama_small.jsonl'),
                            ti2t_rows(images, SEED + 392, preference=True))
    self_layers = cfg.text.num_layers - len(cfg.cross_attention_layers)
    b = MLLAMA_SMALL_BATCH
    common = ['--model_name_or_path', ckpt, '--train_template', 'AA_TI2T',
              '--save_checkpoint', 'False', '--epochs', '1',
              '--per_device_train_batch_size', str(b), '--padding_buckets',
              f'[{MLLAMA_BUCKET}]', '--learning_rate', '1e-4']
    one_step = ['--train_datasets', pref_data, '--train_size', str(b)]
    sft_steps = len(images) // b
    runs = (
        # (tag, class, task, argv, launches: the self layers' forward and
        # backward a step ('save_flash' keeps the kernel's output); KTO's
        # reference too, and its KL estimate at start-up two text-only
        # passes (R14))
        ('SFT', TI2TSupervisedTrainer, 'text_image_to_text/sft',
         [*common, '--train_datasets', sft_data],
         {'fwd': sft_steps * self_layers, 'bwd': sft_steps * self_layers}),
        ('KTO', kto.TI2TKTOTrainer, 'text_to_text/kto',
         [*common, *one_step, '--per_device_kl_batch_size', str(b)],
         {'fwd': 2 * self_layers + 2 * self_layers, 'bwd': self_layers}),
        ('ORPO', orpo.TI2TORPOTrainer, 'text_to_text/orpo',
         [*common, *one_step], {'fwd': self_layers, 'bwd': self_layers}),
        ('SimPO', simpo.TI2TSimPOTrainer, 'text_to_text/simpo',
         [*common, *one_step], {'fwd': self_layers, 'bwd': self_layers}))
    total = {'fwd': 0, 'bwd': 0}
    for tag, cls, task, argv, need in runs:
        torch.cuda.synchronize()
        reset_flash_counts()
        t0 = time.perf_counter()
        trainer, steps, _ = run_ti2t(cls, task, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = flash_counts()
        losses = [m['train/loss'] for m in steps]
        log(f'phase39 Mllama {tag}: model {trainer.mm.__name__}; '
            f'{len(steps)} steps, train/loss {losses}; trainer_main '
            f'{seconds:.2f} s; flash launches fwd {launches["fwd"]} (need '
            f'{need["fwd"]}) bwd {launches["bwd"]} (need {need["bwd"]}); '
            f'card {smi}')
        if (not trainer.mm.__name__.endswith('.mllama') or not steps
                or not all_finite(steps)):
            raise AssertionError(f'Mllama {tag}: {trainer.mm.__name__}, no '
                                 'step, or a non-finite metric')
        check_launches(f'Mllama {tag}', launches, need, exact=True)
        if tag == 'SFT':
            out = os.path.join(tmp, 'export_mllama_small')
            save_mllama_params(out, trainer.state.params, trainer.model_cfg,
                               dtype=torch.bfloat16)
            back, bcfg = load_mllama_params(out, device=dev)
            want = leaves_by_path(trainer.state.params)
            got = leaves_by_path(back)
            same = set(got) == set(want) and all(
                torch.equal(got[k].float(), want[k].to(torch.bfloat16)
                            .float()) for k in want)
            nbytes = dir_bytes(out)
            same_cfg = (bcfg.vision == cfg.vision
                        and bcfg.cross_attention_layers
                        == cfg.cross_attention_layers
                        and bcfg.image_token_id == cfg.image_token_id)
            log(f'phase39 Mllama SFT bf16 export: {len(got)} leaves, '
                f'{nbytes / 1e9:.4f} GB; read back through '
                f'load_mllama_params equal to the trained params in bf16: '
                f'{same}; the tower, cross layers and image token of the '
                f'config kept: {same_cfg}')
            shutil.rmtree(out, ignore_errors=True)
            if not (same and same_cfg):
                raise AssertionError('Mllama SFT: the export does not read '
                                     'back')
            del back
        for k in total:
            total[k] += launches[k]
        del trainer
        free_memory()
    gen = mllama_generation(cfg, ckpt, images[:2], dev)
    log(f'phase39 Mllama generate (fp32 compute, {MLLAMA_GEN_NEW} new tokens '
        f'from 2 image prompts of {gen["tiles"]} tiles, init_cache_fn): '
        f'{gen["gen_s"]:.3f} s; ids equal to the argmax of the no-cache '
        f'forward over the grown sequence {gen["agree"]}/{gen["total"]}; '
        f'ids {gen["ids"]}')
    if gen['agree'] != gen['total']:
        raise AssertionError('Mllama generate: ids off the no-cache argmax')
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f'phase39 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written() - written0:.3f} GB written by the phase (the '
        f'checkpoint {w["bytes"] / 1e9:.3f} GB, deleted)')
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


# phases 40-42: the mixture-of-experts decoder.  Phase 40 serves the
# repo's 'qwen3-moe-30b-a3b' preset at its full 24 layers (the JAX
# package's preset: 64 experts of 768, top 8, no q/k norm; not
# transformers' Qwen3MoeConfig, ROADMAP R33) with seeded random weights;
# phase 41 trains it by SFT at its widths, depth cut to 4 layers (fp32
# params, grads and AdamW moments of 24 layers, 129.6 GB, do not fit), and
# times bench.py's MoE config; phase 42 runs the rest at small widths.
MOE_PRESET = 'qwen3-moe-30b-a3b'
MOE_REQUESTS, MOE_PROMPT, MOE_NEW = 8, (112, 129), 32
MOE_SLOTS, MOE_MAX_LEN = 8, 256
MOE_CHECKED_NEW = 3
MOE_SFT_LAYERS, MOE_SFT_ROWS, MOE_SFT_BATCH = 4, 4, 2
# bench.py:589 bench_moe_extra: 32 experts of 1408, top 2, 4 layers at
# width 1024, 8 x 512 tokens, ms per forward without logits
MOE_BENCH = dict(vocab_size=32000, hidden_size=1024, num_layers=4,
                 num_heads=16, num_kv_heads=8, head_dim=64, mlp_dim=1408,
                 num_experts=32, num_experts_per_tok=2,
                 compute_dtype='bfloat16', eos_token_id=2, pad_token_id=0)
MOE_BENCH_SHAPE, MOE_BENCH_STEPS = (8, 512), 10
# phase 40's fp32 prefill, sparse against dense dispatch: the share of
# positions whose row of logits agrees within MOE_FP32_TOL x max|logit|
MOE_FP32_TOL, MOE_FP32_SHARE = 1e-3, 0.99
# phase 42: tiny-moe's routing (4 experts, top 2, coefficient 0.01) at
# hidden 256 with heads of 64 (tiny-moe's own heads of 16 are below K1's
# smallest head dim)
MOE_SMALL = dict(vocab_size=4096, hidden=256, layers=2, heads=4, kv_heads=2,
                 mlp=128, num_experts=4, top_k=2, max_pos=2048)
MOE_SMALL_PRESET = 'moe-small'


def k2_held_to_plain(run) -> dict:
    """``run()`` with every K2 launch held against its plain version on the
    same inputs (phase 2's limit, TOL x max|plain|): (M, K, N) -> the worst
    max|kernel - plain| / max|plain|.  The kernel's output is what the path
    reads on; these launches are not counted as the path's."""
    real = k2.int4_matmul_cuda
    worst: dict = {}

    def held(x, values, scales, dtype):
        out = real(x, values, scales, dtype)
        ref = k2.int4_matmul_reference(x, values, scales, dtype).float()
        err = float((out.float() - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-30)
        key = (x.shape[0], x.shape[1], out.shape[1])
        worst[key] = max(worst.get(key, 0.0), err)
        if not (torch.isfinite(out).all()
                and err <= TOL[str(dtype).split('.')[-1]]):
            raise AssertionError(f'K2 disagrees with its plain version at '
                                 f'(M, K, N) {key} {dtype}: {err:.3e}')
        return out

    # the kernel counts its launches on the module's name, here ``held``
    held.launches = 0
    with mock.patch.object(k2, 'int4_matmul_cuda', held):
        run()
    return worst


def moe_serving(dev, smi) -> dict:
    """Phase 40: the 'qwen3-moe-30b-a3b' preset at its full 24 layers,
    int4-COMPUTE as JAX's serving path quantizes it (experts fp32, the
    router, q/k/v/o and the head int4): 8 requests of 112-128 prompt tokens
    and 32 new ones through ``generate`` and the continuous engine (dense
    and paged cache), each ``moe_impl``.  bf16 over the int4-COMPUTE tree:
    timed, K2 counted.  fp32 over the same tree dequantized: the greedy ids
    of the three paths equal (over the int4-COMPUTE tree they need not:
    K2 takes a matmul of at most 128 rows, so the paged engine's
    one-request prefill runs K2 on bf16-rounded activations where
    ``generate``'s batched prefill runs the dense product; a dense model
    differs there too).  Every K2 launch of a short paged run held against
    the plain int4 product on its own inputs.  The prefill logits and aux
    loss of the two dispatches against each other in bf16 and fp32."""
    from align_anything_tpu_torch.generation.engine import generate  # noqa: PLC0415
    from align_anything_tpu_torch.models.config import PRESETS  # noqa: PLC0415

    t_phase = time.perf_counter()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    cfg = PRESETS[MOE_PRESET]().replace(compute_dtype='bfloat16')
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 400), device=dev)
    n_params = sum(t.numel() for t in param_leaves(params))
    params = q.quantize_decoder_int4(params, num_experts=cfg.num_experts,
                                     compute=True)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    kinds = {name: type(sub['w']).__name__
             for name, sub in params['layers'].items() if 'w' in sub}
    log(f'phase40 built {MOE_PRESET} ({cfg.num_layers} layers, hidden '
        f'{cfg.hidden_size}, {cfg.num_heads} / {cfg.num_kv_heads} heads of '
        f'{cfg.head_dim}, {cfg.num_experts} experts of {cfg.mlp_dim}, top '
        f'{cfg.num_experts_per_tok}, vocab {cfg.vocab_size}): {n_params / 1e9:.3f} '
        f'B params, int4-COMPUTE as quantize_decoder_int4 leaves it '
        f'({kinds}; head {type(params["lm_head"]).__name__}), resident '
        f'{resident / 1e9:.3f} GB, in {time.perf_counter() - t0:.1f} s')
    if any(kinds[k] != 'Tensor' for k in ('up', 'gate', 'down')) or \
            kinds['router'] != 'Int4Weight':
        raise AssertionError(f'phase40: unexpected quantized tree {kinds}')
    rng = np.random.default_rng(SEED + 401)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(
        rng.integers(*MOE_PROMPT))).tolist() for _ in range(MOE_REQUESTS)]
    ids, mask = left_padded(prompts, cfg.pad_token_id, dev)
    gen_cfg = GenerationConfig(max_new_tokens=MOE_NEW, greedy=True,
                               eos_token_id=-1, pad_token_id=cfg.pad_token_id)
    need_per_step = 3 * cfg.num_layers + 1        # q, k, v and the head
    # the same weights dense: only q/k/v/o, the router and the head (1.3 B
    # params) are new tensors, the experts are shared
    plain = q.dequantize_decoder(params)
    k2_total, rows = 0, {}
    for impl in ('dense', 'sparse'):
        for dtype in ('float32', 'bfloat16'):
            c = cfg.replace(moe_impl=impl, compute_dtype=dtype)
            tree = plain if dtype == 'float32' else params
            # fp32: the three paths' greedy ids; bf16: the engine timed
            names = (('generate', 'dense', 'paged') if dtype == 'float32'
                     else ('dense', 'paged'))
            for name in names:
                free_memory()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                k2.int4_matmul_cuda.launches = 0
                t0 = time.perf_counter()
                steps = None
                if name == 'generate':
                    toks = generate(tree, c, gen_cfg, ids,
                                    mask)['completions'].tolist()
                else:
                    engine = ContinuousBatchingEngine(
                        c, num_slots=MOE_SLOTS, max_len=MOE_MAX_LEN,
                        prompt_buckets=(128,), cache_mode=name)
                    toks = engine.generate(tree, prompts, gen_cfg)
                    steps = engine.stats['total_steps']
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                n = k2.int4_matmul_cuda.launches
                k2_total += n
                r = {'tokens': toks, 's': dt, 'k2': n, 'steps': steps,
                     'tokens_per_s': MOE_REQUESTS * MOE_NEW / dt,
                     'peak_gb': torch.cuda.max_memory_allocated() / 1e9}
                rows[(impl, dtype, name)] = r
                log(f'phase40 {impl} {dtype} {name}: {MOE_REQUESTS} requests'
                    f' x {MOE_NEW} tokens in {dt:.3f} s = '
                    f'{r["tokens_per_s"]:.1f} tokens/s; decode steps '
                    f'{steps}; K2 launches {n}; peak memory '
                    f'{r["peak_gb"]:.3f} GB; card {smi}')
                if not (len(toks) == MOE_REQUESTS
                        and all(len(t) == MOE_NEW for t in toks)
                        and all(0 <= x < cfg.vocab_size
                                for t in toks for x in t)):
                    raise AssertionError(f'phase40 {impl} {dtype} {name}: a '
                                         'request fell short or left the '
                                         'vocab')
                if (dtype == 'bfloat16' and steps is not None
                        and n < steps * need_per_step):
                    raise AssertionError(
                        f'phase40 {impl} {dtype} {name}: K2 launched {n} '
                        f'times, expected >= {steps * need_per_step}')
        want = rows[(impl, 'float32', 'generate')]['tokens']
        for name in ('dense', 'paged'):
            got = rows[(impl, 'float32', name)]['tokens']
            same = sum(g == w for g, w in zip(got, want))
            log(f'phase40 {impl}: continuous {name} greedy ids equal '
                f'generate\'s (fp32 compute, dequantized tree): '
                f'{same}/{MOE_REQUESTS} requests')
            if got != want:
                raise AssertionError(f'phase40 {impl}: the continuous {name} '
                                     'engine\'s greedy ids differ from '
                                     'generate\'s')
        timed = [rows[(impl, 'bfloat16', name)]['tokens']
                 for name in ('dense', 'paged')]
        log(f'phase40 {impl}: bf16 int4-COMPUTE, the paged engine\'s greedy '
            f'ids equal the dense engine\'s for '
            f'{sum(a == b for a, b in zip(*timed))}/{MOE_REQUESTS} requests '
            '(logged only: its one-request prefill runs K2)')
    # K2 on this path's own inputs: the paged engine's first tokens again
    # (bf16 int4-COMPUTE, dense dispatch), each launch held against the
    # plain int4 product: the one-request prefills at M 128 and the decode
    # steps at M 8, on q, k, v and the head
    again: list = []
    c = cfg.replace(moe_impl='dense', compute_dtype='bfloat16')
    worst = k2_held_to_plain(lambda: again.extend(ContinuousBatchingEngine(
        c, num_slots=MOE_SLOTS, max_len=MOE_MAX_LEN, prompt_buckets=(128,),
        cache_mode='paged').generate(params, prompts, GenerationConfig(
            max_new_tokens=MOE_CHECKED_NEW, greedy=True, eos_token_id=-1,
            pad_token_id=cfg.pad_token_id))))
    timed = rows[('dense', 'bfloat16', 'paged')]['tokens']
    same = sum(a == b[:MOE_CHECKED_NEW] for a, b in zip(again, timed))
    log(f'phase40 K2 held to its plain version on the path\'s inputs (paged '
        f'engine, {MOE_CHECKED_NEW} new tokens): worst max|kernel - plain| / '
        f'max|plain| per (M, K, N) {worst} (limit {TOL["bfloat16"]:g} bf16, '
        f'{TOL["float32"]:g} fp32); first {MOE_CHECKED_NEW} ids equal the '
        f'timed run\'s for {same}/{MOE_REQUESTS} requests')
    e = cfg.hidden_size
    need = {(MOE_SLOTS, e, n) for n in (cfg.num_heads * cfg.head_dim,
                                        cfg.num_kv_heads * cfg.head_dim,
                                        cfg.vocab_size)}
    if not need <= set(worst) or max(m for m, _, _ in worst) <= MOE_SLOTS:
        raise AssertionError(f'phase40: K2 missed a shape of the path: saw '
                             f'{sorted(worst)}')
    if same != MOE_REQUESTS:
        raise AssertionError('phase40: the checked run\'s ids differ from '
                             'the timed run\'s')
    # the prefill through the training forward (K1 over the left pads):
    # the dense and sparse dispatch against each other in bf16, within 3x
    # the dense pass's own distance from fp32 compute
    reset_flash_counts()
    pre = {}
    valid = mask.bool()
    with torch.no_grad():
        for impl in ('dense', 'sparse'):
            for dtype in ('bfloat16', 'float32'):
                out = transformer.forward(
                    params, cfg.replace(moe_impl=impl, compute_dtype=dtype),
                    ids, attention_mask=mask)
                pre[(impl, dtype)] = (out.logits[valid].float(),
                                      out.aux_loss.double().cpu())
                del out
    launches = flash_counts()
    check_launches('phase40 prefill', launches,
                   {'fwd': 4 * cfg.num_layers}, exact=True)
    dense, sparse, fp32, sparse32 = (pre[k] for k in (
        ('dense', 'bfloat16'), ('sparse', 'bfloat16'), ('dense', 'float32'),
        ('sparse', 'float32')))
    same_top = float((dense[0].argmax(-1) == sparse[0].argmax(-1))
                     .float().mean())
    # the sparse dispatch in the place of the kernels, the dense one in
    # the place of the plain version
    log(check_scores(
        'phase40 prefill logits, the sparse dispatch against the dense one '
        '(bf16)', sparse[0], dense[0], fp32[0]) + f'; same greedy token at '
        f'{100 * same_top:.2f} % of {int(valid.sum())} positions')
    log(check_scores(
        f'phase40 aux loss, the sparse dispatch {float(sparse[1]):.6f} '
        f'against the dense one {float(dense[1]):.6f} (fp32 '
        f'{float(fp32[1]):.6f})', sparse[1].reshape(1), dense[1].reshape(1),
        fp32[1].reshape(1)))
    # in fp32 the two dispatches differ only in their order of summation,
    # except at a token whose k-th and (k+1)-th router probabilities tie
    # within that noise, where the top k flips: most positions agree tight
    row = (sparse32[0] - fp32[0]).abs().amax(-1) / fp32[0].abs().max()
    share = float((row <= MOE_FP32_TOL).float().mean())
    aux32 = abs(float(sparse32[1]) - float(fp32[1]))
    log(f'phase40 prefill logits, sparse against dense dispatch (fp32): '
        f'{100 * share:.2f} % of positions within {MOE_FP32_TOL:g} x '
        f'max|logit| (limit {100 * MOE_FP32_SHARE:g} %), worst position '
        f'{float(row.max()):.3e}, median {float(row.median()):.3e}; aux '
        f'loss {float(sparse32[1]):.9f} against {float(fp32[1]):.9f} '
        f'(diff {aux32:.3e}, limit {MOE_FP32_TOL:g} x)')
    if not (share >= MOE_FP32_SHARE
            and aux32 <= MOE_FP32_TOL * abs(float(fp32[1]))):
        raise AssertionError('phase40: the sparse dispatch disagrees with '
                             'the dense one in fp32')
    del pre, dense, sparse, fp32, sparse32, params, plain
    free_memory()
    log(f'phase40 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': {'fwd': launches['fwd'], 'bwd': 0},
            'k2_launches': k2_total, 'rows': rows}


def moe_step1(trainer, batch: dict, compute_dtype: str | None = None
              ) -> torch.Tensor:
    """Step 1's quantities through ``trainer.loss_fn`` at its params: the
    cross-entropy, the router aux loss and the gradient norm of each
    module (router, experts, attention, embedding, head), float64 on the
    host; the gradients are cleared after."""
    params = trainer.state.params
    cfg = trainer.model_cfg
    if compute_dtype is not None:
        cfg = cfg.replace(compute_dtype=compute_dtype)
    for p in param_leaves(params):
        p.grad = None
    with mock.patch.object(trainer, 'model_cfg', cfg):
        loss, metrics = trainer.loss_fn(params, batch)
    loss.backward()
    lay = params['layers']
    groups = [lay[k]['w'] for k in ('router', 'up', 'gate', 'down', 'q', 'k',
                                    'v', 'o')]
    groups += [params['embedding'], params['lm_head']]
    vals = [float(metrics['train/loss']),
            float(metrics['train/router_aux_loss'])]
    vals += [float(g.grad.double().norm()) for g in groups]
    for p in param_leaves(params):
        p.grad = None
    return torch.tensor(vals, dtype=torch.float64)


MOE_STEP1_KEYS = ('loss', 'router_aux_loss', 'grad router', 'grad up',
                  'grad gate', 'grad down', 'grad q', 'grad k', 'grad v',
                  'grad o', 'grad embedding', 'grad lm_head')


def moe_sft(dev, smi, tmp: str) -> dict:
    """Phase 41: SFT through ``trainer_main(SupervisedTrainer, ...)`` from
    the 'qwen3-moe-30b-a3b' preset at its widths, cut to 4 layers, 2 rows
    x 1024 tokens a step, 2 steps with each ``moe_impl``, the trainer's
    default remat ('save_flash'); step 1 against the plain attention
    (``check_sums``), the two dispatches against each other, the router
    and every expert moved; then bench.py's MoE config timed."""
    from align_anything_tpu_torch.models import config as model_config  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.sft import (  # noqa: PLC0415
        SupervisedTrainer)

    t_phase = time.perf_counter()
    free_memory()
    rng = np.random.default_rng(SEED + 410)
    # 300 + 100 + 300-559 words: 710-970 tokens, the 1024 bucket
    data = write_jsonl(os.path.join(tmp, 'sft_moe.jsonl'), [
        {'instruction': words(rng, 300), 'input': words(rng, 100),
         'output': words(rng, int(rng.integers(300, 560)))}
        for _ in range(MOE_SFT_ROWS)])
    argv = ['--model_name_or_path', MOE_PRESET, '--train_datasets', data,
            '--train_template', 'Alpaca', '--save_checkpoint', 'False',
            '--epochs', '1', '--per_device_train_batch_size',
            str(MOE_SFT_BATCH)]
    launches = {'fwd': 0, 'bwd': 0}
    runs = {}
    for impl in ('dense', 'sparse'):
        first: dict = {}
        real = SupervisedTrainer.train_step

        def probe(self, batch, first=first, real=real):
            if not first:
                b = self.put_batch(batch)
                saved = flash_counts()
                first['kernel'] = moe_step1(self, b)
                first['kernel32'] = moe_step1(self, b, 'float32')
                with plain_flash():
                    first['plain'] = moe_step1(self, b)
                    first['fp32'] = moe_step1(self, b, 'float32')
                with nudged_plain_flash():
                    first['nudged'] = moe_step1(self, b)
                # the comparison's launches are not the path's
                fa.flash_attention_fwd_cuda.launches = saved['fwd']
                fa.flash_attention_bwd_cuda.launches = saved['bwd']
                lay = self.state.params['layers']
                first['start'] = {k: lay[k]['w'].detach().clone()
                                  for k in ('router', 'up', 'gate', 'down')}
                first['embedding_sum'] = float(
                    self.state.params['embedding'].detach().double().sum())
                first['shape'] = tuple(b['input_ids'].shape)
                first['cfg'] = self.model_cfg
            return real(self, batch)

        cut = functools.partial(model_config.qwen3_moe_config,
                                layers=MOE_SFT_LAYERS, moe_impl=impl)
        free_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        with mock.patch.dict(model_config.PRESETS, {MOE_PRESET: cut}), \
                mock.patch.object(SupervisedTrainer, 'train_step', probe):
            trainer, steps, _ = run_trainer(SupervisedTrainer,
                                            'text_to_text/sft', argv)
        torch.cuda.synchronize()
        n = flash_counts()
        peak = torch.cuda.max_memory_allocated()
        lay = trainer.state.params['layers']
        moved = {k: [bool(not torch.equal(lay[k]['w'][i], w[i]))
                     for i in range(MOE_SFT_LAYERS)]
                 for k, w in first['start'].items()}
        mcfg = first['cfg']
        n_params = sum(t.numel() for t in param_leaves(trainer.state.params))
        del trainer, lay, first['start']
        free_memory()
        for kind in launches:
            launches[kind] += n[kind]
        losses = [m['train/loss'] for m in steps]
        auxes = [m['train/router_aux_loss'] for m in steps]
        seconds = [m['perf/step_time_s'] for m in steps]
        shape = first['shape']
        # the last step: step 1's time on the loop's clock holds the
        # step-1 comparison's four passes (``probe``) and the first call
        step_s = seconds[-1]
        tps = shape[0] * shape[1] / step_s
        # FLOPs a trained token of the top-k model does (PaLM's 6N + 12 L h
        # layers, N the matmul params a token passes through: attention, the
        # router, K of the X experts, the head); the dense dispatch runs
        # every expert, X / K times the experts' share of that
        e, f, x_, k_ = (mcfg.hidden_size, mcfg.mlp_dim, mcfg.num_experts,
                        mcfg.num_experts_per_tok)
        attn = e * (mcfg.num_heads + 2 * mcfg.num_kv_heads) * mcfg.head_dim \
            + mcfg.num_heads * mcfg.head_dim * e
        active = mcfg.num_layers * (attn + e * x_ + k_ * 3 * e * f) \
            + e * mcfg.vocab_size
        flops = 6 * active + 12 * shape[1] * e * mcfg.num_layers
        mfu = flops * tps / PEAK_FLOPS[torch.bfloat16]
        for i, m in enumerate(steps):
            log(f'phase41 {impl} step {i + 1}: loss={losses[i]:.9f} '
                f'router_aux_loss={auxes[i]:.9f} grad_norm='
                f'{m["train/grad_norm"]:.6e} seconds={seconds[i]:.4f}')
        need = {'fwd': len(steps) * MOE_SFT_LAYERS,
                'bwd': len(steps) * MOE_SFT_LAYERS}
        log(f'phase41 {impl}: {n_params / 1e9:.3f} B params '
            f'({mcfg.num_layers} layers, remat {mcfg.remat}, compute '
            f'{mcfg.compute_dtype}, moe_impl {mcfg.moe_impl}); batch {shape};'
            f' step {step_s:.4f} s (step {len(steps)}), {tps:.1f} '
            f'tokens/s, MFU {mfu:.4f} ({flops / 1e9:.3f} GFLOP a token, top-'
            f'{k_} active {active / 1e9:.3f} B); peak memory '
            f'{peak / 1e9:.3f} GB; flash launches fwd {n["fwd"]} bwd '
            f'{n["bwd"]} (need {need}); card {smi}')
        log(f'phase41 {impl} moved (router, experts; per layer): {moved}')
        if len(steps) != 2 or not all_finite(steps):
            raise AssertionError(f'phase41 {impl}: {len(steps)} steps or a '
                                 'non-finite metric')
        if shape != (MOE_SFT_BATCH, 1024) or mcfg.remat != 'save_flash' \
                or mcfg.moe_impl != impl:
            raise AssertionError(f'phase41 {impl}: batch {shape}, remat '
                                 f'{mcfg.remat}, moe_impl {mcfg.moe_impl}')
        if not all(all(v) for v in moved.values()):
            raise AssertionError(f'phase41 {impl}: a router or expert leaf '
                                 f'did not move: {moved}')
        check_launches(f'phase41 {impl}', n, need, exact=True)
        ker, plain, fp32 = first['kernel'], first['plain'], first['fp32']
        for key, a, b, c, d in zip(MOE_STEP1_KEYS, ker, plain,
                                   first['kernel32'], fp32):
            log(f'phase41 {impl} step 1 {key}: kernel {float(a):.9e} plain '
                f'{float(b):.9e}; fp32 compute: kernel {float(c):.9e} plain '
                f'{float(d):.9e}')
        # fp32 compute (K1's CUDA-core kernels at D 64): the router's top k
        # does not flip on rounding there, so every quantity is held to
        # the flat limit
        log(f'phase41 {impl} ' + check_sums(
            'step 1 loss, router_aux_loss and per-module gradient norms '
            'through the kernels against the plain attention, fp32 compute',
            first['kernel32'], fp32))
        if abs(losses[0] - float(ker[0])) > 1e-6 * abs(float(ker[0])) or \
                abs(auxes[0] - float(ker[1])) > 1e-6 * abs(float(ker[1])):
            raise AssertionError(f'phase41 {impl}: the logged step 1 '
                                 f'({losses[0]}, {auxes[0]}) is not the '
                                 f'recomputed ({float(ker[0])}, '
                                 f'{float(ker[1])})')
        runs[impl] = dict(first, steps=steps, step_s=step_s, tps=tps,
                          mfu=mfu, peak_gb=peak / 1e9, launches=n)
    d, s = runs['dense'], runs['sparse']
    if d['embedding_sum'] != s['embedding_sum']:
        raise AssertionError('phase41: the two runs started from different '
                             'params')
    # bf16: an ulp of an attention output moves bf16 router logits across
    # ties, and the top k of a token flips (of every pad token at once:
    # they share one input).  The aux loss and the gradients behind it
    # move by 1e-3 to 1e-2 (a 1-ulp perturbation of the attention moved a
    # 4-layer model's aux by up to 1.5e-3 on the CPU), beyond the one
    # sample of bf16 noise that plain against fp32 gives.  So the bf16
    # limit takes the larger of two samples of that noise, both of this
    # dispatch's plain pass: against fp32, and against itself with each
    # attention output nudged by at most one ulp (``nudged_plain_flash``)
    for impl, run in (('dense', d), ('sparse', s)):
        ref = max((run['fp32'], run['nudged']),
                  key=lambda r, run=run: relative_gap(run['plain'], r))
        log(f'phase41 {impl} ' + check_sums(
            'step 1 loss, router_aux_loss and per-module gradient norms '
            'through the kernels against the plain attention, bf16 (noise: '
            'the larger of plain against fp32, '
            f'{relative_gap(run["plain"], run["fp32"]):.3e}, and against '
            'the plain pass with its attention output nudged by at most one '
            f'ulp, {relative_gap(run["plain"], run["nudged"]):.3e})',
            run['kernel'], run['plain'], ref))
    log('phase41 ' + check_sums(
        'step 1 loss and router_aux_loss, sparse against dense dispatch',
        s['kernel'][:2], d['kernel'][:2], d['fp32'][:2]))
    bench = moe_bench(dev, smi)
    for kind in launches:
        launches[kind] += bench['launches'][kind]
    log(f'phase41 done in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'runs': runs, 'bench': bench}


def moe_bench(dev, smi) -> dict:
    """``bench.py``'s ``bench_moe_extra`` config (bench.py:589): the
    forward without logits of 8 x 512 tokens through 4 layers of 32 experts
    (top 2) at width 1024, dense against sparse dispatch, ms a forward."""
    from align_anything_tpu_torch.models.config import ModelConfig  # noqa: PLC0415

    cfg = ModelConfig(**MOE_BENCH)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 415), device=dev)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, MOE_BENCH_SHAPE), device=dev)
    mask = torch.ones_like(ids)
    reset_flash_counts()
    out = {}
    with torch.no_grad():
        for impl in ('dense', 'sparse'):
            c = cfg.replace(moe_impl=impl)
            transformer.forward(params, c, ids, attention_mask=mask,
                                need_logits=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MOE_BENCH_STEPS):
                transformer.forward(params, c, ids, attention_mask=mask,
                                    need_logits=False)
            torch.cuda.synchronize()
            out[impl] = (time.perf_counter() - t0) / MOE_BENCH_STEPS * 1e3
    launches = flash_counts()
    check_launches('phase41 bench_moe_extra', launches,
                   {'fwd': 2 * (MOE_BENCH_STEPS + 1) * cfg.num_layers},
                   exact=True)
    log(f'phase41 bench_moe_extra (bench.py:589, {MOE_BENCH_SHAPE[0]} x '
        f'{MOE_BENCH_SHAPE[1]} tokens, {cfg.num_layers} layers, '
        f'{cfg.num_experts} experts of {cfg.mlp_dim}, top '
        f'{cfg.num_experts_per_tok}, width {cfg.hidden_size}): moe_dense '
        f'{out["dense"]:.3f} ms a forward, moe_sparse {out["sparse"]:.3f} ms, '
        f'dense / sparse {out["dense"] / out["sparse"]:.3f}; card {smi}')
    del params
    free_memory()
    return {'launches': {'fwd': launches['fwd'], 'bwd': 0},
            'dense_ms': out['dense'], 'sparse_ms': out['sparse']}


def moe_small(dev, smi, tmp: str) -> dict:
    """Phase 42 at small widths (``MOE_SMALL``): the forward over the int8
    tree, the R31 refusal, SFT through ``trainer_main`` with its HF export
    (R34's warning; ``tests/test_torch_moe.py`` holds the contents to JAX's)
    and a resume from its step-2 train state, and one DPO step."""
    import warnings  # noqa: PLC0415

    from align_anything_tpu_torch.models import config as model_config  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: PLC0415
        DPOTrainer)
    from align_anything_tpu_torch.trainers.text_to_text.sft import (  # noqa: PLC0415
        SupervisedTrainer)

    t_phase = time.perf_counter()
    disk0 = disk_written()
    # the special ids inside the small vocab (Qwen's sit past it)
    cfg = model_config.qwen3_moe_config(**MOE_SMALL).replace(
        router_aux_coef=0.01, bos_token_id=1, eos_token_id=2,
        pad_token_id=0)
    reset_flash_counts()
    # (a) the int8 tree: experts on axis 2, the router on axis 1; the
    # forward over it equals the forward over its dequantized copy
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 420), device=dev)
    qt = q.quantize_decoder_int8(params, num_experts=cfg.num_experts)
    dense_tree = q.dequantize_decoder(qt)
    ids = torch.as_tensor(np.random.default_rng(SEED + 421).integers(
        3, cfg.vocab_size, (2, 256)), device=dev)
    mask = torch.ones_like(ids)
    mask[1, 200:] = 0
    with torch.no_grad():
        for impl in ('dense', 'sparse'):
            c = cfg.replace(moe_impl=impl)
            got = transformer.forward(qt, c, ids, attention_mask=mask)
            want = transformer.forward(dense_tree, c, ids,
                                       attention_mask=mask)
            err = float((got.logits - want.logits).abs().max())
            scale = float(want.logits.abs().max())
            log(f'phase42 int8 tree, {impl}: forward against its '
                f'dequantized copy max|diff| {err:.3e} (max|logit| '
                f'{scale:.3e}, limit 1e-5 x); aux {float(got.aux_loss):.6f} '
                f'/ {float(want.aux_loss):.6f}')
            if not (err <= 1e-5 * scale and torch.isfinite(got.logits).all()
                    and float(got.aux_loss) == float(want.aux_loss)):
                raise AssertionError(f'phase42 int8 {impl}: the forward '
                                     'over the int8 tree disagrees')
    # (b) R31: int4 fuse=True refuses an MoE tree
    try:
        q.quantize_decoder_int4(params, num_experts=cfg.num_experts,
                                fuse=True)
    except ValueError as e:
        if 'R31' not in str(e):
            raise
        log('phase42 R31: quantize_decoder_int4(fuse=True) refused')
    else:
        raise AssertionError('phase42: int4 fuse=True ran on an MoE tree')
    del params, qt, dense_tree
    free_memory()

    rng = np.random.default_rng(SEED + 422)
    sft = write_jsonl(os.path.join(tmp, 'sft_moe_small.jsonl'), [
        {'instruction': words(rng, 40), 'input': words(rng, 10),
         'output': words(rng, int(rng.integers(20, 120)))}
        for _ in range(4)])
    pref = write_jsonl(os.path.join(tmp, 'pref_moe_small.jsonl'),
                       preference_rows(SEED + 423, 4, 60, (20, 121)))

    def argv(data, template, out, *extra):
        return ['--model_name_or_path', MOE_SMALL_PRESET, '--train_datasets',
                data, '--train_template', template,
                *(('--output_dir', os.path.join(tmp, out)) if out else ()),
                '--per_device_train_batch_size', '2', *extra]

    with mock.patch.dict(model_config.PRESETS, {MOE_SMALL_PRESET: lambda:
                                                cfg}):
        # (c) 4 steps (2 epochs), the train state saved at step 2 and the
        # export at the end; then a resume from step 2
        with unread_saves_skipped(state_steps=(2,), slice_steps=(4,)), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            full, full_steps, _ = run_trainer(
                SupervisedTrainer, 'text_to_text/sft',
                argv(sft, 'Alpaca', 'moe_full', '--epochs', '2',
                     '--save_checkpoint', 'True', '--save_interval', '2'))
        # the export's contents are held to JAX's in tests/test_torch_moe.py
        r34 = [str(w.message) for w in caught if 'R34' in str(w.message)]
        log(f'phase42 SFT: losses {[m["train/loss"] for m in full_steps]}, '
            f'router_aux_loss '
            f'{[m["train/router_aux_loss"] for m in full_steps]}; export '
            f'(R34): {len(r34)} warning(s)')
        if not (len(full_steps) == 4 and all_finite(full_steps) and r34
                and os.path.isfile(os.path.join(
                    tmp, 'moe_full', 'slice_4', 'model.safetensors'))):
            raise AssertionError('phase42: the MoE SFT run or its export '
                                 'failed')
        os.makedirs(os.path.join(tmp, 'moe_resumed', 'checkpoints'))
        shutil.copytree(
            os.path.join(tmp, 'moe_full', 'checkpoints', 'step_2'),
            os.path.join(tmp, 'moe_resumed', 'checkpoints', 'step_2'))
        with unread_saves_skipped(), warnings.catch_warnings():
            warnings.simplefilter('ignore')
            resumed, resumed_steps, _ = run_trainer(
                SupervisedTrainer, 'text_to_text/sft',
                argv(sft, 'Alpaca', 'moe_resumed', '--epochs', '2',
                     '--save_checkpoint', 'False', '--load_checkpoint',
                     'True'))
        want = [(m['train/loss'], m['train/router_aux_loss'],
                 m['train/grad_norm']) for m in full_steps[2:]]
        have = [(m['train/loss'], m['train/router_aux_loss'],
                 m['train/grad_norm']) for m in resumed_steps]
        a, b = (leaves_by_path(t.state.params) for t in (full, resumed))
        bit_equal = have == want and all(torch.equal(a[p], b[p]) for p in a)
        rel = max((abs(h - w) / abs(w) for hw, ww in zip(have, want)
                   for h, w in zip(hw, ww)), default=math.inf)
        log(f'phase42 resume from step 2: steps 3-4 {have} vs uninterrupted '
            f'{want}; bit-equal (metrics and params) {bit_equal}; max rel '
            f'diff {rel:.3e} (limit {DPO_SUM_TOL:g})')
        if len(have) != 2 or not (bit_equal or rel <= DPO_SUM_TOL):
            raise AssertionError('phase42: the MoE resume disagrees with the '
                                 'uninterrupted run')
        del full, resumed, a, b
        free_memory()
        # (d) one DPO step on the MoE model
        _, dpo_steps, _ = run_trainer(
            DPOTrainer, 'text_to_text/dpo',
            argv(pref, 'PKUSafeRLHF', None, '--epochs', '1',
                 '--save_checkpoint', 'False', '--train_size', '2'))
    launches = flash_counts()
    log(f'phase42 DPO: {len(dpo_steps)} step(s), loss '
        f'{[m["train/loss"] for m in dpo_steps]} (ln 2 = {math.log(2):.9f}); '
        f'flash launches of the phase {launches}')
    if not (len(dpo_steps) == 1
            and abs(dpo_steps[0]['train/loss'] - math.log(2)) <= 1e-6):
        raise AssertionError('phase42: MoE DPO step 1 is not ln 2')
    check_launches('phase42', launches, {'fwd': 1, 'bwd': 1})
    free_memory()
    log(f'phase42 done in {time.perf_counter() - t_phase:.1f} s; '
        f'{disk_written() - disk0:.4f} GB written by the phase')
    return {'launches': launches}


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
    # only the step-2 train state is read (the merged slices of steps 2
    # and 4, 0.39 GB each, would be read by nothing)
    with unread_saves_skipped(state_steps=(2,)):
        full, full_steps, _ = run_trainer(
            dpo.DPOTrainer, 'text_to_text/dpo',
            argv(pref, 'PKUSafeRLHF', 'lora_full', '--save_checkpoint',
                 'True', '--save_interval', '2', '--save_total_limit', '3',
                 *LORA_FLAGS['int4']))
    os.makedirs(os.path.join(tmp, 'lora_resumed', 'checkpoints'))
    shutil.copytree(os.path.join(tmp, 'lora_full', 'checkpoints', 'step_2'),
                    os.path.join(tmp, 'lora_resumed', 'checkpoints',
                                 'step_2'))
    with unread_saves_skipped():      # its final save: read by nothing
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


# phase 30: the OpenAI-compatible HTTP server at Gemma-3-1B's full size, on
# phase 24's checkpoint (no tokenizer files: the hash tokenizer, one token a
# word).  Every prompt starts with the same 48-word system text and runs
# 470-500 words more: 520-550 tokens, longer than the window 512, and a
# tail in the 512 bucket, so the cached prefix and the tail fit max_len
# 1024 (the engine's match rule).  32 new tokens a request: the phase's
# time is the host's work in four servers' decode loops (112.5-170.2 s of
# the call at 64).  Not a shallower model: cut to 6 of its 26 layers, the
# random model repeats the prompt's closing EOS and every request stops
# after one token.
HTTP_CLIENTS, HTTP_SLOTS, HTTP_NEW = 16, 8, 32
HTTP_SYSTEM_WORDS, HTTP_WORDS = 48, (470, 501)


class CountingServer(api_server.InferenceServer):
    """An ``InferenceServer`` that also counts the tokens it generates."""

    def __init__(self, *args, **kwargs):
        self.generated = 0
        super().__init__(*args, **kwargs)

    def _finish(self, rid, tokens):
        self.generated += len(tokens)
        super()._finish(rid, tokens)


def http_texts(seed: int) -> tuple[str, list]:
    rng = np.random.default_rng(seed)

    def text(n):
        return ' '.join(f'w{int(x)}' for x in rng.integers(0, 50000, size=n))

    system = text(HTTP_SYSTEM_WORDS)
    return system, [f'{system} {text(int(rng.integers(*HTTP_WORDS)))}'
                    for _ in range(HTTP_CLIENTS)]


def http_call(base: str, path: str, payload: dict | None = None) -> dict:
    """One request; for a stream, the events, whether it ended in [DONE]
    and the time to its first event (its first text, or the closing event
    of a completion that ended at once)."""
    import urllib.error  # noqa: PLC0415
    import urllib.request  # noqa: PLC0415

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={'Content-Type': 'application/json'})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            if not (payload or {}).get('stream'):
                return {'status': r.status, 'body': json.loads(r.read())}
            events, done, ttft = [], False, None
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith('data: '):
                    continue
                if line == 'data: [DONE]':
                    done = True
                    break
                if ttft is None:
                    ttft = time.perf_counter() - t0
                events.append(json.loads(line[len('data: '):]))
            return {'status': r.status, 'events': events, 'done': done,
                    'ttft': ttft}
    except urllib.error.HTTPError as err:
        return {'status': err.code, 'body': err.read()}


def streamed_text(events: list) -> str:
    return ''.join(e['choices'][0].get('text')
                   or e['choices'][0].get('delta', {}).get('content', '')
                   for e in events)


def start_http(ckpt: str, mode: str, system: str, dtype: str):
    """A server on phase 24's checkpoint behind ``make_stdlib_server`` on a
    free port of 127.0.0.1, serving in a daemon thread.  The checkpoint has
    no tokenizer files, so the server serves the hash tokenizer.  The
    checkpoint's config computes in bf16; for ``dtype`` float32 the
    server's ``load_params`` hands back that config in fp32 compute."""
    real = api_server.load_params

    def load(path, **kw):
        params, cfg = real(path, **kw)
        return params, cfg.replace(compute_dtype=dtype)

    with mock.patch.object(api_server, 'load_params', load):
        server = CountingServer(
            ckpt, num_slots=HTTP_SLOTS, max_len=GEN_MAX_LEN,
            max_new_tokens=HTTP_NEW, cache_mode=mode,
            prefix_cache_text=system if mode == 'paged' else None,
            device=torch.device('cuda', 0))
    if not isinstance(server.tokenizer, api_server.HashTokenizer):
        raise AssertionError('phase30: the server did not take the hash '
                             'tokenizer for a checkpoint without one')
    httpd = api_server.make_stdlib_server(server, '127.0.0.1', 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return server, httpd, thread, f'http://127.0.0.1:{httpd.server_address[1]}'


def stop_http(server, httpd, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    server.shutdown(timeout=60)
    if server._worker.is_alive() or thread.is_alive():
        raise AssertionError('phase30: the server did not stop')


def client_mix(base: str, prompts: list) -> tuple[list, float]:
    """16 concurrent clients, each a GET of /health and /v1/models and one
    greedy POST: completions, chat, and both streamed, in turn."""
    kinds = ('completion', 'chat', 'stream_completion', 'stream_chat')
    replies: list = [None] * len(prompts)

    def client(i):
        kind = kinds[i % len(kinds)]
        path = '/v1/chat/completions' if 'chat' in kind else '/v1/completions'
        body = ({'messages': [{'role': 'user', 'content': prompts[i]}]}
                if 'chat' in kind else {'prompt': prompts[i]})
        body.update(max_tokens=HTTP_NEW, temperature=0.0,
                    stream=kind.startswith('stream'))
        replies[i] = [http_call(base, '/health'),
                      http_call(base, '/v1/models'),
                      dict(http_call(base, path, body), kind=kind)]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(prompts)) as pool:
        for fut in [pool.submit(client, i) for i in range(len(prompts))]:
            fut.result()
    return replies, time.perf_counter() - t0


def greedy_ids_against_direct(server, prompts: list) -> tuple[int, list]:
    """Greedy ids from ``submit`` / ``wait`` (all submitted at once); after
    the worker stopped, a direct ``engine.generate`` of the same prompt ids
    on the server's engine.  -> (how many are equal, the ids)."""
    ids = [server.tokenizer.encode(p) for p in prompts]
    rids = [server.submit(x, temperature=0.0) for x in ids]
    got = [server.wait(r)[0] for r in rids]
    server.shutdown(timeout=60)
    direct = server.engine.generate(
        server.params, ids, GenerationConfig(
            max_new_tokens=HTTP_NEW, greedy=True,
            eos_token_id=server.tokenizer.eos_token_id))
    return sum(a == b for a, b in zip(got, direct)), got


def http_serving(dev, smi, ckpt: str) -> dict:
    """Phase 30: phase 24's Gemma-3-1B checkpoint served over HTTP, dense
    then paged with the system text as its cached prefix; bf16 timed,
    fp32 held to the engine."""
    t_phase = time.perf_counter()
    system, prompts = http_texts(SEED + 300)
    rows = {}
    for mode in ('dense', 'paged'):
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        server, httpd, thread, base = start_http(ckpt, mode, system,
                                                 'bfloat16')
        try:
            lens = [len(server.tokenizer.encode(p)) for p in prompts]
            replies, seconds = client_mix(base, prompts)
            generated = server.generated
            peak = torch.cuda.max_memory_allocated() / 1e9
            statuses = [r['status'] for rs in replies for r in rs]
            ttft = [rs[2]['ttft'] for rs in replies
                    if rs[2]['kind'].startswith('stream')]
            done = all(rs[2]['done'] for rs in replies
                       if rs[2]['kind'].startswith('stream'))
            reasons = Counter(
                (rs[2]['events'][-1] if 'events' in rs[2] else rs[2]['body'])
                ['choices'][0]['finish_reason'] for rs in replies
                if rs[2]['status'] == 200)
            if mode == 'paged':
                cached = server.engine._prefix['len']
            same, ids = greedy_ids_against_direct(server, prompts)
        finally:
            stop_http(server, httpd, thread)
        log(f'phase30 {mode} bf16: {HTTP_CLIENTS} clients ({len(statuses)} '
            f'requests: /health, /v1/models and a completion, chat or '
            f'stream each), prompts {min(lens)}-{max(lens)} tokens (window '
            f'{server.model_cfg.sliding_window}), {generated} tokens '
            f'generated in {seconds:.3f} s = {generated / seconds:.1f} '
            f'tokens/s; time to first token (SSE) {quantiles(ttft)}; peak '
            f'memory {peak:.3f} GB; statuses '
            f'{sorted(Counter(statuses).items())}'
            + (f'; prefix {cached} tokens cached' if mode == 'paged' else '')
            + f'; finish reasons {sorted(reasons.items())}; greedy ids equal '
            f'to a direct engine.generate: {same}/{len(ids)} (tokens a '
            f'request {min(map(len, ids))}-{max(map(len, ids))}); card {smi}')
        if set(statuses) != {200} or not done or None in ttft:
            raise AssertionError(f'phase30 {mode}: a request failed')
        if min(lens) <= server.model_cfg.sliding_window:
            raise AssertionError('phase30: a prompt within the window')
        rows[mode] = {'tokens_per_s': generated / seconds, 'ttft': ttft,
                      'peak_gb': peak, 'same': same}
        # the stdlib server's handler holds the server: drop both
        del server, httpd, thread

        # fp32: the server's greedy ids are the engine's, and a stream
        # joins into the non-streamed text
        free_memory()
        server, httpd, thread, base = start_http(ckpt, mode, system,
                                                 'float32')
        try:
            body = {'prompt': prompts[0], 'max_tokens': HTTP_NEW,
                    'temperature': 0.0}
            stream = http_call(base, '/v1/completions',
                               dict(body, stream=True))
            whole = http_call(base, '/v1/completions', body)
            text = whole['body']['choices'][0]['text']
            joined = (stream['status'] == whole['status'] == 200
                      and stream['done'] and bool(text)
                      and streamed_text(stream['events']) == text)
            same32, ids = greedy_ids_against_direct(server, prompts)
        finally:
            stop_http(server, httpd, thread)
        log(f'phase30 {mode} fp32: streamed deltas join into the '
            f'non-streamed text: {joined} ({len(text)} characters); greedy '
            f'ids equal to a direct engine.generate: '
            f'{same32}/{len(ids)}')
        if not (joined and same32 == len(ids)):
            raise AssertionError(f'phase30 {mode}: the server disagrees with '
                                 'the engine in fp32')
        # the stdlib server's handler holds the server: drop both
        del server, httpd, thread
    free_memory()
    log(f'phase30 done in {time.perf_counter() - t_phase:.1f} s')
    return rows


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
                 ) -> float:
    """Device time by kernel group and the idle share of a traced window
    that took ``wall`` seconds (ending in a synchronize); returns the
    device's busy seconds."""
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
    report_groups(name, groups, wall)
    for key, (us, count) in sorted(kernels.items(),
                                   key=lambda kv: -kv[1][0])[:top]:
        log(f'profile {name} kernel {us / 1e3:10.3f} ms x{count:<6d} '
            f'{key[:110]}')
    return busy


def report_groups(name: str, groups: dict, wall: float) -> None:
    for group, sec in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f'profile {name} group {group}: {sec:.4f} s '
            f'({sec / wall:.4f} of the window)')


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


def profile_qwen2_vl(dev, smi, tmp: str) -> None:
    """``--profile qwen2vl``: one Qwen2-VL DPO step of phase 34's config
    after a warm-up step, traced whole; then, over that step's patch rows,
    the tower's forward and backward (the policy's pass), its forward
    without gradients (the reference's), and the tower's 32 plain
    attention calls alone at those shapes (forward and backward, then
    forward without gradients): the share of the step that a D 80
    attention kernel could take over."""
    from align_anything_tpu_torch.models import qwen2_vl  # noqa: PLC0415
    from align_anything_tpu_torch.ops.attention import xla_attention  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.cli import parse_cfgs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_image_to_text.dpo import (  # noqa: PLC0415
        TI2TDPOTrainer)

    cfg = qwen2_vl_config()
    argv = qwen2_vl_dpo_assets(cfg, dev, tmp)[2]
    with mock.patch.dict(os.environ, {'MESH_FILE': HARNESS_MESH}):
        cfgs, pc = parse_cfgs('text_image_to_text/dpo', argv)
    trainer = TI2TDPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    warm, batch = list(trainer.train_iterator.epoch_batches(0))[:2]
    trainer.train_step(warm)
    _, prof, wall = traced(lambda: trainer.train_step(batch))
    step_busy = report_trace('qwen2vl dpo step', prof, wall, smi)
    dev_batch = trainer.put_batch(batch)
    px, grids = dev_batch['pixel_values'], dev_batch['image_grid_thw'][:, 1:]
    visual, vcfg = trainer.state.params['visual'], trainer.model_cfg.vision

    def tower_fwd_bwd():
        out = qwen2_vl.vision_forward(visual, vcfg, px, 'bfloat16', grids)
        out.float().sum().backward()

    _, prof, wall = traced(tower_fwd_bwd)
    tower = report_trace(f'qwen2vl tower forward + backward ({px.shape[0]} '
                         f'rows of {px.shape[1]} patches)', prof, wall, smi)
    for t in param_leaves(visual):
        t.grad = None
    with torch.no_grad():
        _, prof, wall = traced(lambda: qwen2_vl.vision_forward(
            visual, vcfg, px, 'bfloat16', grids))
    tower += report_trace('qwen2vl tower forward, no grad', prof, wall, smi)
    gen = torch.Generator(device=dev).manual_seed(SEED + 345)
    b, n = px.shape[:2]
    q, k, v = (torch.randn((b, n, vcfg.num_heads, vcfg.head_dim),
                           generator=gen, device=dev).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    mask = (torch.arange(n, device=dev)[None]
            < (grids[:, 0] * grids[:, 1])[:, None])

    def attention_fwd_bwd():
        for _ in range(vcfg.depth):
            out = xla_attention(q, k, v, attention_mask=mask, causal=False)
            torch.autograd.grad(out.float().sum(), (q, k, v))

    _, prof, wall = traced(attention_fwd_bwd)
    attn = report_trace(f'qwen2vl tower attention x {vcfg.depth}, forward + '
                        'backward', prof, wall, smi, top=8)
    with torch.no_grad():
        _, prof, wall = traced(lambda: [
            xla_attention(q, k, v, attention_mask=mask, causal=False)
            for _ in range(vcfg.depth)])
    attn += report_trace(f'qwen2vl tower attention x {vcfg.depth}, forward',
                         prof, wall, smi, top=8)
    log(f'profile qwen2vl: device busy a step {step_busy:.4f} s; the tower '
        f'(policy and reference passes) {tower:.4f} s '
        f'({tower / step_busy:.4f}); its plain attention at D '
        f'{vcfg.head_dim} {attn:.4f} s ({attn / step_busy:.4f} of the '
        f"step's device time); card {smi}")
    del trainer, prof, q, k, v
    free_memory()


def profile_mllama(dev, smi, tmp: str) -> None:
    """``--profile mllama``: one Mllama DPO step of phase 38's config after
    a warm-up step, traced whole; then, over that step's tiles and rows,
    the tower with the projector, forward and backward (the policy's pass)
    and forward without gradients (the reference's); the tower's plain
    attention alone at its shapes (its 10 layers, the same two ways); and
    the cross layer alone (the same two ways): their shares of the step's
    device time."""
    from align_anything_tpu_torch.models import mllama  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.cli import parse_cfgs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_image_to_text.dpo import (  # noqa: PLC0415
        TI2TDPOTrainer)

    cfg = mllama_11b_config()
    ckpt, _, argv, _ = mllama_dpo_assets(cfg, dev, tmp)
    cfgs, pc = parse_cfgs('text_image_to_text/dpo', argv)
    trainer = TI2TDPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    warm, batch = list(trainer.train_iterator.epoch_batches(0))[:2]
    trainer.train_step(warm)
    _, prof, wall = traced(lambda: trainer.train_step(batch))
    step_busy = report_trace('mllama dpo step', prof, wall, smi)
    db = trainer.put_batch(batch)
    params, mcfg = trainer.state.params, trainer.model_cfg
    c, vc = mcfg.text, mcfg.vision
    media = (db['pixel_values'], db['aspect_ratio_ids'],
             db['aspect_ratio_mask'])

    def tower(grad: bool):
        out = mllama.image_features(params, mcfg, *media, torch.bfloat16,
                                    remat=c.remat if grad else 'none')
        if grad:
            out.float().sum().backward()
        return out

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    _, prof, wall = traced(lambda: tower(True))
    t_tower = report_trace('mllama tower + projector, forward + backward',
                           prof, wall, smi)
    for t in param_leaves(params):
        t.grad = None
    states, prof, wall = traced(no_grad(lambda: tower(False)))
    t_tower += report_trace('mllama tower + projector, forward, no grad',
                            prof, wall, smi)
    gen = torch.Generator(device=dev).manual_seed(SEED + 385)
    rows = db['pixel_values'].shape[0]
    p1 = vc.num_patches
    pp = p1 + (8 - p1 % 8) % 8
    s = vc.max_num_tiles * pp
    q, k, v = (torch.randn((rows, s, vc.num_heads, vc.head_dim),
                           generator=gen, device=dev).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    valid = (db['aspect_ratio_mask'].reshape(rows, -1, 1).bool()
             & (torch.arange(pp, device=dev) < p1))
    invalid = 1.0 - valid.reshape(rows, s).float()
    n_layers = vc.num_layers + vc.num_global_layers

    def attention(grad: bool):
        for _ in range(n_layers):
            out = mllama.vision_attention(q, k, v, invalid)
            if grad:
                torch.autograd.grad(out.float().sum(), (q, k, v))

    _, prof, wall = traced(lambda: attention(True))
    t_attn = report_trace(f'mllama tower attention x {n_layers}, forward + '
                          'backward', prof, wall, smi, top=8)
    _, prof, wall = traced(no_grad(lambda: attention(False)))
    t_attn += report_trace(f'mllama tower attention x {n_layers}, forward',
                           prof, wall, smi, top=8)
    lp = params['language_model']['layers'][mcfg.cross_attention_layers[0]]
    x = torch.randn((rows, db['input_ids'].shape[1], c.hidden_size),
                    generator=gen, device=dev).to(torch.bfloat16) \
        .requires_grad_(True)
    xmask = mllama.default_cross_attention_mask(
        mcfg, db['input_ids'], db['aspect_ratio_mask'])
    bias, full_row = mllama.prepare_cross_attention_mask(xmask, p1)
    states = states.detach()

    def cross(grad: bool):
        out = mllama._cross_block(c, lp, x, states, bias, full_row)
        if grad:
            out.float().sum().backward()

    _, prof, wall = traced(lambda: cross(True))
    t_cross = report_trace('mllama cross layer, forward + backward', prof,
                           wall, smi, top=8)
    for t in param_leaves(params):
        t.grad = None
    _, prof, wall = traced(no_grad(lambda: cross(False)))
    t_cross += report_trace('mllama cross layer, forward, no grad', prof,
                            wall, smi, top=8)
    log(f'profile mllama: device busy a step {step_busy:.4f} s; the tower '
        f'with the projector (policy and reference passes) {t_tower:.4f} s '
        f'({t_tower / step_busy:.4f}); its plain attention at D '
        f'{vc.head_dim} {t_attn:.4f} s ({t_attn / step_busy:.4f}); the cross '
        f'layer {t_cross:.4f} s ({t_cross / step_busy:.4f}) of the step\'s '
        f'device time; card {smi}')
    del trainer, params, prof, q, k, v, x, states
    free_memory()
    shutil.rmtree(ckpt, ignore_errors=True)


def profile_ta2t(dev, smi, tmp: str) -> None:
    """``--profile ta2t``: one TA2T DPO step of phase 36's config after a
    warm-up step, traced whole; then, on that step's clips, what the step
    runs of the audio path twice (the policy's pass and the reference's):
    the log-mel frontend alone, and the whole encoder (frontend,
    convolutions, the 32 layers, pool, norm and projector) without
    gradients, as the frozen tower runs: their shares of the step's device
    time."""
    from align_anything_tpu_torch.models import audio  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.cli import parse_cfgs  # noqa: PLC0415
    from align_anything_tpu_torch.trainers.text_audio_to_text.dpo import (  # noqa: PLC0415
        TA2TDPOTrainer)

    cfg = qwen2_audio_config()
    ckpt, _, argv = ta2t_dpo_assets(cfg, dev, tmp)
    cfgs, pc = parse_cfgs('text_audio_to_text/dpo', argv)
    trainer = TA2TDPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    shutil.rmtree(ckpt, ignore_errors=True)
    warm, batch = list(trainer.train_iterator.epoch_batches(0))[:2]
    trainer.train_step(warm)
    _, prof, wall = traced(lambda: trainer.train_step(batch))
    step_busy = report_trace('ta2t dpo step', prof, wall, smi)
    waves = trainer.put_batch(batch)['audio_values']
    params, mcfg = trainer.state.params, trainer.model_cfg
    with torch.no_grad():
        _, prof, wall = traced(lambda: [audio.frontend(mcfg, waves)
                                        for _ in range(2)])
        mel = report_trace(f'ta2t log-mel frontend x 2 ({waves.shape[0]} '
                           'clips of 30 s)', prof, wall, smi, top=8)
        _, prof, wall = traced(lambda: [audio.encode_audio(params, mcfg,
                                                           waves)
                                        for _ in range(2)])
        tower = report_trace(f'ta2t encoder forward x 2 ({waves.shape[0]} '
                             'clips of 30 s)', prof, wall, smi)
    log(f'profile ta2t: device busy a step {step_busy:.4f} s; the encoder '
        f'(policy and reference passes) {tower:.4f} s '
        f'({tower / step_busy:.4f} of the step\'s device time), of it the '
        f'log-mel frontend {mel:.4f} s ({mel / step_busy:.4f}); card {smi}')
    del trainer, prof, params, waves
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
    if sys.argv[1:2] in (['--help'], ['-h']):
        print(__doc__)
        return 0
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
        which = sys.argv[2:] or ['dpo', 'ppo', 'ti2t', 'qlora', 'gemma3',
                                 'qwen2vl', 'ta2t', 'mllama']
        if 'dpo' in which:
            profile_dpo(dev, smi)
        tmp = tempfile.mkdtemp(prefix='chip_smoke_profile_')
        try:
            for name, fn in (('ppo', profile_ppo), ('ti2t', profile_ti2t),
                             ('qlora', profile_qlora),
                             ('gemma3', profile_gemma3),
                             ('qwen2vl', profile_qwen2_vl),
                             ('ta2t', profile_ta2t),
                             ('mllama', profile_mllama)):
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

    paged = paged_serving(params, cfg, requests, dev, smi)
    del params, engine, served
    free_memory()
    int4_8b = bench_int4_8b(dev, smi)
    free_memory()

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
        rm = rm_full(dev, smi, tmp, base=harness['ckpt'])
        ppo = ppo_full(dev, smi, tmp, rm)
        cost = rl_small(dev, smi, tmp)
        kto = kto_full(dev, smi, tmp)
        grpo = grpo_full(dev, smi, tmp, rm)
        safe = saferlhf_full(dev, smi, tmp)
        variants = rl_variants_small(dev, smi, tmp, cost)
        ti2t = ti2t_full(dev, smi, tmp)
        ti2t_sft = ti2t_small(dev, smi, tmp)
        ti2t_rm = ti2t_rm_full(dev, smi, tmp, base=ti2t['ckpt'])
        ti2t_ppo = ti2t_ppo_full(dev, smi, tmp, ti2t_rm)
        ti2t_rl = ti2t_rl_small(dev, smi, tmp, ti2t_sft)
        anyres = anyres_full(dev, smi, tmp, ti2t['ckpt'])
        tv2t = tv2t_full(dev, smi, tmp, ti2t['ckpt'], anyres['newline'])
        lnext_small = llava_next_small(dev, smi, tmp)
        qwen_dpo = qwen2_vl_dpo_full(dev, smi, tmp)
        qwen_small = qwen_vl_small(dev, smi, tmp)
        ta2t_dpo = ta2t_dpo_full(dev, smi, tmp)
        ta2t_sm = ta2t_small(dev, smi, tmp)
        mllama_dpo = mllama_dpo_full(dev, smi, tmp)
        mllama_sm = mllama_small(dev, smi, tmp, mllama_dpo['images'])
        moe_serve = moe_serving(dev, smi)
        moe_train = moe_sft(dev, smi, tmp)
        moe_sm = moe_small(dev, smi, tmp)
        qlora4 = qlora_full(dev, smi, tmp, 4, QLORA_STEPS)
        qlora8 = qlora_full(dev, smi, tmp, 8, QLORA_INT8_STEPS)
        lora = lora_small(dev, smi, tmp, cost)
        gemma = gemma3_dpo(dev, smi, tmp)
        gemma_gen = gemma3_generation(dev, smi, gemma['ckpt'])
        http_serving(dev, smi, gemma['ckpt'])
        shutil.rmtree(gemma['ckpt'], ignore_errors=True)
        remat = remat_sweep(dev, smi)
        saves = async_save(dev, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    log(f'done: {disk_written():.3f} GB written by the run')
    t8 = fstats['timed']['llama8b']
    vit = fstats['timed']['vit336']
    mm_ppo = fstats['timed']['ti2t_ppo']
    timed = {name: fstats['timed'][name]
             for name in ('gemma3_1b', 'gemma3_1b_w512', 'llava_next',
                          'qwen2_vl_2b', 'qwen2_audio_tower', 'qwen3_moe')}
    main_path = (dpo, harness, rm, ppo, kto, grpo, safe, variants, ti2t,
                 ti2t_sft, ti2t_rm, ti2t_ppo, ti2t_rl, anyres, tv2t,
                 lnext_small, qwen_dpo, qwen_small, ta2t_dpo, ta2t_sm,
                 mllama_dpo, mllama_sm, moe_serve, moe_train, moe_sm, qlora4,
                 qlora8, lora, gemma, gemma_gen, remat, saves)
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
                      'the whole causal square, no window; llava_next: B4 '
                      'L4096 H32 KH32 D128 causal, 2 rows padded (phase '
                      '31\'s AnyRes DPO decoder), SDPA causal, no padding; '
                      'qwen2_vl_2b: B4 L1024 H12 KH2 D128 causal, 2 rows '
                      'padded (phase 34\'s Qwen2-VL-2B DPO decoder), SDPA '
                      'causal, no padding; qwen2_audio_tower: B4 L1500 '
                      'H20 KH20 D64 full (phase 36\'s Qwen2-Audio-7B '
                      'encoder over 30 s clips), SDPA full; qwen3_moe: B2 '
                      'L1024 H32 KH4 D64 causal, 2 rows padded (phase '
                      '41\'s qwen3-moe-30b-a3b SFT decoder), SDPA causal, '
                      'no padding',
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
                             'DPO steps around two saves, small) + phase 31 '
                             '(4 AnyRes DPO steps at llava-v1.6-vicuna-7b '
                             'widths: the 23-layer tower over 20 crops twice '
                             'a step, the text at L 4096) + phase 32 (TV2T '
                             'SFT and DPO, 2 steps each, at '
                             'LLaVA-NeXT-Video-7B widths: the tower over 16 '
                             'frames a step) + phase 33 (AnyRes SFT, TV2T '
                             'RM, PPO and GRPO, small) + phase 34 (2 '
                             'Qwen2-VL DPO steps at Qwen2-VL-2B widths, text '
                             '4 layers: the trunk only, the towers run no '
                             'kernel) + phase 35 (Qwen2-VL SFT at 224 px and '
                             'dynamic, Qwen2.5-VL SFT and DPO, small) + '
                             'phase 36 (2 TA2T DPO steps at Qwen2-Audio-7B '
                             'widths, text 4 layers: the 32-layer tower '
                             'forward twice a step, frozen) + phase 37 '
                             '(TA2T SFT, RM, PPO, GRPO and SFT over a '
                             'fresh encoder, small: the towers train in '
                             'PPO and GRPO) + phase 38 (2 Mllama DPO steps '
                             'at Llama-3.2-11B-Vision widths, text 5 '
                             'layers: the 4 self-attention layers, the '
                             'tower and cross layer run no kernel) + phase '
                             '39 (Mllama SFT, KTO, ORPO and SimPO, small) '
                             '+ phase 40 (qwen3-moe-30b-a3b at 24 layers: '
                             'three prefill forwards without a cache) + '
                             'phase 41 (2 + 2 SFT steps at its widths, 4 '
                             'layers, and 22 forwards of bench.py\'s MoE '
                             'config) + phase 42 (MoE SFT, its resume and '
                             'one DPO step, small)'}
    print(json.dumps({'kernels': [{
        'name': 'int4_matmul', 'route': 'cuda',
        'source': 'align_anything_tpu_torch/csrc/int4_matmul.cu',
        'replaces': 'align_anything_tpu/ops/int4_matmul.py:124',
        'also_replaces': 'align_anything_tpu/ops/int4_matmul.py:153',
        'launches': (launches + paged['launches'] + int4_8b['launches']
                     + moe_serve['k2_launches']),
        'max_abs_err': kstats['max_abs_err'],
        'ms': kstats['ms'], 'plain_ms': kstats['plain_ms'],
        'bound_ms': kstats['bound_ms'], 'bound_by': kstats['bound_by'],
        'library_ms': kstats['library_ms'],
        'ms_is': 'one decode step at 32 slots: 4x32 layer matmuls + head; '
                 'library_ms: torch._weight_int4pack_mm',
        'launches_are': 'phase 4 (48 requests served, dense) + phase 28 '
                        '(the first 32 of them paged, on half the pool, and '
                        'with a shared prefix dense and paged) + phase 29 '
                        '(bench_int4_7b run, int4 dense and paged at 128 '
                        'slots, o flattened; int8 runs no K2) + phase 40 '
                        '(qwen3-moe-30b-a3b at 24 layers: q, k, v and the '
                        'head of 8 requests through generate and the '
                        'continuous engine, dense and paged, each '
                        'moe_impl, fp32 and bf16 compute)'}, *({
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
           for name, t in timed.items()}}, {
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
           for name, t in timed.items()}}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
