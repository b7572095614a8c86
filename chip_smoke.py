#!/usr/bin/env python3
"""Smoke run of the PyTorch port (align_anything_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one H100

Phases (any failure raises and the run exits non-zero):
  0. require a CUDA device; print the card's name and power limit;
  1. build the hand-written kernels from csrc/ with nvcc (sm_90a);
  2. hold the int4 matmul kernel against its plain PyTorch version at the
     serving path's shapes (Llama-3-8B widths) and time both;
  3. build Llama-3-8B-geometry int4-COMPUTE weights on the card from a seed,
     layer by layer, without holding the fp model;
  4. serve ~48 requests through the continuous-batching engine's serving
     mode in a worker thread, as the HTTP server's worker does; check every
     request's budget, the kernel's launch count, and one decode step
     against the plain int4 path.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit from nvidia-smi, and the one before that a
JSON summary of each kernel.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
from collections import deque
from unittest import mock

import numpy as np
import torch

import align_anything_tpu_torch
from align_anything_tpu_torch.generation import (ContinuousBatchingEngine,
                                                 GenerationConfig)
from align_anything_tpu_torch.models import llama_config, transformer
from align_anything_tpu_torch.models import quantization as q
from align_anything_tpu_torch.ops import int4_matmul as k2

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


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (decode finds its weights cold: they are 100x the L2)."""
    fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def check_kernel(dev) -> dict:
    """Phase 2: kernel against plain at every serving shape."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    worst = 0.0
    step_ms = {'kernel': 0.0, 'plain': 0.0}
    n_layers = llama_config().num_layers
    for name, k, n in SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev,
                        dtype=torch.bfloat16) * (k ** -0.5)
        qw = q.quantize_int4(w, (0,), group_size=GROUP, compute=True)
        del w
        g = k // GROUP
        vals, sc = qw.values, qw.scales.reshape(g, n)
        for m in (1, 32, 128):
            x = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            for dtype in (torch.bfloat16, torch.float32):
                got = k2.int4_matmul_cuda(x, vals, sc, dtype).float()
                ref = k2.int4_matmul_reference(x, vals, sc, dtype).float()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                scale = float(ref.abs().max())
                tol = TOL[str(dtype).split('.')[-1]]
                ok = bool(torch.isfinite(got).all()) and err <= tol * scale
                kms = time_ms(lambda: k2.int4_matmul_cuda(
                    x, vals, sc, dtype), 10, flush)
                pms = time_ms(lambda: k2.int4_matmul_reference(
                    x, vals, sc, dtype), 3, flush)
                log(f'phase2 {name:8s} M={m:<4d} K={k:<6d} N={n:<7d} '
                    f'out={str(dtype)[6:]:9s} max_abs_err={err:.3e} '
                    f'max|plain|={scale:.3e} tol={tol:g} '
                    f'kernel_ms={kms:.4f} plain_ms={pms:.4f} '
                    f'{"ok" if ok else "FAIL"}')
                if not ok:
                    raise AssertionError(
                        f'int4 kernel disagrees at {name} M={m} {dtype}')
                worst = max(worst, err)
                # one decode step at 32 slots: 32 layers' bf16 matmuls and
                # the fp32-out head
                if m == DECODE_SLOTS and (
                        (name == 'head') == (dtype == torch.float32)):
                    reps = 1 if name == 'head' else n_layers
                    step_ms['kernel'] += reps * kms
                    step_ms['plain'] += reps * pms
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
    log(f'phase2 one decode step (32 slots, 4x32 layer matmuls + head): '
        f'kernel_ms={step_ms["kernel"]:.3f} plain_ms={step_ms["plain"]:.3f}')
    return {'max_abs_err': worst, 'ms': step_ms['kernel'],
            'plain_ms': step_ms['plain']}


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

    t0 = time.perf_counter()
    k2.build()
    log(f'phase1 built int4_matmul in {time.perf_counter() - t0:.1f} s')
    for line in k2.build_log.splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'phase1 ptxas: {line.strip()}')

    kstats = check_kernel(dev)

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

    print(json.dumps({'kernels': [{
        'name': 'int4_matmul', 'route': 'cuda',
        'source': 'align_anything_tpu_torch/csrc/int4_matmul.cu',
        'replaces': 'align_anything_tpu/ops/int4_matmul.py:124',
        'also_replaces': 'align_anything_tpu/ops/int4_matmul.py:153',
        'launches': launches, 'max_abs_err': kstats['max_abs_err'],
        'ms': kstats['ms'], 'plain_ms': kstats['plain_ms'],
        'ms_is': 'one decode step at 32 slots: 4x32 layer matmuls + head'}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
