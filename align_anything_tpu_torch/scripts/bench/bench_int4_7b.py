"""Llama-3-8B decode on one H100 through quantized weights: the Hopper port
of ``scripts/bench/bench_int4_7b.py``.

    python -m align_anything_tpu_torch.scripts.bench.bench_int4_7b \
        [--mode int4|int8|both] [--slots 128] [--cache_mode dense|paged]

Geometry: Llama-3-8B (vocab 128256, hidden 4096, 32 layers, GQA kv 8, mlp
14336, untied head) with random weights from a seed: the measurement is
decode throughput and memory, not quality.  The weights are drawn already
quantized, layer by layer on the card, so the fp model is never held.

Two modes through the continuous batching engine, both with an
int8-COMPUTE head (a dequantized bf16 head would be a 1 GB transient per
decode step at vocab 128256):

- int4: group-64 int4 weight-only layers (the bnb ``load_in_4bit``
  analog), q/k/v and gate/up fused, ``o`` stored with its (h, d)
  contraction flattened so that the int4 kernel K2 takes it;
- int8: int8-COMPUTE layers (activations quantized per row, the int8 x
  int8 -> int32 product, ``transformer.int8_product``).

One JSON line per mode: generated tokens/s of a second ``generate`` call
(the first is the warm-up), the slots, the weights and the KV cache in GB,
their sum as the analytic resident floor (``hbm_resident_gb``), and the
allocator's in-use and peak GB.  It runs on the card (it raises without
one); ``run(..., tiny=True, device='cpu')`` runs a toy geometry anywhere.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from align_anything_tpu_torch.generation import (ContinuousBatchingEngine,
                                                 GenerationConfig)
from align_anything_tpu_torch.models import llama_config
from align_anything_tpu_torch.models.quantization import (_fuse_int4,
                                                          quantize_int4,
                                                          quantize_int8,
                                                          quantized_bytes)
from align_anything_tpu_torch.scripts.bench.timing_utils import kv_gb
from align_anything_tpu_torch.utils.tools import default_device

# per-layer weight shapes and contraction axes for the Llama geometry (the
# leading layer dim is added by stacking)
_LAYER_SHAPES = {
    'q': (lambda c: (c.hidden_size, c.num_heads, c.head_dim), (0,)),
    'k': (lambda c: (c.hidden_size, c.num_kv_heads, c.head_dim), (0,)),
    'v': (lambda c: (c.hidden_size, c.num_kv_heads, c.head_dim), (0,)),
    'o': (lambda c: (c.num_heads, c.head_dim, c.hidden_size), (0, 1)),
    'up': (lambda c: (c.hidden_size, c.mlp_dim), (0,)),
    'gate': (lambda c: (c.hidden_size, c.mlp_dim), (0,)),
    'down': (lambda c: (c.mlp_dim, c.hidden_size), (0,)),
}
MAX_LEN = 256


@torch.no_grad()
def init_params_quantized(cfg, generator: torch.Generator, mode: str,
                          group_size: int = 64,
                          device: torch.device | str | None = None) -> dict:
    """An already-quantized decoder tree, never holding the fp model: each
    layer weight is drawn in bf16 on ``device`` (``generator`` lives there),
    quantized there, and only the int values and scales are kept."""
    device = default_device(device)
    n = cfg.num_layers

    def draw(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.bfloat16) * (1.0 / np.sqrt(fan_in)))

    layers = {
        'attn_norm': {'w': torch.ones((n, cfg.hidden_size), device=device)},
        'mlp_norm': {'w': torch.ones((n, cfg.hidden_size), device=device)},
    }
    for name, (shape_fn, axes) in _LAYER_SHAPES.items():
        shape = shape_fn(cfg)
        if name == 'o' and mode == 'int4':
            # o with its (h, d) contraction flattened: its groups run over
            # the whole contraction, so K2 takes it (_wmm reshapes)
            shape = (shape[0] * shape[1], shape[2])
            axes = (0,)
        fan_in = int(np.prod([shape[a] for a in axes]))
        vals, scales = [], []
        for _ in range(n):
            w = draw(shape, fan_in)
            qw = (quantize_int4(w, axes, group_size) if mode == 'int4'
                  else quantize_int8(w, axes))
            vals.append(qw.values)
            scales.append(qw.scales)
            del w
        # compute=True in both modes: int4 runs K2, int8 the int8 product
        layers[name] = {'w': type(qw)(values=torch.stack(vals),
                                      scales=torch.stack(scales),
                                      compute=True)}
    if mode == 'int4':
        # fused qkv / gate_up leaves: one K2 call instead of three
        layers['qkv'] = {'w': _fuse_int4([layers.pop(k)['w']
                                          for k in ('q', 'k', 'v')])}
        layers['gate_up'] = {'w': _fuse_int4([layers.pop(k)['w']
                                              for k in ('gate', 'up')])}
    emb = torch.randn((cfg.vocab_size, cfg.hidden_size), generator=generator,
                      device=device, dtype=torch.bfloat16) * 0.02
    head = draw((cfg.hidden_size, cfg.vocab_size), cfg.hidden_size)
    head_q = quantize_int8(head, (0,), compute=True)
    del head
    return {
        'embedding': emb,
        'layers': layers,
        'final_norm': {'w': torch.ones((cfg.hidden_size,), device=device)},
        'lm_head': head_q,
    }


def mem_stats(device: torch.device) -> dict:
    """The allocator's in-use and peak GiB on a CUDA device (none on the
    CPU)."""
    if device.type != 'cuda':
        return {}
    _, total = torch.cuda.mem_get_info(device)
    return {'bytes_in_use_gb': round(torch.cuda.memory_allocated(device)
                                     / 2**30, 2),
            'peak_bytes_gb': round(torch.cuda.max_memory_allocated(device)
                                   / 2**30, 2),
            'limit_gb': round(total / 2**30, 2)}


def run(mode: str, tiny: bool = False, slots: int = 128,
        cache_mode: str = 'dense',
        device: torch.device | str | None = None,
        n_requests: int | None = None) -> dict:
    """Build the quantized model, serve ``n_requests`` (default
    ``2 * slots``) requests of 120 prompt and 64 new tokens twice through
    the continuous engine, and time the second call."""
    device = default_device(device)
    if tiny:  # a smoke of the full path (quantized init -> engine)
        # special tokens inside the toy vocab: the engine embeds the pad
        # token for finished slots (JAX clamps an id past the vocab)
        cfg = llama_config(vocab_size=512, hidden=128, layers=2, heads=4,
                           kv_heads=2, mlp=256, max_pos=512).replace(
            bos_token_id=1, eos_token_id=2, pad_token_id=0)
    else:
        cfg = llama_config()
    cfg = cfg.replace(compute_dtype='bfloat16', attention_impl='auto')
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = init_params_quantized(
        cfg, torch.Generator(device=device).manual_seed(0), mode,
        device=device)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0

    # 128 lanes: the JAX script's default, a v5e sweep's peak (the lane
    # count has not been swept on the card)
    n_req, prompt_len, new = n_requests or 2 * slots, 120, 64
    if tiny:
        n_req, slots, prompt_len, new = 4, 32, 24, 8
    rng = np.random.default_rng(0)
    reqs = [{'input_ids': rng.integers(
                 5, cfg.vocab_size - 1, size=prompt_len).tolist(),
             'max_new_tokens': new} for _ in range(n_req)]
    gen = GenerationConfig(max_new_tokens=new, greedy=True, eos_token_id=-1)
    eng = ContinuousBatchingEngine(cfg, num_slots=slots, max_len=MAX_LEN,
                                   prompt_buckets=(32 if tiny else 128,),
                                   cache_mode=cache_mode)

    def call(seed: int) -> tuple[list, float]:
        t0 = time.perf_counter()
        outs = eng.generate(params, reqs, gen,
                            torch.Generator(device=device).manual_seed(seed),
                            chunk_steps=32)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        return outs, time.perf_counter() - t0

    _, first_s = call(1)
    outs, dt = call(2)
    got = sum(len(o) for o in outs)
    weights_gb = round(quantized_bytes(params) / 2**30, 2)
    kv = kv_gb(cfg, slots, MAX_LEN)
    return {
        'mode': mode,
        'cache_mode': cache_mode,
        'tokens_per_sec': round(got / dt, 1),
        'tokens': got,
        'requests': n_req,
        'new_tokens': new,
        'outputs': outs,
        'lanes': slots,
        'decode_s': round(dt, 3),
        'weights_gb': weights_gb,
        'kv_gb': kv,
        # the analytic resident floor: weights and the KV cache; the
        # allocator's peak adds each step's transients
        'hbm_resident_gb': round(weights_gb + kv, 2),
        'model_params_b': 8.0,
        'init_s': round(init_s, 1),
        'first_call_s': round(first_s, 1),
        'device': (torch.cuda.get_device_name(device)
                   if device.type == 'cuda' else 'cpu'),
        **mem_stats(device),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--mode', default='both',
                    choices=('int4', 'int8', 'both'))
    ap.add_argument('--slots', type=int, default=128)
    ap.add_argument('--cache_mode', default='dense',
                    choices=('dense', 'paged'))
    ap.add_argument('--tiny', action='store_true',
                    help='toy geometry (a smoke of the path)')
    args = ap.parse_args()
    modes = ('int4', 'int8') if args.mode == 'both' else (args.mode,)
    for mode in modes:
        # int8 weights hold about twice int4's bytes: the JAX script caps
        # the lanes at 64 to keep its chip's memory
        slots = min(args.slots, 64) if mode == 'int8' else args.slots
        # one mode's failure (an out-of-memory) is reported, the other runs
        try:
            r = run(mode, tiny=args.tiny, slots=slots,
                    cache_mode=args.cache_mode)
            r.pop('outputs')
            print(json.dumps(r))
        except Exception as e:  # noqa: BLE001
            print(json.dumps({'mode': mode, 'status': 'failed',
                              'error': repr(e)[:300]}))


if __name__ == '__main__':
    main()
