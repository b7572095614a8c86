"""Continuous-batching generation: per-request admission over a dense
per-slot KV cache.

Port of ``align_anything_tpu/generation/continuous.py`` in dense mode:

- the cache is one (L, num_slots, KH, max_len, D) tensor pair; a slot
  (decode lane) owns one row of it while its request runs;
- admission is per request: at every chunk boundary, free slots are
  refilled from the queue in one wave; the wave's prompts are right-padded
  to a bucket, prefilled in one forward per bucket, and only each prompt's
  last position is projected through the LM head (``_last_pos_logits``);
- decode advances every slot one token per step for ``chunk_steps`` steps,
  then the host fetches the chunk's tokens once and does the bookkeeping.
  Each step writes the fresh K/V of every slot in place at that slot's own
  length and attends over the cache with a length mask;
- per-request ``max_new_tokens`` and ``temperature`` (0 = greedy), EOS and
  ``max_len`` stops, and the serving-mode callbacks (``request_feed``,
  ``on_finish``, ``on_tokens``, ``should_stop``, ``idle_sleep``).

The JAX engine's TPU workarounds are left out: the 128-lane packed cache,
span buckets, the tail window and its one-hot flush, pre-sliced layer
views, and the overlapped dispatch.  Paged mode and prefix caching are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from align_anything_tpu_torch.generation.engine import GenerationConfig
from align_anything_tpu_torch.generation.sampling import sample_token
from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.utils.tools import bucket_length


@dataclasses.dataclass
class DenseState:
    """Device-side serving state of one ``generate`` call."""

    cache: transformer.KVCache   # (L, S, KH, max_len, D)
    lengths: torch.Tensor        # (S,) int64 tokens in cache
    next_logits: torch.Tensor    # (S, V) fp32 logits for the next sample
    done: torch.Tensor           # (S,) bool: finished (or empty) slot
    temps: torch.Tensor          # (S,) fp32 per-request temperature


def _mask_true_vocab(c: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """(S, V') logits -> (S, V), with ids >= true_vocab_size at -inf."""
    if c.true_vocab_size and c.true_vocab_size < c.vocab_size:
        full = torch.full((logits.shape[0], c.vocab_size), -torch.inf,
                          device=logits.device)
        full[:, :c.true_vocab_size] = logits[:, :c.true_vocab_size]
        return full
    return logits


def _last_pos_logits(params: dict, c: ModelConfig, hidden: torch.Tensor,
                     last_idx: torch.Tensor) -> torch.Tensor:
    """Head-project only each row's last prompt position.

    ``hidden``: post-final-norm (B, P, E); ``last_idx``: (B,) position of
    each row's last token.  Sampling reads only the last position, and a
    full (B, P, V) fp32 block would be GBs at vocab 128k."""
    b = hidden.shape[0]
    h_last = hidden[torch.arange(b, device=hidden.device), last_idx][:, None]
    logits = transformer._head_logits(c, params, h_last)[:, 0]
    return _mask_true_vocab(c, logits)


class ContinuousBatchingEngine:
    """Host-side scheduler over batched prefill and decode chunks.

    ``num_slots``: concurrent decode lanes; ``max_len``: per-request cap
    (prompt + generated); ``prompt_buckets``: padded prompt lengths."""

    def __init__(self, model_cfg: ModelConfig, num_slots: int = 8,
                 max_len: int = 2048,
                 prompt_buckets: tuple[int, ...] = (32, 64, 128, 256, 512,
                                                    1024)):
        transformer.check_supported(model_cfg)
        self.cfg = model_cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.prompt_buckets = tuple(b for b in prompt_buckets
                                    if b <= max_len) or (max_len,)
        self.stats: dict = {}

    def _init_state(self, device: torch.device) -> DenseState:
        c = self.cfg
        s = self.num_slots
        return DenseState(
            cache=transformer.init_cache(
                c, s, self.max_len,
                dtype=transformer.torch_dtype(c.compute_dtype), device=device),
            lengths=torch.zeros(s, dtype=torch.long, device=device),
            next_logits=torch.zeros((s, c.vocab_size), device=device),
            done=torch.ones(s, dtype=torch.bool, device=device),
            temps=torch.ones(s, device=device))

    def _prefill(self, params: dict, st: DenseState, slots: list[int],
                 prompts: list[list[int]], temps: list[float], bucket: int,
                 pad: int) -> None:
        """Prefill one bucket of an admission wave: right-padded prompts in
        one forward, their K/V copied into the slots' cache rows."""
        c = self.cfg
        dev = st.lengths.device
        b = len(slots)
        ids = np.full((b, bucket), pad, np.int64)
        mask = np.zeros((b, bucket), np.int64)
        for i, toks in enumerate(prompts):
            n = min(len(toks), bucket)
            ids[i, :n] = toks[:n]
            mask[i, :n] = 1
        ids_t = torch.as_tensor(ids, device=dev)
        mask_t = torch.as_tensor(mask, device=dev)
        cache = transformer.init_cache(c, b, bucket, dtype=st.cache.k.dtype,
                                       device=dev)
        positions = (torch.cumsum(mask_t, -1) - 1).clamp_min(0)
        out = transformer.forward(params, c, ids_t, attention_mask=mask_t,
                                  positions=positions, cache=cache,
                                  cache_offset=0, need_logits=False)
        lengths = mask_t.sum(-1)
        slot_t = torch.as_tensor(slots, device=dev)
        st.cache.k[:, slot_t, :, :bucket] = cache.k
        st.cache.v[:, slot_t, :, :bucket] = cache.v
        st.next_logits[slot_t] = _last_pos_logits(
            params, c, out.last_hidden_state, lengths - 1)
        st.lengths[slot_t] = lengths
        st.temps[slot_t] = torch.as_tensor(temps, dtype=torch.float32,
                                           device=dev)
        st.done[slot_t] = False

    def _decode_chunk(self, params: dict, st: DenseState,
                      gen_cfg: GenerationConfig, chunk_steps: int,
                      generator: torch.Generator | None, eos: int,
                      pad: int) -> torch.Tensor:
        """``chunk_steps`` decode steps over all slots; returns the sampled
        tokens (chunk_steps, S) (pad where done)."""
        c = self.cfg
        # greedy engine config: every admitted slot's temp is 0
        greedy_all = bool(gen_cfg.greedy or gen_cfg.temperature == 0.0)
        toks = []
        for _ in range(chunk_steps):
            if greedy_all:
                tok = st.next_logits.argmax(-1)
            else:
                scaled = st.next_logits / st.temps.clamp_min(1e-6)[:, None]
                sampled = sample_token(scaled, generator, temperature=1.0,
                                       top_k=gen_cfg.top_k,
                                       top_p=gen_cfg.top_p)
                tok = torch.where(st.temps <= 0.0,
                                  st.next_logits.argmax(-1), sampled)
            tok = torch.where(st.done, pad, tok)
            live = ~st.done
            # finished slots keep computing at a clamped, unread position
            pos = st.lengths.clamp(max=self.max_len - 1)
            out = transformer.forward(params, c, tok[:, None],
                                      positions=pos[:, None], cache=st.cache,
                                      cache_offset=pos)
            st.next_logits = _mask_true_vocab(c, out.logits[:, 0])
            st.done = st.done | (tok == eos) | (st.lengths + 1 >= self.max_len)
            st.lengths = st.lengths + live.to(torch.long)
            toks.append(tok)
        return torch.stack(toks)

    @torch.no_grad()
    def generate(self, params: dict, requests: list,
                 gen_cfg: GenerationConfig,
                 generator: torch.Generator | None = None,
                 chunk_steps: int = 8, request_feed=None, on_finish=None,
                 on_tokens=None, should_stop=None,
                 idle_sleep: float = 0.005) -> list[list[int]]:
        """Generate completions for every request.

        A request is a token-id list, or a dict ``{'input_ids': [...],
        'max_new_tokens': n, 'temperature': t}`` (both keys optional).
        Finished slots refill from the queue at chunk boundaries while the
        other slots keep decoding.

        Serving mode (``request_feed`` given): at every chunk boundary
        ``request_feed()`` is drained into the queue; each item is
        ``(rid, request)``.  ``on_finish(rid, tokens)`` fires as each
        request completes, ``on_tokens(rid, new_tokens)`` streams each
        chunk's fresh tokens, the loop idles ``idle_sleep`` seconds when no
        slot is live and returns once ``should_stop()`` is true."""
        c = self.cfg
        pad = (gen_cfg.pad_token_id if gen_cfg.pad_token_id is not None
               else c.pad_token_id)
        eos = (gen_cfg.eos_token_id if gen_cfg.eos_token_id is not None
               else c.eos_token_id)
        default_temp = (0.0 if (gen_cfg.greedy or gen_cfg.temperature == 0.0)
                        else gen_cfg.temperature)
        st = self._init_state(params['embedding'].device)
        queue = deque(enumerate(requests))
        slot_req: list[int | None] = [None] * self.num_slots
        slot_budget = [0] * self.num_slots
        outputs: dict[int, list[int]] = {}
        admit_step: dict[int, int] = {}
        finish_step: dict[int, int] = {}
        step_count = 0

        def request_of(req):
            if not isinstance(req, dict):
                return req, gen_cfg.max_new_tokens, default_temp
            return (req['input_ids'],
                    req.get('max_new_tokens', gen_cfg.max_new_tokens),
                    float(req.get('temperature', default_temp)))

        def admit():
            if request_feed is not None:
                queue.extend(request_feed())
            by_bucket: dict[int, list] = {}
            for slot in range(self.num_slots):
                if slot_req[slot] is not None or not queue:
                    continue
                rid, req = queue.popleft()
                prompt, budget, temp = request_of(req)
                bucket = bucket_length(len(prompt), self.prompt_buckets)
                by_bucket.setdefault(bucket, []).append((slot, prompt, temp))
                slot_req[slot] = rid
                slot_budget[slot] = budget
                outputs[rid] = []
                admit_step[rid] = step_count
            for bucket, group in by_bucket.items():
                self._prefill(params, st, [g[0] for g in group],
                              [g[1] for g in group], [g[2] for g in group],
                              bucket, pad)

        def process(toks: np.ndarray, done: np.ndarray):
            nonlocal step_count
            step_count += toks.shape[0]
            finished = []
            for slot in range(self.num_slots):
                rid = slot_req[slot]
                if rid is None:
                    continue
                n_before = len(outputs[rid])
                for t in toks[:, slot]:
                    if slot_budget[slot] <= 0:
                        break
                    if int(t) == pad and outputs[rid] and done[slot]:
                        break
                    outputs[rid].append(int(t))
                    slot_budget[slot] -= 1
                    if int(t) == eos:
                        break
                if on_tokens is not None and len(outputs[rid]) > n_before:
                    on_tokens(rid, outputs[rid][n_before:])
                if done[slot] or slot_budget[slot] <= 0:
                    finished.append(slot)
                    finish_step[rid] = step_count
                    slot_req[slot] = None
                    if on_finish is not None:
                        on_finish(rid, _trim_eos(outputs[rid], eos))
                    if request_feed is not None:
                        # serving: prune per-request state
                        outputs.pop(rid, None)
                        admit_step.pop(rid, None)
                        finish_step.pop(rid, None)
            if finished:
                st.done[torch.as_tensor(finished, device=st.done.device)] = True
            admit()

        admit()
        while True:
            if all(r is None for r in slot_req):
                if request_feed is None or (should_stop is not None
                                            and should_stop()):
                    break
                time.sleep(idle_sleep)
                admit()
                continue
            toks = self._decode_chunk(params, st, gen_cfg, chunk_steps,
                                      generator, eos, pad)
            # one host fetch per chunk
            host = torch.cat([toks, st.done[None].to(toks.dtype)]).cpu().numpy()
            process(host[:-1], host[-1].astype(bool))

        self.stats = {'admit_step': admit_step, 'finish_step': finish_step,
                      'total_steps': step_count}
        return [_trim_eos(outputs.get(rid, []), eos)
                for rid in range(len(requests))]


def _trim_eos(toks: list[int], eos: int) -> list[int]:
    if eos in toks:
        return toks[:toks.index(eos) + 1]
    return list(toks)
