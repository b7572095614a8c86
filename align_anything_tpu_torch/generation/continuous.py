"""Continuous-batching generation: per-request admission over a dense
per-slot KV cache or a pool of pages, with an optional shared-prefix cache.

Port of ``align_anything_tpu/generation/continuous.py``:

- ``cache_mode='dense'``: the cache is one (L, num_slots, KH, max_len, D)
  tensor pair; a slot (decode lane) owns one row of it while its request
  runs.  Admission waves are right-padded to a bucket and prefilled in one
  forward per bucket;
- ``cache_mode='paged'``: a pool of pages (L, KH, num_pages, page_size, D)
  with a page table (num_slots, max_pages) per call.  Pages are taken from
  a free list at admission (``ceil(prompt / ps) + ceil(budget / ps) + 1``,
  capped at max_pages), returned at finish, and admission waits for the
  next chunk boundary when the pool runs short, so memory follows the live
  tokens.  Page 0 is a sink: the writes of finished slots land there, and
  attention never reads it unmasked.  Each request prefills on its own and
  its K/V scatter into its pages;
- decode advances every slot one token per step for ``chunk_steps`` steps,
  then the host fetches the chunk's tokens once and does the bookkeeping.
  Only each prompt's last position is projected through the LM head
  (``_last_pos_logits``);
- ``register_prefix``: a shared prompt prefix (a system prompt) prefilled
  once; a request that starts with it prefills only its tail, attending
  over the prefix K/V (``transformer.forward`` with a static
  ``cache_offset``).  Dense mode caches ``len(prefix) - 1`` tokens; paged
  mode a page-aligned span whose pages are reserved at the head of every
  call's pool and shared read-only by the slots that use it;
- per-request ``max_new_tokens`` and ``temperature`` (0 = greedy), EOS and
  ``max_len`` stops, and the serving-mode callbacks (``request_feed``,
  ``on_finish``, ``on_tokens``, ``should_stop``, ``idle_sleep``).

The JAX engine's TPU workarounds are left out: the 128-lane packed cache
and page rows (so a dense prefix needs no pack alignment), span buckets,
the tail window and its one-hot flush, pre-sliced layer views, the
power-of-two padding of admission waves, ``chunk_capacity`` and the
overlapped dispatch (the port's admission steps are JAX's with
``overlap=False``).
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


def _gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(KH, P, ps, D), (S, MP) -> (S, KH, MP * ps, D)."""
    kh, _, ps, d = pages.shape
    s, mp = tables.shape
    return pages[:, tables].transpose(0, 1).reshape(s, kh, mp * ps, d)


def _scatter_token(pages: torch.Tensor, tables: torch.Tensor,
                   lengths: torch.Tensor, new: torch.Tensor,
                   live: torch.Tensor) -> None:
    """Write one token's K or V per slot into its page, in place.

    pages (KH, P, ps, D); new (S, KH, D), each at its slot's position
    ``lengths``.  A finished slot's table may name pages that now belong to
    another slot, so its row goes to the sink page 0; its length may run
    one page past the table, so the page index is clamped (JAX clamps
    without a word)."""
    ps, mp = pages.shape[2], tables.shape[1]
    rows = torch.arange(tables.shape[0], device=tables.device)
    page = tables[rows, (lengths // ps).clamp(max=mp - 1)]
    page = torch.where(live, page, 0)
    pages[:, page, lengths % ps] = new.transpose(0, 1).to(pages.dtype)


def _paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, window: int | None = None
                     ) -> torch.Tensor:
    """q (S, 1, H, D); k/v (S, KH, T, D); lengths (S,) valid keys per slot,
    the query at position lengths - 1.  ``window``: a sliding layer's, keys
    ``window`` or more positions behind the query are masked."""
    t = torch.arange(k.shape[2], device=k.device)[None]
    mask = t < lengths[:, None]                        # (S, T)
    if window is not None:
        mask = mask & ((lengths[:, None] - 1 - t) < window)
    return transformer._masked_attention(q, k, v, mask[:, None, None, :])


@dataclasses.dataclass
class PagedLayer:
    """One layer of the page pool at one decode step: the decoder hands it
    the step's q, k, v (``transformer._decoder_layer``)."""

    k: torch.Tensor           # (KH, P, ps, D)
    v: torch.Tensor
    tables: torch.Tensor      # (S, MP)
    lengths: torch.Tensor     # (S,) tokens in cache before this step
    live: torch.Tensor        # (S,) bool

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int | None) -> torch.Tensor:
        """Write this step's k/v (S, 1, KH, D) at each slot's length, then
        attend over the slot's pages up to and including it."""
        _scatter_token(self.k, self.tables, self.lengths, k[:, 0], self.live)
        _scatter_token(self.v, self.tables, self.lengths, v[:, 0], self.live)
        ku = _gather_pages(self.k, self.tables).to(q.dtype)
        vu = _gather_pages(self.v, self.tables).to(q.dtype)
        return _paged_attention(q, ku, vu, self.lengths + 1, window)


@dataclasses.dataclass
class PagedCache:
    """The page pool of one ``generate`` call, and its page tables."""

    k: torch.Tensor                       # (L, KH, P, ps, D)
    v: torch.Tensor
    tables: torch.Tensor                  # (S, MP) int64; 0 = sink page
    lengths: torch.Tensor | None = None   # set per decode step by ``step``
    live: torch.Tensor | None = None

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_len(self) -> int:
        return self.tables.shape[1] * self.page_size

    def step(self, lengths: torch.Tensor, live: torch.Tensor) -> 'PagedCache':
        """The pool as one decode step sees it."""
        return dataclasses.replace(self, lengths=lengths, live=live)

    def layer(self, li: int) -> PagedLayer:
        return PagedLayer(self.k[li], self.v[li], self.tables, self.lengths,
                          self.live)


@dataclasses.dataclass
class ServingState:
    """Device-side serving state of one ``generate`` call."""

    cache: transformer.KVCache | PagedCache
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


def _padded(rows: list[list[int]], bucket: int, pad: int,
            dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-padded (B, bucket) ids and mask; longer rows are cut."""
    ids = np.full((len(rows), bucket), pad, np.int64)
    mask = np.zeros((len(rows), bucket), np.int64)
    for i, toks in enumerate(rows):
        n = min(len(toks), bucket)
        ids[i, :n] = toks[:n]
        mask[i, :n] = 1
    return torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)


class ContinuousBatchingEngine:
    """Host-side scheduler over batched prefill and decode chunks.

    ``num_slots``: concurrent decode lanes; ``page_size`` / ``num_pages``:
    the paged pool (default ``1 + num_slots * max_pages``, page 0 the
    sink); ``max_len``: per-request cap (prompt + generated);
    ``prompt_buckets``: padded prompt lengths."""

    def __init__(self, model_cfg: ModelConfig, num_slots: int = 8,
                 page_size: int = 16, num_pages: int | None = None,
                 max_len: int = 2048,
                 prompt_buckets: tuple[int, ...] = (32, 64, 128, 256, 512,
                                                    1024),
                 cache_mode: str = 'dense'):
        transformer.check_supported(model_cfg)
        if cache_mode not in ('dense', 'paged'):
            raise ValueError(f'cache_mode {cache_mode!r}: dense or paged')
        self.cfg = model_cfg
        self.cache_mode = cache_mode
        self.num_slots = num_slots
        self.page_size = page_size
        self.max_pages_per_slot = -(-max_len // page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else 1 + num_slots * self.max_pages_per_slot)
        self.max_len = max_len
        self.prompt_buckets = tuple(b for b in prompt_buckets
                                    if b <= max_len) or (max_len,)
        self.stats: dict = {}
        self._prefix: dict | None = None          # see register_prefix

    @property
    def _dtype(self) -> torch.dtype:
        return transformer.torch_dtype(self.cfg.compute_dtype)

    def _init_state(self, device: torch.device) -> ServingState:
        c = self.cfg
        s = self.num_slots
        if self.cache_mode == 'dense':
            cache = transformer.init_cache(c, s, self.max_len,
                                           dtype=self._dtype, device=device)
        else:
            shape = (c.num_layers, c.num_kv_heads, self.num_pages,
                     self.page_size, c.head_dim)
            cache = PagedCache(
                k=torch.zeros(shape, dtype=self._dtype, device=device),
                v=torch.zeros(shape, dtype=self._dtype, device=device),
                tables=torch.zeros((s, self.max_pages_per_slot),
                                   dtype=torch.long, device=device))
        return ServingState(
            cache=cache,
            lengths=torch.zeros(s, dtype=torch.long, device=device),
            next_logits=torch.zeros((s, c.vocab_size), device=device),
            done=torch.ones(s, dtype=torch.bool, device=device),
            temps=torch.ones(s, device=device))

    # -- prefix cache ------------------------------------------------------

    @torch.no_grad()
    def register_prefix(self, params: dict, prefix_ids: list[int]) -> None:
        """Prefill a shared prompt prefix once and reuse its K/V for every
        admitted request whose prompt starts with it.

        The cached span is strictly shorter than the prefix, so every
        request still prefills at least one tail token: ``len - 1`` tokens
        in dense mode, whole pages in paged mode, where the pages
        [1, n_pages] are reserved at the head of every call's pool."""
        c = self.cfg
        paged = self.cache_mode == 'paged'
        align = self.page_size if paged else 1
        cached = ((len(prefix_ids) - 1) // align) * align
        if cached <= 0:
            raise ValueError('prefix too short to cache (needs more than '
                             f'{align} tokens)')
        dev = params['embedding'].device
        ids = torch.as_tensor([prefix_ids[:cached]], device=dev)
        cache = transformer.init_cache(c, 1, cached, dtype=self._dtype,
                                       device=dev)
        transformer.forward(params, c, ids,
                            attention_mask=torch.ones_like(ids),
                            positions=torch.arange(cached, device=dev)[None],
                            cache=cache, cache_offset=0, need_logits=False)
        prefix = {'ids': tuple(int(t) for t in prefix_ids[:cached]),
                  'len': cached, 'k': cache.k, 'v': cache.v}
        if paged:
            n_pages = cached // self.page_size
            if n_pages >= self.num_pages - self.num_slots:
                self._prefix = None
                raise ValueError('prefix occupies the whole page pool')
            prefix['pages'] = list(range(1, n_pages + 1))
            # (L, KH, n_pages, ps, D), written into each call's pool
            shape = (c.num_layers, c.num_kv_heads, n_pages, self.page_size,
                     c.head_dim)
            prefix['k_paged'] = cache.k[:, 0].reshape(shape)
            prefix['v_paged'] = cache.v[:, 0].reshape(shape)
        self._prefix = prefix

    def _uses_prefix(self, prompt: list[int]) -> bool:
        """JAX's match rule: the prompt extends the cached span, and the
        span plus the tail's bucket fits ``max_len`` (paged: the prefix
        leaves a page of the table for the tail)."""
        pre = self._prefix
        if (pre is None or len(prompt) <= pre['len']
                or tuple(prompt[:pre['len']]) != pre['ids']):
            return False
        if pre['len'] + bucket_length(len(prompt) - pre['len'],
                                      self.prompt_buckets) > self.max_len:
            return False
        return (self.cache_mode == 'dense'
                or len(pre['pages']) < self.max_pages_per_slot)

    # -- prefill -----------------------------------------------------------

    def _admitted(self, params: dict, st: ServingState, slots: list[int],
                  hidden: torch.Tensor, last_idx: torch.Tensor,
                  lengths: torch.Tensor, temps: list[float]) -> None:
        """Set the admitted slots' next logits, lengths and temperatures."""
        slot_t = torch.as_tensor(slots, device=st.lengths.device)
        st.next_logits[slot_t] = _last_pos_logits(params, self.cfg, hidden,
                                                  last_idx)
        st.lengths[slot_t] = lengths
        st.temps[slot_t] = torch.as_tensor(temps, dtype=torch.float32,
                                           device=st.lengths.device)
        st.done[slot_t] = False

    def _prefill_local(self, params: dict, rows: list[list[int]],
                       bucket: int, pad: int, cached: int, dev):
        """One forward of right-padded rows into a local (rows, cached +
        bucket) cache.  A row is a whole prompt, or with ``cached`` > 0 the
        tail after the prefix: the prefix K/V sit at [0, cached) and the
        tails attend over them through the cache write at the static
        offset ``cached``.  Returns (cache, last hidden states, row
        lengths)."""
        ids, mask = _padded(rows, bucket, pad, dev)
        cache = transformer.init_cache(self.cfg, len(rows), cached + bucket,
                                       dtype=self._dtype, device=dev)
        if cached:
            cache.k[:, :, :, :cached] = self._prefix['k']
            cache.v[:, :, :, :cached] = self._prefix['v']
        positions = cached + (torch.cumsum(mask, -1) - 1).clamp_min(0)
        # slot-space mask over the local cache: the prefix all valid, the
        # tail where the (right-padded) row has tokens
        attn_mask = torch.cat([torch.ones_like(mask[:, :1]).expand(
            -1, cached), mask], -1)
        out = transformer.forward(params, self.cfg, ids,
                                  attention_mask=attn_mask,
                                  positions=positions, cache=cache,
                                  cache_offset=cached, need_logits=False)
        return cache, out.last_hidden_state, mask.sum(-1)

    def _prefill_dense(self, params: dict, st: ServingState,
                       slots: list[int], rows: list[list[int]],
                       temps: list[float], bucket: int, pad: int,
                       cached: int = 0) -> None:
        """Prefill one bucket of an admission wave in one forward and copy
        its K/V into the slots' cache rows; ``cached`` is the prefix span
        the rows extend (0 without a prefix)."""
        dev = st.lengths.device
        cache, hidden, n = self._prefill_local(params, rows, bucket, pad,
                                               cached, dev)
        slot_t = torch.as_tensor(slots, device=dev)
        st.cache.k[:, slot_t, :, :cached + bucket] = cache.k
        st.cache.v[:, slot_t, :, :cached + bucket] = cache.v
        self._admitted(params, st, slots, hidden, n - 1, cached + n, temps)

    def _scatter_prompt(self, st: ServingState, cache: transformer.KVCache,
                        start: int, n: int, pages: list[int]) -> None:
        """Copy the local cache's positions [start, start + n) of row 0
        into the pages of a table ``pages``: position t goes to page
        ``pages[t // ps]`` at row ``t % ps``.  The caller keeps
        ``start + n <= max_len``, so every index is in range."""
        dev = st.lengths.device
        ps = self.page_size
        t = torch.arange(start, start + n, device=dev)
        page = torch.as_tensor(pages, device=dev)[t // ps]
        # (L, KH, n, D) into the pool's (L, KH, [page], [row], D)
        st.cache.k[:, :, page, t % ps] = cache.k[:, 0, :, start:start + n]
        st.cache.v[:, :, page, t % ps] = cache.v[:, 0, :, start:start + n]

    def _prefill_paged(self, params: dict, st: ServingState, slot: int,
                       row: list[int], pages: list[int], temp: float,
                       bucket: int, pad: int, cached: int = 0) -> None:
        """Prefill one request (1, bucket) and scatter its K/V into
        ``pages`` (max_pages page ids for the slot, 0 past its need).  With
        a prefix, ``row`` is the tail and ``pages`` starts with the shared
        prefix pages, which are not written."""
        dev = st.lengths.device
        cache, hidden, n = self._prefill_local(params, [row], bucket, pad,
                                               cached, dev)
        self._scatter_prompt(st, cache, cached, min(len(row), bucket), pages)
        st.cache.tables[slot] = torch.as_tensor(pages, device=dev)
        self._admitted(params, st, [slot], hidden, n - 1, cached + n, [temp])

    # -- decode ------------------------------------------------------------

    def _decode_chunk(self, params: dict, st: ServingState,
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
            # (paged: their writes go to the sink page)
            pos = st.lengths.clamp(max=self.max_len - 1)
            cache = (st.cache if self.cache_mode == 'dense'
                     else st.cache.step(st.lengths, live))
            out = transformer.forward(params, c, tok[:, None],
                                      positions=pos[:, None], cache=cache,
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
        paged = self.cache_mode == 'paged'
        ps, mp = self.page_size, self.max_pages_per_slot
        pad = (gen_cfg.pad_token_id if gen_cfg.pad_token_id is not None
               else c.pad_token_id)
        eos = (gen_cfg.eos_token_id if gen_cfg.eos_token_id is not None
               else c.eos_token_id)
        default_temp = (0.0 if (gen_cfg.greedy or gen_cfg.temperature == 0.0)
                        else gen_cfg.temperature)
        st = self._init_state(params['embedding'].device)
        pre = self._prefix
        first_free = 1
        if paged and pre is not None:
            # the shared prefix K/V live in the reserved head pages of every
            # call's pool (the pool is per call)
            n = len(pre['pages'])
            st.cache.k[:, :, 1:1 + n] = pre['k_paged']
            st.cache.v[:, :, 1:1 + n] = pre['v_paged']
            first_free = 1 + n
        free_pages = deque(range(first_free, self.num_pages))
        queue = deque(enumerate(requests))
        slot_req: list[int | None] = [None] * self.num_slots
        slot_pages: list[list[int]] = [[] for _ in range(self.num_slots)]
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

        def take_pages(need: int) -> list[int] | None:
            if len(free_pages) < need:
                return None
            return [free_pages.popleft() for _ in range(need)]

        def admit_paged(slot: int, prompt: list[int], budget: int,
                        temp: float) -> bool:
            """Take the request's pages and prefill it; False when the pool
            is short (admission retries at the next chunk boundary)."""
            if self._uses_prefix(prompt):
                tail = prompt[pre['len']:]
                got = take_pages(min(-(-len(tail) // ps) + -(-budget // ps)
                                     + 1, mp - len(pre['pages'])))
                if got is None:
                    return False
                pages = pre['pages'] + got
                # only the tail pages return to the pool at finish: the
                # prefix pages are shared
                slot_pages[slot] = got
                cached = pre['len']
            else:
                tail = prompt
                got = take_pages(min(-(-len(prompt) // ps)
                                     + -(-budget // ps) + 1, mp))
                if got is None:
                    return False
                pages = got
                slot_pages[slot] = got
                cached = 0
            self._prefill_paged(params, st, slot, tail,
                                pages + [0] * (mp - len(pages)), temp,
                                bucket_length(len(tail), self.prompt_buckets),
                                pad, cached)
            return True

        def admit_dense(wave: list) -> None:
            """One batched prefill per bucket of the wave, prefix-matching
            requests (their tails) apart."""
            groups: dict[tuple[bool, int], list] = {}
            for slot, _rid, prompt, _budget, temp in wave:
                use = self._uses_prefix(prompt)
                toks = prompt[pre['len']:] if use else prompt
                key = (use, bucket_length(len(toks), self.prompt_buckets))
                groups.setdefault(key, []).append((slot, toks, temp))
            for (use, bucket), group in sorted(groups.items()):
                self._prefill_dense(params, st, [g[0] for g in group],
                                    [g[1] for g in group],
                                    [g[2] for g in group], bucket, pad,
                                    pre['len'] if use else 0)

        def admit():
            if request_feed is not None:
                queue.extend(request_feed())
            wave = []
            for slot in range(self.num_slots):
                if slot_req[slot] is not None or not queue:
                    continue
                rid, req = queue[0]
                prompt, budget, temp = request_of(req)
                if paged and not admit_paged(slot, prompt, budget, temp):
                    break           # pool exhausted; retry next boundary
                queue.popleft()
                wave.append((slot, rid, prompt, budget, temp))
            if wave and not paged:
                admit_dense(wave)
            for slot, rid, _prompt, budget, _temp in wave:
                slot_req[slot] = rid
                slot_budget[slot] = budget
                outputs[rid] = []
                admit_step[rid] = step_count

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
                    free_pages.extend(slot_pages[slot])
                    slot_pages[slot] = []
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
                # as in JAX, a request that needs more pages than the whole
                # pool stays queued: this call returns it empty, a serving
                # loop idles behind it (ROADMAP R23)
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
