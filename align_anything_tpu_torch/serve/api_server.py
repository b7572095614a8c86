"""OpenAI-compatible HTTP serving over the continuous-batching engine.

    python -m align_anything_tpu_torch.serve.api_server \
        --model_name_or_path <hf-dir> [--port 8000] [--num_slots 8] \
        [--cache_mode paged] [--prefix_cache_text '<system prompt>']

Endpoints: ``POST /v1/completions``, ``POST /v1/chat/completions`` (both
streamed as server-sent events with ``"stream": true``), ``GET
/v1/models``, ``GET /health``.

The port of ``align_anything_tpu/serve/api_server.py``.  ONE worker thread
owns the card and runs ``ContinuousBatchingEngine.generate`` in serving
mode: HTTP requests enqueue into its admission feed at chunk boundaries
while earlier requests keep decoding.  Per-request ``max_tokens`` and
``temperature`` are honoured (temperature rides per-slot device state; 0
= greedy); ``top_k`` / ``top_p`` are engine-wide, set at launch.  The
server runs on the first CUDA device unless it is given ``device``.  The
JAX server's mesh and platform environment have no counterpart on one
card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import threading
import time
from collections import deque

import torch

from align_anything_tpu_torch.data import ChatTemplate, HashTokenizer
from align_anything_tpu_torch.data.tokenizer import (has_tokenizer_files,
                                                     load_tokenizer)
from align_anything_tpu_torch.generation import (ContinuousBatchingEngine,
                                                 GenerationConfig)
from align_anything_tpu_torch.models.hf_loader import load_params
from align_anything_tpu_torch.utils.tools import default_device


class InferenceServer:
    """Owns the model, the engine, and the single worker thread."""

    def __init__(self, model_name_or_path: str, num_slots: int = 8,
                 max_len: int = 2048, max_new_tokens: int = 512,
                 temperature: float = 0.7, top_p: float = 0.9,
                 chunk_steps: int = 8, cache_mode: str = 'dense',
                 prefix_cache_text: str | None = None,
                 device: torch.device | str | None = None):
        self.device = default_device(device)
        self.params, self.model_cfg = load_params(model_name_or_path,
                                                  device=self.device)
        self.model_name = model_name_or_path
        if has_tokenizer_files(model_name_or_path):
            self.tokenizer = load_tokenizer(model_name_or_path,
                                            padding_side='left')
        else:
            self.tokenizer = HashTokenizer(
                vocab_size=self.model_cfg.true_vocab_size
                or self.model_cfg.vocab_size)
        self.template = ChatTemplate(formatter=self.tokenizer)
        self.max_new_tokens = max_new_tokens
        self.gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, eos_token_id=self.tokenizer.eos_token_id)
        self.engine = ContinuousBatchingEngine(
            self.model_cfg, num_slots=num_slots, max_len=max_len,
            cache_mode=cache_mode)
        if prefix_cache_text:
            # shared-prefix KV reuse (system prompts): requests whose token
            # stream starts with this prefix skip its prefill; done here,
            # before the worker starts, so one thread touches the card
            self.engine.register_prefix(
                self.params, self.tokenizer.encode(prefix_cache_text))
        self.chunk_steps = chunk_steps
        self._rid = itertools.count()
        self._queue: deque = deque()
        self._events: dict[int, threading.Event] = {}
        self._results: dict[int, tuple[list[int], str]] = {}
        self._chunks: dict[int, deque] = {}  # streamed rids only
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stop = False
        self._error: str | None = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- worker side -------------------------------------------------------

    def _feed(self):
        with self._lock:
            batch = list(self._queue)
            self._queue.clear()
        return batch

    def _on_tokens(self, rid: int, tokens: list[int]) -> None:
        with self._cond:
            if rid in self._chunks:
                self._chunks[rid].append(list(tokens))
                self._cond.notify_all()

    def _finish(self, rid: int, tokens: list[int]) -> None:
        eos = self.tokenizer.eos_token_id
        reason = 'stop' if tokens and tokens[-1] == eos else 'length'
        with self._cond:
            ev = self._events.pop(rid, None)
            if ev is None and rid not in self._chunks:
                return  # abandoned (timed out) request: drop, don't leak
            self._results[rid] = (tokens, reason)
            if rid in self._chunks:
                self._chunks[rid].append(None)  # end-of-stream sentinel
                self._cond.notify_all()
        if ev is not None:
            ev.set()

    def _run(self) -> None:
        try:
            # the sampling generator lives on the worker: only this thread
            # touches the card
            generator = torch.Generator(device=self.device).manual_seed(0)
            self.engine.generate(
                self.params, [], self.gen_cfg, generator,
                chunk_steps=self.chunk_steps, request_feed=self._feed,
                on_finish=self._finish, on_tokens=self._on_tokens,
                should_stop=lambda: self._stop)
        except Exception as exc:  # noqa: BLE001 - surfaced via /health
            with self._cond:
                # error set + sweep under one lock so submit() can't
                # register an event after the sweep (it re-checks under
                # the same lock)
                self._error = f'{type(exc).__name__}: {exc}'
                for ev in self._events.values():
                    ev.set()
                for chunks in self._chunks.values():
                    chunks.append(None)
                self._cond.notify_all()
            raise

    # -- request side ------------------------------------------------------

    def submit(self, prompt_ids: list[int], max_tokens: int | None = None,
               stream: bool = False,
               temperature: float | None = None) -> int:
        rid = next(self._rid)
        ev = threading.Event()
        budget = (self.max_new_tokens if max_tokens is None
                  else max(1, min(int(max_tokens), self.max_new_tokens)))
        req = {'input_ids': prompt_ids, 'max_new_tokens': budget}
        if temperature is not None:
            req['temperature'] = max(float(temperature), 0.0)
        with self._lock:
            # checked under the lock: the dead-worker sweep also runs under
            # it, so a request can't slip in after the sweep
            if self._error is not None:
                raise RuntimeError(f'inference worker died: {self._error}')
            self._events[rid] = ev
            if stream:
                self._chunks[rid] = deque()
            self._queue.append((rid, req))
        return rid

    def wait(self, rid: int, timeout: float = 600.0
             ) -> tuple[list[int], str]:
        """-> (tokens, finish_reason)."""
        with self._lock:
            ev = self._events.get(rid)
        if ev is not None and not ev.wait(timeout):
            with self._lock:
                self._events.pop(rid, None)
                self._results.pop(rid, None)
            raise TimeoutError(f'request {rid} timed out')
        if self._error is not None:
            raise RuntimeError(f'inference worker died: {self._error}')
        with self._lock:
            return self._results.pop(rid)

    def iter_chunks(self, rid: int, timeout: float = 600.0):
        """Yield per-chunk token lists for a streamed rid until done.
        Generator return value: the finish reason ('stop' | 'length')."""
        deadline = time.time() + timeout
        while True:
            with self._cond:
                while not self._chunks.get(rid):
                    if not self._cond.wait(timeout=min(
                            1.0, max(deadline - time.time(), 0.01))):
                        if time.time() > deadline:
                            del self._chunks[rid]
                            raise TimeoutError(f'stream {rid} timed out')
                chunk = self._chunks[rid].popleft()
                if chunk is None:
                    del self._chunks[rid]
                    result = self._results.pop(rid, None)
                    return result[1] if result else 'stop'
            yield chunk

    def stream_text(self, prompt: str, max_tokens: int | None = None,
                    temperature: float | None = None):
        """Yield ('delta', text) increments then a final ('finish',
        reason).  Cumulative-decode diff keeps BPE merges correct across
        chunk boundaries; deltas are withheld while the decoded text ends
        mid-character (U+FFFD) so multi-byte UTF-8 never reaches the
        client split."""
        ids = self.tokenizer.encode(prompt)
        rid = self.submit(ids, max_tokens, stream=True,
                          temperature=temperature)
        sofar: list[int] = []
        prev = ''
        eos = self.tokenizer.eos_token_id

        def decoded():
            trimmed = sofar[:-1] if sofar and sofar[-1] == eos else sofar
            return self.tokenizer.decode(trimmed)

        gen = self.iter_chunks(rid)
        reason = 'stop'
        while True:
            try:
                chunk = next(gen)
            except StopIteration as stop:
                reason = stop.value or 'stop'
                break
            sofar.extend(chunk)
            text = decoded()
            if text.endswith('�'):
                continue  # mid-character: wait for the completing token
            if text.startswith(prev) and len(text) > len(prev):
                yield ('delta', text[len(prev):])
                prev = text
        final = decoded()
        if final != prev and final.startswith(prev):
            yield ('delta', final[len(prev):])
        yield ('finish', reason)

    def complete(self, prompt: str, max_tokens: int | None = None,
                 temperature: float | None = None) -> tuple[str, str]:
        """-> (text, finish_reason)."""
        ids = self.tokenizer.encode(prompt)
        rid = self.submit(ids, max_tokens, temperature=temperature)
        out, reason = self.wait(rid)
        eos = self.tokenizer.eos_token_id
        if out and out[-1] == eos:
            out = out[:-1]
        return self.tokenizer.decode(out), reason

    def chat(self, messages: list[dict], max_tokens: int | None = None,
             temperature: float | None = None) -> tuple[str, str]:
        prompt, _ = self.template.format_chat_sample(messages)
        return self.complete(prompt, max_tokens, temperature)

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the worker at its next chunk boundary and join it."""
        self._stop = True
        self._worker.join(timeout=timeout)


def _stream_events(server: InferenceServer, path: str, body: dict):
    """OpenAI SSE event dicts for a streamed completion/chat request."""
    chat = path == '/v1/chat/completions'
    if chat:
        prompt, _ = server.template.format_chat_sample(
            body.get('messages') or [])
    else:
        prompt = body.get('prompt') or ''
        if isinstance(prompt, list):
            prompt = prompt[0]
    rid_tag = f'{"chatcmpl" if chat else "cmpl"}-{int(time.time() * 1000)}'
    model = body.get('model', server.model_name)
    reason = 'stop'
    for kind, value in server.stream_text(prompt, body.get('max_tokens'),
                                          body.get('temperature')):
        if kind == 'finish':
            reason = value
            continue
        if chat:
            yield {'id': rid_tag, 'object': 'chat.completion.chunk',
                   'model': model,
                   'choices': [{'index': 0, 'finish_reason': None,
                                'delta': {'content': value}}]}
        else:
            yield {'id': rid_tag, 'object': 'text_completion',
                   'model': model,
                   'choices': [{'index': 0, 'finish_reason': None,
                                'text': value}]}
    closing = ({'delta': {}} if chat else {'text': ''})
    yield {'id': rid_tag,
           'object': 'chat.completion.chunk' if chat else 'text_completion',
           'model': model,
           'choices': [{'index': 0, 'finish_reason': reason, **closing}]}


def _handle(server: InferenceServer, method: str, path: str,
            body: dict) -> tuple[int, dict]:
    """Framework-independent request handling (flask + stdlib share it)."""
    if method == 'GET' and path == '/health':
        if server._error is not None:
            return 500, {'status': 'error', 'detail': server._error}
        return 200, {'status': 'ok'}
    if method == 'GET' and path == '/v1/models':
        return 200, {'object': 'list', 'data': [
            {'id': server.model_name, 'object': 'model',
             'owned_by': 'align-anything-tpu'}]}
    if method == 'POST' and path == '/v1/completions':
        prompt = body.get('prompt') or ''
        if isinstance(prompt, list):
            prompt = prompt[0]
        text, reason = server.complete(prompt, body.get('max_tokens'),
                                       body.get('temperature'))
        return 200, {
            'id': f'cmpl-{int(time.time() * 1000)}',
            'object': 'text_completion',
            'model': body.get('model', server.model_name),
            'choices': [{'index': 0, 'text': text,
                         'finish_reason': reason}],
        }
    if method == 'POST' and path == '/v1/chat/completions':
        messages = body.get('messages') or []
        text, reason = server.chat(messages, body.get('max_tokens'),
                                   body.get('temperature'))
        return 200, {
            'id': f'chatcmpl-{int(time.time() * 1000)}',
            'object': 'chat.completion',
            'model': body.get('model', server.model_name),
            'choices': [{'index': 0, 'finish_reason': reason,
                         'message': {'role': 'assistant',
                                     'content': text}}],
        }
    return 404, {'error': {'message': f'no route {method} {path}'}}


def make_stdlib_server(server: InferenceServer, host: str, port: int):
    """A stdlib ``ThreadingHTTPServer`` (no flask needed; the recipe of
    ``models/remote_rm/server.py``)."""
    from http.server import (  # noqa: PLC0415
        BaseHTTPRequestHandler,
        ThreadingHTTPServer,
    )

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, method):
            length = int(self.headers.get('Content-Length') or 0)
            body = {}
            if length:
                try:
                    body = json.loads(self.rfile.read(length))
                except json.JSONDecodeError:
                    self.send_response(400)
                    self.end_headers()
                    return
            if (method == 'POST' and body.get('stream')
                    and self.path in ('/v1/completions',
                                      '/v1/chat/completions')):
                self.send_response(200)
                self.send_header('Content-Type', 'text/event-stream')
                self.send_header('Cache-Control', 'no-cache')
                self.end_headers()
                for event in _stream_events(server, self.path, body):
                    self.wfile.write(
                        b'data: ' + json.dumps(event).encode() + b'\n\n')
                    self.wfile.flush()
                self.wfile.write(b'data: [DONE]\n\n')
                self.wfile.flush()
                return
            status, payload = _handle(server, method, self.path, body)
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            self._reply('GET')

        def do_POST(self):  # noqa: N802
            self._reply('POST')

        def log_message(self, *args):  # quiet
            pass

    return ThreadingHTTPServer((host, port), Handler)


def build_app(server: InferenceServer):
    """The same routes as a flask app (raises ImportError without flask)."""
    from flask import Flask, Response, jsonify, request  # noqa: PLC0415

    app = Flask('align_anything_tpu_torch')

    @app.get('/health')
    def health():
        status, payload = _handle(server, 'GET', '/health', {})
        return jsonify(payload), status

    @app.get('/v1/models')
    def models():
        return jsonify(_handle(server, 'GET', '/v1/models', {})[1])

    def _sse(path, body):
        def gen():
            for event in _stream_events(server, path, body):
                yield f'data: {json.dumps(event)}\n\n'
            yield 'data: [DONE]\n\n'
        return Response(gen(), mimetype='text/event-stream')

    @app.post('/v1/completions')
    def completions():
        body = request.get_json(force=True)
        if body.get('stream'):
            return _sse('/v1/completions', body)
        status, payload = _handle(server, 'POST', '/v1/completions', body)
        return jsonify(payload), status

    @app.post('/v1/chat/completions')
    def chat_completions():
        body = request.get_json(force=True)
        if body.get('stream'):
            return _sse('/v1/chat/completions', body)
        status, payload = _handle(server, 'POST', '/v1/chat/completions',
                                  body)
        return jsonify(payload), status

    return app


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='OpenAI-compatible server over the continuous engine')
    parser.add_argument('--model_name_or_path', required=True)
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--num_slots', type=int, default=8)
    parser.add_argument('--max_len', type=int, default=2048)
    parser.add_argument('--max_new_tokens', type=int, default=512)
    parser.add_argument('--temperature', type=float, default=0.7)
    parser.add_argument('--top_p', type=float, default=0.9)
    parser.add_argument('--cache_mode', default='dense',
                        choices=('dense', 'paged'))
    parser.add_argument('--prefix_cache_text', default=None,
                        help='shared prompt prefix (e.g. the system '
                             'prompt) to prefill once and reuse for every '
                             'request that starts with it')
    args = parser.parse_args(argv)

    server = InferenceServer(
        args.model_name_or_path, num_slots=args.num_slots,
        max_len=args.max_len, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, top_p=args.top_p,
        cache_mode=args.cache_mode,
        prefix_cache_text=args.prefix_cache_text)
    try:
        try:
            app = build_app(server)
        except ImportError:
            httpd = make_stdlib_server(server, args.host, args.port)
            print(f'serving (stdlib http) on {args.host}:{args.port}',
                  file=sys.stderr)
            httpd.serve_forever()
        else:
            app.run(host=args.host, port=args.port, threaded=True)
    finally:
        server.shutdown()
    return 0


if __name__ == '__main__':
    sys.exit(main())
