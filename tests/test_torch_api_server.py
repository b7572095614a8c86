"""The port's OpenAI-compatible server (``serve/api_server.py``) on the CPU:
greedy ids against the JAX package's ``InferenceServer`` over the same tiny
checkpoint (float32 compute in both), and every route through the stdlib
HTTP server: completions, chat, both streamed as server-sent events,
``/v1/models``, ``/health``, a 404, ``max_tokens`` clipped, and a dead
worker surfacing as ``/health`` 500."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.models import hf_loader  # noqa: E402
from align_anything_tpu_torch.models import transformer  # noqa: E402
from align_anything_tpu_torch.models.config import llama_config  # noqa: E402
from align_anything_tpu_torch.serve import api_server  # noqa: E402

from test_torch_paged import one_thread  # noqa: E402,F401

NEW = 6
PROMPTS = [[1, 5, 6, 7], [1, 9, 10, 11, 12, 13, 14], [1, 20],
           [1, 33, 34, 35, 36, 40, 41, 42, 43]]


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    """The JAX api-server test's tiny Llama, written once from a seed."""
    cfg = llama_config(vocab_size=128, hidden=32, layers=2, heads=4,
                       kv_heads=2, mlp=64, max_pos=256).replace(
        eos_token_id=1, pad_token_id=0)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device='cpu')
    path = str(tmp_path_factory.mktemp('ckpt') / 'm')
    hf_loader.save_params(path, params, cfg)
    return path


@pytest.fixture(autouse=True)
def fp32_load(monkeypatch):
    """The port's server computes in float32, as the JAX side's below:
    ``load_params`` hands back the checkpoint's config in fp32 compute."""
    real = api_server.load_params
    monkeypatch.setattr(api_server, 'load_params', lambda path, **kw: (
        lambda pc: (pc[0], pc[1].replace(compute_dtype='float32')))(
            real(path, **kw)))


def port_server(path, **kw):
    kw = dict(dict(num_slots=2, max_len=64, max_new_tokens=NEW,
                   temperature=0.0), **kw)
    return api_server.InferenceServer(path, device='cpu', **kw)


def greedy_ids(server, prompts):
    rids = [server.submit(p, temperature=0.0) for p in prompts]
    return [server.wait(r, timeout=120)[0] for r in rids]


def test_submit_wait_matches_jax(ckpt, monkeypatch):
    """Greedy ids from ``submit`` / ``wait`` equal JAX's server's on the
    same checkpoint, and the port's paged server gives the same ids."""
    pytest.importorskip('jax')
    from align_anything_tpu.serve import api_server as jserve

    real = jserve.load_params
    monkeypatch.setattr(jserve, 'load_params', lambda path: (
        lambda pc: (pc[0], pc[1].replace(compute_dtype='float32')))(
            real(path)))
    jsrv = jserve.InferenceServer(ckpt, num_slots=2, max_len=64,
                                  max_new_tokens=NEW, temperature=0.0)
    try:
        want = greedy_ids(jsrv, PROMPTS)
    finally:
        jsrv.shutdown()
    for mode in ('dense', 'paged'):
        srv = port_server(ckpt, cache_mode=mode)
        try:
            assert greedy_ids(srv, PROMPTS) == want
        finally:
            srv.shutdown()
            assert not srv._worker.is_alive()
    assert all(len(t) == NEW or t[-1] == jsrv.tokenizer.eos_token_id
               for t in want)


def request(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers['Content-Type'], r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers['Content-Type'], err.read()


def sse(raw: bytes) -> tuple[list[dict], bool]:
    events, done = [], False
    for line in raw.decode().splitlines():
        if not line.startswith('data: '):
            continue
        if line == 'data: [DONE]':
            done = True
            break
        events.append(json.loads(line[len('data: '):]))
    return events, done


def test_http_routes(ckpt):
    """Every route through ``make_stdlib_server``, three concurrent
    completions, streams against the non-streamed text, ``max_tokens``
    clipped to the server's budget, then a dead worker."""
    system = ' '.join(f'w{i}' for i in range(20))     # 16 cached tokens
    srv = port_server(ckpt, prefix_cache_text=system, cache_mode='paged')
    assert srv.engine._prefix['len'] == 16
    httpd = api_server.make_stdlib_server(srv, '127.0.0.1', 0)
    base = f'http://127.0.0.1:{httpd.server_address[1]}'
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        status, _, body = request(base, '/health')
        assert status == 200 and json.loads(body)['status'] == 'ok'
        status, _, body = request(base, '/v1/models')
        assert status == 200 and json.loads(body)['data'][0]['id'] == ckpt
        assert request(base, '/v1/nothing')[0] == 404

        results = {}

        def post(i):
            results[i] = request(base, '/v1/completions',
                                 {'prompt': f'{system} word {i}',
                                  'max_tokens': 4})
        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert sorted(results) == [0, 1, 2]
        for status, _, body in results.values():
            choice = json.loads(body)['choices'][0]
            assert status == 200 and isinstance(choice['text'], str)

        for path, body in (
                ('/v1/completions', {'prompt': 'stream me please'}),
                ('/v1/chat/completions',
                 {'messages': [{'role': 'user', 'content': 'hi there'}]})):
            status, ctype, raw = request(base, path, dict(body, stream=True))
            assert status == 200 and ctype.startswith('text/event-stream')
            events, done = sse(raw)
            assert done
            chat = 'chat' in path
            streamed = ''.join(
                e['choices'][0]['delta'].get('content', '') if chat
                else e['choices'][0]['text'] for e in events)
            status, _, whole = request(base, path, body)
            choice = json.loads(whole)['choices'][0]
            assert status == 200
            assert streamed == (choice['message']['content'] if chat
                                else choice['text'])
            assert events[-1]['choices'][0]['finish_reason'] == \
                choice['finish_reason']

        toks, _ = srv.wait(srv.submit(PROMPTS[0], max_tokens=100,
                                      temperature=0.0))
        assert len(toks) == NEW or toks[-1] == srv.tokenizer.eos_token_id

        # a token id past the vocab kills the worker: /health turns 500 and
        # submit refuses from then on
        with pytest.raises(RuntimeError, match='worker died'):
            srv.wait(srv.submit([1, 10_000]), timeout=120)
        status, _, body = request(base, '/health')
        assert status == 500 and json.loads(body)['status'] == 'error'
        with pytest.raises(RuntimeError, match='worker died'):
            srv.submit(PROMPTS[0])
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()
    assert not srv._worker.is_alive()


def test_flask_health_reports_a_dead_worker(ckpt, monkeypatch):
    """``build_app`` over a stand-in flask module (flask need not be
    installed): the port's ``/health`` route answers 500 for a
    dead worker, where JAX's answers 200 with the error in its body
    (ROADMAP R24)."""
    import sys
    import types

    class App:
        def __init__(self, name):
            self.routes = {}

        def route(self, method):
            def deco(path):
                def reg(fn):
                    self.routes[(method, path)] = fn
                    return fn
                return reg
            return deco

        def __getattr__(self, method):
            return self.route(method)

    flask = types.ModuleType('flask')
    flask.Flask = App
    flask.jsonify = lambda payload: ('json', payload)
    flask.Response = object
    flask.request = None
    monkeypatch.setitem(sys.modules, 'flask', flask)

    dead = types.SimpleNamespace(_error='IndexError: boom', model_name='m')
    got = api_server.build_app(dead).routes[('get', '/health')]()
    assert got == (('json', {'status': 'error',
                             'detail': 'IndexError: boom'}), 500)
    pytest.importorskip('jax')
    from align_anything_tpu.serve import api_server as jserve
    want = jserve.build_app(dead).routes[('get', '/health')]()
    assert want == ('json', {'status': 'error', 'detail': 'IndexError: boom'})
    assert not isinstance(want[1], int)        # flask's default: 200


class OneTokenTokenizer:
    """What some transformers versions build for a directory without
    tokenizer files: every prompt encodes to one token."""
    pad_token_id, eos_token_id, bos_token_id = 0, 1, None

    def encode(self, text, add_special_tokens=True):
        return [5]

    def decode(self, ids, skip_special_tokens=True):
        return ''


@pytest.mark.parametrize('files', [(), ('tokenizer_config.json',)])
def test_no_tokenizer_files_serve_the_hash_tokenizer(ckpt, tmp_path,
                                                     monkeypatch, files):
    """A checkpoint directory without a tokenizer file serves the hash
    tokenizer without asking ``load_tokenizer`` (ROADMAP R25); one with a
    tokenizer file loads it."""
    import os
    import shutil

    path = str(tmp_path / 'm')
    shutil.copytree(ckpt, path)
    for name in files:
        open(os.path.join(path, name), 'w').write('{}')
    calls = []
    monkeypatch.setattr(api_server, 'load_tokenizer', lambda *a, **kw: (
        calls.append(a), OneTokenTokenizer())[1])
    srv = port_server(path)
    try:
        if files:
            assert calls and isinstance(srv.tokenizer, OneTokenTokenizer)
        else:
            assert not calls
            assert isinstance(srv.tokenizer, api_server.HashTokenizer)
            assert len(srv.tokenizer.encode('three more words')) > 1
            text, reason = srv.complete('three more words', temperature=0.0)
            assert isinstance(text, str) and reason in ('stop', 'length')
    finally:
        srv.shutdown()


def test_greedy_ids_equal_direct_engine(ckpt):
    """The server's greedy ids equal a direct ``engine.generate`` of the
    same prompts on the server's own engine, after the worker stopped."""
    srv = port_server(ckpt)
    try:
        got = greedy_ids(srv, PROMPTS)
    finally:
        srv.shutdown()
    from align_anything_tpu_torch.generation import GenerationConfig
    direct = srv.engine.generate(
        srv.params, PROMPTS, GenerationConfig(
            max_new_tokens=NEW, greedy=True,
            eos_token_id=srv.tokenizer.eos_token_id))
    assert got == direct
    assert np.sum([len(t) for t in got]) > 0
