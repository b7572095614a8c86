"""Remote reward-model HTTP server.

Parity with reference models/remote_rm/reward_server.py: a ``/get_reward``
POST endpoint mapping ``{prompts, responses}`` to ``{rewards}`` via a
pluggable rule-based reward function, with an optional golden-answer
dataset matched by similarity.  Uses the stdlib http.server when flask is
unavailable (air-gapped hosts).  The port of
``align_anything_tpu/models/remote_rm/server.py``.
"""

from __future__ import annotations

import difflib
import json
from typing import Optional

from align_anything_tpu_torch.models.remote_rm.reward_functions import (
    get_reward_function,
)


class RewardService:
    def __init__(self, reward_fn_name: str = 'example_length',
                 golden_dataset: dict[str, str] | None = None):
        self.reward_function = get_reward_function(reward_fn_name)
        self.problem_to_answer = golden_dataset or {}

    def find_similar_problem(self, problem: str) -> Optional[str]:
        """Nearest golden problem by string similarity
        (reference reward_server.py:65 Levenshtein analog)."""
        if not self.problem_to_answer:
            return None
        return max(self.problem_to_answer,
                   key=lambda p: difflib.SequenceMatcher(None, problem, p)
                   .ratio())

    def get_reward(self, payload: dict) -> tuple[dict, int]:
        if 'prompts' not in payload or 'responses' not in payload:
            return ({'error': "Request must contain 'prompts' and "
                              "'responses' fields, optional "
                              "'golden_responses' field"}, 400)
        prompts = payload['prompts']
        responses = payload['responses']
        if len(prompts) != len(responses):
            return ({'error': 'The number of prompts and responses must be '
                              'the same'}, 400)
        golden = payload.get('golden_responses')
        if golden is None and self.problem_to_answer:
            golden = [self.problem_to_answer.get(self.find_similar_problem(p))
                      for p in prompts]
        try:
            rewards = self.reward_function(prompts, responses, golden)
        except Exception as exc:  # mirror reference's catch-all 500
            return ({'error': str(exc)}, 500)
        return ({'rewards': [float(r) for r in rewards]}, 200)


def load_golden_dataset(path: str | None) -> dict[str, str]:
    """jsonl with ``problem``/``answer`` (or ``prompt``/``response``) rows."""
    if not path:
        return {}
    table: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            problem = row.get('problem') or row.get('prompt') or row.get('question')
            answer = row.get('answer') or row.get('response')
            if problem and answer is not None:
                table[problem] = str(answer)
    return table


def start_server(host: str = '0.0.0.0', port: int = 6000,
                 reward_fn_name: str = 'example_length',
                 golden_dataset_path: str | None = None,
                 use_flask: bool = True):
    """Serve /get_reward.  Flask if available, stdlib otherwise."""
    service = RewardService(reward_fn_name,
                            load_golden_dataset(golden_dataset_path))
    if use_flask:
        try:
            from flask import Flask, jsonify, request  # noqa: PLC0415

            app = Flask('align-anything-tpu-remote-rm')

            @app.route('/get_reward', methods=['POST'])
            def get_reward():  # pragma: no cover - thin wrapper
                body, code = service.get_reward(request.get_json())
                return jsonify(body), code

            app.run(host=host, port=port)
            return
        except ImportError:
            pass

    from http.server import BaseHTTPRequestHandler, HTTPServer  # noqa: PLC0415

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != '/get_reward':
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get('Content-Length', 0))
            try:
                payload = json.loads(self.rfile.read(length) or b'{}')
            except json.JSONDecodeError:
                payload = {}
            body, code = service.get_reward(payload)
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    server = HTTPServer((host, port), Handler)
    server.serve_forever()


def main(argv=None):
    import argparse  # noqa: PLC0415

    parser = argparse.ArgumentParser(description='remote reward model server')
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--port', type=int, default=6000)
    parser.add_argument('--reward-function', default='example_length')
    parser.add_argument('--golden-dataset', default=None)
    args = parser.parse_args(argv)
    start_server(args.host, args.port, args.reward_function,
                 args.golden_dataset)


if __name__ == '__main__':
    main()
