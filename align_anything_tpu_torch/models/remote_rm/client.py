"""Remote reward-model HTTP client with retry
(parity: models/remote_rm/remote_rm_client.py:25-84, returning a numpy
array instead of a torch tensor).  The port of
``align_anything_tpu/models/remote_rm/client.py``."""

from __future__ import annotations

import json
import time
import urllib.request
from typing import List

import numpy as np


class RemoteRewardModel:
    def __init__(self, endpoint: str, timeout: int = 100,
                 retry_times: int = 3):
        self.endpoint = endpoint
        self.timeout = timeout
        self.retry_times = retry_times

    def score(self, prompts: List[str], responses: List[str]) -> np.ndarray:
        assert len(prompts) == len(responses), (
            'The number of prompts and responses must be the same')
        payload = json.dumps({'prompts': prompts,
                              'responses': responses}).encode()
        last_error: Exception | None = None
        for attempt in range(self.retry_times):
            try:
                req = urllib.request.Request(
                    self.endpoint, data=payload,
                    headers={'Content-Type': 'application/json'})
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    body = json.loads(resp.read())
                return np.asarray(body['rewards'], np.float32)
            except Exception as exc:
                last_error = exc
                if attempt + 1 < self.retry_times:
                    time.sleep(min(2 ** attempt, 10))
        raise RuntimeError(
            f'remote reward model at {self.endpoint} failed after '
            f'{self.retry_times} attempts: {last_error}')
