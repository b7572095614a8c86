"""Profiling/tracing hooks: the port of
``align_anything_tpu/utils/profiling.py``.  ``StepTimer`` is unchanged;
``maybe_trace`` writes a ``torch.profiler`` trace (CPU and CUDA activity,
Chrome trace JSON) where the JAX module wrote a ``jax.profiler`` one."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None, step: int,
                start_step: int = 3, num_steps: int = 3) -> Iterator[None]:
    """Trace each step in [start, start+num) into
    ``profile_dir/step_{step}.json``."""
    if profile_dir and start_step <= step < start_step + num_steps:
        import torch  # noqa: PLC0415
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

        os.makedirs(profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              f'step_{step}.json'))
        return
    yield


class StepTimer:
    """Rolling per-step wall-clock + tokens/sec accounting."""

    def __init__(self, window: int = 20):
        self.window = window
        self.times: list[float] = []
        self.tokens: list[int] = []
        self._last = time.monotonic()

    def tick(self, n_tokens: int = 0) -> dict[str, float]:
        now = time.monotonic()
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        self.tokens.append(n_tokens)
        self.times = self.times[-self.window:]
        self.tokens = self.tokens[-self.window:]
        total_t = sum(self.times)
        out = {'perf/step_time_s': dt}
        if total_t > 0 and any(self.tokens):
            out['perf/tokens_per_sec'] = sum(self.tokens) / total_t
        return out
