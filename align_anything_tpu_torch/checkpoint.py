"""Checkpoint/resume + HF-format export: the port of
``align_anything_tpu/checkpoint.py``.

Two save mechanisms, as in the JAX module (reference:
trainers/base/supervised_trainer.py:404-450):
- full train-state checkpoints (params + optimizer + step) under
  ``checkpoints/step_{step}``, with explicit step metadata instead of
  ``slice_{step}`` dirname parsing: here one ``torch.save`` file of the
  param tree, the optimizer's ``state_dict`` and the step;
- HF-format ``slice_{step}/`` exports (safetensors + config.json) so outputs
  remain loadable by the reference ecosystem.

Train-state saves may be asynchronous, as the JAX module's orbax
``AsyncCheckpointer`` writes are: with ``wait=False`` the state is copied
to host memory before ``save_train_state`` returns and one background
thread writes it.  Every save writes a temporary file and commits it with
``os.replace``, so ``latest_checkpoint`` never sees a partial save.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any

import torch

_STATE_FILE = 'train_state.pt'
# the save being written in the background: (thread, errors it hit)
_IN_FLIGHT: list = [None]


def _host_copy(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors live in host memory and share no
    storage with the originals (the train step updates those in place).
    A CUDA tensor is copied into pinned memory without blocking, and the
    copies are waited for once: PyTorch's host allocator keeps the pinned
    blocks of one save for the next."""
    pending = []

    def copy(t):
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                out.copy_(t.detach(), non_blocking=True)
                pending.append(t.device)
                return out
            return t.detach().to('cpu', copy=True)
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(copy(v) for v in t)
        return t

    out = copy(tree)
    for device in set(pending):
        torch.cuda.synchronize(device)
    return out


def _write(payload: dict, path: str) -> None:
    tmp = os.path.join(path, _STATE_FILE + '.tmp')
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))


def _write_in_background(payload: dict, path: str, errors: list) -> None:
    try:
        _write(payload, path)
    except BaseException as err:  # noqa: BLE001 -- re-raised by wait_for_saves
        errors.append(err)


def save_train_state(output_dir: str, step: int, state: Any,
                     keep: int | None = None, wait: bool = True) -> str:
    """Save the train state (a ``trainers.base.TrainState``) to
    ``output_dir/checkpoints/step_{step}``, keeping the newest ``keep``.

    The save in flight, if any, is waited for first (orbax serializes
    consecutive saves too), and its error re-raised.  Then the state is
    copied to host memory; with ``wait=False`` one background thread writes
    it and this returns at once: call :func:`wait_for_saves` before
    exiting or restoring."""
    wait_for_saves()
    path = os.path.abspath(os.path.join(output_dir, 'checkpoints',
                                        f'step_{step}'))
    os.makedirs(path, exist_ok=True)
    payload = _host_copy({'params': state.params,
                          'optimizer': state.optimizer.state_dict(),
                          'step': int(state.step)})
    if wait:
        _write(payload, path)
    else:
        errors: list = []
        thread = threading.Thread(target=_write_in_background,
                                  args=(payload, path, errors),
                                  name=f'checkpoint-step_{step}')
        thread.start()
        _IN_FLIGHT[0] = (thread, errors)
    if keep is not None:
        # every earlier save has committed (waited for above); this one is
        # spared even while it is in flight
        _prune_old(os.path.join(output_dir, 'checkpoints'), keep,
                   exclude=os.path.basename(path))
    return path


def wait_for_saves() -> None:
    """Block until the save in flight has committed; re-raise the error
    its writer hit, if any."""
    entry, _IN_FLIGHT[0] = _IN_FLIGHT[0], None
    if entry is None:
        return
    thread, errors = entry
    thread.join()
    if errors:
        raise errors[0]


def latest_checkpoint(output_dir: str) -> tuple[str, int] | None:
    root = os.path.join(output_dir, 'checkpoints')
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        m = re.fullmatch(r'step_(\d+)', name)
        if m and os.path.exists(os.path.join(root, name, _STATE_FILE)):
            steps.append(int(m.group(1)))
    if not steps:
        return None
    step = max(steps)
    return os.path.join(root, f'step_{step}'), step


def restore_train_state(path: str, target: Any) -> Any:
    """Restore a committed save into ``target`` (a ``TrainState`` of the same tree): the
    params are copied into its leaves in place, on their devices, and the
    optimizer's state is loaded into its optimizer."""
    saved = torch.load(os.path.join(path, _STATE_FILE), map_location='cpu',
                       weights_only=True)
    _copy_into(target.params, saved['params'])
    target.optimizer.load_state_dict(saved['optimizer'])
    target.step = int(saved['step'])
    return target


def _copy_into(tree: Any, saved: Any) -> None:
    if isinstance(tree, dict):
        if set(tree) != set(saved):
            raise ValueError('checkpoint param tree differs from the '
                             f'target: {sorted(set(tree) ^ set(saved))}')
        for k in tree:
            _copy_into(tree[k], saved[k])
        return
    with torch.no_grad():
        tree.copy_(saved)


def _prune_old(root: str, keep: int, exclude: str | None = None) -> None:
    entries = []
    for name in os.listdir(root):
        m = re.fullmatch(r'step_(\d+)', name)
        if m and name != exclude:
            entries.append((int(m.group(1)), name))
    # `exclude` (the save just written) always counts toward the keep budget.
    budget = keep - (1 if exclude is not None else 0)
    if budget < 0:
        budget = 0
    doomed = sorted(entries)[:-budget] if budget > 0 else sorted(entries)
    if keep <= 0:
        doomed = []
    for _, name in doomed:
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def save_hf_slice(output_dir: str, step: int, params: Any, model_config: Any,
                  tokenizer: Any | None = None) -> str:
    """HF-format ``slice_{step}`` export (reference output-layout parity) of
    a decoder param tree, or of a LLaVA-layout one for a multimodal config;
    the JAX module's other multimodal savers are not ported."""
    from align_anything_tpu_torch.models.hf_loader import (  # noqa: PLC0415
        save_multimodal_params,
        save_params,
    )
    from align_anything_tpu_torch.models.multimodal import (  # noqa: PLC0415
        MultimodalConfig)

    path = os.path.join(output_dir, f'slice_{step}')
    params = {k: v for k, v in params.items() if k != 'score_head'}
    if isinstance(model_config, MultimodalConfig):
        save_multimodal_params(path, params, model_config)
    else:
        save_params(path, params, model_config)
    if tokenizer is not None and hasattr(tokenizer, 'save_pretrained'):
        tokenizer.save_pretrained(path)
    return path


def parse_slice_step(model_name_or_path: str) -> int:
    """Extract the global step from a `slice_N` path (resume parity with
    supervised_trainer.py:76-77)."""
    m = re.search(r'slice_(\d+)/?$', model_name_or_path)
    return int(m.group(1)) if m else 0
