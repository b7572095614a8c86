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

Saves are synchronous (the JAX module's orbax writes are asynchronous);
``wait_for_saves`` is kept as a no-op so callers read the same.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any

import torch

from align_anything_tpu_torch.utils.tools import tree_map

_STATE_FILE = 'train_state.pt'


def save_train_state(output_dir: str, step: int, state: Any,
                     keep: int | None = None, wait: bool = True) -> str:
    """Save the train state (a ``trainers.base.TrainState``) to
    ``output_dir/checkpoints/step_{step}``, keeping the newest ``keep``.
    The write is synchronous whatever ``wait`` says."""
    del wait
    path = os.path.abspath(os.path.join(output_dir, 'checkpoints',
                                        f'step_{step}'))
    os.makedirs(path, exist_ok=True)
    payload = {'params': tree_map(lambda t: t.detach(), state.params),
               'optimizer': state.optimizer.state_dict(),
               'step': int(state.step)}
    tmp = os.path.join(path, _STATE_FILE + '.tmp')
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    if keep is not None:
        _prune_old(os.path.join(output_dir, 'checkpoints'), keep,
                   exclude=os.path.basename(path))
    return path


def wait_for_saves() -> None:
    """Saves are synchronous: nothing is ever in flight."""


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
    """Restore into ``target`` (a ``TrainState`` of the same tree): the
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
