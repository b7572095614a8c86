"""The train-step core of ``align_anything_tpu/trainers/base.py``: the
train state and ``compile_train_step``'s logic as a plain eager step.

The rest of ``TrainerBase`` (configs, datasets and iterators, tokenizer and
HF checkpoint loading, logging, checkpoints, the CLI) is not ported yet
(ROADMAP, module item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from align_anything_tpu_torch.trainers.optimizer import ClippedAdamW, Schedule
from align_anything_tpu_torch.utils.tools import param_leaves


@dataclasses.dataclass
class TrainState:
    """params: the trainable tree (leaves with ``requires_grad``, updated in
    place); optimizer: the ``torch.optim.AdamW`` over its leaves, holding the
    moments; step: updates taken so far."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_train_state(params: dict, tx: ClippedAdamW) -> TrainState:
    """``params``' leaves must already be trainable (leaf tensors with
    ``requires_grad``, as ``bridge.trainable_from_jax_tree`` makes them):
    a frozen leaf would get no gradient and silently never move."""
    if not all(t.is_leaf and t.requires_grad for t in param_leaves(params)):
        raise ValueError('init_train_state: every param must be a leaf tensor '
                         'with requires_grad')
    return TrainState(params=params, optimizer=tx.init(params))


def make_train_step(loss_fn: Callable[..., tuple[torch.Tensor, dict]],
                    tx: ClippedAdamW, schedule: Schedule
                    ) -> Callable[..., tuple[TrainState, dict]]:
    """``loss_fn(params, *inputs) -> (loss, metrics)`` becomes
    ``step(state, *inputs) -> (state, metrics)``: loss and metrics,
    backward, global-norm clip, AdamW update at ``schedule(state.step)``.
    Metrics gain ``train/lr`` and ``train/grad_norm`` (before clipping)."""

    def step(state: TrainState, *inputs) -> tuple[TrainState, dict]:
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.params, *inputs)
        loss.backward()
        norm = tx.apply_(state.optimizer, state.step)
        metrics = dict(metrics)
        metrics['train/lr'] = schedule(state.step)
        metrics['train/grad_norm'] = norm
        return TrainState(state.params, state.optimizer, state.step + 1), \
            metrics

    return step
