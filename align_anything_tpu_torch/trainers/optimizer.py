"""Optimizer + LR schedule factory: the port of
``align_anything_tpu/trainers/optimizer.py``.

``optax.chain(clip_by_global_norm, adamw(schedule))`` becomes
``torch.optim.AdamW`` over the leaves of a param tree plus a global-norm
clip and a schedule, with optax's semantics: the learning rate of update t
(counted from 0) is ``schedule(t)``; weight decay is decoupled; eps is added
outside the square root; the clip scales by max_norm / norm only when the
norm reaches max_norm, and ``max_grad_norm=0`` turns it off.

``gradient_accumulation_steps=k > 1`` wraps the whole chain as
``optax.MultiSteps(chain, k)`` does (``MultiSteps`` below): each call
folds this step's gradients into a running mean; every k-th call the clip
and AdamW run once, on that mean, and AdamW's count (its bias correction
and the ``schedule(count)`` it applies) advances once per update, not per
call.

``frozen_labels`` (a tree of ``'train'`` / ``'frozen'`` from
``freeze_labels``) is ``optax.multi_transform({'train': chain, 'frozen':
set_to_zero()})``: the optimizer holds only the trainable leaves, so a
frozen leaf has no AdamW state, gets no update and no weight decay, stays
out of the global-norm clip and, under ``MultiSteps``, out of the running
mean.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable

import torch

from align_anything_tpu_torch.utils.tools import param_leaves

Schedule = Callable[[int], float]


def freeze_labels(params: dict, frozen_modules: tuple[str, ...]) -> dict:
    """Label tree for ``make_optimizer(frozen_labels=...)``: ``'frozen'`` for
    every leaf whose path has one of ``frozen_modules`` as a component,
    ``'train'`` otherwise (the reference's ``param.requires_grad_(False)``
    by module name, models/pretrained_model.py:265-281)."""
    def label(tree: Any, frozen: bool) -> Any:
        if isinstance(tree, dict):
            return {k: label(v, frozen or k in frozen_modules)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [label(v, frozen) for v in tree]
        return 'frozen' if frozen else 'train'
    return label(params, False)


def trainable_leaves(params: dict, labels: dict | None
                     ) -> list[torch.Tensor]:
    """The leaves of ``params`` labelled ``'train'`` (all of them without
    labels), in ``param_leaves`` order."""
    leaves = param_leaves(params)
    if labels is None:
        return leaves
    flags = param_leaves(labels)
    if len(flags) != len(leaves):
        raise ValueError('frozen_labels does not match the param tree')
    return [t for t, f in zip(leaves, flags) if f == 'train']


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    return lambda t: init + (end - init) * min(max(t, 0), steps) / steps


def _cosine(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0."""
    return lambda t: init * 0.5 * (1 + math.cos(
        math.pi * min(max(t, 0), steps) / steps))


def make_schedule(learning_rate: float, lr_scheduler_type: str,
                  total_steps: int, lr_warmup_ratio: float = 0.0) -> Schedule:
    """Constant, linear or cosine decay after an optional linear warmup."""
    warmup_steps = int(lr_warmup_ratio * total_steps)
    kind = (lr_scheduler_type or 'constant').lower()
    decay_steps = max(total_steps - warmup_steps, 1)
    if kind == 'constant':
        after: Schedule = lambda t: learning_rate  # noqa: E731
    elif kind == 'linear':
        after = _linear(learning_rate, 0.0, decay_steps)
    elif kind == 'cosine':
        after = _cosine(learning_rate, decay_steps)
    else:
        raise ValueError(f'unknown lr_scheduler_type: {lr_scheduler_type}')
    if warmup_steps == 0:
        return after
    warmup = _linear(0.0, learning_rate, warmup_steps)
    # optax.join_schedules: the second schedule sees t - boundary
    return lambda t: warmup(t) if t < warmup_steps else after(t - warmup_steps)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all elements, fp32, on device."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    b1, b2, eps, weight_decay))`` for torch.

    ``init(params)`` makes the ``torch.optim.AdamW`` over the tree's
    trainable leaves (all of them, or those ``frozen_labels`` marks
    ``'train'``; its state holds the moments); ``apply_(optimizer, step)``
    clips the leaves' ``.grad`` in place, sets the learning rate to
    ``schedule(step)`` and steps, updating the params in place.  A leaf without ``.grad``
    gets a zero gradient first, so weight decay moves it as optax's does.
    It returns the global norm of the gradients before clipping."""

    def __init__(self, schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: float,
                 frozen_labels: dict | None = None):
        self.schedule = schedule
        self.betas = (b1, b2)
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.frozen_labels = frozen_labels

    def init(self, params: dict) -> torch.optim.AdamW:
        return torch.optim.AdamW(trainable_leaves(params, self.frozen_labels),
                                 lr=self.schedule(0),
                                 betas=self.betas, eps=self.eps,
                                 weight_decay=self.weight_decay)

    def apply_(self, optimizer: torch.optim.Optimizer,
               step: int) -> torch.Tensor:
        params = [p for group in optimizer.param_groups
                  for p in group['params']]
        for p in params:
            # a leaf the loss never read (a score model's lm_head) gets a
            # zero gradient, as JAX gives it: AdamW then still applies its
            # decoupled weight decay, where torch would skip the leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if self.max_grad_norm:
            scale = torch.where(norm < self.max_grad_norm,
                                torch.ones_like(norm),
                                self.max_grad_norm / norm)
            for g in grads:
                g.mul_(scale)
        for group in optimizer.param_groups:
            group['lr'] = self.schedule(step)
        optimizer.step()
        return norm


class AccumulatingOptimizer:
    """The optimizer state of ``MultiSteps``: the inner
    ``torch.optim.AdamW``, the running mean of the gradients since the last
    update, the calls folded into it (``mini_step``) and the updates taken
    (``updates``, AdamW's count).  ``zero_grad``, ``param_groups``,
    ``state_dict`` and ``load_state_dict`` as a torch optimizer's."""

    def __init__(self, inner: torch.optim.Optimizer):
        self.inner = inner
        self.acc = [torch.zeros_like(p) for group in inner.param_groups
                    for p in group['params']]
        self.mini_step = 0
        self.updates = 0

    @property
    def param_groups(self) -> list:
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        return {'inner': self.inner.state_dict(), 'acc': self.acc,
                'mini_step': self.mini_step, 'updates': self.updates}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state['inner'])
        for a, saved in zip(self.acc, state['acc']):
            a.copy_(saved)
        self.mini_step = int(state['mini_step'])
        self.updates = int(state['updates'])


class MultiSteps:
    """``optax.MultiSteps(inner, k)``: ``init`` and ``apply_`` as
    ``ClippedAdamW``'s.  ``apply_`` folds the leaves' ``.grad`` into the
    running mean ``acc + (g - acc) / (mini_step + 1)``, as optax does; on
    every k-th call it hands the mean to the inner chain (clip, AdamW at
    ``schedule(updates)``) and resets the mean.  Between updates the params
    do not move.  It returns the global norm of this call's gradients."""

    def __init__(self, inner: ClippedAdamW, every_k: int):
        self.inner = inner
        self.every_k = every_k

    @property
    def frozen_labels(self) -> dict | None:
        return self.inner.frozen_labels

    def init(self, params: dict) -> AccumulatingOptimizer:
        return AccumulatingOptimizer(self.inner.init(params))

    def apply_(self, optimizer: AccumulatingOptimizer,
               step: int) -> torch.Tensor:
        params = [p for group in optimizer.param_groups
                  for p in group['params']]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        norm = global_norm(grads)
        n = optimizer.mini_step
        for a, g in zip(optimizer.acc, grads):
            a.copy_(a + (g - a) / (n + 1))
        if n < self.every_k - 1:
            optimizer.mini_step = n + 1
            return norm
        for p, a in zip(params, optimizer.acc):
            p.grad = a.clone()
        self.inner.apply_(optimizer.inner, optimizer.updates)
        for a in optimizer.acc:
            a.zero_()
        optimizer.mini_step = 0
        optimizer.updates += 1
        return norm


def make_optimizer(learning_rate: float, *,
                   lr_scheduler_type: str = 'constant', total_steps: int = 1, lr_warmup_ratio: float = 0.0,
                   weight_decay: float = 0.0,
                   adam_betas: tuple[float, float] = (0.9, 0.95),
                   adam_epsilon: float = 1e-8,
                   max_grad_norm: float = 1.0,
                   gradient_accumulation_steps: int = 1,
                   frozen_labels: dict | None = None,
                   ) -> tuple[ClippedAdamW | MultiSteps, Schedule]:
    """(optimizer, schedule), the JAX ``make_optimizer``'s signature."""
    schedule = make_schedule(learning_rate, lr_scheduler_type, total_steps,
                             lr_warmup_ratio)
    tx = ClippedAdamW(schedule, adam_betas[0], adam_betas[1], adam_epsilon,
                      weight_decay, max_grad_norm, frozen_labels)
    if gradient_accumulation_steps > 1:
        return MultiSteps(tx, gradient_accumulation_steps), schedule
    return tx, schedule
