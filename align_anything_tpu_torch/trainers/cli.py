"""Shared trainer main(): config resolution + CLI overrides + launch, the
port of ``align_anything_tpu/trainers/cli.py``.

Mirrors the reference's per-trainer main() pattern (ppo.py:556-584):
read YAML + parallel config JSON, apply `--key value` overrides, build the
trainer, train, save.  The JAX ``apply_platform_env`` (JAX platform and
device-count variables, the multi-host control plane) has no counterpart:
the trainer runs on ``cuda:0`` unless ``trainer_main``'s caller passes
``device``.
"""

from __future__ import annotations

import argparse

import torch

from align_anything_tpu_torch import checkpoint as ckpt_lib
from align_anything_tpu_torch.utils.config import (
    custom_cfgs_to_dict,
    dict_to_namedtuple,
    read_cfgs,
    update_dict,
)


def parse_cfgs(task: str, argv: list[str] | None = None):
    dict_cfgs, parallel_cfgs = read_cfgs(mode='train', task=task)
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _, unparsed = parser.parse_known_args(argv)
    keys = [k[2:] for k in unparsed[0::2]]
    values = unparsed[1::2]
    for k, v in zip(keys, values):
        dict_cfgs = update_dict(dict_cfgs, custom_cfgs_to_dict(k, v))
    return dict_to_namedtuple(dict_cfgs), parallel_cfgs


def trainer_main(trainer_cls, task: str, argv: list[str] | None = None,
                 device: torch.device | str | None = None):
    """Parse ``argv`` (default: the command line), build ``trainer_cls`` on
    ``device`` (default: the first CUDA device), train, save."""
    cfgs, parallel_cfgs = parse_cfgs(task, argv)
    trainer = trainer_cls(cfgs=cfgs, parallel_cfgs=parallel_cfgs,
                          device=device)
    trainer.train()
    if not trainer._preempted:  # preemption already saved
        trainer.save()
        ckpt_lib.wait_for_saves()
    return trainer
