"""Singleton training logger: wandb | tensorboard | stdout-only: the port of
``align_anything_tpu/utils/logger.py``.

The reference Logger's behaviour (align_anything/utils/logger.py:64-196):
metric dict logging, config + environment snapshots, and rich-table sample
dumps.  The port runs one process, so ``is_main_process()`` is always
True.  ``wandb``, ``tensorboard`` and ``yaml`` are imported only where
they are used; without ``yaml`` the config snapshot is written as
``arguments.json`` in place of ``arguments.yaml``, and ``torch_env.json``
takes the place of ``jax_env.json``.
"""

from __future__ import annotations

import atexit
import json
import os
import time
from typing import Any



def is_main_process() -> bool:
    """One process drives one GPU: always the main one."""
    return True


def rank_zero_only(fn):
    def wrapper(*args, **kwargs):
        if is_main_process():
            return fn(*args, **kwargs)
        return None

    return wrapper


class Logger:
    """Rank-0 metric logger with pluggable backend.

    ``log_type`` in {'wandb', 'tensorboard', 'none'}; falls back to stdout if
    the backend package is unavailable (e.g. an air-gapped machine).
    """

    _instance = None

    def __new__(cls, *args, **kwargs):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __init__(
        self,
        log_type: str = 'none',
        log_dir: str | None = None,
        log_project: str | None = None,
        log_run_name: str | None = None,
        config: dict[str, Any] | None = None,
    ) -> None:
        if getattr(self, '_initialized', False):
            return
        self._initialized = True
        self.log_type = (log_type or 'none').lower()
        self.log_dir = log_dir
        self.writer = None
        self.wandb = None
        self._t0 = time.monotonic()

        if not is_main_process():
            return

        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            self._dump_snapshots(config or {})

        if self.log_type == 'wandb':
            try:
                import wandb  # noqa: PLC0415

                wandb.init(
                    project=log_project or 'align-anything',
                    name=log_run_name,
                    dir=self.log_dir,
                    config=config,
                    mode=os.getenv('WANDB_MODE', 'offline'),
                )
                self.wandb = wandb
            except Exception as exc:  # pragma: no cover - depends on env
                self.print(f'wandb unavailable ({exc}); falling back to stdout logging')
                self.log_type = 'none'
        elif self.log_type == 'tensorboard':
            try:
                from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415

                self.writer = SummaryWriter(log_dir=self.log_dir)
                atexit.register(self.writer.close)
            except Exception as exc:  # pragma: no cover
                self.print(f'tensorboard unavailable ({exc}); falling back to stdout logging')
                self.log_type = 'none'

    def _dump_snapshots(self, config: dict[str, Any]) -> None:
        """Persist the resolved config and environment (reference logger.py:109-120)."""
        try:
            import yaml  # noqa: PLC0415
        except ImportError:
            with open(os.path.join(self.log_dir, 'arguments.json'), 'w') as f:
                json.dump(config, f, indent=2)
        else:
            with open(os.path.join(self.log_dir, 'arguments.yaml'), 'w') as f:
                yaml.safe_dump(config, f, default_flow_style=False)
        with open(os.path.join(self.log_dir, 'environ.txt'), 'w') as f:
            for key in sorted(os.environ):
                f.write(f'{key}={os.environ[key]}\n')
        import torch  # noqa: PLC0415

        cuda = torch.cuda.is_available()
        with open(os.path.join(self.log_dir, 'torch_env.json'), 'w') as f:
            json.dump(
                {
                    'torch_version': torch.__version__,
                    'cuda_version': torch.version.cuda,
                    'device': torch.cuda.get_device_name(0) if cuda else 'cpu',
                    'device_count': torch.cuda.device_count(),
                },
                f,
                indent=2,
            )

    @rank_zero_only
    def log(self, metrics: dict[str, Any], step: int) -> None:
        metrics = {k: (float(v) if hasattr(v, 'item') or isinstance(v, (int, float)) else v)
                   for k, v in metrics.items()}
        if self.log_type == 'wandb' and self.wandb is not None:
            self.wandb.log(metrics, step=step)
        elif self.log_type == 'tensorboard' and self.writer is not None:
            for key, value in metrics.items():
                if isinstance(value, (int, float)):
                    self.writer.add_scalar(key, value, global_step=step)

    @rank_zero_only
    def print(self, message: str) -> None:
        print(message, flush=True)

    @rank_zero_only
    def print_table(self, title: str, columns: list[str], rows: list[list[Any]],
                    max_num_rows: int | None = None) -> None:
        """Sample-dump table during eval (reference logger.py:164-196)."""
        if max_num_rows is not None:
            rows = rows[:max_num_rows]
        try:
            from rich.console import Console  # noqa: PLC0415
            from rich.table import Table  # noqa: PLC0415

            table = Table(title=title, show_lines=True)
            for col in columns:
                table.add_column(col, overflow='fold')
            for row in rows:
                table.add_row(*[str(x) for x in row])
            Console(soft_wrap=True).print(table)
        except Exception:
            print(f'== {title} ==')
            print('\t'.join(columns))
            for row in rows:
                print('\t'.join(str(x) for x in row))

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton (used by tests and multi-trainer processes)."""
        cls._instance = None
