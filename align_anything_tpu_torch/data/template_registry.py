"""Dataset-template registry (parity with utils/template_registry.py:20-47):
the port of ``align_anything_tpu/data/template_registry.py``, unchanged."""

from __future__ import annotations

from typing import Any, Type

TEMPLATE_REGISTRY: dict[str, Type] = {}


def register_template(name: str):
    """Class decorator mapping a template-name string to a formatter class."""

    def decorator(cls):
        TEMPLATE_REGISTRY[name] = cls
        return cls

    return decorator


def get_template_class(name: str) -> Any:
    if name not in TEMPLATE_REGISTRY:
        raise ValueError(
            f'Template "{name}" not registered. '
            f'Available: {sorted(TEMPLATE_REGISTRY)}'
        )
    return TEMPLATE_REGISTRY[name]()
