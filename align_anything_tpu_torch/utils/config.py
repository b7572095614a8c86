"""Config system: YAML defaults -> env-var overrides -> CLI overrides: the
port of ``align_anything_tpu/utils/config.py``, with the same functions and
the same coercions.

The configs are the port's own copies under
``align_anything_tpu_torch/configs/`` (the text-to-text and
text-image-to-text train configs and ``parallel/mesh_fsdp.json``, plus
``parallel/single_gpu_dots_saveable.json``, which the JAX package does not
have); the JAX package's files are never read.  ``yaml`` is imported
where it is used, not with the module.  A parallel config here describes
one GPU: ``trainers/base.py`` raises for a mesh axis other than data or
fsdp above 1.

Behavior-parity with the reference three-layer override scheme
(reference: align_anything/utils/tools.py:169-206,331-375):

- ``read_cfgs(mode, task)`` loads ``configs/<mode>/<task>.yaml``.
- Env vars ``ENV_PREFIX__section__key=value`` override any nested key.
- Unknown CLI args ``--a:b value`` parsed by ``custom_cfgs_to_dict`` +
  ``update_dict`` override any nested key (dashes become underscores).
- ``dict_to_namedtuple`` gives attribute access with silent ``None`` for
  missing keys.

Where the reference pairs the YAML with a DeepSpeed JSON
(``train_cfgs.ds_cfgs``), this framework pairs it with a *parallelism
config* (``train_cfgs.parallel_cfgs``, JSON under ``configs/parallel/``)
describing the device mesh: dp/fsdp/tp/sp/ep axis sizes, remat policy and
param dtype. ``ZERO_STAGE_FILE``'s analog is the ``MESH_FILE`` env var.
"""

from __future__ import annotations

import json
import os
from collections import namedtuple
from typing import Any



ENV_PREFIX = 'ENV_PREFIX__'


def set_nested_value(config: dict, keys: list[str], value: Any) -> None:
    for key in keys[:-1]:
        config = config.setdefault(key, {})
    config[keys[-1]] = value


def override_nested_value(config: dict, keys: list[str], value: Any) -> None:
    """Recursively apply the override wherever the key path matches."""
    for subconfig in config.values():
        if isinstance(subconfig, dict):
            override_nested_value(subconfig, keys, value)
    if keys[0] in config:
        set_nested_value(config, keys, value)


def _coerce_scalar(value: str) -> Any:
    """Coerce an override string: bool/int/float if possible, else YAML, else str.

    Note ``yaml.safe_load`` alone is not enough: YAML 1.1 parses ``9e-4`` as a
    *string* (exponent floats need a dot), which would silently break
    ``ENV_PREFIX__LEARNING_RATE=9e-4``.
    """
    if value == 'True':
        return True
    if value == 'False':
        return False
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    import yaml  # noqa: PLC0415

    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def override_with_env_variables(config: dict, env_prefix: str = ENV_PREFIX) -> None:
    for key, value in os.environ.items():
        if key.startswith(env_prefix):
            keys = key[len(env_prefix):].lower().split('__')
            override_nested_value(config, keys, _coerce_scalar(value))


def yaml_load(yaml_path: str | os.PathLike) -> dict[str, Any]:
    import yaml  # noqa: PLC0415

    with open(yaml_path, encoding='utf-8') as f:
        configs = yaml.safe_load(f)
    override_with_env_variables(configs)
    return configs


def _configs_root() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'configs')


def read_cfgs(mode: str, task: str) -> tuple[dict[str, Any], dict[str, Any]]:
    """Load (task configs, parallel/mesh configs) for ``configs/<mode>/<task>.yaml``.

    The second return value plays the role of the reference's DeepSpeed JSON:
    it is the machine-level parallelism config selected by
    ``train_cfgs.parallel_cfgs`` (overridable via the ``MESH_FILE`` env var).
    """
    yaml_path = os.path.join(_configs_root(), mode, f'{task}.yaml')
    configs = yaml_load(yaml_path)

    mesh_file = os.getenv(
        'MESH_FILE',
        configs.get('train_cfgs', {}).get('parallel_cfgs') or 'mesh_fsdp.json',
    )
    mesh_path = os.path.join(_configs_root(), 'parallel', mesh_file)
    with open(mesh_path) as f:
        parallel_cfgs = json.load(f)
    return configs, parallel_cfgs


def update_dict(total_dict: dict[str, Any], item_dict: dict[str, Any]) -> dict[str, Any]:
    """Recursively push ``item_dict``'s keys into every matching level of ``total_dict``.

    Improvement over the reference (tools.py:330-340): when both sides are
    dicts the override *merges* instead of replacing, so a nested CLI key
    like ``--train_cfgs:epochs 3`` does not wipe out the rest of
    ``train_cfgs``.  Leaf-key overrides behave identically to the reference.
    """
    for key, value in total_dict.items():
        if key in item_dict:
            if isinstance(value, dict) and isinstance(item_dict[key], dict):
                update_dict(value, item_dict[key])
            else:
                total_dict[key] = item_dict[key]
        if isinstance(value, dict):
            update_dict(value, item_dict)
    return total_dict


def is_convertible_to_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def custom_cfgs_to_dict(key_list: str, value: Any) -> dict[str, Any]:
    """Convert a ``--a:b value`` CLI override into a nested dict.

    Same value coercions as the reference (tools.py:351-375): True/False,
    int, float, ``[a,b,c]`` lists, comma lists, else string.
    """
    if value == 'True':
        value = True
    elif value == 'False':
        value = False
    elif isinstance(value, str) and value.isdigit():
        value = int(value)
    elif isinstance(value, str) and is_convertible_to_float(value):
        value = float(value)
    elif isinstance(value, str) and value.startswith('[') and value.endswith(']'):
        value = list(filter(None, value[1:-1].split(',')))
    elif isinstance(value, str) and ',' in value:
        value = list(filter(None, value.split(',')))
    else:
        value = str(value)

    keys_split = key_list.replace('-', '_').split(':')
    return_dict: dict[str, Any] = {keys_split[-1]: value}
    for key in reversed(keys_split[:-1]):
        return_dict = {key: return_dict}
    return return_dict


def parse_unknown_args(unknown_args: list[str]) -> dict[str, Any]:
    """Parse ``--key value [--key value ...]`` pairs into one nested override dict.

    Mirrors the trainers' main() loops (reference: ppo.py:569-575).
    """
    keys = [k[2:] for k in unknown_args[0::2]]
    values = unknown_args[1::2]
    overrides: dict[str, Any] = {}
    for k, v in zip(keys, values):
        for key, val in custom_cfgs_to_dict(k, v).items():
            if key in overrides and isinstance(overrides[key], dict) and isinstance(val, dict):
                overrides[key].update(val)
            else:
                overrides[key] = val
    return overrides


def dict_to_namedtuple(dic: dict) -> Any:
    """Nested dict -> namedtuple; missing attribute access returns ``None``."""

    def convert(value: Any) -> Any:
        if isinstance(value, dict):
            return dict_to_namedtuple(value)
        if isinstance(value, list):
            return [convert(item) for item in value]
        return value

    class EnhancedNamedTuple(namedtuple('configs', dic.keys())):
        __slots__ = ()

        def __getattr__(self, item):
            return None

    return EnhancedNamedTuple(**{k: convert(v) for k, v in dic.items()})


def namedtuple_to_dict(obj: Any) -> Any:
    if obj is None:
        return {}
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return {k: namedtuple_to_dict(v) for k, v in obj._asdict().items()}
    if isinstance(obj, list):
        return [namedtuple_to_dict(v) for v in obj]
    return obj
