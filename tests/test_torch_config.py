"""The port's config system (``align_anything_tpu_torch/utils/config.py``)
against the JAX package's: the cases of ``tests/test_config.py`` through
both, and the port's copies of the configs against the JAX files.

Both read YAML with ``yaml.safe_load`` and coerce override strings with the
same ``_coerce_scalar``, so no override string is coerced differently:
``test_coercion_matches_jax`` holds that over strings where YAML 1.1 and
Python disagree (``yes`` / ``on`` / ``off`` -> bool, ``9e-4`` -> float,
``~`` / ``null`` -> None, flow lists and maps).  Results are compared
exactly.
"""

import json
import os
import textwrap

import pytest

pytest.importorskip('torch')
yaml = pytest.importorskip('yaml')

from align_anything_tpu.utils import config as jcfg  # noqa: E402
from align_anything_tpu_torch.utils import config as tcfg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# text-to-text tasks by name; the others by their path under train/
TASKS = ('sft', 'dpo', 'orpo', 'simpo', 'rm', 'ppo', 'kto', 'grpo',
         'saferlhf', 'text_image_to_text/sft', 'text_image_to_text/dpo',
         'text_image_to_text/rm', 'text_image_to_text/ppo',
         'text_image_to_text/grpo', 'text_image_to_text/saferlhf',
         'text_video_to_text/sft', 'text_video_to_text/dpo',
         'text_video_to_text/rm', 'text_video_to_text/ppo',
         'text_audio_to_text/sft', 'text_audio_to_text/dpo',
         'text_audio_to_text/rm', 'text_audio_to_text/ppo')
BOTH = pytest.mark.parametrize('m', [jcfg, tcfg], ids=['jax', 'port'])


@BOTH
def test_custom_cfgs_to_dict_coercions(m):
    assert m.custom_cfgs_to_dict('train_cfgs:learning_rate', '1e-5') == {
        'train_cfgs': {'learning_rate': 1e-5}}
    assert m.custom_cfgs_to_dict('a:b:c', '3') == {'a': {'b': {'c': 3}}}
    assert m.custom_cfgs_to_dict('x', 'True') == {'x': True}
    assert m.custom_cfgs_to_dict('x', 'False') == {'x': False}
    assert m.custom_cfgs_to_dict('x', '[1,2,3]') == {'x': ['1', '2', '3']}
    assert m.custom_cfgs_to_dict('x', 'a,b') == {'x': ['a', 'b']}
    assert m.custom_cfgs_to_dict('model-cfgs:name', 'opt') == {
        'model_cfgs': {'name': 'opt'}}


@BOTH
def test_update_dict_recursive_override(m):
    total = {'train_cfgs': {'learning_rate': 1.0, 'nested': {'epochs': 1}}}
    out = m.update_dict(total, {'learning_rate': 2.0, 'epochs': 3})
    assert out['train_cfgs']['learning_rate'] == 2.0
    assert out['train_cfgs']['nested']['epochs'] == 3


@BOTH
def test_parse_unknown_args(m):
    overrides = m.parse_unknown_args(
        ['--train_cfgs:learning_rate', '5e-4',
         '--model_cfgs:model_max_length', '128'])
    assert overrides == {'train_cfgs': {'learning_rate': 5e-4},
                         'model_cfgs': {'model_max_length': 128}}


@BOTH
def test_env_override(m, monkeypatch):
    cfg = {'train_cfgs': {'seed': 42, 'inner': {'seed': 42}}}
    monkeypatch.setenv('ENV_PREFIX__SEED', '7')
    m.override_with_env_variables(cfg)
    assert cfg['train_cfgs']['seed'] == 7
    assert cfg['train_cfgs']['inner']['seed'] == 7


@BOTH
def test_dict_to_namedtuple_missing_is_none(m):
    cfgs = m.dict_to_namedtuple({'a': {'b': 1}, 'c': [1, {'d': 2}]})
    assert cfgs.a.b == 1
    assert cfgs.a.missing_key is None
    assert cfgs.c[1].d == 2
    assert m.namedtuple_to_dict(cfgs) == {'a': {'b': 1}, 'c': [1, {'d': 2}]}


@BOTH
def test_yaml_load_env(m, tmp_path, monkeypatch):
    p = tmp_path / 'cfg.yaml'
    p.write_text(textwrap.dedent('''
        train_cfgs:
          learning_rate: 2.e-5
          epochs: 1
    '''))
    monkeypatch.setenv('ENV_PREFIX__EPOCHS', '5')
    cfg = m.yaml_load(p)
    assert cfg['train_cfgs']['learning_rate'] == 2e-5
    assert cfg['train_cfgs']['epochs'] == 5


OVERRIDES = ['True', 'False', 'true', 'yes', 'no', 'on', 'off', 'y', 'n',
             '3', '-3', '0x1f', '1_000', '9e-4', '2.e-5', '.5', 'inf', 'nan',
             '~', 'null', 'None', '', '[1, 2]', '{a: 1}', 'a: b', 'opt',
             'Alpaca', '2024-01-01', "'quoted'", '[unclosed']


@pytest.mark.parametrize('value', OVERRIDES)
def test_coercion_matches_jax(value):
    want, got = jcfg._coerce_scalar(value), tcfg._coerce_scalar(value)
    assert type(got) is type(want)
    assert got == want or (got != got and want != want)   # nan


@pytest.mark.parametrize('task', TASKS)
def test_config_copies_equal_the_jax_files(task):
    if '/' not in task:
        task = f'text_to_text/{task}'
    rel = os.path.join('train', f'{task}.yaml')
    with open(os.path.join(REPO, 'align_anything_tpu', 'configs', rel)) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(REPO, 'align_anything_tpu_torch', 'configs',
                           rel)) as f:
        got = yaml.safe_load(f)
    assert got == want
    assert tcfg.read_cfgs('train', task) == jcfg.read_cfgs('train', task)


def test_parallel_configs():
    """The default parallel config, mesh_fsdp.json, is the JAX file's
    copy."""
    name = 'mesh_fsdp.json'
    with open(os.path.join(REPO, 'align_anything_tpu', 'configs', 'parallel',
                           name)) as f:
        want = json.load(f)
    _, got = tcfg.read_cfgs('train', 'text_to_text/sft')
    assert got == want


def test_read_cfgs_mesh_file_env(monkeypatch):
    """``MESH_FILE`` selects the port's own one-GPU config."""
    monkeypatch.setenv('MESH_FILE', 'single_gpu_dots_saveable.json')
    cfgs, parallel_cfgs = tcfg.read_cfgs(mode='train',
                                         task='text_to_text/sft')
    assert cfgs['train_cfgs']['seed'] == 42
    assert parallel_cfgs['remat'] == 'dots_saveable'
    assert set(parallel_cfgs['mesh'].values()) == {1}
