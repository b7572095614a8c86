"""The PyTorch port imports no JAX, directly or through the JAX package,
and none of ``yaml``, ``safetensors``, ``transformers``, ``datasets`` or
``orbax`` with its modules (it imports them only inside the functions that
use them, and the card's path needs none of them)."""

import os
import subprocess
import sys

import pytest

pytest.importorskip('torch')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, pkgutil, sys
import align_anything_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               'align_anything_tpu_torch.')]
for name in names:
    importlib.import_module(name)
# the A/B bench, the port of scripts/bench/bench_int4_kernel_ab.py, the
# trainer harness, the reward-model and PPO trainers, KTO, GRPO,
# Safe-RLHF and the two PPO variants with the remote reward model, the
# LLaVA image-text path, the image-text RL and preference trainers, LoRA,
# the HTTP server and the 8B int4 / int8 serving bench, the video data and
# the text-video-to-text trainers, the Qwen2-VL and Qwen2.5-VL models, the
# audio frontend, the Qwen2-Audio model, the audio data, the
# text-audio-to-text trainers and the Mllama model
for name in ('scripts.bench.bench_int4_kernel_ab', 'utils.config',
             'utils.logger', 'utils.profiling', 'data.tokenizer',
             'data.template_registry', 'data.chat_template',
             'data.formatters', 'data.datasets', 'models.hf_loader',
             'checkpoint', 'losses.sft', 'trainers.base', 'trainers.cli',
             'trainers.text_to_text.dpo', 'trainers.text_to_text.sft',
             'trainers.text_to_text.orpo', 'trainers.text_to_text.simpo',
             'models.score_model', 'losses.ppo', 'trainers.text_to_text.rm',
             'trainers.text_to_text.cost_model',
             'trainers.text_to_text.rm_score', 'trainers.text_to_text.ppo',
             'trainers.text_to_text.multi_ppo', 'trainers.text_to_text.kto',
             'trainers.text_to_text.grpo', 'trainers.text_to_text.saferlhf',
             'trainers.text_to_text.ppo_remote_rm',
             'trainers.text_to_text.ppo_vllm', 'models.remote_rm',
             'models.remote_rm.client', 'models.remote_rm.server',
             'models.remote_rm.reward_functions', 'models.vision',
             'models.multimodal', 'data.image', 'data.multimodal_formatters',
             'trainers.text_image_to_text', 'trainers.text_image_to_text.sft',
             'trainers.text_image_to_text.dpo',
             'trainers.text_image_to_text.rm',
             'trainers.text_image_to_text.cost_model',
             'trainers.text_image_to_text.ppo',
             'trainers.text_image_to_text.grpo',
             'trainers.text_image_to_text.saferlhf',
             'trainers.text_image_to_text.kto',
             'trainers.text_image_to_text.orpo',
             'trainers.text_image_to_text.simpo', 'models.lora', 'serve',
             'serve.api_server', 'scripts.bench.bench_int4_7b', 'data.video',
             'trainers.text_video_to_text',
             'trainers.text_video_to_text.sft',
             'trainers.text_video_to_text.dpo',
             'trainers.text_video_to_text.rm',
             'trainers.text_video_to_text.ppo',
             'trainers.text_video_to_text.grpo', 'models.qwen2_vl',
             'models.qwen2_5_vl', 'ops.rope', 'ops.audio', 'models.audio',
             'data.audio', 'trainers.text_audio_to_text',
             'trainers.text_audio_to_text.sft',
             'trainers.text_audio_to_text.dpo',
             'trainers.text_audio_to_text.rm',
             'trainers.text_audio_to_text.ppo',
             'trainers.text_audio_to_text.grpo', 'models.mllama'):
    assert 'align_anything_tpu_torch.' + name in names, name
# the mixture-of-experts functions of the decoder and its configs
from align_anything_tpu_torch.models import config, transformer
for fn in (transformer._moe_mlp, transformer._moe_sparse,
           transformer._route, transformer.ragged_dot,
           config.qwen3_moe_config):
    assert callable(fn)
assert {'qwen3-moe-30b-a3b', 'tiny-moe'} <= set(config.PRESETS)
banned = ('jax', 'align_anything_tpu', 'yaml', 'safetensors',
          'transformers', 'datasets', 'orbax')
bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.split(maxsplit=1)
    assert bad.strip() == '[]', bad
    # every module of the slices was imported
    assert int(n) >= 100


@pytest.mark.parametrize('module', [
    'align_anything_tpu_torch.ops.int4_matmul',
    'align_anything_tpu_torch.ops.flash_attention',
    'align_anything_tpu_torch.scripts.bench.bench_int4_kernel_ab',
    'align_anything_tpu_torch.trainers.text_to_text.dpo',
    'align_anything_tpu_torch.checkpoint',
    'align_anything_tpu_torch.trainers.text_to_text.rm_score',
    'align_anything_tpu_torch.trainers.text_to_text.multi_ppo',
    'align_anything_tpu_torch.models.multimodal',
    'align_anything_tpu_torch.trainers.text_image_to_text.dpo',
    'align_anything_tpu_torch.trainers.text_image_to_text.ppo',
    'align_anything_tpu_torch.trainers.text_image_to_text.saferlhf',
    'align_anything_tpu_torch.serve.api_server',
    'align_anything_tpu_torch.scripts.bench.bench_int4_7b',
    'align_anything_tpu_torch.models.audio',
    'align_anything_tpu_torch.trainers.text_audio_to_text.dpo',
    'align_anything_tpu_torch.trainers.text_audio_to_text.grpo',
    'align_anything_tpu_torch.models.mllama',
])
def test_kernel_module_imports_first(module):
    """A module that holds a kernel, or a trainer's entry point, imports on
    its own in a fresh interpreter (``ops/int4_matmul.py`` and ``models/``
    import each other)."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', f'import {module}'],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
