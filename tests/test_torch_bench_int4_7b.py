"""The port of ``scripts/bench/bench_int4_7b.py`` on the CPU: the JAX
script's ``init_params_quantized`` tree (int4 layers with a flattened
``o`` and fused qkv / gate_up, or int8-COMPUTE layers; an int8-COMPUTE head
in both) through ``models/bridge.py`` decodes the JAX engine's greedy
tokens in the port's engine, dense and paged, in float32 compute; and the
port's own ``run(tiny=True)`` serves every request in all four modes."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.generation import (  # noqa: E402
    ContinuousBatchingEngine,
    GenerationConfig,
)
from align_anything_tpu_torch.models import llama_config  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.quantization import (  # noqa: E402
    Int4Weight,
    Int8Weight,
)
from align_anything_tpu_torch.scripts.bench import bench_int4_7b  # noqa: E402
from align_anything_tpu_torch.scripts.bench.timing_utils import kv_gb  # noqa: E402

from test_torch_paged import one_thread  # noqa: E402,F401
from test_torch_quantization_int8 import np_tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=512, hidden=128, layers=2, heads=4, kv_heads=2,
            mlp=256, max_pos=512)
# special tokens inside the toy vocab in both packages (JAX clamps a pad
# id past the vocab, the port's embedding lookup does not)
SPECIAL = dict(bos_token_id=1, eos_token_id=2, pad_token_id=0,
               compute_dtype='float32', attention_impl='xla')


@pytest.fixture(scope='module')
def jscript():
    jax = pytest.importorskip('jax')
    spec = importlib.util.spec_from_file_location(
        'jax_bench_int4_7b',
        os.path.join(REPO, 'scripts/bench/bench_int4_7b.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return jax, mod


@pytest.mark.parametrize('mode', ['int4', 'int8'])
def test_jax_tree_decodes_the_same_tokens(jscript, mode):
    jax, mod = jscript
    from align_anything_tpu.generation import continuous as jcont
    from align_anything_tpu.generation import engine as jeng
    from align_anything_tpu.models import llama_config as jllama

    jcfg = jllama(**TINY).replace(**SPECIAL)
    jparams = mod.init_params_quantized(jcfg, jax.random.PRNGKey(0), mode)
    tparams = from_jax_tree(np_tree(jparams), device='cpu')
    tcfg = llama_config(**TINY).replace(**SPECIAL)
    layers = tparams['layers']
    if mode == 'int4':
        assert sorted(layers) == ['attn_norm', 'down', 'gate_up', 'mlp_norm',
                                  'o', 'qkv']
        # o flattened: (n, G, gs/2, E) over the whole (h * d) contraction
        assert isinstance(layers['o']['w'], Int4Weight)
        assert layers['o']['w'].values.shape == (2, 2, 32, 128)
    else:
        assert all(isinstance(layers[k]['w'], Int8Weight)
                   for k in ('q', 'k', 'v', 'o', 'up', 'gate', 'down'))
    assert isinstance(tparams['lm_head'], Int8Weight)
    assert tparams['lm_head'].compute

    rng = np.random.default_rng(0)
    reqs = [{'input_ids': rng.integers(5, 511, size=24).tolist(),
             'max_new_tokens': 8} for _ in range(4)]
    kw = dict(num_slots=2, max_len=64, prompt_buckets=(32,))
    for cache_mode in ('dense', 'paged'):
        want = jcont.ContinuousBatchingEngine(
            jcfg, cache_mode=cache_mode, **kw).generate(
                jparams, reqs, jeng.GenerationConfig(
                    max_new_tokens=8, greedy=True, eos_token_id=-1),
                jax.random.PRNGKey(1), chunk_steps=4, overlap=False)
        got = ContinuousBatchingEngine(
            tcfg, cache_mode=cache_mode, **kw).generate(
                tparams, reqs, GenerationConfig(
                    max_new_tokens=8, greedy=True, eos_token_id=-1),
                torch.Generator().manual_seed(1), chunk_steps=4)
        assert got == want
        assert all(len(o) == 8 for o in got)


@pytest.mark.parametrize('mode', ['int4', 'int8'])
def test_run_tiny(mode):
    """The script's ``run`` at its toy geometry on the CPU, dense and
    paged: every request gives its budget, the same tokens in both cache
    modes (bf16 compute, one process)."""
    out = {}
    for cache_mode in ('dense', 'paged'):
        r = bench_int4_7b.run(mode, tiny=True, slots=8,
                              cache_mode=cache_mode, device='cpu')
        assert r['mode'] == mode and r['cache_mode'] == cache_mode
        assert r['tokens'] == r['requests'] * r['new_tokens'] == 32
        assert r['lanes'] == 32 and r['device'] == 'cpu'
        assert r['hbm_resident_gb'] == round(r['weights_gb'] + r['kv_gb'], 2)
        out[cache_mode] = r['outputs']
    assert out['dense'] == out['paged']
    cfg = llama_config(**TINY)
    assert kv_gb(cfg, 32, 256) == round(2 * 2 * 2 * 32 * 256 * 32 * 2
                                        / 2**30, 2)
