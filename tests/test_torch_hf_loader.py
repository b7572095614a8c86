"""The port's HF checkpoint loader (``align_anything_tpu_torch/models/
hf_loader.py``) against the JAX package's, ``transformers`` and the
``safetensors`` package, on tiny OPT, Llama and Qwen2 checkpoints built
with ``transformers`` config classes and ``save_pretrained`` (as
``tests/test_hf_parity.py`` builds them).

Tolerances: params and configs are compared exactly (both loaders only
move and reshape the stored numbers); logits against ``transformers`` at
fp32 to 2e-4 abs / 1e-3 rel (the JAX parity test's limits: the same math
summed in another order); the codec's tensors exactly, bf16 included.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')

from align_anything_tpu_torch.models import config as tconfig  # noqa: E402
from align_anything_tpu_torch.models import hf_loader as th  # noqa: E402
from align_anything_tpu_torch.models import transformer as tt  # noqa: E402

from test_torch_int4_matmul import np_tree  # noqa: E402

COMMON = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, max_position_embeddings=64)
FAMILIES = {
    'opt': lambda: transformers.OPTForCausalLM(transformers.OPTConfig(
        ffn_dim=64, word_embed_proj_dim=32, do_layer_norm_before=True,
        **COMMON)),
    'llama': lambda: transformers.LlamaForCausalLM(transformers.LlamaConfig(
        intermediate_size=64, num_key_value_heads=2, rope_theta=10000.0,
        tie_word_embeddings=False, **COMMON)),
    'qwen2': lambda: transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        intermediate_size=64, num_key_value_heads=2, rope_theta=10000.0,
        tie_word_embeddings=True, **COMMON)),
}


@pytest.fixture(scope='module', params=sorted(FAMILIES))
def checkpoint(request, tmp_path_factory):
    torch.manual_seed(0)
    model = FAMILIES[request.param]().eval()
    d = tmp_path_factory.mktemp(request.param)
    model.save_pretrained(d, safe_serialization=True)
    return str(d), model


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items()
                for p, leaf in _flat(v, f'{prefix}/{k}').items()}
    return {prefix: tree.detach().numpy() if hasattr(tree, 'detach')
            else np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for path in got:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_load_params_matches_jax(checkpoint):
    from align_anything_tpu.models import hf_loader as jh

    d, _ = checkpoint
    params, cfg = th.load_params(d, device='cpu')
    jparams, jcfg = jh.load_params(d)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_trees_equal(params, np_tree(jparams))


def test_config_from_hf_matches_jax(checkpoint):
    from align_anything_tpu.models import config as jc

    d, _ = checkpoint
    assert dataclasses.asdict(tconfig.config_from_hf(d)) == \
        dataclasses.asdict(jc.config_from_hf(d))


def test_config_from_hf_raises_for_what_the_port_cannot_run(tmp_path):
    """Gemma3's sliding layers map as in JAX and run (since the port runs
    them); a family the port leaves out (MoE) raises."""
    from align_anything_tpu.models import config as jc

    cfg = transformers.Gemma3TextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=64, sliding_window=8,
        layer_types=['sliding_attention', 'full_attention'])
    transformers.Gemma3ForCausalLM(cfg).save_pretrained(
        tmp_path / 'gemma3', safe_serialization=True)
    got = tconfig.config_from_hf(str(tmp_path / 'gemma3'))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jc.config_from_hf(str(tmp_path / 'gemma3')))
    assert (got.sliding_window, got.layer_is_sliding) == (8, (1, 0))
    os.makedirs(tmp_path / 'moe')
    with open(tmp_path / 'moe' / 'config.json', 'w') as f:
        json.dump({'architectures': ['Qwen3MoeForCausalLM']}, f)
    with pytest.raises(ValueError, match='unsupported HF architecture'):
        tconfig.config_from_hf(str(tmp_path / 'moe'))


@pytest.mark.parametrize('padded', [False, True])
def test_logits_match_transformers(checkpoint, padded):
    d, model = checkpoint
    params, cfg = th.load_params(d, device='cpu')
    cfg = cfg.replace(compute_dtype='float32')
    ids = np.array([[2, 5, 6, 7, 8, 9, 10, 11], [2, 12, 13, 14, 15, 16, 1, 1]])
    mask = np.ones_like(ids)
    if padded:
        mask[1, 6:] = 0
    t_ids, t_mask = torch.tensor(ids), torch.tensor(mask)
    with torch.no_grad():
        want = model(input_ids=t_ids, attention_mask=t_mask).logits.numpy()
        got = tt.forward(params, cfg, t_ids, attention_mask=t_mask
                         ).logits.numpy()
    keep = mask.astype(bool)
    np.testing.assert_allclose(got[keep], want[keep], atol=2e-4, rtol=1e-3)


def test_save_params_round_trips_through_jax(checkpoint, tmp_path):
    """The port's export, read by the JAX loader, gives the JAX loader's
    params of the original checkpoint; and ``transformers`` reads it back
    to the same logits."""
    from align_anything_tpu.models import hf_loader as jh

    d, model = checkpoint
    params, cfg = th.load_params(d, device='cpu')
    out = str(tmp_path / 'resaved')
    th.save_params(out, params, cfg)
    with open(os.path.join(out, 'config.json')) as f:
        assert json.load(f) == th._to_hf_config(cfg)
    assert th._to_hf_config(cfg) == jh._to_hf_config(cfg)
    jparams, _ = jh.load_params(out)
    want, _ = jh.load_params(d)
    _assert_trees_equal(np_tree(jparams), np_tree(want))
    reloaded = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    ids = torch.tensor([[2, 5, 6, 7]])
    with torch.no_grad():
        np.testing.assert_array_equal(reloaded(input_ids=ids).logits.numpy(),
                                      model(input_ids=ids).logits.numpy())


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items()
                for p, leaf in _leaves(v, f'{prefix}/{k}').items()}
    return {prefix: tree}


def test_bf16_export_reads_back(checkpoint, tmp_path):
    """``save_params(dtype=bfloat16)`` stores bf16; ``load_params`` reads it
    back, in bf16, as the params rounded to bf16."""
    d, _ = checkpoint
    params, cfg = th.load_params(d, device='cpu')
    out = str(tmp_path / 'bf16')
    th.save_params(out, params, cfg, dtype=torch.bfloat16)
    raw = th.read_safetensors(os.path.join(out, 'model.safetensors'))
    assert {t.dtype for t in raw.values()} == {torch.bfloat16}
    back, _ = th.load_params(out, dtype=torch.bfloat16, device='cpu')
    want, got = _leaves(params), _leaves(back)
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == torch.bfloat16
        assert torch.equal(got[path], leaf.to(torch.bfloat16)), path


def test_sharded_checkpoint_index(checkpoint, tmp_path):
    """``model.safetensors.index.json`` with the tensors split over two
    files loads to the same params."""
    d, _ = checkpoint
    tensors = th.read_safetensors(os.path.join(d, 'model.safetensors'))
    names = sorted(tensors)
    half = len(names) // 2
    out = tmp_path / 'sharded'
    out.mkdir()
    weight_map = {}
    for i, part in enumerate((names[:half], names[half:])):
        fname = f'model-0000{i + 1}-of-00002.safetensors'
        th.write_safetensors(str(out / fname), {n: tensors[n] for n in part})
        weight_map.update(dict.fromkeys(part, fname))
    with open(out / 'model.safetensors.index.json', 'w') as f:
        json.dump({'metadata': {}, 'weight_map': weight_map}, f)
    with open(os.path.join(d, 'config.json')) as f:
        (out / 'config.json').write_text(f.read())
    got, _ = th.load_params(str(out), device='cpu')
    want, _ = th.load_params(d, device='cpu')
    _assert_trees_equal(got, want)


CODEC_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64,
                torch.int32]


def _codec_tensors(seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dtype in enumerate(CODEC_DTYPES):
        shape = [(3, 5), (7,), (2, 3, 4), (1,), ()][i]
        if dtype.is_floating_point:
            out[f't{i}'] = (torch.randn(shape, generator=g) * 100).to(dtype)
        else:
            out[f't{i}'] = torch.randint(-2 ** 30, 2 ** 30, shape,
                                         generator=g).to(dtype)
    out['empty'] = torch.zeros((0, 4), dtype=torch.bfloat16)
    return out


def test_codec_reads_safetensors_files(tmp_path):
    """A file written by ``safetensors`` reads back through the port's codec
    as the same tensors, bf16 included."""
    st = pytest.importorskip('safetensors.torch')
    tensors = _codec_tensors(1)
    path = str(tmp_path / 'lib.safetensors')
    st.save_file(tensors, path, metadata={'format': 'pt'})
    got = th.read_safetensors(path)
    assert set(got) == set(tensors)
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape
        assert torch.equal(got[name], t), name


def test_safetensors_reads_codec_files(tmp_path):
    """A file written by the port's codec reads back through ``safetensors``
    (torch and numpy) as the same tensors, bf16 included."""
    st = pytest.importorskip('safetensors.torch')
    from safetensors import safe_open

    tensors = _codec_tensors(2)
    path = str(tmp_path / 'port.safetensors')
    th.write_safetensors(path, tensors, metadata={'format': 'pt'})
    got = st.load_file(path)
    assert set(got) == set(tensors)
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    with safe_open(path, framework='np') as f:
        assert f.metadata() == {'format': 'pt'}
        np.testing.assert_array_equal(f.get_tensor('t0'),
                                      tensors['t0'].numpy())


def test_codec_casts_on_write(tmp_path):
    """``write_safetensors(dtype=...)`` casts each tensor as it writes it."""
    tensors = _codec_tensors(3)
    floats = {k: v.float() for k, v in tensors.items()
              if v.dtype.is_floating_point}
    path = str(tmp_path / 'cast.safetensors')
    th.write_safetensors(path, floats, dtype=torch.bfloat16)
    got = th.read_safetensors(path)
    for name, t in floats.items():
        assert torch.equal(got[name], t.to(torch.bfloat16)), name
