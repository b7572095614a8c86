"""The port's image-prefilled ``generate`` (``align_anything_tpu_torch/
generation/engine.py``) and ``TI2TPromptOnlyDataset`` (``data/image.py``)
against the JAX package's.

- ``generate`` with ``pixel_values``, ``prefill_forward=multimodal.forward``
  and ``step_forward=multimodal.decode_forward``, greedy, on a tiny LLaVA
  config (two text layers, a three-layer tower; the weights bridged from
  the JAX init): the same sequences, and the prefill's last-position
  logits in fp32 to 1e-5 of their max (JAX's from its own cached
  ``multimodal.forward`` over the same cache layout), as
  ``tests/test_torch_multimodal.py`` holds the forward.  The image moves
  the logits.
- The text ``generate`` unchanged: its defaults equal passing
  ``transformer.forward`` for both hooks, bit for bit, and its greedy
  tokens equal JAX's.
- ``TI2TPromptOnlyDataset`` rows (ids, pixels) and the collated
  left-padded batch equal JAX's, exactly (host-side numpy).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('transformers')
PIL = pytest.importorskip('PIL.Image')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.data import image as jimage  # noqa: E402
from align_anything_tpu.data.chat_template import (  # noqa: E402
    ChatTemplate as JChatTemplate,
)
from align_anything_tpu.data.tokenizer import (  # noqa: E402
    HashTokenizer as JHashTokenizer,
)
from align_anything_tpu.generation import engine as jeng  # noqa: E402
from align_anything_tpu.models import multimodal as jmm  # noqa: E402
from align_anything_tpu.models import transformer as jtr  # noqa: E402
from align_anything_tpu_torch.data import (  # noqa: E402
    ChatTemplate,
    HashTokenizer,
    TI2TPromptOnlyDataset,
)
from align_anything_tpu_torch.data import image as timage  # noqa: E402
from align_anything_tpu_torch.generation import (  # noqa: E402
    GenerationConfig,
    generate,
)
from align_anything_tpu_torch.models import multimodal as tmm  # noqa: E402
from align_anything_tpu_torch.models import transformer as ttr  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from test_torch_multimodal import IMG, _configs, _params  # noqa: E402

TOL = 1e-5
NEW = 6


def _prompts(b=3, seed=5):
    """Left-padded prompts (B, 12): [bos, 4 image tokens, text], rows 2
    and 3 shorter by 2 and 4 tokens; pixels (B, 3, 28, 28)."""
    rng = np.random.default_rng(seed)
    p = 12
    ids = np.zeros((b, p), np.int32)
    mask = np.zeros((b, p), np.int32)
    for r in range(b):
        n = p - 2 * r
        row = rng.integers(3, IMG, size=n).astype(np.int32)
        row[0], row[1:5] = 1, IMG
        ids[r, p - n:], mask[r, p - n:] = row, 1
    px = rng.normal(size=(b, 3, 28, 28)).astype(np.float32)
    return ids, mask, px


def _jax_prefill_logits(params, jc, ids, mask, px):
    """JAX's ``multimodal.forward`` over the prompt into a cache, as its
    ``generate`` calls it: the last position's logits."""
    b, p = ids.shape
    cache = jtr.init_cache(jc.text, b, p + NEW, dtype=jnp.float32)
    full = jnp.zeros((b, p + NEW), jnp.int32).at[:, :p].set(mask)
    pos = jnp.clip(jnp.cumsum(jnp.asarray(mask), -1) - 1, 0)
    out = jmm.forward(params, jc, jnp.asarray(ids), attention_mask=full,
                      positions=pos, cache=cache, cache_offset=0,
                      pixel_values=jnp.asarray(px))
    return np.asarray(out.logits[:, -1])


def test_generate_with_image_matches_jax():
    jc, tc = _configs()
    params = _params(jc)
    tparams = from_jax_tree(params, device='cpu')
    ids, mask, px = _prompts()
    gen = dict(max_new_tokens=NEW, greedy=True, eos_token_id=-1)
    want = jeng.generate(params, jc, jeng.GenerationConfig(**gen),
                         jnp.asarray(ids), jnp.asarray(mask),
                         jax.random.PRNGKey(0),
                         pixel_values=jnp.asarray(px),
                         prefill_forward=jmm.forward,
                         step_forward=jmm.decode_forward)
    seen = []

    def prefill(*args, **kwargs):
        out = tmm.forward(*args, **kwargs)
        seen.append((kwargs, out.logits[:, -1].clone()))
        return out

    got = generate(tparams, tc, GenerationConfig(**gen),
                   torch.from_numpy(ids), torch.from_numpy(mask),
                   pixel_values=torch.from_numpy(px),
                   prefill_forward=prefill, step_forward=tmm.decode_forward)
    for key in ('sequences', 'attention_mask', 'completions',
                'completion_mask', 'prompt_lens'):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert len(seen) == 1
    kwargs, logits = seen[0]
    assert kwargs['pixel_values'].shape == px.shape
    assert kwargs['cache'].k.shape[1:] == (3, 2, ids.shape[1] + NEW, 8)
    jlogits = _jax_prefill_logits(params, jc, ids, mask, px)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                               atol=TOL * float(np.abs(jlogits).max()))
    blind = tmm.forward(tparams, tc, torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask)).logits[:, -1]
    assert not torch.allclose(blind, logits, rtol=1e-3, atol=0)


def test_text_generate_unchanged():
    """The text path: the defaults are ``transformer.forward`` for the
    prefill and the steps, and the greedy tokens are JAX's."""
    jc, tc = _configs()
    lm = _params(jc)['language_model']
    tlm = from_jax_tree(lm, device='cpu')
    ids, mask, _ = _prompts()
    ids = np.where(ids == IMG, 7, ids).astype(np.int32)
    gen = dict(max_new_tokens=NEW, greedy=True, eos_token_id=-1)
    args = (tlm, tc.text, GenerationConfig(**gen), torch.from_numpy(ids),
            torch.from_numpy(mask))
    default = generate(*args)
    explicit = generate(*args, prefill_forward=ttr.forward,
                        step_forward=ttr.forward)
    for key, value in default.items():
        assert torch.equal(value, explicit[key]), key
    want = jeng.generate(lm, jc.text, jeng.GenerationConfig(**gen),
                         jnp.asarray(ids), jnp.asarray(mask),
                         jax.random.PRNGKey(0))
    np.testing.assert_array_equal(default['sequences'].numpy(),
                                  np.asarray(want['sequences']))


@pytest.fixture(scope='module')
def prompt_rows(tmp_path_factory):
    """AA_TI2T rows over PNG images of several sizes; row 3 repeats row
    1's question over another image (deduplicated away)."""
    d = tmp_path_factory.mktemp('ti2t_prompts')
    rng = np.random.default_rng(11)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps']
    rows = []
    for i in range(6):
        path = d / f'p{i}.png'
        PIL.fromarray(rng.integers(0, 256, size=(
            int(rng.integers(20, 50)), 28, 3)).astype(np.uint8)).save(path)
        question = ' '.join(words[j] for j in rng.integers(
            0, 5, size=int(rng.integers(1, 7))))
        rows.append({'question': rows[1]['question'] if i == 3 else question,
                     'response_1': 'a', 'response_2': 'b',
                     'overall_response': 1, 'image': str(path)})
    (d / 'prompts.jsonl').write_text(
        ''.join(json.dumps(r) + '\n' for r in rows))
    return d / 'prompts.jsonl'


def test_prompt_only_rows_match_jax(prompt_rows):
    """Each row's ids (the image expanded to 4 tokens, no trailing EOS) and
    ``meta['pixel_values']`` equal JAX's; the left-padded batch of the
    text ``PromptOnlyCollator`` equals JAX's collator's."""
    tok, jtok = HashTokenizer(vocab_size=512), JHashTokenizer(vocab_size=512)
    kw = dict(image_token_id=IMG, num_patches=4, max_length=64)
    ours = TI2TPromptOnlyDataset(
        str(prompt_rows), ChatTemplate(tok, 'AA_TI2T'), tok,
        image_processor=timage.ImageProcessor(
            timage.ImageProcessorConfig(size=28)), **kw)
    theirs = jimage.TI2TPromptOnlyDataset(
        str(prompt_rows), JChatTemplate(jtok, 'AA_TI2T'), jtok,
        image_processor=jimage.ImageProcessor(
            jimage.ImageProcessorConfig(size=28)), **kw)
    assert len(ours) == len(theirs) == 5
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a['input_ids'] == b['input_ids']
        assert a['input_ids'].count(IMG) == 4
        assert a['input_ids'][-1] != tok.eos_token_id
        assert set(a['meta']) == set(b['meta']) == {'pixel_values'}
        np.testing.assert_array_equal(a['meta']['pixel_values'],
                                      b['meta']['pixel_values'])
        assert a['meta']['pixel_values'].shape == (3, 28, 28)
    samples = [ours[i] for i in range(len(ours))]
    got = ours.get_collator(buckets=(32, 64))(samples)
    want = theirs.get_collator(buckets=(32, 64))(
        [theirs[i] for i in range(len(theirs))])
    for key in ('input_ids', 'attention_mask'):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got['attention_mask'][:, -1] == 1).all()     # left-padded
    for m, jm in zip(got['meta'], want['meta']):
        np.testing.assert_array_equal(m['pixel_values'], jm['pixel_values'])
