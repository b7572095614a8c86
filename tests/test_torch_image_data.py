"""The port's image data layer (``align_anything_tpu_torch/data/image.py``)
and image-text templates (``data/multimodal_formatters.py``) against the
JAX package's: the same images and rows through both, compared exactly
(host-side numpy, no device math).

Also the image-token collision of the hash tokenizer, in both packages
(ROADMAP §3 R12): with LLaVA's vocab of 32064 a text word can hash to
32000, the image token, and a row then holds one image token more than the
image has patches.
"""

import io
import json
import sys

import numpy as np
import pytest

PIL = pytest.importorskip('PIL.Image')

from align_anything_tpu.data import image as jimage  # noqa: E402
from align_anything_tpu.data.chat_template import (  # noqa: E402
    ChatTemplate as JChatTemplate,
)
from align_anything_tpu.data.template_registry import (  # noqa: E402
    TEMPLATE_REGISTRY as JREGISTRY,
)
from align_anything_tpu.data.tokenizer import (  # noqa: E402
    HashTokenizer as JHashTokenizer,
)
from align_anything_tpu_torch.data import image as timage  # noqa: E402
from align_anything_tpu_torch.data.chat_template import ChatTemplate  # noqa: E402
from align_anything_tpu_torch.data.template_registry import (  # noqa: E402
    TEMPLATE_REGISTRY,
)
from align_anything_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402

IMG = 120
TEMPLATES = ('AA_TI2T', 'LLaVA_Instruct', 'RLAIFV', 'SPA_VL', 'SafeRLHF_V')


def _img(h, w, seed=0, gray=False):
    rng = np.random.default_rng(seed)
    shape = (h, w) if gray else (h, w, 3)
    return rng.integers(0, 256, size=shape).astype(np.uint8)


def _batches_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('h,w,gray,kind', [
    (28, 28, False, 'array'), (40, 28, False, 'array'),
    (28, 51, True, 'array'), (33, 47, False, 'float'),
    (30, 30, False, 'pil'), (36, 24, False, 'path'), (29, 31, False, 'bytes'),
])
def test_image_processor_matches_jax(tmp_path, h, w, gray, kind):
    """CLIP resize (bicubic, short side), center crop and normalize:
    exactly JAX's for arrays (uint8, gray, float), PIL images, PNG paths
    and PNG bytes."""
    arr = _img(h, w, gray=gray)
    image = arr
    if kind == 'float':
        image = arr.astype(np.float32) * 1.5 - 20       # clipped to uint8
    elif kind in ('pil', 'path', 'bytes'):
        pil = PIL.fromarray(arr)
        if kind == 'pil':
            image = pil
        else:
            buf = io.BytesIO()
            pil.save(buf, format='PNG')
            image = buf.getvalue()
            if kind == 'path':
                path = tmp_path / 'x.png'
                path.write_bytes(image)
                image = str(path)
    cfg = dict(size=28)
    want = jimage.ImageProcessor(jimage.ImageProcessorConfig(**cfg))(image)
    got = timage.ImageProcessor(timage.ImageProcessorConfig(**cfg))(image)
    assert got.shape == (3, 28, 28) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_image_processor_without_pillow(monkeypatch):
    """Where Pillow does not import, both resample the whole image by
    nearest neighbour (no crop), the same pixels, which differ from the
    Pillow branch's."""
    arr = _img(40, 28, seed=3)
    proc = timage.ImageProcessor(timage.ImageProcessorConfig(size=28))
    with_pillow = proc(arr)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, 'PIL', None)
        want = jimage.ImageProcessor(
            jimage.ImageProcessorConfig(size=28))(arr)
        got = proc(arr)
    np.testing.assert_array_equal(got, want)
    ys = np.linspace(0, 39, 28).astype(int)
    np.testing.assert_array_equal(
        got, timage.ImageProcessor(timage.ImageProcessorConfig(size=28))(
            arr[ys]))
    assert not np.array_equal(got, with_pillow)


def test_clip_constants():
    assert timage.CLIP_MEAN == jimage.CLIP_MEAN
    assert timage.CLIP_STD == jimage.CLIP_STD
    assert timage.IMAGE_PLACEHOLDER == jimage.IMAGE_PLACEHOLDER


@pytest.mark.parametrize('text', [
    '<image>\nwhat is this', 'USER: <image>\nwhat is this\nASSISTANT: a cat',
    'two <image> images <image> here', 'no image at all', '<image>'])
def test_expand_image_tokens_matches_jax(text):
    tok, jtok = HashTokenizer(vocab_size=512), JHashTokenizer(vocab_size=512)
    assert timage.expand_image_tokens(text, tok, IMG, 4) == \
        jimage.expand_image_tokens(text, jtok, IMG, 4)


@pytest.mark.parametrize('name', TEMPLATES)
def test_templates_registered_and_equal(name):
    """The five image-text templates are registered by importing the data
    package, and format a row as JAX does."""
    import align_anything_tpu_torch.data  # noqa: F401  (registers)

    assert name in TEMPLATE_REGISTRY
    row = {'question': 'what is it', 'response': 'a dog', 'image': 'x.png',
           'overall_response': 2, 'response_1': 'a cat',
           'response_2': 'a dog', 'chosen': 'yes', 'rejected': 'no',
           'prompt': 'is it safe', 'better_response_id': 0,
           'response_0': 'safe',
           'conversations': [{'from': 'human', 'value': '<image>\nhi'},
                             {'from': 'gpt', 'value': 'hello'}]}
    ours, theirs = TEMPLATE_REGISTRY[name](), JREGISTRY[name]()
    for method in ('format_supervised_sample', 'format_preference_sample',
                   'format_prompt_only_sample'):
        try:
            want = getattr(theirs, method)(row)
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                getattr(ours, method)(row)
            continue
        assert getattr(ours, method)(row) == want


@pytest.fixture(scope='module')
def rows(tmp_path_factory):
    """AA_TI2T rows with PNG images of several sizes; one row of each file
    has no image."""
    d = tmp_path_factory.mktemp('ti2t_rows')
    rng = np.random.default_rng(7)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps']

    def pick(k):
        return ' '.join(words[j] for j in rng.integers(0, 5, size=k))

    pref, sft = [], []
    for i in range(6):
        path = d / f'i{i}.png'
        PIL.fromarray(_img(int(rng.integers(20, 50)), 28, seed=i)).save(path)
        image = str(path)
        pref.append({'question': pick(3), 'response_1': pick(4),
                     'response_2': pick(int(rng.integers(1, 6))),
                     'overall_response': int(rng.integers(1, 3)),
                     'image': image})
        sft.append({'question': pick(2), 'response': pick(5),
                    'image': None if i == 5 else image})
    for name, data in (('pref', pref), ('sft', sft)):
        (d / f'{name}.jsonl').write_text(
            ''.join(json.dumps(r) + '\n' for r in data))
    return d


def _datasets(rows, kind, n_patches=4, size=28):
    tok, jtok = HashTokenizer(vocab_size=512), JHashTokenizer(vocab_size=512)
    cls = {'sft': (timage.TI2TSupervisedDataset,
                   jimage.TI2TSupervisedDataset),
           'pref': (timage.TI2TPreferenceDataset,
                    jimage.TI2TPreferenceDataset)}[kind]
    path = str(rows / f'{kind}.jsonl')
    ours = cls[0](path, ChatTemplate(tok, 'AA_TI2T'), tok,
                  image_token_id=IMG, num_patches=n_patches,
                  image_processor=timage.ImageProcessor(
                      timage.ImageProcessorConfig(size=size)),
                  max_length=64)
    theirs = cls[1](path, JChatTemplate(jtok, 'AA_TI2T'), jtok,
                    image_token_id=IMG, num_patches=n_patches,
                    image_processor=jimage.ImageProcessor(
                        jimage.ImageProcessorConfig(size=size)),
                    max_length=64)
    return ours, theirs


@pytest.mark.parametrize('kind', ['sft', 'pref'])
def test_collated_batches_match_jax(rows, kind):
    """The TI2T supervised and preference collators' batches (ids, labels
    or masks, pixel_values duplicated [better; worse]) equal JAX's; image
    tokens never carry a label."""
    ours, theirs = _datasets(rows, kind)
    assert len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k
    samples = [ours[i] for i in range(len(ours))]
    jsamples = [theirs[i] for i in range(len(theirs))]
    for buckets in ((32, 64), (128,)):
        got = ours.get_collator(buckets=buckets)(samples)
        want = theirs.get_collator(buckets=buckets)(jsamples)
        _batches_equal(got, want)
    assert got['pixel_values'].shape[1:] == (3, 28, 28)
    if kind == 'sft':
        image = got['input_ids'] == IMG
        # AA_TI2T writes the placeholder in every row; the row whose image
        # is None gets zero pixels
        assert image.sum() == 6 * 4
        assert (got['labels'][image] == -100).all()
        assert (got['pixel_values'][5] == 0).all()
    else:
        n = len(samples)
        np.testing.assert_array_equal(got['pixel_values'][:n],
                                      got['pixel_values'][n:])


def _colliding_word(vocab: int, target: int) -> str:
    tok = HashTokenizer(vocab_size=vocab)
    for i in range(1_000_000):
        word = f'w{i}'
        if tok.encode(word, add_special_tokens=False) == [target]:
            return word
    raise AssertionError('no colliding word found')


def test_hash_tokenizer_image_token_collision():
    """R12: the hash tokenizer a LLaVA checkpoint without tokenizer files
    gets (vocab 32064, as ``load_tokenizer_for`` builds it in both
    packages) maps some words to 32000, LLaVA's image token.  A row with
    such a word holds 577 image tokens for 576 patches, in both packages
    alike; ``merge_image_embeds`` then places a patch embedding on the
    word."""
    word = _colliding_word(32064, 32000)
    assert JHashTokenizer(vocab_size=32064).encode(
        word, add_special_tokens=False) == [32000]
    text = f'<image>\nwhat is {word}'
    tok, jtok = HashTokenizer(vocab_size=32064), JHashTokenizer(
        vocab_size=32064)
    ids = timage.expand_image_tokens(text, tok, 32000, 576)
    assert ids == jimage.expand_image_tokens(text, jtok, 32000, 576)
    assert ids.count(32000) == 577
