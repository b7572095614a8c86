"""The port's Idefics2 against the JAX package's, on the CPU:
``data/image.py`` ``Idefics2NaViTProcessor``, ``models/idefics2.py`` (the
NaViT position ids, the fixed and packed SigLIP tower and its chunked
attention (``ops/attention.py`` ``chunked_masked_attention``), the
perceiver connector with and without a patch mask, the text-only and
image forwards, log-probs with ``tgt_sizes``, gradients, the loader),
greedy ``generate`` with ``media={'tgt_sizes': ...}``, the TI2T trainers
(SFT and DPO against JAX; KTO, ORPO and SimPO in the port alone) and
ROADMAP §3 R35-R37 in both packages.

The checkpoint is a tiny ``Idefics2ForConditionalGeneration`` saved by
transformers (a tower 32 wide of 2 layers over 56 px images of 14 px
patches, 16 slots; a perceiver of 4 latents, depth 2, 4 heads of 8 over 2
KV heads; a Mistral trunk of 2 layers 32 wide; vocab 128, the image token
120), every weight moved by 0.05 x N(0, 1) from a seed so that no bias,
norm or latent sits at its init.  The JAX tree comes from JAX's loader and
goes to the port through ``models/bridge.py``; the trainers read the
checkpoint through both packages' loaders.

Tolerances: the processor, the position ids, the loaded trees and the
generated ids exactly; the towers, the connector, logits and log-probs
within 1e-4 of their max (fp32); every gradient leaf within 1e-4 of its
max; the trainers' metrics and params to 1e-5, as the other trainer
parity tests.  JAX's DPO family fails on Idefics2 (R35), so the port's DPO
step is held to JAX's DPO loss over JAX's log-probs of the same params.
"""

import contextlib
import functools
import io
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
PIL = pytest.importorskip('PIL.Image')
pytest.importorskip('yaml')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.data import image as jimage  # noqa: E402
from align_anything_tpu.generation import engine as jeng  # noqa: E402
from align_anything_tpu.models import idefics2 as jm  # noqa: E402
from align_anything_tpu.ops.logprobs import (  # noqa: E402
    hidden_to_token_logprobs as jlogprobs,
)
from align_anything_tpu_torch import checkpoint as tckpt  # noqa: E402
from align_anything_tpu_torch.data import image as timage  # noqa: E402
from align_anything_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from align_anything_tpu_torch.generation import (  # noqa: E402
    GenerationConfig,
    generate,
)
from align_anything_tpu_torch.models import idefics2 as tm  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.ops import attention as tattn  # noqa: E402
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    dpo as tdpo,
    kto as tkto,
    orpo as torpo,
    sft as tsft,
    simpo as tsimpo,
)
from align_anything_tpu_torch.utils.tools import param_leaves  # noqa: E402
from test_torch_mllama import leaves  # noqa: E402
from test_torch_rl_trainers import one_compile  # noqa: E402
from test_torch_ti2t_trainers import _compare, _steps  # noqa: E402

IMG = 120
REL = 1e-4
TOL = 1e-5
JAX_DEVICES = 8
ROWS = 8
# (h, w) of the trainers' images: landscape, portrait, square
SIZES = ((56, 84), (84, 42), (56, 56))


def hf_idefics2_config():
    return transformers.Idefics2Config(
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=56, patch_size=14,
                           hidden_act='gelu_pytorch_tanh'),
        perceiver_config=dict(resampler_n_latents=4, resampler_depth=2,
                              resampler_n_heads=4, resampler_head_dim=8,
                              num_key_value_heads=2, hidden_act='silu'),
        text_config=dict(vocab_size=128, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=256, rms_norm_eps=1e-6,
                         tie_word_embeddings=False),
        image_token_id=IMG, tie_word_embeddings=False)


def _words(n: int) -> list[str]:
    """``n`` words that the 128-token hash tokenizer maps off the image
    token (ROADMAP R12)."""
    tok = HashTokenizer(vocab_size=128)
    out, i = [], 0
    while len(out) < n:
        w = f'w{i}'
        if IMG not in tok(w, add_special_tokens=False)['input_ids']:
            out.append(w)
        i += 1
    return out


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """The perturbed checkpoint (``model``), ``ROWS`` preference rows
    (``pref.jsonl``) and supervised rows (``sft.jsonl``), each with its
    own PNG of one of ``SIZES``."""
    d = tmp_path_factory.mktemp('idefics2_assets')
    torch.manual_seed(0)
    hf = transformers.Idefics2ForConditionalGeneration(hf_idefics2_config())
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    hf.eval().save_pretrained(d / 'model', safe_serialization=True)
    rng = np.random.default_rng(0)
    words = _words(12)

    def pick(k):
        return ' '.join(words[j] for j in rng.integers(0, len(words), k))

    pref, sft = [], []
    for i in range(ROWS):
        img = d / f'img{i}.png'
        h, w = SIZES[i % len(SIZES)]
        PIL.fromarray(rng.integers(0, 256, size=(h, w, 3)).astype(
            np.uint8)).save(img)
        pref.append({'question': pick(int(rng.integers(1, 4))),
                     'response_1': pick(int(rng.integers(1, 8))),
                     'response_2': pick(int(rng.integers(1, 8))),
                     'overall_response': int(rng.integers(1, 3)),
                     'image': str(img)})
        sft.append({'question': pick(2),
                    'response': pick(int(rng.integers(1, 8))),
                    'image': str(img)})
    for name, data in (('pref', pref), ('sft', sft)):
        with open(d / f'{name}.jsonl', 'w') as f:
            f.writelines(json.dumps(r) + '\n' for r in data)
    return d


@pytest.fixture(scope='module')
def ide(assets):
    """Both packages' params and fp32 configs of the checkpoint."""
    params, jcfg = jm.load_idefics2_params(str(assets / 'model'))
    tparams, tcfg = tm.load_idefics2_params(str(assets / 'model'),
                                            device='cpu')
    return dict(params=params, jcfg=jcfg.replace(compute_dtype='float32',
                                                 attention_impl='xla'),
                tparams=tparams, tcfg=tcfg.replace(compute_dtype='float32'))


def _close(got, want, rel=REL):
    got = np.asarray(got.detach() if hasattr(got, 'detach') else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale, (
        float(np.abs(got - want).max()), scale)


def _packed(seed=0, grids=((4, 2), (3, 4), (4, 4))):
    """NaViT-packed patch rows (B, 16, 3*14*14) of the given (h, w) grids,
    zero past each grid, and their ``tgt_sizes``."""
    rng = np.random.default_rng(seed)
    px = np.zeros((len(grids), 16, 3 * 14 * 14), np.float32)
    for i, (h, w) in enumerate(grids):
        px[i, :h * w] = rng.normal(size=(h * w, 3 * 14 * 14))
    return px, np.asarray(grids, np.int32)


def _ids(n_rows=3):
    """Rows of text around the 4 image tokens, right-padded with 0."""
    rows = [[1, 5] + [IMG] * 4 + [6, 7, 8, 9], [1] + [IMG] * 4 + [10, 11],
            [1, 12] + [IMG] * 4 + [13, 14, 15]][:n_rows]
    ids = np.zeros((len(rows), 10), np.int64)
    mask = np.zeros((len(rows), 10), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return ids, mask


# ---------------------------------------------------------------------------
# the processor and the position ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shortest', [378, 28])
def test_navit_processor_matches_jax(ide, shortest):
    """``pixel_values`` (16 slots x 588), ``tgt_sizes`` and ``num_tokens``
    equal JAX's bit for bit for landscape, portrait, square and oversized
    images; with a short edge of 28 the grids differ in shape."""
    vcfg = ide['tcfg'].vision
    kw = dict(n_latents=4, shortest_edge=shortest)
    got_proc = timage.Idefics2NaViTProcessor(vcfg, **kw)
    want_proc = jimage.Idefics2NaViTProcessor(ide['jcfg'].vision, **kw)
    rng = np.random.default_rng(3)
    grids = set()
    for h, w in ((56, 84), (84, 42), (56, 56), (200, 90), (30, 17)):
        img = PIL.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        got, want = got_proc(img), want_proc(img)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
        assert got['pixel_values'].shape == (16, 588)
        assert got['num_tokens'] == 4
        grids.add(tuple(got['tgt_sizes'].tolist()))
    assert len(grids) == (1 if shortest == 378 else 4)
    assert timage.ensure_divide(35, 14) == jimage.ensure_divide(35, 14) == 28


def test_navit_position_ids_match_jax():
    """The bucketized ids of grids up to the full square, exactly."""
    grids = np.asarray([[1, 1], [2, 3], [7, 5], [10, 10], [3, 10]], np.int32)
    for n, side in ((100, 10), (64, 70)):
        got = tm.navit_position_ids(torch.from_numpy(grids), n, side)
        want = jm.navit_position_ids(jnp.asarray(grids), n, side)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_vision_towers_match_jax(ide):
    """The fixed-square tower and the packed tower (three grids, padded
    slots) within 1e-4; on a full grid the packed tower is the fixed one;
    the chunked attention equals one chunk."""
    tv, jv = ide['tparams']['vision_model'], ide['params']['vision_model']
    vcfg = ide['tcfg'].vision
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 3, 56, 56)).astype(np.float32)
    fixed = tm.vision_forward(tv, vcfg, torch.from_numpy(img))
    # JAX's towers compiled (the eager op-by-op trace is slow)
    _close(fixed, jax.jit(jm.vision_forward, static_argnums=1)(
        jv, ide['jcfg'].vision, jnp.asarray(img)))
    px, grids = _packed()
    got = tm.vision_forward_packed(tv, vcfg, torch.from_numpy(px),
                                   torch.from_numpy(grids))
    want = jax.jit(jm.vision_forward_packed, static_argnums=1)(
        jv, ide['jcfg'].vision, jnp.asarray(px), jnp.asarray(grids))
    _close(got, want)
    # a full 4 x 4 grid packed row-major is the conv's patch order
    full = img.reshape(2, 3, 4, 14, 4, 14).transpose(0, 2, 4, 1, 3, 5)
    packed = tm.vision_forward_packed(
        tv, vcfg, torch.from_numpy(full.reshape(2, 16, 588).copy()),
        torch.tensor([[4, 4], [4, 4]]))
    _close(packed, fixed.detach().numpy(), rel=1e-5)
    # the tower's attention, the shared op under a key mask in chunks of 8
    # queries (five a row), is the plain non-causal ``xla_attention``,
    # forward and backward
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 40, 4, 8)).astype(
        np.float32)).requires_grad_(True) for _ in range(3))
    valid = torch.arange(40)[None] < torch.tensor([[40], [23]])
    dout = torch.from_numpy(rng.normal(size=(2, 40, 4, 8)).astype(np.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tattn, 'CHUNKED_ATTN_ELEMS', 1)
        assert tattn._chunk_rows(2, 40, 4) == 8
        out = tattn.chunked_masked_attention(
            q, k, v, torch.ones(2, 40), 1.0 - valid.float())
        chunked = (out,) + torch.autograd.grad(out, (q, k, v), dout)
    plain = tattn.xla_attention(q, k, v, valid, causal=False)
    plain = (plain,) + torch.autograd.grad(plain, (q, k, v), dout)
    for got, want in zip(chunked, plain):
        _close(got, want.detach().numpy(), rel=1e-6)


@pytest.mark.parametrize('masked', [False, True])
def test_connector_matches_jax(ide, masked):
    """The modality projection and perceiver, with and without a patch
    mask (the latents always attend to each other)."""
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(3, 16, 32)).astype(np.float32)
    mask = (np.arange(16)[None] < np.asarray([[8], [12], [16]])
            if masked else None)
    got = tm.connector_forward(
        ide['tparams']['connector'], ide['tcfg'].perceiver,
        torch.from_numpy(feats), 1e-6,
        patch_mask=None if mask is None else torch.from_numpy(mask))
    want = jm.connector_forward(
        ide['params']['connector'], ide['jcfg'].perceiver, jnp.asarray(feats),
        1e-6, patch_mask=None if mask is None else jnp.asarray(mask))
    assert got.shape == (3, 4, 32)
    _close(got, want)


@pytest.mark.parametrize('media', ['text', 'fixed', 'packed'])
def test_forward_logits_match_jax(ide, media):
    """Logits text-only, with fixed-square images and with packed patches
    (``tgt_sizes``)."""
    ids, mask = _ids()
    kw, jkw = {}, {}
    if media == 'fixed':
        img = np.random.default_rng(8).normal(
            size=(3, 3, 56, 56)).astype(np.float32)
        kw['pixel_values'], jkw['pixel_values'] = (torch.from_numpy(img),
                                                   jnp.asarray(img))
    elif media == 'packed':
        px, grids = _packed(9)
        kw = {'pixel_values': torch.from_numpy(px),
              'tgt_sizes': torch.from_numpy(grids)}
        jkw = {'pixel_values': jnp.asarray(px),
               'tgt_sizes': jnp.asarray(grids)}
    got = tm.forward(ide['tparams'], ide['tcfg'], torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask), **kw)
    want = jax.jit(jm.forward, static_argnums=1)(
        ide['params'], ide['jcfg'], jnp.asarray(ids, jnp.int32),
        attention_mask=jnp.asarray(mask, jnp.int32), **jkw)
    _close(got.logits, want.logits)


@functools.partial(jax.jit, static_argnums=1)
def _jax_logprobs(params, jcfg, ids, mask, px, grids):
    """What JAX's DPO would compute if its ``token_logprobs`` took
    ``tgt_sizes`` (R35): JAX's forward with them, then its chunked
    log-probs (compiled: one trace instead of hundreds of eager ops)."""
    out = jm.forward(params, jcfg, ids, attention_mask=mask, pixel_values=px,
                     need_logits=False, tgt_sizes=grids)
    head = params['language_model']['lm_head']
    return jlogprobs(out.last_hidden_state[:, :-1], head, ids[:, 1:],
                     chunk_size=256, true_vocab=jcfg.text.true_vocab_size)


def test_logprobs_and_grads_match_jax(ide, monkeypatch):
    """``token_logprobs`` with ``tgt_sizes`` against JAX's forward with
    them plus ``hidden_to_token_logprobs``, and the gradient of their
    masked sum at every leaf of the tree (tower, connector, trunk), with
    the tower's attention in two chunks of 8 queries a row, so that its
    backward adds dK / dV over chunks as at full size."""
    monkeypatch.setattr(tattn, 'CHUNKED_ATTN_ELEMS', 1)
    assert tattn._chunk_rows(3, 16, 4) == 8
    ids, mask = _ids()
    px, grids = _packed(10)
    want = _jax_logprobs(ide['params'], ide['jcfg'],
                         jnp.asarray(ids, jnp.int32),
                         jnp.asarray(mask, jnp.int32), jnp.asarray(px),
                         jnp.asarray(grids))
    tparams = from_jax_tree(ide['params'], device='cpu')
    for t in param_leaves(tparams):
        t.requires_grad_(True)
    got = tm.token_logprobs(tparams, ide['tcfg'], torch.from_numpy(ids),
                            attention_mask=torch.from_numpy(mask),
                            pixel_values=torch.from_numpy(px),
                            tgt_sizes=torch.from_numpy(grids))
    _close(got, want)
    w = torch.from_numpy(mask[:, 1:]).float()
    (got * w).sum().backward()

    def loss(p):
        lp = _jax_logprobs(p, ide['jcfg'], jnp.asarray(ids, jnp.int32),
                           jnp.asarray(mask, jnp.int32), jnp.asarray(px),
                           jnp.asarray(grids))
        return (lp * jnp.asarray(mask[:, 1:], jnp.float32)).sum()

    jgrads = leaves(jax.jit(jax.grad(loss))(ide['params']))
    tgrads = {p: t for p, t in leaves(
        {k: v for k, v in _grad_tree(tparams).items()}).items()}
    assert set(tgrads) == set(jgrads)
    for p, g in jgrads.items():
        _close(tgrads[p], g)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


def test_loader_matches_jax(assets, ide):
    """The port's loader reads the transformers checkpoint into JAX's tree
    bit for bit (the trunk in the decoder's layout, the rest by module
    path) with JAX's configs."""
    got, want = leaves(ide['tparams']), leaves(ide['params'])
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    _, jcfg = jm.load_idefics2_params(str(assets / 'model'))
    _, tcfg = tm.load_idefics2_params(str(assets / 'model'), device='cpu')
    for name in ('vision', 'perceiver'):
        assert (getattr(tcfg, name).__dict__
                == getattr(jcfg, name).__dict__), name
    assert tcfg.image_token_id == jcfg.image_token_id == IMG
    for f in ('vocab_size', 'hidden_size', 'num_layers', 'num_heads',
              'num_kv_heads', 'head_dim', 'mlp_dim', 'rope_theta',
              'norm_eps', 'pad_token_id', 'eos_token_id', 'bos_token_id',
              'tie_word_embeddings', 'sliding_window'):
        assert getattr(tcfg.text, f) == getattr(jcfg.text, f), f


def test_generate_matches_jax(ide):
    """Greedy ``generate`` with the packed image in the prefill
    (``media={'tgt_sizes': ...}``) and ``forward`` as both the prefill and
    the decode step: JAX's ids."""
    ids = np.asarray([[0, 0, 1, 5] + [IMG] * 4 + [6, 7],
                      [1, 9] + [IMG] * 4 + [10, 11, 12, 13]])
    mask = (np.arange(10)[None] >= np.asarray([[2], [0]])).astype(np.int64)
    px, grids = _packed(11, grids=((4, 3), (2, 4)))
    gen = dict(max_new_tokens=5, greedy=True, eos_token_id=-1)
    got = generate(ide['tparams'], ide['tcfg'], GenerationConfig(**gen),
                   torch.from_numpy(ids), torch.from_numpy(mask),
                   pixel_values=torch.from_numpy(px),
                   media={'tgt_sizes': torch.from_numpy(grids)},
                   prefill_forward=tm.forward, step_forward=tm.forward)
    want = jeng.generate(
        ide['params'], ide['jcfg'], jeng.GenerationConfig(**gen),
        jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
        jax.random.PRNGKey(0), pixel_values=jnp.asarray(px),
        media={'tgt_sizes': jnp.asarray(grids)},
        prefill_forward=jm.forward, step_forward=jm.forward)
    np.testing.assert_array_equal(got['sequences'].numpy(),
                                  np.asarray(want['sequences']))


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

PORT = {'sft': tsft.TI2TSupervisedTrainer, 'dpo': tdpo.TI2TDPOTrainer,
        'kto': tkto.TI2TKTOTrainer, 'orpo': torpo.TI2TORPOTrainer,
        'simpo': tsimpo.TI2TSimPOTrainer}
TASK = {'sft': 'text_image_to_text/sft', 'dpo': 'text_image_to_text/dpo',
        'kto': 'text_to_text/kto', 'orpo': 'text_to_text/orpo',
        'simpo': 'text_to_text/simpo'}


def _argv(assets, algo, per_device, out=None):
    data = 'sft' if algo == 'sft' else 'pref'
    kl = (('--per_device_kl_batch_size', str(per_device)) if algo == 'kto'
          else ())
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / f'{data}.jsonl'),
            '--train_template', 'AA_TI2T',
            *(('--output_dir', str(out)) if out else ()),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[64]', '--save_checkpoint', 'False',
            '--per_device_train_batch_size', str(per_device), *kl]


# DPO runs two steps of 4 pairs (step 2 is held to JAX's loss), the others
# one step of all 8 rows, as JAX's 8 devices take them
STEPS = {'dpo': 2}
PER_DEVICE = {'dpo': 4}


@pytest.fixture(scope='module')
def runs(assets):
    """algo -> the port's trainer on all ``ROWS`` rows (each built once in
    this file): its start-up output, its params before the steps and
    after each (numpy trees) and the metrics of its ``STEPS``."""
    cache = {}

    def run(algo):
        if algo not in cache:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                cfgs, pc = tcli.parse_cfgs(TASK[algo], _argv(
                    assets, algo, PER_DEVICE.get(algo, JAX_DEVICES)))
                trainer = PORT[algo](cfgs=cfgs, parallel_cfgs=pc,
                                     device='cpu')
            start = _np_tree(trainer.state.params)
            got, after = [], []
            for b in list(trainer.train_iterator.epoch_batches(0))[
                    :STEPS.get(algo, 1)]:
                got.append({k: float(v)
                            for k, v in trainer.train_step(b).items()})
                after.append(_np_tree(trainer.state.params))
            cache[algo] = dict(trainer=trainer, printed=printed.getvalue(),
                               start=start, got=got, after=after)
        return cache[algo]

    return run


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def test_sft_step_matches_jax(assets, ide, runs):
    """One SFT step of 8 rows: the same batch (packed patches, ``tgt_sizes``,
    4 image tokens a row), every metric JAX reports and every param after
    the step; the tower trains in both (R37).  JAX's trainer is built with
    R1's ``pp_stages`` and R39's specs patched."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_image_to_text import sft as jsft

    with pytest.MonkeyPatch.context() as mp:
        # R1: the JAX SFT engine reads model_cfg.pp_stages
        mp.setattr(jm.Idefics2Config, 'pp_stages', 1, raising=False)
        # R39: JAX's init asks for the specs without the tree
        mp.setattr(jm, 'param_specs', functools.partial(
            jm.param_specs, params=ide['params']))
        cfgs, pc = jcli.parse_cfgs(TASK['sft'], _argv(assets, 'sft', 1))
        jtrainer = one_compile(jsft.TI2TSupervisedTrainer(
            cfgs=cfgs, parallel_cfgs=pc))
        jbatch = next(iter(jtrainer.train_iterator.epoch_batches(0)))
        jstart = leaves(jtrainer.state.params['vision_model'])
        want = _steps(jtrainer, 1)
    r = runs('sft')
    trainer = r['trainer']
    assert trainer.mm is tm
    batch = next(iter(trainer.train_iterator.epoch_batches(0)))
    assert set(batch) == set(jbatch)
    for key in jbatch:
        np.testing.assert_array_equal(batch[key], jbatch[key], err_msg=key)
    assert batch['pixel_values'].shape == (ROWS, 16, 588)
    assert {tuple(g) for g in batch['tgt_sizes'].tolist()} == {(4, 4)}
    assert ((batch['input_ids'] == IMG).sum(-1) == 4).all()
    _compare(r['got'], want)
    want_p, got_p = leaves(jtrainer.state.params), leaves(
        trainer.state.params)
    assert set(got_p) == set(want_p)
    for path, leaf in got_p.items():
        np.testing.assert_allclose(leaf, want_p[path], rtol=TOL, atol=TOL,
                                   err_msg=path)
    moved = leaves(jtrainer.state.params['vision_model'])
    assert all(not np.array_equal(moved[p], jstart[p]) for p in jstart)


def test_dpo_steps_match_jax_loss(ide, runs):
    """Two DPO steps of 4 pairs: step 1 at ln 2 (the policy is the
    reference); step 2's loss and rewards equal JAX's DPO loss over JAX's
    log-probs (R35's repair: with ``tgt_sizes``) of the port's params after
    step 1 against the loaded reference, within 1e-5."""
    from align_anything_tpu.losses.preference import dpo_loss

    r = runs('dpo')
    trainer, got = r['trainer'], r['got']
    assert trainer.mm is tm
    assert abs(got[0]['train/loss'] - math.log(2)) <= 1e-6
    assert got[1]['train/loss'] != got[0]['train/loss']
    b = list(trainer.train_iterator.epoch_batches(0))[1]
    assert 'tgt_sizes' in b
    args = [jnp.asarray(b[k]) for k in ('input_ids', 'attention_mask',
                                        'pixel_values', 'tgt_sizes')]
    policy = jax.tree.map(jnp.asarray, r['after'][0])
    ref = jax.tree.map(jnp.asarray, ide['params'])
    lp = _jax_logprobs(policy, ide['jcfg'], *args)
    ref_lp = _jax_logprobs(ref, ide['jcfg'], *args)
    want = dpo_loss(lp, ref_lp, args[0], jnp.asarray(b['response_mask']),
                    scale_coeff=trainer.cfgs.train_cfgs.scale_coeff)
    assert abs(got[1]['train/loss'] - float(want['loss'])) <= TOL
    for key in ('reward', 'better_sample_reward', 'worse_sample_reward',
                'reward_margin'):
        assert abs(got[1][f'train/{key}']
                   - float(jnp.mean(want[key]))) <= TOL, key


@pytest.mark.parametrize('algo', ['kto', 'orpo', 'simpo'])
def test_dpo_family_step(runs, algo):
    """One step of TI2T KTO (its text-only KL rows, R14), ORPO and SimPO on
    the Idefics2 checkpoint, in the port alone (JAX's fail: R35): finite
    metrics, every module moved."""
    r = runs(algo)
    trainer, got = r['trainer'], r['got']
    assert trainer.mm is tm
    assert got and all(np.isfinite(v) for v in got[0].values())
    if algo == 'kto':
        assert trainer.kl >= 0.0
    after, start = leaves(trainer.state.params), leaves(r['start'])
    for module in ('/language_model', '/vision_model', '/connector'):
        assert any(not np.array_equal(after[p], start[p])
                   for p in after if p.startswith(module)), module


# ---------------------------------------------------------------------------
# the reference's faults
# ---------------------------------------------------------------------------

def test_r35_jax_dpo_logprobs_fail_the_port_repairs(ide):
    """R35: JAX's TI2T DPO passes the batch's ``tgt_sizes`` to
    ``idefics2.token_logprobs``, which takes none: ``TypeError``.  The
    port's takes them and equals JAX's forward with them (the log-probs
    test holds the values)."""
    from align_anything_tpu.trainers.text_image_to_text import dpo as jdpo

    ids, mask = _ids()
    px, grids = _packed(12)
    batch = {'input_ids': jnp.asarray(ids, jnp.int32),
             'attention_mask': jnp.asarray(mask, jnp.int32),
             'pixel_values': jnp.asarray(px), 'tgt_sizes': jnp.asarray(grids)}
    fake = type('T', (), {'mm': jm, 'model_cfg': ide['jcfg']})()
    with pytest.raises(TypeError, match='tgt_sizes'):
        jdpo.TI2TDPOTrainer.compute_token_logprobs(fake, ide['params'],
                                                   batch)
    tfake = type('T', (), {'mm': tm, 'model_cfg': ide['tcfg']})()
    got = tdpo.TI2TDPOTrainer.compute_token_logprobs(
        tfake, ide['tparams'], {k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()})
    assert got.shape == (3, 9) and torch.isfinite(got).all()


def test_r36_export_fails_in_jax_and_raises_in_the_port(assets, ide,
                                                        tmp_path):
    """R36: JAX's ``save_hf_slice`` sends an Idefics2 config to the LLaVA
    writer, which fails (``AttributeError``); the port's raises a
    ``NotImplementedError`` naming R36, and a trainer given an
    ``output_dir`` raises it at start-up, writing nothing."""
    from align_anything_tpu import checkpoint as jckpt

    with pytest.raises(AttributeError):
        jckpt.save_hf_slice(str(tmp_path / 'jax'), 1, ide['params'],
                            ide['jcfg'])
    with pytest.raises(NotImplementedError, match='R36'):
        tckpt.save_hf_slice(str(tmp_path / 'port'), 1, ide['tparams'],
                            ide['tcfg'])
    out = tmp_path / 'run'
    cfgs, pc = tcli.parse_cfgs(TASK['dpo'], _argv(assets, 'dpo', 8, out))
    with pytest.raises(NotImplementedError, match='R36'):
        PORT['dpo'](cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    assert not (tmp_path / 'port').exists()
    assert not any(p.name.startswith('slice_') for p in out.glob('*'))


def test_r37_freeze_flags_miss_the_tower(ide, runs):
    """R37: the TI2T YAMLs' ``freeze_vision_tower: True`` names
    ``vision_tower``, which an Idefics2 tree (``vision_model``,
    ``connector``) does not hold: JAX's labels freeze nothing, the port's
    start-up prints the line naming R37, and every tower leaf gets an
    optimizer state and moves (the SFT test shows JAX's tower moving)."""
    from align_anything_tpu.trainers.optimizer import freeze_labels

    labels = freeze_labels(ide['params'], ('vision_tower', 'projector'))
    assert set(jax.tree.leaves(labels)) == {'train'}
    r = runs('dpo')
    trainer = r['trainer']
    assert "freeze_vision_tower: True names ('vision_tower',)" in r['printed']
    assert 'R37' in r['printed']
    assert trainer.frozen_modules() == ('vision_tower',)
    held = {id(p) for g in trainer.state.optimizer.param_groups
            for p in g['params']}
    assert all(id(t) in held
               for t in param_leaves(trainer.state.params['vision_model']))
    after = leaves(trainer.state.params['vision_model'])
    start = leaves(r['start']['vision_model'])
    assert all(not np.array_equal(after[p], start[p]) for p in after)


def test_r39_jax_ti2t_trainers_fail_at_init(assets):
    """R39: JAX's TI2T SFT (and DPO, whose init its KTO, ORPO and SimPO
    share) asks ``idefics2.param_specs`` for the specs without the tree,
    so the tower and connector get none and ``shard_pytree`` raises
    ``ValueError`` before any step; the port's trainers build (the runs
    above)."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_image_to_text import dpo as jdpo
    from align_anything_tpu.trainers.text_image_to_text import sft as jsft

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm.Idefics2Config, 'pp_stages', 1, raising=False)
        for algo, cls in (('sft', jsft.TI2TSupervisedTrainer),
                          ('dpo', jdpo.TI2TDPOTrainer)):
            cfgs, pc = jcli.parse_cfgs(TASK[algo], _argv(assets, algo, 1))
            with pytest.raises(ValueError, match='tree prefix'):
                cls(cfgs=cfgs, parallel_cfgs=pc)
