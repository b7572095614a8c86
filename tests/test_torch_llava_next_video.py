"""The port's LLaVA-NeXT-Video path and text-video-to-text trainers against
the JAX package's, fp32 on the CPU: ``models/multimodal.py``
``project_video_features`` and both 5-D branches of ``forward`` (pooled
over the video token, and every frame's patches over the image token),
the ``llava_next_video`` loader and exporter, ``data/video.py``
(``sample_frames`` and the three TV2T datasets), the AA_TV2T template,
R26 in both packages, and the entry points of ``trainers/
text_video_to_text/``, whose steps are held to JAX's in ``tests/
test_torch_tv2t_trainers.py``.

The checkpoint is a tiny ``LlavaNextVideoForConditionalGeneration`` saved
by transformers (32 px frames, 8 px patches: a 4 x 4 grid, pooled by the
stride 2 to 2 x 2).  The port's attention runs the flash kernel's plain
version, JAX's ``attention_impl='xla'``.

Tolerances: frames, rows and batches exactly; features, logits and
log-probs to 1e-5 of their max; the loaded and re-exported trees exactly;
against transformers' logits 3e-5 (``tests/test_llava_next_video.py``);
R26's log-probs with and without the frames exactly.

R26 (ROADMAP §3): JAX's TV2T DPO, RM, PPO and GRPO expand <video> to
n_frames x the full patch grid of the IMAGE token; on a LLaVA-NeXT-Video
config ``forward`` merges the pooled frames over the VIDEO token, which
those rows do not hold, so the video is dropped.  The port copies it.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
pytest.importorskip('yaml')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.data import video as jvideo  # noqa: E402
from align_anything_tpu.data.chat_template import (  # noqa: E402
    ChatTemplate as JChatTemplate,
)
from align_anything_tpu.data.image import (  # noqa: E402
    ImageProcessor as JImageProcessor,
    ImageProcessorConfig as JImageProcessorConfig,
)
from align_anything_tpu.data.template_registry import (  # noqa: E402
    TEMPLATE_REGISTRY as JREGISTRY,
)
from align_anything_tpu.data.tokenizer import (  # noqa: E402
    HashTokenizer as JHashTokenizer,
)
from align_anything_tpu.models import multimodal as jmm  # noqa: E402
from align_anything_tpu.models.hf_loader import (  # noqa: E402
    load_multimodal_params as jload,
)
from align_anything_tpu_torch.data import video as tvideo  # noqa: E402
from align_anything_tpu_torch.data.chat_template import ChatTemplate  # noqa: E402
from align_anything_tpu_torch.data.image import (  # noqa: E402
    ImageProcessor,
    ImageProcessorConfig,
)
from align_anything_tpu_torch.data.template_registry import (  # noqa: E402
    TEMPLATE_REGISTRY,
)
from align_anything_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from align_anything_tpu_torch.models import multimodal as tmm  # noqa: E402
from align_anything_tpu_torch.models.hf_loader import (  # noqa: E402
    load_multimodal_params as tload,
    save_multimodal_params,
)
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_video_to_text import (  # noqa: E402
    dpo as tdpo,
    grpo as tgrpo,
    ppo as tppo,
    rm as trm,
    sft as tsft,
)
from test_torch_rl_trainers import (  # noqa: E402
    NEW_TOKENS,
    _leaves,
    one_compile,
)
from test_torch_ti2t_trainers import IMAGE_TOKEN  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
VIDEO_TOKEN = IMAGE_TOKEN + 1
HIDDEN = 32
PATCHES, POOLED = 16, 4          # a frame's 4 x 4 grid, pooled 2 x 2


def _hf_config(layers=2, stride=2):
    return transformers.LlavaNextVideoConfig(
        vision_config=dict(image_size=32, patch_size=8, hidden_size=24,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=48, projection_dim=24),
        text_config=dict(model_type='llama', vocab_size=256,
                         hidden_size=HIDDEN, intermediate_size=64,
                         num_hidden_layers=layers, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=512,
                         bos_token_id=1, eos_token_id=2, pad_token_id=0),
        image_grid_pinpoints=[[32, 32], [32, 64], [64, 32]],
        image_token_index=IMAGE_TOKEN, video_token_index=VIDEO_TOKEN,
        spatial_pool_mode='average', spatial_pool_stride=stride,
        vision_feature_layer=-2, vision_feature_select_strategy='default')


@pytest.fixture(scope='module')
def lnv(tmp_path_factory):
    torch.manual_seed(0)
    hf = transformers.LlavaNextVideoForConditionalGeneration(
        _hf_config()).eval()
    d = tmp_path_factory.mktemp('lnv')
    hf.save_pretrained(d, safe_serialization=True)
    return hf, d


def _both_loaded(d):
    tparams, tcfg = tload(str(d), device='cpu')
    jparams, jcfg = jload(str(d))
    return (tparams, tcfg.replace(compute_dtype='float32'), jparams,
            jcfg.replace(compute_dtype='float32', attention_impl='xla'))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_loader_matches_jax(lnv):
    """The tree (``image_newline`` too: the config has pinpoints) and the
    config: the video token, the stride."""
    _, d = lnv
    tparams, tcfg = tload(str(d), device='cpu')
    jparams, jcfg = jload(str(d))
    want = _leaves(jparams)
    got = _leaves(tparams)
    assert set(got) == set(want) and '/image_newline' in got
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert (tcfg.image_token_id, tcfg.video_token_id,
            tcfg.spatial_pool_stride, tcfg.image_grid_pinpoints) == (
        jcfg.image_token_id, jcfg.video_token_id, jcfg.spatial_pool_stride,
        jcfg.image_grid_pinpoints)
    assert (tcfg.video_token_id, tcfg.spatial_pool_stride) == (VIDEO_TOKEN,
                                                                2)
    assert dataclasses.asdict(tcfg.text) == dataclasses.asdict(jcfg.text)


def test_loader_refuses_other_pooling(lnv, tmp_path):
    """Only average pooling: both loaders raise ``ValueError`` on
    another ``spatial_pool_mode``."""
    _, d = lnv
    for f in os.listdir(d):
        shutil.copy(d / f, tmp_path / f)
    hf = json.loads((tmp_path / 'config.json').read_text())
    hf['spatial_pool_mode'] = 'max'
    (tmp_path / 'config.json').write_text(json.dumps(hf))
    for load in (lambda: tload(str(tmp_path), device='cpu'),
                 lambda: jload(str(tmp_path))):
        with pytest.raises(ValueError, match='average'):
            load()


@pytest.mark.parametrize('stride', [2, 3])
def test_project_video_features_matches_jax(lnv, stride):
    """Two videos of three frames: stride 2 pools the 4 x 4 grid to 2 x 2;
    stride 3 drops the grid's last row and column and pools to 1 x 1."""
    _, d = lnv
    tparams, tcfg, jparams, jcfg = _both_loaded(d)
    tcfg = tcfg.replace(spatial_pool_stride=stride)
    jcfg = jcfg.replace(spatial_pool_stride=stride)
    px = np.random.default_rng(stride).standard_normal(
        (2, 3, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = tmm.project_video_features(tparams, tcfg, torch.from_numpy(px))
    want = jmm.project_video_features(jparams, jcfg, jnp.asarray(px))
    assert got.shape == (2, 3 * (4 // stride) ** 2, HIDDEN)
    _close(got, want)


def _video_rows(token, per_frame, frames=3, seed=0):
    """Two rows [bos, 2 words, frames x per_frame ``token``s, 3 words],
    the second right-padded by 2, and their videos (2, frames, 3, 32,
    32)."""
    rng = np.random.default_rng(seed)
    n = frames * per_frame
    ids = np.concatenate([np.ones((2, 1)), rng.integers(3, 200, (2, 2)),
                          np.full((2, n), token),
                          rng.integers(3, 200, (2, 3))], 1).astype(np.int64)
    mask = np.ones_like(ids)
    ids[1, -2:], mask[1, -2:] = 0, 0
    px = rng.standard_normal((2, frames, 3, 32, 32)).astype(np.float32)
    return ids, mask, px


@pytest.mark.parametrize('pooled', [True, False])
def test_video_forward_and_logprobs_match_jax(lnv, pooled):
    """The pooled branch (the stride set: frames over the video token) and
    the unpooled one (no stride: every frame's patches over the image
    token): logits and ``token_logprobs`` against JAX's; the frames reach
    the output."""
    _, d = lnv
    tparams, tcfg, jparams, jcfg = _both_loaded(d)
    if pooled:
        ids, mask, px = _video_rows(VIDEO_TOKEN, POOLED)
    else:
        tcfg = tcfg.replace(spatial_pool_stride=None)
        jcfg = jcfg.replace(spatial_pool_stride=None)
        ids, mask, px = _video_rows(IMAGE_TOKEN, PATCHES)
    with torch.no_grad():
        kw = dict(attention_mask=torch.from_numpy(mask),
                  pixel_values=torch.from_numpy(px))
        got = tmm.forward(tparams, tcfg, torch.from_numpy(ids), **kw)
        got_lp = tmm.token_logprobs(tparams, tcfg, torch.from_numpy(ids),
                                    **kw)
        bare = tmm.forward(tparams, tcfg, torch.from_numpy(ids),
                           attention_mask=torch.from_numpy(mask))
    jkw = dict(attention_mask=jnp.asarray(mask), pixel_values=jnp.asarray(px))
    want = jmm.forward(jparams, jcfg, jnp.asarray(ids), **jkw)
    _close(got.logits, want.logits)
    _close(got_lp, jmm.token_logprobs(jparams, jcfg, jnp.asarray(ids), **jkw))
    assert not torch.allclose(got.logits, bare.logits)


def test_video_forward_matches_transformers(lnv):
    """The pooled forward against ``LlavaNextVideoForConditionalGeneration``
    on ``pixel_values_videos``."""
    hf, d = lnv
    params, cfg = tload(str(d), device='cpu')
    cfg = cfg.replace(compute_dtype='float32')
    ids, mask, px = _video_rows(VIDEO_TOKEN, POOLED, seed=4)
    ids, mask, px = ids[:1], mask[:1], px[:1]
    with torch.no_grad():
        got = tmm.forward(params, cfg, torch.from_numpy(ids),
                          attention_mask=torch.from_numpy(mask),
                          pixel_values=torch.from_numpy(px)).logits
        ref = hf(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask),
                 pixel_values_videos=torch.from_numpy(px)).logits
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-5, rtol=0)


def test_export_reads_back(lnv, tmp_path):
    """The port's ``llava_next_video`` export: JAX's loader and the port's
    read it back equal, and transformers loads it to the same logits with
    a video."""
    hf, d = lnv
    params, cfg = tload(str(d), device='cpu')
    save_multimodal_params(str(tmp_path), params, cfg)
    hf_cfg = json.loads((tmp_path / 'config.json').read_text())
    assert (hf_cfg['model_type'], hf_cfg['architectures'],
            hf_cfg['video_token_index'], hf_cfg['spatial_pool_mode'],
            hf_cfg['spatial_pool_stride']) == (
        'llava_next_video', ['LlavaNextVideoForConditionalGeneration'],
        VIDEO_TOKEN, 'average', 2)
    jparams, jcfg = jload(str(tmp_path))
    back, cfg2 = tload(str(tmp_path), device='cpu')
    assert cfg2 == cfg
    assert (jcfg.video_token_id, jcfg.spatial_pool_stride) == (VIDEO_TOKEN, 2)
    want = _leaves(params)
    for tree in (jparams, back):
        got = _leaves(tree)
        assert set(got) == set(want)
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    again = transformers.LlavaNextVideoForConditionalGeneration\
        .from_pretrained(str(tmp_path)).eval()
    ids, mask, px = _video_rows(VIDEO_TOKEN, POOLED, seed=5)
    with torch.no_grad():
        kw = dict(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(mask),
                  pixel_values_videos=torch.from_numpy(px))
        np.testing.assert_array_equal(again(**kw).logits.numpy(),
                                      hf(**kw).logits.numpy())


# ---------------------------------------------------------------------------
# the data layer
# ---------------------------------------------------------------------------

def _video(t=5, h=24, w=30, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(t, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize('kind', ['array', 'npy', 'list'])
@pytest.mark.parametrize('n', [1, 3, 8])
def test_sample_frames_matches_jax(tmp_path, kind, n):
    """Arrays, ``.npy`` paths and lists of frames, fewer and more frames
    asked for than the video has."""
    vid = _video()
    src = {'array': vid, 'list': list(vid)}.get(kind)
    if kind == 'npy':
        src = str(tmp_path / 'v.npy')
        np.save(src, vid)
    got = tvideo.sample_frames(src, n)
    want = jvideo.sample_frames(src, n)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        tvideo.sample_frames(3, n)


def test_tv2t_template_registered_and_equal():
    import align_anything_tpu_torch.data  # noqa: F401  (registers)

    row = {'question': 'what happens', 'response': 'a dog runs',
           'video': 'v.npy', 'overall_response': 2, 'response_1': 'a cat',
           'response_2': 'a dog'}
    ours, theirs = TEMPLATE_REGISTRY['AA_TV2T'](), JREGISTRY['AA_TV2T']()
    for method in ('format_supervised_sample', 'format_preference_sample',
                   'format_prompt_only_sample'):
        assert getattr(ours, method)(row) == getattr(theirs, method)(row)


@pytest.fixture(scope='module')
def video_rows(tmp_path_factory):
    """AA_TV2T rows over ``.npy`` videos of 3-7 frames of differing sizes;
    the last supervised row has no video."""
    d = tmp_path_factory.mktemp('tv2t_rows')
    rng = np.random.default_rng(11)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps']

    def pick(k):
        return ' '.join(words[j] for j in rng.integers(0, 5, size=k))

    rows = []
    for i in range(5):
        path = d / f'v{i}.npy'
        np.save(path, _video(int(rng.integers(3, 8)),
                             int(rng.integers(20, 40)), 28, seed=i))
        rows.append({'question': pick(3), 'response': pick(4),
                     'response_1': pick(4),
                     'response_2': pick(int(rng.integers(1, 6))),
                     'overall_response': int(rng.integers(1, 3)),
                     'video': None if i == 4 else str(path)})
    (d / 'rows.jsonl').write_text(''.join(json.dumps(r) + '\n'
                                          for r in rows[:4]))
    (d / 'sft.jsonl').write_text(''.join(json.dumps(r) + '\n' for r in rows))
    return d


def _video_datasets(d, kind):
    tok, jtok = HashTokenizer(vocab_size=512), JHashTokenizer(vocab_size=512)
    cls = {'sft': (tvideo.TV2TSupervisedDataset,
                   jvideo.TV2TSupervisedDataset),
           'pref': (tvideo.TV2TPreferenceDataset,
                    jvideo.TV2TPreferenceDataset),
           'prompt': (tvideo.TV2TPromptOnlyDataset,
                      jvideo.TV2TPromptOnlyDataset)}[kind]
    path = str(d / ('sft.jsonl' if kind == 'sft' else 'rows.jsonl'))
    kw = dict(image_token_id=IMAGE_TOKEN, num_patches=4, n_frames=3,
              max_length=96)
    ours = cls[0](path, ChatTemplate(tok, 'AA_TV2T'), tok,
                  image_processor=ImageProcessor(ImageProcessorConfig(
                      size=28)), **kw)
    theirs = cls[1](path, JChatTemplate(jtok, 'AA_TV2T'), jtok,
                    image_processor=JImageProcessor(JImageProcessorConfig(
                        size=28)), **kw)
    return ours, theirs


def _equal(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _equal(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(b, list) and b and isinstance(b[0], dict):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize('kind', ['sft', 'pref', 'prompt'])
def test_tv2t_datasets_match_jax(video_rows, kind):
    """Each row and the collated batch equal JAX's: <video> expanded to
    n_frames x num_patches image tokens (never labelled), (n_frames, C, H,
    W) frames a row, 5-D batches ([better; worse] for pairs), the prompt
    set's frames in ``meta``."""
    ours, theirs = _video_datasets(video_rows, kind)
    assert len(ours) == len(theirs) > 0
    samples = [ours[i] for i in range(len(ours))]
    jsamples = [theirs[i] for i in range(len(theirs))]
    for a, b in zip(samples, jsamples):
        _equal(a, b)
    got = ours.get_collator(buckets=(64, 96))(samples)
    want = theirs.get_collator(buckets=(64, 96))(jsamples)
    _equal(got, want)
    image = got['input_ids'] == IMAGE_TOKEN
    assert (image.sum(-1) == 12).all()
    if kind == 'prompt':
        assert got['meta'][0]['pixel_values'].shape == (3, 3, 28, 28)
        return
    assert got['pixel_values'].shape[1:] == (3, 3, 28, 28)
    if kind == 'sft':
        assert (got['labels'][image] == -100).all()
        assert (got['pixel_values'][4] == 0).all()
    else:
        n = len(samples)
        np.testing.assert_array_equal(got['pixel_values'][:n],
                                      got['pixel_values'][n:])


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

def make_tv2t_assets(d, rows: int = 16):
    """A one-layer LLaVA-NeXT-Video checkpoint (``d / 'model'``), a reward
    model (the checkpoint with a ``score_head.npy``), and ``rows`` AA_TV2T
    rows (supervised, preference and prompt fields) over ``.npy`` videos
    of 3-6 frames."""
    torch.manual_seed(0)
    transformers.LlavaNextVideoForConditionalGeneration(
        _hf_config(layers=1)).eval().save_pretrained(
        d / 'model', safe_serialization=True)
    shutil.copytree(d / 'model', d / 'reward')
    np.save(d / 'reward' / 'score_head.npy',
            np.random.default_rng(1).standard_normal((HIDDEN, 1)).astype(
                np.float32))
    rng = np.random.default_rng(0)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps', 'zeta']

    def pick(k):
        return ' '.join(words[j] for j in rng.integers(0, 6, size=k))

    with open(d / 'rows.jsonl', 'w') as f:
        for i in range(rows):
            path = d / f'v{i}.npy'
            np.save(path, _video(int(rng.integers(3, 7)),
                                 int(rng.integers(24, 40)), 32, seed=i))
            f.write(json.dumps({
                'question': f'what {pick(int(rng.integers(1, 9)))} {i}',
                'response': pick(int(rng.integers(1, 8))),
                'response_1': pick(int(rng.integers(1, 8))),
                'response_2': pick(int(rng.integers(1, 8))),
                'overall_response': int(rng.integers(1, 3)),
                'video': str(path)}) + '\n')
    return d


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return make_tv2t_assets(tmp_path_factory.mktemp('tv2t_assets'))


def _argv(assets, out, extra=()):
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / 'rows.jsonl'),
            '--train_template', 'AA_TV2T', '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[64]', '--save_checkpoint', 'False',
            '--n_frames', '2', '--per_device_train_batch_size', '1', *extra]


def _rl_argv(assets, out, task_extra=()):
    return ['--actor_model_name_or_path', str(assets / 'model'),
            '--reward_model_name_or_path', str(assets / 'reward'),
            '--train_datasets', str(assets / 'rows.jsonl'),
            '--train_template', 'AA_TV2T', '--output_dir', str(out),
            '--epochs', '1', '--max_new_tokens', str(NEW_TOKENS),
            '--bf16', 'False', '--save_checkpoint', 'False',
            '--per_device_prompt_batch_size', '1', *task_extra]


def test_r26_video_dropped_in_both(assets, tmp_path):
    """R26 in both packages: TV2T DPO on a LLaVA-NeXT-Video checkpoint
    expands <video> to the image token, the pooled branch merges over the
    video token, so the log-probs with the frames equal those without."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_video_to_text.dpo import (
        TV2TDPOTrainer,
    )

    argv = _argv(assets, tmp_path)
    cfgs, pc = jcli.parse_cfgs('text_video_to_text/dpo', argv)
    jtrainer = one_compile(TV2TDPOTrainer(cfgs=cfgs, parallel_cfgs=pc))
    cfgs, pc = tcli.parse_cfgs('text_video_to_text/dpo', argv)
    trainer = tdpo.TV2TDPOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    batch = next(trainer.train_iterator.epoch_batches(0))
    assert (batch['input_ids'] == IMAGE_TOKEN).any()
    assert not (batch['input_ids'] == VIDEO_TOKEN).any()
    assert batch['pixel_values'].ndim == 5
    assert trainer.model_cfg.spatial_pool_stride == 2
    bare = {k: v for k, v in batch.items() if k != 'pixel_values'}
    with torch.no_grad():
        t_with = trainer.compute_token_logprobs(trainer.state.params,
                                                trainer.put_batch(batch))
        t_without = trainer.compute_token_logprobs(trainer.state.params,
                                                   trainer.put_batch(bare))
    torch.testing.assert_close(t_with, t_without, rtol=0, atol=0)
    j_with = jtrainer.compute_token_logprobs(
        jtrainer.state.params, jax.tree.map(jnp.asarray, batch))
    j_without = jtrainer.compute_token_logprobs(
        jtrainer.state.params, jax.tree.map(jnp.asarray, bare))
    np.testing.assert_array_equal(np.asarray(j_with), np.asarray(j_without))


def test_tv2t_trainers_default_to_the_card(assets, tmp_path, monkeypatch):
    """No device given: each TV2T trainer takes the first CUDA device, and
    raises where there is none."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rl = _rl_argv(assets, tmp_path)
    for cls, task, argv in (
            (tsft.TV2TSupervisedTrainer, 'text_video_to_text/sft',
             _argv(assets, tmp_path)),
            (tdpo.TV2TDPOTrainer, 'text_video_to_text/dpo',
             _argv(assets, tmp_path)),
            (trm.TV2TRMTrainer, 'text_video_to_text/rm',
             _argv(assets, tmp_path)),
            (tppo.TV2TPPOTrainer, 'text_video_to_text/ppo', rl),
            (tgrpo.TV2TGRPOTrainer, 'text_image_to_text/grpo', rl)):
        cfgs, pc = tcli.parse_cfgs(task, argv)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            cls(cfgs=cfgs, parallel_cfgs=pc)


@pytest.mark.parametrize('algo', ['sft', 'dpo', 'rm', 'ppo', 'grpo'])
def test_tv2t_entry_point(algo):
    """``python -m align_anything_tpu_torch.trainers.text_video_to_text.
    <algo>`` exists and parses its command line (``--help`` exits before
    the trainer is built)."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run(
        [sys.executable, '-m',
         f'align_anything_tpu_torch.trainers.text_video_to_text.{algo}',
         '--help'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'usage' in proc.stdout

