"""The port's Qwen2-Audio path against the JAX package's, on the CPU: the
log-mel frontend (``ops/audio.py``), the model (``models/audio.py``: the
convolutions' padding, the tower, forward, log-probs, prefill through the
cache), the loader and writer (``models/hf_loader.py``), ``save_hf_slice``,
the bridge of the JAX tree, and the audio templates.  Sizes are JAX's own
test sizes: 32 mel bins, ``max_frames`` 32 (8 audio tokens), a one-layer
tower 32 wide, the trunk 2 layers of 32.

The checkpoint is a tiny ``Qwen2AudioForConditionalGeneration`` saved by
transformers; its tree goes to the port through the port's loader and to
JAX through JAX's.  A random tree (the port's init, perturbed) goes to
JAX as arrays and to the port through ``models/bridge.py``; the JAX
functions are jitted (one compile each).

Tolerances (fp32): the mel bank exactly (the same numpy code); the log-mel
within 1e-4 absolute (both stay within 6e-5 of a float64 recompute; the
gap is widest 8 decades under a clip's peak, where the FFTs' roundings
show); the convolutions within 1e-5; tower, logits and log-probs within
1e-4 absolute; the loaders' trees exactly; transformers' logits within
5e-5, as JAX's ``tests/test_audio.py`` holds them.

ROADMAP §3 R28: transformers masks the padded frames of a short clip and
keeps only its own audio tokens; JAX, and the port with it, attend over
every frame of the padded clip and keep all ``num_audio_tokens``.
``test_r28_transformers_masks_short_clips`` shows both sides.
"""

import json
import wave

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.data import multimodal_formatters as jfmt  # noqa: E402
from align_anything_tpu.models import audio as ja  # noqa: E402
from align_anything_tpu.models.hf_loader import (  # noqa: E402
    load_audio_params as jload,
)
from align_anything_tpu.ops import audio as jops  # noqa: E402
from align_anything_tpu_torch.checkpoint import save_hf_slice  # noqa: E402
from align_anything_tpu_torch.data import (  # noqa: E402
    multimodal_formatters as tfmt,
)
from align_anything_tpu_torch.generation import (  # noqa: E402
    GenerationConfig,
    generate,
)
from align_anything_tpu_torch.models import audio as ta  # noqa: E402
from align_anything_tpu_torch.models import transformer as ttr  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.hf_loader import (  # noqa: E402
    load_audio_params as tload,
    save_audio_params as tsave,
)
from align_anything_tpu_torch.ops import audio as tops  # noqa: E402
from align_anything_tpu_torch.utils.tools import tree_map  # noqa: E402

AUDIO_TOKEN = 120
N_MELS, FRAMES, TOKENS = 32, 32, 8
WAVE_LEN = FRAMES * 160
MEL_TOL = 1e-4
TOL = 1e-4


def hf_audio_config(text_layers=2, tie=True):
    return transformers.Qwen2AudioConfig(
        audio_config=dict(d_model=32, encoder_attention_heads=2,
                          encoder_ffn_dim=64, encoder_layers=1,
                          num_mel_bins=N_MELS,
                          max_source_positions=FRAMES // 2),
        text_config=dict(vocab_size=128, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=text_layers,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=256,
                         tie_word_embeddings=tie),
        audio_token_index=AUDIO_TOKEN)


def perturb_hf(model, seed=0):
    """Every bias and norm of a fresh transformers model away from its
    init (zeros / ones), so that the tests see each of them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('bias') or 'norm' in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    """(directory, transformers model) of a tiny Qwen2-Audio checkpoint
    with an untied head."""
    d = tmp_path_factory.mktemp('qwen2_audio')
    torch.manual_seed(0)
    hf = perturb_hf(transformers.Qwen2AudioForConditionalGeneration(
        hf_audio_config(tie=False)).eval())
    hf.save_pretrained(d, safe_serialization=True)
    return d, hf


def _waves(n, seed=0, length=WAVE_LEN, clip=None):
    """(n, length) fp32 clips: noise, a tone, a clip of ``clip`` samples
    then silence."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, length)) * 0.1).astype(np.float32)
    t = np.arange(length)
    w[0] = np.sin(t * 0.31 + seed).astype(np.float32) * 0.5
    if clip is not None:
        w[:, clip:] = 0.0
    return w


def _ids(n, seed=0, text=6):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(3, 100, (n, 2)),
                           np.full((n, TOKENS), AUDIO_TOKEN),
                           rng.integers(3, 100, (n, text))], 1)


def _jax_cfg(cfg: ta.AudioLMConfig) -> ja.AudioLMConfig:
    from align_anything_tpu.models.config import ModelConfig

    return ja.AudioLMConfig(
        text=ModelConfig(**{f: getattr(cfg.text, f) for f in (
            'vocab_size', 'hidden_size', 'num_layers', 'num_heads',
            'num_kv_heads', 'head_dim', 'mlp_dim', 'max_position_embeddings',
            'rope_theta', 'norm_eps', 'qkv_bias', 'tie_word_embeddings',
            'compute_dtype')}),
        audio=ja.AudioEncoderConfig(**{
            f: getattr(cfg.audio, f) for f in (
                'n_mels', 'hidden_size', 'num_layers', 'num_heads', 'mlp_dim',
                'max_frames', 'norm_eps', 'pool_stride')}),
        audio_token_id=cfg.audio_token_id)


def _tiny_cfg():
    from align_anything_tpu_torch.models.config import ModelConfig

    return ta.AudioLMConfig(
        text=ModelConfig(vocab_size=128, hidden_size=32, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=8, mlp_dim=64,
                         max_position_embeddings=256, qkv_bias=True,
                         compute_dtype='float32'),
        audio=ta.AudioEncoderConfig(n_mels=N_MELS, hidden_size=32,
                                    num_layers=1, num_heads=2, mlp_dim=64,
                                    max_frames=FRAMES),
        audio_token_id=AUDIO_TOKEN)


@pytest.fixture(scope='module')
def random_pair():
    """(port params, port config, JAX params, JAX config): the port's init
    perturbed so that every zero bias and unit norm matters, as numpy, to
    the port through ``models/bridge.py`` and to JAX as arrays."""
    cfg = _tiny_cfg()
    rng = np.random.default_rng(1)
    tree = tree_map(lambda t: t.numpy() + 0.05 * rng.standard_normal(
        t.shape).astype(np.float32),
        ta.init_params(cfg, torch.Generator().manual_seed(0), 'cpu'))
    return from_jax_tree(tree, 'cpu'), cfg, \
        jax.tree.map(jnp.asarray, tree), _jax_cfg(cfg)


# the JAX functions compiled once each (op-by-op dispatch compiles every
# primitive on first use: five times slower here)
j_encode = jax.jit(ja.encode_audio, static_argnums=1)
j_forward = jax.jit(ja.forward, static_argnums=1)
j_logprobs = jax.jit(ja.token_logprobs, static_argnums=1)


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _leaves(sub, f'{prefix}/{k}').items()}
    return {prefix: np.asarray(tree.detach().numpy()
                               if hasattr(tree, 'detach') else tree)}


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n_mels', [32, 80, 128])
def test_mel_filter_bank_matches_jax_and_transformers(n_mels):
    from transformers.audio_utils import mel_filter_bank as hf_fb

    ours = tops.mel_filter_bank(201, n_mels, 16000)
    np.testing.assert_array_equal(ours, jops.mel_filter_bank(201, n_mels,
                                                             16000))
    ref = hf_fb(num_frequency_bins=201, num_mel_filters=n_mels,
                min_frequency=0.0, max_frequency=8000.0,
                sampling_rate=16000, norm='slaney', mel_scale='slaney')
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize('n_mels,length,clip', [
    (32, WAVE_LEN, None), (128, 16000, 5000), (80, 4000, None)])
def test_log_mel_matches_jax(n_mels, length, clip):
    """(B, n_mels, T // 160) on a batch of noise, a tone, and clips cut to
    silence (the per-sample clamp at max - 8 differs row by row)."""
    w = _waves(3, seed=n_mels, length=length, clip=clip)
    want = np.asarray(jops.log_mel_spectrogram(jnp.asarray(w), n_mels=n_mels))
    got = tops.log_mel_spectrogram(torch.from_numpy(w), n_mels=n_mels)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (3, n_mels, length // 160)
    np.testing.assert_allclose(got.numpy(), want, atol=MEL_TOL, rtol=0)


def test_log_mel_matches_whisper_feature_extractor():
    """Against the feature extractor's own numpy path (its torch path
    computes the same, after a first call of about 12 s here)."""
    fe = transformers.WhisperFeatureExtractor(
        feature_size=80, n_fft=400, hop_length=160, sampling_rate=16000)
    wave_ = _waves(1, seed=3, length=16000)[0] * 0.3
    ref = fe._np_extract_fbank_features(wave_[None], 'cpu')[0]
    ours = tops.log_mel_spectrogram(torch.from_numpy(wave_)[None],
                                    n_mels=80)[0].numpy()
    n = min(ref.shape[1], ours.shape[1])
    np.testing.assert_allclose(ours[:, :n], ref[:, :n], atol=2e-4)


def test_mel_product_ignores_tf32_flag():
    """The mel product leaves ``allow_tf32`` as it found it."""
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tops.log_mel_spectrogram(torch.from_numpy(_waves(1)), n_mels=32)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('stride,t', [(1, 32), (2, 32), (2, 33), (1, 7)])
def test_conv1d_padding_matches_jax_and_torch_conv(stride, t):
    """Symmetric padding 1 at both strides (the stride-2 windows center on
    even frames), as JAX's explicit padding and ``Conv1d(padding=1)``."""
    rng = np.random.default_rng(t + stride)
    x = rng.standard_normal((2, t, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    got = ta._conv1d(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), stride).numpy()
    want = np.asarray(ja._conv1d(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), stride))
    assert got.shape == want.shape == (2, (t - 1) // stride + 1, 6)
    np.testing.assert_allclose(got, want, atol=1e-5)
    conv = torch.nn.Conv1d(5, 6, 3, stride=stride, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(2, 1, 0))
        conv.bias.copy_(torch.from_numpy(b))
        ref = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-5)


def test_init_tree_matches_jax(random_pair):
    """``init_params`` builds JAX's tree and shapes: no patch path, the
    convolutions (K, C_in, C_out), ``max_frames // 2`` positions."""
    params, cfg, _, jcfg = random_pair
    mine = ta.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    shapes = {p: v.shape for p, v in _leaves(mine).items()}
    jax_shapes = jax.eval_shape(lambda k: ja.init_params(jcfg, k),
                                jax.random.PRNGKey(0))
    assert shapes == {p: tuple(v.shape) for p, v in _leaves(
        jax.tree.map(lambda a: np.empty(a.shape, a.dtype),
                     jax_shapes)).items()}
    assert shapes == {p: v.shape for p, v in _leaves(params).items()}
    assert shapes['/audio_tower/conv1/w'] == (3, N_MELS, 32)
    assert shapes['/audio_tower/pos_embed'] == (FRAMES // 2, 32)
    assert 'patch_embed' not in mine['audio_tower']
    assert cfg.audio.num_audio_tokens == TOKENS


@pytest.mark.parametrize('clip', [None, 1600])
def test_encode_audio_matches_jax(random_pair, clip):
    """The tower and projector: a full clip and a short one (zero-padded
    as the dataset pads it); a waveform shorter than ``max_frames`` has its
    mel frames zero-padded, a longer one cut."""
    params, cfg, jparams, jcfg = random_pair
    for length in (WAVE_LEN, 1600, 2 * WAVE_LEN):
        w = _waves(2, seed=length, length=length, clip=clip)
        got = ta.encode_audio(params, cfg, torch.from_numpy(w))
        want = np.asarray(j_encode(jparams, jcfg, jnp.asarray(w)))
        assert tuple(got.shape) == want.shape == (2, TOKENS, 32)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL)


def test_forward_and_logprobs_match_jax(random_pair):
    params, cfg, jparams, jcfg = random_pair
    w = _waves(3, seed=5)
    ids = _ids(3, seed=5)
    mask = np.ones_like(ids)
    mask[1, -2:] = 0
    kw = dict(attention_mask=mask, audio_values=w)
    got = ta.forward(params, cfg, torch.from_numpy(ids), **{
        k: torch.from_numpy(v) for k, v in kw.items()}).logits
    want = j_forward(jparams, jcfg, jnp.asarray(ids), **{
        k: jnp.asarray(v) for k, v in kw.items()}).logits
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.detach().numpy()[valid],
                               np.asarray(want)[valid], atol=TOL)
    got = ta.token_logprobs(params, cfg, torch.from_numpy(ids), **{
        k: torch.from_numpy(v) for k, v in kw.items()})
    want = j_logprobs(jparams, jcfg, jnp.asarray(ids), **{
        k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.detach().numpy()[valid[:, 1:]],
                               np.asarray(want)[valid[:, 1:]], atol=TOL)
    # without audio the model is the text trunk alone
    bare = ta.forward(params, cfg, torch.from_numpy(ids)).logits
    text = ttr.forward(params['language_model'], cfg.text,
                       torch.from_numpy(ids)).logits
    torch.testing.assert_close(bare, text, rtol=0, atol=0)


def test_generate_with_audio_prefill_matches_jax(random_pair):
    """Greedy ``generate`` with the audio prefill (``media``) against JAX's
    engine on the same left-padded prompts."""
    from align_anything_tpu.generation import GenerationConfig as JGen
    from align_anything_tpu.generation import generate as jgenerate

    params, cfg, jparams, jcfg = random_pair
    w = _waves(2, seed=9)
    ids = _ids(2, seed=9, text=3)
    mask = np.ones_like(ids)
    ids[1, :2], mask[1, :2] = 0, 0           # left padding
    got = generate(params, cfg, GenerationConfig(max_new_tokens=5,
                                                 greedy=True),
                   torch.from_numpy(ids), torch.from_numpy(mask),
                   media={'audio_values': torch.from_numpy(w)},
                   prefill_forward=ta.forward, step_forward=ta.decode_forward)
    want = jgenerate(jparams, jcfg, JGen(max_new_tokens=5, greedy=True),
                     jnp.asarray(ids), jnp.asarray(mask),
                     jax.random.PRNGKey(0),
                     media={'audio_values': jnp.asarray(w)},
                     prefill_forward=ja.forward,
                     step_forward=ja.decode_forward)
    np.testing.assert_array_equal(got['sequences'].numpy(),
                                  np.asarray(want['sequences']))


# ---------------------------------------------------------------------------
# loader and writer
# ---------------------------------------------------------------------------

def test_loader_matches_jax_and_transformers(ckpt):
    d, hf = ckpt
    params, cfg = tload(str(d), device='cpu')
    jparams, jcfg = jload(str(d))
    got, want = _leaves(params), _leaves(jparams)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert (cfg.audio.n_mels, cfg.audio.max_frames, cfg.audio_token_id,
            cfg.text.qkv_bias, cfg.text.head_dim, cfg.text.norm_eps) == (
        jcfg.audio.n_mels, jcfg.audio.max_frames, jcfg.audio_token_id,
        jcfg.text.qkv_bias, jcfg.text.head_dim, jcfg.text.norm_eps)
    assert not cfg.tie_word_embeddings and 'lm_head' in params[
        'language_model']
    np.testing.assert_array_equal(
        got['/audio_tower/layers/k/b'], np.zeros((1, 2, 16), np.float32))
    # the logits of transformers' model on the full padded clip, every
    # frame attended (R28: what transformers does with a short clip is in
    # test_r28_transformers_masks_short_clips)
    cfg = cfg.replace(compute_dtype='float32')
    w = _waves(1, seed=2)
    ids = _ids(1, seed=2)
    ours = ta.forward(params, cfg, torch.from_numpy(ids),
                      audio_values=torch.from_numpy(w)).logits
    mel = tops.log_mel_spectrogram(torch.from_numpy(w), n_mels=N_MELS)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.ones_like(torch.from_numpy(ids)),
                 input_features=mel,
                 feature_attention_mask=torch.ones(1, FRAMES,
                                                   dtype=torch.long)).logits
    np.testing.assert_allclose(ours.detach().numpy(), ref.numpy(), atol=5e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_writer_round_trips(ckpt, tmp_path, dtype):
    """``save_audio_params`` writes what both loaders and transformers read
    back: the trees equal (bf16: the rounded tree), the zero key bias
    dropped and restored, transformers' logits equal the source's."""
    d, hf = ckpt
    params, cfg = tload(str(d), device='cpu')
    dt = getattr(torch, dtype)
    tsave(str(tmp_path / 'out'), params, cfg, dtype=dt)
    with open(tmp_path / 'out' / 'config.json') as f:
        hf_cfg = json.load(f)
    assert hf_cfg['model_type'] == 'qwen2_audio'
    assert hf_cfg['audio_config']['max_source_positions'] == FRAMES // 2
    back, cfg2 = tload(str(tmp_path / 'out'), device='cpu')
    jback, _ = jload(str(tmp_path / 'out'))
    want = _leaves(params)
    for path, leaf in _leaves(back).items():
        np.testing.assert_array_equal(
            leaf, torch.from_numpy(want[path]).to(dt).float().numpy(),
            err_msg=path)
        np.testing.assert_array_equal(leaf, _leaves(jback)[path],
                                      err_msg=path)
    assert cfg2 == cfg
    if dtype == 'float32':
        reloaded = transformers.Qwen2AudioForConditionalGeneration \
            .from_pretrained(str(tmp_path / 'out')).eval()
        ids = torch.from_numpy(_ids(1, seed=4))
        mel = torch.randn(1, N_MELS, FRAMES)
        fam = torch.ones(1, FRAMES, dtype=torch.long)
        with torch.no_grad():
            ref = hf(input_ids=ids, input_features=mel,
                     feature_attention_mask=fam).logits
            got = reloaded(input_ids=ids, input_features=mel,
                           feature_attention_mask=fam).logits
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_writer_refuses_an_opt_trunk(tmp_path):
    cfg = _tiny_cfg()
    cfg = cfg.replace(positional='learned')
    with pytest.raises(ValueError, match='OPT'):
        tsave(str(tmp_path), {}, cfg)


def test_save_hf_slice_writes_qwen2_audio(ckpt, tmp_path):
    d, _ = ckpt
    params, cfg = tload(str(d), device='cpu')
    params['score_head'] = {'w': torch.zeros(32, 1)}
    path = save_hf_slice(str(tmp_path), 3, params, cfg)
    assert path.endswith('slice_3')
    back, _ = tload(path, device='cpu')
    want = _leaves({k: v for k, v in params.items() if k != 'score_head'})
    got = _leaves(back)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def test_r28_transformers_masks_short_clips(ckpt):
    """R28.  A 0.1 s clip zero-padded to the 32 frames, as the dataset
    pads it: the port (as JAX) attends over all 32 frames and merges all 8
    audio tokens; transformers, given the clip's own frame mask, attends
    over its 10 frames, keeps 2 tokens, and refuses 8."""
    d, hf = ckpt
    params, cfg = tload(str(d), device='cpu')
    cfg = cfg.replace(compute_dtype='float32')
    w = _waves(1, seed=7, clip=1600)
    mel = tops.log_mel_spectrogram(torch.from_numpy(w), n_mels=N_MELS)
    fam = torch.zeros(1, FRAMES, dtype=torch.long)
    fam[:, :1600 // 160] = 1
    _, out_len = hf.audio_tower._get_feat_extract_output_lengths(fam.sum(-1))
    assert int(out_len) == 2
    ids8 = torch.from_numpy(_ids(1, seed=7))
    with torch.no_grad(), pytest.raises(ValueError, match='do not match'):
        hf(input_ids=ids8, input_features=mel, feature_attention_mask=fam)
    ids2 = torch.cat([ids8[:, :2], ids8[:, 2:4], ids8[:, 2 + TOKENS:]], 1)
    with torch.no_grad():
        theirs = hf(input_ids=ids2, input_features=mel,
                    feature_attention_mask=fam).logits
    ours = ta.forward(params, cfg, ids8,
                      audio_values=torch.from_numpy(w)).logits
    # the text after the audio: the same tokens, other logits
    gap = (ours[0, 2 + TOKENS:] - theirs[0, 4:]).abs().max()
    assert float(gap) > 1e-3


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------

ROW = {'question': 'what is it', 'response': 'a bell',
       'response_1': 'a bell', 'response_2': 'a drum',
       'overall_response': 2, 'audio': 'x.wav', 'text': 'hello there',
       'caption': 'rain on a roof', 'audiocap_path': 'r.wav'}


@pytest.mark.parametrize('name,method', [
    ('AA_TA2T', 'format_supervised_sample'),
    ('AA_TA2T', 'format_prompt_only_sample'),
    ('AA_TA2T', 'format_preference_sample'),
    ('LibriSpeech', 'format_supervised_sample'),
    ('AudioCaps', 'format_supervised_sample'),
    ('AudioCaps', 'format_diffusion_supervised_sample'),
    ('AudioSet', 'format_supervised_sample'),
])
def test_audio_templates_match_jax(name, method):
    mine, theirs = getattr(tfmt, name)(), getattr(jfmt, name)()
    assert getattr(mine, method)(dict(ROW)) == getattr(theirs, method)(
        dict(ROW))


def write_wav(path, samples: np.ndarray, rate=16000):
    """16-bit mono PCM through the standard library."""
    pcm = np.clip(samples * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(str(path), 'wb') as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())
