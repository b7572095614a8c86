"""The port's text-audio-to-text data and trainers
(``align_anything_tpu_torch/data/audio.py``,
``align_anything_tpu_torch/trainers/text_audio_to_text/{sft,dpo,rm,ppo,
grpo}.py``) against the JAX package's, on the CPU, driven the same way:
configs parsed from the same command-line overrides, 8x the per-device
batch in the port (JAX runs 8 CPU devices).

Assets: a tiny Qwen2-Audio checkpoint saved by transformers (a one-layer
tower 32 wide over 32 mel bins, ``max_frames`` 32: 8 audio tokens; a
one-layer Qwen2 trunk), a one-layer Qwen2 text checkpoint for the
fresh-encoder path (JAX's own test sizes, ``tests/test_mm_rl_smoke.py``),
and AA_TA2T rows over clips of 800-6000 samples, as ``.npy`` and as 16-bit
wav files, padded to ``waveform_len`` 5120 (32 frames).

Tolerances: datasets and batches exactly; metrics and leaves to 1e-5
(rtol and atol), as ``tests/test_torch_tv2t_trainers.py``; the frozen
tower bit-equal.  The RL rollouts are fixed to one numpy block in both
packages, with one CPU thread for round 1's exact KL.  Fresh score heads
and fresh encoders come from each package's own generator: JAX's are
copied into the port before its first step.

R1: the JAX SFT trainer needs ``AudioLMConfig.pp_stages`` patched to 1.
R13: PPO and GRPO freeze nothing, in both packages, and the port says so.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
pytest.importorskip('yaml')

from align_anything_tpu.data import audio as jdata  # noqa: E402
from align_anything_tpu.models import audio as jaudio  # noqa: E402
from align_anything_tpu_torch.data import audio as tdata  # noqa: E402
from align_anything_tpu_torch.data.chat_template import ChatTemplate  # noqa: E402
from align_anything_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from align_anything_tpu_torch.models.hf_loader import (  # noqa: E402
    load_audio_params,
)
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_audio_to_text import (  # noqa: E402
    dpo as tdpo,
    grpo as tgrpo,
    ppo as tppo,
    rm as trm,
    sft as tsft,
)
from test_torch_audio import hf_audio_config, perturb_hf, write_wav  # noqa: E402
from test_torch_llava_next_video import _equal  # noqa: E402
from test_torch_rl_trainers import (  # noqa: E402,F401  (a fixture)
    NEW_TOKENS,
    _block,
    _both,
    _compare,
    _compare_trees,
    _leaves,
    one_thread,
)
from test_torch_ti2t_rm_ppo import snapshot  # noqa: E402

AUDIO_TOKEN = 120
TOKENS = 8
WAVE_LEN = 5120
HIDDEN = 32
PAD = 0


def module_moved(params, start) -> dict:
    """module -> whether any of its leaves differs from ``start``."""
    now = _leaves(params)
    return {m: any(not np.array_equal(v, start[p]) for p, v in now.items()
                   if p.startswith(f'/{m}/'))
            for m in ('language_model', 'audio_tower', 'projector')}


def make_ta2t_assets(d, rows: int = 16):
    """``d / 'model'`` the Qwen2-Audio checkpoint, ``d / 'text'`` a Qwen2
    text checkpoint, ``d / 'rows.jsonl'`` AA_TA2T rows (supervised,
    preference and prompt fields) over ``.npy`` and ``.wav`` clips."""
    torch.manual_seed(0)
    perturb_hf(transformers.Qwen2AudioForConditionalGeneration(
        hf_audio_config(text_layers=1, tie=False)).eval()).save_pretrained(
        d / 'model', safe_serialization=True)
    transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=128, hidden_size=HIDDEN, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, tie_word_embeddings=True)
    ).eval().save_pretrained(d / 'text', safe_serialization=True)
    rng = np.random.default_rng(0)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps', 'zeta']

    def pick(k):
        return ' '.join(words[j] for j in rng.integers(0, 6, size=k))

    with open(d / 'rows.jsonl', 'w') as f:
        for i in range(rows):
            clip = (rng.standard_normal(int(rng.integers(800, 6000)))
                    * 0.2).astype(np.float32)
            if i % 2:
                path = d / f'a{i}.wav'
                write_wav(path, clip)
            else:
                path = d / f'a{i}.npy'
                np.save(path, clip)
            f.write(json.dumps({
                'question': f'what {pick(int(rng.integers(1, 9)))} {i}',
                'response': pick(int(rng.integers(1, 8))),
                'response_1': pick(int(rng.integers(1, 8))),
                'response_2': pick(int(rng.integers(1, 8))),
                'overall_response': int(rng.integers(1, 3)),
                'audio': str(path)}) + '\n')
    return d


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return make_ta2t_assets(tmp_path_factory.mktemp('ta2t_assets'))


def _argv(assets, out, model='model', extra=()):
    return ['--model_name_or_path', str(assets / model),
            '--train_datasets', str(assets / 'rows.jsonl'),
            '--train_template', 'AA_TA2T', '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[64]', '--save_checkpoint', 'False',
            '--waveform_len', str(WAVE_LEN),
            '--per_device_train_batch_size', '1', *extra]


# the fresh encoder's flags: JAX's test sizes (tests/test_mm_rl_smoke.py)
FRESH = ('--audio_max_frames', '32', '--n_mels', '32',
         '--audio_hidden_size', '32', '--audio_layers', '1',
         '--audio_heads', '2', '--audio_mlp_dim', '64',
         '--audio_token_id', str(AUDIO_TOKEN))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['array', 'list', 'dict', 'npy', 'wav',
                                  'stereo'])
def test_load_waveform_matches_jax(tmp_path, kind):
    """Every input type, padded and cut (JAX's ``load_waveform``)."""
    clip = np.random.default_rng(3).uniform(-0.9, 0.9, 1000).astype(
        np.float32)
    audio = {'array': clip, 'list': clip.tolist(),
             'dict': {'array': clip, 'sampling_rate': 16000},
             'stereo': np.stack([clip, -clip * 0.5], -1)}.get(kind, clip)
    if kind in ('npy', 'wav'):
        audio = str(tmp_path / f'c.{kind}')
        np.save(audio, clip) if kind == 'npy' else write_wav(audio, clip)
    for target in (600, 1600):
        got = tdata.load_waveform(audio, target)
        want = jdata.load_waveform(audio, target)
        assert got.dtype == np.float32 and got.shape == (target,)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError):
        tdata.load_waveform(3, 10)


def _datasets(assets, kind):
    from align_anything_tpu.data.chat_template import ChatTemplate as JChat
    from align_anything_tpu.data.tokenizer import HashTokenizer as JTok
    from align_anything_tpu.trainers.text_audio_to_text.ppo import (
        TA2TPromptOnlyDataset as JPrompt,
    )

    classes = {'sft': (tdata.TA2TSupervisedDataset,
                       jdata.TA2TSupervisedDataset),
               'pref': (tdata.TA2TPreferenceDataset,
                        jdata.TA2TPreferenceDataset),
               'prompt': (tdata.TA2TPromptOnlyDataset, JPrompt)}[kind]
    out = []
    for cls, tok_cls, chat in zip(classes, (HashTokenizer, JTok),
                                  (ChatTemplate, JChat)):
        tok = tok_cls(vocab_size=128)
        out.append(cls(str(assets / 'rows.jsonl'), chat(tok, 'AA_TA2T'), tok,
                       audio_token_id=AUDIO_TOKEN, num_audio_tokens=TOKENS,
                       waveform_len=WAVE_LEN, max_length=64))
    return out


@pytest.mark.parametrize('kind', ['sft', 'pref', 'prompt'])
def test_ta2t_datasets_match_jax(assets, kind):
    """Each row and the collated batch equal JAX's: <audio> expanded to 8
    audio tokens (never labelled), the clips padded to ``waveform_len``
    ([better; worse] for pairs), the prompt set's clips in ``meta``."""
    ours, theirs = _datasets(assets, kind)
    assert len(ours) == len(theirs) == 16
    samples = [ours[i] for i in range(len(ours))]
    jsamples = [theirs[i] for i in range(len(theirs))]
    for a, b in zip(samples, jsamples):
        _equal(a, b)
    got = ours.get_collator(buckets=(64, 96))(samples)
    want = theirs.get_collator(buckets=(64, 96))(jsamples)
    _equal(got, want)
    if kind == 'sft':
        assert (got['labels'][got['input_ids'] == AUDIO_TOKEN] == -100).all()
        assert got['audio_values'].shape == (16, WAVE_LEN)
    elif kind == 'pref':
        assert got['audio_values'].shape == (32, WAVE_LEN)
        np.testing.assert_array_equal(got['audio_values'][:16],
                                      got['audio_values'][16:])
    else:
        assert got['meta'][0]['audio_values'].shape == (WAVE_LEN,)


def test_collators_without_audio_match_jax():
    """Rows without a clip: no ``audio_values`` unless some row has one,
    then zeros in its place."""
    rows = [{'input_ids': [5, 6, 7], 'labels': [-100, 6, 7], 'prompt_len': 1,
             'audio_values': None},
            {'input_ids': [5, 6], 'labels': [-100, 6], 'prompt_len': 1,
             'audio_values': np.ones(4, np.float32)}]
    for sel in (rows[:1], rows):
        _equal(tdata.TA2TSupervisedCollator(0, (8,))(sel),
               jdata.TA2TSupervisedCollator(0, (8,))(sel))
    pairs = [{'better_input_ids': [5, 6, 7], 'worse_input_ids': [5, 8],
              'better_prompt_len': 1, 'worse_prompt_len': 1,
              'audio_values': w} for w in (None, np.ones(4, np.float32))]
    for sel in (pairs[:1], pairs):
        _equal(tdata.TA2TPreferenceCollator(0, (8,))(sel),
               jdata.TA2TPreferenceCollator(0, (8,))(sel))


# ---------------------------------------------------------------------------
# SFT, DPO, RM
# ---------------------------------------------------------------------------

def _jax_trainer_cls(algo):
    from align_anything_tpu.trainers.text_audio_to_text import (
        dpo,
        grpo,
        ppo,
        rm,
        sft,
    )

    return {'sft': sft.TA2TSupervisedTrainer, 'dpo': dpo.TA2TDPOTrainer,
            'rm': rm.TA2TRMTrainer, 'ppo': ppo.TA2TPPOTrainer,
            'grpo': grpo.TA2TGRPOTrainer}[algo]


PORT = {'sft': tsft.TA2TSupervisedTrainer, 'dpo': tdpo.TA2TDPOTrainer,
        'rm': trm.TA2TRMTrainer, 'ppo': tppo.TA2TPPOTrainer,
        'grpo': tgrpo.TA2TGRPOTrainer}


def _copy_into(port_tree, jax_tree):
    """The JAX tree's values into the port's leaves, in place."""
    with torch.no_grad():
        for path, leaf in _leaves(jax_tree).items():
            node = port_tree
            for k in path.strip('/').split('/'):
                node = node[k]
            node.copy_(torch.from_numpy(np.array(leaf)))


@pytest.mark.parametrize('algo,model', [
    ('sft', 'model'), ('dpo', 'model'), ('rm', 'model'), ('sft', 'text')])
def test_ta2t_steps_match_jax(assets, tmp_path, monkeypatch, algo, model):
    """Two steps of 8 rows (pairs) against JAX's: the batches, every
    metric and every leaf.  The tower (frozen by the YAMLs'
    ``freeze_audio_tower``) stays bit-equal; the projector and trunk move.
    ``text``: the fresh-encoder path over a text checkpoint (JAX's initial
    tree copied into the port)."""
    monkeypatch.setattr(jaudio.AudioLMConfig, 'pp_stages', 1, raising=False)
    task = f'text_audio_to_text/{algo}'
    extra = FRESH if model == 'text' else ()
    jtrainer, trainer = _both(_jax_trainer_cls(algo), PORT[algo], task,
                              _argv(assets, tmp_path, model, extra),
                              ('per_device_train_batch_size',))
    if model == 'text':
        assert trainer.model_cfg.audio.num_audio_tokens == TOKENS
        assert trainer.model_cfg.audio_token_id == AUDIO_TOKEN
        assert trainer.model_cfg.text.remat == jtrainer.model_cfg.text.remat
    if algo == 'rm' or model == 'text':
        _copy_into(trainer.state.params, jtrainer.state.params)
    batches = list(trainer.train_iterator.epoch_batches(0))[:2]
    jbatches = list(jtrainer.train_iterator.epoch_batches(0))[:2]
    for b, jb in zip(batches, jbatches):
        _equal(b, jb)
    per_row = (batches[0]['input_ids'] == AUDIO_TOKEN).sum(-1)
    assert (per_row >= TOKENS).all()
    start = snapshot(trainer.state.params)
    got = [trainer.train_step(b) for b in batches]
    want = [{k: float(v) for k, v in jtrainer.train_step(b).items()}
            for b in jbatches]
    _compare(got, want)
    _compare_trees(trainer.state.params, jtrainer.state.params)
    moved = module_moved(trainer.state.params, start)
    assert not moved['audio_tower']
    assert moved['projector'] and moved['language_model']


def test_ta2t_dpo_step1_loss_is_ln2_and_reference_shares_tower(
        assets, tmp_path):
    """The reference starts as the policy: step 1's loss is ln 2; it holds
    the policy's frozen tower tensors and its own copies of the rest."""
    cfgs, pc = tcli.parse_cfgs('text_audio_to_text/dpo',
                               _argv(assets, tmp_path))
    trainer = tdpo.TA2TDPOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    ref, params = trainer.ref_params, trainer.state.params
    assert ref['audio_tower']['conv1']['w'] is not params['audio_tower'][
        'conv1']['w']
    assert ref['audio_tower']['conv1']['w'].data_ptr() == params[
        'audio_tower']['conv1']['w'].data_ptr()
    assert ref['projector']['w'].data_ptr() != params['projector'][
        'w'].data_ptr()
    m = trainer.train_step(next(trainer.train_iterator.epoch_batches(0)))
    assert m['train/loss'] == pytest.approx(np.log(2), abs=1e-6)


def test_ta2t_sft_export_reads_back(assets, tmp_path, monkeypatch):
    """``trainer_main`` (the entry point's path) trains an epoch and saves:
    the slice reads back through the port's and JAX's ``load_audio_params``
    equal to the trained state; DPO and RM save the train state alone."""
    from align_anything_tpu.models.hf_loader import (
        load_audio_params as jload,
    )

    argv = _argv(assets, tmp_path / 'sft', extra=('--save_checkpoint',
                                                  'True', '--train_size',
                                                  '2'))
    trainer = tcli.trainer_main(tsft.TA2TSupervisedTrainer,
                                'text_audio_to_text/sft', argv, device='cpu')
    path = tmp_path / 'sft' / f'slice_{trainer.global_step}'
    back, cfg = load_audio_params(str(path), device='cpu')
    jback, _ = jload(str(path))
    assert cfg.audio == trainer.model_cfg.audio
    want = _leaves(trainer.state.params)
    for p, leaf in _leaves(back).items():
        np.testing.assert_array_equal(leaf, want[p], err_msg=p)
        np.testing.assert_array_equal(leaf, _leaves(jback)[p], err_msg=p)
    assert (tmp_path / 'sft' / 'checkpoints').is_dir()
    argv = _argv(assets, tmp_path / 'rm', extra=('--save_checkpoint', 'True',
                                                 '--train_size', '2'))
    tcli.trainer_main(trm.TA2TRMTrainer, 'text_audio_to_text/rm', argv,
                      device='cpu')
    assert (tmp_path / 'rm' / 'checkpoints').is_dir()
    assert not list((tmp_path / 'rm').glob('slice_*'))


# ---------------------------------------------------------------------------
# PPO and GRPO
# ---------------------------------------------------------------------------

def fix_rollouts(monkeypatch):
    """Both packages' TA2T ``generate`` (PPO's and GRPO's) return one numpy
    block; the completions draw no audio token; the prefill got the clips
    through ``media``."""
    import jax.numpy as jnp
    from align_anything_tpu.trainers.text_audio_to_text import (
        grpo as jgrpo,
        ppo as jppo,
    )

    def block(input_ids, attention_mask):
        ids, mask, comp = _block(input_ids, attention_mask, 100, PAD)
        return {'sequences': ids, 'attention_mask': mask,
                'completions': comp,
                'completion_mask': (comp != PAD).astype(np.int64)}

    def jax_generate(params, model_cfg, gen_cfg, input_ids, attention_mask,
                     *args, **kwargs):
        assert kwargs['media']['audio_values'].shape == (input_ids.shape[0],
                                                         WAVE_LEN)
        assert kwargs['prefill_forward'] is jaudio.forward
        return {k: jnp.asarray(v, jnp.int32) for k, v in block(
            np.asarray(input_ids), np.asarray(attention_mask)).items()}

    def torch_generate(params, model_cfg, gen_cfg, input_ids, attention_mask,
                       *args, **kwargs):
        assert tuple(kwargs['media']['audio_values'].shape) == (
            input_ids.shape[0], WAVE_LEN)
        assert kwargs['prefill_forward'] is tppo.audio.forward
        return {k: torch.as_tensor(v, device=input_ids.device)
                for k, v in block(input_ids.cpu().numpy(),
                                  attention_mask.cpu().numpy()).items()}

    for module, fn in ((jppo, jax_generate), (jgrpo, jax_generate),
                       (tppo, torch_generate)):
        monkeypatch.setattr(module, 'generate', fn)


def _rl_argv(assets, out, extra=()):
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / 'rows.jsonl'),
            '--train_template', 'AA_TA2T', '--output_dir', str(out),
            '--epochs', '1', '--max_new_tokens', str(NEW_TOKENS),
            '--bf16', 'False', '--save_checkpoint', 'False',
            '--waveform_len', str(WAVE_LEN), '--padding_buckets', '[64]',
            '--per_device_prompt_batch_size', '1', *extra]


def _same_heads(jtrainer, trainer, names):
    for name in names:
        jtree, tree = getattr(jtrainer, name), getattr(trainer, name)
        jtree = getattr(jtree, 'params', jtree)
        tree = getattr(tree, 'params', tree)
        with torch.no_grad():
            tree['score_head']['w'].copy_(torch.from_numpy(np.array(
                jtree['score_head']['w'])))


def test_ta2t_ppo_round_matches_jax(assets, tmp_path, monkeypatch,
                                    one_thread, capsys):
    """One TA2T PPO round (8 audio prompts, micro-batches of 8) against
    JAX's on the same sequences: the clips through the prefill, the
    scoring and the updates; every metric; the actor and critic after the
    round; round 1's KL exactly 0; the towers train (R13, said at
    start-up)."""
    fix_rollouts(monkeypatch)
    argv = _rl_argv(assets, tmp_path, (
        '--actor_lr', '1e-4', '--critic_lr', '1e-4',
        '--per_device_train_batch_size', '1'))
    jtrainer, trainer = _both(
        _jax_trainer_cls('ppo'), tppo.TA2TPPOTrainer,
        'text_audio_to_text/ppo', argv,
        ('per_device_prompt_batch_size', 'per_device_train_batch_size'))
    assert 'R13' in capsys.readouterr().out
    _same_heads(jtrainer, trainer, ('reward_params', 'critic_state'))
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    _equal(batch, jbatch)
    start = snapshot(trainer.actor_state.params)
    got = trainer.train_step(batch)
    want = {k: float(v) for k, v in jtrainer.train_step(jbatch).items()}
    assert got['train/kl_divergence'] == 0.0
    _compare([got], [want])
    for name in ('actor_state', 'critic_state'):
        _compare_trees(getattr(trainer, name).params,
                       getattr(jtrainer, name).params)
    assert module_moved(trainer.actor_state.params, start)['audio_tower']


def test_ta2t_grpo_round_matches_jax(assets, tmp_path, monkeypatch,
                                     one_thread):
    """One TA2T GRPO round (8 audio prompts x 4 generations: the task
    ``text_audio_to_text/ppo`` has no ``num_generations``, and a
    command-line override adds no key, R9) against JAX's on the same
    sequences; the rewards compared, not JAX's sign counts."""
    fix_rollouts(monkeypatch)
    argv = _rl_argv(assets, tmp_path, ('--learning_rate', '1e-4',
                                       '--num_generations', '2'))
    jtrainer, trainer = _both(
        _jax_trainer_cls('grpo'), tgrpo.TA2TGRPOTrainer,
        'text_audio_to_text/ppo', argv, ('per_device_prompt_batch_size',))
    assert trainer.num_generations == jtrainer.num_generations == 4
    _same_heads(jtrainer, trainer, ('reward_params',))
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    _equal(batch, jbatch)
    got = trainer.train_step(batch)
    want = {k: float(v) for k, v in jtrainer.train_step(jbatch).items()}
    assert got['train/kl'] == 0.0
    _compare([got], [want])
    _compare_trees(trainer.actor_state.params, jtrainer.actor_state.params)
