"""The port's LoRA and QLoRA (``align_anything_tpu_torch/models/lora.py``,
``models/transformer.py`` ``_wmm``, ``trainers/base.py`` ``init_peft`` and
the trainers that use it) against the JAX package, on the same numpy
weights, adapters and inputs (``models/bridge.py``), in float32 on the CPU.

The trainer tests build both packages' trainers from the same command-line
overrides over the tiny Llama checkpoint of ``tests/test_torch_rl_trainers.py``
(one layer: the JAX trainers compile each step), give the port's adapters
the JAX trainer's A (each package draws its own; B starts at 0 in both) and
compare every step's metrics and the adapters after them.  The JAX trainers
multiply per-device batch sizes by its 8 CPU devices; the port's runs take
8x them (``_both``).

Tolerances: forwards to 1e-4 x max|logit| (the same math summed in another
order); LoRA's dense fallback to 1e-6; adapter gradients to 1e-4 x max|g|;
trainer metrics and adapters to 1e-5 (rtol and atol), as the other trainer
parity tests (learning rates of 1e-4 make each Adam update 10x that);
step 1's DPO loss ln 2 to 1e-6 and PPO's round-1 KL exactly 0 (policy and
reference are the same base through the same ops, B = 0 adds exact zeros;
one CPU thread).  The merged export reads back equal to ``merge_lora`` of
the trained adapters (0 difference: both are the same fp32 sums).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
pytest.importorskip('yaml')

from align_anything_tpu_torch.generation import GenerationConfig  # noqa: E402
from align_anything_tpu_torch.generation import engine as tengine  # noqa: E402
from align_anything_tpu_torch.generation.continuous import (  # noqa: E402
    ContinuousBatchingEngine,
)
from align_anything_tpu_torch.models import lora as tlora  # noqa: E402
from align_anything_tpu_torch.models import quantization as tq  # noqa: E402
from align_anything_tpu_torch.models import transformer as tt  # noqa: E402
from align_anything_tpu_torch.models.bridge import (  # noqa: E402
    from_jax_tree,
    lora_from_jax_tree,
)
from align_anything_tpu_torch.models.hf_loader import load_params  # noqa: E402
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_to_text import (  # noqa: E402
    cost_model as tcost,
    dpo as tdpo,
    grpo as tgrpo,
    kto as tkto,
    multi_ppo as tmulti,
    orpo as torpo,
    ppo as tppo,
    ppo_remote_rm as tremote,
    ppo_vllm as tvllm,
    rm as trm,
    saferlhf as tsafe,
    simpo as tsimpo,
    sft as tsft,
)

from test_torch_quantization_int8 import (  # noqa: E402
    cfgs,
    jax_params,
    jx,  # noqa: F401 (fixture)
    np_tree,
)
from test_torch_rl_trainers import (  # noqa: E402
    PPO_SCALED,
    _both,
    _compare,
    _estimator_env,
    _fix_rollouts,
    _leaves,
    _ppo_argv,
    _rm_argv,
    _scaled,
    make_assets,
    one_thread,  # noqa: F401 (fixture)
)

TOL = 1e-5
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj', 'up_proj', 'gate_proj',
           'down_proj')
MODES = {'lora': ('--use_lora', 'True'),
         'qlora4': ('--use_lora', 'True', '--use_bnb', 'True',
                    '--load_in_4bit', 'True'),
         'qlora8': ('--use_lora', 'True', '--use_bnb', 'True')}


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp('lora_assets')
    make_assets(d, layers=1)
    return d


# ---------------------------------------------------------------------------
# models/lora.py and the decoder
# ---------------------------------------------------------------------------

def test_init_lora_params_shapes_match_jax(jx):
    """Every target module's (A, B) shapes as JAX's; B = 0, A ~ N(0, 1/r)."""
    jcfg, tcfg = cfgs(jx)
    want = jx.lora.init_lora_params(jcfg, jx.jax.random.PRNGKey(0), r=8,
                                    target_modules=TARGETS)
    got = tlora.init_lora_params(tcfg, torch.Generator().manual_seed(0),
                                 r=8, target_modules=TARGETS, device='cpu')
    assert list(got) == list(TARGETS)
    for m in TARGETS:
        for k in ('a', 'b'):
            assert tuple(got[m][k].shape) == want[m][k].shape, (m, k)
            assert got[m][k].dtype == torch.float32
        assert not got[m]['b'].any()
    a = torch.cat([got[m]['a'].reshape(-1) for m in TARGETS])
    assert abs(float(a.std()) * math.sqrt(8) - 1) < 0.05


def _adapters(jx, jcfg, seed=1, r=4):
    """JAX adapters on four targets with a nonzero B, so the delta shows."""
    lp = jx.lora.init_lora_params(
        jcfg, jx.jax.random.PRNGKey(seed), r=r,
        target_modules=('q_proj', 'v_proj', 'o_proj', 'down_proj'))
    rng = np.random.default_rng(seed)
    return jx.jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        lp)


def _base(jx, jcfg, kind):
    jp = jax_params(jx, jcfg)
    if kind == 'int4':
        return jx.q.quantize_decoder_int4(jp)
    if kind == 'int8':
        return jx.q.quantize_decoder_int8(jp)
    return jp


@pytest.mark.parametrize('kind', ['fp', 'int4', 'int8'])
def test_attach_matches_merge_and_jax(jx, kind):
    """The activation-level path (``attach_lora``) against the merged dense
    weights (``merge_lora``), both in the port, and against JAX's attached
    forward on the same base and adapters."""
    jcfg, tcfg = cfgs(jx)
    jbase, jlp = _base(jx, jcfg, kind), _adapters(jx, jcfg)
    base = from_jax_tree(np_tree(jbase), device='cpu')
    lp = from_jax_tree(np_tree(jlp), device='cpu')
    ids = np.random.default_rng(0).integers(3, 128, size=(2, 10))
    want = np.asarray(jx.t.forward(
        jx.lora.attach_lora(jbase, jlp, jcfg, r=4, alpha=8.0), jcfg,
        jx.jnp.asarray(ids)).logits)
    attached = tt.forward(tlora.attach_lora(base, lp, tcfg, r=4, alpha=8.0),
                          tcfg, torch.from_numpy(ids)).logits.numpy()
    merged = tt.forward(tlora.merge_lora(base, lp, tcfg, r=4, alpha=8.0),
                        tcfg, torch.from_numpy(ids)).logits.numpy()
    tol = 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(attached, want, rtol=0, atol=tol)
    np.testing.assert_allclose(attached, merged, rtol=0, atol=tol)
    # the merge leaves every non-target leaf as the base's own
    m = tlora.merge_lora(base, lp, tcfg, r=4, alpha=8.0)
    assert m['layers']['k']['w'] is base['layers']['k']['w']


@pytest.mark.parametrize('kind', ['fp', 'int4'])
def test_lora_weight_dequantize_matches_jax(jx, kind):
    """``LoraWeight.dequantize`` (the dense fallback) against JAX's
    ``astype``: a layer-sliced fp base, and a stacked int4 base, which
    dequantizes layer by layer."""
    rng = np.random.default_rng(0)
    if kind == 'fp':
        base = rng.standard_normal((6, 2, 3)).astype(np.float32)
        a = rng.standard_normal((6, 2)).astype(np.float32)
        b = rng.standard_normal((2, 6)).astype(np.float32)
        jbase = jx.jnp.asarray(base)
    else:
        w = rng.standard_normal((2, 64, 2, 3)).astype(np.float32)
        jbase = jx.q.quantize_int4(jx.jnp.asarray(w), (1,), group_size=32)
        a = rng.standard_normal((2, 64, 2)).astype(np.float32)
        b = rng.standard_normal((2, 2, 6)).astype(np.float32)
    jw = jx.lora.LoraWeight(base=jbase, a=jx.jnp.asarray(a),
                            b=jx.jnp.asarray(b), scaling=0.5)
    tw = from_jax_tree(np_tree(jw), device='cpu')
    assert isinstance(tw, tlora.LoraWeight) and tw.scaling == 0.5
    np.testing.assert_allclose(tw.dequantize(torch.float32).numpy(),
                               np.asarray(jw.astype(jx.jnp.float32)),
                               rtol=1e-6, atol=1e-6)


def test_grads_reach_the_adapters_only(jx):
    """Over an int4 base: the adapters' gradients equal JAX's
    ``jax.grad`` over the adapter tree, B's live path is nonzero, and no
    base tensor requires or receives a gradient."""
    jcfg, tcfg = cfgs(jx)
    jbase = jx.q.quantize_decoder_int4(jax_params(jx, jcfg))
    jlp = jx.lora.init_lora_params(jcfg, jx.jax.random.PRNGKey(1), r=4)
    ids = np.random.default_rng(0).integers(3, 128, size=(2, 8))

    def jloss(lp, bp):
        policy = jx.lora.attach_lora(bp, lp, jcfg, r=4, alpha=8.0)
        return jx.t.forward(policy, jcfg, jx.jnp.asarray(ids)).logits.mean()

    want = jx.jax.jit(jx.jax.grad(jloss))(jlp, jbase)
    base = from_jax_tree(np_tree(jbase), device='cpu')
    lp = lora_from_jax_tree(np_tree(jlp), device='cpu')
    policy = tlora.attach_lora(base, lp, tcfg, r=4, alpha=8.0)
    tt.forward(policy, tcfg, torch.from_numpy(ids)).logits.mean().backward()
    for m in ('q_proj', 'v_proj'):
        for k in ('a', 'b'):
            w = np.asarray(want[m][k])
            np.testing.assert_allclose(lp[m][k].grad.numpy(), w, rtol=0,
                                       atol=1e-4 * max(np.abs(w).max(), 1e-12))
        assert float(lp[m]['b'].grad.abs().sum()) > 0
    for t in tq.weight_tensors(base['layers']['q']['w']) + [base['embedding']]:
        assert not t.requires_grad and t.grad is None


@pytest.mark.parametrize('backend', ['batch', 'continuous'])
def test_generation_takes_lora_leaves(jx, backend):
    """Both rollout backends decode through ``LoraWeight`` leaves over an
    int4 base (with the int4 head) and give the tokens of the merged dense
    model, greedily."""
    jcfg, tcfg = cfgs(jx)
    base = from_jax_tree(np_tree(_base(jx, jcfg, 'int4')), device='cpu')
    lp = from_jax_tree(np_tree(_adapters(jx, jcfg)), device='cpu')
    attached = tlora.attach_lora(base, lp, tcfg, r=4, alpha=8.0)
    merged = tq.dequantize_decoder(tlora.merge_lora(base, lp, tcfg, r=4,
                                                    alpha=8.0))
    gen = GenerationConfig(max_new_tokens=5, greedy=True, eos_token_id=-1)
    prompts = [[5, 9, 17, 33], [7, 8]]
    if backend == 'batch':
        ids = torch.tensor([[5, 9, 17, 33], [0, 0, 7, 8]])
        mask = (ids != 0).long()
        out = [tengine.generate(p, tcfg, gen, ids, mask)['completions']
               for p in (attached, merged)]
        assert torch.equal(out[0], out[1])
    else:
        eng = ContinuousBatchingEngine(tcfg, num_slots=2, max_len=32)
        out = [eng.generate(p, prompts, gen) for p in (attached, merged)]
        assert out[0] == out[1] and all(len(r) == 5 for r in out[0])


# ---------------------------------------------------------------------------
# the trainers against JAX
# ---------------------------------------------------------------------------

def _copy_adapters(adapters, jadapters):
    """The JAX trainer's adapters into the port's train state, in place."""
    with torch.no_grad():
        for m, pair in adapters.items():
            for k, t in pair.items():
                t.copy_(torch.from_numpy(np.array(jadapters[m][k])))


def _steps(trainer, n):
    batches = list(trainer.train_iterator.epoch_batches(0))[:n]
    return [{k: float(v) for k, v in trainer.train_step(b).items()}
            for b in batches]


def _compare_adapters(got, want, tol=TOL):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=tol, atol=tol,
                                   err_msg=p)


def _sft_argv(assets, out, extra=()):
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / 'sft.jsonl'),
            '--train_template', 'Alpaca', '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[32]', '--save_checkpoint', 'False',
            '--per_device_train_batch_size', '1', *extra]


def _base_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _base_tensors(v)]
    return tq.weight_tensors(tree)


def _assert_base_unchanged(trainer, before):
    after = _base_tensors(trainer.base_params)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert not any(t.requires_grad for t in after)


@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('algo', ['sft', 'dpo'])
def test_lora_trainer_steps_match_jax(assets, tmp_path, one_thread, algo,
                                      mode):
    """SFT and DPO with LoRA and with QLoRA on int4 and int8 bases: three
    steps' metrics and the adapters against the JAX trainer's; the base
    does not move; DPO's step 1 is ln 2 (the reference is the base)."""
    from align_anything_tpu.trainers.text_to_text.dpo import DPOTrainer
    from align_anything_tpu.trainers.text_to_text.sft import (
        SupervisedTrainer,
    )

    if algo == 'sft':
        argv = _sft_argv(assets, tmp_path, MODES[mode])
        classes = (SupervisedTrainer, tsft.SupervisedTrainer)
    else:
        argv = _rm_argv(assets, tmp_path, MODES[mode])
        classes = (DPOTrainer, tdpo.DPOTrainer)
    jtrainer, trainer = _both(*classes, f'text_to_text/{algo}', argv,
                              ('per_device_train_batch_size',))
    assert set(trainer.state.params) == {'q_proj', 'v_proj'}
    kind = {'lora': torch.Tensor, 'qlora4': tq.Int4Weight,
            'qlora8': tq.Int8Weight}[mode]
    assert isinstance(trainer.base_params['layers']['q']['w'], kind)
    assert isinstance(trainer.base_params['lm_head'], kind)
    _copy_adapters(trainer.state.params, jtrainer.state.params)
    before = [t.clone() for t in _base_tensors(trainer.base_params)]
    want, got = _steps(jtrainer, 3), _steps(trainer, 3)
    _compare(got, want)
    _compare_adapters(trainer.state.params, jtrainer.state.params)
    _assert_base_unchanged(trainer, before)
    if algo == 'dpo':
        assert abs(got[0]['train/loss'] - math.log(2)) < 1e-6
        assert trainer.ref_params is trainer.base_params
    assert float(trainer.state.params['q_proj']['b'].detach().abs().sum()) > 0


@pytest.mark.parametrize('mode', list(MODES))
def test_lora_rm_steps_match_jax(assets, tmp_path, mode):
    """The reward model: the train state is {'lora', 'score_head'}; three
    steps against JAX's; the head and the adapters move, the trunk not."""
    from align_anything_tpu.trainers.text_to_text.rm import RMTrainer

    jtrainer, trainer = _both(RMTrainer, trm.RMTrainer, 'text_to_text/rm',
                              _rm_argv(assets, tmp_path, MODES[mode]),
                              ('per_device_train_batch_size',))
    assert set(trainer.state.params) == {'lora', 'score_head'}
    _copy_adapters(trainer.state.params['lora'],
                   jtrainer.state.params['lora'])
    with torch.no_grad():
        trainer.state.params['score_head']['w'].copy_(torch.from_numpy(
            np.array(jtrainer.state.params['score_head']['w'])))
    head0 = trainer.state.params['score_head']['w'].detach().clone()
    before = [t.clone() for t in _base_tensors(trainer.base_params)]
    want, got = _steps(jtrainer, 3), _steps(trainer, 3)
    _compare(got, want)
    _compare_adapters(trainer.state.params, jtrainer.state.params)
    _assert_base_unchanged(trainer, before)
    assert not torch.equal(trainer.state.params['score_head']['w'], head0)


@pytest.mark.parametrize('mode', list(MODES))
def test_lora_ppo_round_matches_jax(assets, tmp_path, monkeypatch,
                                    one_thread, mode):
    """One PPO round (16 prompts, 2 micro-batches) with the adapters on the
    actor: metrics and adapters against JAX's, round 1's KL exactly 0 (the
    reference is the base), the critic full and trained."""
    from align_anything_tpu.trainers.text_to_text.ppo import PPOTrainer

    _fix_rollouts(monkeypatch)
    jtrainer, trainer = _both(PPOTrainer, tppo.PPOTrainer, 'text_to_text/ppo',
                              _ppo_argv(assets, tmp_path, extra=MODES[mode]),
                              PPO_SCALED)
    assert set(trainer.actor_state.params) == {'q_proj', 'v_proj'}
    assert trainer.ref_params is trainer.base_params
    assert 'embedding' in trainer.critic_state.params
    _copy_adapters(trainer.actor_state.params, jtrainer.actor_state.params)
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    got = trainer.train_step(batch)
    want = {k: float(v) for k, v in jtrainer.train_step(jbatch).items()}
    assert got['train/kl_divergence'] == 0.0
    _compare([got], [want])
    _compare_adapters(trainer.actor_state.params, jtrainer.actor_state.params)


@pytest.mark.parametrize('algo', ['orpo', 'simpo', 'kto', 'cost_model'])
def test_lora_inheriting_trainers_match_jax(assets, tmp_path, one_thread,
                                            algo):
    """ORPO, SimPO, KTO and the cost model take LoRA through the DPO and RM
    trainers, in both packages: three steps against JAX's.  KTO runs with
    no KL batch (more KL rows than the data): JAX's LoRA KTO fails at a
    KL estimate (R18)."""
    from align_anything_tpu.trainers.text_to_text.cost_model import (
        CostModelTrainer,
    )
    from align_anything_tpu.trainers.text_to_text.kto import KTOTrainer
    from align_anything_tpu.trainers.text_to_text.orpo import ORPOTrainer
    from align_anything_tpu.trainers.text_to_text.simpo import SimPOTrainer

    jcls, tcls, task = {
        'orpo': (ORPOTrainer, torpo.ORPOTrainer, 'orpo'),
        'simpo': (SimPOTrainer, tsimpo.SimPOTrainer, 'simpo'),
        'kto': (KTOTrainer, tkto.KTOTrainer, 'kto'),
        'cost_model': (CostModelTrainer, tcost.CostModelTrainer, 'rm')}[algo]
    extra = MODES['lora'] + (('--per_device_kl_batch_size', '8')
                             if algo == 'kto' else ())
    jtrainer, trainer = _both(jcls, tcls, f'text_to_text/{task}',
                              _rm_argv(assets, tmp_path, extra),
                              ('per_device_train_batch_size',
                               'per_device_kl_batch_size'))
    if algo == 'kto':
        assert len(trainer.kl_iterator) == 0 and trainer.kl == 0.0
    if algo == 'cost_model':
        _copy_adapters(trainer.state.params['lora'],
                       jtrainer.state.params['lora'])
        with torch.no_grad():
            trainer.state.params['score_head']['w'].copy_(torch.from_numpy(
                np.array(jtrainer.state.params['score_head']['w'])))
    else:
        _copy_adapters(trainer.state.params, jtrainer.state.params)
    want, got = _steps(jtrainer, 3), _steps(trainer, 3)
    _compare(got, want)
    _compare_adapters(trainer.state.params, jtrainer.state.params)


@pytest.mark.parametrize('algo', ['multi_ppo', 'ppo_vllm'])
def test_lora_ppo_variants_match_jax(assets, tmp_path, monkeypatch,
                                     one_thread, algo):
    """Multi-sample PPO (RLOO) and ``ppo_vllm`` (the continuous rollout)
    take PPO's actor adapters: one round against JAX's, KL exactly 0."""
    from align_anything_tpu.trainers.text_to_text.multi_ppo import (
        MultiPPOTrainer,
    )
    from align_anything_tpu.trainers.text_to_text.ppo_vllm import (
        PPOVLLMTrainer,
    )

    _fix_rollouts(monkeypatch)
    argv = _ppo_argv(assets, tmp_path, extra=MODES['lora'])
    if algo == 'multi_ppo':
        _estimator_env(monkeypatch, 2, 'rloo')
        argv[argv.index('--per_device_prompt_batch_size') + 1] = '1'
    classes = {'multi_ppo': (MultiPPOTrainer, tmulti.MultiPPOTrainer),
               'ppo_vllm': (PPOVLLMTrainer, tvllm.PPOVLLMTrainer)}[algo]
    jtrainer, trainer = _both(*classes, 'text_to_text/ppo', argv, PPO_SCALED)
    assert trainer.rollout_backend == jtrainer.rollout_backend
    _copy_adapters(trainer.actor_state.params, jtrainer.actor_state.params)
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    got = trainer.train_step(batch)
    want = {k: float(v) for k, v in jtrainer.train_step(jbatch).items()}
    assert got['train/kl_divergence'] == 0.0
    _compare([got], [want])
    _compare_adapters(trainer.actor_state.params, jtrainer.actor_state.params)


def _merged_equal(trainer, slice_dir, adapters, tol=0.0):
    back, _ = load_params(str(slice_dir), device='cpu')
    want = tq.dequantize_decoder(tlora.merge_lora(
        trainer.base_params, adapters, trainer.model_cfg, trainer.lora_r,
        trainer.lora_alpha))
    want = {k: v for k, v in want.items() if k != 'score_head'}
    got, want = _leaves(back), _leaves(want)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=tol, atol=tol,
                                   err_msg=p)


@pytest.mark.parametrize('mode', ['qlora4', 'qlora8'])
def test_qlora_dpo_trainer_main_exports_and_resumes(assets, tmp_path, mode):
    """``trainer_main`` with QLoRA: the merged export reads back as
    ``merge_lora`` of the trained adapters; the checkpoint holds the adapter
    state, so a resume from it holds the trained adapters and their AdamW
    moments bit for bit (JAX checkpoints the merged tree and cannot resume,
    R20)."""
    argv = _scaled(_rm_argv(assets, tmp_path, MODES[mode]),
                   ('per_device_train_batch_size',))
    argv[argv.index('--save_checkpoint') + 1] = 'True'
    trainer = tcli.trainer_main(tdpo.DPOTrainer, 'text_to_text/dpo', argv,
                                device='cpu')
    n = trainer.global_step
    assert n >= 3
    _merged_equal(trainer, tmp_path / f'slice_{n}', trainer.state.params)
    cfgs, pc = tcli.parse_cfgs('text_to_text/dpo',
                               argv + ['--load_checkpoint', 'True'])
    resumed = tdpo.DPOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    assert resumed.global_step == resumed.state.step == n
    for m in ('q_proj', 'v_proj'):
        for k in ('a', 'b'):
            assert torch.equal(resumed.state.params[m][k],
                               trainer.state.params[m][k])
    want = trainer.state.optimizer.state_dict()['state']
    got = resumed.state.optimizer.state_dict()['state']
    assert len(got) == len(want) == 4
    for i in want:
        for k in ('exp_avg', 'exp_avg_sq'):
            assert torch.equal(got[i][k], want[i][k])


def test_lora_rm_trainer_main_exports_the_head(assets, tmp_path):
    """The RM's merged trunk and ``score_head.npy`` hold the trained
    adapters and head."""
    argv = _scaled(_rm_argv(assets, tmp_path, MODES['qlora4']),
                   ('per_device_train_batch_size',))
    trainer = tcli.trainer_main(trm.RMTrainer, 'text_to_text/rm', argv,
                                device='cpu')
    n = trainer.global_step
    _merged_equal(trainer, tmp_path / f'slice_{n}',
                  trainer.state.params['lora'])
    np.testing.assert_array_equal(
        np.load(tmp_path / f'slice_{n}' / 'score_head.npy'),
        trainer.state.params['score_head']['w'].detach().numpy())


def test_lora_ppo_trainer_main_saves_the_merged_actor(assets, tmp_path,
                                                      monkeypatch):
    """``trainer_main(PPOTrainer, ...)`` with QLoRA on the 'continuous'
    rollout runs its round and exports the merged actor."""
    _fix_rollouts(monkeypatch)
    argv = _scaled(_ppo_argv(assets, tmp_path,
                             extra=MODES['qlora4'] + ('--rollout_backend',
                                                      'continuous')),
                   PPO_SCALED)
    trainer = tcli.trainer_main(tppo.PPOTrainer, 'text_to_text/ppo', argv,
                                device='cpu')
    assert trainer.global_step == 1
    _merged_equal(trainer, tmp_path / 'slice_1', trainer.actor_state.params)


# ---------------------------------------------------------------------------
# where JAX fails with LoRA, the port raises on the same config
# ---------------------------------------------------------------------------

def test_kto_lora_fails_at_the_kl_estimate_in_both(assets, tmp_path):
    """JAX's KL estimate feeds the adapter tree to the model (R18): with a
    KL batch to draw, JAX fails with a KeyError, the port with a
    ValueError; the same trainer with LoRA off runs."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_to_text.kto import KTOTrainer

    argv = _rm_argv(assets, tmp_path, MODES['lora']) + [
        '--per_device_kl_batch_size', '1']
    cfgs, pc = jcli.parse_cfgs('text_to_text/kto', argv)
    with pytest.raises(KeyError, match='embedding'):
        KTOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    cfgs, pc = tcli.parse_cfgs('text_to_text/kto', _scaled(
        argv, ('per_device_train_batch_size', 'per_device_kl_batch_size')))
    with pytest.raises(ValueError, match='KL baseline'):
        tkto.KTOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')


def test_saferlhf_lora_fails_in_both(assets, tmp_path, monkeypatch):
    """JAX's Safe-RLHF update reads the adapters as the model (R18): its
    first round fails; the port refuses the config when it is built."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_to_text.saferlhf import (
        SafeRLHFTrainer,
    )

    _fix_rollouts(monkeypatch)
    argv = _ppo_argv(assets, tmp_path, extra=(
        '--cost_model_name_or_path', str(assets / 'reward'),
        *MODES['lora']))
    cfgs, pc = jcli.parse_cfgs('text_to_text/saferlhf', argv)
    jtrainer = SafeRLHFTrainer(cfgs=cfgs, parallel_cfgs=pc)
    with pytest.raises(KeyError, match='embedding'):
        jtrainer.train_step(next(jtrainer.train_iterator.epoch_batches(0)))
    cfgs, pc = tcli.parse_cfgs('text_to_text/saferlhf',
                               _scaled(argv, PPO_SCALED))
    with pytest.raises(ValueError, match='Safe-RLHF'):
        tsafe.SafeRLHFTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')


def test_remote_rm_ppo_lora_fails_in_both(assets, tmp_path):
    """JAX's remote-RM rollout generates from the adapter tree (R18): its
    first round fails before any request; the port refuses the config."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_to_text.ppo_remote_rm import (
        PPORemoteRMTrainer,
    )

    argv = _ppo_argv(assets, tmp_path, extra=MODES['lora'])
    cfgs, pc = jcli.parse_cfgs('text_to_text/ppo', argv)
    jtrainer = PPORemoteRMTrainer(cfgs=cfgs, parallel_cfgs=pc)
    with pytest.raises(KeyError, match='embedding'):
        jtrainer.train_step(next(jtrainer.train_iterator.epoch_batches(0)))
    cfgs, pc = tcli.parse_cfgs('text_to_text/ppo', _scaled(argv, PPO_SCALED))
    with pytest.raises(ValueError, match='remote-RM PPO'):
        tremote.PPORemoteRMTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')


def test_bnb_without_lora_fails_in_both(assets, tmp_path):
    """``use_bnb`` alone: both packages refuse to fine-tune a quantized
    model, with the same message."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_to_text.dpo import DPOTrainer

    argv = _rm_argv(assets, tmp_path, ('--use_bnb', 'True'))
    cfgs, pc = jcli.parse_cfgs('text_to_text/dpo', argv)
    with pytest.raises(ValueError, match='requires lora_cfgs.use_lora'):
        DPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    cfgs, pc = tcli.parse_cfgs('text_to_text/dpo', argv)
    with pytest.raises(ValueError, match='requires lora_cfgs.use_lora'):
        tdpo.DPOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')


def test_grpo_ignores_lora_as_jax(assets, tmp_path, monkeypatch, capsys):
    """JAX's GRPO never calls ``init_peft`` (R17): with ``--use_lora`` and
    ``--use_bnb`` both packages hold and train the full fp32 actor; the
    port says so in one line."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_to_text.grpo import GRPOTrainer

    argv = _ppo_argv(assets, tmp_path, extra=MODES['qlora4'])
    cfgs, pc = jcli.parse_cfgs('text_to_text/grpo', argv)
    jtrainer = GRPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    assert not getattr(jtrainer, 'use_lora', False)
    assert 'embedding' in jtrainer.actor_state.params
    cfgs, pc = tcli.parse_cfgs('text_to_text/grpo', _scaled(argv,
                                                            PPO_SCALED))
    trainer = tgrpo.GRPOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    assert not trainer.use_lora
    assert 'GRPO ignores lora_cfgs and bnb_cfgs' in capsys.readouterr().out
    q = trainer.actor_state.params['layers']['q']['w']
    assert isinstance(q, torch.Tensor) and q.requires_grad
    assert q.dtype == torch.float32


@pytest.fixture(scope='module')
def ti2t_assets(tmp_path_factory):
    from test_torch_ti2t_rm_ppo import make_rl_assets

    return make_rl_assets(tmp_path_factory.mktemp('lora_ti2t_assets'))


TI2T = ('sft', 'dpo', 'kto', 'orpo', 'simpo', 'rm', 'ppo', 'saferlhf')


@pytest.mark.parametrize('flags', ['lora', 'qlora4'])
@pytest.mark.parametrize('algo', TI2T)
def test_ti2t_lora_fails_in_both(ti2t_assets, tmp_path, monkeypatch, algo,
                                 flags):
    """The image-text trainers' multimodal trees have no top-level
    ``layers`` (R19): JAX's ``init_peft`` fails (an AttributeError for
    LoRA, a ValueError for bnb) and the port raises a ValueError."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_image_to_text import (
        ppo as jppo,
        rm as jrm,
        saferlhf as jsafe,
    )
    from align_anything_tpu_torch.trainers.text_image_to_text import (
        ppo as pppo,
        rm as prm,
        saferlhf as psafe,
    )

    import test_torch_ti2t_rm_ppo as R
    import test_torch_ti2t_trainers as T

    extra = MODES[flags]
    jerr = AttributeError if flags == 'lora' else ValueError
    if algo in T.PORT:
        with pytest.raises(jerr):
            T._jax(ti2t_assets, algo, tmp_path, monkeypatch, extra)
        with pytest.raises(ValueError, match='generic decoder'):
            T._port(ti2t_assets, algo, tmp_path, extra)
        return
    argv = {'rm': R._rm_argv(ti2t_assets, tmp_path),
            'ppo': R._ppo_argv(ti2t_assets, tmp_path),
            'saferlhf': R._ppo_argv(ti2t_assets, tmp_path) + [
                '--cost_model_name_or_path',
                str(ti2t_assets / 'cost')]}[algo] + list(extra)
    jcls, pcls = {'rm': (jrm.TI2TRMTrainer, prm.TI2TRMTrainer),
                  'ppo': (jppo.TI2TPPOTrainer, pppo.TI2TPPOTrainer),
                  'saferlhf': (jsafe.TI2TSafeRLHFTrainer,
                               psafe.TI2TSafeRLHFTrainer)}[algo]
    task = f'text_image_to_text/{algo}'
    cfgs, pc = jcli.parse_cfgs(task, argv)
    with pytest.raises(jerr):
        jcls(cfgs=cfgs, parallel_cfgs=pc)
    cfgs, pc = tcli.parse_cfgs(task, argv)
    with pytest.raises(ValueError):
        pcls(cfgs=cfgs, parallel_cfgs=pc, device='cpu')


def test_ti2t_grpo_ignores_lora_as_jax(ti2t_assets, tmp_path):
    """The image-text GRPO inherits GRPO's ``init_engines``, in both
    packages: with ``--use_lora`` it holds and trains the full actor
    (R17)."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_image_to_text import grpo as jgrpo
    from align_anything_tpu_torch.trainers.text_image_to_text import (
        grpo as pgrpo,
    )

    import test_torch_ti2t_rm_ppo as R

    argv = R._ppo_argv(ti2t_assets, tmp_path) + list(MODES['qlora4'])
    cfgs, pc = jcli.parse_cfgs('text_image_to_text/grpo', argv)
    jtrainer = jgrpo.TI2TGRPOTrainer(cfgs=cfgs, parallel_cfgs=pc)
    assert not getattr(jtrainer, 'use_lora', False)
    cfgs, pc = tcli.parse_cfgs('text_image_to_text/grpo', argv)
    trainer = pgrpo.TI2TGRPOTrainer(cfgs=cfgs, parallel_cfgs=pc,
                                    device='cpu')
    assert not trainer.use_lora
    assert set(trainer.actor_state.params) == set(jtrainer.actor_state.params)
