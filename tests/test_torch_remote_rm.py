"""The port's remote reward model (``align_anything_tpu_torch/models/
remote_rm``) and the two PPO variants around it, against the JAX package's:

- every case of ``tests/test_remote_rm.py``, run through both packages'
  functions (the reward functions, the service, the stdlib HTTP server and
  the client);
- ``PPORemoteRMTrainer``: one round against a local stdlib server, on the
  assets and helpers of ``tests/test_torch_rl_trainers.py`` (the rollout
  fixed by patching both packages' ``generate``): the rewards, the metrics
  and the actor and critic after the round;
- ``PPOVLLMTrainer``: 'continuous' by default, and an explicit
  ``--rollout_backend batch`` wins (``tests/test_rl_smoke.py:140``).

A server binds a free port (a socket probe) on 127.0.0.1 and is waited for
by polling with a deadline.  Tolerances: the rewards exactly (the same
texts through the same rule), metrics and parameters to 1e-5.
"""

import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('transformers')
pytest.importorskip('yaml')

from align_anything_tpu_torch.models import remote_rm as tremote  # noqa: E402
from align_anything_tpu_torch.models.remote_rm import (  # noqa: E402
    reward_functions as treward,
)
from align_anything_tpu_torch.models.remote_rm import (  # noqa: E402
    server as tserver,
)
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_to_text import (  # noqa: E402
    ppo as tppo,
)
from align_anything_tpu_torch.trainers.text_to_text import (  # noqa: E402
    ppo_remote_rm as tremote_ppo,
)
from align_anything_tpu_torch.trainers.text_to_text import (  # noqa: E402
    ppo_vllm as tvllm,
)
from test_torch_rl_trainers import (  # noqa: E402,F401  (a fixture)
    PPO_SCALED,
    REPO,
    TOL,
    _both,
    _compare,
    _compare_trees,
    _fix_rollouts,
    _ppo_argv,
    _ppo_round,
    _scaled,
    make_assets,
    one_thread,
)


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """``tests/test_torch_rl_trainers.py``'s assets with a one-layer model:
    the JAX trainer's compile time grows with the depth, and one layer
    holds the trainer's logic."""
    return make_assets(tmp_path_factory.mktemp('remote_rm_assets'), layers=1)


SERVER_DEADLINE_S = 30.0


def _packages():
    """(client, reward functions, server) modules of each package."""
    from align_anything_tpu.models import remote_rm as jremote
    from align_anything_tpu.models.remote_rm import (
        reward_functions as jreward,
    )
    from align_anything_tpu.models.remote_rm import server as jserver

    return {'jax': (jremote, jreward, jserver),
            'port': (tremote, treward, tserver)}


PACKAGES = pytest.mark.parametrize('pkg', ['jax', 'port'])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def serve(server_module, reward_fn: str) -> str:
    """Start ``server_module.start_server`` (stdlib) in a daemon thread on a
    free port and wait until it accepts; returns its endpoint."""
    port = free_port()
    threading.Thread(target=server_module.start_server, kwargs={
        'host': '127.0.0.1', 'port': port, 'reward_fn_name': reward_fn,
        'use_flask': False}, daemon=True).start()
    deadline = time.monotonic() + SERVER_DEADLINE_S
    while True:
        try:
            socket.create_connection(('127.0.0.1', port), timeout=1).close()
            return f'http://127.0.0.1:{port}/get_reward'
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.01)


# ---------------------------------------------------------------------------
# the cases of tests/test_remote_rm.py, through both packages
# ---------------------------------------------------------------------------

@PACKAGES
def test_extract_answer(pkg):
    extract_answer = _packages()[pkg][1].extract_answer
    assert extract_answer(r'the answer is \boxed{42}') == '42'
    assert extract_answer('reasoning #### 7') == '7'
    assert extract_answer('so we get 3 then 15') == '15'
    assert extract_answer('no numbers here') is None


@PACKAGES
def test_math_verifier(pkg):
    fn = _packages()[pkg][0].get_reward_function('math_verifier')
    rewards = fn(['q1', 'q2', 'q3'],
                 [r'\boxed{42}', 'the answer is 8', 'wrong 9'],
                 ['42', '#### 8.0', '10'])
    assert rewards == [1.0, 1.0, -1.0]


@PACKAGES
def test_service_validation(pkg):
    svc = _packages()[pkg][2].RewardService('example_length')
    body, code = svc.get_reward({'prompts': ['a']})
    assert code == 400
    body, code = svc.get_reward({'prompts': ['a'], 'responses': ['x', 'y']})
    assert code == 400
    body, code = svc.get_reward({'prompts': ['a'],
                                 'responses': ['hello world']})
    assert code == 200 and len(body['rewards']) == 1


@PACKAGES
def test_golden_dataset_similarity(pkg):
    svc = _packages()[pkg][2].RewardService(
        'math_verifier', golden_dataset={'what is 2+2': '4',
                                         'what is 3*3': '9'})
    body, code = svc.get_reward({'prompts': ['what is 2 + 2'],
                                 'responses': ['the answer is 4']})
    assert code == 200 and body['rewards'] == [1.0]


@PACKAGES
def test_http_roundtrip_stdlib_server(pkg):
    """Client <-> stdlib server over a real socket."""
    remote, _, server = _packages()[pkg]
    client = remote.RemoteRewardModel(serve(server, 'example_safety'),
                                      timeout=5, retry_times=2)
    rewards = client.score(['p1', 'p2'], ['a friendly reply', 'attack plan'])
    np.testing.assert_array_equal(rewards, [1.0, -1.0])
    assert rewards.dtype == np.float32


@PACKAGES
def test_client_retry_then_fail(pkg):
    """No server on the port: every attempt is refused."""
    client = _packages()[pkg][0].RemoteRewardModel(
        f'http://127.0.0.1:{free_port()}/get_reward', timeout=1,
        retry_times=2)
    with pytest.raises(RuntimeError, match='failed after 2 attempts'):
        client.score(['p'], ['r'])


def test_reward_functions_match_jax():
    """The port's registry and every function's answers equal JAX's."""
    jreward = _packages()['jax'][1]
    assert sorted(treward.REWARD_FUNCTIONS) == sorted(jreward.REWARD_FUNCTIONS)
    prompts = ['q'] * 5
    responses = ['', 'one two', r'\boxed{3/4}', 'kill the 7 bugs',
                 ' '.join(['w'] * 150)]
    golden = ['x', '2', '0.75', '7', None]
    for name in treward.REWARD_FUNCTIONS:
        assert (treward.get_reward_function(name)(prompts, responses, golden)
                == jreward.get_reward_function(name)(prompts, responses,
                                                     golden)), name


# ---------------------------------------------------------------------------
# PPO with the remote reward server
# ---------------------------------------------------------------------------

def _remote_argv(assets, out, endpoint, extra=()):
    return _ppo_argv(assets, out, extra=(
        '--reward_critic_model_name_or_path', str(assets / 'reward'),
        '--reward_server_endpoint', endpoint, '--reward_server_timeout', '10',
        *extra))


def _fix_remote_rollouts(monkeypatch):
    """The PPO rollout fix, also for the remote-RM modules' ``generate``."""
    from align_anything_tpu.trainers.text_to_text import ppo as jppo
    from align_anything_tpu.trainers.text_to_text import (
        ppo_remote_rm as jremote_ppo,
    )

    _fix_rollouts(monkeypatch)
    monkeypatch.setattr(jremote_ppo, 'generate', jppo.generate)
    monkeypatch.setattr(tremote_ppo, 'generate', tppo.generate)


def _recording_rollouts(monkeypatch, cls, out: list):
    rollout = cls.rollout

    def recording(self, prompt_batch):
        r = rollout(self, prompt_batch)
        out.append({k: np.asarray(v.cpu() if hasattr(v, 'cpu') else v)
                    for k, v in r.items()})
        return r

    monkeypatch.setattr(cls, 'rollout', recording)


def test_ppo_remote_rm_round_matches_jax(assets, tmp_path, monkeypatch,
                                         one_thread):
    """One round (16 prompts, 2 micro-batches of 8) against a local server
    with the ``example_length`` rule: every rollout key and every metric
    equal JAX's, each reward the rule over the decoded texts, and the actor
    and critic after the round.  The generation eval reports the critic's
    starting end score as ``eval/reward``; JAX's eval raises before it
    scores (its trainer never sets ``reward_tokenizer``), and with that
    attribute set it agrees (ROADMAP R11)."""
    from align_anything_tpu.trainers.text_to_text.ppo_remote_rm import (
        PPORemoteRMTrainer,
    )

    _fix_remote_rollouts(monkeypatch)
    endpoint = serve(tserver, 'example_length')
    rollouts = {'jax': [], 'port': []}
    _recording_rollouts(monkeypatch, PPORemoteRMTrainer, rollouts['jax'])
    _recording_rollouts(monkeypatch, tremote_ppo.PPORemoteRMTrainer,
                        rollouts['port'])
    extra = ('--eval_datasets', str(assets / 'prompts.jsonl'),
             '--eval_size', '8', '--per_device_eval_batch_size', '1')
    jtrainer, trainer = _both(
        PPORemoteRMTrainer, tremote_ppo.PPORemoteRMTrainer,
        'text_to_text/ppo', _remote_argv(assets, tmp_path, endpoint, extra),
        PPO_SCALED)
    assert trainer.rollout_backend == 'batch'
    got, want = _ppo_round(jtrainer, trainer)
    (jr,), (r,) = rollouts['jax'], rollouts['port']
    assert set(jr) <= set(r)
    for key in ('input_ids', 'attention_mask', 'start', 'reward'):
        np.testing.assert_array_equal(r[key], jr[key], err_msg=key)
    # per-token keys under the completion mask: a left pad's query row sees
    # no key (ROADMAP §3, not a fault)
    start = int(r['start'])
    mask = r['attention_mask'][:, 1:][:, start:]
    for key in ('log_probs', 'ref_log_probs', 'reward_values'):
        np.testing.assert_allclose(r[key][:, start:] * mask,
                                   jr[key][:, start:] * mask, rtol=TOL,
                                   atol=TOL, err_msg=key)
    assert r['reward'].dtype == np.float32
    prompts, responses = trainer.decode_rollout(
        r['input_ids'][:, :r['start'] + 1],
        r['input_ids'][:, r['start'] + 1:])
    rule = treward.get_reward_function('example_length')
    np.testing.assert_array_equal(
        r['reward'], np.asarray(rule(prompts, responses), np.float32))
    assert len(set(r['reward'].tolist())) > 2 and -1.0 in r['reward']
    assert got['train/kl_divergence'] == 0.0
    _compare([got], [want])
    _compare_trees(trainer.actor_state.params, jtrainer.actor_state.params)
    _compare_trees(trainer.critic_state.params, jtrainer.critic_state.params)

    with pytest.raises(AttributeError, match='reward_tokenizer'):
        jtrainer.eval()
    jtrainer.reward_tokenizer = jtrainer.tokenizer
    _compare([trainer.eval()], [jtrainer.eval()])


def test_ppo_remote_rm_trainer_main(assets, tmp_path, monkeypatch):
    """``trainer_main(PPORemoteRMTrainer, ...)`` with the critic from the
    actor's checkpoint (no ``reward_critic_model_name_or_path``; a fresh
    head) and ``--rollout_backend continuous``, which the trainer ignores
    for the batch engine; an unreachable server raises."""
    _fix_remote_rollouts(monkeypatch)
    endpoint = serve(tserver, 'example_safety')
    argv = _scaled(_ppo_argv(assets, tmp_path, extra=(
        '--reward_server_endpoint', endpoint,
        '--rollout_backend', 'continuous')), PPO_SCALED)
    trainer = tcli.trainer_main(tremote_ppo.PPORemoteRMTrainer,
                                'text_to_text/ppo', argv, device='cpu')
    assert trainer.global_step == 1
    assert trainer._cont_engine is None
    dead = _scaled(_ppo_argv(assets, tmp_path / 'dead', extra=(
        '--reward_server_endpoint',
        f'http://127.0.0.1:{free_port()}/get_reward',
        '--reward_server_timeout', '1')), PPO_SCALED)
    cfgs, pc = tcli.parse_cfgs('text_to_text/ppo', dead)
    trainer = tremote_ppo.PPORemoteRMTrainer(cfgs=cfgs, parallel_cfgs=pc,
                                             device='cpu')
    trainer.remote_rm.retry_times = 1
    with pytest.raises(RuntimeError, match='failed after 1 attempts'):
        trainer.train_step(next(trainer.train_iterator.epoch_batches(0)))


# ---------------------------------------------------------------------------
# PPO with the continuous rollout by default
# ---------------------------------------------------------------------------

def test_ppo_vllm_defaults_to_continuous(assets, tmp_path):
    """The port picks the backend the JAX trainer picks: 'continuous'
    unless the command line names one."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_to_text.ppo_vllm import (
        PPOVLLMTrainer,
    )

    argv = _ppo_argv(assets, tmp_path)
    for extra, backend in (((), 'continuous'),
                           (('--rollout_backend', 'batch'), 'batch')):
        cfgs, pc = jcli.parse_cfgs('text_to_text/ppo', argv + list(extra))
        assert PPOVLLMTrainer(cfgs=cfgs,
                              parallel_cfgs=pc).rollout_backend == backend
        cfgs, pc = tcli.parse_cfgs('text_to_text/ppo', _scaled(
            argv + list(extra), PPO_SCALED))
        assert tvllm.PPOVLLMTrainer(cfgs=cfgs, parallel_cfgs=pc,
                                    device='cpu').rollout_backend == backend


def test_ppo_vllm_round(assets, tmp_path, monkeypatch, one_thread):
    """One round through the continuous engine, as ``PPOTrainer`` with
    ``--rollout_backend continuous`` runs it: the same metrics and actor,
    and round 1's KL exactly 0."""
    _fix_rollouts(monkeypatch)
    argv = _scaled(_ppo_argv(assets, tmp_path), PPO_SCALED)
    runs = {}
    for name, cls, extra in (
            ('vllm', tvllm.PPOVLLMTrainer, ()),
            ('ppo', tppo.PPOTrainer, ('--rollout_backend', 'continuous'))):
        cfgs, pc = tcli.parse_cfgs('text_to_text/ppo', argv + list(extra))
        trainer = cls(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
        metrics = trainer.train_step(
            next(trainer.train_iterator.epoch_batches(0)))
        assert trainer._cont_engine is not None
        runs[name] = (trainer, metrics)
    got, want = runs['vllm'][1], runs['ppo'][1]
    assert got['train/kl_divergence'] == 0.0
    _compare([{k: v for k, v in got.items() if not k.startswith('perf/')}],
             [{k: v for k, v in want.items() if not k.startswith('perf/')}],
             tol=0)
    _compare_trees(runs['vllm'][0].actor_state.params,
                   runs['ppo'][0].actor_state.params, 0)


@pytest.mark.parametrize('module', [
    'trainers.text_to_text.ppo_remote_rm', 'trainers.text_to_text.ppo_vllm',
    'models.remote_rm.server'])
def test_remote_rm_entry_points(module):
    """``python -m align_anything_tpu_torch.<module> --help`` exits 0 with
    a usage line (the trainers parse their command line; the server its
    flags)."""
    proc = subprocess.run(
        [sys.executable, '-m', f'align_anything_tpu_torch.{module}',
         '--help'], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'usage' in proc.stdout
