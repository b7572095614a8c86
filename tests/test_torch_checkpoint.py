"""The port's asynchronous train-state saves (``align_anything_tpu_torch/
checkpoint.py``): the host snapshot, one background writer, commits by
``os.replace``, and errors that reach the caller; then a resume through
``trainer_main`` from a save made while the loop went on.

The JAX module saves through orbax's ``AsyncCheckpointer``, which the card's
machine does not have, so these hold the port to orbax's contract rather
than to JAX's numbers.  The writer is held back with an event where a test
needs a save to be in flight; comparisons are bit for bit.
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch import checkpoint as ckpt  # noqa: E402
from align_anything_tpu_torch.models import transformer as tt  # noqa: E402
from align_anything_tpu_torch.models.config import tiny_config  # noqa: E402
from align_anything_tpu_torch.trainers.optimizer import (  # noqa: E402
    make_optimizer,
    param_leaves,
)
from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: E402
    DPOStep,
)
from align_anything_tpu_torch.utils.tools import tree_map  # noqa: E402

CFG = dict(vocab_size=64, hidden=32, layers=1, heads=2, kv_heads=1, mlp=64)


def _trainer():
    cfg = tiny_config(**CFG).replace(compute_dtype='float32')
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device='cpu')
    ref = tree_map(lambda t: t.clone(), params)
    trainer = DPOStep(cfg, *make_optimizer(1e-2, total_steps=8))
    state = trainer.init_state(tree_map(lambda t: t.requires_grad_(True),
                                        params))
    rng = np.random.default_rng(0)
    batch = {'input_ids': torch.from_numpy(rng.integers(3, 64, size=(2, 12))),
             'attention_mask': torch.ones((2, 12), dtype=torch.long),
             'response_mask': torch.ones((2, 11))}
    return trainer, state, ref, batch


def _snapshot(state):
    return ([p.detach().clone() for p in param_leaves(state.params)],
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in state.optimizer.state_dict()['state'].items()})


def _restored(path):
    _, fresh, _, _ = _trainer()
    ckpt.restore_train_state(path, fresh)
    return fresh


def _same(state, snap) -> bool:
    params, moments = snap
    got = _snapshot(state)
    return (all(torch.equal(a, b) for a, b in zip(got[0], params))
            and got[1].keys() == moments.keys()
            and all(torch.equal(got[1][i][k], moments[i][k])
                    for i in moments for k in moments[i]))


class _HeldWriter:
    """``checkpoint._write`` that waits for ``release`` and logs each
    write's start and end."""

    def __init__(self, monkeypatch):
        self.release = threading.Event()
        self.log = []
        write = ckpt._write

        def held(payload, path):
            name = os.path.basename(path)
            self.log.append(f'start {name}')
            self.release.wait(30)
            write(payload, path)
            self.log.append(f'end {name}')

        monkeypatch.setattr(ckpt, '_write', held)


@pytest.fixture(autouse=True)
def _no_save_in_flight():
    yield
    ckpt.wait_for_saves()


def test_async_save_is_the_state_at_the_call(tmp_path, monkeypatch):
    """The save written after two more in-place steps restores to the
    state at the call, params and AdamW moments."""
    trainer, state, ref, batch = _trainer()
    state, _ = trainer.step(state, ref, batch)
    held = _HeldWriter(monkeypatch)
    path = ckpt.save_train_state(str(tmp_path), 1, state, wait=False)
    at_call = _snapshot(state)
    for _ in range(2):
        state, _ = trainer.step(state, ref, batch)
    assert not _same(state, at_call)
    assert held.log == ['start step_1']       # still in flight
    held.release.set()
    ckpt.wait_for_saves()
    restored = _restored(path)
    assert _same(restored, at_call) and restored.step == 1


def test_consecutive_saves_serialize(tmp_path, monkeypatch):
    """A second save waits for the one in flight before it starts."""
    _, state, _, _ = _trainer()
    held = _HeldWriter(monkeypatch)
    ckpt.save_train_state(str(tmp_path), 1, state, wait=False)
    second = threading.Thread(target=ckpt.save_train_state,
                              args=(str(tmp_path), 2, state),
                              kwargs={'wait': False})
    second.start()
    time.sleep(0.3)
    assert held.log == ['start step_1']
    held.release.set()
    second.join(30)
    ckpt.wait_for_saves()
    assert held.log == ['start step_1', 'end step_1', 'start step_2',
                        'end step_2']


def test_pruning_spares_the_save_in_flight(tmp_path, monkeypatch):
    """``keep=1``: the save in flight survives the pruning its own call
    does, and the committed one before it goes."""
    _, state, _, _ = _trainer()
    ckpt.save_train_state(str(tmp_path), 1, state, keep=1)
    held = _HeldWriter(monkeypatch)
    ckpt.save_train_state(str(tmp_path), 2, state, keep=1, wait=False)
    root = tmp_path / 'checkpoints'
    assert sorted(os.listdir(root)) == ['step_2']
    held.release.set()
    ckpt.wait_for_saves()
    assert ckpt.latest_checkpoint(str(tmp_path)) == (str(root / 'step_2'), 2)


def test_writer_error_reaches_the_caller(tmp_path, monkeypatch):
    """A failed background write raises in ``wait_for_saves``, and, when
    nothing waited, in the next save; it never commits."""
    _, state, _, _ = _trainer()

    def broken(*args, **kwargs):
        raise OSError('disk full')

    monkeypatch.setattr(torch, 'save', broken)
    ckpt.save_train_state(str(tmp_path), 1, state, wait=False)
    with pytest.raises(OSError, match='disk full'):
        ckpt.wait_for_saves()
    ckpt.save_train_state(str(tmp_path), 2, state, wait=False)
    with pytest.raises(OSError, match='disk full'):
        ckpt.save_train_state(str(tmp_path), 3, state, wait=False)
    ckpt.wait_for_saves()             # raised once; save 3 never started
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    assert not os.path.exists(tmp_path / 'checkpoints' / 'step_3')


def test_latest_checkpoint_ignores_an_uncommitted_save(tmp_path,
                                                       monkeypatch):
    _, state, _, _ = _trainer()
    ckpt.save_train_state(str(tmp_path), 1, state)
    root = tmp_path / 'checkpoints'
    # a save cut off before its commit: only the temporary file
    os.makedirs(root / 'step_5')
    (root / 'step_5' / (ckpt._STATE_FILE + '.tmp')).write_bytes(b'partial')
    held = _HeldWriter(monkeypatch)
    ckpt.save_train_state(str(tmp_path), 3, state, wait=False)
    assert ckpt.latest_checkpoint(str(tmp_path)) == (str(root / 'step_1'), 1)
    held.release.set()
    ckpt.wait_for_saves()
    assert ckpt.latest_checkpoint(str(tmp_path)) == (str(root / 'step_3'), 3)


def test_trainer_main_resume_from_an_async_save(tmp_path, monkeypatch,
                                                one_thread):
    """DPO through ``trainer_main``, its step-2 train state saved with
    ``wait=False`` while steps 3-4 ran; a second ``trainer_main`` resumed
    from it is bit-equal to the uninterrupted run."""
    from align_anything_tpu_torch.trainers import cli as tcli
    from align_anything_tpu_torch.trainers.text_to_text.dpo import (
        DPOTrainer)
    from align_anything_tpu_torch.utils.logger import Logger

    from test_torch_trainers import _argv, _leaves, make_assets

    assets = make_assets(tmp_path / 'assets')
    waits = []
    save = ckpt.save_train_state

    def spied(*args, **kwargs):
        waits.append(kwargs.get('wait', True))
        return save(*args, **kwargs)

    monkeypatch.setattr(ckpt, 'save_train_state', spied)
    steps = []
    monkeypatch.setattr(Logger, 'log', lambda self, metrics, step:
                        steps.append(dict(metrics)))
    full = tcli.trainer_main(DPOTrainer, 'text_to_text/dpo', _argv(
        assets, 'dpo', tmp_path / 'full', 8,
        ('--save_checkpoint', 'True', '--save_interval', '2',
         '--save_total_limit', '3')), device='cpu')
    full_steps, steps[:] = list(steps), []
    assert len(full_steps) == 4 and waits and not any(waits)
    os.makedirs(tmp_path / 'resumed' / 'checkpoints')
    os.rename(tmp_path / 'full' / 'checkpoints' / 'step_2',
              tmp_path / 'resumed' / 'checkpoints' / 'step_2')
    resumed = tcli.trainer_main(DPOTrainer, 'text_to_text/dpo', _argv(
        assets, 'dpo', tmp_path / 'resumed', 8,
        ('--load_checkpoint', 'True')), device='cpu')
    keys = ('train/loss', 'train/grad_norm', 'train/lr')
    assert [[m[k] for k in keys] for m in steps] == \
        [[m[k] for k in keys] for m in full_steps[2:]]
    want, got = _leaves(full.state.params), _leaves(resumed.state.params)
    assert all(torch.equal(got[p], want[p]) for p in want)


@pytest.fixture()
def one_thread():
    """torch's multithreaded CPU reductions are not repeatable bit for bit;
    one thread is."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
