"""Loss-curve parity with the port as the third curve (BASELINE.json's
"loss-curve parity" criterion in miniature): ``tests/test_loss_curve_parity.py``'s
fixture (a tiny OPT saved by ``transformers``, 6 DPO steps on fixed
batches, Adam lr 1e-4, fp32), trained three ways on the same data, init and
hyperparameters:

- the JAX package (``_jax_curve`` of that test),
- an independent torch implementation (HF model + hand-written DPO loss +
  ``torch.optim.Adam``; ``_torch_curve`` of that test),
- the port: the checkpoint read by the port's ``load_params`` and trained
  with the port's ``DPOStep`` (AdamW without weight decay and without a
  clip is Adam).

Each pair of curves must agree at that test's tolerance (2e-4 abs, 1e-3
rel per step).
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('transformers')

from test_loss_curve_parity import (  # noqa: E402
    BETA,
    LR,
    _jax_curve,
    _torch_curve,
    setup,  # noqa: F401  (the shared fixture)
)

from align_anything_tpu_torch.models.hf_loader import load_params  # noqa: E402
from align_anything_tpu_torch.trainers.optimizer import (  # noqa: E402
    make_optimizer,
)
from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: E402
    DPOStep,
)
from align_anything_tpu_torch.utils.tools import tree_map  # noqa: E402


def _port_curve(model_dir, batches):
    params, cfg = load_params(str(model_dir), device='cpu')
    cfg = cfg.replace(compute_dtype='float32')
    params = tree_map(lambda t: t.requires_grad_(True), params)
    ref = tree_map(lambda t: t.detach().clone(), params)
    tx, schedule = make_optimizer(LR, adam_betas=(0.9, 0.95),
                                  adam_epsilon=1e-8, max_grad_norm=0.0)
    step = DPOStep(cfg, tx, schedule, scale_coeff=BETA)
    state = step.init_state(params)
    losses = []
    for ids_np, mask_np in batches:
        ids = torch.tensor(ids_np)
        batch = {'input_ids': ids, 'attention_mask': torch.ones_like(ids),
                 'response_mask': torch.tensor(mask_np)}
        state, metrics = step.step(state, ref, batch)
        losses.append(float(metrics['train/loss']))
    return losses


def test_port_curve_matches_jax_and_torch(setup):  # noqa: F811
    model_dir, batches = setup
    port = _port_curve(model_dir, batches)
    jax_curve = _jax_curve(model_dir, batches)
    torch_curve = _torch_curve(model_dir, batches)
    np.testing.assert_allclose(port, jax_curve, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(port, torch_curve, atol=2e-4, rtol=1e-3)
    assert abs(port[0] - np.log(2)) < 1e-6
    assert abs(port[0] - port[-1]) > 1e-4
