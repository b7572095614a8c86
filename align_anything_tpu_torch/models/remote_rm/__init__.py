"""The remote reward model: a rule-based reward server and its HTTP
client, the port's own copy of ``align_anything_tpu/models/remote_rm``
(stdlib and numpy only; importing the JAX package's copy would run
``align_anything_tpu/models/__init__.py``, which imports JAX)."""

from align_anything_tpu_torch.models.remote_rm.client import RemoteRewardModel
from align_anything_tpu_torch.models.remote_rm.reward_functions import (
    REWARD_FUNCTIONS,
    get_reward_function,
    register_reward_function,
)

__all__ = ['RemoteRewardModel', 'REWARD_FUNCTIONS', 'get_reward_function',
           'register_reward_function']
