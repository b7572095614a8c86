"""Rule-based reward functions for the remote RM server.

Parity with reference models/remote_rm/reward_functions/{examples,
math_verifier}.py: pluggable `(prompts, responses, golden) -> rewards`
callables, including a math answer verifier (boxed/number extraction with an
optional sympy equivalence check when available).  The port of
``align_anything_tpu/models/remote_rm/reward_functions.py``.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional

RewardFn = Callable[[List[str], List[str], Optional[List[str]]], List[float]]

REWARD_FUNCTIONS: dict[str, RewardFn] = {}


def register_reward_function(name: str | None = None):
    def decorator(fn: RewardFn) -> RewardFn:
        REWARD_FUNCTIONS[name or fn.__name__] = fn
        return fn

    return decorator


def get_reward_function(name: str) -> RewardFn:
    if name not in REWARD_FUNCTIONS:
        raise ValueError(f'unknown reward function {name!r}; '
                         f'available: {sorted(REWARD_FUNCTIONS)}')
    return REWARD_FUNCTIONS[name]


@register_reward_function('example_length')
def example_length_reward(prompts, responses, golden_responses=None):
    """Toy reward: favor concise non-empty responses."""
    return [min(len(r.split()), 100) / 100.0 if r.strip() else -1.0
            for r in responses]


@register_reward_function('example_safety')
def example_safety_reward(prompts, responses, golden_responses=None):
    """Toy keyword-based safety scorer (reference examples.py analog)."""
    unsafe = ('kill', 'attack', 'weapon', 'bomb')
    return [-1.0 if any(w in r.lower() for w in unsafe) else 1.0
            for r in responses]


_BOXED = re.compile(r'\\boxed\{([^{}]*)\}')
_NUMBER = re.compile(r'-?\d+(?:\.\d+)?(?:/\d+)?')


def extract_answer(text: str) -> str | None:
    """Final answer: last \\boxed{...}, else text after '####', else the
    last number in the response."""
    m = _BOXED.findall(text)
    if m:
        return m[-1].strip()
    if '####' in text:
        return text.rsplit('####', 1)[-1].strip().split('\n')[0].strip()
    nums = _NUMBER.findall(text.replace(',', ''))
    return nums[-1] if nums else None


def _math_equal(a: str, b: str) -> bool:
    if a == b:
        return True
    try:
        return abs(float(eval(a, {'__builtins__': {}}))  # noqa: S307 - digits/ops only
                   - float(eval(b, {'__builtins__': {}}))) < 1e-6
    except Exception:
        pass
    try:
        import sympy  # noqa: PLC0415

        return sympy.simplify(f'({a})-({b})') == 0
    except Exception:
        return False


@register_reward_function('math_verifier')
def math_verifier_reward(prompts, responses, golden_responses=None):
    """Golden-answer matcher (reference reward_functions/math_verifier.py):
    +1 for a response whose extracted final answer equals the golden
    answer, -1 otherwise."""
    rewards = []
    golden_responses = golden_responses or [None] * len(responses)
    for response, golden in zip(responses, golden_responses):
        if golden is None:
            rewards.append(0.0)
            continue
        pred = extract_answer(response)
        gold = extract_answer(golden) or golden.strip()
        ok = pred is not None and _math_equal(str(pred), str(gold))
        rewards.append(1.0 if ok else -1.0)
    return rewards
