"""optax's learning-rate schedules, the port's own copies: a schedule
maps the count of optimizer updates made so far to a learning rate.

The count may be a Python int (the value comes back as a 0-d float32
tensor) or an int tensor on the card, where the rate is computed on the
device: inside a captured CUDA graph a Python float would be baked into
the graph, so the port's optimizers keep their count as a tensor and
call the schedule on it each update.  The arithmetic is optax's
(``optax/schedules/_schedule.py``, ``_join.py``) in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

__all__ = ["cosine_decay_schedule", "join_schedules", "linear_schedule"]


def _count(count) -> torch.Tensor:
    return count if torch.is_tensor(count) else torch.tensor(count)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int,
                    transition_begin: int = 0) -> Callable:
    """``optax.linear_schedule``: ``init_value`` until
    ``transition_begin``, then linear to ``end_value`` over
    ``transition_steps`` updates, then ``end_value``."""
    if transition_steps <= 0:
        return lambda count: torch.full((), float(init_value),
                                        device=_count(count).device)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        c = torch.clamp(_count(count) - transition_begin, 0,
                        transition_steps)
        frac = 1 - c.float() / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable:
    """``optax.cosine_decay_schedule``: ``init_value`` times
    ``(1 - alpha) * (0.5 (1 + cos(pi t / T)))**exponent + alpha``, with
    ``t`` held at ``T = decay_steps``."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = torch.clamp(_count(count).float(), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def join_schedules(schedules: Sequence[Callable],
                   boundaries: Sequence[int]) -> Callable:
    """``optax.join_schedules``: ``schedules[i + 1]`` takes over at
    ``boundaries[i]``, counting from there."""

    def schedule(count):
        count = _count(count)
        out = schedules[0](count)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, nxt(count - boundary))
        return out

    return schedule
