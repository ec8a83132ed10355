"""Train state: parameters + optimizer state + step counter."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .optim import AdamWState


@dataclass
class TrainState:
    """``params``: the f32 master tree (leaves require grad); ``opt_state``:
    the AdamW state; ``step``: train steps taken (host integer, folded into
    each step's seed)."""

    params: Any
    opt_state: AdamWState
    step: int = 0
