"""Dynamic MLM masking on the device, from a ``torch.Generator``.

Counterpart of ``msa_tpu/ops/masking.py``: special tokens are never
masked, labels are -100 off the masked positions, and 80% of the masked
positions become [MASK] (the remaining 20% keep their token; the 10%
random-word branch is off, as in the JAX package).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .losses import IGNORE_INDEX

# bert-uncased ids: [PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103
DEFAULT_SPECIAL_IDS = (0, 100, 101, 102, 103)
DEFAULT_MASK_ID = 103


def mask_tokens(generator: torch.Generator, input_ids: torch.Tensor,
                mlm_probability: float = 0.15,
                mask_token_id: int = DEFAULT_MASK_ID,
                special_ids: Sequence[int] = DEFAULT_SPECIAL_IDS,
                replace_prob: float = 0.8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (masked_ids, labels).  Both draws come from ``generator``,
    which lives on ``input_ids``' device."""
    special = torch.isin(input_ids,
                         torch.tensor(special_ids, device=input_ids.device))
    draw = lambda: torch.rand(input_ids.shape, generator=generator,  # noqa: E731
                              device=input_ids.device)
    masked = (draw() < mlm_probability) & ~special
    replaced = (draw() < replace_prob) & masked
    return apply_mlm_masks(input_ids, masked, replaced, mask_token_id)


def apply_mlm_masks(input_ids: torch.Tensor, masked: torch.Tensor,
                    replaced: torch.Tensor,
                    mask_token_id: int = DEFAULT_MASK_ID
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic MLM masking from precomputed boolean masks (the
    ``Trainer.mlm_mask_injector`` hook): ``masked`` selects the supervised
    positions, ``replaced & masked`` ones become ``mask_token_id``.  The
    caller keeps special tokens out of ``masked``."""
    masked = masked.bool()
    replaced = replaced.bool() & masked
    labels = torch.where(masked, input_ids, IGNORE_INDEX)
    return torch.where(replaced, mask_token_id, input_ids), labels
