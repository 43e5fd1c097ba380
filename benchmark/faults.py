"""Faults planted in the timed path, for the readings that show the
comparison fails them (the CPU tests at a tiny size; ``run.py --fault`` on
the card at a cell's own size).  Each takes ``setattr(owner, name, value)``,
a monkeypatch's or ``Patch``'s, and breaks the program underneath:

  * ``state_unchanged``: the optimizer step leaves the parameters and the
    optimizer state as they were;
  * ``half_batch``: the loss is the mean over the first half of each
    micro-batch, the rest left out;
  * ``altered_token``: the DiT's velocity of the first image token of each
    row is shifted by 4 where it is produced (a token of garbage);
  * ``altered_frame``: the video loader's frames have a corner of 8 x 8
    pixels inverted where they are decoded (video cells only, ``MODES``).

One card runs each cell, so no fault of an exchange between cards applies.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


def state_unchanged(setattr_):
    from genhancer_tpu_torch.train import step_utils

    def apply_nothing(state, grads, optimizer, loss=None):
        return torch.zeros((), device=loss.device if loss is not None else None), loss
    setattr_(step_utils, "apply_gradients", apply_nothing)


def half_batch(setattr_):
    from genhancer_tpu_torch.train import flow
    orig = flow.mse_loss

    def half(pred, target, mask=None, tokens=None):
        n = pred.shape[0] // 2
        return orig(pred[:n], target[:n], None if mask is None else mask[:n], tokens)
    setattr_(flow, "mse_loss", half)


def altered_token(setattr_):
    from genhancer_tpu_torch.models import dit
    orig = dit.dit_forward

    def altered(*a, **kw):
        out = orig(*a, **kw)
        return torch.cat([out[:, :1] + 4.0, out[:, 1:]], 1)
    setattr_(dit, "dit_forward", altered)


def altered_frame(setattr_):
    from genhancer_tpu_torch.data import video
    orig = video.video_frame_transform

    def altered(*a, **kw):
        out = orig(*a, **kw).copy()
        out[:8, :8] = 1.0 - out[:8, :8]
        return out
    setattr_(video, "video_frame_transform", altered)


FAULTS: Dict[str, Callable] = {"state_unchanged": state_unchanged, "half_batch": half_batch,
                               "altered_token": altered_token, "altered_frame": altered_frame}
# the modes ("image", "video") whose path a fault breaks, where not both
MODES: Dict[str, Tuple[str, ...]] = {"altered_frame": ("video",)}


class Patch:
    """``setattr`` that remembers the originals; ``undo`` restores them."""

    def __init__(self):
        self._saved: List[Tuple[object, str, object]] = []

    def __call__(self, owner, name, value):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        for owner, name, value in reversed(self._saved):
            setattr(owner, name, value)
        self._saved.clear()
