"""The port's one device rule.

Every entry point of :mod:`pyabc_tpu_torch` runs on the card unless the
caller asks for the CPU: :func:`resolve_device` with no argument returns
``cuda`` and raises when no card is present.  ``device="cpu"`` must be
passed explicitly (the CPU tests do); there is no environment switch.

Float32 matrix products and convolutions are pinned to full float32 here
(``allow_tf32 = False`` for both cuBLAS and cuDNN): the KDE whitening and
the covariance math feed ``exp``, where TF32's ~3 decimal digits would
show up as weight error.  PyTorch already defaults the matmul flag to
False; setting both makes the choice explicit and independent of the
caller's global state at import.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card.

    Raises ``RuntimeError`` when a CUDA device is requested (explicitly or
    by default) and none is available — the port never falls back to the
    CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyabc_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def device_of(generator: torch.Generator) -> torch.device:
    """The device a generator draws on (tensors it fills live there)."""
    return torch.device(generator.device)


#: the capture pre-screen open on each thread (``autotune.ladder``)
_SCREEN = threading.local()


def note_uncapturable(reason: str) -> None:
    """Called by port code that does work a CUDA graph cannot hold and
    no call shows (making generators from a generator's host state): a
    capture pre-screen open on this thread refuses the call.  Other
    threads' screens never see it."""
    marks = getattr(_SCREEN, "marks", None)
    if marks is not None:
        marks.append(reason)


@contextmanager
def capture_screen():
    """Collect this thread's :func:`note_uncapturable` reasons (a list)
    while the block runs."""
    outer = getattr(_SCREEN, "marks", None)
    _SCREEN.marks = marks = []
    try:
        yield marks
    finally:
        _SCREEN.marks = outer
        if outer is not None:
            outer.extend(marks)
