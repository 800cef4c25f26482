"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model and serving path.

The JAX package `ray_tpu` is the reference; this package mirrors its
layout (`models/`, `ops/`, `serve/`, `train/`, `util/`) and never
imports it or JAX.  Plain
tensor code is PyTorch; every Pallas TPU kernel on the ported path is a
CUDA kernel written by hand for Hopper (`csrc/`), built with nvcc at
first use (`ops/_build.py`) and held against a plain PyTorch version of
the same function in the same module.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; with no CUDA device present, any other request raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default)
    and no CUDA device is present: the port never carries on silently on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev

