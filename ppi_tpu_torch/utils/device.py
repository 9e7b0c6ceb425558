"""The device of a run, checked before anything is placed on it."""

import torch


def checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``, with TF32 matmuls and convolutions
    off (f32 everywhere). A CUDA device without a card raises: no entry
    point falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
