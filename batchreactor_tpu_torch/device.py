"""Device resolution for the port's entry points.

Every entry point takes ``device=``.  ``None`` means the GPU: the port runs
on ``cuda`` unless the caller asks for the CPU by name, and it never falls
back to the CPU on its own.
"""

import torch


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises without a GPU); anything else is
    passed to ``torch.device`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
