"""Device resolution for the port's entry points.

Every entry point takes ``device=``.  ``None`` means the GPU: the port runs
on ``cuda`` unless the caller asks for the CPU by name, and it never falls
back to the CPU on its own.
"""

import torch


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises without a GPU); anything else is
    passed to ``torch.device`` as given.  A CUDA device comes back with
    its index (``cuda`` -> ``cuda:0``), so it compares equal to the device
    of the tensors made on it and a mechanism already there is not copied
    again (``GasMechanism.to`` keeps it, and with it the identity that the
    sweep's cached callables and graphs are keyed by)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
