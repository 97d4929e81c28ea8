"""The user scripts of the JAX package's ``scripts/`` directory, ported.

One module per script, under the script's name, with its flags and
defaults; each runs as ``python -m vista_slam_tpu_torch.scripts.<name>``
and has ``main(argv=None)``. The scripts that run a model take
``--device`` (``cuda`` by default, never a silent fall back to the CPU).
OpenCV and matplotlib are imported inside the functions that use them
(``utils.optional.require``), so that a machine without them can still
run the others.
"""

from __future__ import annotations


def script_device(name: str):
    """The torch device a script runs on, with full fp32 in fp32 matmuls and
    convolutions as the port's entry points set it. ``cuda`` without a card
    raises: a script never moves to the CPU unless asked to."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def device_name(dev) -> str:
    import torch

    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)} x{torch.cuda.device_count()}"
    return "cpu"
