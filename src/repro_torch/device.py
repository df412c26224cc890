"""Device selection for the port's entry points.

Every entry point (``algorithm1``, ``classification_dataset``, ``mlp.init``,
``random.PRNGKey``, ...) takes ``device=``. ``None`` means the card: the port
is written for one NVIDIA GPU, and a default that quietly fell back to the
CPU would make every timing taken from it a CPU timing. Tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device=None`` -> ``cuda`` (raises when no card is present);
    anything else is taken as given. On a CUDA device this also pins fp32
    matmuls and convolutions to full fp32: PyTorch would otherwise be free to
    use TF32 (about three decimal digits) in cuDNN, and the JAX reference
    computes in fp32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default, and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        # fp32 matmuls stay fp32: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def given_or_card(device=None) -> torch.device:
    """``device`` as given, or the card when it is None. For helpers that a
    path calls after its entry point has resolved the device: unlike
    ``resolve`` this sets nothing on an explicit device, so a caller's own
    matmul precision (a TF32 control run, say) stands."""
    return resolve(None) if device is None else torch.device(device)
