"""The device rule of the port's entry points: they run on the GPU unless
the caller asks for the CPU, and they raise rather than fall back when no GPU
is present."""

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def full_f32_products():
    """Run float32 products and convolutions in full float32, not TF32.

    The f32 parts of the step (augmentation operators, projection head, loss,
    K1's plain version) are small, and TF32's 10-bit mantissa would put ~1e-3
    errors into the comparisons of each kernel with its plain version. The
    backbone runs in the compute dtype (bf16 on the GPU), which these flags do
    not touch. Called by the entry points that build and run a step, not at
    import, so that importing the port changes no backend state.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
