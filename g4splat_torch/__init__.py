"""g4splat_torch: the G4Splat surfel pipeline in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `g4splat_tpu` (JAX/Pallas), kept beside it; module layout and names
follow that package so each function has a findable counterpart. Entry points
place their tensors on ``cuda`` unless the caller passes ``device="cpu"``.
Kernels are compiled from ``g4splat_torch/csrc`` at first use, never at import.
"""

from g4splat_torch.device import resolve_device

__all__ = ["resolve_device"]
