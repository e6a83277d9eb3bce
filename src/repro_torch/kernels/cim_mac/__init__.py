"""Kernel B4: the ACIM simulator MAC (IR-drop, mean compensation, ADC).

:mod:`.ops` is the entry point on flat (B, R) x (R, C) operands, which
computes each array's column load and ADC range;
:mod:`.kernel` launches the hand-written CUDA kernel on CUDA tensors (the
plain version on CPU tensors); :mod:`.ref` is the plain PyTorch version;
:mod:`.cardcheck` holds the kernel against it on the card.
"""

from .kernel import cim_mac_arrays
from .ops import cim_mac
from .ref import cim_mac_plain

__all__ = ["cim_mac", "cim_mac_arrays", "cim_mac_plain"]
