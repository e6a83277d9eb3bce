"""TM-DV-IG: N:1 Time-Modulation Dynamic-Voltage input generator (paper §3.2).

Port of ``repro.core.tmdv``.  Behavioral model of the mixed time/voltage
word-line DAC.  A ``2N``-bit input code (a B(X) value from the SH-LUT) is
split::

    code = hi * 2**N + lo
    hi (N bits) -> voltage level  V[hi]   (DAC configured so I[x] = x * I_u)
    lo (N bits) -> pulse width    lo * W_p1

and the charge integrated on the BL cap is linear in the code.  Noise
(Gaussian, per WL event): a relative current-level sigma ``sigma_v`` that
grows with the number of DAC levels, and pulse-edge jitter ``sigma_t`` in
unit-pulse units.  Pure voltage (all bits in voltage), pure PWM (all bits
in time) and TM-DV (N bits each) are points of the same model (Fig. 11);
TD-P / TD-A move the split point.

The reference's PRNG key becomes an explicit ``torch.Generator`` on the
codes' device.  Threefry and Philox draw different numbers, so the two
packages agree in distribution, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from .asp_quant import f32

__all__ = ["TMDVConfig", "TD_A", "TD_P", "PURE_VOLTAGE", "PURE_PWM",
           "apply_input_noise", "wl_latency_units"]


@dataclasses.dataclass(frozen=True)
class TMDVConfig:
    """One TM-DV-IG operating point (paper §3.2).

    ``total_bits`` = 2N in the paper; ``voltage_bits`` = the bits carried
    by the DAC voltage level (the rest ride in the pulse width).
    """

    total_bits: int = 8
    voltage_bits: int = 4
    # Relative sigma of one DAC current level at 16 levels (4-bit) reference.
    sigma_v_ref: float = 0.015
    # Pulse-edge jitter in unit-pulse units.
    sigma_t: float = 0.08

    @property
    def time_bits(self) -> int:
        return self.total_bits - self.voltage_bits

    @property
    def num_levels(self) -> int:
        return 2**self.voltage_bits

    @property
    def sigma_v(self) -> float:
        # Noise margin shrinks linearly with the number of levels packed into
        # the fixed VDD range; 16 levels is the reference point.
        return self.sigma_v_ref * (self.num_levels / 16.0)


def TD_A(total_bits: int = 8) -> TMDVConfig:
    """High-accuracy mode: fewer voltage levels (N_v = total/2 - 1)."""
    return TMDVConfig(total_bits=total_bits,
                      voltage_bits=max(1, total_bits // 2 - 1))


def TD_P(total_bits: int = 8) -> TMDVConfig:
    """High-performance mode: more voltage levels (N_v = total/2 + 1)."""
    return TMDVConfig(total_bits=total_bits,
                      voltage_bits=min(total_bits - 1, total_bits // 2 + 1))


def PURE_VOLTAGE(total_bits: int = 8) -> TMDVConfig:
    return TMDVConfig(total_bits=total_bits, voltage_bits=total_bits)


def PURE_PWM(total_bits: int = 8) -> TMDVConfig:
    return TMDVConfig(total_bits=total_bits, voltage_bits=0)


def wl_latency_units(cfg: TMDVConfig) -> int:
    """WL activation window in unit pulses: the time field must fit."""
    return max(1, 2**cfg.time_bits)


def apply_input_noise(codes: torch.Tensor, cfg: TMDVConfig,
                      generator: torch.Generator) -> torch.Tensor:
    """codes (int, in [0, 2**total_bits - 1]) -> noisy effective charge.

    Returns the f32 "effective code" Q / (I_u * W_p1), whose ideal value is
    the code.  Draws two normals of the codes' shape from ``generator``
    (on the codes' device): the voltage-level noise, then the edge jitter.
    """
    codes = codes.to(torch.float32)
    slots = float(max(1, 2**cfg.time_bits))
    hi = torch.floor(codes / slots)
    lo = codes - hi * slots
    v_noise = 1.0 + f32(cfg.sigma_v) * torch.randn(
        codes.shape, generator=generator, device=codes.device)
    q_v = hi * slots * v_noise
    t_noise = f32(cfg.sigma_t) * torch.randn(
        codes.shape, generator=generator, device=codes.device)
    q_t = torch.where(lo > 0, lo + t_noise, torch.zeros_like(lo))
    return q_v + q_t
