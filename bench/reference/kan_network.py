"""Plain reference of an ASP-quantized KAN network (paper section 3.1).

Written from the paper's datapath, independent of the program: it
imports nothing of ``repro_torch`` or ``repro`` and takes only the float
weights and the input rows the benchmark made.

    per layer:  y_o = sum_f [ w_b[f,o] * relu(x_f) + sum_i c'[f,i,o] B_i(x_f) ]

Post-training quantization: c' and w_b to symmetric int8 codes per
output column (numpy float64, round half to even, clipped to +-127) and
back to float32.  Inputs are coded on the PowerGap grid: ``G * 2**LD``
codes over [lo, hi], ``code = floor((x - lo) / step + 0.5)`` clipped, with
``g = code >> LD`` the knot interval and ``u = code & (2**LD - 1)`` the
offset in it.  The K+1 active bases at a code are one shared table
(the SH-LUT) of the cardinal B-spline b_K at ``u / 2**LD + K - d``, coded
to ``lut_bits`` on the bump's peak.  Between layers the next codes are
taken from ``tanh(y)`` mapped onto [lo, hi].  Everything after the host
quantization is float32 on the inputs' device, with TF32 off.

``mac`` selects the precision of the band MAC: ``"float32"`` (as the
configuration states) or ``"tf32"`` (both operands rounded to TF32's 10
mantissa bits, the control one step below).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def bump(t: float, k: int) -> float:
    """The cardinal B-spline b_k on [0, k+1] by the Cox-de Boor recursion
    (float64)."""
    if k == 0:
        return 1.0 if 0.0 <= t < 1.0 else 0.0
    return (t * bump(t, k - 1) + (k + 1 - t) * bump(t - 1.0, k - 1)) / k


def local_bits(grid: int, n_bits: int) -> int:
    ld = -1
    while grid * 2 ** (ld + 1) <= 2 ** n_bits:
        ld += 1
    return ld


def f32(v: float) -> float:
    return float(np.float32(v))


class LayerSpec:
    def __init__(self, grid: int, order: int, n_bits: int, lut_bits: int,
                 lo: float, hi: float):
        self.grid, self.order, self.lo, self.hi = grid, order, lo, hi
        self.ld = local_bits(grid, n_bits)
        self.per = 2 ** self.ld
        self.num_codes = grid * self.per
        self.step = (hi - lo) / grid / self.per
        qmax = 2 ** lut_bits - 1
        self.lut_scale = bump((order + 1) / 2.0, order) / qmax
        u = np.arange(self.per) / self.per
        table = np.array([[bump(x + order - d, order) for d in range(order + 1)]
                          for x in u])
        lut_q = np.round(table / self.lut_scale)
        self.lut = (lut_q * self.lut_scale).astype(np.float32)

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        q = torch.floor((x - f32(self.lo)) * f32(1.0 / self.step) + 0.5)
        return torch.clamp(q.to(torch.int32), 0, self.num_codes - 1)

    def preround(self, x: torch.Tensor) -> torch.Tensor:
        """The value whose floor is the code (before the clip)."""
        return (x - f32(self.lo)) * f32(1.0 / self.step) + 0.5


def quantize_columns(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric per-output-column codes of ``w`` (last axis = output) in
    float64 on ``w``'s device, returned dequantized in float32:
    ``s = max|w| / qmax``, ``q = clip(round_half_even(w / s), +-qmax)``,
    ``q * float32(s)``."""
    a = w.detach().to(torch.float64)
    qmax = 2 ** (bits - 1) - 1
    red = tuple(range(a.ndim - 1))
    s = torch.clamp_min(a.abs().amax(dim=red), 1e-12) / qmax
    q = torch.clamp(torch.round(a / s), -qmax, qmax)
    return q.to(torch.float32) * s.to(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, round half to even)."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


class KANReference:
    """The quantized network, rebuilt from float weights ``[{"c": (F,
    G+K, O), "w_b": (F, O)}]`` and a config dict."""

    def __init__(self, params, cfg: dict, mac: str = "float32"):
        self.cfg = cfg
        self.mac = mac
        bits = cfg["weight_bits"]
        self.spec = LayerSpec(cfg["grid_size"], cfg["order"], cfg["n_bits"],
                              cfg["lut_bits"], cfg["lo"], cfg["hi"])
        self.layers = [(quantize_columns(p["c"], bits),
                        quantize_columns(p["w_b"], bits)) for p in params]
        dev = self.layers[0][0].device
        self.lut = torch.from_numpy(self.spec.lut).to(dev)

    def _mm(self, a, b):
        if self.mac == "tf32":
            a, b = tf32(a), tf32(b)
        return a @ b

    def layer(self, li: int, codes: torch.Tensor) -> torch.Tensor:
        sp = self.spec
        wc, wb = self.layers[li]
        f, nb, o = wc.shape
        g = (codes >> sp.ld).to(torch.int64)
        vals = self.lut[(codes & (sp.per - 1)).to(torch.int64)]   # (R, F, K+1)
        basis = torch.zeros(codes.shape + (nb,), dtype=torch.float32,
                            device=codes.device)
        basis.scatter_(-1, g[..., None] + torch.arange(sp.order + 1,
                                                       device=codes.device),
                       vals)
        y = self._mm(basis.reshape(-1, f * nb), wc.reshape(f * nb, o))
        xq = f32(sp.lo) + codes.to(torch.float32) * f32(sp.step)
        return y + self._mm(torch.relu(xq), wb)

    def hidden_input(self, y: torch.Tensor) -> torch.Tensor:
        sp = self.spec
        return torch.tanh(y) * f32(0.5 * (sp.hi - sp.lo)) + f32(0.5 * (sp.hi + sp.lo))

    def forward(self, x: torch.Tensor, flips=None):
        """Outputs of rows ``x`` (R, F0) float32.  ``flips`` (one (R, H)
        int tensor per hidden boundary, or None) is added to that
        boundary's codes: the answer the program gives where it rounds a
        near-tie the other way."""
        codes = self.spec.codes(x)
        n = len(self.layers)
        pre = []
        for li in range(n):
            y = self.layer(li, codes)
            if li < n - 1:
                h = self.hidden_input(y)
                pre.append(self.spec.preround(h))
                codes = self.spec.codes(h)
                if flips is not None and flips[li] is not None:
                    codes = torch.clamp(codes + flips[li], 0,
                                        self.spec.num_codes - 1)
        return y, pre


def near_ties(pre: torch.Tensor, tol: float = 1e-4) -> torch.Tensor:
    """Where a pre-round value lies within ``tol`` of an integer: +1 where
    its code could round up instead, -1 where down, 0 elsewhere."""
    frac = pre - torch.floor(pre)
    up = (1 - frac) <= tol
    down = frac <= tol
    return up.to(torch.int32) - down.to(torch.int32)


def compare(ref: KANReference, x: torch.Tensor, y: torch.Tensor) -> dict:
    """Judge the program's outputs ``y`` of rows ``x`` (both float32 on one
    device).  A row's error is the smaller of its distance to the
    reference's outputs and, where a hidden boundary code sits at a
    near-tie (pre-round value within 1e-4 of an integer: the two sides'
    tanh differ in the last bits), its distance to the outputs with that
    code rounded the other way.  Returns the largest absolute error over
    every output and the count of rows whose answer took the other
    rounding."""
    ry, pre = ref.forward(x)
    if y.shape != ry.shape:
        return {"max_abs_err": math.inf, "excused": 0, "rows": int(x.shape[0])}
    err = torch.nan_to_num((y - ry).abs().amax(dim=-1), nan=math.inf)
    flips = [near_ties(p) for p in pre]
    excused = 0
    if any(bool(f.any()) for f in flips):
        fy, _ = ref.forward(x, flips=flips)
        alt = torch.nan_to_num((y - fy).abs().amax(dim=-1), nan=math.inf)
        excused = int((alt < err).sum())
        err = torch.minimum(err, alt)
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "excused": excused, "rows": int(x.shape[0])}


def row_blocks(n: int, block: int):
    for a in range(0, n, block):
        yield a, min(n, a + block)


def judge_answers(ref: KANReference, answers, block: int = 1 << 18) -> dict:
    """``answers``: [(x rows float32 array or tensor, program outputs)]."""
    worst, excused, rows = 0.0, 0, 0
    dev = ref.lut.device
    for x, y in answers:
        x = torch.as_tensor(x).to(dev, torch.float32)
        y = torch.as_tensor(y).to(dev, torch.float32)
        for a, b in row_blocks(x.shape[0], block):
            st = compare(ref, x[a:b], y[a:b])
            worst = max(worst, st["max_abs_err"])
            excused += st["excused"]
            rows += st["rows"]
    return {"max_abs_err": worst, "excused": excused, "rows": rows,
            "answers": len(answers)}

