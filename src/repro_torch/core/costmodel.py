"""22nm-calibrated analytical area/energy/latency model (Figs. 10, 11, 13).

Port of ``repro.core.costmodel``: the same formulas and constants, line for
line, on the port's ``asp_quant`` and ``tmdv`` specs, so every function
returns the same float as the reference for the same arguments.

Structure comes from component counts (LUT bits, decoder lines, TG throws,
DAC cells, delay stages, RRAM cells, ADCs, WL buffers); the handful of unit
constants are calibrated so the three paper tables are reproduced.  Areas in
um^2, energy in pJ, power in uW (normalized), latency in ns.

Scaling laws implemented (the actual contribution being validated):

* Conventional B(X) path (PACT-style): every one of the G+K basis functions
  needs its OWN programmable LUT (2**n entries), 8-bit decoder, 2**n:1
  TG-MUX  ->  area grows ~ (G+K) * 2**n.
* ASP B(X) path: ONE hemi-folded shared LUT ((K+1)*2**LD/2 entries),
  split (n-LD)/LD-bit decoders, (K+1) L:1 MUXes + (K+1) 1:G DEMUXes
  ->  area grows ~ G (demux) + 2**(n-LD) (global decoder), with the LUT
  *shrinking* as G grows at fixed n.
* Input generators: pure-voltage DAC area/power ~ levels (power ~ 4**bits to
  hold noise margin), pure-PWM latency ~ 2**bits, TM-DV N:1 splits the bits.
* Accelerator totals: RRAM cells = #params; WL buffers per row; shared
  IG blocks and ADC banks fire per array phase; phases = sum over layers of
  row-tiles x col-tiles.
"""

from __future__ import annotations

import dataclasses
import math

from .asp_quant import ASPQuantSpec
from .tmdv import TMDVConfig, wl_latency_units

# ----------------------------------------------------------------------------
# Unit constants (22 nm).  Calibrated once against the paper's tables; see
# benchmarks/fig*.py for the side-by-side numbers.
# ----------------------------------------------------------------------------

A_LUT_BIT = 0.6      # programmable LUT bit incl. periphery share (um^2)
A_DEC_LINE = 0.9     # decoder area per output line
A_TG = 0.5           # transmission gate (mux/demux throw)
A_DAC_CELL = 1.0     # current-steering DAC unit cell
A_DELAY_STAGE = 0.404
A_TCM = 11.6         # PM-TCM control block
A_IG_BUF = 20.0      # shared input-generator buffer block (WL drive)
A_WL_BUF = 2.0       # per-word-line buffer
A_RRAM_CELL = 0.12   # 1T1R cell
A_ADC = 640.0        # 8-bit SAR ADC slice per BL; area doubles per extra bit
A_BX_FIXED = 1068.0  # B(X)->IG transmission block (regs, routing, FSM)
A_DIG_LAYER = 1500.0 # per-layer digital (accum, shift-add, ctrl)

P_DAC_UNIT = 0.003   # DAC static power ~ P_DAC_UNIT * 4**bits (noise margin)
P_DELAY_STAGE = 0.001
P_TCM = 0.421
P_IG_BUF = 0.45

E_LUT_BIT_READ = 0.004   # pJ per bit read
E_DEC_LINE = 0.0015      # pJ per decoder line switched
E_TG = 0.001             # pJ per TG toggled
E_LEAK_AREA = 0.00028    # pJ per um^2 per lookup window (leakage share)
E_BX_FIXED = 3.3         # transmission block per lookup
E_MAC_CELL = 0.01        # pJ per RRAM cell MAC
E_ADC = 2.0              # pJ per ADC conversion
E_IG_PWM_SHARED = 300.0  # shared PWM gen blocks per phase (8-bit)
E_IG_PWM_WL = 6.6        # per-WL PWM drive energy (8-bit full-scale)
E_IG_TMDV_SHARED = 30.0  # shared TM-DV blocks per phase
E_IG_TMDV_WL = 0.1       # per-WL TM-DV drive energy per 16-unit window
E_DIG_LAYER = 15.0       # per-layer digital

T_UNIT_PULSE = 3.0       # ns, unit WL pulse
T_ADC = 50.0             # ns, ADC conversion
T_DIG_LAYER = 185.0      # ns, per-layer digital pipeline (incl. B(X) path)
T_DEC_LINE = 0.0105      # ns per global-decoder output line (B(X) retrieval)

ARRAY_ROWS_DEFAULT = 128
ARRAY_COLS = 128


# ----------------------------------------------------------------------------
# Fig. 10 — B(X) lookup path, conventional vs ASP
# ----------------------------------------------------------------------------


def bx_path_conventional(spec: ASPQuantSpec) -> dict:
    """Per-input-feature B(X) path with misaligned (PACT) quantization."""
    nb = spec.num_basis
    n = spec.n_bits
    lut_bits = (2**n) * spec.lut_bits          # per B_i
    area = nb * (
        lut_bits * A_LUT_BIT + (2**n) * A_DEC_LINE + (2**n) * A_TG
    ) + A_BX_FIXED
    # per lookup: only the K+1 ACTIVE B_i fire (decoder+mux+row read each),
    # but leakage is paid on the whole instantiated area.
    active = spec.order + 1
    energy = (
        active
        * (
            spec.lut_bits * E_LUT_BIT_READ
            + (2**n) * E_DEC_LINE
            + (2**n) * E_TG
        )
        + E_LEAK_AREA * area
        + E_BX_FIXED
    )
    return {"area_um2": area, "energy_pj": energy}


def bx_path_asp(spec: ASPQuantSpec) -> dict:
    """Per-input-feature B(X) path with ASP-KAN-HAQ (SH-LUT + split decode)."""
    K = spec.order
    ld = spec.ld
    g = spec.grid_size
    n = spec.n_bits
    hemi_entries = (K + 1) * 2**ld // 2 + 1
    area = (
        hemi_entries * spec.lut_bits * A_LUT_BIT
        + (2 ** (n - ld)) * A_DEC_LINE      # global decoder
        + (2**ld) * A_DEC_LINE              # local decoder
        + (K + 1) * (2**ld) * A_TG          # L:1 muxes
        + (K + 1) * g * A_TG                # 1:G demuxes
        + A_BX_FIXED
    )
    # one hemi-row read yields all K+1 active values
    energy = (
        (K + 1) * spec.lut_bits * E_LUT_BIT_READ
        + (2 ** (n - ld)) * E_DEC_LINE
        + (2**ld) * E_DEC_LINE
        + ((K + 1) * (2**ld) + (K + 1) * g) * E_TG
        + E_LEAK_AREA * area
        + E_BX_FIXED
    )
    return {"area_um2": area, "energy_pj": energy}


def bx_retrieval_latency_ns(spec: ASPQuantSpec) -> float:
    """ASP B(X) retrieval pipeline latency (global decoder dominates)."""
    return T_DEC_LINE * (2 ** (spec.n_bits - spec.ld))


# ----------------------------------------------------------------------------
# Fig. 11 — WL input generators
# ----------------------------------------------------------------------------


def input_generator_cost(cfg: TMDVConfig) -> dict:
    """Area/power/latency/FOM of one WL input-generator slice.

    pure voltage: voltage_bits == total_bits; pure PWM: voltage_bits == 0.
    FOM = 1 / (area * power * latency), reported normalized by caller.
    """
    vb, tb = cfg.voltage_bits, cfg.time_bits
    area = A_IG_BUF
    power = P_IG_BUF
    if vb > 0:
        area += A_DAC_CELL * 2**vb
        power += P_DAC_UNIT * 4**vb
    if tb > 0:
        area += A_DELAY_STAGE * 2**tb
        power += P_DELAY_STAGE * 2**tb
    if vb > 0 and tb > 0:
        area += A_TCM
        power += P_TCM
    latency = wl_latency_units(cfg) * T_UNIT_PULSE
    fom = 1.0 / (area * power * latency)
    return {"area_um2": area, "power_uw": power, "latency_ns": latency, "fom": fom}


# ----------------------------------------------------------------------------
# Fig. 13 — whole-accelerator model
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerGeom:
    rows: int            # word lines (MLP: in_dim; KAN: in_dim*(G+K) + in_dim)
    cols: int            # bit lines (out_dim)
    cells: int           # programmed cells (= params of this layer)
    cell_bits: int = 8   # weight width stored per crosspoint; <8-bit layers
                         # pack narrower conductance stacks, so their cell
                         # area/energy footprint scales by cell_bits/8


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    layers: tuple                 # tuple[LayerGeom, ...]
    input_gen: TMDVConfig         # WL input method
    array_rows: int = ARRAY_ROWS_DEFAULT
    adc_bits: int = 8             # partial-sum ADC resolution
    bx_spec: ASPQuantSpec | None = None  # None -> MLP (no B(X) path)
    bx_features: int = 0          # input features needing a B(X) path slice


def _phases(spec: AcceleratorSpec) -> int:
    """Sequential array activations: row-tiles x col-tiles per layer."""
    total = 0
    for l in spec.layers:
        total += math.ceil(l.rows / spec.array_rows) * math.ceil(l.cols / ARRAY_COLS)
    return total


def accelerator_cost(spec: AcceleratorSpec) -> dict:
    nl = len(spec.layers)
    # physical rows are padded to whole arrays; columns are laid out as-is
    padded_rows = [
        math.ceil(l.rows / spec.array_rows) * spec.array_rows for l in spec.layers
    ]
    rows_total = sum(padded_rows)
    # bit-dependent cell footprint: a layer stored at cell_bits < 8 programs
    # proportionally fewer conductance levels per crosspoint (int4 packing
    # halves the at-rest cell demand), shrinking both the allocated array
    # area and the per-MAC cell energy.  cell_bits == 8 everywhere degrades
    # to the original integer counts exactly.
    cells_alloc = sum(pr * l.cols * (l.cell_bits / 8.0)
                      for pr, l in zip(padded_rows, spec.layers))
    cells_prog = sum(l.cells * (l.cell_bits / 8.0) for l in spec.layers)
    phases = _phases(spec)
    adc_area_unit = A_ADC * 2 ** (spec.adc_bits - 8)
    # per-WL drive energy scales with the WL activation window
    pwm_like = spec.input_gen.voltage_bits == 0
    wl_scale = wl_latency_units(spec.input_gen) / (256.0 if pwm_like else 16.0)

    # --- area
    area = cells_alloc * A_RRAM_CELL
    area += rows_total * A_WL_BUF
    ig = input_generator_cost(spec.input_gen)
    area += ig["area_um2"] * nl  # shared IG blocks, one slice per layer
    adc_count = sum(l.cols for l in spec.layers)  # pitch-matched SAR per BL
    area += adc_count * adc_area_unit
    area += nl * A_DIG_LAYER
    bx_lat = 0.0
    if spec.bx_spec is not None:
        bx = bx_path_asp(spec.bx_spec)
        area += bx["area_um2"]  # shared across features (time-multiplexed)
        bx_lat = bx_retrieval_latency_ns(spec.bx_spec)

    # --- latency (ADC conversion time scales with resolution)
    t_adc = T_ADC * spec.adc_bits / 8.0
    t_phase = wl_latency_units(spec.input_gen) * T_UNIT_PULSE + t_adc
    latency = phases * t_phase + nl * (T_DIG_LAYER + bx_lat)

    # --- energy
    e_sh = E_IG_PWM_SHARED if pwm_like else E_IG_TMDV_SHARED
    e_wl = (E_IG_PWM_WL if pwm_like else E_IG_TMDV_WL) * wl_scale
    active_rows = sum(l.rows for l in spec.layers)
    energy = phases * e_sh + active_rows * e_wl
    energy += cells_prog * E_MAC_CELL
    e_adc = E_ADC * 2 ** ((spec.adc_bits - 8) / 2)  # SAR energy ~ 2^(b/2)
    for l in spec.layers:
        energy += (
            min(l.cols, ARRAY_COLS)
            * e_adc
            * math.ceil(l.rows / spec.array_rows)
            * math.ceil(l.cols / ARRAY_COLS)
        )
    energy += nl * E_DIG_LAYER
    if spec.bx_spec is not None:
        energy += spec.bx_features * bx_path_asp(spec.bx_spec)["energy_pj"]

    return {
        "area_mm2": area / 1e6,
        "energy_pj": energy,
        "latency_ns": latency,
        "phases": phases,
    }


def mlp_accelerator(dims, input_gen: TMDVConfig) -> AcceleratorSpec:
    layers = tuple(
        LayerGeom(rows=i, cols=o, cells=i * o + o)
        for i, o in zip(dims[:-1], dims[1:])
    )
    return AcceleratorSpec(layers=layers, input_gen=input_gen)


def kan_accelerator(
    dims,
    spec: ASPQuantSpec,
    input_gen: TMDVConfig,
    array_rows: int = ARRAY_ROWS_DEFAULT,
    adc_bits: int = 8,
    layer_bits: tuple = (),
) -> AcceleratorSpec:
    """``layer_bits``: per-layer weight widths (mixed precision); ``()``
    costs every layer at the spec's uniform ``n_bits``."""
    nb = spec.num_basis
    bits = tuple(layer_bits) if layer_bits \
        else (spec.n_bits,) * (len(dims) - 1)
    if len(bits) != len(dims) - 1:
        raise ValueError(
            f"layer_bits {layer_bits} vs {len(dims) - 1} layers")
    layers = tuple(
        LayerGeom(rows=i * nb + i, cols=o, cells=i * nb * o + i * o,
                  cell_bits=min(8, int(b)))
        for i, o, b in zip(dims[:-1], dims[1:], bits)
    )
    return AcceleratorSpec(
        layers=layers,
        input_gen=input_gen,
        array_rows=array_rows,
        adc_bits=adc_bits,
        bx_spec=spec,
        bx_features=max(dims[:-1]),
    )
