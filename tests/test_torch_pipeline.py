"""Kernel B1 and the pipeline geometry of the port against the JAX reference.

  * plans: field for field equal on the deploy tests' SHAPES (the port keeps
    the reference's TPU tile heuristics only so that it pads identically);
  * deployed bundles: byte-equal, packed (int4) and unpacked;
  * B1's plain version against the reference ``run_pipeline_layer`` (Pallas
    interpret mode) in every flag combination: outputs within 1e-5 (same
    dense banded product, summed in another order), boundary codes equal up
    to the excused near-ties of ``repro_torch.parity``;
  * packed and unpacked runs bit-identical within the port.

The CUDA kernel itself is held against the plain version in
``test_torch_gpu.py`` (card only).
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kan1_bundle
from repro.core import asp_quant as jq
from repro.core.kan_layer import KANSpec as JKANSpec
from repro.core.kan_layer import init_kan_network as j_init
from repro.core.kan_network_deploy import deploy_kan_ffn_stack as j_deploy_ffn
from repro.core.kan_network_deploy import quantize_kan_network as j_quantize
from repro.kernels.kan_spline import pipeline as jpl
from repro_torch import convert, parity
from repro_torch.core.kan_layer import KANSpec
from repro_torch.core.kan_network_deploy import deploy_kan_ffn_stack, deploy_kan_network
from repro_torch.kernels.kan_spline import pipeline as tpl

torch.set_num_threads(1)

# tests/test_kan_network_deploy.py::SHAPES (dims, grid, batch)
SHAPES = [
    ((17, 1, 14), 5, 33),
    ((17, 1, 14), 68, 7),
    ((3, 2), 4, 1),
    ((5, 9, 3, 2), 8, 130),
    ((40, 77, 13), 16, 19),
]
# residual_raw x packed_w x packed_lut x psum_noise x emit_codes
FLAGS = list(itertools.product((False, True), repeat=5))
FLAG_IDS = ["raw%d-pw%d-plut%d-noise%d-emit%d" % f for f in FLAGS]


def _plan_fields(plan):
    return (plan.b, plan.bp, tuple(
        (dataclasses.asdict(lp.spec),
         None if lp.next_spec is None else dataclasses.asdict(lp.next_spec),
         lp.f, lp.o, lp.fp, lp.op, lp.bb, lp.bo, lp.bf, lp.residual_raw,
         lp.emit_codes)
        for lp in plan.layers))


@pytest.mark.parametrize("residual_raw", [False, True])
@pytest.mark.parametrize("dims,grid,batch", SHAPES + [((17, 1, 14), 5, 640),
                                                     ((64, 128, 64), 8, 65536)])
def test_plans_equal_field_for_field(dims, grid, batch, residual_raw):
    for bits in (8, 4):
        jk = JKANSpec(dims=dims, grid_size=grid, n_bits=bits if grid <= 16 else 8)
        js = jk.layer_specs()
        ts = tuple(convert.spec_from_reference(s) for s in js)
        want = jpl.make_pipeline_plan(batch, dims, js, residual_raw=residual_raw)
        got = tpl.make_pipeline_plan(batch, dims, ts, residual_raw=residual_raw)
        assert _plan_fields(got) == _plan_fields(want)
        tpl.validate_plan(got)


@pytest.mark.parametrize("ov", [(8, 128, 8), ((16, 64, 32), (16, 128, 128)),
                                (12, 128, 8), (8, 96, 8), ((8, 128, 8), (16, 128, 8))],
                         ids=str)
def test_tile_overrides_equal_or_raise_alike(ov):
    js = JKANSpec(dims=(17, 130, 14), grid_size=5).layer_specs()
    ts = tuple(convert.spec_from_reference(s) for s in js)
    try:
        want = jpl.make_pipeline_plan(40, (17, 130, 14), js, tile_overrides=ov)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpl.make_pipeline_plan(40, (17, 130, 14), ts, tile_overrides=ov)
        assert str(got.value) == str(e)
    else:
        got = tpl.make_pipeline_plan(40, (17, 130, 14), ts, tile_overrides=ov)
        assert _plan_fields(got) == _plan_fields(want)


def _assert_bundle_bytes_equal(tdep, jdep):
    assert tdep.dims == tuple(jdep.dims)
    assert _plan_fields(tdep.plan) == _plan_fields(jdep.plan)
    for tl, jl in zip(tdep.layers, jdep.layers):
        assert list(tl) == list(jl)
        for k in jl:
            w = np.asarray(jl[k])
            g = tl[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("bits", [8, (8, 4), (4, 4)], ids=str)
def test_deployed_kan1_bundle_byte_equal(bits):
    """The port deploys the reference's qparams to the same bytes: padded
    f32 banded matrices, int4-packed wcp/wscale and nibble-packed lutp."""
    kspec, qparams, jdep = kan1_bundle(n_bits=bits, batch=16)
    tqp = [convert.qparams_from_numpy({k: np.asarray(v) for k, v in qp.items()},
                                      device="cpu") for qp in qparams]
    tdep = deploy_kan_network(tqp, KANSpec(dims=kspec.dims, grid_size=5,
                                           n_bits=bits), batch=16, device="cpu")
    _assert_bundle_bytes_equal(tdep, jdep)
    _assert_bundle_bytes_equal(convert.deployed_from_reference(jdep, device="cpu"),
                               jdep)


def test_deployed_ffn_stack_byte_equal():
    import jax

    jk = JKANSpec(dims=(20, 33, 20), grid_size=8)
    qparams = j_quantize(j_init(jax.random.PRNGKey(3), jk), jk)
    jdep = j_deploy_ffn(qparams, jk.dims, jk.layer_spec(), batch=13)
    tqp = [convert.qparams_from_numpy({k: np.asarray(v) for k, v in qp.items()},
                                      device="cpu") for qp in qparams]
    tdep = deploy_kan_ffn_stack(tqp, jk.dims, convert.spec_from_reference(
        jk.layer_spec()), batch=13, device="cpu")
    assert tdep.residual_raw
    _assert_bundle_bytes_equal(tdep, jdep)


def test_nibble_codec_roundtrip_and_matches_reference():
    rng = np.random.default_rng(0)
    lo = rng.integers(-8, 8, (37, 5)).astype(np.int32)
    hi = rng.integers(-8, 8, (37, 5)).astype(np.int32)
    p = tpl._pack_nibbles(torch.from_numpy(lo), torch.from_numpy(hi))
    assert p.dtype == torch.int8
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jpl._pack_nibbles(jnp.asarray(lo), jnp.asarray(hi))))
    p32 = p.to(torch.int32)
    np.testing.assert_array_equal(tpl._unpack_lo_nibble(p32).numpy(), lo)
    np.testing.assert_array_equal(tpl._unpack_hi_nibble(p32).numpy(), hi)


def _layer_case(grid, f, o, flags, bp=16, seed=0):
    """One B1 call's operands in numpy, for both packages.

    Weights at the model's init scale (|w| <= 0.3/sqrt(f)) keep outputs
    O(1), so f32 summation-order noise stays ~1e-7 and the code gate's
    1e-4 pre-round window holds.
    """
    raw, pw, plut, noise, emit = flags
    js = jq.ASPQuantSpec(grid_size=grid, lut_bits=4)
    dims = (f, o, 3) if emit else (f, o)
    jlp = jpl.make_pipeline_plan(bp, dims, (js,) * (len(dims) - 1),
                                 residual_raw=raw).layers[0]
    rng = np.random.default_rng(seed)
    nb = js.num_basis
    e = jq.build_lut(js)
    c_q = rng.integers(-7, 8, (f, nb, o)).astype(np.int8)
    c_scale = ((rng.random(o) + 0.5) * 0.3 / np.sqrt(f) / 7).astype(np.float32)
    wb = (rng.normal(size=(f, o)) / np.sqrt(f)).astype(np.float32)
    packed = jpl.pack_layer_weights(jnp.asarray(c_q), jnp.asarray(c_scale),
                                    jnp.asarray(wb), jlp)
    lw = {"lut": np.float32(e["lut_q"]) * np.float32(e["scale"])}
    if plut:
        lw["lutp"] = np.asarray(jpl.pack_lut(jnp.asarray(e["lut_q"]), js))
    if pw:
        lw.update({k: np.asarray(v) for k, v in packed.items()})
    else:
        lw["wc"] = np.asarray(jpl.unpacked_wc(packed, jlp))
        lw["wb"] = np.asarray(packed["wb"])
    codes = rng.integers(0, js.num_codes, (bp, jlp.fp)).astype(np.int32)
    xraw = rng.normal(size=(bp, jlp.fp)).astype(np.float32) if raw else None
    nz = (rng.normal(size=(bp, jlp.op)) * 0.01).astype(np.float32) if noise else None
    return jlp, lw, codes, xraw, nz


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _port_layer(jlp):
    ts = convert.spec_from_reference(jlp.spec)
    nxt = None if jlp.next_spec is None else convert.spec_from_reference(jlp.next_spec)
    return dataclasses.replace(jlp, spec=ts, next_spec=nxt)


def _gate(got, want, lp):
    """Outputs within 1e-5, codes equal up to excused ties."""
    (gy, gc), (wy, wc) = got, want
    assert (gc is None) == (wc is None)
    if wc is None:
        np.testing.assert_allclose(gy, wy, atol=1e-5, rtol=1e-5)
        return 0
    return parity.compare_runs([gc], [wc], [parity.requant_preround(wy, lp.next_spec)],
                               gy, wy)["excused"]


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_b1_plain_matches_reference_kernel(flags):
    jlp, lw, codes, xraw, nz = _layer_case(5, 17, 14, flags)
    jy, jc = jpl.run_pipeline_layer(
        jnp.asarray(codes), None if xraw is None else jnp.asarray(xraw),
        {k: jnp.asarray(v) for k, v in lw.items()}, jlp, 16, interpret=True,
        psum_noise=None if nz is None else jnp.asarray(nz))
    lp = _port_layer(jlp)
    ty, tc = tpl.run_pipeline_layer(_t(codes), _t(xraw),
                                    {k: _t(v) for k, v in lw.items()}, lp, 16,
                                    psum_noise=_t(nz))
    want = (np.asarray(jy), None if jc is None else np.asarray(jc))
    got = (ty.numpy(), None if tc is None else tc.numpy())
    excused = _gate(got, want, lp)
    print(f"excused code positions: {excused}")


@pytest.mark.parametrize("grid,f,o", [(68, 17, 1), (8, 64, 128)])
@pytest.mark.parametrize("flags", [(0, 0, 0, 0, 1), (1, 1, 1, 1, 1),
                                   (0, 1, 0, 0, 0)], ids=str)
def test_b1_plain_matches_reference_kernel_wide(grid, f, o, flags):
    """KAN2's G=68 band (NB=71) and the FFN geometry, for a few flag sets."""
    jlp, lw, codes, xraw, nz = _layer_case(grid, f, o, tuple(map(bool, flags)))
    jy, jc = jpl.run_pipeline_layer(
        jnp.asarray(codes), None if xraw is None else jnp.asarray(xraw),
        {k: jnp.asarray(v) for k, v in lw.items()}, jlp, 16, interpret=True,
        psum_noise=None if nz is None else jnp.asarray(nz))
    lp = _port_layer(jlp)
    ty, tc = tpl.run_pipeline_layer(_t(codes), _t(xraw),
                                    {k: _t(v) for k, v in lw.items()}, lp, 16,
                                    psum_noise=_t(nz))
    _gate((ty.numpy(), None if tc is None else tc.numpy()),
          (np.asarray(jy), None if jc is None else np.asarray(jc)), lp)


@pytest.mark.parametrize("plut", [False, True])
@pytest.mark.parametrize("emit", [False, True])
def test_packed_and_unpacked_bit_identical(plut, emit):
    jlp, lw, codes, xraw, nz = _layer_case(5, 17, 14, (True, True, plut, True, emit))
    lp = _port_layer(jlp)
    packed = {k: _t(v) for k, v in lw.items()}
    unpacked = {"lut": packed["lut"], "wc": tpl.unpacked_wc(packed, lp),
                "wb": packed["wb"]}
    a = tpl.run_pipeline_layer(_t(codes), _t(xraw), packed, lp, 16, psum_noise=_t(nz))
    b = tpl.run_pipeline_layer(_t(codes), _t(xraw), unpacked, lp, 16, psum_noise=_t(nz))
    assert torch.equal(a[0], b[0])
    assert (a[1] is None and b[1] is None) or torch.equal(a[1], b[1])


def test_layer_operands_are_validated():
    jlp, lw, codes, xraw, nz = _layer_case(5, 17, 14, (False,) * 4 + (True,))
    lp = _port_layer(jlp)
    lw = {k: _t(v) for k, v in lw.items()}
    with pytest.raises(ValueError, match="codes"):
        tpl.run_pipeline_layer(_t(codes)[:, :5], None, lw, lp, 16)
    with pytest.raises(ValueError, match="wc"):
        tpl.run_pipeline_layer(_t(codes), None, {**lw, "wc": lw["wc"][:-2]}, lp, 16)


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("grid,f,o,flags", [
    (5, 17, 14, (1, 1, 1, 1, 1)), (8, 64, 128, (1, 0, 0, 1, 1)),
    (68, 17, 1, (0, 0, 0, 0, 1)), (16, 40, 77, (0, 1, 0, 1, 0)),
], ids=str)
def test_b1_plain_feature_splits_match_reference_kernel(splits, grid, f, o,
                                                        flags):
    """The plain version in the kernel's split order (each feature slice
    summed on its own, the slices added in order, then the noise) against
    the reference kernel, under the same gate as one split."""
    jlp, lw, codes, xraw, nz = _layer_case(grid, f, o, tuple(map(bool, flags)),
                                           seed=splits)
    jy, jc = jpl.run_pipeline_layer(
        jnp.asarray(codes), None if xraw is None else jnp.asarray(xraw),
        {k: jnp.asarray(v) for k, v in lw.items()}, jlp, 16, interpret=True,
        psum_noise=None if nz is None else jnp.asarray(nz))
    lp = _port_layer(jlp)
    ty, tc = tpl.run_pipeline_layer_plain(
        _t(codes), _t(xraw), {k: _t(v) for k, v in lw.items()}, lp, 16,
        psum_noise=_t(nz), feature_splits=splits)
    _gate((ty.numpy(), None if tc is None else tc.numpy()),
          (np.asarray(jy), None if jc is None else np.asarray(jc)), lp)


def test_feature_split_plan_is_a_function_of_the_widths_alone():
    """The split count and bounds come from the layer's widths, never from
    the batch: the full-width FFN halves split the same at 8 and 1024 rows,
    the KAN slice's layers do not split, and the bounds tile the features
    in order with the padded tail on the last split."""
    assert tpl.feature_split_plan(5120, 1280) == (20, 256)
    assert tpl.feature_split_plan(1280, 5120) == (5, 256)
    js = jq.ASPQuantSpec(grid_size=8)
    ts = convert.spec_from_reference(js)
    by_bp = {}
    for bp in (8, 1024):
        plan = tpl.make_pipeline_plan(bp, (5120, 1280, 5120), (ts, ts),
                                      residual_raw=True)
        by_bp[bp] = [tpl.feature_split_plan(lp.f, lp.o) for lp in plan.layers]
    assert by_bp[8] == by_bp[1024] == [(20, 256), (5, 256)]
    for dims in ((17, 1, 14), (64, 128, 64), (128, 64)):
        for f, o in zip(dims[:-1], dims[1:]):
            assert tpl.feature_split_plan(f, o) == (1, f)
    assert tpl.feature_split_bounds(5120, 5120, 20) == [
        (lo, lo + 256) for lo in range(0, 5120, 256)]
    assert tpl.feature_split_bounds(17, 32, 5) == [(0, 4), (4, 8), (8, 12),
                                                   (12, 16), (16, 32)]
    assert tpl.feature_split_bounds(17, 32, 1) == [(0, 32)]


@pytest.mark.parametrize("splits", [2, 5])
def test_b3_plain_feature_splits_match_reference(splits):
    """kan_spline_ref summed in split order against the reference's."""
    from repro.kernels.kan_spline.ref import kan_spline_ref as j_ref
    from repro_torch.kernels.kan_spline.ref import kan_spline_ref

    js = jq.ASPQuantSpec(grid_size=8)
    ts = convert.spec_from_reference(js)
    rng = np.random.default_rng(splits)
    e = jq.build_lut(js)
    lut = (np.float32(e["lut_q"]) * np.float32(e["scale"]))
    codes = rng.integers(0, js.num_codes, (9, 30)).astype(np.int32)
    wc = (rng.normal(size=(30, js.num_basis, 7)) * 0.05).astype(np.float32)
    wb = (rng.normal(size=(30, 7)) * 0.2).astype(np.float32)
    want = np.asarray(j_ref(jnp.asarray(codes), jnp.asarray(lut),
                            jnp.asarray(wc), jnp.asarray(wb), js))
    got = kan_spline_ref(_t(codes), _t(lut), _t(wc), _t(wb), ts,
                         feature_splits=splits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
