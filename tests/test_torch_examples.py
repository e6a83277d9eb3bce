"""The port's examples (``repro_torch.examples``): quickstart and knot_e2e
against the reference's library calls in the example's order, at smoke
sizes, on weights carried through numpy (Pallas in interpret mode).
``tests/test_torch_examples_codesign.py`` holds neurosim_search and
tune_deploy, ``tests/test_torch_examples_lm.py`` lm_kan_train and
serve_demo.

  * quickstart: the float output within 1e-5 (+1e-5 relative) of the
    reference's; the quantized, kernel and fused outputs against the
    reference's same path under ``repro_torch.parity``'s gate (boundary
    codes equal except at excused ties, outputs within 1e-5 + 1e-5
    relative); within the port, the kernel and fused paths against the
    quantized one under the same gate; the SH-LUT's stored entry count is
    the reference's and ``(K+1) * 2**LD // 2 + 1``;
  * knot_e2e: software accuracy of the twin's trained network, carried to
    the reference, by ``test_torch_neurosim.py``'s rule (the rows whose
    predictions differ are near-ties, top-2 margin below 1e-3), the same
    rule for a quiet (deterministic) ACIM macro under both placements; the
    cost dict equal to the reference's to 1e-12 relative; the cosine
    schedule's quotient bit-equal to the reference's and its value within
    one f32 ulp at the first, middle and last step (``cos`` of another
    library);
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import neurosim as jns
from repro.core.asp_quant import ASPQuantSpec as JSpec
from repro.core.asp_quant import quantize_input as j_quantize_input
from repro.core.cim import CIMConfig as JCIMConfig
from repro.core.costmodel import accelerator_cost as j_cost
from repro.core.costmodel import kan_accelerator as j_kan_acc
from repro.core.kan_layer import KANSpec as JKANSpec
from repro.core.kan_layer import init_kan_network as j_init
from repro.core.kan_layer import kan_network_apply as j_apply
from repro.core.kan_layer import quantize_kan_layer as j_quantize_layer
from repro.core.kan_network_deploy import deploy_kan_network as j_deploy
from repro.core.tmdv import TMDVConfig as JTMDV
from repro.kernels.kan_spline.ops import kan_spline_from_qparams as j_spline
from repro.runtime.executor import _entry_codes as j_entry_codes
from repro_torch import convert, parity, runtime
from repro_torch.core import neurosim as tns
from repro_torch.core.cim import CIMConfig
from repro_torch.core.kan_network_deploy import deploy_kan_network
from repro_torch.data.knot import make_knot_dataset
from repro_torch.examples import knot_e2e, quickstart

torch.set_num_threads(1)

TIE_MARGIN = 1e-3  # top-2 logit margin under which a row counts as a tie
quiet = lambda *_: None  # noqa: E731


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ----------------------------------------------------------------------------
# quickstart
# ----------------------------------------------------------------------------


def _reference_quickstart():
    """The reference quickstart's four outputs, its boundary codes per path
    and its weights (its own key for both the weights and the batch)."""
    jk = JKANSpec(dims=(17, 1, 14), grid_size=5, n_bits=8)
    spec = jk.layer_spec()
    key = jax.random.PRNGKey(0)
    params = j_init(key, jk)
    x = jax.random.uniform(key, (8, 17), minval=-1.0, maxval=1.0)
    qparams = [j_quantize_layer(p, spec) for p in params]
    out = {"params": params, "x": x, "kspec": jk}
    out["y_float"] = j_apply(params, x, jk)
    out["y_quant"] = j_apply(None, x, jk, quantized=True, qparams_list=qparams)
    h, codes = x, []
    for qp in qparams:
        c = j_quantize_input(h, spec)
        codes.append(c)
        h = j_spline(c, qp, spec, interpret=True)
        if qp is not qparams[-1]:
            h = jnp.tanh(h)
    out["y_kernel"], out["kernel_codes"] = h, codes[1:]
    out["y_fused"] = j_apply(None, x, jk, quantized=True, qparams_list=qparams,
                             backend="pallas", interpret=True)
    jdep = j_deploy(qparams, jk, batch=8)
    _, out["quant_codes"] = jrt.execute(jdep, x, backend="ref",
                                        return_intermediates=True)
    _, out["fused_codes"] = jrt.execute(jdep, x, backend="pallas",
                                        interpret=True,
                                        return_intermediates=True)
    out["entry"], _ = j_entry_codes(jdep, x, None)
    out["hemi"] = len(j_quantize_layer(params[0], spec)["hemi"])
    return out


def test_quickstart_matches_the_reference_on_carried_weights():
    ref = _reference_quickstart()
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, ref["params"]),
                                   device="cpu")
    out = quickstart.run(params=tp, x=np.asarray(ref["x"]), device="cpu",
                         log=quiet)
    np.testing.assert_allclose(_np(out["y_float"]), np.asarray(ref["y_float"]),
                               atol=1e-5, rtol=1e-5)
    tdep = deploy_kan_network(out["qparams"], out["kspec"], batch=8,
                              device="cpu")
    port_codes = {
        "quant": runtime.execute(tdep, out["x"], backend="ref",
                                 return_intermediates=True)[1],
        "kernel": out["kernel_codes"][1:],
        "fused": runtime.execute(tdep, out["x"], backend="fused",
                                 return_intermediates=True)[1],
    }
    for path in ("quant", "kernel", "fused"):
        want = [torch.tensor(np.asarray(c)) for c in ref[f"{path}_codes"]]
        pre = parity.boundary_prerounds(
            tdep, torch.tensor(np.asarray(ref["entry"])), None, want)
        parity.compare_runs(port_codes[path], want, pre, out[f"y_{path}"],
                            np.asarray(ref[f"y_{path}"]))
    within = quickstart.parity_gate(out)
    assert within["kernel"]["rows"] == within["fused"]["rows"] == 8
    spec = out["spec"]
    assert out["sh_lut"]["stored"] == ref["hemi"] \
        == (spec.order + 1) * 2**spec.ld // 2 + 1


@pytest.mark.parametrize("name,argv,want", [
    ("quickstart", [], "SH-LUT: 65 stored entries"),
    ("knot_e2e", ["--fast"], "ACIM accuracy (KAN-SAM):"),
], ids=["quickstart", "knot_e2e"])
def test_example_main_runs_on_the_cpu(capsys, name, argv, want):
    """Each CLI at its own flags (knot_e2e with the example's noisy ACIM
    macro) names the device it ran on."""
    mod = {"quickstart": quickstart, "knot_e2e": knot_e2e}[name]
    mod.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert want in text and " on cpu" in text, text[-2000:]


# ----------------------------------------------------------------------------
# knot_e2e
# ----------------------------------------------------------------------------

QUIET_CIM = dict(array_rows=128, adc_bits=8, ir_gamma=0.06, deterministic=True)
KNOT = dict(n=2048, n_val=1024, epochs=40)


@pytest.fixture(scope="module")
def knot_run():
    """The twin at a smoke size, its ACIM macro made quiet (no noise)."""
    out = knot_e2e.run(**KNOT, cim=CIMConfig(**QUIET_CIM), device="cpu",
                       log=quiet)
    xt, yt, xv, yv = make_knot_dataset(KNOT["n"], KNOT["n_val"], seed=0,
                                       label_noise=0.04)
    jp = jax.tree.map(jnp.asarray, [{k: _np(v) for k, v in p.items()}
                                    for p in out["params"]])
    return out, jp, (xt, yt, xv, yv)


def _near_ties(logits: torch.Tensor) -> int:
    top2 = torch.topk(logits, 2, dim=-1).values
    return int(((top2[:, 0] - top2[:, 1]) < TIE_MARGIN).sum())


def test_knot_software_accuracy_matches_the_reference(knot_run):
    out, jp, (_, _, xv, yv) = knot_run
    jk = JKANSpec(dims=(17, 1, 14), grid_size=5)
    with torch.no_grad():
        logits = tns.kan_network_apply(out["params"], torch.from_numpy(xv),
                                       out["kspec"])
    pred = logits.argmax(-1).numpy()
    differ = round(len(yv) * (1.0 - jns.evaluate_accuracy(jp, xv, pred, jk)))
    assert differ <= _near_ties(logits)
    assert abs(out["sw_acc"] - jns.evaluate_accuracy(jp, xv, yv, jk)) \
        * len(yv) <= differ + 1e-6
    assert out["sw_acc"] > 1.0 / 14 + 0.1, out["sw_acc"]


@pytest.mark.parametrize("sam", [False, True], ids=["baseline", "kan_sam"])
def test_knot_quiet_acim_accuracy_matches_the_reference(knot_run, sam):
    out, jp, (xt, _, xv, yv) = knot_run
    jk = JKANSpec(dims=(17, 1, 14), grid_size=5)
    calib = xt[:2048]  # the example's KAN-SAM calibration rows
    logits = tns.cim_network_apply(out["params"], xv, out["kspec"],
                                   CIMConfig(**QUIET_CIM), None, use_sam=sam,
                                   calib_x=calib)
    pred = logits.argmax(-1).numpy()
    ta = out["acim_acc"]["kan_sam" if sam else "baseline"]
    assert ta == float((pred == yv).mean())
    jc, key = JCIMConfig(**QUIET_CIM), jax.random.PRNGKey(7)
    ja = jns.evaluate_accuracy_cim(jp, xv, yv, jk, jc, key, use_sam=sam,
                                   calib_x=calib)
    agree = jns.evaluate_accuracy_cim(jp, xv, pred, jk, jc, key, use_sam=sam,
                                      calib_x=calib)
    differ = round(len(yv) * (1.0 - agree))
    assert differ <= _near_ties(logits), (differ, _near_ties(logits))
    assert abs(ta - ja) * len(yv) <= differ + 1e-6, (ta, ja, differ)


def test_knot_cost_matches_the_reference(knot_run):
    out, _, _ = knot_run
    spec = JSpec(grid_size=5, order=3, n_bits=8, lut_bits=8, lo=-1.0, hi=1.0)
    want = j_cost(j_kan_acc((17, 1, 14), spec, JTMDV(8, 4), 128, adc_bits=8))
    assert set(out["cost"]) == set(want)
    for k, v in want.items():
        assert math.isclose(out["cost"][k], v, rel_tol=1e-12), (k, v)


def test_knot_schedule_matches_the_reference():
    """The example's fast schedule (60 epochs x 4 steps): the clamped
    quotient is bit-equal; ``cos`` differs by an ulp between the two
    libraries, so the rate is held within one f32 ulp."""
    steps = 60 * (8192 // 2048)

    def jsched(step):  # examples/knot_e2e.py's schedule
        t = jnp.minimum(step / (0.9 * steps), 1.0)
        return 1.5e-2 * 0.95 * (0.5 * (1 + jnp.cos(jnp.pi * t))) + 1e-3

    sched = knot_e2e.cosine_schedule(steps)
    for step in (0, steps // 2, steps):
        jt = np.float32(jnp.minimum(jnp.int32(step) / (0.9 * steps), 1.0))
        st = torch.tensor(step, dtype=torch.int32)
        tt = torch.clamp(st.float() / torch.tensor(0.9 * steps), max=1.0)
        assert np.float32(tt.item()) == jt, step
        got = np.float32(sched(st).item())
        want = np.float32(jsched(jnp.int32(step)))
        assert abs(got - want) <= np.spacing(want), (step, got, want)
    assert float(sched(torch.tensor(0, dtype=torch.int32))) == \
        float(jsched(jnp.int32(0)))
