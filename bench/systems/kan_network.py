"""A quantized KAN network served by ``runtime.execute`` (the paper's
datapath): the system under test of a ``"system": "kan_network"``
configuration.

The benchmark draws the float weights from the seed on the device, hands
them to the program's post-training quantization and deployment
(``core.kan_network_deploy``), and keeps them for the plain reference,
which quantizes them again itself.
"""

from __future__ import annotations

import math

import torch

from benchlib.manifest import load_reference


def draw_params(cfg: dict, seed: int, device) -> list:
    """Float weights of every layer from ``seed``, on ``device``: c ~
    N(0, 0.1/sqrt(in)), w_b ~ N(0, 1/sqrt(in)), two draws per layer."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 64))
    nb = cfg["grid_size"] + cfg["order"]
    out = []
    for f, o in zip(cfg["dims"][:-1], cfg["dims"][1:]):
        c = torch.randn((f, nb, o), generator=gen, device=device)
        wb = torch.randn((f, o), generator=gen, device=device)
        out.append({"c": c * (0.1 / math.sqrt(f)), "w_b": wb / math.sqrt(f)})
    return out


class KANSystem:
    def __init__(self, cfg: dict, seed: int, device):
        from repro_torch.core.kan_layer import KANSpec
        from repro_torch.core.kan_network_deploy import (
            deploy_kan_network,
            quantize_kan_network,
        )

        self.cfg = cfg
        self.device = device
        self.params = draw_params(cfg, seed, device)
        kspec = KANSpec(dims=tuple(cfg["dims"]), grid_size=cfg["grid_size"],
                        order=cfg["order"], n_bits=cfg["n_bits"],
                        lut_bits=cfg["lut_bits"], lo=cfg["lo"], hi=cfg["hi"])
        self.dep = deploy_kan_network(quantize_kan_network(self.params, kspec),
                                      kspec, device=device)

    def execute(self, x):
        """Dispatch one request of host rows; returns the device answer."""
        from repro_torch import runtime

        return runtime.execute(self.dep, x, backend=self.cfg["backend"])

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.dep = None

    def reference(self, mac: str = "float32"):
        ref = load_reference(self.cfg["reference"])
        return ref.KANReference(self.params, self.cfg, mac)

    def judge(self, answers) -> dict:
        """Compare ``answers`` ([(rows, host outputs)]) with the plain
        reference."""
        ref = load_reference(self.cfg["reference"])
        return ref.judge_answers(self.reference(), answers)

    def control(self, answers) -> dict:
        """The control's reading, by name: the reference with its MACs one
        precision step below (TF32), put in the program's place on the same
        rows and judged as the program is."""
        ctl = self.reference("tf32")
        dev = self.device
        outs = [(x, ctl.forward(torch.as_tensor(x).to(dev, torch.float32))[0])
                for x, _ in answers]
        return {"tf32": self.judge(outs)}


def build(cfg: dict, mix: dict, seed: int, device) -> KANSystem:
    return KANSystem(cfg, seed, device)
