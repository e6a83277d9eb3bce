"""Plain reference of Moonlight-16B-A3B (DeepseekV3ForCausalLM) with the
paper's KAN in place of every FFN and expert.

Plain PyTorch, independent of the program: it imports nothing of
``repro_torch`` or ``repro``, takes the float weights the benchmark drew
(the program's tree layout) and quantizes every KAN itself with the KAN
reference beside it (``kan_network.py``).  One full forward over a whole
sequence, no cache, no batching, every position in the expanded form.

Architecture (hub ``config.json``; MLA as DeepSeek-V2, arXiv:2405.04434
§2.1, the router as DeepSeek-V3, arXiv:2412.19437 §2.1.2, both as
``modeling_deepseek.py`` computes them): token embeddings; per layer a
pre-norm MLA block and a pre-norm FFN block; a final RMSNorm and the
untied LM head.

  * MLA, no q-LoRA: q = x W_q as 16 heads of 128 + 64; [c, k_pe] = x
    W_kva, c (512) through its own RMSNorm, k_pe (64) shared by every
    head; [k_nope, v] = c W_kvb, 16 x (128 + 128); rotary at theta on
    q_pe and k_pe on the pairs (2i, 2i+1), as the published code's
    de-interleave and half rotation; causal softmax of q . k over 192 dims
    at 1/sqrt(192); o = W_o . concat(heads).
  * Layer 0's FFN is dense (first_k_dense_replace 1); every later one a
    MoE: s = sigmoid(x W_r) in float32, the top-6 of s + b select (b, the
    selection bias, steers selection only), gates = the selected s over
    their sum (norm_topk_prob) times 2.446; every selected expert runs on
    its tokens (a dense loop over the experts, nothing dropped) and the
    gated outputs add up in float32; the 2 shared experts, one MLP as in
    the published code, add ungated.
  * Every FFN and expert is the paper's KAN-FFN: entry codes from tanh(x)
    on the 8-bit PowerGap grid, the raw x for the ReLU branch, two
    quantized KAN layers d -> hidden -> d with the hidden re-coded from
    tanh(y1) and y1 as the raw input of the second; each expert quantized
    on its own (per-column int8 codes), as the dense layer and the shared
    experts are.

Departures from the published model, as the configuration file lists them
under ``assumed``: the KAN in place of the SwiGLU FFN and experts (hidden
widths by ``kan_variant``'s rule: 1024 dense, 128 an expert, 256 the
shared experts); the port's sqrt(hidden) embedding scale; RMSNorm weights
stored as 1 + scale; random weights and selection bias from the seed; the
group-limited routing left out, which n_group = topk_group = 1 makes the
identity.

Precision, as the configuration states it: bfloat16 weights and
activations between operations; float32 inside RMSNorm, rotary, the
router, softmax and the matmuls' accumulation; the KANs in float32 on
8-bit codes.  ``fp8`` names the linear layers computed one step below
instead (``"proj"``: the attention's q, kv_a, kv_b and o projections;
``"head"``: the LM head), as the Qwen reference beside it does: that is
the check's control.  The judge, the control's reading and the gap
summary are that reference's (``qwen2_kanffn.py``).
"""

from __future__ import annotations

import math

import torch

from benchlib.manifest import load_reference

NAMES = ("c1", "wb1", "c2", "wb2")


def _qwen():
    return load_reference("qwen2_kanffn")


class MoonlightReference:
    def __init__(self, params: dict, cfg: dict, fp8: tuple = ()):
        kan = load_reference("kan_network")
        self.cfg = cfg
        self.fp8 = frozenset(fp8)
        self.dt = getattr(torch, cfg["torch_dtype"])
        self.d = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.dn = cfg["qk_nope_head_dim"]
        self.dr = cfg["qk_rope_head_dim"]
        self.dv = cfg["v_head_dim"]
        self.r = cfg["kv_lora_rank"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.k = cfg["num_experts_per_tok"]
        self.scale = cfg["routed_scaling_factor"]
        self.norm_topk = cfg["norm_topk_prob"]
        k = cfg["kan_ffn"]
        self.bits = k["n_bits"]
        self.spec = kan.LayerSpec(k["grid"], k["order"], k["n_bits"],
                                  k["n_bits"], -1.0, 1.0)
        self.p = params
        # the layers in order: (attn, ln1, ln2, ffn or None, moe or None)
        self.layers = []
        for blk in params["decoder"]:
            for i in range(blk["l0_attn"]["wq"].shape[0]):
                def pick(tree, i=i):
                    return {n: (pick(v) if isinstance(v, dict) else v[i])
                            for n, v in tree.items()}
                self.layers.append({
                    "attn": pick(blk["l0_attn"]),
                    "ln1": blk["l0_ln1"]["scale"][i],
                    "ln2": blk["l0_ln2"]["scale"][i],
                    "ffn": (self.quantize(pick(blk["l0_ffn"]))
                            if "l0_ffn" in blk else None),
                    "moe": (self.quantize_moe(pick(blk["l0_moe"]))
                            if "l0_moe" in blk else None)})
        dev = params["embed"].device
        self.lut = torch.from_numpy(self.spec.lut).to(dev)

    # -- quantization -----------------------------------------------------------

    def quantize(self, w: dict) -> list:
        """One KAN-FFN's two halves as dequantized float32 (c', w_b)."""
        q = load_reference("kan_network").quantize_columns
        return [(q(w[c], self.bits), q(w[b], self.bits))
                for c, b in (("c1", "wb1"), ("c2", "wb2"))]

    def quantize_moe(self, w: dict) -> dict:
        experts = [self.quantize({n: w[n][e] for n in NAMES})
                   for e in range(w["c1"].shape[0])]
        return {"router": w["router"].float(), "bias": w["bias"].float(),
                "experts": experts,
                "shared": self.quantize(w["shared"]) if "shared" in w
                else None}

    # -- pieces ---------------------------------------------------------------

    def store(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dt)

    def linear(self, x, w, kind: str = "proj"):
        if kind in self.fp8:
            fp8 = _qwen().fp8
            return (fp8(x) @ fp8(w)).to(self.dt)
        return x @ w

    def rmsnorm(self, x, scale):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return self.store(xf * torch.rsqrt(var + self.eps) * (1.0 + scale))

    def rope(self, x, pos):
        """Rotary on the pairs (x[2i], x[2i+1]) at theta^(-2i/D): the
        published code de-interleaves them, then rotates the halves."""
        x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
        half = x.shape[-1] // 2
        exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
        freq = torch.pow(torch.full((), self.theta, dtype=torch.float32,
                                    device=x.device), exps)
        ang = pos[:, None].float() * freq
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half].float(), x[..., half:].float()
        return self.store(torch.cat([x1 * cos - x2 * sin,
                                     x2 * cos + x1 * sin], -1))

    def attention(self, a: dict, x, block: int = 256):
        s, d = x.shape
        h, dn, dr, r = self.heads, self.dn, self.dr, self.r
        pos = torch.arange(s, device=x.device)
        q = self.store(self.linear(x, a["wq"].reshape(d, -1))).reshape(
            s, h, dn + dr)
        q = torch.cat([q[..., :dn], self.rope(q[..., dn:], pos)], -1)
        kva = self.store(self.linear(x, a["wkva"]))
        c = self.rmsnorm(kva[:, :r], a["kv_norm"]["scale"])
        k_pe = self.rope(kva[:, None, r:], pos)
        kv = self.store(self.linear(c, a["wkvb"].reshape(r, -1))).reshape(
            s, h, dn + self.dv)
        k = torch.cat([kv[..., :dn], k_pe.expand(s, h, dr)], -1).float()
        v = kv[..., dn:]
        out = []
        for a0 in range(0, s, block):
            qb = q[a0:a0 + block].float()
            logits = torch.einsum("shd,thd->hst", qb, k) / math.sqrt(dn + dr)
            mask = pos[None, :] <= pos[a0:a0 + block, None]
            probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
            o = torch.einsum("hst,thd->shd", self.store(probs), v)
            out.append(self.store(o).reshape(-1, h * self.dv))
        return self.linear(torch.cat(out), a["wo"].reshape(h * self.dv, d))

    def kan_half(self, wc, wb, codes, xraw):
        sp = self.spec
        f, nb, o = wc.shape
        g = (codes >> sp.ld).to(torch.int64)
        vals = self.lut[(codes & (sp.per - 1)).to(torch.int64)]
        basis = torch.zeros(codes.shape + (nb,), device=codes.device)
        basis.scatter_(-1, g[..., None] + torch.arange(sp.order + 1,
                                                       device=codes.device),
                       vals)
        return basis.reshape(-1, f * nb) @ wc.reshape(f * nb, o) \
            + torch.relu(xraw) @ wb

    def kan_ffn(self, w: list, xf, block: int = 256):
        """float32 rows ``xf`` through one quantized KAN-FFN, float32."""
        out = []
        for a0 in range(0, xf.shape[0], block):
            x = xf[a0:a0 + block]
            y1 = self.kan_half(*w[0], self.spec.codes(torch.tanh(x)), x)
            out.append(self.kan_half(*w[1], self.spec.codes(torch.tanh(y1)),
                                     y1))
        return torch.cat(out) if out else xf.new_zeros((0, self.d))

    def moe(self, m: dict, x):
        xf = x.float()
        s = torch.sigmoid(xf @ m["router"])
        top = torch.topk(s + m["bias"], self.k, dim=-1).indices
        g = s.gather(1, top)
        if self.norm_topk:
            g = g / (g.sum(-1, keepdim=True) + 1e-20)
        g = g * self.scale
        out = torch.zeros_like(xf)
        for e, w in enumerate(m["experts"]):
            tok, j = torch.nonzero(top == e, as_tuple=True)
            if tok.numel():
                out.index_add_(0, tok, g[tok, j, None]
                               * self.kan_ffn(w, xf[tok]))
        if m["shared"] is not None:
            out = out + self.kan_ffn(m["shared"], xf)
        return self.store(out)

    # -- the model --------------------------------------------------------------

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.store(self.p["embed"][tokens] * torch.full(
            (), math.sqrt(self.d), dtype=self.dt, device=tokens.device))

    def block(self, lay: dict, h, steer=None):
        """One layer over the hidden rows ``h`` (S, D).  ``steer(moe, x)``,
        where given, runs on a MoE layer's FFN input before it routes."""
        h = self.store(h + self.attention(lay["attn"],
                                          self.rmsnorm(h, lay["ln1"])))
        x = self.rmsnorm(h, lay["ln2"])
        if lay["ffn"] is not None:
            return self.store(h + self.store(self.kan_ffn(lay["ffn"],
                                                          x.float())))
        if steer is not None:
            steer(lay["moe"], x)
        return self.store(h + self.moe(lay["moe"], x))

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, first: int) -> torch.Tensor:
        """(S - first, V) float32 logits of positions ``first..S-1`` of one
        sequence ``tokens`` (S,)."""
        p = self.p
        h = self.embed(tokens)
        for lay in self.layers:
            h = self.block(lay, h)
        h = self.rmsnorm(h[first:], p["final_norm"]["scale"])
        return self.linear(h, p["lm_head"], "head").float()


def judge_streams(ref: MoonlightReference, answers) -> dict:
    return _qwen().judge_streams(ref, answers)


def control_gaps(ref: MoonlightReference, ctl: MoonlightReference,
                 answers) -> dict:
    return _qwen().control_gaps(ref, ctl, answers)
