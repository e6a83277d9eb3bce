"""Plain reference of the Qwen2 decoder with the paper's KAN-FFN.

Plain PyTorch, independent of the program: it imports nothing of
``repro_torch`` or ``repro``, takes the float weights the benchmark drew
(the program's tree layout) and quantizes the KAN-FFN itself with the
KAN reference beside it (``kan_network.py``).  One full forward over a
whole sequence, no cache, no batching.

Architecture (hub ``Qwen2ForCausalLM``, with the port's departure that
the configuration file lists under ``assumed``): token embeddings times
sqrt(hidden); per layer a pre-norm GQA attention block (RMSNorm with
weight 1 + scale, q/k/v projections with bias, rotary embedding on the
two halves of each head at theta, causal softmax attention in which
query head r reads KV head r // (heads / kv_heads), output projection)
and a pre-norm KAN-FFN block; a final RMSNorm and the LM head.  The
benchmark stores the 40 query heads as 48, one zero head at the end of
each KV head's group of 6 (``real_heads``); the reference takes the 40
real heads out of that layout and never computes the padding.

The KAN-FFN: entry codes from tanh(x) on the 8-bit PowerGap grid, the
raw x for the ReLU branch, two quantized KAN layers d -> hidden -> d with
the hidden re-coded from tanh(y1) and y1 as the raw input of the second.

Precision, as the configuration states it: bfloat16 weights and
activations between operations, float32 inside RMSNorm, rotary, softmax
and the matmuls' accumulation; the KAN-FFN in float32 on 8-bit codes.
``fp8`` names the linear layers computed one step below instead
(``"proj"``: the q/k/v/o projections; ``"head"``: the LM head): both
operands rounded to float8 e4m3 on a per-tensor scale, the product
accumulated in float32 and kept in bfloat16, as a float8 GEMM with a
bfloat16 output does.  That is the check's control.
"""

from __future__ import annotations

import math

import torch

from benchlib.manifest import load_reference

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 on a per-tensor scale, as float32."""
    t = t.float()
    s = t.abs().max().clamp_min(1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def real_heads(cfg: dict) -> list:
    """Indices of the real query heads among the stored ones: the stored
    heads fall into one group per KV head, and each group holds its real
    heads first, then zero heads up to the padded count."""
    heads, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    m = cfg["head_pad_multiple"]
    stored = heads + (-heads) % m if m else heads
    g, real = stored // hkv, heads // hkv
    return [h for h in range(stored) if h % g < real]


class LMReference:
    def __init__(self, params: dict, cfg: dict, fp8: tuple = ()):
        kan = load_reference("kan_network")
        self.cfg = cfg
        self.fp8 = frozenset(fp8)
        self.dt = getattr(torch, cfg["torch_dtype"])
        self.d = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.hd = self.d // self.heads
        self.hkv = cfg["num_key_value_heads"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        k = cfg["kan_ffn"]
        self.spec = kan.LayerSpec(k["grid"], k["order"], k["n_bits"],
                                  k["n_bits"], -1.0, 1.0)
        self.p = params
        blk = params["decoder"][0]
        idx = torch.tensor(real_heads(cfg), device=blk["l0_attn"]["wq"].device)
        axis = {"wq": -2, "bq": -2, "wo": 1}
        self.attn = {name: (w.index_select(axis[name], idx) if name in axis
                            else w)
                     for name, w in blk["l0_attn"].items()}
        self.ffn = blk["l0_ffn"]
        self.ln1, self.ln2 = blk["l0_ln1"]["scale"], blk["l0_ln2"]["scale"]
        self.layers = self.attn["wq"].shape[0]
        # the KAN-FFN quantized from the float weights, per layer and half
        self.kan_w = [
            [(kan.quantize_columns(self.ffn[c][i], k["n_bits"]),
              kan.quantize_columns(self.ffn[w][i], k["n_bits"]))
             for c, w in (("c1", "wb1"), ("c2", "wb2"))]
            for i in range(self.layers)]
        self.lut = torch.from_numpy(self.spec.lut).to(self.attn["wq"].device)

    # -- pieces ---------------------------------------------------------------

    def store(self, t: torch.Tensor) -> torch.Tensor:
        """An activation as the precision keeps it between operations."""
        return t.to(self.dt)

    def linear(self, x: torch.Tensor, w: torch.Tensor, kind: str = "proj"):
        if kind in self.fp8:
            return (fp8(x) @ fp8(w)).to(self.dt)
        return x @ w

    def rmsnorm(self, x, scale):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return self.store(xf * torch.rsqrt(var + self.eps) * (1.0 + scale))

    def rope(self, x, pos):
        half = self.hd // 2
        exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
        freq = torch.pow(torch.full((), self.theta, dtype=torch.float32,
                                    device=x.device), exps)
        ang = pos[:, None].float() * freq
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return self.store(torch.cat([x1 * cos - x2 * sin,
                                     x2 * cos + x1 * sin], -1))

    def attention(self, i: int, x, block: int = 256):
        a = self.attn
        s, d = x.shape
        q = self.linear(x, a["wq"][i].reshape(d, -1)).reshape(s, self.heads,
                                                              self.hd)
        k = self.linear(x, a["wk"][i].reshape(d, -1)).reshape(s, self.hkv, self.hd)
        v = self.linear(x, a["wv"][i].reshape(d, -1)).reshape(s, self.hkv, self.hd)
        if "bq" in a:
            q, k, v = (self.store(t + a[b][i]) for t, b in
                       ((q, "bq"), (k, "bk"), (v, "bv")))
        pos = torch.arange(s, device=x.device)
        q, k = self.rope(q, pos), self.rope(k, pos)
        g = self.heads // self.hkv
        kf = k.float()
        out = []
        for a0 in range(0, s, block):
            qb = q[a0:a0 + block].float().reshape(-1, self.hkv, g, self.hd)
            logits = torch.einsum("shgd,thd->hgst", qb, kf) / math.sqrt(self.hd)
            mask = pos[None, :] <= pos[a0:a0 + block, None]
            probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
            o = torch.einsum("hgst,thd->shgd", self.store(probs), v)
            out.append(self.store(o).reshape(-1, self.heads * self.hd))
        o = torch.cat(out)
        return self.linear(o, a["wo"][i].reshape(self.heads * self.hd, d))

    def kan_half(self, i: int, half: int, codes, xraw):
        sp = self.spec
        wc, wb = self.kan_w[i][half]
        f, nb, o = wc.shape
        g = (codes >> sp.ld).to(torch.int64)
        vals = self.lut[(codes & (sp.per - 1)).to(torch.int64)]
        basis = torch.zeros(codes.shape + (nb,), device=codes.device)
        basis.scatter_(-1, g[..., None] + torch.arange(sp.order + 1,
                                                       device=codes.device),
                       vals)
        return basis.reshape(-1, f * nb) @ wc.reshape(f * nb, o) \
            + torch.relu(xraw) @ wb

    def kan_ffn(self, i: int, x, block: int = 256):
        out = []
        for a0 in range(0, x.shape[0], block):
            xf = x[a0:a0 + block].float()
            y1 = self.kan_half(i, 0, self.spec.codes(torch.tanh(xf)), xf)
            y2 = self.kan_half(i, 1, self.spec.codes(torch.tanh(y1)), y1)
            out.append(self.store(y2))
        return torch.cat(out)

    # -- the model --------------------------------------------------------------

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, first: int) -> torch.Tensor:
        """(S - first, V) float32 logits of positions ``first..S-1`` of one
        sequence ``tokens`` (S,)."""
        p = self.p
        h = self.store(p["embed"][tokens] * torch.full(
            (), math.sqrt(self.d), dtype=self.dt, device=tokens.device))
        for i in range(self.layers):
            h = self.store(h + self.attention(i, self.rmsnorm(h, self.ln1[i])))
            h = self.store(h + self.kan_ffn(i, self.rmsnorm(h, self.ln2[i])))
        h = self.rmsnorm(h[first:], p["final_norm"]["scale"])
        head = p["embed"].T if "lm_head" not in p else p["lm_head"]
        return self.linear(h, head, "head").float()


def stream_logits(ref: LMReference, prompt, tokens):
    """Teacher-forced logits of a served stream: row j predicts
    ``tokens[j]`` after the prompt and ``tokens[:j]``."""
    dev = ref.lut.device
    seq = torch.tensor(list(prompt) + list(tokens[:-1]), device=dev)
    return ref.logits(seq, len(prompt) - 1), torch.tensor(tokens, device=dev)


def gaps(lg: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
    """The reference's gap of each picked token below its best logit."""
    return lg.max(-1).values - lg.gather(1, pick[:, None])[:, 0]


def summary(gap_list: list, n_answers: int) -> dict:
    """``worst_gap``: the widest gap; ``mean_gap``: the gaps' sum over all
    picked tokens; ``off_argmax``: picks strictly below the best;
    ``gap_counts``: how often each gap above 0 came."""
    g = torch.cat(gap_list) if gap_list else torch.zeros(0)
    vals, counts = torch.unique(g[g > 0], return_counts=True)
    return {"worst_gap": float(g.max()) if g.numel() else 0.0,
            "mean_gap": float(g.double().sum()) / max(1, g.numel()),
            "off_argmax": int((g > 0).sum()), "tokens": int(g.numel()),
            "answers": n_answers,
            "gap_counts": {repr(float(v)): int(c)
                           for v, c in zip(vals, counts)}}


def judge_streams(ref: LMReference, answers) -> dict:
    """``answers``: [(prompt, served tokens)], each scored by the gaps of
    its served tokens (``summary``)."""
    found = []
    for prompt, tokens in answers:
        lg, tok = stream_logits(ref, prompt, tokens)
        if lg.shape[0] != len(tokens) or not bool(torch.isfinite(lg).all()):
            return {"worst_gap": math.inf, "mean_gap": math.inf,
                    "off_argmax": 0, "tokens": 0, "answers": len(answers),
                    "gap_counts": {}}
        found.append(gaps(lg, tok).cpu())
    return summary(found, len(answers))


def control_gaps(ref: LMReference, ctl: LMReference, answers) -> dict:
    """The control's reading on the same prompts and tokens: at each
    position the reference's gap of the token the control puts first."""
    found = []
    for prompt, tokens in answers:
        lg, _ = stream_logits(ref, prompt, tokens)
        lc, _ = stream_logits(ctl, prompt, tokens)
        found.append(gaps(lg, lc.argmax(-1)).cpu())
    return summary(found, len(answers))
