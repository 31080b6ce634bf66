"""Decode traffic: one session of ``batch`` sequences decoding greedily
with ``serve_step.decode_step`` from caches seeded in set-up (N(0, 1) in
every float leaf, ``prefix`` positions taken), the token handed back,
and so synchronised, every step. A session that reaches the end of the
caches restarts from their seeded state.

End to end: ``decode_tokens_per_s``, the tokens generated in the window
over its time, and ``itl_p90_ms``, the 90th percentile of every gap
from one handed-back token to the next. The check: every step of the
last session against the share's plain reference fed the same tokens
from the same seeded caches: each step's logits, the served token's
place among the reference's (``token_gap``), and after the last
step the attention cache's new entries and the SSM's conv and state.
"""
from __future__ import annotations

import math
import time

import torch

from perfbench.harness import draw_normal, leaves
from perfbench.kinds.common import rel_err, sync
from perfbench.reference.common import Prec
from perfbench.traffic import generator

#: the float leaves of a hybrid layer's caches, as the share holds them
LEAVES = ("k", "v", "conv", "ssm")



def seeded(shape, dtype, device, seed: int, leaf: str):
    """The seeded values of the caches' leaf ``leaf`` (all layers)."""
    return draw_normal(shape, dtype, device, seed, "cache", leaf)


class Driver:
    def __init__(self, run):
        self.run = run
        self.share = run.share
        tr = run.traffic
        self.pos0 = tr["prefix"]
        self.slots = tr["cache_slots"]
        self.caches = None
        self.sessions = []

    def _seed_caches(self):
        for path, t in leaves(self.caches):
            if t.is_floating_point():
                t.copy_(seeded(t.shape, t.dtype, t.device, self.run.seed,
                               path.split("/")[-1]))

    def _step(self, tok, pos: int):
        from repro_torch.serve.serve_step import decode_step
        run, sh = self.run, self.share
        with run.spans("decode_step"):
            logits, _ = decode_step(run.params, sh.cfg, tok, self.caches,
                                    pos, tp=sh.tp)
        with run.spans("sample"):
            real = sh.hi - sh.lo
            nxt = logits[:, 0, :real].argmax(-1, keepdim=True) + sh.lo
        with run.spans("sync"):
            sync(sh.device)
        return logits[:, 0], nxt

    def setup(self):
        from repro_torch.models.transformer import init_caches
        run, sh, tr = self.run, self.share, self.run.traffic
        self.caches = init_caches(sh.cfg, tr["batch"], self.slots, sh.dtype,
                                  sh.device, tp_size=sh.n)
        self.shapes = {path.split("/")[-1]: (tuple(x.shape), x.dtype)
                       for path, x in leaves(self.caches)
                       if x.is_floating_point()}
        self.tok0 = generator.first_tokens(tr, sh, run.seed)
        with torch.no_grad():
            self._seed_caches()
            tok = self.tok0
            for i in range(tr["warmup"]):
                _, tok = self._step(tok, self.pos0 + i)
            self._seed_caches()
        run.spans.items.clear()

    def window(self):
        run, sh = self.run, self.share
        sync(sh.device)
        t0 = t_prev = time.perf_counter()
        gaps = []
        tok, pos = self.tok0, self.pos0
        session = {"tokens": [tok], "logits": []}
        self.sessions.append(session)
        with torch.no_grad():
            while True:
                logits, tok = self._step(tok, pos)
                t = time.perf_counter()
                gaps.append(t - t_prev)
                t_prev = t
                session["logits"].append(logits)
                session["tokens"].append(tok)
                pos += 1
                if t - t0 >= run.seconds:
                    break
                if pos == self.slots:
                    self._seed_caches()
                    tok, pos = self.tok0, self.pos0
                    session = {"tokens": [tok], "logits": []}
                    self.sessions.append(session)
        run.window_s = t_prev - t0
        run.attempted = len(gaps) * run.traffic["batch"]
        self.gaps = gaps
        run.counts = {"steps": len(gaps), "batch": run.traffic["batch"],
                      "tokens": run.attempted, "pos0": self.pos0,
                      "pos_end": self.pos0 + len(session["logits"])}

    def end_to_end(self) -> dict:
        gaps = sorted(self.gaps)
        p90 = gaps[max(0, math.ceil(0.9 * len(gaps)) - 1)]
        return {"decode_tokens_per_s":
                self.run.counts["tokens"] / self.run.window_s,
                "itl_p90_ms": p90 * 1e3}

    # -- the comparison --
    def program_outputs(self) -> dict:
        """The last session's logits (T, B, V / n), its served tokens,
        and per layer the caches' new entries and the SSM's conv and
        state after its last step."""
        s = self.sessions[-1]
        t = len(s["logits"])
        c = self.caches["scan"]
        new = slice(self.pos0, self.pos0 + t)
        return {"logits": torch.stack(s["logits"]),
                "served": torch.cat(s["tokens"][1:], dim=1),
                "k": c["attn"]["k"][:, :, new], "v": c["attn"]["v"][:, :, new],
                "conv": c["ssm"]["conv"], "ssm": c["ssm"]["ssm"]}

    def reference_outputs(self, prec: Prec) -> dict:
        """The plain reference fed the last session's input tokens from
        the same seeded caches, built layer by layer in f32."""
        run, sh = self.run, self.share
        s = self.sessions[-1]
        t = len(s["logits"])
        shapes = self.shapes
        self.caches = None
        if sh.device.type == "cuda":
            torch.cuda.empty_cache()
        layers = [{} for _ in range(shapes["k"][0][0])]
        for leaf in LEAVES:
            shape, dtype = shapes[leaf]
            full = seeded(shape, dtype, sh.device, run.seed, leaf)
            for i, layer in enumerate(layers):
                layer[leaf] = full[i].float()
            del full
        ref = run.reference()
        info = {"n": sh.n, "rank": sh.rank, "lo": sh.lo}
        tokens = torch.cat(s["tokens"][:t], dim=1)
        got = ref.decode(run.params, run.conf, info, layers, tokens,
                         self.pos0, prec)
        new = slice(self.pos0, self.pos0 + t)
        return {"logits": got["logits"],
                "k": torch.stack([l["k"][:, new] for l in layers]),
                "v": torch.stack([l["v"][:, new] for l in layers]),
                "conv": torch.stack([l["conv"] for l in layers]),
                "ssm": torch.stack([l["ssm"] for l in layers])}

    def judge(self, got: dict, ref: dict, names) -> dict:
        """The numbers among ``names`` (the cell's limits say which), of:
        the worst step's relative error of the logits (``logits_err``);
        the widest gap, over the reference's spread across the row, by
        which a served token's logit lies below the reference's best
        (``token_gap``; only the vocabulary's real rows are served); the
        worst layer's relative error of the new attention entries
        (``kv_err``), and of the SSM's conv and state (``state_err``)."""
        real = self.share.hi - self.share.lo
        lg, rl = got["logits"].float(), ref["logits"].float()[..., :real]
        served = got.get("served")
        if served is None:         # a control: its own first token
            served = lg[..., :real].argmax(-1).T + self.share.lo
        pick = (served.T - self.share.lo)[..., None]          # (T, B, 1)
        gap = (rl.amax(-1) - rl.gather(-1, pick)[..., 0]) / rl.std(-1)
        kv = [float(rel_err(torch.cat([got["k"][i], got["v"][i]]),
                            torch.cat([ref["k"][i], ref["v"][i]])))
              for i in range(ref["k"].shape[0])]
        st = [max(float(rel_err(got["conv"][i], ref["conv"][i])),
                  float(rel_err(got["ssm"][i], ref["ssm"][i])))
              for i in range(ref["ssm"].shape[0])]
        out = {"logits_err": float(rel_err(lg, ref["logits"], -1).max()),
               "token_gap": float(gap.max()),
               "kv_err": max(kv), "state_err": max(st)}
        return {k: v for k, v in out.items() if k in names}

    def check(self, names) -> dict:
        got = {k: v.clone() for k, v in self.program_outputs().items()}
        return self.judge(got, self.reference_outputs(Prec("f32")), names)
