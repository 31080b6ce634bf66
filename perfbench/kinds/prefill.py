"""Prefill traffic: a closed loop of one client, each operation one
``serve_step.prefill_step`` of ``batch`` fresh prompts of ``prompt_len``
tokens from position 0, into caches allocated in set-up.

End to end: ``prefill_tokens_per_s``, the prompt tokens of every
prefill completed in the window over the window's time. The check:
the last operation's logits and the caches it filled, and the logits of
more operations drawn from the seed (``checked_ops`` in all, a key of
the configuration file, else ``CHECKED``), against the share's plain
reference run on the same prompts.
"""
from __future__ import annotations

import time

import torch

from perfbench.harness import leaves, seed_of
from perfbench.kinds.common import rel_err, sync
from perfbench.reference.common import Prec
from perfbench.traffic import generator

#: cache leaves that hold one entry a position, and leaves that hold a
#: state a fresh request starts from zero
SEQ_LEAVES = ("c_kv", "k_rope", "k", "v")
STATE_LEAVES = ("conv", "ssm")
#: operations whose logits are checked, the last and others drawn from
#: the seed, where the configuration does not say
CHECKED = 4



class Driver:
    def __init__(self, run):
        self.run = run
        self.share = run.share
        self.caches = None
        self.logits = []

    # -- the program's side --
    def _op(self, op: int):
        from repro_torch.serve.serve_step import prefill_step
        run, sh = self.run, self.share
        with run.spans("input"):
            toks = generator.prompts(run.traffic, sh, run.seed, op)
            for t in self.states:       # a fresh request's SSM state
                t.zero_()
        with run.spans("prefill_step"):
            logits, _ = prefill_step(run.params, sh.cfg, {"tokens": toks},
                                     self.caches, tp=sh.tp)
            last = logits[:, 0].clone()      # (B, V / n); frees the rest
        with run.spans("sync"):
            sync(sh.device)
        return last

    def setup(self):
        from repro_torch.models.transformer import init_caches
        run, sh, tr = self.run, self.share, self.run.traffic
        self.caches = init_caches(sh.cfg, tr["batch"], tr["prompt_len"],
                                  sh.dtype, sh.device, tp_size=sh.n)
        self.states = [t for path, t in leaves(self.caches)
                       if path.split("/")[-1] in STATE_LEAVES]
        with torch.no_grad():
            for i in range(tr["warmup"]):
                self._op(-1 - i)
        run.spans.items.clear()

    def window(self):
        run = self.run
        sync(self.share.device)
        t0 = time.perf_counter()
        with torch.no_grad():
            while True:
                self.logits.append(self._op(len(self.logits)))
                t1 = time.perf_counter()
                if t1 - t0 >= run.seconds:
                    break
        run.window_s = t1 - t0
        run.attempted = len(self.logits)
        tr = run.traffic
        run.counts = {"ops": len(self.logits), "batch": tr["batch"],
                      "prompt_len": tr["prompt_len"],
                      "tokens": len(self.logits) * tr["batch"]
                      * tr["prompt_len"]}

    def end_to_end(self) -> dict:
        return {"prefill_tokens_per_s":
                self.run.counts["tokens"] / self.run.window_s}

    # -- the comparison --
    def checked_ops(self) -> list:
        """The last operation and others drawn from the seed, all of them
        where fewer ran."""
        n = len(self.logits)
        k = self.run.conf.get("checked_ops", CHECKED)
        gen = torch.Generator().manual_seed(seed_of(self.run.seed, "checked"))
        order = torch.randperm(n - 1, generator=gen).tolist()
        return sorted(order[:k - 1] + [n - 1])

    def program_outputs(self) -> dict:
        """The program's outputs that are judged: the checked operations'
        logits and, per layer, the caches the last one filled."""
        c = self.caches
        layers = [dict(leaves(c["dense"][k])) for k in sorted(
            c.get("dense", {}), key=int)]
        scan = dict(leaves(c["scan"]))
        n = next(iter(scan.values())).shape[0]
        layers += [{p.split("/")[-1]: t[i] for p, t in scan.items()}
                   for i in range(n)]
        return {"logits": {op: self.logits[op] for op in self.checked_ops()},
                "layers": [{k: v for k, v in layer.items()
                            if k.split("/")[-1] in SEQ_LEAVES + STATE_LEAVES}
                           for layer in layers]}

    def reference_outputs(self, prec: Prec) -> dict:
        """The plain reference's outputs for the same prompts."""
        run, sh = self.run, self.share
        ref = run.reference()
        info = {"n": sh.n, "rank": sh.rank, "lo": sh.lo}
        ops = self.checked_ops()
        out = {"logits": {}}
        for op in ops:
            toks = generator.prompts(run.traffic, sh, run.seed, op)
            got = ref.prefill(run.params, run.conf, info, toks, prec)
            out["logits"][op] = got["logits"]
            if op == ops[-1]:
                out["layers"] = got["caches"]
            del got
        return out

    def judge(self, got: dict, ref: dict, names) -> dict:
        """The numbers among ``names`` (the cell's limits say which). Of
        the logits, a row's relative error (over the vocabulary's real
        rows), over every row of the checked operations (operations
        times sequences): ``logits_err`` their median, for a
        configuration that routes tokens, where a token whose routing
        flips on a near tie departs from the reference by far more than
        rounding (about one last token in five does over 26 MoE
        layers); ``logits_mean`` their mean, where a layer normalises a
        branch's output (Hymba's attention and SSM heads): a row whose
        branch output is small next to its rounding has it amplified,
        and reads up to four times the others; ``logits_max`` the
        worst. Of the caches the last operation filled: ``cache_err``,
        per layer and sequence the median over positions of a position's
        relative error of the entries, the worst of them; ``cache_max``,
        the worst layer's relative error of its whole cache;
        ``state_err``, the worst layer's relative error of its state
        (the SSM's conv and state)."""
        names = set(names)
        real = self.share.hi - self.share.lo
        ops = sorted(ref["logits"])
        g = torch.stack([got["logits"][op][..., :real].float() for op in ops])
        r = torch.stack([ref["logits"][op][..., :real].float() for op in ops])
        row = rel_err(g, r, -1)                          # (ops, B)
        out = {"logits_err": float(row.median()),
               "logits_mean": float(row.mean()),
               "logits_max": float(row.max())}
        med, whole, state = [], [], []
        for gl, rl in zip(got["layers"], ref["layers"]):
            keys = [k for k in SEQ_LEAVES if k in rl]
            b, s = rl[keys[0]].shape[:2]
            g = torch.cat([gl[k].float().reshape(b, s, -1) for k in keys], -1)
            r = torch.cat([rl[k].float().reshape(b, s, -1) for k in keys], -1)
            if "cache_err" in names:
                med.append(float(rel_err(g, r, -1).median(dim=-1).values.max()))
            if "cache_max" in names:
                whole.append(float(rel_err(g, r)))
            if "state_err" in names:
                state += [float(rel_err(gl[k], rl[k])) for k in STATE_LEAVES
                          if k in rl]
        if med:
            out["cache_err"] = max(med)
        if whole:
            out["cache_max"] = max(whole)
        if state:
            out["state_err"] = max(state)
        return {k: v for k, v in out.items() if k in names}

    def check(self, names) -> dict:
        got = self.program_outputs()
        return self.judge(got, self.reference_outputs(Prec("f32")), names)
