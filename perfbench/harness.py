"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything a cell needs is found by name. A cell names a configuration
(``configs/<name>.json``: the sizes as run, the port's arch, the mesh
and the share of it that this chip holds) and a traffic mix
(``traffic/<name>.json``: its kind and parameters, read by
``traffic/generator.py``); its limits are ``limits/<cell>.json``, the
plain reference of the configuration ``reference/<module>.py`` (the
module the configuration file names), and each per-layer metric a
reader ``metrics/<metric>.py``. The kind of traffic (``prefill``,
``decode``) picks the driver in ``kinds/``.

The program under test is the PyTorch port, ``repro_torch``: the
harness takes from it the shapes of a share's parameters (on ``meta``),
the serve steps it times and the names of its kernels. Weights, inputs
and caches are drawn here from ``--seed`` on the device; the reference
is handed the same tensors and nothing the program made.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """A run that must print no result (exit code 2)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file of the benchmark, loaded by its path (its name may
    hold dots and dashes)."""
    name = "perfbench_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def seed_of(seed: int, *tags) -> int:
    """A 63-bit seed for a ``torch.Generator``, from ``seed`` and tags."""
    text = "/".join([str(int(seed)), *map(str, tags)]).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def forbidden_modules(names=None) -> list:
    """The top-level names of ``FORBIDDEN`` among module ``names``
    (``sys.modules``'), compared whole (``repro_torch`` is not
    ``repro``)."""
    tops = {name.split(".", 1)[0]
            for name in list(sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Spans on the host's clock
# ---------------------------------------------------------------------------

class Spans:
    """The benchmark's own spans around its calls into the program, on
    the host's clock: (name, start s, end s). Under a trace each span is
    also a ``record_function`` range, so that idle gaps on the device
    can be named by what the host was doing."""

    def __init__(self):
        self.items: list = []
        self.traced = False

    @contextmanager
    def __call__(self, name: str):
        if self.traced:
            import torch
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                yield
                self.items.append((name, t0, time.perf_counter()))
        else:
            t0 = time.perf_counter()
            yield
            self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> list:
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


# ---------------------------------------------------------------------------
# The share of the deployment that this chip holds
# ---------------------------------------------------------------------------

#: keys of a configuration file and the port's value they state, for
#: the keys the file holds at their published value
_PUBLISHED = {
    "hidden_size": lambda c: c.d_model,
    "num_hidden_layers": lambda c: c.num_layers,
    "intermediate_size": lambda c: (c.moe.dense_d_ff if c.moe.enabled
                                    else c.d_ff),
    "moe_intermediate_size": lambda c: c.moe.expert_d_ff,
    "n_shared_experts": lambda c: c.moe.num_shared_experts,
    "num_experts_per_tok": lambda c: c.moe.top_k,
    "first_k_dense_replace": lambda c: c.moe.first_dense_layers,
    "kv_lora_rank": lambda c: c.mla.kv_lora_rank,
    "qk_nope_head_dim": lambda c: c.mla.qk_nope_head_dim,
    "qk_rope_head_dim": lambda c: c.mla.qk_rope_head_dim,
    "v_head_dim": lambda c: c.mla.v_head_dim,
    "rope_theta": lambda c: c.rope_theta,
    "rms_norm_eps": lambda c: c.rms_eps,
    "mamba_d_state": lambda c: c.ssm.d_state,
    "mamba_d_conv": lambda c: c.ssm.d_conv,
    "mamba_expand": lambda c: c.ssm.expand,
    "sliding_window": lambda c: c.sliding_window,
}
#: keys of a configuration file's ``as_run``, where the port departs from
#: the published model, and the port's value they state
_AS_RUN = {
    "global_attn_idx": lambda c: [
        i for i, w in enumerate(_windows(c)) if w == 0],
    "tie_word_embeddings": lambda c: c.tie_embeddings,
}


def _windows(cfg) -> list:
    from repro_torch.models.transformer import layer_windows
    return layer_windows(cfg, cfg.num_layers)


#: keys a share holds a part of: the part one rank of a ``model`` axis
#: of ``n`` holds
_HELD = {
    "num_attention_heads": lambda c, n: c.num_heads // n,
    "num_key_value_heads": lambda c, n: c.num_kv_heads // n,
    "n_routed_experts": lambda c, n: c.moe.num_experts // n,
    "vocab_size": lambda c, n: c.padded_vocab() // n,
}


@dataclass
class Share:
    """One rank's share of a deployment: the port's config ``cfg``, the
    ``model`` axis ``n`` and this chip's rank on it, the share's
    ``TensorParallel`` over a plan of the mesh (its collectives move
    nothing: no other rank is there), the token ids it embeds
    ``[lo, hi)`` and the served dtype."""
    conf: dict
    cfg: object
    n: int
    rank: int
    tp: object
    lo: int
    hi: int
    dtype: object
    device: object


def check_config(conf: dict, cfg, n: int) -> None:
    """Raise unless the configuration file states the port's config as
    this share runs it: the published keys at the port's values, the
    ``reduced`` keys at the share's part, and ``as_run``'s departures at
    the port's."""
    for key in conf["reduced"]:
        if key in _HELD and conf[key] != _HELD[key](cfg, n):
            raise ValueError(f"{conf['name']}: {key} is {conf[key]}, the "
                             f"share holds {_HELD[key](cfg, n)}")
    for key, get in _PUBLISHED.items():
        if key in conf and key not in conf["reduced"]:
            if not math.isclose(float(conf[key]), float(get(cfg))):
                raise ValueError(f"{conf['name']}: {key} is {conf[key]}, "
                                 f"the port runs {get(cfg)}")
    for key, get in _AS_RUN.items():
        if key in conf.get("as_run", {}) and conf["as_run"][key] != get(cfg):
            raise ValueError(f"{conf['name']}: {key} is {conf['as_run'][key]}"
                             f" as run, the port runs {get(cfg)}")


def build_share(conf: dict, device, cfg=None) -> Share:
    """The share a configuration file names, on ``device``. ``cfg``
    replaces the port's config of ``conf["arch"]`` (the CPU tests' small
    configs), unchecked."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import PlanMesh
    from repro_torch.models import sharding
    mesh = conf["mesh"]
    axes, shape = mesh["axes"], mesh["shape"]
    n = shape[axes.index("model")]
    rank = conf["share"]["model_rank"]
    if cfg is None:
        cfg = get_config(conf["arch"])
        check_config(conf, cfg, n)
    coord = [rank if a == "model" else 0 for a in axes]
    tp = sharding.TensorParallel(PlanMesh(shape, axes, coord).group(
        ("model",)), sequence_parallel=False)
    rows = cfg.padded_vocab() // n
    lo = rank * rows
    hi = min(lo + rows, cfg.vocab_size)
    return Share(conf, cfg, n, rank, tp, lo, hi,
                 getattr(torch, conf["dtype"]), device)


def leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _put(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def draw_params(share: Share, seed: int) -> dict:
    """The share's parameters from ``seed``, on its device in the served
    dtype (the router and the SSM's decay, skip and step bias in f32, as
    the port holds them): their shapes from the port's tree on ``meta``,
    every random leaf a view of one N(0, 1) draw per dtype, scaled by
    sqrt(2 / (d_in + d_out)) of the whole leaf (the conv taps by
    1 / sqrt(d_conv)); norm scales 1, biases 0, a_log log(1..16), the
    skip 1, the step bias 0."""
    import torch
    from repro_torch.models.transformer import init_params
    cfg, n = share.cfg, share.n
    cut = init_params(cfg, 0, share.dtype, "meta", tp_rank=share.rank,
                      tp_size=n)
    whole = dict(leaves(init_params(cfg, 0, share.dtype, "meta")))
    dev = share.device
    random, out = [], {}
    for path, leaf in leaves(cut):
        name = path.split("/")[-1]
        shape, dt = tuple(leaf.shape), leaf.dtype
        if name == "a_log":
            value = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                             device=dev)).expand(shape)
        elif name in ("d_skip", "dt_bias") or name.endswith("scale") \
                or name.startswith("b_"):
            fill = 1.0 if name == "d_skip" or name.endswith("scale") else 0.0
            value = torch.full(shape, fill, device=dev)
        else:
            random.append((path, shape, dt, whole[path].shape))
            continue
        _put(out, path, value.to(dt).contiguous())
    for dt in sorted({r[2] for r in random}, key=str):
        mine = [r for r in random if r[2] == dt]
        total = sum(math.prod(r[1]) for r in mine)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed_of(seed, "weights", str(dt)))
        buf = torch.randn(total, generator=gen, dtype=dt, device=dev)
        off = 0
        for path, shape, _, wshape in mine:
            size = math.prod(shape)
            scale = ((1.0 / wshape[-2]) ** 0.5 if path.endswith("conv_w")
                     else (2.0 / (wshape[-2] + wshape[-1])) ** 0.5)
            _put(out, path, buf[off:off + size].view(shape).mul_(scale))
            off += size
    return out


def draw_normal(shape, dtype, device, seed: int, *tags):
    """N(0, 1) values of ``shape`` from ``seed`` and ``tags``, drawn on
    ``device`` in ``dtype``: the same call gives the same values."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, *tags))
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=device)


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """What one run knows: the cell, its configuration, traffic and
    limits, the share and its parameters, the spans, and after the
    window its counts, trace and outputs."""
    bench: dict
    cell: dict
    conf: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    share: Optional[Share] = None
    params: Optional[dict] = None
    spans: Spans = field(default_factory=Spans)
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    counts: dict = field(default_factory=dict)
    traced: Optional[object] = None
    driver: Optional[object] = None

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(
            f"perfbench.reference.{self.conf['reference']}")


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` and what it finds by name: its
    configuration file, traffic mix and limits, ``overrides`` merged."""
    bench: dict
    cell: dict
    conf: dict
    traffic: dict
    limits: dict


def open_cell(workload: str, overrides=None) -> Cell:
    """The cell ``workload``. ``overrides`` (the CPU tests only) may
    replace entries of the configuration file and the traffic
    (``"conf"``, ``"traffic"``)."""
    overrides = overrides or {}
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    conf = {**load_json(ROOT / entry["file"]), **overrides.get("conf", {})}
    traffic = {**load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
               **overrides.get("traffic", {})}
    limits = load_json(HERE / "limits" / f"{workload}.json")["numbers"]
    return Cell(bench, cell, conf, traffic, limits)


def plain_products() -> None:
    """Plain f32 products (TF32 off), as the reference and the
    comparison run."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def new_run(c: Cell, share: Share, seed: int, seconds: float,
            trace: bool = False) -> "Run":
    """A run of cell ``c`` on ``share``: its parameters drawn from
    ``seed`` and its kind's driver made (not yet set up)."""
    run = Run(c.bench, c.cell, c.conf, c.traffic, seed, seconds, trace,
              share.device, share=share)
    run.params = draw_params(share, seed)
    kind = importlib.import_module(f"perfbench.kinds.{c.traffic['kind']}")
    run.driver = kind.Driver(run)
    return run


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            t_start: float, device=None, overrides=None) -> dict:
    """One run of ``workload``; returns the result line as a dict. On
    the card (``device`` None) it refuses to run without enough CUDA
    devices. ``overrides`` (the CPU tests only) may replace the port's
    config (``"cfg"``) and entries of the configuration file and the
    traffic (``"conf"``, ``"traffic"``)."""
    import torch

    from perfbench.kinds.common import sync
    overrides = overrides or {}
    c = open_cell(workload, overrides)
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < c.cell["chips"]:
            raise Refused(f"{workload} needs {c.cell['chips']} CUDA "
                          f"devices, {torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    plain_products()
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)

    marks = [("start to imports", time.time())]
    share = build_share(c.conf, device, overrides.get("cfg"))
    marks.append(("share", time.time()))
    run = new_run(c, share, seed, seconds, trace)
    driver = run.driver
    sync(device)
    marks.append(("weights", time.time()))
    driver.setup()
    sync(device)
    marks.append(("caches and warm-up", time.time()))
    setup_s = marks[-1][1] - t_start
    print("setup_s " + ", ".join(
        f"{name} {t1 - t0:.3f}" for (name, t1), t0 in
        zip(marks, [t_start] + [t for _, t in marks[:-1]])), file=sys.stderr)

    if trace:
        run.traced = _traced_window(run, driver)
    else:
        driver.window()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    numbers = driver.check(sorted(c.limits))
    checked = {k: {"value": numbers[k], "limit": c.limits[k]["limit"]}
               for k in sorted(c.limits)}
    correct = all(
        v["value"] is not None and math.isfinite(v["value"])
        and v["value"] <= v["limit"] for v in checked.values()
    ) and run.failed == 0 and run.attempted > 0
    if trace:
        metrics = _per_layer(run, c.bench, workload)
    else:
        metrics = driver.end_to_end()
        metrics["setup_s"] = setup_s
        metrics = {m["name"]: {"value": metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in c.bench["end_to_end"]
                   if workload in m.get("workloads", [workload])}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.traced.busy_s
        dev["window_s"] = run.traced.window_s
        out["breakdown"] = run.traced.breakdown()
    out["checked"] = checked
    return out


def _traced_window(run: Run, driver):
    """The window under ``torch.profiler`` (CUPTI on the card), cut to
    the traffic's ``trace_seconds``; its device rows, spans and gaps."""
    import torch

    from perfbench import trace as trace_mod
    from perfbench.kinds.common import sync
    run.seconds = min(run.seconds, run.traffic["trace_seconds"])
    acts = [torch.profiler.ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    run.spans.traced = True
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("window"):
            t0 = time.perf_counter()
            driver.window()
            sync(run.device)
            window_s = time.perf_counter() - t0
    run.spans.traced = False
    return trace_mod.read(prof, window_s)


def _per_layer(run: Run, bench: dict, workload: str) -> dict:
    """Each per-layer metric of the cell, from its reader; a reader that
    finds nothing to read leaves its metric out."""
    out = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = execute(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
        found = forbidden_modules()
        if found:
            raise Refused("modules loaded that the port may not use: "
                          + ", ".join(found))
    except Refused as exc:
        print(f"refused: {exc}", file=sys.stderr)
        return 2
    for name, v in out["checked"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
