"""Exporters: Prometheus text exposition, JSON snapshot, and a parser.

``to_prometheus`` serializes a
:class:`~repro_torch.obs.metrics.MetricsRegistry` into the text exposition
format (``# HELP`` / ``# TYPE`` headers, cumulative ``_bucket{le=...}``
rows, ``_sum`` / ``_count``).
``parse_prometheus`` reads that format back into a flat
``{(name, label_items): value}`` map -- the round trip :func:`selfcheck`
runs.

``to_json`` bundles the registry snapshot with the span-ring snapshot
into one JSON-ready document.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from dataclasses import dataclass, field

from .metrics import Histogram, MetricsRegistry, registry as default_registry
from .trace import SpanTracer, tracer as default_tracer

__all__ = ["to_prometheus", "to_json", "parse_prometheus", "selfcheck",
           "histogram_quantile", "quantile", "quantile_from_parsed",
           "SloSpec", "SloResult", "evaluate_slos"]

SNAPSHOT_VERSION = 1


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a trailing ``.0`` so
    counter rows read naturally; +Inf spelled the exposition way."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _labels_str(items: Tuple[Tuple[str, str], ...],
                extra: Optional[Tuple[Tuple[str, str], ...]] = None) -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in items]
    if extra:
        parts += [f'{k}="{_escape(v)}"' for k, v in extra]
    return "{" + ",".join(parts) + "}" if parts else ""


def to_prometheus(reg: Optional[MetricsRegistry] = None) -> str:
    reg = reg if reg is not None else default_registry()
    lines = []
    for fam in sorted(reg.families(), key=lambda f: f.name):
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for items, child in sorted(fam.children.items()):
            if fam.kind == "histogram":
                counts = child.bucket_counts()
                cum = 0
                for bound, c in zip(child.bounds, counts[:-1]):
                    cum += c
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labels_str(items, (('le', _fmt(bound)),))}"
                        f" {cum}")
                cum += counts[-1]
                lines.append(
                    f"{fam.name}_bucket"
                    f"{_labels_str(items, (('le', '+Inf'),))} {cum}")
                lines.append(
                    f"{fam.name}_sum{_labels_str(items)} {_fmt(child.sum)}")
                lines.append(
                    f"{fam.name}_count{_labels_str(items)} {child.count}")
            else:
                lines.append(
                    f"{fam.name}{_labels_str(items)} {_fmt(child.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_json(reg: Optional[MetricsRegistry] = None,
            trc: Optional[SpanTracer] = None,
            include_spans: bool = True) -> dict:
    reg = reg if reg is not None else default_registry()
    trc = trc if trc is not None else default_tracer()
    doc = {"version": SNAPSHOT_VERSION, "metrics": reg.snapshot()}
    if include_spans:
        doc["spans"] = trc.snapshot()
    return doc


def _parse_labels(s: str) -> Tuple[Tuple[str, str], ...]:
    # exposition label block: {k="v",k2="v2"} with \\ \n \" escapes
    items = []
    i = 0
    while i < len(s):
        eq = s.index("=", i)
        key = s[i:eq].lstrip(",").strip()
        assert s[eq + 1] == '"', f"malformed label value at {s[eq:]!r}"
        j = eq + 2
        val = []
        while s[j] != '"':
            if s[j] == "\\":
                nxt = s[j + 1]
                val.append({"n": "\n", "\\": "\\", '"': '"'}[nxt])
                j += 2
            else:
                val.append(s[j])
                j += 1
        items.append((key, "".join(val)))
        i = j + 1
    return tuple(sorted(items))


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str],
                                                         ...]], float]:
    """Exposition text -> ``{(sample_name, label_items): value}``.
    Histogram series keep their expanded ``_bucket``/``_sum``/``_count``
    names and the ``le`` label, exactly as exposed."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name = line[:line.index("{")]
            rest = line[line.index("{") + 1:]
            labels_s, _, value_s = rest.rpartition("}")
            items = _parse_labels(labels_s)
        else:
            name, _, value_s = line.partition(" ")
            items = ()
        value_s = value_s.strip()
        if value_s == "+Inf":
            value = math.inf
        elif value_s == "-Inf":
            value = -math.inf
        else:
            value = float(value_s)
        out[(name, items)] = value
    return out


# ------------------------------------------------------------ SLO evaluation
# Quantile estimation over fixed-bucket histograms, Prometheus
# histogram_quantile-style: find the bucket the target rank falls in and
# interpolate linearly inside it.  A serving control loop and an SLO gate
# read the same math from here.

def histogram_quantile(bounds, counts, q: float) -> Optional[float]:
    """Estimate the ``q``-quantile from per-bucket (non-cumulative)
    ``counts`` -- one count per finite upper ``bound`` plus a trailing
    +Inf slot, exactly :meth:`Histogram.bucket_counts` shape.  Returns
    ``None`` on an empty histogram.  Ranks landing in the +Inf bucket
    clamp to the largest finite bound (the estimate is then a floor)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts[:-1]):
        cum += c
        if cum >= rank and c > 0:
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else 0.0
            frac = (rank - (cum - c)) / c
            return lo + (hi - lo) * frac
    return float(bounds[-1]) if bounds else None


def quantile(name: str, q: float,
             labels: Optional[Dict[str, str]] = None,
             reg: Optional[MetricsRegistry] = None) -> Optional[float]:
    """``q``-quantile of a live registry histogram child (``None`` when
    the family/child does not exist or holds no observations)."""
    reg = reg if reg is not None else default_registry()
    items = tuple(sorted((labels or {}).items()))
    for fam in reg.families():
        if fam.name == name and fam.kind == "histogram":
            child = fam.children.get(items)
            if isinstance(child, Histogram):
                return histogram_quantile(child.bounds,
                                          child.bucket_counts(), q)
    return None


def quantile_from_parsed(parsed, name: str, q: float,
                         labels: Optional[Dict[str, str]] = None
                         ) -> Optional[float]:
    """``q``-quantile from :func:`parse_prometheus` output -- the scrape
    side of the same estimate (cumulative ``le`` series converted back to
    per-bucket counts first)."""
    want = dict(labels or {})
    series = []
    for (sample, items), value in parsed.items():
        if sample != f"{name}_bucket":
            continue
        d = dict(items)
        le = d.pop("le", None)
        if le is None or d != want:
            continue
        bound = math.inf if le == "+Inf" else float(le)
        series.append((bound, value))
    if not series:
        return None
    series.sort()
    bounds = [b for b, _ in series if not math.isinf(b)]
    cum = [v for _, v in series]
    counts = [cum[0]] + [cum[i] - cum[i - 1] for i in range(1, len(cum))]
    return histogram_quantile(bounds, counts, q)


@dataclass(frozen=True)
class SloSpec:
    """One latency/size objective: ``quantile`` of histogram ``name``
    (optionally a labeled child) must stay <= ``max_value``."""

    name: str
    quantile: float
    max_value: float
    labels: Dict[str, str] = field(default_factory=dict)

    def describe(self) -> str:
        lbl = ("{" + ",".join(f"{k}={v}" for k, v in
                              sorted(self.labels.items())) + "}"
               if self.labels else "")
        return f"p{self.quantile * 100:g} {self.name}{lbl}"


@dataclass(frozen=True)
class SloResult:
    spec: SloSpec
    value: Optional[float]  # None: histogram absent/empty (not a breach)
    ok: bool

    def describe(self) -> str:
        v = "n/a" if self.value is None else f"{self.value:.6g}"
        verdict = "ok" if self.ok else "BREACH"
        return (f"{self.spec.describe()} = {v} "
                f"(<= {self.spec.max_value:.6g}) {verdict}")


def evaluate_slos(specs, reg: Optional[MetricsRegistry] = None,
                  parsed=None) -> list:
    """Evaluate SLO specs against a live registry (default) or a parsed
    scrape (``parsed=parse_prometheus(text)``).  An absent or empty
    histogram yields ``value=None, ok=True`` -- no traffic is not a
    breach; gate on traffic separately if it should be."""
    out = []
    for spec in specs:
        if parsed is not None:
            v = quantile_from_parsed(parsed, spec.name, spec.quantile,
                                     spec.labels)
        else:
            v = quantile(spec.name, spec.quantile, spec.labels, reg)
        out.append(SloResult(spec, v, v is None or v <= spec.max_value))
    return out


def selfcheck(reg: Optional[MetricsRegistry] = None,
              trc: Optional[SpanTracer] = None) -> list:
    """Exporter round trip on a registry (default: a scratch one with all
    three instrument kinds populated).  Returns a list of problem
    strings; empty means healthy."""
    problems = []
    if reg is None:
        reg = MetricsRegistry()
        reg.counter("repro_check_ops_total", "ops",
                    labels={"op": 'weird"\\label\n'}).inc(3)
        reg.gauge("repro_check_depth", "depth").set(-2.5)
        h = reg.histogram("repro_check_lat_seconds", "lat")
        for v in (1e-6, 3e-4, 0.25, 99.0):
            h.observe(v)
    text = to_prometheus(reg)
    try:
        parsed = parse_prometheus(text)
    except Exception as exc:  # pragma: no cover - defensive
        return [f"exposition does not parse: {exc!r}"]
    # every sample the registry holds must survive the round trip exactly
    for fam in reg.families():
        for items, child in fam.children.items():
            if fam.kind == "histogram":
                counts = child.bucket_counts()
                want = {("_count", items): float(child.count),
                        ("_sum", items): child.sum}
                for (suffix, it), v in want.items():
                    got = parsed.get((fam.name + suffix, it))
                    if got != v:
                        problems.append(
                            f"{fam.name}{suffix}{dict(it)}: {got} != {v}")
                inf_key = (fam.name + "_bucket",
                           tuple(sorted(items + (("le", "+Inf"),))))
                if parsed.get(inf_key) != float(sum(counts)):
                    problems.append(f"{fam.name}_bucket le=+Inf mismatch")
            else:
                got = parsed.get((fam.name, items))
                if got != child.value:
                    problems.append(
                        f"{fam.name}{dict(items)}: {got} != {child.value}")
    # the JSON document must be round-trippable too
    import json
    try:
        json.loads(json.dumps(to_json(reg, trc)))
    except (TypeError, ValueError) as exc:
        problems.append(f"JSON snapshot not serializable: {exc!r}")
    return problems
