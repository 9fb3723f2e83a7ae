"""OpenMetrics text render of the port's metrics registry — the
single-process half of the JAX package's ``obs/export.py``.

- every metric is ``racon_tpu_<key>`` (the JAX package's prefix, so one
  scrape config reads both), preceded by stable ``# HELP`` / ``# TYPE``
  lines;
- the merge kind (obs/metrics.py::merge_kind) decides the type: ``sum``
  keys are counters (samples get the ``_total`` suffix), ``max``/``last``
  keys gauges, the histogram families histograms;
- the output is byte-stable: keys sorted, numbers formatted through one
  path, no timestamps; it ends with ``# EOF``.

Non-numeric registry values have no OpenMetrics form and are skipped.
Entry points: :func:`render_registry` (the daemon's metrics endpoint)
and :func:`validate_openmetrics` (the tests' structural check). The
fleet render waits for the port's distributed slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from racon_tpu_torch.obs.metrics import (HIST_BUCKETS, MERGE_HIST,
                                         MERGE_SUM, merge_kind)

PREFIX = "racon_tpu_"
CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")


def _sanitize(key: str) -> str:
    """Map a registry key into the OpenMetrics name charset
    ``[a-zA-Z0-9_]`` (leading digits get an underscore)."""
    out = "".join(ch if ch.isalnum() or ch == "_" else "_"
                  for ch in key)
    if out and out[0].isdigit():
        out = "_" + out
    return out or "unnamed"


def _fmt(value) -> str:
    """One deterministic number path — byte-stability depends on it."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _numeric(value) -> bool:
    # bool is an int subclass; _fmt renders it 1/0.
    return isinstance(value, (int, float))


class _Family:
    """One metric family: TYPE/HELP header + sorted samples."""

    __slots__ = ("name", "mtype", "help", "samples")

    def __init__(self, name: str, mtype: str, help_text: str):
        self.name = name
        self.mtype = mtype
        self.help = help_text
        self.samples: List[Tuple[str, str]] = []

    def add(self, labels: List[Tuple[str, str]], value) -> None:
        suffix = "_total" if self.mtype == "counter" else ""
        self.samples.append(
            (f"{self.name}{suffix}{_labels(labels)}", _fmt(value)))

    def add_hist(self, labels: List[Tuple[str, str]], hist: Dict,
                 bounds) -> None:
        """One histogram series: cumulative ``_bucket`` samples in
        declared ``le`` order (ending at ``+Inf``), then ``_sum`` and
        ``_count``. Appended in order — render() keeps histogram
        samples unsorted because ``le`` values sort numerically, not
        lexically."""
        buckets = list(hist.get("buckets", ()))
        buckets += [0] * (len(bounds) + 1 - len(buckets))
        cum = 0
        for i, bound in enumerate(bounds):
            cum += int(buckets[i])
            self.samples.append((
                f"{self.name}_bucket"
                f"{_labels(labels + [('le', _fmt(float(bound)))])}",
                _fmt(cum)))
        cum += int(buckets[len(bounds)])
        self.samples.append((
            f"{self.name}_bucket{_labels(labels + [('le', '+Inf')])}",
            _fmt(cum)))
        self.samples.append((f"{self.name}_sum{_labels(labels)}",
                             _fmt(float(hist.get('sum', 0.0)))))
        self.samples.append((f"{self.name}_count{_labels(labels)}",
                             _fmt(int(hist.get('count', 0)))))

    def render(self, out: List[str]) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.mtype}")
        samples = self.samples if self.mtype == "histogram" \
            else sorted(self.samples)
        for sample, value in samples:
            out.append(f"{sample} {value}")


def _family_for_key(key: str) -> _Family:
    kind = merge_kind(key)
    name = PREFIX + _sanitize(key)
    if kind == MERGE_SUM and name.endswith("_total"):
        # The sample suffix is appended by _Family.add; a key that
        # already says _total (poa_windows_total) must not double it.
        name = name[:-len("_total")]
    if kind == MERGE_HIST:
        mtype = "histogram"
    else:
        mtype = "counter" if kind == MERGE_SUM else "gauge"
    return _Family(name, mtype,
                   f"racon_tpu metric {key} (merge={kind})")


def _render(families: List[_Family]) -> str:
    families = sorted(families, key=lambda f: f.name)
    out: List[str] = []
    for fam in families:
        fam.render(out)
    out.append("# EOF")
    return "\n".join(out) + "\n"


def render_registry(snapshot: Dict,
                    labels: Optional[List[Tuple[str, str]]] = None
                    ) -> str:
    """Render one registry snapshot (MetricsRegistry.snapshot()) as
    OpenMetrics text. ``labels`` are attached to every sample (the pull
    endpoint tags ``worker``)."""
    labels = labels or []
    fams: Dict[str, _Family] = {}
    for key in sorted(snapshot):
        value = snapshot[key]
        is_hist = key in HIST_BUCKETS and isinstance(value, dict)
        if not is_hist and not _numeric(value):
            continue
        fam = _family_for_key(key)
        if fam.name in fams:
            fam = fams[fam.name]
        else:
            fams[fam.name] = fam
        if is_hist:
            fam.add_hist(labels, value, HIST_BUCKETS[key])
        else:
            fam.add(labels, value)
    return _render(list(fams.values()))




def validate_openmetrics(text: str) -> List[str]:
    """Structural OpenMetrics check (the smoke/test gate — promtool is
    not in the image). Verifies: single trailing ``# EOF``; every
    sample parses as ``name[{labels}] value`` with a finite number;
    every sample's family has TYPE and HELP lines *before* it; counter
    samples end in ``_total``; histogram samples end in ``_bucket`` /
    ``_sum`` / ``_count`` and buckets carry an ``le`` label; families
    are not interleaved. Returns a list of problems (empty = valid)."""
    errors: List[str] = []
    lines = text.split("\n")
    if not text.endswith("\n"):
        errors.append("missing trailing newline")
    body = [ln for ln in lines if ln != ""]
    if not body or body[-1] != "# EOF":
        errors.append("missing '# EOF' terminator")
    if text.count("# EOF") != 1:
        errors.append("multiple '# EOF' terminators")
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    seen_families: List[str] = []
    for i, ln in enumerate(body):
        if ln == "# EOF":
            if i != len(body) - 1:
                errors.append("content after '# EOF'")
            break
        if ln.startswith("# TYPE ") or ln.startswith("# HELP "):
            parts = ln.split(" ", 3)
            if len(parts) < 4:
                errors.append(f"malformed meta line: {ln!r}")
                continue
            _, kw, fname, rest = parts
            table = types if kw == "TYPE" else helps
            if fname in table:
                errors.append(f"duplicate # {kw} for {fname}")
            table[fname] = rest
            if kw == "TYPE":
                if rest not in ("counter", "gauge", "histogram",
                                "summary", "info", "unknown"):
                    errors.append(f"bad type {rest!r} for {fname}")
                if seen_families and seen_families[-1] != fname:
                    seen_families.append(fname)
                elif not seen_families:
                    seen_families.append(fname)
            continue
        if ln.startswith("#"):
            errors.append(f"unexpected comment line: {ln!r}")
            continue
        # Sample: name[{labels}] value
        head, _, value = ln.rpartition(" ")
        if not head:
            errors.append(f"malformed sample line: {ln!r}")
            continue
        name = head.split("{", 1)[0]
        if "{" in head and not head.endswith("}"):
            errors.append(f"malformed labels in: {ln!r}")
        fam = name
        if fam not in types:
            # Family resolution: counters sample as <fam>_total,
            # histograms as <fam>_bucket/_sum/_count.
            for suf in ("_total", "_bucket", "_sum", "_count"):
                if name.endswith(suf) and name[:-len(suf)] in types:
                    fam = name[:-len(suf)]
                    break
        if fam not in types:
            errors.append(f"sample {name!r} has no # TYPE line")
            continue
        if fam not in helps:
            errors.append(f"sample {name!r} has no # HELP line")
        if types[fam] == "counter" and not name.endswith("_total"):
            errors.append(
                f"counter sample {name!r} lacks '_total' suffix")
        if types[fam] == "histogram":
            suffix = name[len(fam):]
            if suffix not in ("_bucket", "_sum", "_count"):
                errors.append(f"histogram sample {name!r} lacks "
                              f"'_bucket'/'_sum'/'_count' suffix")
            if suffix == "_bucket" and 'le="' not in head:
                errors.append(f"histogram bucket {name!r} lacks an "
                              f"'le' label")
        try:
            float(value)
        except ValueError:
            errors.append(f"non-numeric value {value!r} in: {ln!r}")
        if seen_families and seen_families[-1] != fam and \
                fam in seen_families:
            errors.append(f"family {fam!r} is interleaved")
    return errors
