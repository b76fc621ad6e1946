"""The rules that ``BENCHMARK.json`` and every file it names keep.

``check(root)`` lists what breaks them in the benchmark tree at ``root``
(empty when none does).  The rules hold for any cell and configuration,
so a later cell joins through new files (``configs/<name>.json``,
``traffic/<name>.json``, ``limits/<cell>.json``, a reader
``metrics/<metric>.py`` where it brings a metric) and new entries, the
only edit to an existing line being the cell's name appended to the
``workloads`` lists of the metrics it reports.  What was accepted before
stays pinned: the first four cells, in order and on one chip each, and
the two configurations' River settings with ``reduced`` empty.

Each rule group is a function of ``(spec, root)`` returning its
problems as strings.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}
# the traffic kinds run.py has a runner for
KINDS = ("learn", "serve")

ACCEPTED_CELLS = ("arf_qo_t10_m1023_f16_c64.friedman_gra",
                  "arf_sketch_t10_m1023_f16_k16.friedman_gra_cauchy",
                  "arf_qo_t10_m1023_f16_c64.friedman_stable",
                  "arf_qo_t10_m1023_f16_c64.serve_loguniform")
ACCEPTED_CONFIGS = ("arf_qo_t10_m1023_f16_c64", "arf_sketch_t10_m1023_f16_k16")

# River's ARFRegressor settings that the port expresses, at the values
# the configurations' sources name (aggregation_method='mean')
RIVER = {"n_trees": 10, "lam": 6, "subspace": "sqrt", "grace_period": 50,
         "delta": 0.01, "tau": 0.05, "vote": "mean"}
# widths of a row or a table: never cut
WIDTHS = {"n_features", "n_bins", "sketch_k"}


def _config(root, entry):
    return json.loads((Path(root) / entry["file"]).read_text())


def _traffic(root, name):
    return json.loads((Path(root) / "perfbench" / "traffic" / f"{name}.json").read_text())


def cell_metrics(root, cell):
    """(end-to-end names, per-layer names) that ``cell`` reports, as the
    harness reads them (``harness.spec.load``)."""
    from harness import spec as hspec
    c = hspec.load(cell, Path(root))
    return {m["name"] for m in c.end_to_end}, {m["name"] for m in c.per_layer}


def keys(spec, root):
    out = []
    if set(spec) != KEYS:
        out.append(f"top-level keys {sorted(spec)}")
    for c in spec["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c.get('name')}: keys {sorted(c)}")
    for w in spec["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"cell {w.get('name')}: keys {sorted(w)}")
    for m in spec["end_to_end"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound", "source"}:
            out.append(f"metric {m.get('name')}: keys {sorted(m)}")
        elif m["source"] not in ("host_clock", "device_trace"):
            out.append(f"metric {m['name']}: source {m['source']!r}")
        elif not 0.01 <= m["bound"] <= 0.25:
            out.append(f"metric {m['name']}: bound {m['bound']}")
    for m in spec["per_layer"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "source", "layer", "moves"}:
            out.append(f"metric {m.get('name')}: keys {sorted(m)}")
    return out


def names(spec, root):
    out = []
    listed = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
              for x in spec[k]]
    listed += [w["config"] for w in spec["workloads"]] + [w["traffic"] for w in spec["workloads"]]
    listed += [r for c in spec["configs"] for r in c["reduced"]]
    out += [f"name {n!r}" for n in listed if not NAME.match(n)]
    for k in ("end_to_end", "per_layer"):
        for m in spec[k]:
            if not UNIT.match(m["unit"]):
                out.append(f"metric {m['name']}: unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"metric {m['name']}: better {m['better']!r}")
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        if len({x["name"] for x in spec[k]}) != len(spec[k]):
            out.append(f"{k}: a name twice")
    for x in spec["configs"] + spec["workloads"]:
        if not (1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]):
            out.append(f"{x['name']}: why")
    if len((Path(root) / "BENCHMARK.json").read_bytes()) > 64 * 1024:
        out.append("BENCHMARK.json over 64 KiB")
    return out


def cells(spec, root):
    """The accepted cells first, in order, on one chip; every cell named
    ``<config>.<traffic>`` with its files, a runner for its traffic's
    kind, ``setup_s`` and another end-to-end metric, and a per-layer
    metric; four chips within the 25 % rule; every configuration used."""
    out = []
    ws = spec["workloads"]
    first = [w["name"] for w in ws[:len(ACCEPTED_CELLS)]]
    if first != list(ACCEPTED_CELLS):
        out.append(f"the accepted cells {ACCEPTED_CELLS} are not the first, in order: {first}")
    confs = {c["name"] for c in spec["configs"]}
    for w in ws:
        n = w["name"]
        if n in ACCEPTED_CELLS and w["chips"] != 1:
            out.append(f"{n}: an accepted cell moved off one chip")
        if w["chips"] not in (1, 4):
            out.append(f"{n}: chips {w['chips']}")
        if n != f"{w['config']}.{w['traffic']}":
            out.append(f"{n}: not named <config>.<traffic>")
        if w["config"] not in confs:
            out.append(f"{n}: no configuration {w['config']!r}")
        try:
            kind = _traffic(root, w["traffic"])["kind"]
            if kind not in KINDS:
                out.append(f"{n}: no runner for traffic kind {kind!r}")
        except (OSError, ValueError, KeyError) as e:
            out.append(f"{n}: traffic file: {e}")
        try:
            limits = json.loads((Path(root) / "perfbench" / "limits" / f"{n}.json").read_text())
            if not limits or not all(v >= 0 for v in limits.values()):
                out.append(f"{n}: limits {limits}")
        except (OSError, ValueError) as e:
            out.append(f"{n}: limits file: {e}")
        try:
            e2e, layer = cell_metrics(root, n)
        except (OSError, ValueError, KeyError) as e:
            out.append(f"{n}: does not load: {e!r}")
            continue
        if "setup_s" not in e2e or len(e2e) < 2:
            out.append(f"{n}: reports {sorted(e2e)}: setup_s and one more are due")
        if not layer:
            out.append(f"{n}: reports no per-layer metric")
    n4 = sum(w["chips"] == 4 for w in ws)
    if n4 > max(1, len(ws) // 4):
        out.append(f"{n4} of {len(ws)} cells ask for four chips")
    used = {w["config"] for w in ws}
    out += [f"configuration {c} runs in no cell" for c in sorted(confs - used)]
    return out


def per_layer(spec, root):
    """Each per-layer metric moves an end-to-end metric that every cell
    reporting it reports, is reported somewhere, and has its reader."""
    out = []
    e2e_names = {m["name"] for m in spec["end_to_end"]}
    reporting = {}
    for w in spec["workloads"]:
        try:
            reporting[w["name"]] = cell_metrics(root, w["name"])
        except (OSError, ValueError, KeyError):
            pass            # cells() reports it
    for m in spec["per_layer"]:
        n = m["name"]
        if m["moves"] not in e2e_names:
            out.append(f"{n}: moves {m['moves']!r}, no end-to-end metric")
        listed = [w for w, (e2e, layer) in reporting.items() if n in layer]
        if not listed:
            out.append(f"{n}: no cell reports it")
        for w in m.get("workloads", []):
            if w not in reporting:
                out.append(f"{n}: lists {w!r}, no cell")
            elif m["moves"] not in reporting[w][0]:
                out.append(f"{n}: {w} does not report {m['moves']}")
        if not (Path(root) / "perfbench" / "metrics" / f"{n}.py").exists():
            out.append(f"{n}: no reader metrics/{n}.py")
        if n.endswith("_roofline") and m["unit"] != "%":
            out.append(f"{n}: a roofline share in {m['unit']!r}")
    for m in spec["end_to_end"]:
        for w in m.get("workloads", []):
            if w not in reporting:
                out.append(f"{m['name']}: lists {w!r}, no cell")
    return out


def _named(cfg):
    """Keys the file accounts for: from the source, departed from (each
    ``departures`` key names one or more, space-separated), assumed."""
    src = list(cfg["from_source"])
    dep = [k for key in cfg["departures"] for k in key.split()]
    return src, dep, list(cfg["assumed"])


def configs(spec, root):
    """Each configuration's file: under ``paths``, its own, with the
    entry's name and source, something assumed, its plain reference,
    every key it names present, nothing both assumed and sourced; each
    ``reduced`` key in the file with its published value beside it in
    ``published``, and no width among them; the accepted ones cut
    nowhere."""
    out = []
    files = [c["file"] for c in spec["configs"]]
    if len(set(files)) != len(files):
        out.append("two configurations share a file")
    for c in spec["configs"]:
        n = c["name"]
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in spec["paths"]):
            out.append(f"{n}: file {c['file']} outside paths")
        try:
            cfg = _config(root, c)
        except (OSError, ValueError) as e:
            out.append(f"{n}: {e}")
            continue
        if cfg.get("name") != n or cfg.get("source") != c["source"]:
            out.append(f"{n}: the file's name or source differs from the entry's")
        if not cfg.get("assumed"):
            out.append(f"{n}: nothing assumed")
        if not (Path(root) / cfg.get("reference", "")).is_file():
            out.append(f"{n}: no reference {cfg.get('reference')!r}")
        src, dep, assumed = _named(cfg)
        out += [f"{n}: names {k!r}, not in the file" for k in src + dep + assumed
                if k not in cfg and k != "leaf_prediction"]
        out += [f"{n}: {k!r} both assumed and from the source or a departure"
                for k in set(assumed) & set(src + dep)]
        if not isinstance(cfg["assumed"], list):
            out += [f"{n}: assumed {k!r} without its reason"
                    for k, why in cfg["assumed"].items() if not why]
        published = cfg.get("published", {})
        for k in c["reduced"]:
            if k not in cfg:
                out.append(f"{n}: reduced {k!r} is not in the file")
            elif k not in published or published[k] == cfg[k]:
                out.append(f"{n}: reduced {k!r} without its published value")
            if k in WIDTHS or k.endswith(("_dim", "_rank")):
                out.append(f"{n}: reduced {k!r} is a width")
        if len(c["reduced"]) > 16:
            out.append(f"{n}: more than 16 reduced keys")
        if n in ACCEPTED_CONFIGS and c["reduced"]:
            out.append(f"{n}: an accepted configuration is cut ({c['reduced']})")
    missing = set(ACCEPTED_CONFIGS) - {c["name"] for c in spec["configs"]}
    out += [f"accepted configuration {m} is gone" for m in sorted(missing)]
    return out


def _keeps_river(key, cfg):
    if key == "subspace":
        F = cfg["n_features"]
        return round(cfg["subspace"] * F) == int(F ** 0.5)
    return cfg[key] == RIVER[key]


def river(spec, root):
    """River's ARFRegressor settings that the port expresses: each equals
    River's value under ``from_source``, or is named with its reason
    under ``departures``, ``assumed`` (as a map of reasons) or
    ``reduced`` (with River's value under ``published``).  The accepted
    configurations keep River's values."""
    out = []
    for c in spec["configs"]:
        n = c["name"]
        try:
            cfg = _config(root, c)
        except (OSError, ValueError):
            continue            # configs() reports it
        deps = {k: why for key, why in cfg["departures"].items() for k in key.split()}
        assumed = cfg["assumed"] if isinstance(cfg["assumed"], dict) else {}
        published = cfg.get("published", {})
        for k, want in RIVER.items():
            if k not in cfg:
                out.append(f"{n}: River's {k} is not set")
                continue
            kept = _keeps_river(k, cfg)
            if n in ACCEPTED_CONFIGS and not kept:
                out.append(f"{n}: accepted configuration's {k} = {cfg[k]!r}, River's is {want!r}")
            if k in cfg["from_source"]:
                if not kept:
                    out.append(f"{n}: {k} = {cfg[k]!r} under from_source, River's is {want!r}")
            elif not (deps.get(k) or assumed.get(k)
                      or (k in c["reduced"] and published.get(k) == want)):
                out.append(f"{n}: {k} = {cfg[k]!r} neither River's under from_source nor "
                           f"named with its reason")
    return out


def command(spec, root):
    out = []
    if spec["command"] != ["python3", "perfbench/run.py"] or spec["paths"] != ["perfbench"]:
        out.append(f"command {spec['command']} or paths {spec['paths']} changed")
    n = 24
    if not 1 <= spec["run_seconds"] <= 51 or \
            2 + 14 * n * (spec["run_seconds"] + 60) + n * 2 * 90 + 1200 > 43200:
        out.append(f"run_seconds {spec['run_seconds']}")
    return out


RULES = (keys, names, cells, per_layer, configs, river, command)


def check(root):
    """Every rule's problems for the benchmark tree at ``root``."""
    spec = json.loads((Path(root) / "BENCHMARK.json").read_text())
    return [p for rule in RULES for p in rule(spec, root)]
