"""Experiment reporting: metric aggregation + a static HTML browser
(homan_tpu/eval/report.py, whole; numpy and HTML, its output byte-equal to
the JAX module's).

Replaces the bokeh/pandas/dominate stack of the reference
(homan/eval/saveresults.py, logutils.py, analyze.py, htmlgrid.py) with
dependency-free inline-SVG loss curves and plain HTML tables.
"""
from __future__ import annotations

import html
import os
import pickle
from typing import Dict, List, Sequence

import numpy as np


def dump(opts: Dict, all_metrics: Dict[str, List], save_path: str):
    """Accumulated results pickle (homan/eval/saveresults.py:7-16)."""
    payload = {"opts": dict(opts), "metrics": {k: list(v) for k, v in
                                               all_metrics.items()}}
    with open(save_path, "wb") as f:
        pickle.dump(payload, f)
    return payload


def _svg_curve(values: Sequence[float], width=320, height=90,
               color="#2266cc") -> str:
    vals = np.asarray(values, np.float64)
    vals = vals[np.isfinite(vals)]
    if len(vals) < 2:
        return "<svg/>"
    lo, hi = float(vals.min()), float(vals.max())
    span = (hi - lo) or 1.0
    xs = np.linspace(4, width - 4, len(vals))
    ys = height - 4 - (vals - lo) / span * (height - 8)
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))
    return (f'<svg width="{width}" height="{height}">'
            f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{pts}"/>'
            f'<text x="4" y="12" font-size="10">{hi:.4g}</text>'
            f'<text x="4" y="{height - 2}" font-size="10">{lo:.4g}</text>'
            f"</svg>")


def metrics_table(metrics: Dict[str, Sequence[float]]) -> str:
    rows = []
    for key in sorted(metrics):
        vals = np.asarray(
            [v for v in np.ravel(metrics[key]) if isinstance(
                v, (int, float, np.floating, np.integer))], np.float64)
        if len(vals) == 0:
            continue
        rows.append(
            f"<tr><td>{html.escape(key)}</td>"
            f"<td>{np.nanmean(vals):.5g}</td><td>{np.nanmedian(vals):.5g}</td>"
            f"<td>{np.nanstd(vals):.3g}</td><td>{len(vals)}</td></tr>")
    return ("<table border=1 cellspacing=0 cellpadding=4>"
            "<tr><th>metric</th><th>mean</th><th>median</th>"
            "<th>std</th><th>n</th></tr>" + "".join(rows) + "</table>")


def make_exp_html(result_root: str, out_path: str | None = None) -> str:
    """Walk samples/*/results.pkl into one HTML report
    (homan/eval/analyze.py:12-115 + logutils.py role)."""
    out_path = out_path or os.path.join(result_root, "report.html")
    samples_dir = os.path.join(result_root, "samples")
    sections = []
    agg: Dict[str, List[float]] = {}
    if os.path.isdir(samples_dir):
        for name in sorted(os.listdir(samples_dir)):
            res_path = os.path.join(samples_dir, name, "results.pkl")
            if not os.path.exists(res_path):
                continue
            with open(res_path, "rb") as f:
                res = pickle.load(f)
            curves = ""
            for key, series in sorted(res.get("losses", {}).items()):
                series = np.ravel(series)
                if len(series) > 1:
                    curves += (f"<div style='display:inline-block;margin:4px'>"
                               f"<div>{html.escape(key)}</div>"
                               f"{_svg_curve(series)}</div>")
            imgs = ""
            for img in ("final_points.png", "detections_masks.png"):
                if os.path.exists(os.path.join(samples_dir, name, img)):
                    imgs += f'<img src="samples/{name}/{img}" height="160"/>'
            for k, v in res.get("metrics", {}).items():
                agg.setdefault(k, []).extend(
                    v if isinstance(v, list) else [v])
            sections.append(f"<h3>sample {name}</h3>{imgs}{curves}"
                            f"{metrics_table(res.get('metrics', {}))}")
    doc = ("<html><head><title>homan_tpu results</title></head><body>"
           f"<h1>{html.escape(result_root)}</h1>"
           "<h2>Aggregate</h2>" + metrics_table(agg)
           + "".join(sections) + "</body></html>")
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


def html_grid(rows: Dict[str, List[str]], out_path: str,
              title: str = "grid") -> str:
    """Simple media grid (homan/htmlgrid.py:29-57 role): label -> media paths."""
    body = ""
    for label, paths in rows.items():
        cells = ""
        for p in paths:
            if p.endswith((".mp4", ".webm")):
                cells += (f'<td><video src="{html.escape(p)}" height="140" '
                          'controls loop autoplay muted/></td>')
            else:
                cells += f'<td><img src="{html.escape(p)}" height="140"/></td>'
        body += f"<tr><td>{html.escape(label)}</td>{cells}</tr>"
    doc = (f"<html><head><title>{html.escape(title)}</title></head><body>"
           f"<table>{body}</table></body></html>")
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


def parse_experiment(result_root: str) -> Dict:
    """Collect one experiment's options + per-sample metric lists
    (homan/eval/analyze.py parse_res role). Reads the root results.pkl when
    present, else aggregates samples/*/results.pkl."""
    root_pkl = os.path.join(result_root, "results.pkl")
    if os.path.exists(root_pkl):
        with open(root_pkl, "rb") as f:
            payload = pickle.load(f)
        return {"root": result_root, "opts": payload.get("opts", {}),
                "metrics": payload.get("metrics", {})}
    metrics: Dict[str, List] = {}
    samples = os.path.join(result_root, "samples")
    for name in sorted(os.listdir(samples)) if os.path.isdir(samples) else []:
        spath = os.path.join(samples, name, "results.pkl")
        if not os.path.exists(spath):
            continue
        with open(spath, "rb") as f:
            res = pickle.load(f)
        for k, v in res.get("metrics", {}).items():
            metrics.setdefault(k, []).extend(np.ravel(v).tolist())
    return {"root": result_root, "opts": {}, "metrics": metrics}


def compare_experiments(result_roots: Sequence[str],
                        out_path: str,
                        sort_metric: str | None = None) -> str:
    """Cross-experiment comparison table (homan/eval/analyze.py:12-115 +
    logutils.df2html role): one row per experiment, mean of each metric,
    differing options highlighted; optionally sorted by a metric."""
    exps = [parse_experiment(r) for r in result_roots]
    all_keys = sorted({k for e in exps for k in e["metrics"]})
    opt_keys = sorted({k for e in exps for k in e["opts"]})
    # only show options that differ between experiments
    diff_opts = [k for k in opt_keys
                 if len({repr(e["opts"].get(k)) for e in exps}) > 1]

    def mean_of(e, k):
        vals = np.asarray([v for v in np.ravel(e["metrics"].get(k, []))
                           if isinstance(v, (int, float, np.floating,
                                             np.integer))], np.float64)
        return float(np.nanmean(vals)) if len(vals) else float("nan")

    if sort_metric in all_keys:
        exps.sort(key=lambda e: mean_of(e, sort_metric))
    parts = ["<html><body><h1>Experiment comparison</h1>",
             "<table border=1 cellspacing=0 cellpadding=4><tr>",
             "<th>experiment</th>"]
    parts += [f"<th>{html.escape(k)}</th>" for k in diff_opts]
    parts += [f"<th>{html.escape(k)}</th>" for k in all_keys]
    parts.append("</tr>")
    for e in exps:
        parts.append(f"<tr><td>{html.escape(os.path.basename(e['root']) or e['root'])}</td>")
        for k in diff_opts:
            parts.append(f"<td>{html.escape(str(e['opts'].get(k, '')))}</td>")
        for k in all_keys:
            m = mean_of(e, k)
            parts.append(f"<td>{m:.5g}</td>" if np.isfinite(m)
                         else "<td>-</td>")
        parts.append("</tr>")
    parts.append("</table></body></html>")
    with open(out_path, "w") as f:
        f.write("".join(parts))
    return out_path
