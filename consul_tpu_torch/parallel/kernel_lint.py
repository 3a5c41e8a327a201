"""The port's program-contract gate, the counterpart of tools/hlo_lint.py.

    python -m consul_tpu_torch.parallel.kernel_lint --check [--device cpu]
    python -m consul_tpu_torch.parallel.kernel_lint --update-baseline [--device cpu]
    python -m consul_tpu_torch.parallel.kernel_lint --json [--device cpu]
    python -m consul_tpu_torch.parallel.kernel_lint --list

Every entry point in the registry (parallel/kernel_audit.py) is built and
called on the device — the card at full width by default, `--device cpu`
at N = 256 — and judged against its topology-stamped record in the
committed manifest KERNELBUDGET_r01.json: kernel census, host syncs and
O(page) reads, in place honored, bytes per slot, peak bytes and
allocations within budget, one build; a node-sharded entry also the
gather law and the block-scaling law over its records at B = 1, 2, 4.
On the card every hand-written kernel (kernels.KERNELS) must be launched
by some entry.

The rules, the registry and the judge are pure and live in
kernel_audit.py; this file owns the filesystem side: manifest I/O, the
AST scan of `kernels.launch_*` call sites behind registry parity, and
orchestration.  A record judged against a budget from another backend or
card refuses (exit 2) instead of failing: re-baseline on that topology
with --update-baseline.  Exit 1 on a violation or a parity or coverage
failure, 0 when every record holds.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from consul_tpu_torch.utils import devices

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join(REPO, "KERNELBUDGET_r01.json")
DEFAULT_TOLERANCE = 0.25
# where the registry-parity scan looks for kernel launch sites
PARITY_ROOT = "consul_tpu_torch"


# ------------------------------------------------------------ parity scan

def _launcher(call: ast.Call) -> Optional[str]:
    """`launch_x` for a call of `kernels.launch_x(...)`, else None."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr.startswith("launch_") \
            and isinstance(f.value, ast.Name) and f.value.id == "kernels":
        return f.attr
    return None


def scan_launch_sites(repo: str = REPO) -> List[Tuple[str, str, str]]:
    """Every call of `kernels.launch_*` under PARITY_ROOT as (relpath,
    enclosing function, launcher): the input of
    kernel_audit.registry_parity."""
    sites: List[Tuple[str, str, str]] = []
    root = os.path.join(repo, PARITY_ROOT)
    paths = sorted(os.path.join(d, n) for d, _, names in os.walk(root)
                   for n in names if n.endswith(".py"))
    for path in paths:
        rel = os.path.relpath(path, repo).replace(os.sep, "/")
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())

        def visit(node, func: str):
            for child in ast.iter_child_nodes(node):
                inner = func
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    inner = child.name
                if isinstance(child, ast.Call):
                    name = _launcher(child)
                    if name is not None:
                        sites.append((rel, func, name))
                visit(child, inner)

        visit(tree, "<module>")
    return sites


# ------------------------------------------------------------ manifest IO

def load_baseline(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def save_baseline(path: str, manifest: dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")


# ------------------------------------------------------------- orchestrate

def measure_all(device: torch.device) -> Dict[str, dict]:
    """Measure every registry entry on `device`: {name: record}, each
    straight from kernel_audit.measure_entry, with the seconds it took."""
    from consul_tpu_torch.parallel import kernel_audit
    records: Dict[str, dict] = {}
    for spec in kernel_audit.REGISTRY:
        t0 = time.monotonic()
        rec = kernel_audit.measure_entry(spec, device)
        rec["measure_s"] = round(time.monotonic() - t0, 3)
        records[spec.name] = rec
    return records


def judge_all(records: Dict[str, dict], manifest: dict,
              tolerance: float) -> dict:
    """Judge every record against the manifest's record of its backend.
    Refusals (no budget, another topology: cannot judge, exit 2) are kept
    apart from violations (judged and failed, exit 1)."""
    from consul_tpu_torch.parallel import kernel_audit
    base_entries = manifest.get("entries", {})
    violations: List[dict] = []
    refused: List[dict] = []
    verdicts: Dict[str, dict] = {}
    for name, rec in sorted(records.items()):
        backend = rec["topology"]["backend"]
        base = base_entries.get(name, {}).get(backend)
        if base is None:
            refused.append({"entry": name, "backend": backend,
                            "why": "no committed budget: run "
                                   "--update-baseline"})
            continue
        v = kernel_audit.judge_record(rec, base, tolerance)
        verdicts[name] = v
        if v["verdict"] == "topology":
            refused.append({"entry": name, "backend": backend,
                            "why": "topology stamp mismatch: re-baseline "
                                   "on this topology",
                            **{k: v[k] for k in ("baseline_topology",
                                                 "run_topology")}})
        elif not v["ok"]:
            violations.append({"entry": name, "failures": v["failures"]})
        verdicts[name]["scaling"] = kernel_audit.judge_scaling(
            rec.get("scaling") or {}, tolerance)
        if not verdicts[name]["scaling"]["ok"]:
            violations.append({"entry": name, "failures": [
                {"rule": "block-scaling",
                 "detail": str(verdicts[name]["scaling"])}]})
    return {"violations": violations, "refused": refused,
            "verdicts": verdicts}


def check(device=None, baseline: str = DEFAULT_BASELINE,
          update: bool = False) -> dict:
    """Measure, (with `update`) write the records into the manifest, and
    judge: the summary with the records and verdicts, and `rc` the exit
    code.  The card unless `device` names another."""
    from consul_tpu_torch.parallel import kernel_audit
    t0 = time.monotonic()
    dev = devices.resolve(device)
    manifest = load_baseline(baseline)
    tolerance = manifest.get("tolerance", DEFAULT_TOLERANCE)
    records = measure_all(dev)
    parity = kernel_audit.registry_parity(scan_launch_sites())
    if update:
        manifest.setdefault("version", "r01")
        manifest.setdefault("tolerance", DEFAULT_TOLERANCE)
        ents = manifest.setdefault("entries", {})
        for name, rec in records.items():
            rec = {k: v for k, v in rec.items() if k != "measure_s"}
            ents.setdefault(name, {})[rec["topology"]["backend"]] = rec
        save_baseline(baseline, manifest)
        manifest = load_baseline(baseline)
    judged = judge_all(records, manifest, tolerance)
    # every hand-written kernel launched by some entry: on the card
    coverage = kernel_audit.launch_coverage(records) \
        if dev.type == "cuda" else None
    ok = not judged["violations"] and not judged["refused"] \
        and parity["ok"] and (coverage is None or coverage["ok"])
    rc = 1 if judged["violations"] or not parity["ok"] \
        or (coverage is not None and not coverage["ok"]) \
        else 2 if judged["refused"] else 0
    return {"tool": "kernel_lint", "ok": ok, "rc": rc,
            "device": str(dev), "entries": len(records),
            "violations": judged["violations"], "refused": judged["refused"],
            "parity": parity, "coverage": coverage, "tolerance": tolerance,
            "updated": update, "wall_s": round(time.monotonic() - t0, 2),
            "records": records, "verdicts": judged["verdicts"]}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="kernel_lint", description=__doc__.splitlines()[0])
    p.add_argument("--check", action="store_true",
                   help="measure and judge against the committed manifest")
    p.add_argument("--update-baseline", action="store_true", dest="update",
                   help="write the measured records into the manifest "
                        "(merged per entry and backend), then judge")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the records and verdicts as JSON too")
    p.add_argument("--list", action="store_true", dest="list_entries",
                   help="list the registry's entries and exit")
    p.add_argument("--device", default=None,
                   help="cuda (the default: the card) or cpu")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help="the budget manifest's path")
    args = p.parse_args(argv)

    if args.list_entries:
        from consul_tpu_torch.parallel import kernel_audit
        for spec in kernel_audit.REGISTRY:
            print(f"{spec.name:32s} topologies="
                  f"{list(kernel_audit.TOPOLOGIES)} launch sites="
                  f"{len(spec.covers)}")
        return 0
    if not (args.check or args.update or args.as_json):
        p.print_help()
        return 0
    summary = check(args.device, args.baseline, args.update)
    if not args.as_json:
        summary = {k: v for k, v in summary.items()
                   if k not in ("records", "verdicts")}
    print(json.dumps(summary, sort_keys=True, default=str))
    return summary["rc"]


if __name__ == "__main__":
    sys.exit(main())
