"""Render ``python -m repro_torch.launch.dryrun`` JSONL records as a
markdown table, the newest record per (arch, shape, mesh, variant)
(``scripts/make_roofline_table.py`` for the port's measured records).

  python scripts/torch_make_roofline_table.py records.jsonl [MESH]
"""

from __future__ import annotations

import json
import re
import sys


def fmt(x, spec=".4g"):
    if x is None:
        return "-"
    return x if isinstance(x, str) else format(x, spec)


def fmt_gib(b):
    return "-" if not isinstance(b, (int, float)) else f"{b / 2**30:.2f}"


def op_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and arguments."""
    for noise in ("void ", "std::enable_if<!(false), void>::type ", "at::native::",
                  "(anonymous namespace)::", "at_cuda_detail::cub::"):
        name = name.replace(noise, "")
    return name.split("(")[0].split("<")[0][:40]


def rows_of(path: str, mesh_filter: str | None = None) -> list:
    latest = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                r = json.loads(line)
                latest[(r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))] = r
    rows = list(latest.values())  # in first-seen order: the registry's
    return [r for r in rows if not mesh_filter or r["mesh"] == mesh_filter]


def main(path: str = "dryrun_results.jsonl", mesh_filter: str | None = None) -> None:
    print("| arch | shape | mesh | status | cut | wall s | device s | idle | mfu |"
          " peak GiB | args GiB | dominant | top op (launches) |")
    print("|" + "---|" * 13)
    for r in rows_of(path, mesh_filter):
        name = r["arch"] + ("" if r.get("variant", "baseline") == "baseline"
                            else f" [{r['variant']}]")
        if r["status"] != "ok":
            reason = r.get("skip_reason") or r.get("error") or ""
            need = re.search(r"needs (\d+) B", reason)
            if need:  # a cell that does not fit one card
                held = re.search(r"holding it: (\S+)", reason)
                reason = (f"needs {fmt_gib(int(need.group(1)))} GiB at batch 1; smallest "
                          f"layout holding it: {held.group(1) if held else 'none offered'}")
            reason = reason[:80]
            print(f"| {name} | {r['shape']} | {r['mesh']} | {r['status']} | - | - | - |"
                  f" - | - | - | - | - | {reason} |")
            continue
        ro, mem = r.get("roofline", {}), r.get("memory", {})
        cut = ", ".join(f"{a} {f} -> {t}" for a, (f, t) in r.get("reduced", {}).items())
        top = (r.get("top_ops") or [{}])[0]
        top_s = f"{op_name(top.get('name', '-'))} ({top.get('launches', '-')})"
        print(f"| {name} | {r['shape']} | {r['mesh']} | ok | {cut or 'none'} | "
              f"{fmt(ro.get('wall_s'))} | {fmt(ro.get('device_s'))} | "
              f"{fmt(ro.get('idle_share'), '.3f')} | {fmt(ro.get('mfu'), '.4f')} | "
              f"{fmt_gib(mem.get('peak_bytes'))} | {fmt_gib(mem.get('argument_bytes'))} | "
              f"{ro.get('dominant', '-')} | {top_s} |")


if __name__ == "__main__":
    main(*sys.argv[1:])
