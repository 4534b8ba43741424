"""Summarize a traced partitioning run directory.

Reads every per-host ``trace_h*.jsonl`` event log under RUN_DIR (plus
``timing.json`` when the worker published one) and prints the per-phase /
per-round summary table: round latency percentiles (p50/p90/p99),
per-phase time breakdown, collective payload bytes and per-host peak
RSS.  Optionally also writes the merged Perfetto-loadable Chrome trace.

Typical use, after a traced multihost run::

  PYTHONPATH=src python -m repro_torch.tools.launch_multihost ... \\
      --out /tmp/run/out --trace-dir /tmp/run/out/trace
  PYTHONPATH=src python -m repro_torch.tools.report_run /tmp/run/out \\
      --trace /tmp/run/trace.json

Open the trace at https://ui.perfetto.dev (or chrome://tracing): one
track per host, spans for ingest/round/snapshot/finalize, counter tracks
for payload bytes and RSS.  It imports no torch: it runs anywhere the
logs are, not only on the machines that produced them.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="directory holding trace_h*.jsonl "
                    "logs (searched one subdirectory deep)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="also write the merged Chrome trace_event JSON "
                    "(Perfetto-loadable) here")
    ap.add_argument("--json", default=None, metavar="OUT.json",
                    help="also dump the raw report dict as JSON "
                    "('-' for stdout)")
    ns = ap.parse_args(argv)

    from repro_torch.obs import export, report

    rep = report.summarize_run(ns.run_dir)
    print(report.render(rep))
    if ns.trace:
        export.write_chrome_trace(ns.trace, ns.run_dir)
        print(f"\nchrome trace written to {ns.trace} "
              f"(open in https://ui.perfetto.dev)")
    if ns.json:
        payload = json.dumps(rep, indent=2, default=str)
        if ns.json == "-":
            print(payload)
        else:
            Path(ns.json).write_text(payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
