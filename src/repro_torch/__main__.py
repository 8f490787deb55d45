"""``python -m repro_torch`` - the port's CLI.

Subcommands:
  * ``sweep`` - batched experiment grids on the card (see
    ``repro_torch.sweep.__main__``; ``--device cpu`` runs on the CPU).
  * ``obs`` - summarize a JSONL observability run log (spans + counters,
    ``obs.export_jsonl``), optionally converting it to Perfetto JSON.
  * ``validate`` - check the workload suites for malformed rows
    (``repro_torch.resilience.validate``; exit status 1 on any).

    PYTHONPATH=src python -m repro_torch sweep --suites azure --n-instances 28
    PYTHONPATH=src python -m repro_torch obs run.obs.jsonl --perfetto t.json
    PYTHONPATH=src python -m repro_torch validate --suites azure huawei
"""
from __future__ import annotations

import sys


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return
    cmd, rest = argv[0], argv[1:]
    if cmd == "sweep":
        from .sweep.__main__ import main as sweep_main
        sweep_main(rest)
        return
    if cmd == "obs":
        from .obs.cli import main as obs_main
        raise SystemExit(obs_main(rest))
    if cmd == "validate":
        from .resilience.validate import main as validate_main
        validate_main(rest)
        return
    raise SystemExit(f"unknown subcommand {cmd!r}; try: sweep, obs, "
                     "validate")


if __name__ == "__main__":
    main()
