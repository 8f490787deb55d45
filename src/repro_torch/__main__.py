"""``python -m repro_torch`` - the port's CLI.

Subcommands:
  * ``sweep`` - batched experiment grids on the card (see
    ``repro_torch.sweep.__main__``; ``--device cpu`` runs on the CPU).

    PYTHONPATH=src python -m repro_torch sweep --suites azure --n-instances 28
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
    raise SystemExit(f"unknown subcommand {cmd!r}; try: sweep")


if __name__ == "__main__":
    main()
