"""``python -m repro_torch sweep``: evaluate a DVBP experiment grid on the
card (the reference's ``python -m repro sweep``, all 21 scan policies;
``--suites azure_trace --trace-root DIR`` reads an Azure Packing2020 dump).
The legacy ``python -m repro_torch.sweep`` runs the same with a migration
warning.

    PYTHONPATH=src python -m repro_torch sweep --suites azure \
        --n-instances 28 --n-items 5000 --preds clairvoyant lognormal:1.0 \
        --seeds 0,1 --block-events 256
    # the same command again: every group prints "skip ... (cached)"
    PYTHONPATH=src python -m repro_torch sweep --device cpu --n-items 200
    # the consolidation axis: each value adds a grid column
    PYTHONPATH=src python -m repro_torch sweep --device cpu \
        --consolidate none underload:t0.25:e32
    # checkpoint every replay under STORE/checkpoints: a killed sweep rerun
    # with the same arguments resumes mid-scan, with the same store
    PYTHONPATH=src python -m repro_torch sweep --resume \
        --checkpoint-every 2048
    # two processes, each a slice of the grid, one store; then the merged
    # summary (the store equals a single-process run's)
    PYTHONPATH=src python -m repro_torch sweep --hosts 2 --store DIR
    # each replay's lanes split across every local card
    PYTHONPATH=src python -m repro_torch sweep --shard always
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from ..consolidate import ConsolidationSpec
from ..core.torchsim import SCAN_POLICIES
from .grid import PredModel, SuiteSpec, SweepSpec, run_sweep, summarize_sweep
from .store import SweepStore

SUITE_DEFAULT_SEED = {"azure": 2026, "huawei": 77, "azure_trace": 0}


def _pred(token: str) -> PredModel:
    kind, _, param = token.partition(":")
    if kind in ("lognormal", "uniform") and not param:
        unit = "SIGMA" if kind == "lognormal" else "EPS"
        raise SystemExit(f"--preds {kind} needs a parameter: {kind}:{unit}")
    return PredModel(kind, float(param) if param else 0.0)


def main(argv=None, prog: str = "python -m repro_torch sweep") -> None:
    ap = argparse.ArgumentParser(
        prog=prog,
        description="Evaluate a DVBP experiment grid in batched replays on "
                    "the card.")
    ap.add_argument("--suites", nargs="+", default=["azure"],
                    choices=["azure", "huawei", "azure_trace"])
    ap.add_argument("--n-instances", type=int, default=6)
    ap.add_argument("--n-items", type=int, default=500)
    ap.add_argument("--suite-seed", type=int, default=None,
                    help="instance-generator seed (default: family-specific)")
    ap.add_argument("--trace-root", default="data/azure",
                    help="Azure Packing2020 dump directory (azure_trace)")
    ap.add_argument("--policies", default="all",
                    help=f"comma list from {','.join(SCAN_POLICIES)} "
                         "or 'all' (parametric names like cbd_beta4 / "
                         "cbdt_rho3600 parse too)")
    ap.add_argument("--preds", nargs="+", default=["clairvoyant"],
                    help="prediction models: none | clairvoyant | "
                         "lognormal:SIGMA | uniform:EPS")
    ap.add_argument("--seeds", default="0",
                    help="comma list of seeds for noisy prediction models")
    ap.add_argument("--max-bins", type=int, default=64)
    ap.add_argument("--max-bins-cap", type=int, default=8192)
    ap.add_argument("--consolidate", nargs="+", default=["none"],
                    help="consolidation scenario axis: none | "
                         "underload[:THRESHOLD[:BUDGET]] | "
                         "periodic:DT[:THRESHOLD[:BUDGET]] (tagged knobs "
                         "t/b/e/c/dt accepted, e.g. underload:t0.25:b64); "
                         "each value adds a grid column")
    ap.add_argument("--store", default="experiments/sweeps",
                    help="result-store directory")
    ap.add_argument("--no-store", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute even if the store has results")
    ap.add_argument("--block-events", type=int, default=0,
                    help="events per megakernel launch (0/1 = per-event "
                         "replay); execution knob only, never changes "
                         "results")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the replay (default cuda; cpu runs "
                         "the plain PyTorch select)")
    ap.add_argument("--resume", action="store_true",
                    help="checkpoint every replay under STORE/checkpoints "
                         "and resume a killed sweep bit for bit (sugar for "
                         "--checkpoint-dir STORE/checkpoints)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot the replay's carry here between "
                         "segments; a rerun resumes from the last snapshot")
    ap.add_argument("--checkpoint-every", type=int, default=2048,
                    help="events between checkpoint snapshots")
    ap.add_argument("--shard", default="auto",
                    choices=["auto", "never", "always"],
                    help="split each replay's lanes across the local "
                         "devices (auto: when there are several)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="launch N worker processes, each running a 1/N "
                         "slice of the (suite, pred, policy, "
                         "consolidation) grid against the shared store "
                         "(journal-merged; the final records equal a "
                         "single-process run)")
    ap.add_argument("--host-index", type=int, default=None,
                    help="run only this host's grid slice (normally set "
                         "by --hosts, or via REPRO_HOST_INDEX)")
    ap.add_argument("--host-count", type=int, default=None,
                    help="total hosts sharing the grid (with "
                         "--host-index, or via REPRO_HOST_COUNT)")
    args = ap.parse_args(argv)

    if args.hosts and args.hosts > 1:
        # one process a slice, the slice given by the environment; the
        # store's journal and lock merge their groups
        if args.no_store:
            raise SystemExit("--hosts needs a store to merge results into")
        base, skip = [], False
        for a in (argv if argv is not None else sys.argv[1:]):
            if skip:
                skip = False
            elif a == "--hosts":
                skip = True
            elif not a.startswith("--hosts="):
                base.append(a)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch", "sweep"] + base,
            env=dict(os.environ, REPRO_HOST_INDEX=str(i),
                     REPRO_HOST_COUNT=str(args.hosts)))
            for i in range(args.hosts)]
        rcs = [p.wait() for p in procs]
        if any(rcs):
            raise SystemExit(f"worker processes failed: rc={rcs}")
        # every group is in the store now: the grid again, as store reads
        # (the workers already honoured --force on their slices)
        args = ap.parse_args(base)
        args.force = False

    host_index = args.host_index if args.host_index is not None else \
        int(os.environ.get("REPRO_HOST_INDEX", "0"))
    host_count = args.host_count if args.host_count is not None else \
        (int(os.environ["REPRO_HOST_COUNT"])
         if "REPRO_HOST_COUNT" in os.environ else None)

    policies = SCAN_POLICIES if args.policies == "all" else \
        tuple(args.policies.split(","))
    suites = tuple(
        SuiteSpec(fam, args.n_instances, args.n_items,
                  args.suite_seed if args.suite_seed is not None
                  else SUITE_DEFAULT_SEED[fam], trace_root=args.trace_root)
        for fam in args.suites)
    spec = SweepSpec(
        suites=suites, policies=policies,
        predictions=tuple(_pred(t) for t in args.preds),
        seeds=tuple(int(s) for s in args.seeds.split(",")),
        max_bins=args.max_bins, max_bins_cap=args.max_bins_cap,
        consolidations=tuple(ConsolidationSpec.parse(t)
                             for t in args.consolidate))
    store = None if args.no_store else SweepStore(args.store)
    ckpt_dir = args.checkpoint_dir
    if args.resume and ckpt_dir is None:
        ckpt_dir = os.path.join(args.store, "checkpoints")
    who = f" host {host_index}/{host_count}" if host_count else ""
    print(f"# sweep {spec.spec_hash()}{who} -> "
          f"{store.path(spec) if store else '(not stored)'}")
    records = run_sweep(spec, store=store, force=args.force,
                        progress=lambda m: print(f"# {m}", flush=True),
                        device=args.device, block_events=args.block_events,
                        checkpoint_dir=ckpt_dir,
                        checkpoint_every=args.checkpoint_every,
                        shard=args.shard, host_index=host_index,
                        host_count=host_count)

    print(f"{'policy':<18} {'pred':<14} {'n':>4} {'mean':>8} {'median':>8} "
          f"{'q1':>8} {'q3':>8}")
    for (policy, pred), st in summarize_sweep(records).items():
        print(f"{policy:<18} {pred:<14} {st.n:>4} {st.mean:>8.4f} "
              f"{st.median:>8.4f} {st.q1:>8.4f} {st.q3:>8.4f}")


if __name__ == "__main__":
    from ..api._migration import warn_legacy
    warn_legacy("python -m repro_torch.sweep", "python -m repro_torch sweep")
    main(prog="python -m repro_torch.sweep")
