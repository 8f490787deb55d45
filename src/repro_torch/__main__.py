"""``python -m repro_torch`` - the port's CLI.

Subcommands:
  * ``sweep`` - batched experiment grids on the card (see
    ``repro_torch.sweep.__main__``; ``--device cpu`` runs on the CPU).
  * ``serve`` - fleet capacity planning: replay a synthetic serving
    request stream through the batched DVBP replay (``repro_torch.api``'s
    ``serving_requests`` workload) and compare policies, optionally
    against the host fleet baselines.  With ``--traffic {poisson,diurnal}``
    it drives the live batched front end instead (admission queue ->
    double-buffered block dispatch on the replay megakernel) and reports
    throughput and placement latency.  On the card unless ``--device
    cpu``.
  * ``obs`` - summarize a JSONL observability run log (spans + counters,
    ``obs.export_jsonl``), optionally converting it to Perfetto JSON.
  * ``validate`` - check the workload suites for malformed rows
    (``repro_torch.resilience.validate``; exit status 1 on any).

    PYTHONPATH=src python -m repro_torch sweep --suites azure --n-instances 28
    PYTHONPATH=src python -m repro_torch serve --requests 2000 --sigma 0.5
    PYTHONPATH=src python -m repro_torch serve --traffic poisson --rate 5e4 \
        --tps 1.2e5 --requests 2000
    PYTHONPATH=src python -m repro_torch obs run.obs.jsonl --perfetto t.json
    PYTHONPATH=src python -m repro_torch validate --suites azure huawei
"""
from __future__ import annotations

import argparse
import sys


def _serve(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch serve",
        description="Fleet capacity planning: DVBP policies over a "
                    "request stream through the batched replay.")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--tps", type=float, default=50.0,
                    help="decode tokens per second per slot")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sigma", type=float, default=0.0,
                    help="log-normal decode-length prediction error "
                         "(0 = clairvoyant predictions)")
    ap.add_argument("--policies",
                    default="first_fit,best_fit_linf,greedy,"
                            "nrt_prioritized",
                    help="comma list of scan policies to plan with")
    ap.add_argument("--setting", default="predicted",
                    choices=["nonclairvoyant", "clairvoyant", "predicted"],
                    help="information regime (predicted replays the "
                         "attached request predictions)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--kv-tokens", type=int, default=65536)
    ap.add_argument("--prefill-budget", type=float, default=262144)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the replay runs (default cuda; cpu runs "
                         "the kernels' plain PyTorch versions)")
    ap.add_argument("--store", default="",
                    help="persist records to this sweep-store directory")
    ap.add_argument("--baselines", action="store_true",
                    help="also run the host round_robin / pack_all fleet "
                         "baselines for reference")
    ap.add_argument("--traffic", default=None,
                    choices=["poisson", "diurnal"],
                    help="run the live batched front end (admission queue "
                         "-> double-buffered block dispatch) under this "
                         "synthetic traffic instead of capacity planning")
    ap.add_argument("--batch-max", type=int, default=256,
                    help="admission batch size for --traffic mode")
    args = ap.parse_args(argv)

    from . import api
    from .serving.fleet import attach_predictions, synth_requests
    from .serving.scheduler import ReplicaCapacity

    caps = ReplicaCapacity(args.slots, args.kv_tokens, args.prefill_budget)
    if args.traffic:
        from .serving.dispatch import serve_traffic
        from .serving.traffic import make_traffic
        reqs = make_traffic(args.traffic, args.requests, rate=args.rate,
                            seed=args.seed, sigma_pred=args.sigma)
        print(f"{'policy':<18} {'req/s':>10} {'p50_ms':>8} {'p99_ms':>8} "
              f"{'replica_s':>12} {'opened':>7} {'shed':>6}")
        for pol in args.policies.split(","):
            rep = serve_traffic(reqs, pol, caps, tps=args.tps,
                                batch_max=args.batch_max,
                                device=args.device)
            p50, p99 = rep.latency_quantiles()
            print(f"{pol:<18} {rep.throughput:>10.0f} {p50 * 1e3:>8.2f} "
                  f"{p99 * 1e3:>8.2f} {rep.replica_seconds:>12.1f} "
                  f"{rep.replicas_opened:>7d} {rep.shed:>6d}")
        return

    reqs = synth_requests(args.requests, seed=args.seed, rate=args.rate,
                          tps=args.tps)
    setting = args.setting
    if setting == "predicted":
        reqs = attach_predictions(reqs, args.sigma, seed=args.seed)
        setting = api.Setting.predicted()
    wl = api.serving_requests(reqs, caps=caps, tps=args.tps,
                              name=f"synth{args.requests}r{args.seed}")
    exp = api.Experiment(wl, policies=tuple(args.policies.split(",")),
                         settings=(setting,))
    res = exp.run(store=args.store or None, device=args.device,
                  progress=lambda m: print(f"# {m}", flush=True))
    print(f"{'policy':<18} {'setting':<22} {'replica_s':>12} "
          f"{'opened':>7} {'ratio':>8}")
    for r in res.rows():
        print(f"{r['policy']:<18} {r['setting']:<22} "
              f"{r['usage_time']:>12.1f} {r['n_bins_opened']:>7d} "
              f"{r['ratio']:>8.4f}")
    if args.baselines:
        from .serving.fleet import simulate_fleet
        for pol in ("round_robin", "pack_all"):
            b = simulate_fleet(reqs, pol, caps, args.tps)
            print(f"{pol:<18} {'(host baseline)':<22} "
                  f"{b['replica_seconds']:>12.1f} "
                  f"{b['replicas_opened']:>7d} {'-':>8}")


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
    if cmd == "serve":
        _serve(rest)
        return
    if cmd == "bench":
        raise SystemExit("python -m repro_torch bench is not ported yet: the "
                         "port's benchmark harness is ROADMAP.md's Queue 1 "
                         "item 7")
    if cmd == "obs":
        from .obs.cli import main as obs_main
        raise SystemExit(obs_main(rest))
    if cmd == "validate":
        from .resilience.validate import main as validate_main
        validate_main(rest)
        return
    raise SystemExit(f"unknown subcommand {cmd!r}; try: sweep, serve, "
                     "obs, validate")


if __name__ == "__main__":
    main()
