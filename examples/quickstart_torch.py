"""Quickstart on the PyTorch + CUDA port: the paper in one minute, through
the port's experiment API (``repro_torch.api``).

One workload x one policy x one information setting -> one usage-time
ratio vs. the Eq. (1) lower bound.  ``repro_torch.api`` runs every cell of
that matrix as batched replay lanes on the card: Workload (what gets
packed), Policy (how), Setting (what the policy is told about durations),
Experiment (run it).

    PYTHONPATH=src python examples/quickstart_torch.py              # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch import api


def main(device: str = "cuda"):
    wl = api.synthetic("azure", n_instances=2, n_items=800)

    # Policies are first-class values, not strings: parse/str round-trip,
    # structured params, capability flags, registry introspection.
    cbd = api.Policy.parse("cbd_beta2")
    assert str(cbd) == "cbd_beta2" and cbd.beta == 2.0 and cbd.category
    n_scan = sum(p.scan for p in api.policies())
    print(f"{n_scan} batched policies registered; e.g. {cbd.name}: "
          f"family={cbd.family} device_select={cbd.device_select}\n")

    cells = [
        (api.Setting.nonclairvoyant(),
         ("first_fit", "mru", "best_fit_linf")),
        (api.Setting.clairvoyant(),
         ("nrt_prioritized", "greedy", "cbdt_rho21600", "reduced_hybrid")),
        (api.Setting.predicted("lognormal", 1.0),
         ("ppe_modified", "greedy", "nrt_prioritized", "la_binary",
          "la_geometric")),
    ]
    for setting, policies in cells:
        print(f"{setting.label()}:")
        res = api.Experiment(wl, policies=policies, settings=(setting,),
                             seeds=(1,)).run(device=device)
        for (w, policy, s), st in res.summary().items():
            print(f"  {policy:22s} ratio={st.mean:.3f}")
        print()

    # Host-only extras (no batched lane) still run on the oracle engine:
    from repro_torch.core import get_algorithm, lower_bound, run
    from repro_torch.data import make_azure_like_suite
    inst = make_azure_like_suite(n_instances=1, n_items=800)[0]
    r = run(inst, get_algorithm("next_fit"))
    print("host-only (oracle engine):")
    print(f"  {r.algorithm:22s} ratio={r.ratio(lower_bound(inst)):.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(ap.parse_args().device)
