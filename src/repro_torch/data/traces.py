"""DVBP instance sources; counterpart of ``repro.data.traces``.

  * ``make_azure_like_suite``: the calibrated synthetic family of the
    paper's 28-instance Azure Packing 2020 set - log-normal VM lifetimes, a
    14-day horizon, d = 4/5 normalized resource dims with core/memory
    correlation, Zipf VM-type popularity, diurnal arrivals, one instance per
    synthetic PM type.
  * ``make_huawei_like_suite``: the d = 2 (CPU, memory) analogue of
    Appendix D.
  * ``load_azure_csv``: the real trace when present (data/azure/*.csv);
    ``iter_azure_requests`` streams one machineId's requests from it line
    by line (``repro_torch.stream.CsvSource``).

The numpy draws are the reference's, in the same order, so the same seeds
give identical instances.  All times are in seconds.
"""
from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.types import Instance

DAY = 86400.0
HORIZON = 14 * DAY


def _vm_type_table(rng: np.random.Generator, n_types: int, d: int,
                   pm_cores: int) -> np.ndarray:
    """Normalized size vectors for n_types VM flavors on one PM type.

    core: power-of-two flavors; memory: correlated GB/core ratio;
    ssd / nic (and optional hdd): sub-linear in cores with noise.
    """
    max_exp = int(np.log2(pm_cores))
    core_exp = rng.integers(0, max_exp, n_types)   # 1 .. pm_cores/2 cores
    cores = 2.0 ** core_exp
    gb_per_core = rng.choice([1.0, 2.0, 4.0, 8.0], n_types,
                             p=[0.15, 0.35, 0.35, 0.15])
    pm_mem = pm_cores * 4.0
    mem = cores * gb_per_core
    ssd = cores / pm_cores * rng.uniform(0.3, 1.5, n_types)
    nic = cores / pm_cores * rng.uniform(0.2, 1.2, n_types)
    cols = [cores / pm_cores, mem / pm_mem, ssd, nic]
    if d == 5:
        cols.append(cores / pm_cores * rng.uniform(0.0, 1.0, n_types))  # hdd
    sizes = np.stack(cols[:d], axis=1)
    return np.clip(sizes, 1e-4, 1.0)


def _one_instance(seed: int, n_items: int, d: int, pm_cores: int,
                  med_lifetime: float, sigma_lifetime: float,
                  name: str) -> Instance:
    rng = np.random.default_rng(seed)
    n_types = int(rng.integers(8, 30))
    table = _vm_type_table(rng, n_types, d, pm_cores)
    # Zipf popularity over VM types (heavier head, like Azure).
    pop = 1.0 / np.arange(1, n_types + 1) ** rng.uniform(0.8, 1.6)
    pop /= pop.sum()
    types = rng.choice(n_types, n_items, p=pop)
    sizes = table[types]

    # Diurnal arrival intensity: thin a uniform proposal by a sinusoid.
    proposals = rng.uniform(0, HORIZON, n_items * 2)
    phase = rng.uniform(0, 2 * np.pi)
    accept = rng.random(n_items * 2) < \
        0.55 + 0.45 * np.sin(2 * np.pi * proposals / DAY + phase)
    arrivals = np.sort(proposals[accept][:n_items])
    if len(arrivals) < n_items:   # extremely unlikely; pad uniformly
        extra = rng.uniform(0, HORIZON, n_items - len(arrivals))
        arrivals = np.sort(np.concatenate([arrivals, extra]))

    # Log-normal lifetimes (paper Fig. 1b), truncated inside the horizon the
    # same way the paper cleans the Azure trace (items must fully fit).
    mu_ln = np.log(med_lifetime)
    life = rng.lognormal(mu_ln, sigma_lifetime, n_items)
    life = np.clip(life, 30.0, None)
    life = np.minimum(life, np.maximum(HORIZON - arrivals, 60.0))
    life = np.minimum(life, HORIZON - arrivals + 1e-3)
    departures = arrivals + life
    return Instance(sizes, arrivals, departures, name).sorted_by_arrival()


def make_azure_like_suite(n_instances: int = 28, n_items: int = 5000,
                          seed: int = 2026) -> List[Instance]:
    """One instance per synthetic PM type, mirroring the paper's 28-instance
    Azure family: d in {4,5}, varied PM size, load, and lifetime spread."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_instances):
        d = 4 if k % 3 else 5
        pm_cores = int(rng.choice([32, 48, 64, 96, 128]))
        med = float(rng.choice([600.0, 1800.0, 3600.0, 10800.0]))
        sig = float(rng.uniform(1.2, 2.4))
        items = int(n_items * rng.uniform(0.6, 1.4))
        out.append(_one_instance(int(rng.integers(1 << 31)), items, d,
                                 pm_cores, med, sig, f"azure_like_{k:02d}"))
    return out


def make_huawei_like_suite(n_instances: int = 9, n_items: int = 4000,
                           seed: int = 77) -> List[Instance]:
    """Appendix D analogue: d=2 (CPU, memory), nine assumed PM capacities."""
    rng = np.random.default_rng(seed)
    out = []
    caps = [(64, 128), (64, 200), (64, 256), (100, 128), (100, 200),
            (100, 256), (128, 128), (128, 200), (128, 256)]
    for k in range(n_instances):
        cpu_cap, mem_cap = caps[k % len(caps)]
        sub = np.random.default_rng(seed + 1000 + k)
        n_types = int(sub.integers(6, 20))
        cores = 2.0 ** sub.integers(0, 7, n_types)        # up to 64 cores
        mem = cores * sub.choice([1.0, 2.0, 4.0], n_types)
        table = np.stack([cores / cpu_cap, mem / mem_cap], axis=1)
        table = np.clip(table, 1e-4, 1.0)
        pop = 1.0 / np.arange(1, n_types + 1) ** 1.2
        pop /= pop.sum()
        types = sub.choice(n_types, n_items, p=pop)
        arrivals = np.sort(sub.uniform(0, HORIZON, n_items))
        life = np.clip(sub.lognormal(np.log(1800.0), 1.8, n_items), 30.0, None)
        life = np.minimum(life, HORIZON - arrivals + 1e-3)
        out.append(Instance(table[types], arrivals, arrivals + life,
                            f"huawei_like_{k}").sorted_by_arrival())
    return out


def load_azure_csv(root: str = "data/azure") -> Optional[List[Instance]]:
    """Load the real AzureTracesForPacking2020 dataset if the user has placed
    it under ``root`` (vmtype.csv + vmrequest.csv).  Returns None if absent."""
    tpath, rpath = os.path.join(root, "vmtype.csv"), os.path.join(root, "vmrequest.csv")
    if not (os.path.exists(tpath) and os.path.exists(rpath)):
        return None
    # vmtype.csv: vmTypeId,machineId,core,memory,hdd,ssd,nic
    ttab = np.genfromtxt(tpath, delimiter=",", names=True)
    rtab = np.genfromtxt(rpath, delimiter=",", names=True)
    out = []
    for pm in np.unique(ttab["machineId"]):
        rows = ttab[ttab["machineId"] == pm]
        dims = ["core", "memory", "hdd", "ssd", "nic"]
        cols = [np.nan_to_num(rows[c]) for c in dims]
        keep = [i for i, c in enumerate(cols) if np.any(c > 0)]
        table = {int(v): np.array([cols[i][j] for i in keep])
                 for j, v in enumerate(rows["vmTypeId"])}
        mask = np.isin(rtab["vmTypeId"], list(table))
        req = rtab[mask]
        ok = (req["starttime"] >= 0) & np.isfinite(req["endtime"]) & \
             (req["endtime"] <= 14.0)
        req = req[ok]
        if not len(req):
            continue
        sizes = np.stack([table[int(v)] for v in req["vmTypeId"]])
        arr = req["starttime"] * DAY
        dep = req["endtime"] * DAY
        good = dep > arr
        out.append(Instance(np.clip(sizes[good], 1e-6, 1.0), arr[good],
                            dep[good], f"azure_pm{int(pm)}").sorted_by_arrival())
    return out or None


def _azure_type_table(root: str, machine_id: int):
    """The (clipped) size-vector table for one machineId, with the same
    keep-nonzero-dims / clip cleaning as ``load_azure_csv``."""
    tpath = os.path.join(root, "vmtype.csv")
    ttab = np.genfromtxt(tpath, delimiter=",", names=True)
    rows = ttab[ttab["machineId"] == machine_id]
    if not len(rows):
        raise ValueError(f"no machineId {machine_id} in {tpath}")
    dims = ["core", "memory", "hdd", "ssd", "nic"]
    cols = [np.nan_to_num(rows[c]) for c in dims]
    keep = [i for i, c in enumerate(cols) if np.any(c > 0)]
    return {int(v): np.clip(np.array([cols[i][j] for i in keep]),
                            1e-6, 1.0)
            for j, v in enumerate(rows["vmTypeId"])}


def azure_stream_meta(root: str, machine_id: int) -> int:
    """Dimension count of one machineId's cleaned size vectors (the
    streaming reader's only up-front fact - no request scan needed)."""
    table = _azure_type_table(root, machine_id)
    return len(next(iter(table.values())))


def iter_azure_requests(root: str = "data/azure", machine_id: int = 0) \
        -> Iterator[Tuple[np.ndarray, float, float]]:
    """Stream one machineId's ``(size_vec, arrival_s, departure_s)``
    requests from an Azure-format trace without materializing it: only the
    (small) vmtype table is loaded; vmrequest.csv is read line by line.

    Applies exactly ``load_azure_csv``'s cleaning - requests joined
    against the type table, ``starttime >= 0``, finite ``endtime <= 14``
    days, strictly positive duration, times scaled to seconds - and
    yields in file order, which for the published trace is arrival order.
    Raises ``ValueError`` on a ``starttime`` regression rather than
    buffering for a sort (a sorted spill would defeat the bounded-memory
    contract; pre-sort the CSV once if yours is unordered)."""
    table = _azure_type_table(root, machine_id)
    rpath = os.path.join(root, "vmrequest.csv")
    last = -np.inf
    with open(rpath, newline="") as fh:
        for row in csv.DictReader(fh):
            try:
                vmtype = int(float(row["vmTypeId"]))
                start = float(row["starttime"])
                end = float(row["endtime"])
            except (KeyError, TypeError, ValueError):
                continue            # genfromtxt turns bad cells into nan
            size = table.get(vmtype)
            if size is None or not (start >= 0) or not np.isfinite(end) \
                    or end > 14.0:
                continue
            arr, dep = start * DAY, end * DAY
            if dep <= arr:
                continue
            if arr < last:
                raise ValueError(
                    f"vmrequest.csv is not arrival-sorted: starttime "
                    f"{start} after {last / DAY}; sort it once up front")
            last = arr
            yield size, arr, dep
