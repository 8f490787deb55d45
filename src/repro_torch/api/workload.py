"""``Workload`` and ``Setting``: what gets packed, and what the policy is
told about durations (the port's ``repro.api.workload``; content digests
equal the reference's, so both packages' stores key the same cells).

A ``Workload`` is anything that yields a labeled list of DVBP
``Instance``s plus the mapping from an information ``Setting`` to the
prediction model replayed on-device:

  * ``synthetic("azure" | "huawei", ...)`` - the paper's generated suites
    (wraps ``sweep.grid.SuiteSpec``, so store keys are unchanged).
  * ``azure_trace(trace_root, ...)`` - the real Azure Packing2020 dump.
  * ``instances([...])`` - prebuilt ``Instance`` lists (what the
    benchmarks feed in).
  * ``serving_requests(requests, caps, tps)`` - the serving adapter: a
    ``serving.Request`` stream becomes one DVBP instance whose items are
    requests (size = <slot, KV, prefill> demand vector from
    ``Request.size(caps)``, duration = decode_len / tps, predicted
    duration = predicted_decode_len / tps), so fleet capacity planning
    replays through the same padded ``InstanceBatch`` lanes / batched
    replay as the experiment grids and lands in the same sweep store.

A ``Setting`` makes the paper's three information regimes explicit
instead of smuggling them through pdeps conventions:

  * ``Setting.nonclairvoyant()`` - durations hidden.  For serving
    workloads this replays with pdep == arrival, exactly the
    ``DVBPScheduler`` behavior when no prediction is attached.  Suite
    workloads cannot hide durations from policies that read the
    predicted-departure clock, so ``Experiment`` rejects that
    combination instead of returning clairvoyant numbers under a
    nonclairvoyant label.
  * ``Setting.clairvoyant()`` - real durations revealed.
  * ``Setting.predicted(model)`` - learning-augmented: a
    ``sweep.grid.PredModel`` ("lognormal"/"uniform" + parameter), or -
    for serving workloads - ``model=None`` to replay the predictions
    already attached to the requests (``fleet.attach_predictions``).

Workloads that cannot be rebuilt from a declarative spec (request
streams, prebuilt instances) register their payload in a process-local
registry keyed by a content digest; the digest is part of the workload's
frozen spec, so store caching stays sound: identical content hits the
same store file, and fully-cached runs never need the registry at all.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..consolidate import ConsolidationSpec
from ..core.types import Instance
from ..serving.scheduler import ReplicaCapacity, Request
from ..sweep.grid import PredModel, SuiteSpec

# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------

SETTING_KINDS = ("nonclairvoyant", "clairvoyant", "predicted")


@dataclasses.dataclass(frozen=True)
class Setting:
    """One information regime (see module docstring), optionally with a
    consolidation scenario attached (``with_consolidation``): the same
    information regime replayed with threshold-triggered migrations."""

    kind: str = "clairvoyant"
    model: Optional[PredModel] = None   # predicted only; None == attached
    consolidation: ConsolidationSpec = ConsolidationSpec()

    def __post_init__(self):
        if self.kind not in SETTING_KINDS:
            raise ValueError(f"setting kind {self.kind!r} not in "
                             f"{SETTING_KINDS}")
        if self.model is not None:
            if self.kind != "predicted":
                raise ValueError("only Setting.predicted takes a model (got "
                                 f"{self.kind})")
            if not self.model.noisy:
                raise ValueError(
                    "Setting.predicted needs a noisy PredModel "
                    "(lognormal/uniform); use clairvoyant()/nonclairvoyant() "
                    "for the exact settings")

    def with_consolidation(self,
                           cons: "ConsolidationSpec | str") -> "Setting":
        """The same setting with consolidation enabled, e.g.
        ``Setting.clairvoyant().with_consolidation("underload:t0.25")``."""
        if isinstance(cons, str):
            cons = ConsolidationSpec.parse(cons)
        return dataclasses.replace(self, consolidation=cons)

    @classmethod
    def nonclairvoyant(cls) -> "Setting":
        return cls("nonclairvoyant")

    @classmethod
    def clairvoyant(cls) -> "Setting":
        return cls("clairvoyant")

    @classmethod
    def predicted(cls, model: Optional[Union[PredModel, str]] = None,
                  param: float = 0.0) -> "Setting":
        """``model``: a PredModel, a kind string ("lognormal"/"uniform",
        with ``param``), or None = the workload's own attached
        predictions (serving request streams)."""
        if isinstance(model, str):
            model = PredModel(model, param)
        return cls("predicted", model)

    @classmethod
    def parse(cls, s: "Setting | str") -> "Setting":
        if isinstance(s, Setting):
            return s
        base, _, cons = s.partition("+")
        if base in ("nonclairvoyant", "clairvoyant"):
            out = cls(base)
        elif base == "predicted":
            out = cls.predicted()
        else:
            raise KeyError(f"unknown setting {s!r}; known: {SETTING_KINDS} "
                           "(predicted variants need Setting.predicted(...); "
                           "'+consspec' attaches consolidation)")
        return out.with_consolidation(cons) if cons else out

    def label(self) -> str:
        base = self.kind if self.kind != "predicted" else \
            "predicted:" + (self.model.label() if self.model else
                            "attached")
        if self.consolidation.enabled:
            base += f"+{self.consolidation.canonical()}"
        return base


# ---------------------------------------------------------------------------
# Duck-typed prediction models (run_sweep only reads .noisy / .label() /
# .durations(inst, seeds))
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ZeroPredictions:
    """pdep == arrival for every item: the serving scheduler's
    non-clairvoyant replay (``DVBPScheduler`` feeds ``now`` into the
    indicated-close clock when no prediction is attached)."""

    kind: str = "nonclairvoyant"

    noisy = False

    def label(self) -> str:
        return "nonclairvoyant"

    def durations(self, inst: Instance, seeds) -> np.ndarray:
        return np.zeros(inst.n_items)


@dataclasses.dataclass(frozen=True)
class AttachedPredictions:
    """The predicted durations carried by the workload's own payload
    (e.g. ``Request.predicted_decode_len`` / ``fleet.attach_predictions``),
    resolved per instance from the workload registry."""

    digest: str
    kind: str = "attached"

    noisy = False

    def label(self) -> str:
        return "attached"

    def durations(self, inst: Instance, seeds) -> np.ndarray:
        pdur = _REGISTRY[self.digest].attached.get(inst.name)
        if pdur is None:
            raise ValueError(
                f"workload {self.digest} carries no attached predictions for "
                f"{inst.name!r} (did you attach_predictions / set "
                "predicted_decode_len?)")
        return pdur


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Workload:
    """Base: maps to one duck-``SuiteSpec`` (anything with ``build()`` /
    ``label()`` / ``n_instances`` that is a dataclass hashes canonically)
    plus the Setting -> prediction-model mapping."""

    def suite(self):
        raise NotImplementedError

    def label(self) -> str:
        return self.suite().label()

    def pred_model(self, setting: Setting):
        setting = Setting.parse(setting)
        if setting.kind == "nonclairvoyant":
            return PredModel("none")
        if setting.kind == "clairvoyant":
            return PredModel("clairvoyant")
        if setting.model is None:
            raise ValueError(
                f"{type(self).__name__} has no attached predictions; "
                "Setting.predicted needs an explicit PredModel "
                "(e.g. Setting.predicted('lognormal', 1.0))")
        return setting.model


@dataclasses.dataclass(frozen=True)
class SuiteWorkload(Workload):
    """A declarative suite family (synthetic generators or the real
    trace): delegates to ``sweep.grid.SuiteSpec`` unchanged, so result
    keys and store files are identical to legacy ``run_sweep`` runs."""

    spec: SuiteSpec = SuiteSpec()

    def suite(self) -> SuiteSpec:
        return self.spec


def synthetic(family: str = "azure", n_instances: int = 6,
              n_items: int = 500, seed: int = 2026) -> SuiteWorkload:
    return SuiteWorkload(SuiteSpec(family, n_instances, n_items, seed))


def azure_trace(trace_root: str = "data/azure", n_instances: int = 0,
                n_items: int = 0) -> SuiteWorkload:
    return SuiteWorkload(SuiteSpec("azure_trace", n_instances, n_items,
                                   seed=0, trace_root=trace_root))


# ---- runtime-payload workloads (instances / request streams) --------------

@dataclasses.dataclass(frozen=True)
class _Payload:
    instances: Tuple[Instance, ...]
    attached: Dict[str, np.ndarray]   # instance name -> predicted durations


_REGISTRY: Dict[str, _Payload] = {}


def _digest_arrays(parts, names=()) -> str:
    """Content digest over arrays AND instance names - records are keyed
    by instance name, so same-array/different-name workloads must not
    collide in the registry."""
    h = hashlib.sha256()
    for n in names:
        h.update(str(n).encode() + b"\0")
    for p in parts:
        a = np.ascontiguousarray(np.asarray(p, np.float64))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class RuntimeWorkload(Workload):
    """A workload whose instances exist only in this process, pinned to a
    content digest.  Doubles as its own duck-``SuiteSpec``."""

    family: str = "instances"
    name: str = "instances"
    digest: str = ""
    n_instances: int = 0

    def suite(self):
        return self

    def build(self) -> List[Instance]:
        payload = _REGISTRY.get(self.digest)
        if payload is None:
            raise ValueError(
                f"workload {self.label()} is not registered in this process "
                "(runtime workloads rebuild from their in-memory payload; "
                "fully store-cached runs do not need it)")
        return list(payload.instances)

    def label(self) -> str:
        return f"{self.family}-{self.name}-{self.digest[:8]}"

    def pred_model(self, setting: Setting):
        setting = Setting.parse(setting)
        if setting.kind == "predicted" and setting.model is None:
            if not _REGISTRY[self.digest].attached:
                raise ValueError(
                    f"{self.label()} carries no attached predictions")
            return AttachedPredictions(self.digest)
        if setting.kind == "nonclairvoyant" and self.family == "serving":
            return ZeroPredictions()
        return Workload.pred_model(self, setting)


def instances(insts: Sequence[Instance], name: str = "adhoc",
              attached: Optional[Dict[str, np.ndarray]] = None
              ) -> RuntimeWorkload:
    """Wrap prebuilt ``Instance``s as a workload (the benchmarks' path)."""
    insts = tuple(insts)
    if not insts:
        raise ValueError("instances() needs at least one Instance")
    attached = dict(attached or {})
    digest = _digest_arrays(
        [a for i in insts for a in (i.sizes, i.arrivals, i.departures)] +
        [attached[k] for k in sorted(attached)],
        names=[i.name for i in insts] + sorted(attached))
    _REGISTRY.setdefault(digest, _Payload(insts, attached))
    return RuntimeWorkload("instances", name, digest, len(insts))


def requests_to_instance(reqs: Sequence[Request],
                         caps: ReplicaCapacity = ReplicaCapacity(),
                         tps: float = 50.0, name: str = "requests"
                         ) -> Tuple[Instance, Optional[np.ndarray]]:
    """Convert one request stream to (Instance, attached predicted
    durations or None): item size = ``Request.size(caps)``, interval =
    [arrival, arrival + decode_len / tps), predicted duration =
    predicted_decode_len / tps when every request carries one.  The
    stable arrival sort matches ``simulate_fleet``'s processing order."""
    if len(reqs) == 0:
        raise ValueError("empty request stream")
    order = np.argsort([r.arrival for r in reqs], kind="stable")
    reqs = [reqs[i] for i in order]
    sizes = np.stack([r.size(caps) for r in reqs])
    arr = np.asarray([r.arrival for r in reqs], float)
    dur = np.asarray([r.decode_len for r in reqs], float) / tps
    inst = Instance(sizes, arr, arr + dur, name)
    pred = None
    if all(r.predicted_decode_len is not None for r in reqs):
        pred = np.asarray([r.predicted_decode_len for r in reqs],
                          float) / tps
    return inst, pred


def serving_requests(streams: Union[Sequence[Request],
                                    Sequence[Sequence[Request]]],
                     caps: ReplicaCapacity = ReplicaCapacity(),
                     tps: float = 50.0, name: str = "serving"
                     ) -> RuntimeWorkload:
    """The serving adapter: one or more ``Request`` streams become DVBP
    instances (one lane each) that replay through the batched scan -
    fleet capacity planning on the sweep engine, results in the sweep
    store.  ``Experiment`` over this workload reproduces
    ``serving.fleet.simulate_fleet`` usage/bins decision-for-decision."""
    if len(streams) == 0:
        raise ValueError("serving_requests needs at least one stream")
    if isinstance(streams[0], Request):
        streams = [list(streams)]
    insts, attached = [], {}
    for k, stream in enumerate(streams):
        iname = f"{name}_{k:02d}" if len(streams) > 1 else name
        inst, pred = requests_to_instance(stream, caps, tps, iname)
        insts.append(inst)
        if pred is not None:
            attached[iname] = pred
    digest = _digest_arrays(
        [a for i in insts for a in (i.sizes, i.arrivals, i.departures)] +
        ([attached[i.name] for i in insts if i.name in attached]) +
        [np.asarray([caps.slots, caps.kv_tokens, caps.prefill_budget, tps])],
        names=[i.name for i in insts] + sorted(attached))
    _REGISTRY.setdefault(digest, _Payload(tuple(insts), attached))
    return RuntimeWorkload("serving", name, digest, len(insts))


def workload(kind: str = "azure", **kw) -> Workload:
    """String-dispatch convenience: ``workload("azure", n_items=500)``."""
    if kind in ("azure", "huawei"):
        return synthetic(kind, **kw)
    if kind == "azure_trace":
        return azure_trace(**kw)
    raise KeyError(f"unknown workload kind {kind!r}; use synthetic / "
                   "azure_trace / instances / serving_requests")


def stream_source(wl: Union[Workload, Instance], instance: Union[int, str] = 0,
                  setting: "Setting | str" = "clairvoyant", seed: int = 0):
    """One instance of a workload as a bounded-memory request source for
    ``repro_torch.stream.replay_stream`` - the API-level on-ramp to
    streamed full-trace replay.

    ``instance`` selects by build index or instance name; ``setting``
    resolves predicted departures exactly as ``Experiment`` would
    (clairvoyant -> real departures, predicted -> the workload's model at
    ``seed``).  Note the source wraps a *built* instance: for traces too
    large to materialize at all, construct ``repro_torch.stream.CsvSource``
    directly on the raw CSV instead."""
    from ..stream import InstanceSource
    if isinstance(wl, Instance):
        return InstanceSource(wl)
    insts = wl.suite().build()
    if isinstance(instance, str):
        picked = [i for i in insts if i.name == instance]
        if not picked:
            raise KeyError(f"no instance {instance!r} in {wl.label()}: "
                           f"{[i.name for i in insts]}")
        inst = picked[0]
    else:
        inst = insts[int(instance)]
    model = wl.pred_model(Setting.parse(setting))
    pdur = None if model is None else model.durations(inst, (seed,))
    if pdur is None:                # exact settings: real departures
        return InstanceSource(inst)
    pdur = np.asarray(pdur)
    if pdur.ndim == 2:              # (n_seeds, n_items) noisy models
        pdur = pdur[0]
    return InstanceSource(inst, predicted_durations=pdur)


__all__ = ["Setting", "Workload", "SuiteWorkload", "RuntimeWorkload",
           "synthetic", "azure_trace", "instances", "serving_requests",
           "requests_to_instance", "stream_source", "workload",
           "ZeroPredictions", "AttachedPredictions"]
